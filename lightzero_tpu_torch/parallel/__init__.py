"""Scale-out on torch.distributed: process-group helpers (``distributed``),
the data-parallel learn step (``ddp``) and a two-process dry run on the
CPU (``dryrun``)."""

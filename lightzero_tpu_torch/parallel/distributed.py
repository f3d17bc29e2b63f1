"""Scale-out helpers on ``torch.distributed`` (the role of
``lightzero_tpu/parallel/distributed.py``, which runs them on
``jax.distributed``): process-group start, rank queries, and the scalar
traffic of the multitask entries (all-gathered task returns, task weights
broadcast from rank 0, averaged collector statistics, the static task
partition).

A single-process run takes the same code with a world size of 1: every
helper is callable without a process group and then returns its input, so
the entries call them unconditionally.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> Dict[str, int]:
    """Start the default process group when the world is larger than one:
    the world size and rank default to torchrun's ``WORLD_SIZE`` and
    ``RANK``, the rendezvous to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``), the backend to NCCL where CUDA is available and gloo
    elsewhere. A no-op at world size 1, or when a group exists. Returns
    {rank, world_size}."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size > 1 and not dist.is_initialized():
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    return dict(rank=get_rank(), world_size=get_world_size())


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, which logs and writes checkpoints."""
    return get_rank() == 0


def barrier() -> None:
    if get_world_size() > 1:
        dist.barrier()


def collective_device() -> torch.device:
    """Where the group's tensors live: the current CUDA device under NCCL,
    the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_scalars(values: Dict[str, float]) -> Dict[str, np.ndarray]:
    """Every process's scalars: {key: (world_size,) array}. The keys must be
    the same on every process."""
    keys = sorted(values)
    local = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                         device=collective_device())
    if get_world_size() == 1:
        stacked = local[None]
    else:
        parts = [torch.empty_like(local) for _ in range(get_world_size())]
        dist.all_gather(parts, local)
        stacked = torch.stack(parts)
    stacked = stacked.cpu().numpy()
    return {k: stacked[:, i] for i, k in enumerate(keys)}


def broadcast_from_main(arr) -> np.ndarray:
    """Rank 0's array on every process (of the same shape and dtype
    everywhere)."""
    arr = np.asarray(arr)
    if get_world_size() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(collective_device())
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def allreduce_mean_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """The mean of each scalar over the processes."""
    return {k: float(np.mean(v)) for k, v in all_gather_scalars(values).items()}


def partition_tasks(num_tasks: int, rank: Optional[int] = None,
                    world_size: Optional[int] = None) -> Sequence[int]:
    """The tasks of a rank: contiguous blocks, the remainder spread over the
    first ranks."""
    rank = get_rank() if rank is None else rank
    world = get_world_size() if world_size is None else world_size
    base, rem = divmod(num_tasks, world)
    start = rank * base + min(rank, rem)
    count = base + (1 if rank < rem else 0)
    return list(range(start, start + count))

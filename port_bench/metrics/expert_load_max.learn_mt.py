"""How unevenly the router loads the experts: the busiest expert's tokens
over the mean of the experts' tokens, per MoE layer and forward, averaged
over the layers and the traced steps; 1 for an even load. A grouped
product waits on its largest group, so this is how much longer than an
even split the experts' products take. Read from the program's
``moe.tokens_per_expert`` counter (one (E,) device tensor a layer a
forward, kept while the profile records), once, after the window; None on
a program that keeps no such counter."""


def read(ctx):
    import torch

    from lightzero_tpu_torch.utils import profiling

    counts = getattr(profiling, "counters", {}).get("moe.tokens_per_expert")
    if not counts:
        return None
    loads = torch.stack(counts).to(torch.float64)
    return float((loads.max(dim=1).values / loads.mean(dim=1)).mean())

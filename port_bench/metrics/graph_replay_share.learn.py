"""How often the learn step ran as a replay of its captured CUDA graph: 100
x the replays the program counted in the traced window (its
``learn_graph.replays`` counter, one entry a replayed step) over the
window's steps. None on a program that keeps no such counter, or where no
step replayed."""


def read(ctx):
    from lightzero_tpu_torch.utils import profiling

    replays = getattr(profiling, "counters", {}).get("learn_graph.replays")
    steps = ctx["counters"].get("steps")
    if not replays or not steps:
        return None
    return 100.0 * sum(replays) / steps

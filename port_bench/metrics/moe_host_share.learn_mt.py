"""Share of the traced multitask learn window the host spent inside the MoE
layers' spans (``moe.route``: the gate, the selection, the grouping and
its read-back of the experts' token counts; ``moe.experts``; ``moe.combine``):
100 x their seconds over the window."""
from port_bench.spans import host_share


def read(ctx):
    return host_share(ctx["trace"], "moe.")

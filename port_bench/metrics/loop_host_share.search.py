"""Share of the traced search window the host spent inside the pUCT loop's
spans (``puct.roots``, ``puct.select``, ``puct.backup``, ``puct.result``):
100 x their seconds over the window."""
from port_bench.spans import host_share


def read(ctx):
    return host_share(ctx["trace"], "puct.")

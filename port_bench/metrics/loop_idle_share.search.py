"""Share of the traced search window in which the device sat idle while
the host was inside the pUCT loop's spans (``puct.roots``,
``puct.select``, ``puct.backup``, ``puct.result``): 100 x those idle
seconds over the window."""
from port_bench.spans import idle_share


def read(ctx):
    return idle_share(ctx["trace"], "puct.")

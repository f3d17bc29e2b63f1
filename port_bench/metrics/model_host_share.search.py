"""Share of the traced search window the host spent inside the model's
spans (``model.initial``, ``model.recurrent``): 100 x their seconds over
the window."""
from port_bench.spans import host_share


def read(ctx):
    return host_share(ctx["trace"], "model.")

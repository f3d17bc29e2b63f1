"""Share of the traced search window in which the device sat idle while
the host was inside the model's spans (``model.initial``, the initial
inference and its value transform; ``model.recurrent``, each simulation's
recurrent inference): 100 x those idle seconds over the window."""
from port_bench.spans import idle_share


def read(ctx):
    return idle_share(ctx["trace"], "model.")

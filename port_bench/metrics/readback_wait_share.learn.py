"""Share of the traced learn window the host spent in each step's one
read-back (``learn.readback``: the gradients' norm and the finite check,
which waits for the forward and backward to finish on the device): 100 x
its seconds over the window."""
from port_bench.spans import host_share


def read(ctx):
    return host_share(ctx["trace"], "learn.readback")

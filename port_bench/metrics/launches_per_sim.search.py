"""Device operations (kernels, copies, fills) in the traced search window
per simulation: over (calls x simulations). A count that repeats exactly."""


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    if tr.device_ops == 0 or not c.get("calls"):
        return None
    return tr.device_ops / (c["calls"] * c["sims"])

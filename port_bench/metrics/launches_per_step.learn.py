"""Device operations (kernels, copies, fills) in the traced learn window
per learn step. A count that repeats exactly."""


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    if tr.device_ops == 0 or not c.get("steps"):
        return None
    return tr.device_ops / c["steps"]

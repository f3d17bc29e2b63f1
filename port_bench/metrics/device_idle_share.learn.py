"""Share of the traced learn window in which no operation ran on the
device: 100 (1 - busy / window), busy the union of the device's intervals."""


def read(ctx):
    tr = ctx["trace"]
    if tr.device_ops == 0 or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

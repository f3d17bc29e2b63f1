"""The whole learn step's share of the card's float32 peak: the forward and
backward operations of the traced steps (from the configuration's shapes)
over the traced window, over 67 TFLOP/s."""
from port_bench.harness import FP32_FLOP_PER_S


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    if not c.get("flops") or tr.window_s <= 0:
        return None
    return 100.0 * c["flops"] / tr.window_s / FP32_FLOP_PER_S

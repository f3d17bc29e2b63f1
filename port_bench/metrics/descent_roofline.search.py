"""The descent kernel's share of its roofline: the least time the card
could take for the traced launches (per launch the larger of its bytes over
3.35 TB/s and its operations over 67 TFLOP/s, from the depths the descents
reached) over the kernel's own device time in the trace."""
KERNEL = "fused_traverse_kernel"


def read(ctx):
    c, tr = ctx["counters"], ctx["trace"]
    kernel_s = sum(s for name, s in tr.kernel_s.items() if KERNEL in name)
    launches = sum(n for name, n in tr.kernel_n.items() if KERNEL in name)
    if kernel_s <= 0 or not c.get("descent_launches") or launches != c["descent_launches"]:
        return None
    return 100.0 * c["descent_bound_s"] / kernel_s

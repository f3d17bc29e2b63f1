"""The channel-norm kernels' share of their roofline in the learn step: the
HBM bytes their traced launches must move (the program's
``channel_norm.bytes`` counter, one host number a launch: x, the residual
and the output, dy and dx, the parameters) over 3.35 TB/s, over the kernels'
own device time in the trace. None on a program that keeps no such counter,
or where the counted launches differ from the trace's launches of the
kernels."""
from port_bench.harness import HBM_BYTES_PER_S

KERNEL = "channel_norm_"


def read(ctx):
    from lightzero_tpu_torch.utils import profiling

    counted = getattr(profiling, "counters", {}).get("channel_norm.bytes")
    tr = ctx["trace"]
    kernel_s = sum(s for name, s in tr.kernel_s.items() if KERNEL in name)
    launches = sum(n for name, n in tr.kernel_n.items() if KERNEL in name)
    if not counted or kernel_s <= 0 or launches != len(counted):
        return None
    return 100.0 * sum(counted) / HBM_BYTES_PER_S / kernel_s

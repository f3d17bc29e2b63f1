"""What the program's own spans say in a traced run: the spans that
``lightzero_tpu_torch.utils.profiling`` records while the profiler is on
(the traced window alone: a run profiles nothing else), and the device's
idle gaps that ``harness.reduce_trace`` charged to them, a program span
being the outermost host op inside the driver's span. Each reads None on a
program that records no span of the layer."""
from typing import Optional


def recorded(prefix: str) -> list:
    """The recorded spans whose name starts with ``prefix``."""
    from lightzero_tpu_torch.utils import profiling

    return [s for s in getattr(profiling, "record", ()) if s.name.startswith(prefix)]


def host_share(tr, prefix: str) -> Optional[float]:
    """100 x the seconds of the spans named ``prefix``* over the window."""
    spans = recorded(prefix)
    if not spans or tr.window_s <= 0:
        return None
    return 100.0 * sum(s.end_ns - s.start_ns for s in spans) * 1e-9 / tr.window_s


def idle_share(tr, prefix: str) -> Optional[float]:
    """100 x the device's idle seconds charged to the spans named
    ``prefix``* (idle keys ``<driver span>/<span>``) over the window; None
    without a device trace."""
    if not recorded(prefix) or tr.device_ops == 0 or tr.window_s <= 0:
        return None
    idle = sum(s for key, s in tr.idle_by_host.items() if key.partition("/")[2].startswith(prefix))
    return 100.0 * idle / tr.window_s

"""Share of the traced learn window in which the device sat idle while the
host was inside ``learn.optimizer`` (the clip, AdamW's step, the schedule,
the clips after the step, the target sync): 100 x those idle seconds over
the window."""
from port_bench.spans import idle_share


def read(ctx):
    return idle_share(ctx["trace"], "learn.optimizer")

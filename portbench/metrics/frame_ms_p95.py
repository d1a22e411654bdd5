"""95th percentile, over every frame handed in during the window, of the
time from the sweep's hand-off (closed loop) or its due time (open loop)
to its pose on the host (host clock)."""

from portbench.harness.core import p95

UNIT = "ms"


def read(run):
    return 1e3 * p95([f.pose - f.due for f in run.frames]) if run.frames else None

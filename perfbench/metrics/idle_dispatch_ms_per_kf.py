"""idle_dispatch_ms_per_kf: the device's idle time, a keyframe, while the
dispatch thread was inside a `cm3d.` span that is not a wait: the host was
still queuing the work (metrics/_spans.py)."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.ms_per_kf(ctx, "dispatch")

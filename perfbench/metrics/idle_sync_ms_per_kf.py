"""idle_sync_ms_per_kf: the device's idle time, a keyframe, while the
dispatch thread was blocked in a `.wait` span other than the wait for the
IO thread's next frame (Detic's boxes, a copy back, the NMS's sweep test,
a delivery; metrics/_spans.py)."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.ms_per_kf(ctx, "sync")

"""idle_io_ms_per_kf: the device's idle time, a keyframe, while the
dispatch thread waited for run_fused's IO thread to prepare the next frame
(`cm3d.e2e.io.wait`; metrics/_spans.py)."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.ms_per_kf(ctx, "io")

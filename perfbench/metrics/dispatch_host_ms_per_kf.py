"""dispatch_host_ms_per_kf: the dispatch thread's own time, a keyframe,
in `cm3d.` spans that are not waits (each span's time less its `cm3d.`
children's): the host time spent queuing device work, idle or not
(metrics/_spans.py)."""

from perfbench.metrics import _spans


def read(ctx):
    return _spans.ms_per_kf(ctx, "host")

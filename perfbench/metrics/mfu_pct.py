"""mfu_pct: the least time the configuration's model work needs at the
card's published peaks (flops.py: the detector and the SAM encode a keyframe, the
SAM decode a box), for the keyframes delivered in the window after its first
batch and the boxes decoded for them, over the window's seconds. The window
of a traced run is untraced: its traced parts come after it."""

from perfbench import flops


def read(ctx):
    probe = ctx["probe"]
    keyframes, boxes = probe.window_work()
    if not keyframes:
        return None
    fixed, box = flops.keyframe_work(ctx["cfg"], ctx["traffic"])
    least = flops.least_time(fixed) * keyframes + flops.least_time(box) * boxes
    return 100.0 * least / (probe.batch_times[-1] - probe.batch_times[0])

"""int8_linear_device_ms_per_kf: device time of what was launched under
the ranges that forward pre / post hooks open around every QuantLinear of
the port's detector and SAM, a keyframe."""


def read(ctx):
    frames = ctx["probe"].traced.get("frames")
    seconds = ctx["trace"].device_s_under(["int8_linear"])
    if not frames or not seconds:
        return None
    return 1e3 * seconds / frames

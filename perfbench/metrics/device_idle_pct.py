"""device_idle_pct: the share of the window in which the device had nothing
to run: 1 - (device-busy seconds a keyframe) x (keyframes a second). The
busy seconds are the union of kernels, copies and fills in the light traced
part (the device's activity alone, which slows the host little), over the
keyframes dispatched in it; the rate is the untraced window's."""


def read(ctx):
    light = ctx["probe"].light
    if not light.get("frames"):
        return None
    return 100.0 * (1.0 - ctx["light"].busy_s() / light["frames"] * ctx["rate"])

"""sam_device_ms_per_kf: device time of what was launched under the
harness's ranges around sam_encode and sam_decode_planes, a keyframe."""


def read(ctx):
    frames = ctx["probe"].traced.get("frames")
    if not frames:
        return None
    return 1e3 * ctx["trace"].device_s_under(["sam"]) / frames

"""sam_decode_device_ms_per_kf: device time of what was launched under the
port's `cm3d.masks.sam_decode` span (start_frame_masks' SAM decode and
bit-pack), a keyframe."""


def read(ctx):
    frames = ctx["probe"].traced.get("frames")
    seconds = ctx["trace"].device_s_under(["cm3d.masks.sam_decode"])
    if not frames or not seconds:
        return None
    return 1e3 * seconds / frames

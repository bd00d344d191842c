"""sam_global_attn_roofline: the bound of SAM's global-attention blocks for
the keyframes traced (each camera's encode, each global block: the work
flops.sam_encoder_work counts for its attention, 4 t^2 d + 2 t d (gh + gw)
operations at the bf16 peak, or q, k, v read and o written once in bf16 at
the card's bandwidth, whichever is longer), over the device time of what
the cm3d_torch::sam_global_attn op launched. A program without that op
(which runs the blocks as a plain chain) has nothing to read."""

from perfbench import flops

OPS = ("cm3d_torch::sam_global_attn",)


def bound_s(cfg: dict, traffic: dict) -> float:
    """Least seconds of a keyframe's global-attention blocks."""
    s = cfg["sam"]
    gh, gw = flops.sam_grid(cfg, *traffic["image_hw"])
    t, d = gh * gw, s["encoder_dim"]
    ops = 4 * t * t * d + 2 * t * d * (gh + gw)
    nbytes = 4 * t * d * 2
    per_block = max(ops / flops.PEAK_OPS_PER_S["bf16"], nbytes / flops.PEAK_BYTES_PER_S)
    return per_block * len(s["encoder_global_attn"]) * traffic["cameras"]


def read(ctx):
    frames = ctx["probe"].traced.get("frames")
    seconds = ctx["trace"].device_s_under(OPS)
    if not frames or not seconds:
        return None
    return 100.0 * bound_s(ctx["cfg"], ctx["traffic"]) * frames / seconds

"""window_attn_roofline: the bound of the window-attention branches of
the detector's Swin (flops.window_attn_bound_s: the heads launch by
operations, the projection by bytes) for the keyframes traced, over the device time of what
the cm3d_torch window-attention ops launched."""

from perfbench import flops

OPS = ("cm3d_torch::window_attn_heads", "cm3d_torch::window_attn_qkv",
       "cm3d_torch::window_attn_proj")


def read(ctx):
    frames = ctx["probe"].traced.get("frames")
    seconds = ctx["trace"].device_s_under(OPS)
    if not frames or not seconds:
        return None
    return 100.0 * flops.window_attn_bound_s(ctx["cfg"], ctx["traffic"]) * frames / seconds

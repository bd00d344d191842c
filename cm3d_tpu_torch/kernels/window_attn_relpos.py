"""Fused SAM windowed-block attention: CUDA kernel wrappers + plain version.

The attention branch of a windowed SAM ViT block, [B, H, W, C] ->
[B, H, W, C] before the residual:

    pad H, W to multiples of `window` (bottom / right); per window of
    n = window^2 tokens: LN (f32, two-pass variance; padding tokens exactly
    0 after the LN, so their k and v are the bare bias) -> qkv = LN @ Wqkv^T
    + bqkv -> per head
    s[i, j] = (q_i . k_j) * hd^-1/2 + q_i . rel_h[r_i - r_j + window - 1]
                                    + q_i . rel_w[c_i - c_j + window - 1]
    -> softmax (f32) -> o = p v -> out = o @ Wproj^T + bproj; crop to [H, W].

Replaces the TPU kernel `cm3d_tpu/kernels/window_attn_pallas.py:520
fused_window_attn_relpos` together with the pad / group / crop that
`cm3d_tpu/models/sam.py:268 _fused_windowed` wraps around it. Rounding
follows the TPU kernel, not the unfused block: the scale is applied to the
f32 dot (the unfused block scales q first), the bias comes from the raw q,
each of its two terms is rounded to the compute dtype before the f32 sum,
and LN out, qkv, p, o and out are rounded to the compute dtype. The TPU's
grouped block-diagonal problem, reversed tables, Toeplitz select-sums and
one-hot expansion products do not carry over: each window is its own n x n
problem and the bias is an indexed read of q @ rel^T.

Two launcher calls per block, each with its wrapper, plain version and
launch counter: `window_attn_relpos_heads` (csrc/window_attn_relpos.cu: the
LN pass, the qkv GEMM over all windows and the per-(window, head)
attention, three kernels queued by one call that counts as one launch ->
o [B*nW*n, C] in window order; windows of at most 196 tokens, heads of at
most 80 channels) and `window_attn_relpos_proj` (the projection kernel of
csrc/window_attn.cu with shift 0, which has no such cap).
`window_attn_relpos` composes the two.

Dispatch: each launcher is a dispatcher op
(`cm3d_torch::window_attn_relpos_heads`, `window_attn_relpos_proj`;
kernels/ops.py): a CPU tensor runs the plain version; a CUDA tensor
launches the kernels or raises. Weights are torch `nn.Linear` layouts: wqkv [3C, C],
wproj [C, C]; the tables are [2 * window - 1, C / heads].
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cm3d_tpu_torch.kernels import build, ops
from cm3d_tpu_torch.kernels.window_attn import (
    _check_cuda_x,
    _cuda_dtype_flag,
    _f32,
    _padded_rows,
    _rounded,
    check_bf16_gemm,
    check_proj,
    ln_stats_scratch,
    needs_graph,
    padded_hw,
    proj_cuda,
    proj_fake,
    ptr,
    window_attn_proj_plain,
    window_ln_rows_plain,
)

EPS = 1e-6  # SAM's encoder LayerNorm
MAX_WINDOW = 14  # 196 tokens a window
MAX_HEAD_DIM = 80  # ViT-H


@functools.lru_cache(maxsize=None)
def rel_index(window: int) -> tuple[np.ndarray, np.ndarray]:
    """([n, n], [n, n]) indices into q @ rel_h^T and q @ rel_w^T:
    r_i - r_j + window - 1 and c_i - c_j + window - 1."""
    r, c = np.divmod(np.arange(window * window), window)
    return ((r[:, None] - r[None, :] + window - 1).astype(np.int64),
            (c[:, None] - c[None, :] + window - 1).astype(np.int64))


def _check(x, wqkv, rel_h, rel_w, heads: int, window: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"window_attn_relpos: x must be [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c % heads:
        raise ValueError(f"window_attn_relpos: channels {c} not divisible by heads {heads}")
    if tuple(wqkv.shape) != (3 * c, c):
        raise ValueError(f"window_attn_relpos: wqkv must be [3C, C] = {(3 * c, c)}, "
                         f"got {tuple(wqkv.shape)}")
    want = (2 * window - 1, c // heads)
    if window < 1 or tuple(rel_h.shape) != want or tuple(rel_w.shape) != want:
        raise ValueError(f"window_attn_relpos: the tables of window {window} must be "
                         f"[2w-1, head_dim] = {want}, got {tuple(rel_h.shape)} and "
                         f"{tuple(rel_w.shape)}")


def window_attn_relpos_heads_plain(x, ln_weight, ln_bias, wqkv, bqkv, rel_h, rel_w, *,
                                   heads: int, window: int, dtype, eps: float = EPS):
    """Plain PyTorch version of the first launch: x [B, H, W, C] ->
    o [B * nW * n, C] of `dtype`, rows in window order (windows row-major
    over the padded grid, tokens row-major inside a window)."""
    _check(x, wqkv, rel_h, rel_w, heads, window)
    c = x.shape[-1]
    hd, n = c // heads, window * window
    ln = window_ln_rows_plain(x, ln_weight, ln_bias, window=window, shift=0, eps=eps)
    qkv = _rounded(ln, dtype) @ _rounded(wqkv, dtype).T + bqkv.float()
    qkv = _rounded(qkv, dtype).reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [B*nW, heads, n, hd]
    s = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    idx_h, idx_w = (torch.as_tensor(i, device=x.device).expand(*s.shape)
                    for i in rel_index(window))
    ph = _rounded(q @ _rounded(rel_h, dtype).T, dtype)  # [B*nW, heads, n, 2w-1]
    pw = _rounded(q @ _rounded(rel_w, dtype).T, dtype)
    s = s + torch.gather(ph, -1, idx_h) + torch.gather(pw, -1, idx_w)
    p = _rounded(torch.softmax(s, dim=-1), dtype)
    o = _rounded(p @ v, dtype)
    return o.permute(0, 2, 1, 3).reshape(-1, c).to(dtype)


def window_attn_relpos_plain(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, rel_h, rel_w, *,
                             heads: int, window: int, dtype, eps: float = EPS):
    """Plain PyTorch version of the whole branch (both launches)."""
    o = window_attn_relpos_heads_plain(x, ln_weight, ln_bias, wqkv, bqkv, rel_h, rel_w,
                                       heads=heads, window=window, dtype=dtype, eps=eps)
    return window_attn_proj_plain(o, wproj, bproj, out_shape=tuple(x.shape), window=window,
                                  shift=0, dtype=dtype)


def window_attn_relpos_heads(x, ln_weight, ln_bias, wqkv, bqkv, rel_h, rel_w, *, heads: int,
                             window: int, dtype, eps: float = EPS) -> torch.Tensor:
    """LN + qkv + per-head rel-pos window attention -> o [B * nW * n, C] of
    `dtype` (see `window_attn_relpos_heads_plain`)."""
    _check(x, wqkv, rel_h, rel_w, heads, window)
    return _heads_op(x, ln_weight, ln_bias, wqkv, bqkv, rel_h, rel_w, heads, window, dtype, eps)


def _window_attn_relpos_heads_cuda(x, ln_weight, ln_bias, wqkv, bqkv, rel_h, rel_w,
                                   heads: int, window: int, dtype, eps: float) -> torch.Tensor:
    flag = _cuda_dtype_flag(dtype)
    _check_cuda_x(x, dtype, heads, window, MAX_WINDOW ** 2, MAX_HEAD_DIM)
    b, h, w, c = x.shape
    hp, wp = padded_hw(h, w, window)
    dev = x.device
    o = torch.empty((b * hp * wp, c), dtype=dtype, device=dev)
    if o.numel() == 0:
        return o
    # scratch between the three kernels: qkv, and (f32) per-token mean |
    # rstd; bf16 writes its LN rows into o, which the attention overwrites
    stats = ln_stats_scratch(x, dtype)
    qkv = torch.empty((b * hp * wp, 3 * c), dtype=dtype, device=dev)
    args = (_f32(ln_weight, dev), _f32(ln_bias, dev),
            wqkv.detach().to(device=dev, dtype=dtype).contiguous(), _f32(bqkv, dev),
            rel_h.detach().to(device=dev, dtype=dtype).contiguous(),
            rel_w.detach().to(device=dev, dtype=dtype).contiguous())
    if dtype == torch.bfloat16:
        check_bf16_gemm(c, x, *args[:3], ln=True)
    err = _lib().window_attn_relpos_heads_launch(
        flag, int(x.dtype == torch.bfloat16), x.data_ptr(), *(a.data_ptr() for a in args),
        ptr(stats), qkv.data_ptr(), o.data_ptr(), b, h, w, c, heads, window, eps,
        (c // heads) ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "window_attn_relpos_heads")
    window_attn_relpos_heads.launches += 1
    return o


window_attn_relpos_heads.launches = 0

_heads_op = ops.define(
    "window_attn_relpos_heads(Tensor x, Tensor ln_weight, Tensor ln_bias, Tensor wqkv, "
    "Tensor bqkv, Tensor rel_h, Tensor rel_w, int heads, int window, ScalarType dtype, "
    "float eps) -> Tensor",
    cpu=lambda x, lnw, lnb, wqkv, bqkv, rel_h, rel_w, heads, window, dtype, eps:
        window_attn_relpos_heads_plain(x, lnw, lnb, wqkv, bqkv, rel_h, rel_w, heads=heads,
                                       window=window, dtype=dtype, eps=eps),
    cuda=_window_attn_relpos_heads_cuda,
    fake=lambda x, lnw, lnb, wqkv, bqkv, rel_h, rel_w, heads, window, dtype, eps:
        x.new_empty((_padded_rows(x, window), x.shape[-1]), dtype=dtype))


def window_attn_relpos_proj(o, wproj, bproj, *, out_shape, heads: int, window: int,
                            dtype) -> torch.Tensor:
    """o [B * nW * n, C] -> out [B, H, W, C] of `dtype`: the projection
    launch of `kernels/window_attn.py` with no shift, counted here."""
    check_proj(o, wproj, out_shape, window)
    return _proj_op(o, wproj, bproj, list(out_shape), heads, window, dtype)


window_attn_relpos_proj.launches = 0

_proj_op = ops.define(
    "window_attn_relpos_proj(Tensor o, Tensor wproj, Tensor bproj, int[] out_shape, int heads, "
    "int window, ScalarType dtype) -> Tensor",
    cpu=lambda o, wproj, bproj, out_shape, heads, window, dtype: window_attn_proj_plain(
        o, wproj, bproj, out_shape=out_shape, window=window, shift=0, dtype=dtype),
    cuda=lambda o, wproj, bproj, out_shape, heads, window, dtype: proj_cuda(
        o, wproj, bproj, out_shape, heads, window, 0, dtype, window_attn_relpos_proj),
    fake=proj_fake)


def refuse_graph_on_card(x, *params) -> None:
    """Raise where autograd would need a graph through the CUDA kernels:
    they record none, so the gradients of x and of the block's parameters
    would silently be zero. SAM is never trained in the JAX package, so no
    backward is ported; the plain version (any CPU tensor) differentiates."""
    if x.device.type == "cuda" and needs_graph(x, *params):
        raise NotImplementedError(
            "window_attn_relpos has no backward on the card: SAM's training is not part "
            "of the JAX package, so none was ported. Run under torch.no_grad(), or "
            "differentiate window_attn_relpos_plain")


def window_attn_relpos(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, rel_h, rel_w, *,
                       heads: int, window: int, dtype, eps: float = EPS) -> torch.Tensor:
    """The attention branch of a windowed SAM block, [B, H, W, C] ->
    [B, H, W, C] of `dtype` (pre-residual): `window_attn_relpos_heads` then
    `window_attn_relpos_proj`. Under autograd on the CPU it is the plain
    version itself (the ops register no autograd kernel)."""
    tensors = (x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, rel_h, rel_w)
    refuse_graph_on_card(*tensors)
    if needs_graph(*tensors):
        return window_attn_relpos_plain(*tensors, heads=heads, window=window, dtype=dtype,
                                        eps=eps)
    o = window_attn_relpos_heads(x, ln_weight, ln_bias, wqkv, bqkv, rel_h, rel_w, heads=heads,
                                 window=window, dtype=dtype, eps=eps)
    return window_attn_relpos_proj(o, wproj, bproj, out_shape=tuple(x.shape), heads=heads,
                                   window=window, dtype=dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("window_attn_relpos")
    lib.window_attn_relpos_heads_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.window_attn_relpos_heads_launch.restype = ctypes.c_int
    return lib

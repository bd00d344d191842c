"""Fused Swin window attention: CUDA kernel wrappers + plain version.

The attention branch of a Swin block, [B, H, W, C] -> [B, H, W, C] before
the residual:

    pad H, W to multiples of `window`, roll by -shift; per window of
    n = window^2 tokens: LN (f32, two-pass variance, eps 1e-5; padding
    tokens exactly 0 after the LN) -> qkv = LN @ Wqkv^T + bqkv -> per head
    s = (q k^T) * hd^-1/2 + B_rel[h] (+ the 0 / -100 shifted-window mask)
    -> softmax (f32) -> o = p v -> out = o @ Wproj^T + bproj; roll back by
    +shift; crop to [H, W].

Replaces the TPU kernel `cm3d_tpu/kernels/window_attn_pallas.py:303
fused_window_attn` together with the pad / roll / group / crop that
`cm3d_tpu/models/swin.py:198 _fused_branch_impl` wraps around it. Rounding
follows the TPU kernel: LN out, qkv, p, o and out are rounded to the
compute dtype, every sum is taken in f32. The TPU's interleaved
block-diagonal attention over groups of windows is a TPU workaround and
does not carry over: each window is computed by itself.

The CUDA source (csrc/window_attn.cu) runs it as two launcher calls per
Swin block, each with its own wrapper, plain version and launch counter:
`window_attn_heads` (the LN pass, ONE qkv GEMM over all windows into a
[B*nW*n, 3C] scratch, then tensor-core attention per (window, group of
heads) -> o [B*nW*n, C] in window order: three kernels queued by one call
that counts as one launch; plain pieces `window_attn_qkv_plain` and
`window_attn_core_plain`) and `window_attn_proj` (o @ Wproj^T + bproj,
scattered back to [B, H, W, C]). `window_attn` composes the two. The bf16
GEMM behind both (wgmma on TMA tiles, sm_90a) takes C % 8 == 0 and 16-byte
aligned tensors; `window_attn_qkv` runs the qkv product alone, off the main
path, for tests and measurement.

Dispatch: each launcher is a dispatcher op (`cm3d_torch::window_attn_heads`,
`window_attn_qkv`, `window_attn_proj`; kernels/ops.py): a CPU tensor runs
the plain version; a CUDA tensor launches the kernels or raises. Weights
are torch `nn.Linear` layouts: wqkv [3C, C], wproj [C, C].

Which kernel serves which model: `window_attn_heads` here holds windows of
at most 64 tokens and heads of at most 64 channels, which is every Swin
stage (window 7, head dim 32). SAM's windowed ViT blocks (window 14 = 196
tokens, head dim 80 in ViT-H, a q-dependent decomposed rel-pos bias instead
of a table) go through `kernels/window_attn_relpos.py`, whose heads kernel
(csrc/window_attn_relpos.cu) tiles the query rows; it shares this module's
qkv GEMM and projection launch, which has no cap on window or head size.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from cm3d_tpu_torch.kernels import build, ops

EPS = 1e-5  # torch Swin LayerNorm default
MAX_TOKENS = 64  # window^2 the kernel holds per block
MAX_HEAD_DIM = 64
MAX_BF16_CHANNELS = 2048  # csrc/window_attn_common.cuh kMaxLnC


@functools.lru_cache(maxsize=None)
def rel_pos_index(window: int) -> np.ndarray:
    """[win^2, win^2] index into the (2w-1)^2 relative-position-bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]).astype(np.int64)


# bounded: a key per (padded canvas, stage) of the plain path, and a
# stage-1 mask of a 6-camera Swin-B ring is about 45 MB; 16 entries hold
# every shifted stage of four canvases
@functools.lru_cache(maxsize=16)
def shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """[nW, win^2, win^2] additive mask for shifted windows (0 / -100)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return (win[:, :, None] != win[:, None, :]).astype(np.float32) * -100.0


def padded_hw(h: int, w: int, window: int) -> tuple[int, int]:
    return -(-h // window) * window, -(-w // window) * window


def _check(x: torch.Tensor, wqkv: torch.Tensor, table: torch.Tensor, heads: int,
           window: int, shift: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"window_attn: x must be [B, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c % heads:
        raise ValueError(f"window_attn: channels {c} not divisible by heads {heads}")
    if tuple(wqkv.shape) != (3 * c, c):
        raise ValueError(f"window_attn: wqkv must be [3C, C] = {(3 * c, c)}, "
                         f"got {tuple(wqkv.shape)}")
    if not 0 <= shift < window:
        raise ValueError(f"window_attn: shift {shift} must lie in [0, window {window})")
    if tuple(table.shape) != ((2 * window - 1) ** 2, heads):
        raise ValueError(f"window_attn: the bias table of window {window} must be "
                         f"[(2w-1)^2, heads] = {((2 * window - 1) ** 2, heads)}, "
                         f"got {tuple(table.shape)}")


def _layer_norm(x, weight, bias, eps):
    """f32 LayerNorm with the two-pass variance of the TPU kernel."""
    xf = x.float()
    xc = xf - xf.mean(-1, keepdim=True)
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight.float() + bias.float()


def _rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to `dtype`, carried as f32 (products of `dtype` values
    accumulated in f32, as the kernel computes them)."""
    return t.to(dtype).float()


def window_ln_rows_plain(x, ln_weight, ln_bias, *, window: int, shift: int, eps: float = EPS):
    """LN(x) in f32 as the qkv product's rows: [B * nW * n, C] in window
    order (windows row-major over the rolled, padded grid, tokens row-major
    inside a window); a padding token's row is 0."""
    b, h, w, c = x.shape
    hp, wp = padded_hw(h, w, window)
    ln = _layer_norm(x, ln_weight, ln_bias, eps)
    # the reference pads AFTER the norm: padding tokens are exact zeros
    ln = torch.nn.functional.pad(ln, (0, 0, 0, wp - w, 0, hp - h))
    if shift:
        ln = torch.roll(ln, (-shift, -shift), (1, 2))
    ln = ln.reshape(b, hp // window, window, wp // window, window, c)
    return ln.permute(0, 1, 3, 2, 4, 5).reshape(-1, c)


def window_attn_qkv_plain(x, ln_weight, ln_bias, wqkv, bqkv, *, window: int, shift: int,
                          dtype, eps: float = EPS):
    """Plain PyTorch version of the first launch's qkv product: x
    [B, H, W, C] -> qkv [B * nW * n, 3C] of `dtype`, rows in window order
    (see `window_ln_rows_plain`); a padding token's row is the bias."""
    ln = window_ln_rows_plain(x, ln_weight, ln_bias, window=window, shift=shift, eps=eps)
    qkv = _rounded(ln, dtype) @ _rounded(wqkv, dtype).T + bqkv.float()
    return qkv.to(dtype)


def window_attn_core_plain(qkv, table, *, x_shape, heads: int, window: int, shift: int, dtype):
    """Plain PyTorch version of the first launch's attention: qkv
    [B * nW * n, 3C] (window order) -> o [B * nW * n, C] of `dtype`."""
    b, h, w, c = x_shape
    hd, n = c // heads, window * window
    hp, wp = padded_hw(h, w, window)
    qkv = qkv.float().reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # [B*nW, heads, n, hd]
    idx = torch.as_tensor(rel_pos_index(window), device=qkv.device).reshape(-1)
    bias = table.float()[idx].reshape(n, n, heads).permute(2, 0, 1)
    s = (q @ k.transpose(-1, -2)) * (hd ** -0.5) + bias
    if shift:
        mask = torch.as_tensor(shift_attn_mask(hp, wp, window, shift), device=qkv.device)
        s = (s.reshape(b, -1, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
    p = _rounded(torch.softmax(s, dim=-1), dtype)
    o = _rounded(p @ v, dtype)
    return o.permute(0, 2, 1, 3).reshape(-1, c).to(dtype)


def window_attn_heads_plain(x, ln_weight, ln_bias, wqkv, bqkv, table, *, heads: int,
                            window: int, shift: int, dtype, eps: float = EPS):
    """Plain PyTorch version of the first launch: x [B, H, W, C] ->
    o [B * nW * n, C] of `dtype`, rows in window order:
    `window_attn_core_plain(window_attn_qkv_plain(x))`."""
    _check(x, wqkv, table, heads, window, shift)
    qkv = window_attn_qkv_plain(x, ln_weight, ln_bias, wqkv, bqkv, window=window, shift=shift,
                                dtype=dtype, eps=eps)
    return window_attn_core_plain(qkv, table, x_shape=tuple(x.shape), heads=heads,
                                  window=window, shift=shift, dtype=dtype)


def window_attn_proj_plain(o, wproj, bproj, *, out_shape, window: int, shift: int, dtype):
    """Plain PyTorch version of the second launch: o [B * nW * n, C] ->
    out [B, H, W, C] = (o @ Wproj^T + bproj) back in image order."""
    b, h, w, c = out_shape
    hp, wp = padded_hw(h, w, window)
    out = _rounded(o, dtype) @ _rounded(wproj, dtype).T + bproj.float()
    out = out.to(dtype).reshape(b, hp // window, wp // window, window, window, c)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if shift:
        out = torch.roll(out, (shift, shift), (1, 2))
    return out[:, :h, :w].contiguous()


def window_attn_plain(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, table, *,
                      heads: int, window: int, shift: int, dtype, eps: float = EPS):
    """Plain PyTorch version of the whole branch (both launches)."""
    o = window_attn_heads_plain(x, ln_weight, ln_bias, wqkv, bqkv, table, heads=heads,
                                window=window, shift=shift, dtype=dtype, eps=eps)
    return window_attn_proj_plain(o, wproj, bproj, out_shape=tuple(x.shape),
                                  window=window, shift=shift, dtype=dtype)


def _cuda_dtype_flag(dtype) -> int:
    if dtype == torch.bfloat16:
        return 1
    if dtype == torch.float32:
        return 0
    raise TypeError(f"window_attn: compute dtype must be float32 or bfloat16, got {dtype}")


def _check_cuda_x(x: torch.Tensor, dtype, heads: int, window: int,
                  max_tokens: int = MAX_TOKENS, max_head_dim: int = MAX_HEAD_DIM) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"window_attn: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("window_attn: the CUDA path needs a contiguous x")
    if x.dtype not in (torch.float32, torch.bfloat16) or (
            x.dtype == torch.bfloat16 and dtype != torch.bfloat16):
        raise TypeError(f"window_attn: x of {x.dtype} with compute dtype {dtype}: the "
                        f"CUDA path takes f32 x, or bf16 x under bf16 compute")
    if window * window > max_tokens or x.shape[-1] // heads > max_head_dim:
        raise ValueError(
            f"window_attn: this CUDA kernel holds window^2 <= {max_tokens} tokens and "
            f"head_dim <= {max_head_dim}, got window {window}, head_dim "
            f"{x.shape[-1] // heads}. Swin's table-bias blocks (<= {MAX_TOKENS} tokens, "
            f"head_dim <= {MAX_HEAD_DIM}) run kernels/window_attn.py window_attn; SAM's "
            f"rel-pos blocks (<= 196 tokens, head_dim <= 80) run "
            f"kernels/window_attn_relpos.py window_attn_relpos")
    b, h, w, _ = x.shape
    hp, wp = padded_hw(h, w, window)
    if b * hp * wp >= 2**31:  # the kernels count padded tokens in int32
        raise ValueError(f"window_attn: {b * hp * wp} padded tokens do not fit in int32")


def check_bf16_gemm(c: int, *tensors, ln: bool = False) -> None:
    """The bf16 GEMM reads its operands by TMA and writes 16-byte stores:
    rows of a multiple of 16 bytes (C % 8 == 0, which every bf16 caller of
    the port has) and 16-byte aligned tensors. `ln`: the LayerNorm pass in
    front of the qkv product also holds a row in registers."""
    if c % 8:
        raise ValueError(f"window_attn: the bf16 kernels need channels % 8 == 0, got {c}")
    if ln and c > MAX_BF16_CHANNELS:
        raise ValueError(f"window_attn: the bf16 LayerNorm pass holds at most "
                         f"{MAX_BF16_CHANNELS} channels, got {c}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("window_attn: the bf16 kernels need 16-byte aligned tensors")


def _f32(t: torch.Tensor, device) -> torch.Tensor:
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


def window_attn_heads(x, ln_weight, ln_bias, wqkv, bqkv, table, *, heads: int, window: int,
                      shift: int, dtype, eps: float = EPS) -> torch.Tensor:
    """LN + qkv + per-head window attention -> o [B * nW * n, C] of
    `dtype` (see `window_attn_heads_plain`)."""
    _check(x, wqkv, table, heads, window, shift)
    return _heads_op(x, ln_weight, ln_bias, wqkv, bqkv, table, heads, window, shift, dtype, eps)


def _window_attn_heads_cuda(x, ln_weight, ln_bias, wqkv, bqkv, table, heads: int, window: int,
                            shift: int, dtype, eps: float) -> torch.Tensor:
    flag = _cuda_dtype_flag(dtype)
    _check_cuda_x(x, dtype, heads, window)
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
            _f32(table, dev))
    if dtype == torch.bfloat16:
        check_bf16_gemm(c, x, *args[:3], ln=True)
    err = _lib().window_attn_heads_launch(
        flag, int(x.dtype == torch.bfloat16), x.data_ptr(), *(a.data_ptr() for a in args),
        ptr(stats), qkv.data_ptr(), o.data_ptr(), b, h, w, c, heads, window, shift, eps,
        (c // heads) ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "window_attn_heads")
    window_attn_heads.launches += 1
    return o


window_attn_heads.launches = 0


def _padded_rows(x, window: int) -> int:
    b, h, w, _ = x.shape
    hp, wp = padded_hw(h, w, window)
    return b * hp * wp


_heads_op = ops.define(
    "window_attn_heads(Tensor x, Tensor ln_weight, Tensor ln_bias, Tensor wqkv, Tensor bqkv, "
    "Tensor table, int heads, int window, int shift, ScalarType dtype, float eps) -> Tensor",
    cpu=lambda x, lnw, lnb, wqkv, bqkv, table, heads, window, shift, dtype, eps:
        window_attn_heads_plain(x, lnw, lnb, wqkv, bqkv, table, heads=heads, window=window,
                                shift=shift, dtype=dtype, eps=eps),
    cuda=_window_attn_heads_cuda,
    fake=lambda x, lnw, lnb, wqkv, bqkv, table, heads, window, shift, dtype, eps:
        x.new_empty((_padded_rows(x, window), x.shape[-1]), dtype=dtype))


def ln_stats_scratch(x: torch.Tensor, dtype):
    """The f32 launches' per-token mean | rstd scratch [2, B * H * W]; the
    bf16 launches need none (None)."""
    if dtype == torch.bfloat16:
        return None
    b, h, w, _ = x.shape
    return torch.empty((2, b * h * w), dtype=torch.float32, device=x.device)


def ptr(t):
    """t's device pointer for a launcher, or None (NULL)."""
    return None if t is None else t.data_ptr()


def window_attn_qkv(x, ln_weight, ln_bias, wqkv, bqkv, *, window: int, shift: int, dtype,
                    eps: float = EPS) -> torch.Tensor:
    """The heads launcher's qkv product alone (its LN pass and GEMM): x
    [B, H, W, C] -> qkv [B * nW * n, 3C] of `dtype` in window order (see
    `window_attn_qkv_plain`). Off the main path, which runs these kernels
    inside `window_attn_heads`: for tests and measurement."""
    return _qkv_op(x, ln_weight, ln_bias, wqkv, bqkv, window, shift, dtype, eps)


def _window_attn_qkv_cuda(x, ln_weight, ln_bias, wqkv, bqkv, window: int, shift: int, dtype,
                          eps: float) -> torch.Tensor:
    flag = _cuda_dtype_flag(dtype)
    c = x.shape[-1]
    if x.ndim != 4 or tuple(wqkv.shape) != (3 * c, c):
        raise ValueError(f"window_attn_qkv: x [B, H, W, C] and wqkv [3C, C], got "
                         f"{tuple(x.shape)} and {tuple(wqkv.shape)}")
    # no cap on the window or the head size here: only the attention has one
    _check_cuda_x(x, dtype, 1, window, max_tokens=window * window, max_head_dim=c)
    b, h, w, _ = x.shape
    hp, wp = padded_hw(h, w, window)
    dev = x.device
    qkv = torch.empty((b * hp * wp, 3 * c), dtype=dtype, device=dev)
    if qkv.numel() == 0:
        return qkv
    stats = ln_stats_scratch(x, dtype)
    lnx = torch.empty((b * hp * wp, c), dtype=dtype, device=dev) if stats is None else None
    args = (_f32(ln_weight, dev), _f32(ln_bias, dev),
            wqkv.detach().to(device=dev, dtype=dtype).contiguous(), _f32(bqkv, dev))
    if dtype == torch.bfloat16:
        check_bf16_gemm(c, x, *args[:3], ln=True)
    err = _lib().window_attn_qkv_launch(
        flag, int(x.dtype == torch.bfloat16), x.data_ptr(), *(a.data_ptr() for a in args),
        ptr(stats), ptr(lnx), qkv.data_ptr(), b, h, w, c, window, shift, eps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "window_attn_qkv")
    window_attn_qkv.launches += 1
    return qkv


window_attn_qkv.launches = 0

_qkv_op = ops.define(
    "window_attn_qkv(Tensor x, Tensor ln_weight, Tensor ln_bias, Tensor wqkv, Tensor bqkv, "
    "int window, int shift, ScalarType dtype, float eps) -> Tensor",
    cpu=lambda x, lnw, lnb, wqkv, bqkv, window, shift, dtype, eps: window_attn_qkv_plain(
        x, lnw, lnb, wqkv, bqkv, window=window, shift=shift, dtype=dtype, eps=eps),
    cuda=_window_attn_qkv_cuda,
    fake=lambda x, lnw, lnb, wqkv, bqkv, window, shift, dtype, eps:
        x.new_empty((_padded_rows(x, window), 3 * x.shape[-1]), dtype=dtype))


def check_proj(o, wproj, out_shape, window: int) -> None:
    """The projection's shapes: o [B * nW * n, C] and wproj [C, C] of out_shape."""
    b, h, w, c = out_shape
    hp, wp = padded_hw(h, w, window)
    if tuple(o.shape) != (b * hp * wp, c) or tuple(wproj.shape) != (c, c):
        raise ValueError(f"window_attn_proj: o {tuple(o.shape)} / wproj "
                         f"{tuple(wproj.shape)} do not fit out_shape {tuple(out_shape)}")


def proj_cuda(o, wproj, bproj, out_shape, heads: int, window: int, shift: int, dtype,
              counter) -> torch.Tensor:
    """The projection launch behind the ops `window_attn_proj` and
    `window_attn_relpos_proj`; a launch is counted on `counter`."""
    b, h, w, c = out_shape
    flag = _cuda_dtype_flag(dtype)
    if o.dtype != dtype or not o.is_contiguous():
        raise TypeError(f"window_attn_proj: o must be contiguous {dtype}, got {o.dtype}")
    dev = o.device
    out = torch.empty(tuple(out_shape), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    wp_t = wproj.detach().to(device=dev, dtype=dtype).contiguous()
    bp_t = _f32(bproj, dev)
    if dtype == torch.bfloat16:
        check_bf16_gemm(c, o, wp_t)
    err = _lib().window_attn_proj_launch(
        flag, o.data_ptr(), wp_t.data_ptr(), bp_t.data_ptr(), out.data_ptr(),
        b, h, w, c, heads, window, shift, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "window_attn_proj")
    counter.launches += 1
    return out


def proj_fake(o, wproj, bproj, out_shape, *geo) -> torch.Tensor:
    """The projection ops' fake implementation; their last argument is the
    dtype."""
    return o.new_empty(tuple(out_shape), dtype=geo[-1])


def window_attn_proj(o, wproj, bproj, *, out_shape, heads: int, window: int, shift: int,
                     dtype) -> torch.Tensor:
    """o [B * nW * n, C] -> out [B, H, W, C] of `dtype` (see
    `window_attn_proj_plain`)."""
    check_proj(o, wproj, out_shape, window)
    return _proj_op(o, wproj, bproj, list(out_shape), heads, window, shift, dtype)


window_attn_proj.launches = 0

_proj_op = ops.define(
    "window_attn_proj(Tensor o, Tensor wproj, Tensor bproj, int[] out_shape, int heads, "
    "int window, int shift, ScalarType dtype) -> Tensor",
    cpu=lambda o, wproj, bproj, out_shape, heads, window, shift, dtype: window_attn_proj_plain(
        o, wproj, bproj, out_shape=out_shape, window=window, shift=shift, dtype=dtype),
    cuda=lambda o, wproj, bproj, out_shape, heads, window, shift, dtype: proj_cuda(
        o, wproj, bproj, out_shape, heads, window, shift, dtype, window_attn_proj),
    fake=proj_fake)


def _launch_branch(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, table, *, heads: int,
                   window: int, shift: int, dtype, eps: float) -> torch.Tensor:
    o = window_attn_heads(x, ln_weight, ln_bias, wqkv, bqkv, table, heads=heads,
                          window=window, shift=shift, dtype=dtype, eps=eps)
    return window_attn_proj(o, wproj, bproj, out_shape=tuple(x.shape), heads=heads,
                            window=window, shift=shift, dtype=dtype)


class _WindowAttn(torch.autograd.Function):
    """Forward: the two launches (no graph is recorded through them).
    Backward: recompute the branch through `window_attn_plain` on the saved
    x and parameters and return its gradients, as the JAX package's
    `_fused_attn_fn` recomputes through its unfused branch; no backward
    kernel exists there or here."""

    @staticmethod
    def forward(ctx, geo, *tensors):
        ctx.geo = geo
        ctx.save_for_backward(*tensors)
        return _launch_branch(*tensors, **geo)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[1:]
        leaves = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = window_attn_plain(*leaves, **ctx.geo)
        wanted = [t for t, need in zip(leaves, needs) if need]
        grads = iter(torch.autograd.grad(out, wanted, g.to(out.dtype), allow_unused=True))
        return (None,) + tuple(next(grads) if need else None for need in needs)


def needs_graph(*tensors) -> bool:
    """True when autograd would record a graph through these inputs."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def window_attn(x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, table, *, heads: int,
                window: int, shift: int, dtype, eps: float = EPS) -> torch.Tensor:
    """The attention branch of a Swin block, [B, H, W, C] -> [B, H, W, C]
    of `dtype` (pre-residual): `window_attn_heads` then `window_attn_proj`.

    Differentiable in x and every parameter: when an input requires grad
    the call is a `torch.autograd.Function` whose backward recomputes the
    branch through `window_attn_plain` (on the card the kernels record no
    graph themselves). Without grad it is the two launches and nothing
    else."""
    tensors = (x, ln_weight, ln_bias, wqkv, bqkv, wproj, bproj, table)
    geo = dict(heads=heads, window=window, shift=shift, dtype=dtype, eps=eps)
    if needs_graph(*tensors):
        return _WindowAttn.apply(geo, *tensors)
    return _launch_branch(*tensors, **geo)


def _lib() -> ctypes.CDLL:
    lib = build.load("window_attn")
    lib.window_attn_heads_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    lib.window_attn_heads_launch.restype = ctypes.c_int
    lib.window_attn_qkv_launch.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_void_p])
    lib.window_attn_qkv_launch.restype = ctypes.c_int
    lib.window_attn_proj_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.window_attn_proj_launch.restype = ctypes.c_int
    return lib

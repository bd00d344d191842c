"""SAM's global-attention blocks: a hand-written flash kernel with the
decomposed relative-position bias, and a launch counter.

For head h of query i and key j of a gh x gw grid (a query's row offset by
`row0` where a sequence-sharded block holds rows row0 ... of the kh-row map):

    s[i, j] = (q_i . k_j) * hd^-1/2 + q_i . Rh[r_i - r_j + kh - 1]
                                    + q_i . Rw[c_i - c_j + gw - 1]
    o_i = sum_j softmax_j(s[i, :]) v_j      -> [B, qn, heads * hd]

q, k, v are [B, n, heads, hd], as the qkv linear gives them (strided views,
no permute copies); o is ready for the block's projection.

Replaces no TPU kernel: the JAX package leaves these blocks to XLA, which
fuses the bias and the softmax. The plain version is
`ops/relpos_attn.py relpos_attention`, the eager chain that the windowed
blocks run: an einsum writing the scores, the two bias terms, the softmax
in f32 between two copies, a second einsum. The kernel
(csrc/sam_global_attn.cu) keeps the scores and probabilities out of device
memory: wgmma with TMA for bf16 at head dims 64 and 80 and grids of up to
64 x 64 (every SAM size and encode), a plain SIMT kernel for f32 and any
other shape. Its sums are f32 and its scores are not rounded, where the
chain rounds the scores, the bias terms and p to the compute dtype.

Dispatch: `sam_global_attn` resizes a table on its device where the grid
is not its own (`resize_rel_pos`, as `get_rel_pos` would; `models/sam.py
Attention` hands it tables it has resized once), so the block copies no
index from the host, then calls the dispatcher op
`cm3d_torch::sam_global_attn` (kernels/ops.py): a CPU tensor runs the plain
chain, bit for bit the block's code before the kernel; a CUDA tensor
launches the kernel or raises, and never falls back to the chain or to a
library attention.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cm3d_tpu_torch.kernels import build, ops
from cm3d_tpu_torch.kernels.window_attn import needs_graph
from cm3d_tpu_torch.ops.relpos_attn import relpos_attention, resize_rel_pos

WGMMA_HEAD_DIMS = (64, 80)
MAX_WGMMA_GRID = 64  # rows and columns; SAM's position table is at most 64 square


def _check(q, k, v, rel_h, rel_w, q_hw, k_hw, row0: int) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"sam_global_attn: q, k, v must be [B, n, heads, hd] with the same "
                         f"B, heads and hd, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    (qh, gw), (kh, kw) = q_hw, k_hw
    if kw != gw or qh * gw != q.shape[1] or kh * kw != k.shape[1] or not 0 <= row0 <= kh - qh:
        raise ValueError(f"sam_global_attn: grids {tuple(q_hw)} (from row {row0}) and "
                         f"{tuple(k_hw)} do not fit {q.shape[1]} queries and {k.shape[1]} keys")
    hd = q.shape[-1]
    if rel_h.shape[1:] != (hd,) or rel_w.shape[1:] != (hd,):
        raise ValueError(f"sam_global_attn: the tables must be [rows, {hd}], got "
                         f"{tuple(rel_h.shape)} and {tuple(rel_w.shape)}")


def route(dtype, hd: int, kh: int, gw: int) -> str:
    """Which kernel a launch takes: "wgmma" (bf16, head dim 64 or 80, a grid
    of at most 64 x 64) or "simt" (anything else)."""
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS and kh <= MAX_WGMMA_GRID \
            and gw <= MAX_WGMMA_GRID:
        return "wgmma"
    return "simt"


def _token_stride(t, heads: int, hd: int) -> int:
    """The element stride between tokens of a [B, n, heads, hd] view whose
    heads and channels are dense, and whose images follow each other."""
    b, n = t.shape[:2]
    if t.stride(3) != 1 or t.stride(2) != hd or (
            n > 1 and b > 1 and t.stride(0) != n * t.stride(1)):
        raise ValueError(f"sam_global_attn: [B, n, heads, hd] needs dense heads and channels "
                         f"and images one after another, got strides {t.stride()}")
    return t.stride(1) if n > 1 else heads * hd


def _cuda(q, k, v, rel_h, rel_w, q_hw, k_hw, row0: int) -> torch.Tensor:
    _check(q, k, v, rel_h, rel_w, q_hw, k_hw, row0)
    dtype = q.dtype
    if dtype not in (torch.bfloat16, torch.float32) or k.dtype != dtype or v.dtype != dtype:
        raise ValueError(f"sam_global_attn: q, k, v must share a dtype of bf16 or f32, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, qn, heads, hd = q.shape
    (qh, gw), kh = q_hw, k_hw[0]
    dev = q.device
    tables = []
    for t, rows in ((rel_h, 2 * kh - 1), (rel_w, 2 * gw - 1)):
        if t.shape[0] != rows or t.device != dev or t.dtype not in (dtype, torch.float32):
            raise ValueError(f"sam_global_attn: a table of {rows} rows in {dtype} or f32 on "
                             f"{dev} (resize_rel_pos), got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
        tables.append(t.contiguous())
    rel_h, rel_w = tables
    tab_f32 = int(rel_h.dtype == torch.float32) | int(rel_w.dtype == torch.float32) << 1
    o = torch.empty((b, qn, heads * hd), dtype=dtype, device=dev)
    if o.numel() == 0:
        return o
    qs, kvs = _token_stride(q, heads, hd), _token_stride(k, heads, hd)
    if _token_stride(v, heads, hd) != kvs:
        raise ValueError("sam_global_attn: k and v must have the same token stride")
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), qs, kvs, rel_h.data_ptr(), rel_w.data_ptr(),
            tab_f32, o.data_ptr(), b, heads, hd, qh, gw, kh, row0, hd ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    aligned = all(p % 16 == 0 for p in args[:3]) and qs % 8 == 0 and kvs % 8 == 0
    if route(dtype, hd, kh, gw) == "wgmma" and aligned:
        err = _lib().sam_global_attn_bf16_launch(*args)
    else:
        err = _lib().sam_global_attn_simt_launch(int(dtype == torch.bfloat16), *args)
    build.check(err, "sam_global_attn")
    sam_global_attn.launches += 1
    return o


_op = ops.define(
    "sam_global_attn(Tensor q, Tensor k, Tensor v, Tensor rel_h, Tensor rel_w, int[] q_hw, "
    "int[] k_hw, int row0) -> Tensor",
    cpu=lambda q, k, v, rel_h, rel_w, q_hw, k_hw, row0: relpos_attention(
        q, k, v, rel_h, rel_w, q_hw=q_hw, k_hw=k_hw, row0=row0),
    cuda=_cuda,
    fake=lambda q, k, v, rel_h, rel_w, q_hw, k_hw, row0: q.new_empty(
        (q.shape[0], q.shape[1], q.shape[2] * q.shape[3])))


def sam_global_attn(q, k, v, rel_h, rel_w, *, q_hw, k_hw, row0: int = 0) -> torch.Tensor:
    """A global block's attention, [B, qh*gw, heads*hd] of q's dtype (see
    the module docstring). rel_h / rel_w: the block's tables in its compute
    dtype, of any row count. Under autograd on the CPU it is the plain chain
    itself (the op registers no autograd kernel); on the card it raises, as
    SAM has no backward there."""
    _check(q, k, v, rel_h, rel_w, q_hw, k_hw, row0)
    if needs_graph(q, k, v, rel_h, rel_w):
        if q.device.type == "cuda":
            raise NotImplementedError(
                "sam_global_attn has no backward on the card: SAM's training is not part of "
                "the JAX package. Run under torch.no_grad(), or differentiate "
                "relpos_attention")
        return relpos_attention(q, k, v, rel_h, rel_w, q_hw=q_hw, k_hw=k_hw, row0=row0)
    rel_h = resize_rel_pos(rel_h, 2 * k_hw[0] - 1)
    rel_w = resize_rel_pos(rel_w, 2 * k_hw[1] - 1)
    return _op(q, k, v, rel_h, rel_w, list(q_hw), list(k_hw), row0)


sam_global_attn.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("sam_global_attn")
    common = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 2
              + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7
              + [ctypes.c_float, ctypes.c_void_p])
    lib.sam_global_attn_bf16_launch.argtypes = common
    lib.sam_global_attn_simt_launch.argtypes = [ctypes.c_int] + common
    lib.sam_global_attn_bf16_launch.restype = ctypes.c_int
    lib.sam_global_attn_simt_launch.restype = ctypes.c_int
    return lib

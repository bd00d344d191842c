"""Attention with SAM / ViTDet's decomposed relative positions, as plain
PyTorch (mirrors the rel-pos helpers of `cm3d_tpu/models/common.py`).

`relpos_attention` is the eager chain a SAM encoder block runs: an einsum
writing the scores, the two bias terms of `add_decomposed_rel_pos_bnhc`,
the softmax in f32 between two copies, a second einsum. The windowed
blocks run it on every device; the global blocks run it on the CPU, as the
plain version of the flash kernel `kernels/sam_global_attn.py`.
"""

from __future__ import annotations

import torch

from cm3d_tpu_torch.utils.observability import span


def resize_rel_pos(rel_pos: torch.Tensor, rows: int) -> torch.Tensor:
    """A relative-position table [n, head_dim] with `rows` rows: itself when
    it has them, else its F.interpolate(mode="linear", align_corners=False)
    resize in float32 (source positions (i + 0.5) * n/rows - 0.5, clamped
    to the table), computed where the table lies."""
    if rel_pos.shape[0] == rows:
        return rel_pos
    orig = rel_pos.shape[0]
    dev = rel_pos.device
    pos = (torch.arange(rows, device=dev, dtype=torch.float32) + 0.5) * (orig / rows) - 0.5
    pos = pos.clamp(0, orig - 1)
    lo = torch.floor(pos).to(torch.int64)
    hi = (lo + 1).clamp(max=orig - 1)
    frac = (pos - lo)[:, None]
    return rel_pos[lo] * (1 - frac) + rel_pos[hi] * frac


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Select (and if needed interpolate) relative position embeddings.

    rel_pos: [2*max_size - 1, head_dim] -> [q_size, k_size, head_dim]. The
    resize is F.interpolate(mode="linear") with align_corners=False: source
    positions (i + 0.5) * src/dst - 0.5, clamped to the table."""
    rel_pos = resize_rel_pos(rel_pos, 2 * max(q_size, k_size) - 1)
    q_coords = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    with span("cm3d.h2d.wait"):  # from pageable memory: the host waits for the copy
        idx = rel.to(torch.int64).to(rel_pos.device)
    return rel_pos[idx]


def add_decomposed_rel_pos_bnhc(attn: torch.Tensor, q: torch.Tensor,
                                rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                                q_hw, k_hw, q_rows=None) -> torch.Tensor:
    """SAM/ViTDet decomposed relative position bias for heads-minor q.

    attn: [B, heads, qh*qw, kh*kw]; q: [B, qh*qw, heads, head_dim] (the raw
    q, before the attention scale). `q_rows` = (row0, grid_h): the queries
    are the rows row0 ... row0 + qh - 1 of a grid_h-row grid (one rank's
    rows of a sequence-sharded map, `parallel/sharding.py`)."""
    qh, qw = q_hw
    kh, kw = k_hw
    row0, grid_h = q_rows or (0, qh)
    rh = get_rel_pos(grid_h, kh, rel_pos_h)[row0:row0 + qh]  # [qh, kh, d]
    rw = get_rel_pos(qw, kw, rel_pos_w)  # [qw, kw, d]
    b, _, heads, _ = q.shape
    # an interpolated table comes back f32: the einsums promote, as JAX's do
    dt = torch.promote_types(q.dtype, rh.dtype)
    r_q = q.reshape(b, qh, qw, heads, -1).to(dt)
    rel_h = torch.einsum("bhwnc,hkc->bnhwk", r_q, rh.to(dt)).reshape(b, heads, qh * qw, kh, 1)
    rel_w = torch.einsum("bhwnc,wkc->bnhwk", r_q, rw.to(dt)).reshape(b, heads, qh * qw, 1, kw)
    attn = attn.reshape(b, heads, qh * qw, kh, kw) + rel_h + rel_w
    return attn.reshape(b, heads, qh * qw, kh * kw)


def relpos_attention(q, k, v, rel_h, rel_w, *, q_hw, k_hw, row0: int = 0) -> torch.Tensor:
    """q [B, qh*gw, heads, hd], k / v [B, kh*gw, heads, hd] (the queries
    the rows row0 ... of the kh-row key map), the tables in the compute
    dtype or resized in f32 -> [B, qh*gw, heads*hd] of q's dtype."""
    b, qn, heads, hd = q.shape
    attn = torch.einsum("bqhc,bkhc->bhqk", q * hd ** -0.5, k)
    # the bias uses the raw q, not the scaled one
    attn = add_decomposed_rel_pos_bnhc(attn, q, rel_h, rel_w, tuple(q_hw), tuple(k_hw),
                                       q_rows=(row0, k_hw[0]))
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhc->bqhc", attn, v).reshape(b, qn, heads * hd)

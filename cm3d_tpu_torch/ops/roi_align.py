"""ROIAlign with aligned (V2) semantics and a fixed 2x2 sampling grid,
mirrors `cm3d_tpu/ops/roi_align.py`.

Bilinear sampling on the separable (ys x xs) grid of each ROI is two
bin-averaged interpolation-matrix products, pooled = My @ F @ Mx^T, which
give the same numbers as a per-sample gather. A sample outside
[-1, size] contributes 0 (torchvision's skip rule); coordinates inside are
clamped to [0, size - 1] as detectron2's CUDA kernel does. Batched over a
leading image axis.
"""

from __future__ import annotations

import torch


def _interp_matrix(coords: torch.Tensor, size: int, oo: int, s: int) -> torch.Tensor:
    """[..., oo*s] continuous coords -> [..., oo, size] bin-averaged
    bilinear weights (rows sum to <= 1)."""
    c0 = torch.floor(coords)
    frac = coords - c0
    c0i = c0.to(torch.int64).clamp(0, size - 1)
    c1i = (c0i + 1).clamp(0, size - 1)
    w1 = torch.where(coords <= 0, 0.0, torch.where(coords >= size - 1, 0.0, frac))
    valid = ((coords >= -1.0) & (coords <= size)).to(coords.dtype)
    rng = torch.arange(size, device=coords.device)
    m = (rng == c0i[..., None]) * ((1.0 - w1) * valid)[..., None] \
        + (rng == c1i[..., None]) * (w1 * valid)[..., None]
    return m.reshape(*coords.shape[:-1], oo, s, size).mean(dim=-2)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size: int = 7,
              sampling_ratio: int = 2) -> torch.Tensor:
    """features [B, H, W, C], boxes [B, R, 4] xyxy in feature-grid
    coordinates -> [B, R, output_size, output_size, C] f32."""
    _, h, w, _ = features.shape
    oo, s = output_size, sampling_ratio
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_w = torch.clamp(x2 - x1, min=1e-6) / oo
    bin_h = torch.clamp(y2 - y1, min=1e-6) / oo
    grid = (torch.arange(oo, device=boxes.device)[:, None]
            + (torch.arange(s, device=boxes.device)[None, :] + 0.5) / s).reshape(-1)
    ys = y1[..., None] + grid * bin_h[..., None] - 0.5  # [B, R, oo*s]
    xs = x1[..., None] + grid * bin_w[..., None] - 0.5
    my = _interp_matrix(ys.float(), h, oo, s)  # [B, R, oo, H]
    mx = _interp_matrix(xs.float(), w, oo, s)  # [B, R, oo, W]
    rows = torch.einsum("nrah,nhwc->nrawc", my, features.float())
    return torch.einsum("nrawc,nrbw->nrabc", rows, mx)


def assign_fpn_levels(boxes: torch.Tensor, min_level: int, max_level: int,
                      canonical_size: float = 224.0, canonical_level: int = 4) -> torch.Tensor:
    """detectron2 level assignment: floor(canonical + log2(sqrt(area)/size))."""
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) \
        * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int64)


def multilevel_roi_align(features: dict, boxes: torch.Tensor, strides: dict,
                         output_size: int = 7, min_level: int = 3,
                         max_level: int = 5) -> torch.Tensor:
    """Pool each ROI from its assigned FPN level. features {level:
    [B, H_l, W_l, C]}, boxes [B, R, 4] xyxy in image coordinates."""
    levels = assign_fpn_levels(boxes, min_level, max_level)
    out = None
    for lvl in range(min_level, max_level + 1):
        pooled = roi_align(features[lvl], boxes / strides[lvl], output_size)
        sel = (levels == lvl)[..., None, None, None].to(pooled.dtype)
        out = pooled * sel if out is None else out + pooled * sel
    return out

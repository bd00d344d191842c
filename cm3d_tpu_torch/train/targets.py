"""Training targets: boxes -> gaussian heatmaps + dense regression targets,
mirrors `cm3d_tpu/train/targets.py`, batched over [B, M, 8] boxes.

CenterPoint target construction: each box splats a gaussian at its center
cell (radius from the box footprint), regression targets live at the center
cell only. Boxes arrive padded (x, y, z, w, l, h, yaw, class) with a
validity mask.
"""

from __future__ import annotations

import torch

from cm3d_tpu_torch.train.voxelize import PillarConfig


def gaussian_radius(l_cells: torch.Tensor, w_cells: torch.Tensor,
                    min_overlap: float = 0.1) -> torch.Tensor:
    """CenterNet radius heuristic, clamped to >= 1 cell."""
    b1 = l_cells + w_cells
    c1 = w_cells * l_cells * (1 - min_overlap) / (1 + min_overlap)
    sq1 = torch.sqrt((b1 * b1 - 4 * c1).clamp(min=0.0))
    r1 = (b1 + sq1) / 2
    return torch.minimum(r1 / 6.0, torch.minimum(l_cells, w_cells)).clamp(min=1.0)


@torch.no_grad()
def build_targets(boxes: torch.Tensor, box_valid: torch.Tensor, pillar_cfg: PillarConfig,
                  num_classes: int, out_stride: int = 2):
    """boxes [B, M, 8], box_valid [B, M] -> (heatmap [B, H', W', C], reg
    [B, H', W', 8], reg_mask [B, H', W']) where reg = (dx, dy, z, log w,
    log l, log h, sin, cos). Unbatched [M, 8] input gives unbatched maps.

    Boxes outside the grid are dropped, not clamped. Two boxes in one cell
    collide: the box with the higher index wins, on every device (the
    order-dependent scatter of the JAX package's CPU path gives the same)."""
    if boxes.ndim == 2:
        return tuple(t[0] for t in build_targets(boxes[None], box_valid[None], pillar_cfg,
                                                 num_classes, out_stride))
    gh, gw = pillar_cfg.grid_hw
    h, w = gh // out_stride, gw // out_stride
    res = pillar_cfg.resolution * out_stride
    bsz, m = boxes.shape[:2]
    dev = boxes.device
    boxes = boxes.float()

    cx = (boxes[..., 0] - pillar_cfg.x_min) / res
    cy = (boxes[..., 1] - pillar_cfg.y_min) / res
    ix = torch.floor(cx).to(torch.int64)
    iy = torch.floor(cy).to(torch.int64)
    in_grid = box_valid & (ix >= 0) & (ix < h) & (iy >= 0) & (iy < w)

    sigma = gaussian_radius(boxes[..., 4] / res, boxes[..., 3] / res) / 3.0

    # gaussians center on the INTEGER center cell (CenterNet convention: the
    # peak is exactly 1.0 there; the offset head owns the fraction); grid
    # axis 0 is x
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    bx = ix.float()[..., None, None]
    by = iy.float()[..., None, None]
    r = sigma[..., None, None]
    g = torch.exp(-(((ys - bx) ** 2) + ((xs - by) ** 2)) / (2 * r * r))  # [B, M, H', W']
    g = torch.where(in_grid[..., None, None], g, torch.zeros_like(g))
    cls = boxes[..., 7].to(torch.int64)
    # per-class maximum over the boxes, one class at a time: the one-hot
    # product of all classes at once is B x M x H' x W' x C floats
    heatmap = torch.stack([
        (g * (cls == c)[..., None, None]).amax(dim=1) for c in range(num_classes)
    ], dim=-1)

    vals = torch.stack([
        cx - (ix.float() + 0.5),
        cy - (iy.float() + 0.5),
        boxes[..., 2],
        torch.log(boxes[..., 3].clamp(min=1e-3)),
        torch.log(boxes[..., 4].clamp(min=1e-3)),
        torch.log(boxes[..., 5].clamp(min=1e-3)),
        torch.sin(boxes[..., 6]),
        torch.cos(boxes[..., 6]),
    ], dim=-1)  # [B, M, 8]
    # regression at center cells. A cell's writer is the in-grid box of the
    # highest index; every other box writes to a sink cell that is cut off,
    # so no real cell is written twice and the result does not depend on
    # the order a device applies the writes in
    flat = torch.where(in_grid, ix * w + iy, h * w)
    later = torch.arange(m, device=dev)[None, :] > torch.arange(m, device=dev)[:, None]
    same = (flat[:, :, None] == flat[:, None, :]) & in_grid[:, None, :]
    loses = (same & later[None]).any(dim=-1)
    flat = torch.where(loses, h * w, flat)
    rows = torch.arange(bsz, device=dev)[:, None].expand(bsz, m)
    reg = torch.zeros((bsz, h * w + 1, 8), dtype=torch.float32, device=dev)
    reg[rows, flat] = vals
    reg_mask = torch.zeros((bsz, h * w + 1), dtype=torch.bool, device=dev)
    reg_mask[rows, flat] = True
    return (heatmap, reg[:, : h * w].reshape(bsz, h, w, 8),
            reg_mask[:, : h * w].reshape(bsz, h, w))


def _global_count(count: torch.Tensor) -> torch.Tensor:
    """`count` summed over the default group inside the data-parallel train
    step (parallel.mesh.global_batch): each rank's loss is then its own
    numerator over the global batch's denominator, so the ranks' gradients
    SUM to the single-device gradient. Elsewhere `count` itself."""
    from cm3d_tpu_torch.parallel.mesh import in_global_batch

    if in_global_batch():
        import torch.distributed as dist

        count = count.detach().clone()
        dist.all_reduce(count)
    return count


def focal_loss(pred_logits: torch.Tensor, gt: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss (CenterNet eq. 1)."""
    p = torch.sigmoid(pred_logits)
    pos = (gt >= 0.999).float()
    neg = 1.0 - pos
    pos_loss = -pos * ((1 - p) ** alpha) * torch.log(p.clamp(min=1e-8))
    neg_loss = -neg * ((1 - gt) ** beta) * (p ** alpha) * torch.log((1 - p).clamp(min=1e-8))
    n_pos = _global_count(pos.sum()).clamp(min=1.0)
    return (pos_loss.sum() + neg_loss.sum()) / n_pos


def reg_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 over the 8 regression channels at center cells."""
    m = mask.float()[..., None]
    return ((pred - gt).abs() * m).sum() / (_global_count(m.sum()) * 8).clamp(min=1.0)

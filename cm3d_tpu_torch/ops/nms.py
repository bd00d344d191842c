"""Greedy NMS variants (exact greedy semantics, batched).

- `circle_nms_keep`: BEV center-distance circle NMS with per-class radii,
  the CenterPoint-style greedy `circle_nms` the reference uses
  (src/nuscenes/2d_to_3d.py:309-332, thresholds :850-861).
- `nms_2d_classwise`: class-wise axis-aligned 2D box NMS, replacing the
  reference's per-class `torchvision.ops.nms` loop
  (src/nuscenes/gen_2d_masks_detic.py:348-372).
- `polygon_nms_keep`: rotated-box BEV NMS by intersection over the
  candidate's own area (the reference's shapely polygon NMS).

Boxes are sorted by score descending with a STABLE sort, so tie-breaking
is deterministic.
"""

from __future__ import annotations

import torch

from cm3d_tpu_torch.utils.observability import span


def _greedy_keep_fixpoint(overlap: torch.Tensor, valid_sorted: torch.Tensor) -> torch.Tensor:
    """Exact greedy-NMS keep flags from a precomputed overlap matrix.

    overlap: [..., N, N] bool in descending-score order; overlap[i, j] True
    iff box i would suppress box j (only i < j is used). valid_sorted:
    [..., N] bool. The recurrence keep[j] = valid[j] & ~any_{i<j}(overlap[i,j]
    & keep[i]) has a unique solution; iterating the whole-vector operator
    reaches it after (suppression-chain depth + 1) sweeps, each one masked
    [N, N] reduction, instead of N sequential steps.
    """
    n = overlap.shape[-1]
    upper = torch.ones((n, n), dtype=torch.bool, device=overlap.device).triu(1)
    ov = overlap & upper & valid_sorted[..., :, None]

    def sweep(keep):
        return valid_sorted & ~(ov & keep[..., :, None]).any(dim=-2)

    if torch.compiler.is_compiling():
        # traced (torch.export, deploy.py): the same sweeps as a while_loop
        # over (keep, previous keep), as the JAX package's lax.while_loop
        from torch._higher_order_ops.while_loop import while_loop

        keep, _ = while_loop(lambda keep, prev: (keep != prev).any(),
                             lambda keep, prev: (sweep(keep), keep.clone()),
                             (sweep(valid_sorted), valid_sorted.clone()))
        return keep
    # eager: one host sync a sweep
    keep = valid_sorted
    while True:
        new = sweep(keep)
        with span("cm3d.nms.wait"):
            converged = torch.equal(new, keep)
        if converged:
            return keep
        keep = new


def circle_nms_keep(
    centers_xy: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    radius_sq_by_label: torch.Tensor,
) -> torch.Tensor:
    """Greedy BEV circle NMS over the last box axis.

    Args:
      centers_xy: [..., N, 2] box centers.
      scores: [..., N].
      labels: [..., N] int class ids.
      valid: [..., N] bool.
      radius_sq_by_label: [num_classes] squared-distance thresholds, indexed
        by label (the reference's `threshs_by_label` values ARE squared
        thresholds; reproduced as-is).

    Returns keep [..., N] bool. A box is kept iff, scanning boxes in
    descending score order, it has not been suppressed by an earlier *kept*
    box of the same class within the class radius (reference :317-332).
    """
    neg = torch.where(valid, scores, -torch.inf)
    order = torch.sort(-neg, dim=-1, stable=True).indices  # descending, stable

    cx = torch.gather(centers_xy[..., 0], -1, order)
    cy = torch.gather(centers_xy[..., 1], -1, order)
    lab = torch.gather(labels, -1, order)
    val = torch.gather(valid, -1, order)
    thresh = radius_sq_by_label[lab.long()]

    dx = cx[..., :, None] - cx[..., None, :]
    dy = cy[..., :, None] - cy[..., None, :]
    dist_sq = dx * dx + dy * dy
    # row i suppresses col j: same class, within the SUPPRESSED box j's class
    # radius (the reference indexes threshs_by_label[det_labels[j]])
    overlap = (lab[..., :, None] == lab[..., None, :]) & (dist_sq <= thresh[..., None, :])
    keep_sorted = _greedy_keep_fixpoint(overlap, val)
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def nms_2d_classwise(
    boxes_xyxy: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float = 0.75,
) -> torch.Tensor:
    """Greedy class-wise axis-aligned NMS over the last box axis. Returns
    keep [..., N] bool.

    torchvision.ops.nms semantics per class: boxes sorted by score
    descending; a box is suppressed if its IoU with a higher-scored kept box
    of the same class is strictly greater than `iou_threshold`; IoU is 0
    where the union is 0.
    """
    neg = torch.where(valid, scores, -torch.inf)
    order = torch.sort(-neg, dim=-1, stable=True).indices
    b = torch.gather(boxes_xyxy, -2, order[..., None].expand(*order.shape, 4))
    lab = torch.gather(labels, -1, order)
    val = torch.gather(valid, -1, order)
    x1, y1, x2, y2 = b.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)
    overlap = (lab[..., :, None] == lab[..., None, :]) & (iou > iou_threshold)
    keep_sorted = _greedy_keep_fixpoint(overlap, val)
    return torch.zeros_like(valid).scatter(-1, order, keep_sorted)


def polygon_nms_keep(
    boxes_bev: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    nms_threshold: float = 0.4,
    score_threshold: float = 0.3,
) -> torch.Tensor:
    """Greedy rotated-box BEV NMS. boxes_bev: [N, 5] (cx, cy, w, l, yaw).
    Mirrors `cm3d_tpu/ops/nms.py polygon_nms_keep`.

    The reference ships (but never calls) a shapely polygon-NMS
    (src/kitti/2d_to_3d.py nms:507-599); this has the SAME criterion: a
    candidate is suppressed when a kept higher-scored box's intersection
    covers more than nms_threshold of the CANDIDATE'S OWN area
    (poly_compare :487-505 — inter/area[candidate], NOT IoU; defaults
    0.4/0.3 from nms :524-536), and boxes scoring <= score_threshold are
    dropped up front. The intersection comes from the exact rotated-IoU
    clipper via inter = iou * (a_i + a_j) / (1 + iou). Tie-break: stable
    descending score. Returns keep [N] bool.
    """
    from cm3d_tpu_torch.geometry.boxes import rotated_iou_bev

    valid = valid & (scores > score_threshold)
    neg = torch.where(valid, scores, -torch.inf)
    order = torch.sort(-neg, stable=True).indices
    b = boxes_bev[order]
    val = valid[order]
    area = torch.clamp(b[:, 2] * b[:, 3], min=1e-9)
    iou = rotated_iou_bev(b, b)
    inter = iou * (area[:, None] + area[None, :]) / (1.0 + iou)
    overlap = inter / area[None, :]  # row i suppresses candidate column j
    keep_sorted = _greedy_keep_fixpoint(overlap > nms_threshold, val)
    return torch.zeros_like(valid).scatter(0, order, keep_sorted)

"""3D box utilities: corners, BEV footprints, 7-DoF conversion, rotated IoU.
Mirrors `cm3d_tpu/geometry/boxes.py`.

The reference computes box corners ad hoc per dataset
(src/kitti/kitti_utils.py:605-640 `compute_box_3d`; the fusion stage builds
7-DoF arrays [cx, cy, bottom_z, l, w, h, heading] in
src/nuscenes/linear_matching.py:164-172). Here they are batched torch ops.

Box convention: center [cx, cy, cz], size (w, l, h) with l along the box
heading (box-local x), yaw about +z.
"""

from __future__ import annotations

import torch


def box_corners_bev(centers: torch.Tensor, sizes_wlh: torch.Tensor,
                    yaws: torch.Tensor) -> torch.Tensor:
    """BEV footprint corners. centers [..., 2], sizes (w, l, h) [..., 3],
    yaws [...]. Returns [..., 4, 2] corners, counter-clockwise.

    Length l runs along the heading (box-local x), width w across it.
    """
    w = sizes_wlh[..., 0]
    length = sizes_wlh[..., 1]
    dx = torch.stack([length, length, -length, -length], dim=-1) / 2.0
    dy = torch.stack([w, -w, -w, w], dim=-1) / 2.0
    c, s = torch.cos(yaws)[..., None], torch.sin(yaws)[..., None]
    gx = centers[..., :1] + c * dx - s * dy
    gy = centers[..., 1:2] + s * dx + c * dy
    return torch.stack([gx, gy], dim=-1)


def box_corners_3d(centers: torch.Tensor, sizes_wlh: torch.Tensor,
                   yaws: torch.Tensor) -> torch.Tensor:
    """Full 8 corners [..., 8, 3]: bottom face then top face, CCW."""
    bev = box_corners_bev(centers[..., :2], sizes_wlh, yaws)  # [..., 4, 2]
    h = sizes_wlh[..., 2]
    z_bot = (centers[..., 2] - h / 2.0)[..., None, None].expand(*bev.shape[:-1], 1)
    z_top = (centers[..., 2] + h / 2.0)[..., None, None].expand(*bev.shape[:-1], 1)
    return torch.cat([torch.cat([bev, z_bot], -1), torch.cat([bev, z_top], -1)], dim=-2)


def boxes_to_7dof(centers: torch.Tensor, sizes_wlh: torch.Tensor,
                  yaws: torch.Tensor) -> torch.Tensor:
    """Pack to the fusion stage's 7-DoF layout
    [cx, cy, bottom_z, length, width, height, heading]
    (reference: src/nuscenes/linear_matching.py:164-172)."""
    w, length, h = sizes_wlh[..., 0], sizes_wlh[..., 1], sizes_wlh[..., 2]
    return torch.stack([centers[..., 0], centers[..., 1], centers[..., 2] - h / 2.0,
                        length, w, h, yaws], dim=-1)


def rotated_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Exact rotated-rectangle IoU in BEV between [A, 5] and [B, 5] boxes
    (cx, cy, w, l, yaw). Returns [A, B].

    Sutherland-Hodgman polygon clipping with fixed-size vertex buffers
    (rect ∩ rect has <= 8 vertices), the same algorithm and buffer layout as
    the JAX package's, so the whole pair matrix is a handful of batched ops.
    """
    def ccw_corners(b):
        wlh = torch.stack([b[:, 2], b[:, 3], b[:, 3]], -1)
        return box_corners_bev(b[:, :2], wlh, b[:, 4]).flip(1)  # clockwise -> CCW

    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    inter = _rect_intersection_area(ccw_corners(boxes_a), ccw_corners(boxes_b))
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-9),
                       torch.zeros((), dtype=inter.dtype))


def _rect_intersection_area(corners_a: torch.Tensor, corners_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of every rect pair. corners_a [A, 4, 2], corners_b
    [B, 4, 2] (CCW). Returns [A, B]. Clips A's rect against B's 4
    half-planes."""
    a_n, b_n, k = corners_a.shape[0], corners_b.shape[0], 8
    dev, dt = corners_a.device, corners_a.dtype
    poly = torch.zeros((a_n, b_n, k, 2), dtype=dt, device=dev)
    poly[:, :, :4] = corners_a[:, None]
    n = torch.full((a_n, b_n), 4, dtype=torch.int64, device=dev)
    idx = torch.arange(k, device=dev)

    for e in range(4):
        p0, p1 = corners_b[:, e], corners_b[:, (e + 1) % 4]  # [B, 2]
        d = p1 - p0
        rel = poly - p0[None, :, None, :]
        side = d[None, :, None, 0] * rel[..., 1] - d[None, :, None, 1] * rel[..., 0]
        inside = side >= 0  # [A, B, K]
        valid = idx < n[..., None]
        nxt = torch.where(idx + 1 < n[..., None], idx + 1, 0)
        v_next = torch.gather(poly, 2, nxt[..., None].expand(-1, -1, -1, 2))
        side_next = torch.gather(side, 2, nxt)
        inside_next = side_next >= 0
        denom = side - side_next
        t = side / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
        ipt = poly + t[..., None] * (v_next - poly)
        emit_v = inside & valid
        emit_i = (inside ^ inside_next) & valid
        # 2K output slots (vertex, intersection) interleaved, then a stable
        # compaction of the emitted ones to the front
        out_pts = torch.stack([poly, ipt], dim=3).reshape(a_n, b_n, 2 * k, 2)
        emit = torch.stack([emit_v, emit_i], dim=3).reshape(a_n, b_n, 2 * k)
        order = torch.sort((~emit).to(torch.uint8), dim=-1, stable=True).indices
        out_sorted = torch.gather(out_pts, 2, order[..., None].expand(-1, -1, -1, 2))
        n = torch.clamp(emit.sum(-1), max=k)
        poly = out_sorted[:, :, :k].contiguous()

    valid = idx < n[..., None]
    nxt = torch.where(idx + 1 < n[..., None], idx + 1, 0)
    x, y = poly[..., 0], poly[..., 1]
    x2, y2 = torch.gather(x, -1, nxt), torch.gather(y, -1, nxt)
    cross = x * y2 - x2 * y
    area = 0.5 * torch.where(valid, cross, torch.zeros_like(cross)).sum(-1).abs()
    return torch.where(n >= 3, area, torch.zeros_like(area))

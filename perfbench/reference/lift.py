"""Plain reference of the lift step: masks + LiDAR -> 3D boxes.

A frozen copy of the plain path of cm3d_tpu_torch/ops/lift.py and
parallel/pipeline.py (with geometry/se3.py, geometry/pointcloud.py,
ops/bitmask.py, ops/lanes.py, ops/pushback.py, ops/nms.py and the plain
versions of kernels/compact.py and kernels/medoid.py), reference CM3D
src/nuscenes/2d_to_3d.py passes 1-2 and the per-sample circle NMS.
No kernel: the compactions are a cumulative sum and a scatter, the medoid a
sum over all pairs of float64 distances. `coord_dtype` rounds the points
and the camera chain to a lower precision first (the control).

The limits come from the configuration's `lift` sizes: points a camera,
points in any mask of a camera, points a mask, the depth cut, the erosion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MEDOID_ROW_BLOCK = 32


class RefBoxes(NamedTuple):
    centers: torch.Tensor  # [B, M, 3]
    sizes: torch.Tensor  # [B, M, 3]
    yaws: torch.Tensor  # [B, M]
    scores: torch.Tensor  # [B, M]
    labels: torch.Tensor  # [B, M]
    keep: torch.Tensor  # [B, M] bool
    point_counts: torch.Tensor  # [B, M] points in each mask before the cut at K


class WorkCounts(NamedTuple):
    """What the step's compactions and medoid have to move for these inputs."""

    in_image: torch.Tensor  # [B, C] selected points of each camera row
    in_union: torch.Tensor  # [B, C] selected points of each union row
    in_mask: torch.Tensor  # [B, M] selected points of each mask row
    kept_mask: torch.Tensor  # [B, M] points each mask keeps (<= K)


def quat_to_rotmat(q):
    w, x, y, z = q.unbind(-1)
    norm = torch.sqrt(((w * w + x * x) + y * y) + z * z)
    w, x, y, z = w / norm, x / norm, y / norm, z / norm
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _matvec(m, cols):
    out = []
    for i in range(m.shape[-2]):
        acc = m[..., i, 0, None] * cols[0]
        for j in range(1, len(cols)):
            acc = acc + m[..., i, j, None] * cols[j]
        out.append(acc)
    return out


def project(points, ego_t, ego_q, cam_t, cam_q, intr):
    """Global points [B, 1, N, 3] -> pixels (x, y) and depths [B, C, N],
    each product written out elementwise in f32 (2d_to_3d.py:569-590)."""
    ego_rt = quat_to_rotmat(ego_q).transpose(-1, -2)
    cam_rt = quat_to_rotmat(cam_q).transpose(-1, -2)
    p = points - ego_t[..., None, :]
    cols = _matvec(ego_rt, [p[..., 0], p[..., 1], p[..., 2]])
    cols = [c - cam_t[..., i, None] for i, c in enumerate(cols)]
    cols = _matvec(cam_rt, cols)
    view = torch.eye(4, dtype=points.dtype, device=points.device)
    view = view.expand(intr.shape[:-2] + (4, 4)).clone()
    view[..., :3, :3] = intr
    proj = _matvec(view[..., :3, :], cols + [torch.ones_like(cols[0])])
    depth = proj[2]
    return proj[0] / depth, proj[1] / depth, depth


def _shift_ones(x, dim, by):
    n = x.shape[dim]
    fill = torch.full_like(x.narrow(dim, 0, abs(by)), -1)
    if by > 0:
        return torch.cat([fill, x.narrow(dim, 0, n - by)], dim)
    return torch.cat([x.narrow(dim, -by, n + by), fill], dim)


def erode3x3(words):
    """3x3 erosion of [B, W, H, Mw] packed masks; outside counts as set."""
    t = words & _shift_ones(words, 2, 1) & _shift_ones(words, 2, -1)
    return t & _shift_ones(t, 1, 1) & _shift_ones(t, 1, -1)


def compact(sel, values, limit):
    """The first `limit` selected sources of each row, in order: sel [R, S],
    values [R, D, S] -> [R, D, limit], zero past the count."""
    r, s = sel.shape
    d = values.shape[1]
    dest = torch.cumsum(sel.to(torch.int64), dim=1) - 1
    dest = torch.where(sel & (dest < limit), dest, limit)
    out = torch.zeros((r, d, limit + 1), dtype=values.dtype, device=values.device)
    out.scatter_(2, dest[:, None, :].expand(r, d, s), values)
    return out[:, :, :limit]


def medoid(coords, valid):
    """Index of the point with the least sum of distances to the others:
    coords [R, 3, K], valid [R, K] -> [R] (first minimum; 0 when empty)."""
    r, _, k = coords.shape
    out = torch.zeros(r, dtype=torch.int64, device=coords.device)
    x = coords.double() * valid[:, None, :]
    for i in range(0, r, MEDOID_ROW_BLOCK):
        sl = slice(i, i + MEDOID_ROW_BLOCK)
        v = valid[sl]
        n = int(v.sum(1).max()) if v.numel() else 0
        if n == 0:
            continue
        p = x[sl, :, :n].transpose(1, 2)  # valid points come first
        d = torch.cdist(p, p, compute_mode="donot_use_mm_for_euclid_dist")
        sums = (d * v[:, None, :n]).sum(-1)
        out[sl] = torch.argmin(torch.where(v[:, :n], sums, torch.inf), dim=-1)
    return out


def greedy_keep(overlap, valid_sorted):
    n = overlap.shape[-1]
    upper = torch.ones((n, n), dtype=torch.bool, device=overlap.device).triu(1)
    ov = overlap & upper & valid_sorted[..., :, None]
    keep = valid_sorted
    while True:
        new = valid_sorted & ~(ov & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            return keep
        keep = new


def circle_nms(centers_xy, scores, labels, valid, radius_sq):
    neg = torch.where(valid, scores, -torch.inf)
    order = torch.sort(-neg, dim=-1, stable=True).indices
    cx = torch.gather(centers_xy[..., 0], -1, order)
    cy = torch.gather(centers_xy[..., 1], -1, order)
    lab = torch.gather(labels, -1, order)
    val = torch.gather(valid, -1, order)
    dx = cx[..., :, None] - cx[..., None, :]
    dy = cy[..., :, None] - cy[..., None, :]
    thresh = radius_sq[lab.long()]
    overlap = (lab[..., :, None] == lab[..., None, :]) & (dx * dx + dy * dy <= thresh[..., None, :])
    return torch.zeros_like(valid).scatter(-1, order, greedy_keep(overlap, val))


def lift_and_box(f, lift: dict, priors, is_vehicle, radius_sq, coord_dtype=torch.float32):
    """f: a dict of the batch's device tensors (the Keyframe fields, cameras
    flattened as cam_ego_t, cam_ego_q, cam_t, cam_q, intrinsics); `lift`
    the configuration's lift sizes. Returns (RefBoxes, WorkCounts)."""
    round_ = (lambda t: t.to(coord_dtype).float()) if coord_dtype != torch.float32 else (
        lambda t: t)
    points = round_(f["points"][..., :3].float())
    b, n, _ = points.shape
    words = f["mask_bits"]
    _, w, h, mw = words.shape
    mask_cam, mask_valid = f["mask_cam"].long(), f["mask_valid"]
    m = mask_cam.shape[1]
    c = f["cam_t"].shape[1]
    dev = points.device
    nc = min(lift["max_points_per_camera"], n)
    nu = min(lift["max_points_in_masks"], nc)
    k = min(lift["max_points_per_mask"], nc, nu)
    if lift["erode_masks"]:
        words = erode3x3(words)

    px, py, depth = project(points[:, None], *(round_(f[key].float()) for key in (
        "cam_ego_t", "cam_ego_q", "cam_t", "cam_q", "intrinsics")))
    fx, fy = torch.floor(px).to(torch.int64), torch.floor(py).to(torch.int64)
    in_image = (f["point_valid"][:, None, :] & (depth > lift["min_dist"]) & (px > 0) & (px < w - 1)
                & (py > 0) & (py < h - 1) & (fx >= 1) & (fy >= 1))  # [B, C, N]
    n_in_image = in_image.sum(-1)
    flat = fx.clamp(0, w - 1) * h + fy.clamp(0, h - 1)

    # masks that are not valid do not count: their bits are ANDed away
    bit = torch.arange(m, device=dev)
    valid_words = torch.zeros((b, mw), dtype=torch.int64, device=dev)
    valid_words.scatter_add_(1, (bit >> 5).expand(b, m),
                             mask_valid.long() << (bit & 31))
    valid_words = torch.where(valid_words >= 1 << 31, valid_words - (1 << 32),
                              valid_words).to(torch.int32)

    # camera rows: the first NC in-image points by index
    ids = torch.arange(n, device=dev).expand(b, c, n)
    cam_vals = torch.stack([flat, ids], 2).reshape(b * c, 2, n)
    out_c = compact(in_image.reshape(b * c, n), cam_vals, nc).reshape(b, c, 2, nc)
    cam_ok = torch.arange(nc, device=dev) < n_in_image.clamp(max=nc)[..., None]
    wpts = torch.gather(words.reshape(b, w * h, mw), 1,
                        out_c[:, :, 0].reshape(b, c * nc, 1).expand(b, c * nc, mw))
    wpts = wpts.reshape(b, c, nc, mw) & valid_words[:, None, None, :]
    union = (wpts != 0).any(-1) & cam_ok  # [B, C, NC]
    n_union = union.sum(-1)
    # union rows: the first NU of them, with their words
    u_vals = torch.cat([out_c[:, :, 1:2].reshape(b * c, 1, nc).to(torch.int64),
                        wpts.reshape(b * c, nc, mw).transpose(1, 2).to(torch.int64)], 1)
    out_u = compact(union.reshape(b * c, nc), u_vals, nu).reshape(b, c, 1 + mw, nu)
    u_ok = torch.arange(nu, device=dev) < n_union.clamp(max=nu)[..., None]

    bidx = torch.arange(b, device=dev)[:, None]
    rows = out_u[bidx, mask_cam, 1 + (bit >> 5)[None, :]]  # [B, M, NU]
    sel = (((rows >> (bit & 31)[None, :, None]) & 1) == 1) & u_ok[bidx, mask_cam] \
        & mask_valid[..., None]
    counts = sel.sum(-1)
    has_points = (counts > 0) & mask_valid
    ids_m = compact(sel.reshape(b * m, nu), out_u[bidx, mask_cam, 0:1].reshape(b * m, 1, nu),
                    k).reshape(b, m, k)
    valid_k = torch.arange(k, device=dev) < counts.clamp(max=k)[..., None]
    coords = torch.gather(points, 1, ids_m.reshape(b, m * k, 1).expand(b, m * k, 3))
    coords = coords.reshape(b, m, k, 3).permute(0, 1, 3, 2)  # [B, M, 3, K]
    med = medoid(coords.reshape(b * m, 3, k), valid_k.reshape(b * m, k)).reshape(b, m)
    centroids = torch.gather(points, 1, torch.gather(ids_m, 2, med[..., None]).expand(b, m, 3))
    centroids = torch.where(has_points[..., None], centroids, 0.0)

    # pass 2: nearest lane yaw, shape prior, pushback, circle NMS
    lanes, lane_valid = f["lane_points"], f["lane_valid"]
    dx = centroids[..., :, None, 0] - lanes[..., None, :, 0]
    dy = centroids[..., :, None, 1] - lanes[..., None, :, 1]
    dist_sq = torch.where(lane_valid[..., None, :], dx * dx + dy * dy, torch.inf)
    lane = torch.gather(lanes, 1, torch.argmin(dist_sq, -1)[..., None].expand(b, m, 3))
    lane_yaw = torch.where(lane_valid.any(-1)[:, None], lane[..., 2], 0.0)
    labels = f["mask_label"].long()
    veh = is_vehicle[labels] & has_points
    sizes = priors[labels]
    yaws = torch.where(veh, lane_yaw, 0.0)
    rel = centroids - f["ego_translation"][:, None, :]
    alpha = torch.atan2(rel[..., 1].double(), rel[..., 0].double())
    s = torch.abs(torch.sin(yaws.double() - alpha)).float()
    co = torch.abs(torch.cos(yaws.double() - alpha)).float()
    off = torch.minimum(torch.abs(sizes[..., 1] / (2.0 * torch.where(s < 1e-12, 1e-12, s))),
                        torch.abs(sizes[..., 0] / (2.0 * torch.where(co < 1e-12, 1e-12, co))))
    pushed = torch.stack([centroids[..., 0] + off * torch.cos(alpha).float(),
                          centroids[..., 1] + off * torch.sin(alpha).float(),
                          centroids[..., 2]], -1)
    centers = torch.where(veh[..., None], pushed, centroids)
    keep = circle_nms(centers[..., :2], f["mask_score"], f["mask_label"], has_points,
                      radius_sq) & has_points
    boxes = RefBoxes(centers, sizes, yaws, f["mask_score"], labels, keep, counts)
    work = WorkCounts(n_in_image, n_union, counts, counts.clamp(max=k))
    return boxes, work

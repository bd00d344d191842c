"""Fused 2D->3D lifting of a keyframe batch: packed-mask erode -> project ->
frustum cull -> camera compaction -> in-mask word gather -> union
compaction -> per-mask compaction -> medoid, plus box building (lane yaw,
pushback, circle NMS).

The JAX package vmaps one keyframe; here the batch dimension B is written
out, and the three compactions fold it into the kernel's row dimension
(B*C camera and union rows, B*M mask rows), one launch each. All three go
through `kernels.compact.compact_rows`, which moves raw 32-bit words: f32
coordinates, int32 point ids, flat pixel indices and mask words ride
through it bit-exactly as int32 bit patterns, so the TPU's bf16 value split
and 16-bit word halves have no counterpart here. The medoid sums go through
`kernels.medoid`.

Everything is fixed-shape: points, masks and boxes are padded with validity
masks.

Reference semantics notes (deliberate quirk reproduction):
- Frustum test: depths > min_dist (NOT sqrt(min_dist); the sqrt only appears
  in the load-time close-point filter, 2d_to_3d.py:443-444 vs :598).
- In-image test is strict: 0 < px < W-1, 0 < py < H-1 on the *unfloored*
  pixel coordinates (2d_to_3d.py:597-605).
- The reference's `logical_and(floored_points, masked_pixels[...])`
  (2d_to_3d.py:608-613) implicitly drops points whose floored x or y is 0;
  reproduced via fx >= 1 & fy >= 1.
- Masks are indexed [x, y] (gen_2d_masks_detic.py:468); here bit-packed as
  words[x, y, m//32] bit (m%32).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from cm3d_tpu_torch.geometry.pointcloud import project_to_camera
from cm3d_tpu_torch.kernels.compact import compact_rows
from cm3d_tpu_torch.ops.bitmask import erode3x3_packed, extract_bit
from cm3d_tpu_torch.ops.lanes import nearest_lane
from cm3d_tpu_torch.ops.medoid import masked_medoid_rows
from cm3d_tpu_torch.ops.nms import circle_nms_keep
from cm3d_tpu_torch.ops.pushback import push_centroid


@dataclasses.dataclass(frozen=True)
class LiftParams:
    """Static configuration of the lift step."""

    min_dist: float = 2.3  # camera-frame depth cutoff (reference :348,598)
    max_points_per_mask: int = 2048  # K: per-mask compaction depth
    max_points_per_camera: int = 32768  # NC: per-camera compaction depth
    max_points_in_masks: int = 8192  # NU: per-camera any-mask union depth
    erode: bool = True  # reference erodes every mask 3x3 (:526-528)


class LiftOutputs(NamedTuple):
    centroids: torch.Tensor  # [B, M, 3] global-frame medoid per mask
    has_points: torch.Tensor  # [B, M] bool: mask produced a centroid
    point_counts: torch.Tensor  # [B, M] int32: points gathered (pre-truncation)
    truncated: torch.Tensor  # [B, M] bool: count exceeded K (silent loss in ref)
    cam_truncated: torch.Tensor  # [B, C] bool: a camera overflowed NC
    pca_yaws: torch.Tensor  # [B, M] BEV principal-axis yaw of the gathered points


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with the same low 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def lift_keyframe(
    points: torch.Tensor,
    point_valid: torch.Tensor,
    cam_ego_t: torch.Tensor,
    cam_ego_q: torch.Tensor,
    cam_t: torch.Tensor,
    cam_q: torch.Tensor,
    cam_intrinsics: torch.Tensor,
    mask_bits: torch.Tensor,
    mask_cam: torch.Tensor,
    mask_valid: torch.Tensor,
    params: LiftParams = LiftParams(),
) -> LiftOutputs:
    """Lift every 2D mask of a keyframe batch to a 3D centroid.

    Args:
      points: [B, N, D>=3] aggregated sweep points in the GLOBAL frame (padded).
      point_valid: [B, N] bool.
      cam_ego_t/[B,C,3], cam_ego_q/[B,C,4]: ego pose at each camera's timestamp.
      cam_t/[B,C,3], cam_q/[B,C,4]: camera extrinsics (sensor->ego).
      cam_intrinsics: [B,C,3,3], ALREADY scaled by the mask-resolution ratio
        with [2,2] reset to 1 (reference 2d_to_3d.py:585-587).
      mask_bits: [B, W, H, Mw] int32 bit-packed instance masks (M <= Mw*32).
      mask_cam: [B, M] int camera index per mask.
      mask_valid: [B, M] bool.
    """
    b, m = mask_cam.shape
    n = points.shape[1]
    c = cam_t.shape[1]
    _, w, h, mw = mask_bits.shape
    if m > mw * 32:
        raise ValueError(f"{m} masks need {-(-m // 32)} words, got {mw}")
    dev = points.device
    # Compaction depths never need to exceed the prior stage's size.
    nc = min(params.max_points_per_camera, n)
    nu = min(params.max_points_in_masks, nc)
    k = min(params.max_points_per_mask, nc, nu)
    bidx = torch.arange(b, device=dev)[:, None]  # [B, 1]

    if params.erode:
        mask_bits = erode3x3_packed(mask_bits)

    pts_xyz = points[..., :3].to(torch.float32)  # [B, N, 3]

    # --- One projection per camera: [B, C, N, 3] pixels, [B, C, N] depths. ---
    proj, depths = project_to_camera(
        pts_xyz[:, None], cam_ego_t, cam_ego_q, cam_t, cam_q, cam_intrinsics
    )
    px, py = proj[..., 0], proj[..., 1]
    fx = torch.floor(px).to(torch.int32)
    fy = torch.floor(py).to(torch.int32)
    in_image = (
        point_valid[:, None, :]
        & (depths > params.min_dist)
        & (px > 0)
        & (px < w - 1)
        & (py > 0)
        & (py < h - 1)
        # Reference quirk: floored coordinate 0 is dropped by the logical_and.
        & (fx >= 1)
        & (fy >= 1)
    )  # [B, C, N]
    n_in_image = in_image.sum(-1)  # [B, C]
    cam_truncated = n_in_image > nc
    flat_all = fx.clamp(0, w - 1) * h + fy.clamp(0, h - 1)  # [B, C, N] int32

    # Invalid masks (class outside the vocabulary, padding slots) keep
    # their bits in the packed planes; AND them out of every gathered word
    # so they can't consume union capacity (NU) or flip cam_truncated.
    vbits = mask_valid.to(torch.int64) << (torch.arange(m, device=dev) & 31)
    valid_words = _int32_bits(
        torch.nn.functional.pad(vbits, (0, mw * 32 - m)).reshape(b, mw, 32).sum(-1)
    )  # [B, Mw] (disjoint bits: sum == OR)

    # --- Camera compaction carrying xyz + flat pixel + point id (D=5). ---
    xyz_words = pts_xyz.transpose(1, 2).contiguous().view(torch.int32)  # [B, 3, N]
    iota_n = torch.arange(n, dtype=torch.int32, device=dev)
    vals_cam = torch.cat(
        [
            xyz_words[:, None].expand(b, c, 3, n),
            flat_all[:, :, None, :],
            iota_n.expand(b, c, 1, n),
        ],
        dim=2,
    ).reshape(b * c, 5, n)
    out_c = compact_rows(in_image.reshape(b * c, n), vals_cam, nc)  # [B*C, 5, NC]
    cam_ok = (
        torch.arange(nc, device=dev) < n_in_image.clamp(max=nc)[..., None]
    )  # [B, C, NC]

    # --- One word gather per (camera, compacted point). Invalid slots carry
    # flat 0 (kernel zero-fill); cam_ok masks their words out below. ---
    flat_c = out_c[:, 3].reshape(b, c * nc).to(torch.int64)
    words_flat = mask_bits.reshape(b, w * h, mw)
    wpts = torch.gather(words_flat, 1, flat_c[..., None].expand(b, c * nc, mw))
    wpts = wpts.reshape(b, c, nc, mw) & valid_words[:, None, None, :]
    union = (wpts != 0).any(-1) & cam_ok  # [B, C, NC]
    cam_truncated = cam_truncated | (union.sum(-1) > nu)

    # --- Union compaction carrying xyz + id + the Mw mask words (D=4+Mw). ---
    vals_u = torch.cat(
        [out_c[:, :3], out_c[:, 4:5], wpts.reshape(b * c, nc, mw).transpose(1, 2)],
        dim=1,
    )  # [B*C, 4+Mw, NC]
    out_u = compact_rows(union.reshape(b * c, nc), vals_u, nu)  # [B*C, 4+Mw, NU]
    out_u = out_u.reshape(b, c, 4 + mw, nu)

    # --- Per-mask bit test: [B, M, NU]. ---
    mask_cam = mask_cam.to(torch.int64)
    word_idx = torch.arange(m, device=dev) >> 5
    rows = out_u[bidx, mask_cam, 4 + word_idx[None, :]]  # [B, M, NU]
    inmask = extract_bit(rows, torch.arange(m, device=dev).expand(b, m))
    sel = inmask & mask_valid[..., None]
    counts = sel.sum(-1, dtype=torch.int32)  # [B, M]
    has_points = (counts > 0) & mask_valid
    truncated = counts > k

    # --- Per-mask compaction NU -> K of xyz + id (D=4), straight off the
    # union output. ---
    vals_m = out_u[:, :, :4][bidx, mask_cam]  # [B, M, 4, NU]
    out_m = compact_rows(sel.reshape(b * m, nu), vals_m.reshape(b * m, 4, nu), k)
    out_m = out_m.reshape(b, m, 4, k)
    coords_dm = out_m[:, :, :3].view(torch.float32)  # [B, M, 3, K] D-major
    idx_buf = out_m[:, :, 3]  # [B, M, K] int32 point ids (0 at invalid slots)
    valid_k = torch.arange(k, device=dev) < counts.clamp(max=k)[..., None]
    return _finish_lift(
        pts_xyz, coords_dm, idx_buf, valid_k, has_points, counts, truncated,
        cam_truncated,
    )


def _finish_lift(pts_xyz, coords_dm, idx_buf, valid_k, has_points, counts,
                 truncated, cam_truncated) -> LiftOutputs:
    """Tail of lift_keyframe: medoid + BEV PCA yaw over the per-mask
    compacted D-major coords."""
    b, m, _, k = coords_dm.shape
    # --- Medoid per mask (reference get_medoid, 2d_to_3d.py:116-119). ---
    med_local = masked_medoid_rows(
        coords_dm.reshape(b * m, 3, k), valid_k.reshape(b * m, k)
    ).reshape(b, m)
    med_global = torch.gather(idx_buf, 2, med_local.to(torch.int64)[..., None])[..., 0]
    centroids = torch.gather(
        pts_xyz, 1, med_global.to(torch.int64)[..., None].expand(b, m, 3)
    )
    centroids = torch.where(has_points[..., None], centroids, 0.0)

    # --- BEV principal-axis yaw (closed-form eigenvector of the 2x2 xy
    # covariance; device replacement for the reference KITTI open3d OBB
    # fit, kitti/2d_to_3d.py:855-876,1524). ---
    vf = valid_k.to(torch.float32)[:, :, None, :]  # [B, M, 1, K]
    cnt = vf[:, :, 0].sum(-1).clamp(min=1.0)
    xy = coords_dm[:, :, :2] * vf  # [B, M, 2, K]
    mean = xy.sum(-1) / cnt[..., None]
    d = (coords_dm[:, :, :2] - mean[..., None]) * vf
    sxx = (d[:, :, 0] * d[:, :, 0]).sum(-1)
    syy = (d[:, :, 1] * d[:, :, 1]).sum(-1)
    sxy = (d[:, :, 0] * d[:, :, 1]).sum(-1)
    # atan2 in f64, rounded: the CPU's vectorised and scalar f32 atan2
    # differ in the last bit, and which one a mask meets depends on the
    # batch's size (ops/pushback.py)
    pca_yaws = (0.5 * torch.atan2(2 * sxy.double(), (sxx - syy).double())).float()

    return LiftOutputs(
        centroids, has_points, counts, truncated, cam_truncated, pca_yaws
    )


@dataclasses.dataclass(frozen=True)
class BoxParams:
    """Static configuration of box building.

    The two filters are the reference's commented-out blocks
    (2d_to_3d.py:756-758 object lane thresh, :774-779 drivable filtering,
    :782-785 vehicle lane thresh), off by default like the reference.
    """

    lane_dist_filter: bool = False
    object_lane_thresh: float = 20.0
    vehicle_lane_thresh: float = 4.0
    drivable_filter: bool = False
    drivable_resolution: float = 0.5  # meters per drivable-raster cell


class BoxOutputs(NamedTuple):
    centers: torch.Tensor  # [B, M, 3] final (possibly pushed-back) centers
    sizes: torch.Tensor  # [B, M, 3] (w, l, h) shape-prior extents
    yaws: torch.Tensor  # [B, M] box yaw (0 for non-vehicle classes)
    scores: torch.Tensor  # [B, M]
    labels: torch.Tensor  # [B, M] int32
    keep: torch.Tensor  # [B, M] bool: valid AND survived circle NMS
    lane_dist: torch.Tensor  # [B, M] distance to the nearest lane point


def build_boxes(
    centroids: torch.Tensor,
    has_points: torch.Tensor,
    labels: torch.Tensor,
    scores: torch.Tensor,
    lane_points: torch.Tensor,
    lane_valid: torch.Tensor,
    ego_translation: torch.Tensor,
    shape_priors: torch.Tensor,
    is_vehicle_class: torch.Tensor,
    nms_radius_sq: torch.Tensor,
    drivable_class: torch.Tensor | None = None,
    drivable_grid: torch.Tensor | None = None,
    drivable_origin: torch.Tensor | None = None,
    params: BoxParams = BoxParams(),
) -> BoxOutputs:
    """Pass 2 of the reference (2d_to_3d.py:733-825) + per-sample circle NMS,
    over a keyframe batch.

    Args:
      centroids/[B,M,3], has_points/[B,M]: from `lift_keyframe`.
      labels: [B, M] int32 canonical class ids.
      scores: [B, M] detection scores.
      lane_points: [B, L, 3] (x, y, yaw); lane_valid: [B, L] bool.
      ego_translation: [B, 3] LIDAR_TOP ego position at the keyframe.
      shape_priors: [num_classes, 3] (w, l, h) per class.
      is_vehicle_class: [num_classes] bool — classes that get lane yaw +
        pushback (reference :763).
      nms_radius_sq: [num_classes] circle-NMS squared radii (:850-861).
      drivable_class: [num_classes] bool — classes the drivable filter drops
        (reference exempts construction_vehicle/trailer/barrier, :774-777).
      drivable_grid: [B, G, G] bool raster, indexed [ix, iy]; drivable_origin:
        [B, 2] world xy of cell (0, 0). Required when params.drivable_filter.
        Centroids outside the raster count as non-drivable.
    """
    yaw_raw, lane_dist, _ = nearest_lane(centroids[..., :2], lane_points, lane_valid)

    labels_i = labels.to(torch.int64)
    veh = is_vehicle_class[labels_i] & has_points
    sizes = shape_priors[labels_i]
    yaws = torch.where(veh, yaw_raw, 0.0)

    pushed = push_centroid(centroids, sizes, yaws, ego_translation)
    centers = torch.where(veh[..., None], pushed, centroids)

    # Both filters test the RAW medoid centroid (the reference filters before
    # pushback, :756-786) and drop boxes before circle NMS.
    valid = has_points
    if params.lane_dist_filter:
        valid = valid & (lane_dist <= params.object_lane_thresh)
        valid = valid & (~veh | (lane_dist <= params.vehicle_lane_thresh))
    if params.drivable_filter:
        gx, gy = drivable_grid.shape[-2:]
        inv_res = 1.0 / params.drivable_resolution
        ij = torch.floor((centroids[..., :2] - drivable_origin[:, None, :]) * inv_res)
        ij = ij.to(torch.int64)
        in_grid = (
            (ij[..., 0] >= 0) & (ij[..., 0] < gx) & (ij[..., 1] >= 0) & (ij[..., 1] < gy)
        )
        bidx = torch.arange(centroids.shape[0], device=centroids.device)[:, None]
        cell = drivable_grid[bidx, ij[..., 0].clamp(0, gx - 1), ij[..., 1].clamp(0, gy - 1)]
        on_road = in_grid & cell
        valid = valid & (~drivable_class[labels_i] | on_road)

    keep = circle_nms_keep(centers[..., :2], scores, labels, valid, nms_radius_sq)
    return BoxOutputs(centers, sizes, yaws, scores, labels, keep & valid, lane_dist)

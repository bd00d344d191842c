"""Waymo range-image -> point-cloud unprojection as torch ops. Mirrors
`cm3d_tpu/ops/range_image.py`.

Replaces frame_utils.parse_range_image_and_camera_projection +
convert_range_image_to_point_cloud (TF C++ ops; reference
src/waymo/2d_to_3d.py:472-474) with the published spherical unprojection
semantics: per-row beam inclinations, per-column azimuth with the
extrinsic yaw correction, polar->cartesian in the sensor frame, then the
sensor extrinsic into the vehicle frame. A per-pixel [H, W, 4, 4] pose grid
(TOP lidar rolling shutter) is supported optionally.

Precision: every 3-vector transform is written out as products and sums
in f32 (`_transform`), never as a matmul. The rolling-shutter correction
routes points through the GLOBAL frame (1e3-1e4 m), where a TF32 matmul's
10-bit mantissa would cost metres; elementwise f32 cannot be switched to
TF32 by any backend flag, and it runs the same on the CPU and the card.
The JAX package gets the same effect with `Precision.HIGHEST`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _transform(rot: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """rot [..., 3, 3] @ pts [..., 3] + t [..., 3], as f32 products and sums
    (broadcast over the leading axes)."""
    return (rot * pts[..., None, :]).sum(-1) + t


def azimuth_grid(width: int, extrinsic: torch.Tensor) -> torch.Tensor:
    """Per-column azimuth: pi - 2*pi*(col+0.5)/W, corrected by the sensor's
    extrinsic yaw."""
    correction = torch.atan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (torch.arange(width, dtype=torch.float32, device=extrinsic.device) + 0.5) / width
    return math.pi - 2.0 * math.pi * ratios - correction


def uniform_inclinations(height: int, incl_min: float, incl_max: float,
                         device=None) -> torch.Tensor:
    """Row inclinations for lidars without a beam table: uniform from max
    (top row) to min (bottom row)."""
    ratios = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    return incl_max + ratios * (incl_min - incl_max)


def pixel_pose_matrices(pose6: torch.Tensor) -> torch.Tensor:
    """[H, W, 6] (roll, pitch, yaw, x, y, z) -> [H, W, 4, 4] vehicle->global
    transforms (waymo transform_utils.get_rotation_matrix semantics:
    R = Rz(yaw) @ Ry(pitch) @ Rx(roll)). All-zero rows (Waymo's invalid
    pixels) become the identity transform — harmless, those pixels carry
    range <= 0 and are dropped by the validity mask anyway."""
    roll, pitch, yaw = pose6[..., 0], pose6[..., 1], pose6[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    rot = torch.stack([
        torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
        torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
        torch.stack([-sp, cp * sr, cp * cr], dim=-1),
    ], dim=-2)  # [H, W, 3, 3]
    m = torch.zeros(pose6.shape[:-1] + (4, 4), dtype=pose6.dtype, device=pose6.device)
    m[..., :3, :3] = rot
    m[..., :3, 3] = pose6[..., 3:6]
    m[..., 3, 3] = 1.0
    return m


def range_image_to_points(
    range_image: torch.Tensor,  # [H, W] ranges in meters (<=0 -> invalid)
    inclinations: torch.Tensor,  # [H] row inclinations, top row first
    extrinsic: torch.Tensor,  # [4, 4] sensor -> vehicle
    pixel_pose: Optional[torch.Tensor] = None,  # [H, W, 4, 4] vehicle -> global
    frame_pose_inv: Optional[torch.Tensor] = None,  # [4, 4] global -> vehicle
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (points [H*W, 3] vehicle-frame, valid [H*W] bool), on the
    range image's device."""
    if pixel_pose is not None and frame_pose_inv is None:
        # Mirrors frame_utils: pixel_pose maps into the GLOBAL frame; without
        # the frame pose to come back, the output silently stops being
        # vehicle-frame.
        raise ValueError("frame_pose_inv must be set when pixel_pose is set")
    h, w = range_image.shape
    az = azimuth_grid(w, extrinsic)  # [W]
    cos_incl = torch.cos(inclinations)[:, None]
    sin_incl = torch.sin(inclinations)[:, None]
    cos_az = torch.cos(az)[None, :]
    sin_az = torch.sin(az)[None, :]
    r = range_image
    x = cos_incl * cos_az * r
    y = cos_incl * sin_az * r
    z = sin_incl * r
    pts = torch.stack([x, y, z], dim=-1)  # [H, W, 3] sensor frame
    pts = _transform(extrinsic[:3, :3], extrinsic[:3, 3], pts)

    if pixel_pose is not None:
        # per-pixel vehicle->global, then back into the frame's vehicle frame
        pts = _transform(pixel_pose[..., :3, :3], pixel_pose[..., :3, 3], pts)
        pts = _transform(frame_pose_inv[:3, :3], frame_pose_inv[:3, 3], pts)

    valid = (range_image > 0).reshape(-1)
    return pts.reshape(-1, 3), valid


def points_to_range_image(
    points: torch.Tensor,  # [N, 3] vehicle frame
    inclinations: torch.Tensor,  # [H]
    extrinsic: torch.Tensor,  # [4, 4]
    height: int,
    width: int,
) -> torch.Tensor:
    """Inverse transform (test oracle + completeness): scatter points back
    into an [H, W] range image. On collisions the point with the highest
    index wins (the JAX package's "last write wins", made deterministic)."""
    inv = torch.linalg.inv(extrinsic.double()).to(points.dtype)
    local = _transform(inv[:3, :3], inv[:3, 3], points)
    r = torch.linalg.norm(local, dim=-1)
    incl = torch.asin(torch.clamp(local[:, 2] / torch.clamp(r, min=1e-9), -1, 1))
    az = torch.atan2(local[:, 1], local[:, 0])

    correction = torch.atan2(extrinsic[1, 0], extrinsic[0, 0])
    col_f = (math.pi - correction - az) * width / (2 * math.pi) - 0.5
    col = torch.remainder(torch.round(col_f).to(torch.int64), width)
    row = torch.argmin((incl[:, None] - inclinations[None, :]).abs(), dim=1)
    lin = row * width + col
    last = torch.full((height * width,), -1, dtype=torch.int64, device=points.device)
    last = last.scatter_reduce(0, lin, torch.arange(len(points), device=points.device),
                               reduce="amax")
    hit = last >= 0
    img = torch.zeros(height * width, dtype=points.dtype, device=points.device)
    img[hit] = r[last[hit]]
    return img.reshape(height, width)

"""Functional point-cloud ops and camera projection (PyTorch, fixed-shape,
batched). Mirrors `cm3d_tpu/geometry/pointcloud.py`.

Replaces the reference's mutable `LidarPointCloud` class
(src/nuscenes/utils/pcd.py:20-257): where the reference filters points by
slicing, a boolean validity mask keeps every shape static. Point layout:
`[..., N, D]` with x, y, z in columns 0..2.

The K=3/4 products are written out elementwise rather than as matmuls: the
points are global-frame coordinates (~1e3 m) and a TF32 tensor-core pass
would cost centimetres, so every product stays plain f32 (the JAX package
pins Precision.HIGHEST for the same reason).
"""

from __future__ import annotations

import torch

from cm3d_tpu_torch.geometry.se3 import _matvec, _transform, quat_to_rotmat


def remove_close_mask(points: torch.Tensor, radius: float) -> torch.Tensor:
    """Validity mask for points outside `radius` (L-inf on x, y).

    Reference semantics (src/nuscenes/utils/pcd.py:148-157): a point is
    removed when |x| < radius AND |y| < radius. Returns True for points kept.
    """
    x_close = torch.abs(points[..., 0]) < radius
    y_close = torch.abs(points[..., 1]) < radius
    return ~(x_close & y_close)


def _with_xyz(points: torch.Tensor, cols: list[torch.Tensor]) -> torch.Tensor:
    """points [..., N, D] with its xyz columns replaced by `cols`."""
    return torch.cat([torch.stack(cols, dim=-1), points[..., 3:]], dim=-1)


def rotate_points(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate xyz columns of [..., N, D] by [..., 3, 3]; other columns pass
    through.

    Reference: PointCloud.rotate (src/nuscenes/utils/pcd.py:167-172).
    """
    return _with_xyz(points, _matvec(rot, [points[..., 0], points[..., 1], points[..., 2]]))


def translate_points(points: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Translate xyz columns of [..., N, D] by [..., 3].

    Reference: PointCloud.translate (src/nuscenes/utils/pcd.py:159-165).
    """
    return torch.cat([points[..., :3] + t[..., None, :], points[..., 3:]], dim=-1)


def transform_points(points: torch.Tensor, tm: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] homogeneous transform to xyz of [..., N, D].

    Reference: PointCloud.transform (src/nuscenes/utils/pcd.py:174-179).
    """
    return _with_xyz(points, _transform(tm, points))


def view_points(points: torch.Tensor, view: torch.Tensor, normalize: bool = True):
    """Pinhole projection. points [..., N, 3], view [..., V0, V1] (V<=4).

    Returns (projected [..., N, 3], depths [..., N]). `depths` is the
    pre-normalization third row, exactly like the reference's torch port
    (src/nuscenes/utils/pcd.py:262-283): the view matrix is padded into a
    4x4 identity, applied in homogeneous coordinates, and rows divided by z
    when `normalize`.
    """
    v0, v1 = view.shape[-2], view.shape[-1]
    viewpad = torch.eye(4, dtype=points.dtype, device=points.device)
    viewpad = viewpad.expand(view.shape[:-2] + (4, 4)).clone()
    viewpad[..., :v0, :v1] = view
    cols = [points[..., 0], points[..., 1], points[..., 2],
            torch.ones_like(points[..., 0])]
    proj = torch.stack(_matvec(viewpad[..., :3, :], cols), dim=-1)
    depths = proj[..., 2]
    if normalize:
        proj = proj / depths[..., None]
    return proj, depths


def project_to_camera(
    points_global: torch.Tensor,
    ego_translation: torch.Tensor,
    ego_rotation: torch.Tensor,
    cam_translation: torch.Tensor,
    cam_rotation: torch.Tensor,
    intrinsics: torch.Tensor,
    normalize: bool = True,
):
    """Global-frame points -> image pixels through an ego+camera chain.

    Mirrors the reference's per-mask transform sequence
    (src/nuscenes/2d_to_3d.py:569-590): translate by -ego_t, rotate by
    ego_R^T, translate by -cam_t, rotate by cam_R^T, then `view_points` with
    the (pre-scaled) intrinsics. Callers run it once per camera and reuse
    the projection for all masks of that camera.

    Args:
      points_global: [..., N, 3] points in the global frame.
      ego_translation/[...,3], ego_rotation/[...,4] quat (w,x,y,z): ego pose
        at the camera timestamp.
      cam_translation/[...,3], cam_rotation/[...,4] quat: camera extrinsics.
      intrinsics: [..., 3, 3].

    Returns (pixels [..., N, 3], depths [..., N]) with depths = camera-frame z.
    """
    ego_rot_t = quat_to_rotmat(ego_rotation).transpose(-1, -2)
    cam_rot_t = quat_to_rotmat(cam_rotation).transpose(-1, -2)

    pts = points_global - ego_translation[..., None, :]
    cols = _matvec(ego_rot_t, [pts[..., 0], pts[..., 1], pts[..., 2]])  # R^T @ p
    cols = [c - cam_translation[..., i, None] for i, c in enumerate(cols)]
    cols = _matvec(cam_rot_t, cols)
    return view_points(torch.stack(cols, dim=-1), intrinsics, normalize=normalize)

"""Quaternion and SE(3) utilities (PyTorch, batched). Mirrors
`cm3d_tpu/geometry/se3.py`.

Replaces the reference's dependency on `pyquaternion.Quaternion` and
`nuscenes.utils.geometry_utils.transform_matrix`
(reference: src/nuscenes/utils/pcd.py:89-114 uses transform_matrix;
src/nuscenes/2d_to_3d.py:451-457 uses Quaternion(...).rotation_matrix).

Conventions:
- Quaternions are `[w, x, y, z]` (Hamilton, scalar-first) — the layout the
  nuScenes devkit / pyquaternion use, so calibration records round-trip
  unchanged.
- SE(3) transforms are 4x4 homogeneous matrices acting on column vectors.
- All functions accept leading batch dimensions.

The K=3/4 products are written out elementwise rather than as matmuls: they
feed global-frame coordinates (~1e3 m) and a TF32 tensor-core pass would
cost centimetres, so every product stays plain f32 (the JAX package pins
Precision.HIGHEST for the same reason).
"""

from __future__ import annotations

import torch


def _norm4(q: torch.Tensor) -> torch.Tensor:
    """|q| of [..., 4], the sum in a fixed order, so every device rounds it
    alike."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.sqrt(((w * w + x * x) + y * y) + z * z)


def _matvec(m: torch.Tensor, cols: list[torch.Tensor]) -> list[torch.Tensor]:
    """Rows of m [..., I, J] applied to J coordinate tensors [..., N]:
    out_i = sum_j m[..., i, j] * cols[j], summed in j order."""
    out = []
    for i in range(m.shape[-2]):
        acc = m[..., i, 0, None] * cols[0]
        for j in range(1, len(cols)):
            acc = acc + m[..., i, j, None] * cols[j]
        out.append(acc)
    return out


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """rot [..., 3, 3] @ v [..., 3] -> [..., 3]."""
    return torch.cat(_matvec(rot, [v[..., j, None] for j in range(3)]), dim=-1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., I, J] @ b [..., J, K] -> [..., I, K]."""
    return torch.stack(_matvec(a, [b[..., j, :] for j in range(b.shape[-2])]), dim=-2)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3].

    Normalizes the input, so non-unit quaternions are handled like
    pyquaternion's `.rotation_matrix`.
    """
    norm = _norm4(q)
    w, x, y, z = q[..., 0] / norm, q[..., 1] / norm, q[..., 2] / norm, q[..., 3] / norm
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    rows = [
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (w, x, y, z).

    The Shepperd / max-trace form without branches, as the JAX package's:
    all four candidate quaternions are computed and the one whose pivot is
    largest is taken (the first on a tie, as `jnp.argmax`).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    # four candidates, each valid when its pivot is the largest
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22,
                      1.0 + m22 - m00 - m11], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) / 2.0
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]

    cand0 = torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0),
                         (m10 - m01) / (4 * w0)], dim=-1)
    cand1 = torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1),
                         (m02 + m20) / (4 * x1)], dim=-1)
    cand2 = torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2,
                         (m12 + m21) / (4 * y2)], dim=-1)
    cand3 = torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3),
                         (m12 + m21) / (4 * z3), z3], dim=-1)

    best = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)  # first maximum
    cands = torch.stack([cand0, cand1, cand2, cand3], dim=-2)  # [..., 4, 4]
    index = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, index).squeeze(-2)
    # the sign made w >= 0, as pyquaternion's constructor gives it for the
    # pipeline's yaw-only matrices
    q = torch.where(q[..., :1] < 0, -q, q)
    return q / _norm4(q)[..., None]


def yaw_to_quat(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw angle [...] -> quaternion [..., 4] for rotation about +z."""
    half = yaw / 2.0
    zeros = torch.zeros_like(yaw)
    return torch.stack([torch.cos(half), zeros, zeros, torch.sin(half)], dim=-1)


def quat_to_yaw(q: torch.Tensor) -> torch.Tensor:
    """Yaw (rotation about +z) of quaternion [..., 4]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def yaw_rotmat(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw angle [...] -> 3x3 rotation matrix about +z.

    Mirrors the reference's `align_mat` construction
    (src/nuscenes/2d_to_3d.py:788-789).
    """
    c, s = torch.cos(yaw), torch.sin(yaw)
    zeros, ones = torch.zeros_like(yaw), torch.ones_like(yaw)
    rows = [
        torch.stack([c, -s, zeros], dim=-1),
        torch.stack([s, c, zeros], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two [..., 4] quaternions (w, x, y, z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion [..., 4]: its conjugate."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def _se3(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    top = torch.cat([rot, trans[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def transform_matrix(translation: torch.Tensor, rotation_quat: torch.Tensor,
                     inverse: bool = False) -> torch.Tensor:
    """A 4x4 homogeneous transform from translation [..., 3] and quaternion
    [..., 4].

    `inverse=True` returns the inverse transform directly, as the nuScenes
    devkit helper the reference relies on (src/nuscenes/utils/pcd.py:89-93).
    """
    rot = quat_to_rotmat(rotation_quat)
    batch = torch.broadcast_shapes(rot.shape[:-2], translation.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    if inverse:
        rot = rot.transpose(-1, -2)
        translation = -_rotate(rot, translation)
    return _se3(rot, translation)


def invert_se3(tm: torch.Tensor) -> torch.Tensor:
    """Invert a [..., 4, 4] rigid transform without a general inverse."""
    rot_t = tm[..., :3, :3].transpose(-1, -2)
    return _se3(rot_t, -_rotate(rot_t, tm[..., :3, 3]))


def compose(*transforms: torch.Tensor) -> torch.Tensor:
    """Compose 4x4 transforms in matmul order: compose(A, B, C) == A @ B @ C.

    The reference fuses its per-sweep chain the same way
    (src/nuscenes/utils/pcd.py:114 `reduce(torch.matmul, [...])`).
    """
    out = transforms[0]
    for t in transforms[1:]:
        out = _matmul(out, t)
    return out


def _transform(tm: torch.Tensor, points: torch.Tensor) -> list[torch.Tensor]:
    """The x, y, z columns [..., N] of points [..., N, >= 3] under the
    [..., 4, 4] transform tm."""
    cols = _matvec(tm[..., :3, :3], [points[..., 0], points[..., 1], points[..., 2]])
    return [c + tm[..., i, 3, None] for i, c in enumerate(cols)]


def apply_se3(tm: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] transform to points [..., N, 3] -> [..., N, 3]."""
    return torch.stack(_transform(tm, points), dim=-1)

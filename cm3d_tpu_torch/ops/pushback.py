"""Centroid pushback along the viewing ray (vectorized).

The reference pushes each vehicle's medoid centroid away from the ego vehicle
by the distance from the box surface to its center along the viewing ray
(`push_centroid`, src/nuscenes/2d_to_3d.py:164-198): the medoid of the
*visible* points sits on the near surface, so the box center lies roughly
half an extent behind it.

Reference quirks reproduced deliberately:
- It reads `l = extents[0]; w = extents[1]` while extents are stored
  (w, l, h) — the roles of width/length are swapped in the offset formula.
  That exact arithmetic is kept for box parity.
- Its yaw goes through a scipy euler round trip yielding theta = yaw - pi;
  the offset only uses |sin(theta - alpha)| and |cos(theta - alpha)|, so the
  lane yaw is used directly.
"""

from __future__ import annotations

import torch


def push_centroid(
    centroids: torch.Tensor,
    extents_wlh: torch.Tensor,
    yaws: torch.Tensor,
    ego_translation: torch.Tensor,
) -> torch.Tensor:
    """Push centroids back along the ego->centroid ray.

    Args:
      centroids: [..., M, 3] global-frame centroids.
      extents_wlh: [..., M, 3] box sizes (w, l, h).
      yaws: [..., M] box yaw (the lane yaw in the pipeline).
      ego_translation: [..., 3] ego position (LIDAR_TOP ego pose at the
        keyframe, reference 2d_to_3d.py:793-796).

    Returns pushed centroids [..., M, 3] (z unchanged).
    """
    ego_centroid = centroids - ego_translation[..., None, :]

    # Reference swap: 'l' <- extents[0] (the width), 'w' <- extents[1] (the length).
    l_swapped = extents_wlh[..., 0]
    w_swapped = extents_wlh[..., 1]

    # alpha = atan(|y|/|x|) with explicit quadrant fixes == atan2(y, x)
    # (reference 2d_to_3d.py:180-190). The angles go through f64 and each
    # sine / cosine is rounded to f32: the CPU's vectorised and scalar f32
    # versions differ in the last bit, and which one an element meets
    # depends on the batch's size, so a keyframe's boxes would depend on
    # the batch it rides in (a data-parallel rank's rows against the whole
    # batch).
    alpha = torch.atan2(ego_centroid[..., 1].double(), ego_centroid[..., 0].double())
    theta = yaws.double()

    s = torch.abs(torch.sin(theta - alpha)).float()
    c = torch.abs(torch.cos(theta - alpha)).float()
    off_w = torch.abs(w_swapped / (2.0 * torch.where(s < 1e-12, 1e-12, s)))
    off_l = torch.abs(l_swapped / (2.0 * torch.where(c < 1e-12, 1e-12, c)))
    offset = torch.minimum(off_w, off_l)

    x_dash = centroids[..., 0] + offset * torch.cos(alpha).float()
    y_dash = centroids[..., 1] + offset * torch.sin(alpha).float()
    return torch.stack([x_dash, y_dash, centroids[..., 2]], dim=-1)

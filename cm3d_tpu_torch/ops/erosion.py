"""Binary mask erosion (3x3) on unpacked masks. Mirrors
`cm3d_tpu/ops/erosion.py`.

Replaces the reference's per-mask `cv2.erode(mask, np.ones((3,3)))` host round
trip (src/nuscenes/2d_to_3d.py:526-528). cv2's default border mode for erode
treats out-of-image neighbors as +inf (they never shrink the min), so the
border is padded with True. The lift erodes packed mask words instead
(ops/bitmask.py erode3x3_packed); this is the unpacked counterpart.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def erode3x3(masks: torch.Tensor) -> torch.Tensor:
    """3x3 binary erosion over the last two dims.

    Args:
      masks: [..., H, W] bool or uint8.

    Returns same shape/dtype: pixel survives iff its full in-image 3x3
    neighborhood is nonzero (out-of-image neighbors count as nonzero,
    matching cv2.erode's default BORDER_CONSTANT(+inf)).
    """
    h, w = masks.shape[-2:]
    padded = F.pad((masks != 0).to(torch.uint8), (1, 1, 1, 1), value=1).bool()
    out = torch.ones(masks.shape, dtype=torch.bool, device=masks.device)
    for dy in range(3):
        for dx in range(3):
            out &= padded[..., dy:dy + h, dx:dx + w]
    return out.to(masks.dtype)

"""Device-side SAM mask postprocess: logits -> packed bit-planes, mirrors
`cm3d_tpu/ops/maskpack.py`.

The reference upsamples each low-res mask logit map to image size with
bilinear interpolation, thresholds at 0, transposes to [W, H] and
RLE-encodes on the CPU (gen_2d_masks_detic.py:454-472 + SamPredictor
postprocess). Here the postprocess runs on the device and emits the
bit-packed planes the lift consumes (ops/bitmask.py layout: bit m of word
[x, y, m // 32]), carried as int32 words and packed with shifts.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from cm3d_tpu_torch.utils.observability import span


def make_plane_postprocess(
    mask_wh: Tuple[int, int],
    cam_hw: Sequence[Tuple[int, int]],
    num_words: int,
    chunk: int = 16,
    rect: bool = False,
    layout: str = "xy",
):
    """Build a fn: (logits [C, P, hm, wm], n_boxes [C] ints) -> planes
    [W, H, num_words] int32 (layout "xy", the lift's input) or
    [H, W, num_words] (layout "yx", sequential for the host COCO-RLE
    encoder).

    Masks are bit-indexed camera-major in artifact order: mask p of camera c
    gets bit offset(c) + p where offset = cumsum(n_boxes). Prompts beyond
    n_boxes[c] and bits beyond 32*num_words are dropped.

    Args:
      mask_wh: (W, H) plane extent (the largest camera geometry).
      cam_hw: per-camera true image (h, w): masks are cropped to it.
      num_words: Mw words of 32 mask bits.
      chunk: prompts upsampled at once (bounds the [chunk, side, side] f32
        intermediate).
      rect: logits come from a rect-encoded SAM: they cover the image
        directly at 1/4 resolution, so upsample by an exact 4x per axis
        instead of to the padded square.

    The fn's `offset` is the bit of the first camera's first mask: a rank
    of the camera-parallel mask stage packs its block of the ring with the
    masks of the cameras before it counted, and the ranks' planes OR
    together into the ring's.
    """
    w_plane, h_plane = mask_wh
    if layout not in ("xy", "yx"):
        raise ValueError(f"layout must be 'xy' or 'yx', got {layout!r}")
    xy = layout == "xy"

    def postprocess(logits: torch.Tensor, n_boxes, offset: int = 0) -> torch.Tensor:
        c, p, hm, wm = logits.shape
        if c != len(cam_hw):
            raise ValueError(f"logits for {c} cameras, geometry for {len(cam_hw)}")
        shape = (num_words, w_plane, h_plane) if xy else (num_words, h_plane, w_plane)
        planes = torch.zeros(shape, dtype=torch.int32, device=logits.device)
        for ci in range(c):
            h_c, w_c = cam_hw[ci]
            up_hw = (4 * hm, 4 * wm) if rect else (max(h_c, w_c),) * 2
            n_c = min(int(n_boxes[ci]), p, max(num_words * 32 - offset, 0))
            for p0 in range(0, n_c, chunk):
                p1 = min(p0 + chunk, n_c)
                up = F.interpolate(logits[ci, p0:p1, None].float(), size=up_hw,
                                   mode="bilinear", align_corners=False,
                                   antialias=up_hw[0] < hm)[:, 0]
                m = (up[:, :h_c, :w_c] > 0).to(torch.int32)  # [k, h_c, w_c]
                if xy:
                    m = m.transpose(1, 2)
                bits = torch.arange(offset + p0, offset + p1, device=logits.device,
                                    dtype=torch.int32)
                vals = m << (bits & 31)[:, None, None]
                words = bits >> 5
                with span("cm3d.maskpack.wait"):  # reads device values
                    w0, w1 = int(words[0]), int(words[-1])
                for wd in range(w0, w1 + 1):
                    # distinct bits: their int64 sum is their OR
                    with span("cm3d.maskpack.wait"):  # a boolean index syncs
                        sel = vals[words == wd]
                    word = sel.sum(0).to(torch.int32)
                    planes[wd, :word.shape[0], :word.shape[1]] |= word
            offset += int(n_boxes[ci])
        return planes.permute(1, 2, 0).contiguous()

    return postprocess

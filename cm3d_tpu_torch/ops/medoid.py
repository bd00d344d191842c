"""Medoid (argmin of pairwise-distance sums) without materializing K x K.

The reference computes `torch.cdist(P.T, P.T).sum(axis=0).argmin()` per mask
(src/nuscenes/2d_to_3d.py:116-119). Here the sums are batched over masks in
`kernels/medoid.py` (the CUDA kernel on the card, its plain chunked version
on the CPU) with exact per-dimension f32 differences, and the argmin takes
the first minimal index, like torch.argmin.

PRECONDITION (kernel contract): valid points must be COMPACTED to the front
of each row; the lift's compaction stages guarantee it.
"""

from __future__ import annotations

import torch

from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums, medoid_distance_sums_rows


def _argmin_valid(sums: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    sums = torch.where(valid, sums, torch.inf)
    return torch.argmin(sums, dim=-1).to(torch.int32)


def medoid_index(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Index of the medoid of a single point set.

    Args:
      points: [K, 3] coordinates (padding rows arbitrary on the CPU; on the
        card the kernel additionally requires valid rows COMPACTED to the
        front — every producer in this package emits compacted rows).
      valid: [K] bool; invalid rows are excluded from sums and argmin.

    Returns scalar int32 index of the medoid (first-minimum tie-break).
    """
    return masked_medoid(points[None], valid[None])[0]


def masked_medoid(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched medoid. points [M, K, 3], valid [M, K] -> [M] int32.

    For each m: argmin_i sum_j valid_j * ||p_i - p_j||_2 over valid i
    (index 0 when a row has no valid point)."""
    return _argmin_valid(medoid_distance_sums(points.to(torch.float32), valid), valid)


def masked_medoid_rows(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Batched medoid from D-major coords. rows [M, 3, K], valid [M, K] ->
    [M] int32; the compaction's output layout goes straight in."""
    return _argmin_valid(medoid_distance_sums_rows(rows.to(torch.float32), valid), valid)

"""Masked pairwise-L2 distance sums (the medoid inner loop): CUDA kernel
wrapper + plain version.

    sums[r, i] = sum_j valid[r, j] * ||p_i - p_j||

Replaces the TPU kernels `cm3d_tpu/kernels/medoid_pallas.py
medoid_distance_sums_rows_pallas` (D-major [R, 3, K] input) and
`medoid_distance_sums_pallas` ([R, K, 3] input, a layout wrapper over the
same kernel here too). The CUDA kernels (csrc/medoid.cu, four behind one
launcher call) are bound by f32 operations on the H100 and compute each
unordered pair once over 128-point tile pairs, with partial sums in a
scratch reduced in a fixed order (the same bits on every call); the source
note says more. Each distance uses exact per-dimension f32 differences —
never `torch.cdist`, whose matmul mode cancels catastrophically at
global-frame coordinates.

Precondition (as on the TPU): each row's valid points come FIRST; the kernel
only sums over the first count_r = valid[r].sum() points. Sums at invalid i
differ between the kernel (0) and the plain version; mask them before an
argmin.

Dispatch: the dispatcher op `cm3d_torch::medoid_sums` (kernels/ops.py), one
call for all of a call's launches: a CPU tensor runs the plain version; a
CUDA tensor launches the kernels or raises.
`medoid_distance_sums_rows.launches` counts launcher calls (both entry
points launch through it; one a call unless the rows' partial sums exceed
`SCRATCH_BYTES`).
"""

from __future__ import annotations

import ctypes

import torch

from cm3d_tpu_torch.kernels import build, ops

# pairwise block of the plain version: ~2^26 f32 per [R, chunk, K] temporary
_PLAIN_BLOCK = 1 << 26
TILE = 128  # points a tile of the kernels (csrc/medoid.cu kTile)
SCRATCH_BYTES = 1 << 28  # the partial sums one launcher call may hold


def rows_per_launch(k: int) -> int:
    """Rows one launcher call takes, so that its partial sums
    [rows, ceil(K / TILE), K] f32 stay within SCRATCH_BYTES (at least one)."""
    return max(1, SCRATCH_BYTES // (-(-k // TILE) * k * 4))


def medoid_distance_sums_rows_plain(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version over row chunks (no cdist): [R, 3, K] -> [R, K]."""
    r, _, k = rows.shape
    validf = valid.to(torch.float32)
    rows = rows.to(torch.float32) * validf[:, None, :]
    x, y, z = rows[:, 0], rows[:, 1], rows[:, 2]
    out = torch.empty((r, k), dtype=torch.float32, device=rows.device)
    chunk = max(1, min(k, _PLAIN_BLOCK // max(r * k, 1)))
    for i0 in range(0, k, chunk):
        sl = slice(i0, i0 + chunk)
        dx = x[:, sl, None] - x[:, None, :]
        dy = y[:, sl, None] - y[:, None, :]
        dz = z[:, sl, None] - z[:, None, :]
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
        out[:, sl] = (dist * validf[:, None, :]).sum(dim=-1)
    return out


def medoid_distance_sums_rows(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Distance sums from D-major coords rows [R, 3, K] f32, valid [R, K]
    bool -> [R, K] f32 (the layout the compaction emits)."""
    if rows.ndim != 3 or rows.shape[1] != 3 or valid.shape != (rows.shape[0], rows.shape[2]):
        raise ValueError(f"medoid sums: rows [R, 3, K] and valid [R, K] expected, "
                         f"got {tuple(rows.shape)} and {tuple(valid.shape)}")
    if valid.dtype != torch.bool or rows.dtype != torch.float32:
        raise TypeError(f"medoid sums: f32 rows and bool valid expected, "
                        f"got {rows.dtype} and {valid.dtype}")
    if rows.device != valid.device:
        raise ValueError("medoid sums: rows and valid on different devices")
    return _op(rows, valid)


def _medoid_sums_cuda(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The whole row-chunk loop of launcher calls, one op call."""
    r, _, k = rows.shape
    if r > 65535:
        raise ValueError(f"medoid sums: at most 65535 rows per launch, got {r}")
    out = torch.empty((r, k), dtype=torch.float32, device=rows.device)
    if r == 0 or k == 0:
        return out
    rows = rows.contiguous()
    valid = valid.contiguous()
    lib = _lib()
    step = min(r, rows_per_launch(k))
    # scratch: the rows' counts of valid points, the tile pairs' prefix over
    # the rows, and the partial sums
    counts = torch.empty(step, dtype=torch.int32, device=rows.device)
    off = torch.empty(step + 1, dtype=torch.int32, device=rows.device)
    part = torch.empty((step, -(-k // TILE), k), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    for r0 in range(0, r, step):
        n = min(step, r - r0)
        err = lib.medoid_sums_launch(
            rows[r0].data_ptr(), valid[r0].data_ptr(), counts.data_ptr(), off.data_ptr(),
            part.data_ptr(), out[r0].data_ptr(), n, k, stream)
        build.check(err, "medoid_distance_sums_rows")
        medoid_distance_sums_rows.launches += 1
    return out


medoid_distance_sums_rows.launches = 0

_op = ops.define(
    "medoid_sums(Tensor rows, Tensor valid) -> Tensor",
    cpu=medoid_distance_sums_rows_plain, cuda=_medoid_sums_cuda,
    fake=lambda rows, valid: rows.new_empty((rows.shape[0], rows.shape[2]), dtype=torch.float32))


def medoid_distance_sums(points: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Distance sums for point sets [R, K, 3] f32, valid [R, K] -> [R, K]."""
    return medoid_distance_sums_rows(points.transpose(1, 2), valid)


def _lib() -> ctypes.CDLL:
    lib = build.load("medoid")
    lib.medoid_sums_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.medoid_sums_launch.restype = ctypes.c_int
    return lib

"""Segment sum (+ max) over sorted cell ids: CUDA kernel wrappers + plain versions.

    sums[r, :, c] = sum of values[r, :, i]  over i with cell[r, i] == c
    maxs[r, c]    = max of maxvals[r, i]    over the same i   (empty -> -inf)

for c in [0, n_cells). Replaces the TPU kernels
`cm3d_tpu/kernels/segment_pallas.py segment_sum_max_pallas` (pillar
voxelization) and `segment_sum_pallas` (the lift-splat BEV pooling, with its
VJP). The contract is theirs: `cell` is NON-DECREASING along each row (sort
first; ids >= n_cells are a sink that sorts last and matches no output
column), `values` is zero and `maxvals` -inf at elements to ignore, empty
cells give exactly 0 and -inf. The batch is the kernel's rows.

The CUDA forward (csrc/segment.cu) is one kernel over tiles of 256 cells
and chunks of 8 channels: a block finds its cells' elements with two
searches, a thread sums its cell's run when it is short, a warp when it is
long, and empty cells get 0 and -inf. Every sum's order depends on the ids
alone, so a call replays bit for bit; there are no float atomics, and the
values of elements with sink ids are never read. The kernels are bound by
memory bytes on the H100. The plain versions are scatter reductions, used
on the CPU and as the yardstick the kernels are held to; nothing on the
card's path calls them.

`segment_sum` is differentiable in `values`: the transpose of a sum over
fixed cells is the gather dvalues[r, :, i] = g[r, :, cell[r, i]] (0 at sink
ids), a kernel of the same source on the card (`segment_sum_bwd`).

Dispatch: the dispatcher ops `cm3d_torch::segment_sum_max`, `segment_sum`
and `segment_sum_bwd` (kernels/ops.py): a CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises. Sortedness is the
caller's contract and is not checked on the hot path. Each wrapper's
`.launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cm3d_tpu_torch.kernels import build, ops

_MAX_GRID = 65535  # rows and channel chunks ride gridDim.z / gridDim.y


def _scatter_index(cell: torch.Tensor, n_cells: int, d: int) -> torch.Tensor:
    """[R, D, N] int64 scatter index: sink ids go to one extra column."""
    r, n = cell.shape
    return cell.clamp(min=0, max=n_cells).to(torch.int64)[:, None, :].expand(r, d, n)


def segment_sum_plain(cell: torch.Tensor, values: torch.Tensor, n_cells: int) -> torch.Tensor:
    """Plain PyTorch version of `segment_sum` (any id order):
    `scatter_add_` into a zero buffer with a sink column, differentiable by
    autograd."""
    r, d, _ = values.shape
    out = torch.zeros((r, d, n_cells + 1), dtype=values.dtype, device=values.device)
    out = out.scatter_add(2, _scatter_index(cell, n_cells, d), values)
    return out[:, :, :n_cells].contiguous()


def segment_sum_max_plain(cell: torch.Tensor, values: torch.Tensor, maxvals: torch.Tensor,
                          n_cells: int):
    """Plain PyTorch version of `segment_sum_max` (any id order)."""
    r, n = cell.shape
    sums = segment_sum_plain(cell, values, n_cells)
    idx = cell.clamp(min=0, max=n_cells).to(torch.int64)
    maxs = torch.full((r, n_cells + 1), float("-inf"), dtype=maxvals.dtype,
                      device=maxvals.device)
    maxs = maxs.scatter_reduce(1, idx, maxvals, "amax", include_self=True)
    return sums, maxs[:, :n_cells].contiguous()


def segment_sum_bwd_plain(cell: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the sum's backward: g [R, D, n_cells] ->
    dvalues [R, D, N], each element its cell's cotangent, sink ids 0."""
    r, d, n_cells = g.shape
    gz = torch.cat([g, g.new_zeros((r, d, 1))], dim=2)
    return torch.gather(gz, 2, _scatter_index(cell, n_cells, d))


def _check(cell, values, n_cells: int, name: str, maxvals=None) -> None:
    if cell.ndim != 2 or values.ndim != 3 or values.shape[0] != cell.shape[0] \
            or values.shape[2] != cell.shape[1]:
        raise ValueError(f"{name}: cell [R, N] and values [R, D, N] expected, got "
                         f"{tuple(cell.shape)} and {tuple(values.shape)}")
    if maxvals is not None and tuple(maxvals.shape) != tuple(cell.shape):
        raise ValueError(f"{name}: maxvals must be [R, N] = {tuple(cell.shape)}, got "
                         f"{tuple(maxvals.shape)}")
    if cell.dtype != torch.int32:
        raise TypeError(f"{name}: cell must be int32, got {cell.dtype}")
    for t in (values, maxvals):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: values and maxvals must be float32, got {t.dtype}")
        if t is not None and t.device != cell.device:
            raise ValueError(f"{name}: cell and values on different devices")
    if n_cells < 1:
        raise ValueError(f"{name}: n_cells must be >= 1, got {n_cells}")


def _check_cuda(cell, values, n_cells: int, name: str) -> None:
    if cell.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {cell.device}")
    r, d, n = values.shape
    if r > _MAX_GRID or -(-d // 8) > _MAX_GRID:
        raise ValueError(f"{name}: at most {_MAX_GRID} rows and {8 * _MAX_GRID} channels, "
                         f"got {r} and {d}")
    if max(r * d * n, r * d * n_cells) >= 2**40 or max(n, n_cells) >= 2**31:
        raise ValueError(f"{name}: sizes too large: values {tuple(values.shape)}, "
                         f"n_cells {n_cells}")


def segment_sum_max(cell: torch.Tensor, values: torch.Tensor, maxvals: torch.Tensor,
                    n_cells: int):
    """cell [R, N] int32 sorted, values [R, D, N] f32, maxvals [R, N] f32 ->
    (sums [R, D, n_cells], maxs [R, n_cells]). Not differentiable (pillars
    do not depend on parameters)."""
    _check(cell, values, n_cells, "segment_sum_max", maxvals)
    return _sum_max_op(cell, values, maxvals, n_cells)


def _segment_sum_max_cuda(cell, values, maxvals, n_cells: int):
    _check_cuda(cell, values, n_cells, "segment_sum_max")
    r, d, n = values.shape
    sums = torch.empty((r, d, n_cells), dtype=torch.float32, device=cell.device)
    maxs = torch.empty((r, n_cells), dtype=torch.float32, device=cell.device)
    if r == 0:
        return sums, maxs
    if d == 0 or n == 0:  # nothing to walk: every cell is empty
        return sums.zero_(), maxs.fill_(float("-inf"))
    cell, values, maxvals = cell.contiguous(), values.contiguous(), maxvals.contiguous()
    err = _lib().segment_sum_max_launch(
        cell.data_ptr(), values.data_ptr(), maxvals.data_ptr(), sums.data_ptr(),
        maxs.data_ptr(), r, n, d, n_cells,
        torch.cuda.current_stream(cell.device).cuda_stream)
    build.check(err, "segment_sum_max")
    segment_sum_max.launches += 1
    return sums, maxs


segment_sum_max.launches = 0


def _segment_sum_cuda(cell: torch.Tensor, values: torch.Tensor, n_cells: int) -> torch.Tensor:
    _check_cuda(cell, values, n_cells, "segment_sum")
    r, d, n = values.shape
    sums = torch.empty((r, d, n_cells), dtype=torch.float32, device=cell.device)
    if r == 0 or d == 0:
        return sums
    if n == 0:
        return sums.zero_()
    cell, values = cell.contiguous(), values.contiguous()
    err = _lib().segment_sum_launch(
        cell.data_ptr(), values.data_ptr(), sums.data_ptr(), r, n, d, n_cells,
        torch.cuda.current_stream(cell.device).cuda_stream)
    build.check(err, "segment_sum")
    segment_sum.launches += 1
    return sums


def segment_sum_bwd(cell: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The sum's backward: cell [R, N] int32, g [R, D, n_cells] f32 ->
    dvalues [R, D, N] (see `segment_sum_bwd_plain`)."""
    if g.ndim != 3 or cell.ndim != 2 or g.shape[0] != cell.shape[0]:
        raise ValueError(f"segment_sum_bwd: cell [R, N] and g [R, D, n_cells] expected, got "
                         f"{tuple(cell.shape)} and {tuple(g.shape)}")
    return _bwd_op(cell, g)


def _segment_sum_bwd_cuda(cell: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if cell.dtype != torch.int32 or g.dtype != torch.float32:
        raise TypeError(f"segment_sum_bwd: int32 cell and float32 g expected, got "
                        f"{cell.dtype} and {g.dtype}")
    r, d, n_cells = g.shape
    n = cell.shape[1]
    dvalues = torch.empty((r, d, n), dtype=torch.float32, device=cell.device)
    _check_cuda(cell, dvalues, n_cells, "segment_sum_bwd")
    if dvalues.numel() == 0:
        return dvalues
    cell, g = cell.contiguous(), g.contiguous()
    err = _lib().segment_sum_bwd_launch(
        cell.data_ptr(), g.data_ptr(), dvalues.data_ptr(), r, n, d, n_cells,
        torch.cuda.current_stream(cell.device).cuda_stream)
    build.check(err, "segment_sum_bwd")
    segment_sum_bwd.launches += 1
    return dvalues


segment_sum_bwd.launches = 0


class _SegmentSum(torch.autograd.Function):
    """Forward: the sum kernel (plain scatter on the CPU). Backward: the
    gather, never a scatter; `cell` gets no gradient."""

    @staticmethod
    def forward(ctx, cell, values, n_cells):
        ctx.save_for_backward(cell)
        return _sum_op(cell, values, n_cells)

    @staticmethod
    def backward(ctx, g):
        (cell,) = ctx.saved_tensors
        return None, segment_sum_bwd(cell, g.contiguous()), None


def segment_sum(cell: torch.Tensor, values: torch.Tensor, n_cells: int) -> torch.Tensor:
    """cell [R, N] int32 sorted, values [R, D, N] f32 -> sums
    [R, D, n_cells], differentiable in `values`."""
    _check(cell, values, n_cells, "segment_sum")
    return _SegmentSum.apply(cell, values, n_cells)


segment_sum.launches = 0

_sum_max_op = ops.define(
    "segment_sum_max(Tensor cell, Tensor values, Tensor maxvals, int n_cells) -> (Tensor, Tensor)",
    cpu=segment_sum_max_plain, cuda=_segment_sum_max_cuda,
    fake=lambda cell, values, maxvals, n_cells: (
        values.new_empty((values.shape[0], values.shape[1], n_cells)),
        maxvals.new_empty((maxvals.shape[0], n_cells))))
_sum_op = ops.define(
    "segment_sum(Tensor cell, Tensor values, int n_cells) -> Tensor",
    cpu=segment_sum_plain, cuda=_segment_sum_cuda,
    fake=lambda cell, values, n_cells: values.new_empty(
        (values.shape[0], values.shape[1], n_cells)))
_bwd_op = ops.define(
    "segment_sum_bwd(Tensor cell, Tensor g) -> Tensor",
    cpu=segment_sum_bwd_plain, cuda=_segment_sum_bwd_cuda,
    fake=lambda cell, g: g.new_empty((g.shape[0], g.shape[1], cell.shape[1])))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("segment")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum_max_launch.argtypes = [ptr] * 5 + [i] * 4 + [ptr]
    lib.segment_sum_launch.argtypes = [ptr] * 3 + [i] * 4 + [ptr]
    lib.segment_sum_bwd_launch.argtypes = [ptr] * 3 + [i] * 4 + [ptr]
    for fn in (lib.segment_sum_max_launch, lib.segment_sum_launch, lib.segment_sum_bwd_launch):
        fn.restype = ctypes.c_int
    return lib

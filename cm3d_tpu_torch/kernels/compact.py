"""Order-preserving row compaction: CUDA kernel wrapper + plain version.

    out[r, :, l] = values[r, :, i_l]   where i_l = position of the l-th True
                                       of sel[r] (ascending; l >= count -> 0)

Replaces the TPU kernel `cm3d_tpu/kernels/compact_pallas.py
compact_rows_pallas`. The CUDA kernel (csrc/compact.cu) moves raw 32-bit
words, so any 4-byte payload (f32 coordinates, int32 ids, mask words) comes
out bit-exact. It is bound by memory bytes on the H100; the source note in
csrc/compact.cu says what the design does about that: each row is cut into
tiles (`plan_tiles`), and a call queues two kernels, a count over the tiles
and a scatter that takes its tile's first slot from the counts.

Dispatch: the dispatcher op `cm3d_torch::compact_rows` (kernels/ops.py): a
CPU tensor runs `compact_rows_plain`; a CUDA tensor launches the kernels or
raises. `compact_rows.launches` counts launcher calls.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cm3d_tpu_torch.kernels import build, ops


def compact_rows_plain(sel: torch.Tensor, values: torch.Tensor, limit: int) -> torch.Tensor:
    """Plain PyTorch version: cumsum -> destination slot, then a scatter
    (unkept sources go to a sink column that is sliced off)."""
    r, s = sel.shape
    d = values.shape[1]
    dest = torch.cumsum(sel.to(torch.int64), dim=1) - 1
    dest = torch.where(sel & (dest < limit), dest, limit)
    out = torch.zeros((r, d, limit + 1), dtype=values.dtype, device=values.device)
    out.scatter_(2, dest[:, None, :].expand(r, d, s), values)
    return out[:, :, :limit].contiguous()


TILE = 4096  # sources a tile: the fastest of 1024 / 2048 / 4096 at all three lift stages
MAX_TILES = 1024  # tiles a row at most: each scatter block adds up its row's counts


def plan_tiles(sources: int) -> tuple[int, int]:
    """(tile, tiles a row) of a call: tiles of TILE sources, widened (in
    multiples of 16) until a row has at most MAX_TILES."""
    tile = max(TILE, 16 * -(-sources // (16 * MAX_TILES)))
    return tile, max(1, -(-sources // tile))


def _check(sel: torch.Tensor, values: torch.Tensor, limit: int) -> None:
    if sel.ndim != 2 or values.ndim != 3 or values.shape[0] != sel.shape[0] \
            or values.shape[2] != sel.shape[1]:
        raise ValueError(f"compact_rows: sel [R, S] and values [R, D, S] expected, "
                         f"got {tuple(sel.shape)} and {tuple(values.shape)}")
    if sel.dtype != torch.bool:
        raise TypeError(f"compact_rows: sel must be bool, got {sel.dtype}")
    if limit < 0:
        raise ValueError(f"compact_rows: limit must be >= 0, got {limit}")
    if sel.device != values.device:
        raise ValueError("compact_rows: sel and values on different devices")
    if max(values.shape + (limit,)) >= 2**31:
        raise ValueError(f"compact_rows: sizes must fit in int32, got "
                         f"{tuple(values.shape)} and limit {limit}")


def compact_rows(sel: torch.Tensor, values: torch.Tensor, limit: int) -> torch.Tensor:
    """sel [R, S] bool, values [R, D, S] (any 4-byte dtype on CUDA) ->
    out [R, D, limit] of values' dtype. Bit-exact equivalent of the JAX
    package's `_compact_topk` + take_along_axis."""
    _check(sel, values, limit)
    return _op(sel, values, limit)


def _compact_rows_cuda(sel: torch.Tensor, values: torch.Tensor, limit: int) -> torch.Tensor:
    if values.element_size() != 4:
        raise TypeError(f"compact_rows: CUDA path moves 32-bit words, got {values.dtype}")
    r, d, s = values.shape
    out = torch.empty((r, d, limit), dtype=values.dtype, device=values.device)
    if r == 0 or d == 0 or limit == 0:
        return out
    sel = sel.contiguous()
    words = values.contiguous().view(torch.int32)
    tile, n_tiles = plan_tiles(s)
    counts = torch.empty((r, n_tiles), dtype=torch.int32, device=values.device)
    err = _lib().compact_rows_launch(
        sel.data_ptr(), words.data_ptr(), out.data_ptr(), counts.data_ptr(), r, s, d, limit,
        tile, torch.cuda.current_stream(values.device).cuda_stream,
    )
    build.check(err, "compact_rows")
    compact_rows.launches += 1
    return out


compact_rows.launches = 0

_op = ops.define(
    "compact_rows(Tensor sel, Tensor values, int limit) -> Tensor",
    cpu=compact_rows_plain, cuda=_compact_rows_cuda,
    fake=lambda sel, values, limit: values.new_empty((values.shape[0], values.shape[1], limit)))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("compact")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.compact_rows_launch.argtypes = [ptr] * 4 + [i] * 5 + [ptr]
    lib.compact_rows_launch.restype = ctypes.c_int
    return lib

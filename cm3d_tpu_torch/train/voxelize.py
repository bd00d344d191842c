"""Pillar voxelization (PointPillars-style), mirrors
`cm3d_tpu/train/voxelize.py`.

Points reduce into a BEV grid with per-pillar mean / max aggregation: the
points of a batch are sorted by cell id (a stable sort, so the order inside
a cell is the input order) and reduced by `kernels.segment.segment_sum_max`,
the hand-written sorted-segment kernel on a CUDA tensor, its plain scatter
version on a CPU tensor. The batch is the kernel's rows. Same values as the
JAX package's two formulations up to f32 addition order.
"""

from __future__ import annotations

import dataclasses

import torch

from cm3d_tpu_torch.kernels.segment import segment_sum_max


class _ApplyPermutation(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return _gather_rows(vals, perm)

    @staticmethod
    def backward(ctx, ct):
        (inv_perm,) = ctx.saved_tensors
        return _gather_rows(ct, inv_perm), None, None


def _gather_rows(vals: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """vals [..., n, F], index [..., n] -> vals[..., index, :]."""
    idx = index.to(torch.int64)[..., None].expand(*index.shape, vals.shape[-1])
    return torch.gather(vals, -2, idx)


def apply_permutation(vals: torch.Tensor, perm: torch.Tensor,
                      inv_perm: torch.Tensor) -> torch.Tensor:
    """vals[..., perm, :] with an exact gather backward (perm must be a
    bijection of the row axis): the cotangent of a permutation gather is
    ct[..., inv_perm, :], another row gather, where autograd's transpose of
    a gather would be a scatter-add. vals [..., n, F], perm and inv_perm
    [..., n]; the integer operands get no gradient."""
    return _ApplyPermutation.apply(vals, perm, inv_perm)


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv[..., perm[..., i]] = i, an integer scatter (exact)."""
    iota = torch.arange(perm.shape[-1], device=perm.device, dtype=perm.dtype)
    return torch.empty_like(perm).scatter_(-1, perm, iota.expand_as(perm))


@dataclasses.dataclass(frozen=True)
class PillarConfig:
    x_min: float = -51.2
    x_max: float = 51.2
    y_min: float = -51.2
    y_max: float = 51.2
    z_min: float = -5.0
    z_max: float = 3.0
    resolution: float = 0.8  # pillar edge in meters

    @property
    def grid_hw(self):
        h = int(round((self.x_max - self.x_min) / self.resolution))
        w = int(round((self.y_max - self.y_min) / self.resolution))
        return h, w

    # feature channels: mean xyz offset-from-pillar-center, mean intensity,
    # max z, log count
    num_features: int = 6


def cell_ids(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, cfg: PillarConfig):
    """(ix, iy, in_range) of ego-frame coordinates: the pillar a point falls
    in, by a full-f32 division (a reciprocal multiply bins points on a cell
    edge differently), and whether it lies inside the grid and z range."""
    h, w = cfg.grid_hw
    ix = torch.floor((x - cfg.x_min) / cfg.resolution).to(torch.int32)
    iy = torch.floor((y - cfg.y_min) / cfg.resolution).to(torch.int32)
    in_range = ((ix >= 0) & (ix < h) & (iy >= 0) & (iy < w)
                & (z > cfg.z_min) & (z < cfg.z_max))
    return ix, iy, in_range


@torch.no_grad()
def pillarize(points: torch.Tensor, valid: torch.Tensor, cfg: PillarConfig) -> torch.Tensor:
    """[B, N, 4] ego-frame points, [B, N] valid -> [B, H, W, F] pillar
    features (a single [N, 4] sample gives [H, W, F]).

    Out-of-range or invalid points drop out via a sink cell."""
    if points.ndim == 2:
        return pillarize(points[None], valid[None], cfg)[0]
    h, w = cfg.grid_hw
    points = points.float()
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    intensity = points[..., 3] if points.shape[-1] > 3 else torch.zeros_like(z)

    ix, iy, in_range = cell_ids(x, y, z, cfg)
    in_range = in_range & valid
    # the sink id h*w is >= n_cells: it matches no column and is never summed
    cell = torch.where(in_range, ix * w + iy, h * w)
    n_cells = h * w

    cx = (ix.float() + 0.5) * cfg.resolution + cfg.x_min
    cy = (iy.float() + 0.5) * cfg.resolution + cfg.y_min
    zero = torch.zeros_like(z)
    vals = torch.stack([
        torch.where(in_range, x - cx, zero),
        torch.where(in_range, y - cy, zero),
        torch.where(in_range, z, zero),
        torch.where(in_range, intensity, zero),
        in_range.float(),
    ], dim=1)  # [B, 5, N]

    cell_s, perm = torch.sort(cell, dim=1, stable=True)
    vals_s = torch.gather(vals, 2, perm[:, None, :].expand_as(vals))
    # the max channel is z masked by in_range, derived after the sort
    zm_s = torch.where(vals_s[:, 4] > 0, vals_s[:, 2], float("-inf"))
    sums, maxs = segment_sum_max(cell_s, vals_s, zm_s, n_cells)
    count = sums[:, 4]  # [B, n_cells]
    mean_feats = sums[:, :4] / count.clamp(min=1.0)[:, None, :]
    max_z = maxs.clamp(min=cfg.z_min)
    feats = torch.cat([mean_feats, max_z[:, None], torch.log1p(count)[:, None]], dim=1)
    feats = feats.permute(0, 2, 1)
    return feats.reshape(-1, h, w, cfg.num_features)

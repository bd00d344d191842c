"""Train-time augmentation for the semi-sup detectors, mirrors
`cm3d_tpu/train/augment.py`.

The whole transform is one affine A applied identically to points and box
centers (sizes scale, yaws rotate / reflect), so it runs inside the train
step on the device. For the camera+LiDAR model the SAME rigid+scale A
premultiplies `cam_to_ego`, keeping the lift-splat geometry consistent.

Randomness: the five quantities of each sample's transform are drawn on the
CPU from a `torch.Generator` seeded from (seed, global step), then moved, so
a killed-and-resumed run replays its own sequence exactly. The sequence is
the port's own: `jax.random` (threefry) draws other numbers from the same
seed. The geometry is the JAX package's, function for function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    flip_x_prob: float = 0.5  # reflect across the y axis (x -> -x)
    flip_y_prob: float = 0.5  # reflect across the x axis (y -> -y)
    rot_max: float = 0.3925  # global z-rotation, U(-rot_max, rot_max) rad
    scale_min: float = 0.95
    scale_max: float = 1.05
    translate_std: float = 0.2  # N(0, std) xyz shift, meters


class AffineParams(NamedTuple):
    """One transform per sample, leading dim B."""

    flip_x: torch.Tensor  # [B] bool
    flip_y: torch.Tensor  # [B] bool
    theta: torch.Tensor  # [B] f32
    scale: torch.Tensor  # [B] f32
    shift: torch.Tensor  # [B, 3] f32


def step_generator(seed: int, step: int, rank: Optional[int] = None) -> torch.Generator:
    """The CPU generator of global step `step` of a run seeded `seed`;
    with `rank`, folded with the rank (the `axis_name` train step, as JAX
    folds in `axis_index`), so that each replica draws its own transforms."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9 + 1) % (2 ** 63)
    if rank is not None:
        mixed = (mixed * 0x94D049BB133111EB + int(rank) + 1) % (2 ** 63)
    return torch.Generator().manual_seed(mixed)


def sample_affine(generator: torch.Generator, batch_size: int, cfg: AugmentConfig,
                  device=None) -> AffineParams:
    """Draw each sample's (flips, angle, scale, shift) on the CPU."""
    u = torch.rand((4, batch_size), generator=generator)
    shift = cfg.translate_std * torch.randn((batch_size, 3), generator=generator)
    params = AffineParams(
        flip_x=u[0] < cfg.flip_x_prob,
        flip_y=u[1] < cfg.flip_y_prob,
        theta=(2.0 * u[2] - 1.0) * cfg.rot_max,
        scale=cfg.scale_min + u[3] * (cfg.scale_max - cfg.scale_min),
        shift=shift,
    )
    return AffineParams(*(t.to(device) for t in params))


def affine_matrix(params: AffineParams) -> torch.Tensor:
    """[B, 4, 4]: rotate AFTER flip, A3 = scale * R @ F, and the shift."""
    sx = torch.where(params.flip_x, -1.0, 1.0)
    sy = torch.where(params.flip_y, -1.0, 1.0)
    c, s = torch.cos(params.theta), torch.sin(params.theta)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    r = torch.stack([
        torch.stack([c * sx, -s * sy, zero], dim=-1),
        torch.stack([s * sx, c * sy, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)  # [B, 3, 3]
    a = torch.zeros((c.shape[0], 4, 4), dtype=torch.float32, device=c.device)
    a[:, :3, :3] = params.scale[:, None, None] * r
    a[:, :3, 3] = params.shift
    a[:, 3, 3] = 1.0
    return a


def apply_affine(params: AffineParams, points: torch.Tensor, boxes: torch.Tensor,
                 cam_to_ego: Optional[torch.Tensor] = None):
    """Transform points [B, N, 4], boxes [B, M, 8] and cam_to_ego
    [B, C, 4, 4] by each sample's affine. The coordinate products need full
    f32 (TF32 would round meter-scale coordinates by centimetres): the
    training entry points call `utils.device.strict_f32()`."""
    a = affine_matrix(params)
    a3t, shift = a[:, :3, :3].transpose(1, 2), a[:, None, :3, 3]
    new_pts = torch.cat([points[..., :3] @ a3t + shift, points[..., 3:]], dim=-1)
    center = boxes[..., :3] @ a3t + shift
    size = boxes[..., 3:6] * params.scale[:, None, None]
    # yaw under reflection: x-flip maps yaw -> pi - yaw, y-flip -> -yaw;
    # then the rotation adds theta. sin/cos targets make wrapping free.
    yaw = boxes[..., 6]
    yaw = torch.where(params.flip_x[:, None], math.pi - yaw, yaw)
    yaw = torch.where(params.flip_y[:, None], -yaw, yaw)
    yaw = yaw + params.theta[:, None]
    new_boxes = torch.cat([center, size, yaw[..., None], boxes[..., 7:8]], dim=-1)
    new_cams = None
    if cam_to_ego is not None:
        new_cams = torch.einsum("bij,bcjk->bcik", a, cam_to_ego)
    return new_pts, new_boxes, new_cams


def augment_batch(generator: torch.Generator, points: torch.Tensor, boxes: torch.Tensor,
                  cfg: AugmentConfig, cam_to_ego: Optional[torch.Tensor] = None,
                  shard: Optional[Tuple[int, int]] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Per-sample random global transform; returns (points, boxes,
    cam_to_ego' or None). Validity masks are unaffected (the transform moves
    points, it never drops them). shard=(rank, world): the batch is rank's
    rows of a global batch `world` times its size; the draw is the global
    batch's and each row takes its global row's transform."""
    n = points.shape[0]
    if shard is None:
        params = sample_affine(generator, n, cfg, device=points.device)
    else:
        rank, world = shard
        params = sample_affine(generator, n * world, cfg)
        params = AffineParams(*(t[rank * n:(rank + 1) * n].to(points.device) for t in params))
    return apply_affine(params, points, boxes, cam_to_ego)

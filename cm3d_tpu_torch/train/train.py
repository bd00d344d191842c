"""Train step (AdamW as optax builds it) + detection decode, mirrors
`cm3d_tpu/train/train.py`.

The step covers voxelization -> detector -> losses -> adamw. PyTorch runs
eagerly, so the state is the live one: `TrainState.params` and
`.batch_stats` are the model's own parameter and buffer tensors, updated in
place; `step(state, batch)` returns the same state object and the metrics
as device scalars.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from cm3d_tpu_torch.parallel.mesh import all_reduce_sum, global_batch
from cm3d_tpu_torch.train.centerpoint import CenterPointConfig, CenterPointDetector
from cm3d_tpu_torch.train.targets import build_targets, focal_loss, reg_loss
from cm3d_tpu_torch.train.voxelize import PillarConfig, pillarize

@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]  # the model's parameters, by name
    batch_stats: Dict[str, torch.Tensor]  # the model's BatchNorm running statistics
    opt_state: Dict[str, Any]  # {"count": int, "mu": {...}, "nu": {...}}
    step: int
    # exponential moving average of params (None unless ema is enabled; the
    # deploy checkpoint saves the EMA when present)
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def tree(self) -> dict:
        """The state as a nested dict of tensors and ints (what
        `models.checkpoints.save_params` writes)."""
        return {"params": self.params, "batch_stats": self.batch_stats,
                "opt_state": self.opt_state, "step": self.step,
                "ema_params": self.ema_params}

    def load_tree(self, tree: dict) -> "TrainState":
        """Copy a saved tree into this state's tensors, in place."""
        if (tree.get("ema_params") is None) != (self.ema_params is None):
            raise ValueError("the saved state and this run disagree on EMA: one carries "
                             "ema_params and the other does not")
        _copy_tree(self.params, tree["params"], "params")
        _copy_tree(self.batch_stats, tree["batch_stats"], "batch_stats")
        for key in ("mu", "nu"):
            _copy_tree(self.opt_state[key], tree["opt_state"][key], f"opt_state.{key}")
        self.opt_state["count"] = int(tree["opt_state"]["count"])
        self.step = int(tree["step"])
        if self.ema_params is not None:
            _copy_tree(self.ema_params, tree["ema_params"], "ema_params")
        return self


@torch.no_grad()
def _copy_tree(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], what: str) -> None:
    if set(dst) != set(src):
        diff = sorted(set(dst) ^ set(src))
        raise KeyError(f"{what}: the saved tree's keys differ from the model's: {diff[:8]}")
    for name, t in dst.items():
        if tuple(t.shape) != tuple(src[name].shape):
            raise ValueError(f"{what}.{name}: saved shape {tuple(src[name].shape)} != "
                             f"{tuple(t.shape)}")
        t.copy_(src[name])


class TrainBatch(NamedTuple):
    points: Any  # [B, N, 4] ego-frame
    point_valid: Any  # [B, N]
    boxes: Any  # [B, M, 8] (x, y, z, w, l, h, yaw, class)
    box_valid: Any  # [B, M]


def _schedule(learning_rate: float, total_steps: Optional[int], schedule: str,
              warmup_steps: int) -> Callable[[int], float]:
    """lr as a function of the optimizer's update count (optax's
    warmup_cosine_decay_schedule(0, lr, warmup, total): the cosine decays
    over `total - warmup` steps to 0; "const" with a warm-up is linear
    0 -> lr over `warmup` steps, then flat)."""
    if schedule == "cosine":
        if not total_steps:
            raise ValueError("cosine schedule needs total_steps")

        def lr(count: int) -> float:
            if count < warmup_steps:
                return learning_rate * count / warmup_steps
            decay = max(total_steps - warmup_steps, 1)
            frac = min(count - warmup_steps, decay) / decay
            return learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr
    if schedule == "const":
        if warmup_steps:
            return lambda count: learning_rate * min(count, warmup_steps) / warmup_steps
        return lambda count: learning_rate
    raise ValueError(f"unknown schedule: {schedule!r}")


class Optimizer:
    """AdamW the way `optax.adamw` composes it: Adam moments with bias
    correction (b1 0.9, b2 0.999, eps 1e-8 outside the root), weight decay
    added to the update of EVERY parameter, then the learning rate of the
    update count; before it, optionally, optax's global-norm clip
    (`g * c / max(norm, c)`). Updates the parameters in place."""

    def __init__(self, lr: Callable[[int], float], weight_decay: float = 1e-4,
                 grad_clip: Optional[float] = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.weight_decay, self.grad_clip = lr, weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], opt_state: Dict[str, Any],
               params: Dict[str, torch.Tensor]) -> None:
        names = list(params)
        g = [grads[k] for k in names]
        p = [params[k] for k in names]
        mu = [opt_state["mu"][k] for k in names]
        nu = [opt_state["nu"][k] for k in names]
        if self.grad_clip:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            g = torch._foreach_mul(g, self.grad_clip / norm.clamp(min=self.grad_clip))
        count = opt_state["count"]
        t = count + 1
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, 1.0 - self.b1 ** t)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr(count))
        opt_state["count"] = t


def make_optimizer(learning_rate: float = 1e-3, total_steps: Optional[int] = None,
                   schedule: str = "const", warmup_steps: int = 0,
                   grad_clip: Optional[float] = None, weight_decay: float = 1e-4) -> Optimizer:
    """AdamW with an optional LR schedule and global-norm gradient clip, the
    standard CenterPoint-style training recipe knobs."""
    return Optimizer(_schedule(learning_rate, total_steps, schedule, warmup_steps),
                     weight_decay=weight_decay, grad_clip=grad_clip)


def model_tensors(model: nn.Module) -> Tuple[dict, dict]:
    """(params, batch_stats): `model`'s parameters and BatchNorm running
    statistics by state-dict name, its live tensors."""
    stats = {k: b for k, b in model.named_buffers() if k.endswith(("running_mean", "running_var"))}
    return dict(model.named_parameters()), stats


def state_for(model: nn.Module, tx: Optimizer, ema: bool) -> TrainState:
    """A step-0 train state over `model`'s own tensors."""
    params, stats = model_tensors(model)
    return TrainState(
        params=params, batch_stats=stats, opt_state=tx.init(params), step=0,
        ema_params={k: p.detach().clone() for k, p in params.items()} if ema else None,
    )


def init_state(seed: int, pillar_cfg: PillarConfig, model_cfg: CenterPointConfig,
               learning_rate: float = 1e-3, tx: Optional[Optimizer] = None, ema: bool = False,
               device=None) -> Tuple[TrainState, CenterPointDetector, Optimizer]:
    """A CenterPointDetector with weights drawn from a torch.Generator
    seeded with `seed` (flax's initializers; the numbers are the port's
    own), on `device`, and its step-0 state."""
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    model = CenterPointDetector(model_cfg, in_channels=pillar_cfg.num_features)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.reset_head_bias()
    model.to(device)
    tx = tx if tx is not None else make_optimizer(learning_rate)
    return state_for(model, tx, ema), model, tx


def make_train_step_impl(forward_fn, model: nn.Module, cfg: CenterPointConfig, tx: Optimizer,
                         pillar_cfg: PillarConfig, axis_name: Optional[str] = None,
                         ema_decay: float = 0.0, augment=None, aug_seed: int = 0,
                         data_parallel: bool = False):
    """Shared step constructor for every BEV detector head family (CenterPoint
    and BEVFusion-lite share targets, losses, metrics and the optimizer
    update; only the forward differs). forward_fn(pillars, batch) -> head
    maps, in train mode.

    ema_decay > 0 maintains state.ema_params (init_state(ema=True)).
    augment: an AugmentConfig; the global flip / rotate / scale / shift runs
    inside the step, drawn from a generator seeded by (aug_seed, state.step)
    so a resumed run replays its augmentation sequence exactly.

    Two collective modes over torch.distributed's default group; in both,
    every rank applies the same AdamW, EMA and clip update (the clip's norm
    taken after the reduction), so the replicas stay bit-identical:
    - data_parallel=True (`--data_parallel`, the GSPMD-jit path of JAX):
      the batch is this rank's rows of one global batch; BatchNorm's
      statistics and the loss denominators are the global batch's
      (parallel.mesh.global_batch), the augmentation draw is the global
      batch's, and the gradients and metrics are SUMMED over the ranks: the
      single-device step's numbers.
    - axis_name (JAX's pmap / shard_map form, cm3d_tpu/train/train.py:
      157-163): the loss is this rank's own; the gradients, the metrics and
      the BatchNorm running statistics are AVERAGED over the group, and the
      augmentation generator is folded with the rank. The value of
      axis_name names the mesh axis in JAX; here the default group is the
      axis."""
    import torch.distributed as dist

    if axis_name is not None and data_parallel:
        raise ValueError("axis_name and data_parallel are two collective modes; pick one")
    if axis_name is not None and not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"axis_name={axis_name!r} averages over torch.distributed's default process "
            "group, and none is initialised: call torch.distributed.init_process_group first")

    def loss_fn(batch):
        pillars = pillarize(batch.points, batch.point_valid, pillar_cfg)
        out = forward_fn(pillars, batch)
        hm_t, reg_t, reg_m = build_targets(batch.boxes, batch.box_valid, pillar_cfg,
                                           cfg.num_classes, cfg.out_stride)
        l_hm = focal_loss(out["heatmap"], hm_t)
        pred_reg = torch.cat([out["offset"], out["z"], out["size"], out["yaw"]], dim=-1)
        l_reg = reg_loss(pred_reg, reg_t, reg_m)
        loss = l_hm + 2.0 * l_reg
        return loss, {"loss": loss.detach(), "loss_heatmap": l_hm.detach(),
                      "loss_reg": l_reg.detach()}

    def step(state: TrainState, batch):
        if ema_decay and state.ema_params is None:
            raise ValueError(
                "ema_decay > 0 requires a state built with "
                "init_state(ema=True) / init_fusion_state(ema=True)"
            )
        if not ema_decay and state.ema_params is not None:
            raise ValueError(
                "state carries ema_params but ema_decay is 0: the EMA "
                "would silently freeze at its init values (the deploy "
                "checkpoint saves the EMA when present)"
            )
        collective = data_parallel or axis_name is not None
        rank, world = (dist.get_rank(), dist.get_world_size()) if collective else (0, 1)
        if augment is not None:
            from cm3d_tpu_torch.train.augment import augment_batch, step_generator

            cams = getattr(batch, "cam_to_ego", None)
            gen = step_generator(aug_seed, state.step,
                                 rank if axis_name is not None else None)
            pts, boxes, cams = augment_batch(gen, batch.points, batch.boxes, augment,
                                             cam_to_ego=cams,
                                             shard=(rank, world) if data_parallel else None)
            batch = batch._replace(points=pts, boxes=boxes)
            if cams is not None:
                batch = batch._replace(cam_to_ego=cams)
        model.train()
        names = list(state.params)
        with global_batch() if data_parallel else contextlib.nullcontext():
            loss, metrics = loss_fn(batch)
            grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        if collective:
            keys = list(metrics)
            summed = all_reduce_sum(list(grads) + [torch.stack([metrics[k] for k in keys])])
            grads, mvec = summed[:-1], summed[-1]
            if axis_name is not None:
                grads = [g / world for g in grads]
                mvec = mvec / world
                with torch.no_grad():
                    stats = list(state.batch_stats.values())
                    for t, total in zip(stats, all_reduce_sum(stats)):
                        t.copy_(total / world)
            metrics = dict(zip(keys, mvec.unbind()))
        tx.update(dict(zip(names, grads)), state.opt_state, state.params)
        if ema_decay:
            with torch.no_grad():
                ema = [state.ema_params[k] for k in names]
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [state.params[k] for k in names],
                                    alpha=1.0 - ema_decay)
        state.step += 1
        return state, metrics

    step.loss_fn = loss_fn  # (batch) -> (loss, metrics), for gradient checks
    return step


def make_train_step(model: CenterPointDetector, tx: Optimizer, pillar_cfg: PillarConfig,
                    axis_name: Optional[str] = None, ema_decay: float = 0.0, augment=None,
                    aug_seed: int = 0, data_parallel: bool = False):
    """Returns step(state, batch) -> (state, metrics); `state` must be the
    one built over `model` (its tensors are updated in place). axis_name /
    data_parallel: the collective modes of make_train_step_impl."""
    return make_train_step_impl(lambda pillars, batch: model(pillars), model, model.cfg, tx,
                                pillar_cfg, axis_name, ema_decay=ema_decay, augment=augment,
                                aug_seed=aug_seed, data_parallel=data_parallel)


def decode_detections(out: Dict[str, torch.Tensor], pillar_cfg: PillarConfig, out_stride: int,
                      top_k: int = 128):
    """Head maps [B, H', W', *] -> (boxes [B, K, 7], scores [B, K], classes
    [B, K]); single-sample [H', W', *] maps give unbatched results.

    CenterPoint decode: per-cell class max (first index on ties), global
    top-k by a stable descending sort (equal scores keep the lower cell
    index first, as jax.lax.top_k does; torch.topk promises no order among
    ties, and at init every logit is the -4.6 bias), regression readout."""
    if out["heatmap"].ndim == 3:
        res = decode_detections({k: v[None] for k, v in out.items()}, pillar_cfg, out_stride,
                                top_k)
        return tuple(t[0] for t in res)
    hm = torch.sigmoid(out["heatmap"].float())
    bsz, h, w, c = hm.shape
    flat = hm.reshape(bsz, -1, c)
    best, best_cls = flat.max(dim=2)  # first index among equal maxima
    order = torch.sort(best, dim=1, descending=True, stable=True)
    scores, idx = order.values[:, :top_k], order.indices[:, :top_k]
    classes = torch.gather(best_cls, 1, idx)
    ix = torch.div(idx, w, rounding_mode="floor").float()
    iy = (idx % w).float()
    res = pillar_cfg.resolution * out_stride

    def read(m):
        m = m.float().reshape(bsz, h * w, m.shape[-1])
        return torch.gather(m, 1, idx[..., None].expand(-1, -1, m.shape[-1]))

    off = read(out["offset"])
    z = read(out["z"])[..., 0]
    size = torch.exp(read(out["size"]))
    yaw_sc = read(out["yaw"])
    yaw = torch.atan2(yaw_sc[..., 0], yaw_sc[..., 1])
    x = (ix + 0.5 + off[..., 0]) * res + pillar_cfg.x_min
    y = (iy + 0.5 + off[..., 1]) * res + pillar_cfg.y_min
    boxes = torch.stack([x, y, z, size[..., 0], size[..., 1], size[..., 2], yaw], dim=-1)
    return boxes, scores, classes

"""BEVFusion-style camera+LiDAR detector, mirrors
`cm3d_tpu/train/bevfusion.py`.

- A camera backbone over the ring (the lite conv trunk, or Swin-T through
  the port's `SwinTransformer`, whose attention branches run the fused
  window-attention kernels on the card and differentiate through their
  recompute backward) emits per-pixel features and a depth DISTRIBUTION over
  fixed bins (lift-splat-shoot style).
- View transform: every (camera, pixel, depth-bin) triple is a 3D point
  (pinhole ray at the bin's depth, cam->ego via calib). The feature x
  depth-probability outer product splats into the pillar BEV grid by cell
  id: a stable sort by cell id, the permutation applied as one row gather
  with an exact gather backward, then `kernels.segment.segment_sum`, the
  hand-written sorted-segment kernel (forward and backward) on a CUDA
  tensor, its plain version on a CPU tensor. The batch is the kernel's rows.
- Fusion: concat [pillar BEV, camera BEV] -> the unchanged CenterPoint trunk
  + heads, so targets, losses and `decode_detections` are shared verbatim.

Intrinsics must be scaled to the input image resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.kernels.segment import segment_sum
from cm3d_tpu_torch.models.common import Conv
from cm3d_tpu_torch.models.swin import SwinConfig, SwinTransformer
from cm3d_tpu_torch.train.centerpoint import (
    BatchNorm,
    CenterPointConfig,
    CenterPointDetector,
)
from cm3d_tpu_torch.train.train import (
    Optimizer,
    TrainState,
    make_optimizer,
    make_train_step_impl,
    state_for,
)
from cm3d_tpu_torch.train.voxelize import (
    PillarConfig,
    apply_permutation,
    cell_ids,
    inverse_permutation,
)

# Swin-T, the backbone BEVFusion's camera branch trains
SWIN_T_CAMERA = SwinConfig(
    embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
    out_indices=(1, 2, 3),
)


@dataclasses.dataclass(frozen=True)
class BevFusionConfig:
    centerpoint: CenterPointConfig = CenterPointConfig()
    cam_channels: int = 32          # per-pixel feature width
    cam_trunk: Tuple[int, ...] = (16, 32, 32)  # stride-2 conv stages
    depth_bins: int = 24
    d_min: float = 1.0
    d_max: float = 45.0
    # "conv": the lite stride-2 conv trunk above (fast default).
    # "swin_t": full Swin-T, multi-scale stage outputs upsampled to the
    # shallowest out-stage's stride and concatenated (the BEVFusion
    # FPN-fusion pattern) before the same feat/depth heads.
    camera_backbone: str = "conv"
    swin: SwinConfig = SWIN_T_CAMERA
    # bf16 compute in the camera backbone (params / optimizer / losses stay
    # f32; the depth / feature heads cast back before the softmax). The one
    # reduced-precision switch of the training path.
    camera_bf16: bool = False
    # recompute Swin blocks on backward (memory for FLOPs; see
    # SwinConfig.remat). Ignored by the conv trunk (too small to matter).
    camera_remat: bool = False
    # the camera Swin's attention branches through the fused kernel wrapper
    # (the CUDA kernels on the card, differentiable via their recompute
    # backward). False selects the plain PyTorch branch for A/B and nothing
    # else.
    camera_fused: bool = True

    def effective_swin(self) -> SwinConfig:
        """The swin config with the dtype / remat / fused training knobs
        applied: ONE derivation point so CLI wiring stays booleans."""
        return dataclasses.replace(
            self.swin,
            dtype="bfloat16" if self.camera_bf16 else self.swin.dtype,
            remat=self.camera_remat or self.swin.remat,
            fused_attn=self.camera_fused,
        )

    @property
    def img_stride(self) -> int:
        if self.camera_backbone == "swin_t":
            return self.swin.patch_size * 2 ** min(self.swin.out_indices)
        return 2 ** len(self.cam_trunk)

    def bin_depths(self) -> torch.Tensor:
        """Bin-center depths, linear in metric depth."""
        step = (self.d_max - self.d_min) / self.depth_bins
        return self.d_min + (torch.arange(self.depth_bins, dtype=torch.float32) + 0.5) * step


def splat_cells(intrinsics: torch.Tensor, cam_to_ego: torch.Tensor, hf: int, wf: int,
                pillar_cfg: PillarConfig, cfg: BevFusionConfig) -> torch.Tensor:
    """The BEV cell of every (camera, pixel, depth bin): intrinsics
    [B, C, 3, 3], cam_to_ego [B, C, 4, 4] -> [B, C * hf * wf * bins] int32,
    the sink id h * w where the point leaves the grid or the z range.
    Geometry in full f32: rounding a 45 m depth bin by 0.1 m misbins 0.8 m
    cells (the training entry points call `utils.device.strict_f32()`)."""
    h, w = pillar_cfg.grid_hw
    stride = cfg.img_stride
    dev = intrinsics.device
    # pixel centers in input-image coordinates
    u = (torch.arange(wf, dtype=torch.float32, device=dev) + 0.5) * stride
    v = (torch.arange(hf, dtype=torch.float32, device=dev) + 0.5) * stride
    fx = intrinsics[..., 0, 0][..., None, None]
    fy = intrinsics[..., 1, 1][..., None, None]
    cx = intrinsics[..., 0, 2][..., None, None]
    cy = intrinsics[..., 1, 2][..., None, None]
    # unit-depth camera-frame ray per pixel: [B, C, hf, wf]
    shape = intrinsics.shape[:2] + (hf, wf)
    rx = ((u[None, :] - cx) / fx).expand(shape)
    ry = ((v[:, None] - cy) / fy).expand(shape)
    d = cfg.bin_depths().to(dev)  # [bins]
    # camera-frame point per (cam, pix, bin): x right, y down, z forward
    pts = torch.stack([rx[..., None] * d, ry[..., None] * d,
                       d.expand(shape + d.shape)], dim=-1)  # [B, C, hf, wf, bins, 3]
    rot = cam_to_ego[..., :3, :3]
    t = cam_to_ego[..., :3, 3]
    ego = torch.einsum("ncij,nchwbj->nchwbi", rot, pts) + t[:, :, None, None, None, :]
    ix, iy, in_range = cell_ids(ego[..., 0], ego[..., 1], ego[..., 2], pillar_cfg)
    cell = torch.where(in_range, ix * w + iy, h * w)  # sink = h*w
    return cell.reshape(cell.shape[0], -1)


def splat_to_bev(feats: torch.Tensor, depth_probs: torch.Tensor, intrinsics: torch.Tensor,
                 cam_to_ego: torch.Tensor, pillar_cfg: PillarConfig,
                 cfg: BevFusionConfig) -> torch.Tensor:
    """Lift-splat BEV pooling: feats [B, C, hf, wf, F] per-pixel camera
    features, depth_probs [B, C, hf, wf, bins] softmaxed, intrinsics
    [B, C, 3, 3] scaled to the INPUT image size, cam_to_ego [B, C, 4, 4] ->
    [B, H, W, F] summed camera features (unbatched [C, ...] inputs give
    [H, W, F]). Differentiable in feats and depth_probs.

    Out-of-grid / out-of-z-range points fall into the segment sink cell."""
    if feats.ndim == 4:
        return splat_to_bev(feats[None], depth_probs[None], intrinsics[None],
                            cam_to_ego[None], pillar_cfg, cfg)[0]
    bsz, _, hf, wf, f = feats.shape
    h, w = pillar_cfg.grid_hw
    n_cells = h * w  # the sink id h*w matches no column and is never summed
    with torch.no_grad():
        cell = splat_cells(intrinsics, cam_to_ego, hf, wf, pillar_cfg, cfg)
        cell_s, perm = torch.sort(cell, dim=1, stable=True)
        inv_perm = inverse_permutation(perm)
    # feature x depth-probability outer product -> [B, N, F]
    contrib = (feats[..., None, :] * depth_probs[..., None]).reshape(bsz, -1, f)
    # one row gather, then channels-major for the kernel
    vals = apply_permutation(contrib, perm, inv_perm).transpose(1, 2)
    sums = segment_sum(cell_s, vals.float(), n_cells)  # [B, F, h*w]
    return sums.transpose(1, 2).reshape(bsz, h, w, f)


def _upsample_nearest(x: torch.Tensor, f: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, f H, f W, C], each pixel repeated (jnp.repeat on
    both axes); its backward is a plain sum."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, f, w, f, c).reshape(b, h * f, w * f, c)


class CameraTrunk(nn.Module):
    """Per-image trunk -> (features [*, hf, wf, F], depth probs
    [*, hf, wf, bins]). Runs over the flattened B*C image batch so BatchNorm
    sees every ring image at once."""

    def __init__(self, cfg: BevFusionConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.camera_backbone == "swin_t":
            self.swin = SwinTransformer(cfg.effective_swin())
            width = sum(cfg.swin.stage_dim(i) for i in cfg.swin.out_indices)
        elif cfg.camera_backbone == "conv":
            dt = torch.bfloat16 if cfg.camera_bf16 else None
            cin = 3
            for i, ch in enumerate(cfg.cam_trunk):
                self.add_module(f"cam{i}", Conv(cin, ch, 3, stride=2, padding=1, bias=False,
                                                dtype=dt))
                self.add_module(f"cam{i}_bn", BatchNorm(ch))
                cin = ch
            width = cin
        else:
            raise ValueError(
                f"unknown camera_backbone {cfg.camera_backbone!r} "
                "(expected 'conv' or 'swin_t')")
        self.cam_feat = Conv(width, cfg.cam_channels, 1, padding=0)
        self.cam_depth = Conv(width, cfg.depth_bins, 1, padding=0)

    def forward(self, images: torch.Tensor):
        cfg = self.cfg
        if cfg.camera_backbone == "swin_t":
            outs = self.swin(images)
            base = min(cfg.swin.out_indices)
            bh = -(-images.shape[1] // (cfg.swin.patch_size * 2 ** base))
            bw = -(-images.shape[2] // (cfg.swin.patch_size * 2 ** base))
            ups = []
            for i in sorted(cfg.swin.out_indices):
                o = outs[f"swin{i}"]
                f = 2 ** (i - base)
                if f > 1:  # nearest upsample to the base stride, then
                    o = _upsample_nearest(o, f)
                ups.append(o[:, :bh, :bw])  # crop odd-size merge padding
            x = torch.cat(ups, dim=-1)
        else:
            x = images
            for i in range(len(cfg.cam_trunk)):
                x = F.relu(getattr(self, f"cam{i}_bn")(getattr(self, f"cam{i}")(x)))
        # heads + depth softmax stay f32 regardless of the backbone dtype
        x = x.float()
        return self.cam_feat(x), torch.softmax(self.cam_depth(x), dim=-1)


class BevFusionDetector(nn.Module):
    """Concat [pillar BEV, camera BEV] -> CenterPoint trunk + heads."""

    def __init__(self, cfg: BevFusionConfig, pillar_cfg: PillarConfig):
        super().__init__()
        self.cfg, self.pillar_cfg = cfg, pillar_cfg
        self.camera = CameraTrunk(cfg)
        self.centerpoint = CenterPointDetector(
            cfg.centerpoint, in_channels=pillar_cfg.num_features + cfg.cam_channels)

    def forward(self, pillars, images, intrinsics, cam_to_ego) -> Dict[str, torch.Tensor]:
        """pillars: [B, H, W, Fp]; images: [B, C, h, w, 3];
        intrinsics: [B, C, 3, 3]; cam_to_ego: [B, C, 4, 4]."""
        bsz, c, ih, iw, _ = images.shape
        stride = self.cfg.img_stride
        assert ih % stride == 0 and iw % stride == 0, (
            f"image_hw ({ih}, {iw}) must be divisible by the camera trunk "
            f"stride {stride}: a ceil-sized conv output walks pixel centers "
            f"past the image extent and silently misprojects the splat "
            f"against the scaled intrinsics"
        )
        feats, depth = self.camera(images.reshape(bsz * c, ih, iw, 3))
        hf, wf = feats.shape[1], feats.shape[2]
        feats = feats.reshape(bsz, c, hf, wf, -1)
        depth = depth.reshape(bsz, c, hf, wf, -1)
        cam = splat_to_bev(feats, depth, intrinsics, cam_to_ego, self.pillar_cfg, self.cfg)
        return self.centerpoint(torch.cat([pillars, cam], dim=-1))


class FusionBatch(NamedTuple):
    points: Any       # [B, N, 4] ego-frame
    point_valid: Any  # [B, N]
    boxes: Any        # [B, M, 8] (x, y, z, w, l, h, yaw, class)
    box_valid: Any    # [B, M]
    images: Any       # [B, C, h, w, 3] normalized float
    intrinsics: Any   # [B, C, 3, 3] scaled to (h, w)
    cam_to_ego: Any   # [B, C, 4, 4]


# identical fields and lifecycle; checkpoints interchange
FusionTrainState = TrainState


def init_fusion_state(seed: int, pillar_cfg: PillarConfig, cfg: BevFusionConfig,
                      image_hw: Tuple[int, int], n_cams: int = 6, learning_rate: float = 1e-3,
                      tx: Optional[Optimizer] = None, ema: bool = False, device=None):
    """Mirrors train.init_state for the fusion model. `image_hw` and
    `n_cams` shape no parameter here (the JAX package traces with them);
    they are kept so both packages' callers read the same."""
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.utils.device import resolve_device

    del image_hw, n_cams
    device = resolve_device(device)
    model = BevFusionDetector(cfg, pillar_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.centerpoint.reset_head_bias()
    model.to(device)
    tx = tx if tx is not None else make_optimizer(learning_rate)
    return state_for(model, tx, ema), model, tx


def make_fusion_train_step(model: BevFusionDetector, tx: Optimizer, pillar_cfg: PillarConfig,
                           axis_name: Optional[str] = None, ema_decay: float = 0.0,
                           augment=None, aug_seed: int = 0, data_parallel: bool = False):
    """Fusion instance of train.make_train_step_impl: voxelize + camera
    splat -> fused heads; targets / losses / optimizer are the SHARED
    step code (one copy to keep in sync)."""

    def forward_fn(pillars, batch: FusionBatch):
        return model(pillars, batch.images, batch.intrinsics, batch.cam_to_ego)

    return make_train_step_impl(forward_fn, model, model.cfg.centerpoint, tx, pillar_cfg,
                                axis_name, ema_decay=ema_decay, augment=augment,
                                aug_seed=aug_seed, data_parallel=data_parallel)

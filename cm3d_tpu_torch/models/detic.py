"""Detic open-vocabulary detector (inference path), mirrors
`cm3d_tpu/models/detic.py`.

The reference's 2D detector: Detic_LCOCOI21k_CLIP_SwinB_896b32 — a Swin-B
trunk, FPN (p3-p7), CenterNet2 class-agnostic proposal head, and a 3-stage
cascade of zero-shot box heads classifying against CLIP text embeddings
(src/nuscenes/gen_2d_masks_detic.py:30-41,90-96). Score threshold 0.1, all
classes per proposal, mask head unused (SAM provides the masks).

Batched over a leading image axis (the camera ring goes through the
backbone as one batch); shapes are static: proposals padded to
`post_nms_topk`, detections to `max_detections`. Parameter names are the
released detectron2 checkpoint's (`backbone.bottom_up.layers.0...`,
`proposal_generator.centernet_head...`, `roi_heads.box_predictor.0...`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.models.common import Conv, Dense, GroupNorm
from cm3d_tpu_torch.models.swin import SWIN_B, SWIN_TEST, SwinConfig, SwinTransformer
from cm3d_tpu_torch.ops.nms import nms_2d_classwise
from cm3d_tpu_torch.ops.roi_align import multilevel_roi_align
from cm3d_tpu_torch.utils.observability import span


@dataclasses.dataclass(frozen=True)
class DeticConfig:
    swin: SwinConfig = SWIN_B
    fpn_dim: int = 256
    # CenterNet2 proposal head
    num_head_convs: int = 4
    head_gn_groups: int = 32
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)  # p3..p7
    pre_nms_topk: int = 1000
    post_nms_topk: int = 256
    proposal_nms_thresh: float = 0.9
    # cascade ROI heads
    num_cascade_stages: int = 3
    pooler_size: int = 7
    fc_dim: int = 1024
    embed_dim: int = 512  # CLIP space
    norm_temperature: float = 50.0
    cascade_deltas: Tuple[Tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0),
        (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0),
    )
    # test-time
    score_thresh: float = 0.1  # reference :35
    nms_thresh: float = 0.5
    max_detections: int = 128
    # (proposal, class) pairs entering the final class-wise NMS (exact
    # whenever <= nms_topk pairs clear score_thresh)
    nms_topk: int = 1024
    mult_proposal_score: bool = True
    dtype: str = "float32"  # compute dtype for FPN/heads (params stay f32)


DETIC_SWINB = DeticConfig()
DETIC_TEST = DeticConfig(
    swin=SWIN_TEST,
    fpn_dim=32,
    num_head_convs=1,
    head_gn_groups=4,
    strides=(8, 16),
    pre_nms_topk=64,
    post_nms_topk=32,
    fc_dim=32,
    embed_dim=16,
    max_detections=16,
)


def top_k(x: torch.Tensor, k: int):
    """Top k along the last axis, ties lower index first (jax.lax.top_k's
    order): a stable descending sort, cut at k."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class TopBlock(nn.Module):
    """P6/P7 from the last FPN output (CenterNet2 style)."""

    def __init__(self, n_extra: int, d: int, dtype):
        super().__init__()
        for j in range(n_extra):
            self.add_module(f"p{6 + j}", Conv(d, d, 3, stride=2, padding=1, dtype=dtype))
        self.n_extra = n_extra


class Backbone(nn.Module):
    """Swin trunk (`bottom_up`) + top-down FPN + the extra levels."""

    def __init__(self, cfg: DeticConfig, dtype):
        super().__init__()
        self.bottom_up = SwinTransformer(cfg.swin)
        d = cfg.fpn_dim
        for i, si in enumerate(sorted(cfg.swin.out_indices)):
            cin = cfg.swin.stage_dim(si)
            self.add_module(f"fpn_lateral{3 + i}", Conv(cin, d, 1, dtype=dtype))
            self.add_module(f"fpn_output{3 + i}", Conv(d, d, 3, padding=1, dtype=dtype))
        self.top_block = TopBlock(len(cfg.strides) - len(cfg.swin.out_indices), d, dtype)

    def forward(self, images: torch.Tensor) -> Dict[int, torch.Tensor]:
        feats = self.bottom_up(images)
        names = sorted(feats)  # swin1 < swin2 < swin3: fine to coarse
        lat = [getattr(self, f"fpn_lateral{3 + i}")(feats[n]) for i, n in enumerate(names)]
        for i in range(len(lat) - 2, -1, -1):  # top-down: nearest 2x, cropped
            th, tw = lat[i].shape[1], lat[i].shape[2]
            up = lat[i + 1].repeat_interleave(2, 1).repeat_interleave(2, 2)
            lat[i] = lat[i] + up[:, :th, :tw]
        levels = {3 + i: getattr(self, f"fpn_output{3 + i}")(x) for i, x in enumerate(lat)}
        x = levels[3 + len(lat) - 1]
        for j in range(self.top_block.n_extra):
            x = getattr(self.top_block, f"p{6 + j}")(F.relu(x) if j > 0 else x)
            levels[3 + len(lat) + j] = x
        return levels


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))


class CenterNetHead(nn.Module):
    """Class-agnostic proposal head shared across levels."""

    def __init__(self, cfg: DeticConfig, dtype):
        super().__init__()
        d = cfg.fpn_dim

        def tower():
            mods = []
            for _ in range(cfg.num_head_convs):
                # torch nn.GroupNorm default eps=1e-5
                mods += [Conv(d, d, 3, padding=1, dtype=dtype),
                         GroupNorm(cfg.head_gn_groups, d, eps=1e-5), nn.ReLU()]
            return nn.Sequential(*mods)

        self.share_tower = tower()
        self.bbox_tower = tower()
        self.agn_hm = Conv(d, 1, 3, padding=1)
        self.bbox_pred = Conv(d, 4, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in cfg.strides)

    def forward(self, feats: Dict[int, torch.Tensor]):
        hms, regs = {}, {}
        for li, (lvl, x) in enumerate(sorted(feats.items())):
            y = self.share_tower(x)
            b = self.bbox_tower(y)
            hms[lvl] = self.agn_hm(y)[..., 0]
            regs[lvl] = F.relu(self.bbox_pred(b) * self.scales[li].scale)
        return hms, regs


def decode_proposals(hms: Dict[int, torch.Tensor], regs: Dict[int, torch.Tensor],
                     strides: Dict[int, int], cfg: DeticConfig):
    """Per-level top-k, one class-agnostic NMS over all levels, then the
    post-NMS top-k: hms {lvl: [B, H, W]}, regs {lvl: [B, H, W, 4]} ->
    (boxes [B, post_nms_topk, 4], scores [B, post_nms_topk])."""
    all_boxes, all_scores = [], []
    for lvl in sorted(hms):
        hm = torch.sigmoid(hms[lvl])
        b, h, w = hm.shape
        s = strides[lvl]
        k = min(cfg.pre_nms_topk, h * w)
        score, idx = top_k(hm.reshape(b, -1), k)
        ys = (idx // w).float() * s + s / 2
        xs = (idx % w).float() * s + s / 2
        r = torch.gather(regs[lvl].reshape(b, -1, 4), 1, idx[..., None].expand(b, k, 4)) * s
        all_boxes.append(torch.stack(
            [xs - r[..., 0], ys - r[..., 1], xs + r[..., 2], ys + r[..., 3]], dim=-1))
        all_scores.append(score)
    boxes = torch.cat(all_boxes, dim=1)
    scores = torch.cat(all_scores, dim=1)
    keep = nms_2d_classwise(boxes, scores, torch.zeros_like(scores, dtype=torch.int64),
                            scores > 0, cfg.proposal_nms_thresh)
    top_s, top_i = top_k(torch.where(keep, scores, 0.0), cfg.post_nms_topk)
    return torch.gather(boxes, 1, top_i[..., None].expand(*top_i.shape, 4)), top_s


class BoxHead(nn.Module):
    def __init__(self, cfg: DeticConfig, dtype):
        super().__init__()
        self.fc1 = Dense(cfg.pooler_size ** 2 * cfg.fpn_dim, cfg.fc_dim, dtype=dtype)
        self.fc2 = Dense(cfg.fc_dim, cfg.fc_dim, dtype=dtype)

    def forward(self, pooled):
        x = pooled.reshape(*pooled.shape[:-3], -1)  # (y, x, c) flatten order
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class ZeroShotClassifier(nn.Module):
    def __init__(self, cfg: DeticConfig):
        super().__init__()
        self.linear = Dense(cfg.fc_dim, cfg.embed_dim)
        self.cls_bias = nn.Parameter(torch.zeros(1))
        self.temperature = cfg.norm_temperature

    def forward(self, x, classifier):
        emb = self.linear(x)
        emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)
        return torch.sigmoid(self.temperature * (emb @ classifier) + self.cls_bias)


class BoxPredictor(nn.Module):
    def __init__(self, cfg: DeticConfig):
        super().__init__()
        self.cls_score = ZeroShotClassifier(cfg)
        self.bbox_pred = nn.Sequential(Dense(cfg.fc_dim, cfg.fc_dim), nn.ReLU(),
                                       Dense(cfg.fc_dim, 4))


class RoiHeads(nn.Module):
    def __init__(self, cfg: DeticConfig, dtype):
        super().__init__()
        self.box_head = nn.ModuleList(BoxHead(cfg, dtype)
                                      for _ in range(cfg.num_cascade_stages))
        self.box_predictor = nn.ModuleList(BoxPredictor(cfg)
                                           for _ in range(cfg.num_cascade_stages))

    def stage(self, i: int, pooled, classifier):
        """One cascade stage: pooled [B, R, s, s, C] -> (scores [B, R, K]
        sigmoid, deltas [B, R, 4])."""
        x = self.box_head[i](pooled)
        pred = self.box_predictor[i]
        return pred.cls_score(x, classifier), pred.bbox_pred(x)


class ProposalGenerator(nn.Module):
    def __init__(self, cfg: DeticConfig, dtype):
        super().__init__()
        self.centernet_head = CenterNetHead(cfg, dtype)


def apply_deltas(boxes: torch.Tensor, deltas: torch.Tensor, weights) -> torch.Tensor:
    """detectron2 Box2BoxTransform.apply_deltas (class-agnostic), over
    [..., 4]."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights
    dx, dy = deltas[..., 0] / wx, deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=4.135)  # log(1000/16) like detectron2
    dh = torch.clamp(deltas[..., 3] / wh, max=4.135)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


class DeticDetections(NamedTuple):
    boxes: torch.Tensor  # [B, D, 4] xyxy in input-image coords
    scores: torch.Tensor  # [B, D]
    classes: torch.Tensor  # [B, D] int64
    valid: torch.Tensor  # [B, D] bool


def select_detections(boxes: torch.Tensor, scores: torch.Tensor,
                      cfg: DeticConfig) -> DeticDetections:
    """detectron2 fast_rcnn_inference order: threshold -> class-wise NMS
    over ALL surviving (proposal, class) pairs -> truncate to
    max_detections. boxes [B, R, 4], scores [B, R, K]."""
    b, r, k = scores.shape
    flat = scores.reshape(b, r * k)
    valid = flat > cfg.score_thresh
    cand_s, cand_i = top_k(torch.where(valid, flat, -1.0), min(cfg.nms_topk, r * k))
    cand_boxes = torch.gather(boxes, 1, (cand_i // k)[..., None].expand(*cand_i.shape, 4))
    cand_classes = cand_i % k
    cand_valid = cand_s > cfg.score_thresh
    keep = nms_2d_classwise(cand_boxes, cand_s, cand_classes, cand_valid, cfg.nms_thresh)
    top_s, top_i = top_k(torch.where(keep & cand_valid, cand_s, -1.0), cfg.max_detections)
    return DeticDetections(
        torch.gather(cand_boxes, 1, top_i[..., None].expand(*top_i.shape, 4)), top_s,
        torch.gather(cand_classes, 1, top_i), top_s > cfg.score_thresh,
    )


class Detic(nn.Module):
    def __init__(self, cfg: DeticConfig = DETIC_SWINB):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.backbone = Backbone(cfg, dtype)
        self.proposal_generator = ProposalGenerator(cfg, dtype)
        self.roi_heads = RoiHeads(cfg, dtype)

    def forward(self, images: torch.Tensor, classifier: torch.Tensor,
                true_hw: Optional[torch.Tensor] = None) -> DeticDetections:
        """images: [B, H, W, 3] normalized; classifier: [embed_dim, K] CLIP
        text embeddings (normalized columns). true_hw: optional [B, 2]
        (h, w) of the real image content before the /32 padding, the
        extent boxes are clipped to (detectron2 clips to the recorded
        image size). Returns padded detections per image."""
        cfg = self.cfg
        with span("cm3d.detic.backbone"):
            levels = self.backbone(images)
        strides = {lvl: s for lvl, s in zip(sorted(levels), cfg.strides)}
        with span("cm3d.detic.proposals"):
            hms, regs = self.proposal_generator.centernet_head(levels)
            boxes, prop_scores = decode_proposals(hms, regs, strides, cfg)
        with span("cm3d.detic.cascade"):
            if true_hw is None:
                hw = torch.tensor(images.shape[1:3], dtype=torch.float32, device=images.device)
                true_hw = hw.expand(images.shape[0], 2)
            h_img = true_hw[:, 0].float()[:, None]
            w_img = true_hw[:, 1].float()[:, None]
            lo = torch.zeros((), device=boxes.device)
            stage_scores = []
            for i in range(cfg.num_cascade_stages):
                pooled = multilevel_roi_align(levels, boxes, strides, cfg.pooler_size,
                                              min(strides), max(strides))
                scores, deltas = self.roi_heads.stage(i, pooled, classifier)
                stage_scores.append(scores)
                boxes = apply_deltas(boxes, deltas, cfg.cascade_deltas[i])
                boxes = torch.stack([
                    torch.minimum(torch.maximum(boxes[..., 0], lo), w_img),
                    torch.minimum(torch.maximum(boxes[..., 1], lo), h_img),
                    torch.minimum(torch.maximum(boxes[..., 2], lo), w_img),
                    torch.minimum(torch.maximum(boxes[..., 3], lo), h_img),
                ], dim=-1)
            scores = torch.stack(stage_scores).mean(0)  # [B, R, K]
            if cfg.mult_proposal_score:
                # geometric mean (Detic/CenterNet2 DeticCascadeROIHeads):
                # ((s * ps) ** 0.5), not s * sqrt(ps)
                scores = torch.sqrt(scores * torch.clamp(prop_scores, min=0.0)[..., None])
            return select_detections(boxes, scores, cfg)


def quantize_detic_state_dict(sd: dict) -> dict:
    """Float Detic state dict -> the one Detic with `swin.quant_int8=True`
    loads: the MLPs of the Swin trunk (`backbone.bottom_up.`) go int8
    (`models.swin.quantize_swin_state_dict`); FPN, proposal head and the
    cascade heads stay float. The counterpart of `quantize_detic_params`."""
    from cm3d_tpu_torch.models.swin import quantize_swin_state_dict

    return quantize_swin_state_dict(sd, "backbone.bottom_up.")


# Detic's configs set INPUT.FORMAT: RGB with ImageNet-order statistics; the
# network always sees RGB (see cm3d_tpu/models/detic.py).
DETIC_PIXEL_MEAN = np.array([123.675, 116.280, 103.530], np.float32)  # RGB
DETIC_PIXEL_STD = np.array([58.395, 57.120, 57.375], np.float32)


def preprocess_rgb(img_rgb_uint8: np.ndarray, size_divisibility: int = 32) -> np.ndarray:
    """Normalize an RGB uint8 image and zero-pad it to the divisibility
    boundary."""
    x = (img_rgb_uint8.astype(np.float32) - DETIC_PIXEL_MEAN) / DETIC_PIXEL_STD
    h, w = x.shape[:2]
    ph = -(-h // size_divisibility) * size_divisibility
    pw = -(-w // size_divisibility) * size_divisibility
    out = np.zeros((ph, pw, 3), np.float32)
    out[:h, :w] = x
    return out

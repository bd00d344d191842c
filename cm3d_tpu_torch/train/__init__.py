"""Pseudo-label pretraining: a CenterPoint-style LiDAR detector and the
BEVFusion-lite camera+LiDAR detector, mirrors `cm3d_tpu/train/`.

Pillar voxelization and the lift-splat pooling reduce through the
hand-written sorted-segment kernels (`kernels/segment.py`); a conv BEV
backbone with center-heatmap heads, penalty-reduced focal + L1 losses, and
an eager AdamW train step.
"""

from cm3d_tpu_torch.train.augment import AugmentConfig
from cm3d_tpu_torch.train.centerpoint import CenterPointConfig, CenterPointDetector
from cm3d_tpu_torch.train.targets import build_targets
from cm3d_tpu_torch.train.train import (
    TrainState,
    decode_detections,
    make_optimizer,
    make_train_step,
)
from cm3d_tpu_torch.train.voxelize import PillarConfig, pillarize

__all__ = [
    "pillarize",
    "PillarConfig",
    "CenterPointConfig",
    "CenterPointDetector",
    "build_targets",
    "TrainState",
    "make_optimizer",
    "make_train_step",
    "decode_detections",
    "AugmentConfig",
]

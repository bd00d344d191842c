"""CenterPoint-style BEV detector (compact trunk, center heads), mirrors
`cm3d_tpu/train/centerpoint.py`.

Heads follow CenterPoint: a per-class center heatmap (sigmoid focal) and
dense regression maps: sub-pillar offset (2), z (1), log sizes (3), yaw
(sin, cos). Feature maps are [B, H, W, C] in and out, as everywhere in the
port; parameter names are the JAX module's (`trunk0_a.conv`, `trunk0_a.bn`,
`heatmap_conv`, `heatmap_out`, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.models.common import Conv

HEADS = (("heatmap", None), ("offset", 2), ("z", 1), ("size", 3), ("yaw", 2))


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    num_classes: int = 10
    trunk_channels: Tuple[int, ...] = (64, 128, 128)
    head_channels: int = 64
    out_stride: int = 2  # heatmap stride relative to the pillar grid

    def __post_init__(self):
        # Only trunk block 0 strides, so the network can realize at most
        # stride 2, but build_targets and decode_detections trust this
        # value as-is (a mismatch misprojects every decoded box).
        if self.out_stride not in (1, 2):
            raise ValueError(
                "out_stride must be 1 or 2 (the trunk downsamples at most "
                f"once); got {self.out_stride}"
            )


class BatchNorm(nn.Module):
    """Batch normalisation over [B, H, W, C] maps with flax's running
    statistics: `running = 0.99 * running + 0.01 * batch`, the batch
    variance the BIASED one (torch.nn.BatchNorm2d folds the unbiased
    variance in), eps 1e-5. Computes in f32 and returns f32.

    Inside `parallel.mesh.global_batch()` (the data-parallel train step) the
    training-mode statistics are those of the global batch, as GSPMD
    computes them in JAX: the sum over every rank's rows gives the mean,
    then the sum of squared deviations the variance, each through an
    all-reduce that autograd differentiates (its backward all-reduces the
    gradient, as torch.distributed.nn.functional.all_reduce's does). The same statistics update the running ones."""

    def __init__(self, ch: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from cm3d_tpu_torch.parallel.mesh import in_global_batch

        x = x.float()
        if self.training and in_global_batch():
            y, mean, var = _global_batch_norm(x, self.weight, self.bias, self.eps)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
            return y
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 1, 2), unbiased=False)
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
            y = F.batch_norm(x.permute(0, 3, 1, 2), None, None, self.weight, self.bias,
                             True, 0.0, self.eps)
        else:
            y = F.batch_norm(x.permute(0, 3, 1, 2), self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
        return y.permute(0, 2, 3, 1)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the default group, differentiable: each rank's input
    reaches every rank's output, so the gradient is the sum of every rank's
    output gradient."""

    @staticmethod
    def forward(ctx, t):
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def _global_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """y, and the global batch mean and biased variance (detached), of
    [B, H, W, C] rows spread over the default group (every rank holds as
    many rows). Two passes: E[x^2] - E[x]^2 would cancel."""
    import torch.distributed as dist

    n = x.shape[0] * x.shape[1] * x.shape[2] * dist.get_world_size()
    mean = _AllReduceSum.apply(x.sum(dim=(0, 1, 2))) / n
    d = x - mean
    var = _AllReduceSum.apply((d * d).sum(dim=(0, 1, 2))) / n
    y = d * torch.rsqrt(var + eps) * weight + bias
    return y, mean.detach(), var.detach()


class ConvBlock(nn.Module):
    """3x3 conv (no bias, padding 1) -> BatchNorm -> ReLU."""

    def __init__(self, cin: int, ch: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(cin, ch, 3, stride=stride, padding=1, bias=False, dtype=dtype)
        self.bn = BatchNorm(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class CenterPointDetector(nn.Module):
    def __init__(self, cfg: CenterPointConfig = CenterPointConfig(), in_channels: int = 6):
        super().__init__()
        self.cfg = cfg
        cin = in_channels
        for i, ch in enumerate(cfg.trunk_channels):
            stride = 2 if (i == 0 and cfg.out_stride > 1) else 1
            self.add_module(f"trunk{i}_a", ConvBlock(cin, ch, stride))
            self.add_module(f"trunk{i}_b", ConvBlock(ch, ch, 1))
            cin = ch
        for name, ch_out in HEADS:
            self.add_module(f"{name}_conv", Conv(cin, cfg.head_channels, 3, padding=1))
            self.add_module(f"{name}_out", Conv(cfg.head_channels,
                                                ch_out or cfg.num_classes, 1, padding=0))
        self.reset_head_bias()

    @torch.no_grad()
    def reset_head_bias(self) -> None:
        """-4.6 heatmap bias: sigmoid ~ 0.01 at init (CenterNet convention)."""
        self.heatmap_out.bias.fill_(-4.6)

    def forward(self, pillars: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pillars: [B, H, W, F] -> dict of dense head maps at H/stride.
        Train or eval mode (batch or running statistics) is the module's."""
        x = pillars
        for i in range(len(self.cfg.trunk_channels)):
            x = getattr(self, f"trunk{i}_a")(x)
            x = getattr(self, f"trunk{i}_b")(x)
        return {
            name: getattr(self, f"{name}_out")(F.relu(getattr(self, f"{name}_conv")(x)))
            for name, _ in HEADS
        }

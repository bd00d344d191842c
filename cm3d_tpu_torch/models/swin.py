"""Swin Transformer backbone (Detic's Swin-B trunk), mirrors
`cm3d_tpu/models/swin.py`.

Published Swin-v1 semantics: shifted-window attention with a relative
position bias, cyclic-shift border masks, patch merging; returns the stage
feature maps the detector's FPN consumes. Every block's attention branch
(norm1 -> window attention -> proj) goes through
`kernels.window_attn.window_attn`: the hand-written CUDA kernels on a CUDA
tensor, the plain PyTorch version on a CPU tensor (the JAX package's
`fused_mode` "on" / "interpret"). Parameter names are the released Swin
checkpoint's (`layers.{i}.blocks.{j}.attn.qkv.weight`, ...). With
`SwinConfig(quant_int8=True)` the blocks' MLPs (fc1 / fc2) are int8 w8a8
(`models.common.QuantLinear`; load transform `quantize_swin_state_dict`);
qkv / proj stay float, so the quantized model still runs the fused
window-attention kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cm3d_tpu_torch.kernels.window_attn import window_attn, window_attn_plain
from cm3d_tpu_torch.models.common import Conv, Dense, LayerNorm, linear


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)  # strides 8, 16, 32
    dtype: str = "float32"  # compute dtype (params stay f32)
    # True: every block's attention branch goes through the fused kernel
    # wrapper (the CUDA kernels on the card). False: the plain PyTorch
    # branch on every device, for A/B runs. Same parameters either way.
    fused_attn: bool = True
    # Recompute each block on the backward pass (torch.utils.checkpoint)
    # instead of holding its activations: memory for FLOPs when TRAINING the
    # backbone. No effect without grad. Same parameters either way.
    remat: bool = False
    # int8 w8a8 MLPs (fc1 / fc2, dynamic activation scales): the MLPs sit
    # outside the window-attention kernels, which keep their float qkv /
    # proj, so this composes with fused_attn. Load transform:
    # quantize_swin_state_dict. An opt-in documented deviation.
    quant_int8: bool = False

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * (2 ** i)


SWIN_B = SwinConfig()
SWIN_TEST = SwinConfig(
    embed_dim=16, depths=(2, 2), num_heads=(2, 4), window_size=4,
    out_indices=(0, 1),
)


def block_window(h: int, w: int, window: int, shift: int) -> Tuple[int, int]:
    """(window, shift) a block uses on an h x w map: Swin shrinks the
    window for small maps and drops the shift when the window covers the
    map's short side."""
    win = min(window, max(h, w))
    sh = shift if win < min(h, w) else 0
    if min(h, w) <= window:
        win, sh = min(h, w), 0
    return win, sh


def shrunk_table(table: torch.Tensor, window: int, win: int) -> torch.Tensor:
    """The [(2 win - 1)^2, heads] bias table of a window shrunk to `win`:
    the relative offsets it spans, read from the centre of the
    [(2 window - 1)^2, heads] table the block holds. (The JAX package
    creates a parameter of the shrunk size instead.)"""
    if win == window:
        return table
    side, lo = 2 * window - 1, window - win
    t = table.reshape(side, side, -1)[lo:lo + 2 * win - 1, lo:lo + 2 * win - 1]
    return t.reshape(-1, table.shape[-1])


class WindowAttention(nn.Module):
    """Parameter holder of a block's attention (qkv, proj, the
    relative-position-bias table)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, quant: bool = False):
        super().__init__()
        self.fc1 = linear(dim, hidden, dtype=dtype, quant=quant)
        self.fc2 = linear(hidden, dim, dtype=dtype, quant=quant)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 dtype: torch.dtype, fused_attn: bool = True, quant: bool = False):
        super().__init__()
        self.heads, self.window, self.shift, self.dtype = heads, window, shift, dtype
        self.fused_attn = fused_attn
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C]."""
        win, shift = block_window(x.shape[1], x.shape[2], self.window, self.shift)
        a = self.attn
        branch = window_attn if self.fused_attn else window_attn_plain
        x = x + branch(
            x, self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, shrunk_table(a.relative_position_bias_table,
                                                     self.window, win),
            heads=self.heads, window=win, shift=shift, dtype=self.dtype,
        )
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, dtype):
        super().__init__()
        self.proj = Conv(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size, dtype=dtype)
        self.norm = LayerNorm(cfg.embed_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


class SwinLayer(nn.Module):
    def __init__(self, cfg: SwinConfig, i: int, dtype):
        super().__init__()
        dim = cfg.stage_dim(i)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i], cfg.window_size,
                      0 if j % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio, dtype,
                      cfg.fused_attn, cfg.quant_int8)
            for j in range(cfg.depths[i])
        )
        self.downsample = PatchMerging(dim, dtype) if i < len(cfg.depths) - 1 else None


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig = SWIN_B):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.patch_embed = PatchEmbed(cfg, dtype)
        self.layers = nn.ModuleList(SwinLayer(cfg, i, dtype) for i in range(len(cfg.depths)))
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", LayerNorm(cfg.stage_dim(i), eps=1e-5))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, H, W, 3] -> {"swin{i}": [B, H/stride, W/stride, C_i]}."""
        x = self.patch_embed(x)
        outs: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                if self.cfg.remat and torch.is_grad_enabled():
                    x = checkpoint(blk, x, use_reentrant=False)
                else:
                    x = blk(x)
            if i in self.cfg.out_indices:
                outs[f"swin{i}"] = getattr(self, f"norm{i}")(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


def quantize_swin_state_dict(sd: dict, prefix: str = "") -> dict:
    """Float Swin state dict (keys under `prefix`) -> the one
    `SwinConfig(quant_int8=True)` loads: every block's mlp.fc1 / mlp.fc2
    becomes QuantLinear buffers; attention, norms, patch embed and merges
    are the same tensors. The counterpart of `quantize_swin_params`; `sd`
    is not changed."""
    from cm3d_tpu_torch.ops.quant import quantize_linear_state

    out = dict(sd)
    for key in sd:
        if key.startswith(f"{prefix}layers.") and key.endswith(".mlp.fc1.weight"):
            blk = key[:-len(".fc1.weight")]
            for name in ("fc1", "fc2"):
                quantize_linear_state(out, f"{blk}.{name}")
    return out

"""Shared building blocks of the 2D-stage models (mirrors
`cm3d_tpu/models/common.py`).

Feature maps stay [B, H, W, C] at every module boundary, as in the JAX
package; convolutions permute to NCHW inside. Parameters are f32 and carry
the released torch checkpoints' names. Compute dtypes follow the JAX
modules: a `Dense` / `Conv` built with `dtype` casts its input and
weights to it (flax `nn.Dense(dtype=...)`); one built without computes in
f32 (flax promotes the input with the f32 params); the norms compute in
f32 and return f32 (flax `nn.LayerNorm` with f32 params).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.utils.observability import span


def _compute_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    return torch.float32 if dtype is None else dtype


class Dense(nn.Linear):
    """nn.Linear computing in `dtype` (None = f32)."""

    def __init__(self, din: int, dout: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(din, dout, bias=bias)
        self.compute_dtype = _compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class QuantLinear(nn.Module):
    """`Dense` drop-in with int8 weights and int8 activations (w8a8,
    `ops/quant.py`): the counterpart of the JAX package's `QuantDense`.

    Buffers: weight_q int8 [out, in], weight_scale f32 [out], bias f32
    [out], and act_scale f32 [] when `static` (calibrated per-tensor
    activation scale; else per-token dynamic scales). They come from a float
    state dict through `ops.quant.quantize_linear_state` at load time. The
    input is quantized as it arrives (not cast to `dtype` first, as flax's
    QuantDense does); the output is in `dtype` (None = f32).

    Calibration: inside `record_act_absmax` the module keeps a running max
    of |input| (`act_absmax`), and runs the dynamic product whatever
    `static` says (the JAX package's dynamic twin); outside, recording
    costs nothing."""

    def __init__(self, din: int, dout: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, static: bool = False):
        super().__init__()
        self.in_features, self.out_features = din, dout
        self.compute_dtype = _compute_dtype(dtype)
        self.static = static
        self.register_buffer("weight_q", torch.zeros(dout, din, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(dout))
        self.register_buffer("bias", torch.zeros(dout) if bias else None)
        if static:
            self.register_buffer("act_scale", torch.ones(()))
        self.act_absmax: Optional[torch.Tensor] = None  # set by record_act_absmax

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from cm3d_tpu_torch.ops.quant import dynamic_int8_matmul, static_int8_matmul

        with span("cm3d.quant.linear"):
            if self.act_absmax is not None:
                self.act_absmax = torch.maximum(self.act_absmax, x.float().abs().amax())
                return dynamic_int8_matmul(x, self.weight_q, self.weight_scale, self.bias,
                                           out_dtype=self.compute_dtype)
            if self.static:
                return static_int8_matmul(x, self.weight_q, self.weight_scale, self.act_scale,
                                          self.bias, out_dtype=self.compute_dtype)
            return dynamic_int8_matmul(x, self.weight_q, self.weight_scale, self.bias,
                                       out_dtype=self.compute_dtype)


@contextlib.contextmanager
def record_act_absmax(model: nn.Module):
    """Calibration record of every QuantLinear of `model`: inside the
    block each one runs its dynamic product and keeps max |input| over all
    calls; the yielded dict fills, at the block's end, with {module name:
    absmax tensor} (the input of `ops.quant.bake_act_scales`)."""
    mods = {n: m for n, m in model.named_modules() if isinstance(m, QuantLinear)}
    for m in mods.values():
        m.act_absmax = torch.zeros((), device=m.weight_scale.device)
    record: Dict[str, torch.Tensor] = {}
    try:
        yield record
        record.update({n: m.act_absmax for n, m in mods.items()})
    finally:
        for m in mods.values():
            m.act_absmax = None


def calibrate_act_scales_(model: nn.Module, run, margin: float = 1.0, reduce=None) -> None:
    """Calibrate a static int8 `model` in place: `run()` (its forwards over
    the calibration data) under `record_act_absmax`, where every QuantLinear
    runs the dynamic product and records its input absmax, then each
    `act_scale` buffer baked from the record (`ops.quant.bake_act_scales`).
    `reduce(record)` (the camera-parallel mask stage's max over its ranks)
    turns the record into the one baked, in place."""
    from cm3d_tpu_torch.ops.quant import bake_act_scales

    with torch.inference_mode(), record_act_absmax(model) as absmax:
        run()
    if reduce is not None:
        reduce(absmax)
    model.load_state_dict(bake_act_scales(model.state_dict(), absmax, margin))


def linear(din: int, dout: int, bias: bool = True, dtype: Optional[torch.dtype] = None,
           quant=False) -> nn.Module:
    """A `Dense`, or with `quant` a QuantLinear (True: dynamic activation
    scales, "static": calibrated ones), as the JAX modules' quant= picks."""
    if quant:
        return QuantLinear(din, dout, bias=bias, dtype=dtype, static=quant == "static")
    return Dense(din, dout, bias=bias, dtype=dtype)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """nn.Conv2d over [B, H, W, C] maps, computing in `dtype` (None = f32).
    padding="same" is flax's SAME (low side gets the smaller half)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="same", bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=0 if padding == "same" else padding, bias=bias)
        self.same = padding == "same"
        self.compute_dtype = _compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        if self.same:
            (k, _), (s, _) = self.kernel_size, self.stride
            t, bo = _same_pads(x.shape[2], k, s)
            le, r = _same_pads(x.shape[3], k, s)
            if t or bo or le or r:
                x = F.pad(x, (le, r, t, bo))
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x, self.weight.to(dt), b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, computed in f32, returning f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over [B, H, W, C] maps, computed in f32, returning f32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups, self.weight,
                         self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


class LayerNorm2d(nn.Module):
    """Channel-wise LayerNorm over [B, H, W, C] maps (SAM's neck norm):
    two-pass variance in f32, eps 1e-6, returns f32."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class MLPBlock(nn.Module):
    """lin1 -> exact GELU (or ReLU) -> lin2, in `dtype`; int8 layers with
    `quant` (False | True | "static", see `linear`)."""

    def __init__(self, dim: int, mlp_dim: int, out_dim: int, act: str = "gelu",
                 dtype: Optional[torch.dtype] = None, quant=False):
        super().__init__()
        self.lin1 = linear(dim, mlp_dim, dtype=dtype, quant=quant)
        self.lin2 = linear(mlp_dim, out_dim, dtype=dtype, quant=quant)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.lin1(x)
        x = F.gelu(x) if self.act == "gelu" else F.relu(x)
        return self.lin2(x)


def window_partition(x: torch.Tensor, window: int):
    """[B, H, W, C] -> ([B*nW, win, win, C], (Hp, Wp)) with bottom/right
    zero padding."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    """Inverse of window_partition (crops the padding)."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


@torch.no_grad()
def cast_compute_weights_(model: nn.Module) -> nn.Module:
    """Store each Dense / Conv / ConvTranspose weight and bias in the
    module's compute dtype, in place. They are cast to it at every forward
    anyway, so the numbers do not change; a bf16 model then reads bf16
    weights instead of casting its f32 ones at every call."""
    for mod in model.modules():
        dt = getattr(mod, "compute_dtype", torch.float32)
        if dt != torch.float32:
            for p in mod.parameters(recurse=False):
                p.data = p.data.to(dt)
    return model


# parameters drawn from normal(0, std) by `init_weights`; every other
# non-norm, non-bias parameter that is not a Dense / Conv weight starts at
# its constructor's value (zeros or ones, as flax's initializers)
NORMAL_INIT_STD = {
    "relative_position_bias_table": 0.02,
    "positional_encoding_gaussian_matrix": 1.0,
}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from `generator`, with flax's initializers:
    Dense / Conv / ConvTranspose kernels lecun-normal (normal truncated at
    2 sigma, variance 1/fan_in), biases zero, embeddings normal(1), the
    tables of NORMAL_INIT_STD normal(std)."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device, dtype=t.dtype) * std)

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = w.shape[1] if isinstance(mod, nn.Linear) else w[0].numel()
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0)
        for name, p in mod.named_parameters(recurse=False):
            if name in NORMAL_INIT_STD:
                normal_(p, NORMAL_INIT_STD[name])
    return model

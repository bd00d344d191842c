"""int8 w8a8 matrix products for the 2D-stage encoders. Mirrors
`cm3d_tpu/ops/quant.py`.

Scheme (per-channel weights, per-token dynamic or calibrated static
activations, symmetric):
  - weights:     int8 per OUTPUT channel, scale = amax(|w|, over in) / 127,
                 computed once at load time (`quantize_linear_state`);
  - activations: int8 per token (row), scale = amax(|x|, last axis) / 127
                 (dynamic), or one calibrated per-tensor scale (static,
                 `bake_act_scales`), beyond which activations clip to +-127;
  - the product runs s8 x s8 -> s32 (`torch._int_mm`: cuBLASLt's int8 GEMM
    on the card), dequantized by (row scale x column scale) in f32.

The arithmetic is the JAX package's, step for step, so the two agree bit for
bit: x is cast to f32 before the amax, the weight scale reduces over the
INPUT axis (a Linear weight is [out, in], a flax kernel [in, out]), rounding
is half to even in both, and the dequantize runs in the order
`acc.float() * x_scale * w_scale + bias`, then casts. The int32 sum is exact
(K * 127^2 < 2^31 up to K = 133,000). The weights stay [out, in] as
`nn.Linear` keeps them; the product reads `w_q.t()`, a column-major
[in, out] view.

On a CUDA tensor the product is `torch._int_mm` or an error: `int_mm` pads
the rows up to what cuBLASLt's int8 path takes and raises on a K or N it
refuses; nothing runs a float product in its place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

EPS = 1e-12
# cuBLASLt's int8 GEMM (torch._int_mm on CUDA): more than 16 rows, K and N
# multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def _div127(t: torch.Tensor) -> torch.Tensor:
    """t / 127 as an IEEE division on every device. PyTorch's CUDA divide
    rewrites a division by a Python number as a multiplication by its
    reciprocal, which can differ in the last bit; a divisor tensor on the
    same device keeps the true division, as the CPU and JAX compute it."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_weight(w: torch.Tensor):
    """Symmetric per-output-channel int8 quantization of a Linear weight
    [out, in]. Returns (w_q int8 [out, in], scale f32 [out]) with
    w ~= w_q * scale[:, None]."""
    w = w.float()
    scale = _div127(torch.clamp(w.abs().amax(dim=1), min=EPS))
    return torch.round(w / scale[:, None]).to(torch.int8), scale


def int_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q int8 [M, K] @ w_q.t() (w_q int8 [N, K]) -> int32 [M, N], exact.
    On the card, fewer than 17 rows are padded with zero rows (sliced off
    after); a K or N that is no multiple of 8 raises."""
    if x_q.device.type == "cuda":
        m, k = x_q.shape
        n = w_q.shape[0]
        if k % INT_MM_ALIGN or n % INT_MM_ALIGN:
            raise ValueError(f"int8 product [{m}, {k}] x [{k}, {n}]: cuBLASLt's int8 GEMM "
                             f"needs K and N multiples of {INT_MM_ALIGN}")
        if m < INT_MM_MIN_ROWS:
            pad = x_q.new_zeros(INT_MM_MIN_ROWS - m, k)
            return torch._int_mm(torch.cat([x_q, pad]), w_q.t())[:m]
    return torch._int_mm(x_q, w_q.t())


def _product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    lead = x_q.shape[:-1]
    acc = int_mm(x_q.reshape(-1, x_q.shape[-1]).contiguous(), w_q)
    return acc.reshape(*lead, w_q.shape[0])


def _dequantize(acc, x_scale, w_scale, bias, out_dtype):
    y = acc.float() * x_scale * w_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def dynamic_int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ dequant(w_q).t() with per-row dynamic int8 activations.

    x: float [..., in]; w_q: int8 [out, in]; w_scale: f32 [out]. The result
    is cast to out_dtype (default: x.dtype)."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    x_scale = _div127(torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=EPS))
    # |xf / x_scale| <= 127 by construction: no clipping needed
    x_q = torch.round(xf / x_scale).to(torch.int8)
    return _dequantize(_product(x_q, w_q), x_scale, w_scale, bias, out_dtype)


def static_int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                       act_scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ dequant(w_q).t() with a CALIBRATED per-tensor activation scale
    (`bake_act_scales`); activations beyond it clip to +-127."""
    out_dtype = out_dtype or x.dtype
    s = torch.clamp(act_scale.float(), min=EPS)
    x_q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return _dequantize(_product(x_q, w_q), s, w_scale, bias, out_dtype)


# ---------------------------------------------------------------------------
# State dicts
# ---------------------------------------------------------------------------

def quantize_linear_state(sd: Dict[str, torch.Tensor], prefix: str) -> None:
    """In `sd`, replace the Linear `{prefix}.weight` by the QuantLinear
    buffers `{prefix}.weight_q` (int8 [out, in]) and `{prefix}.weight_scale`
    (f32 [out]); `{prefix}.bias` stays. The counterpart of
    `quantize_dense_params`: checkpoints stay float, quantization is a load
    transform."""
    w_q, scale = quantize_weight(sd.pop(f"{prefix}.weight"))
    sd[f"{prefix}.weight_q"] = w_q
    sd[f"{prefix}.weight_scale"] = scale


def is_quantized_state_dict(sd: Dict[str, torch.Tensor]) -> bool:
    """True if the state dict holds QuantLinear buffers (a `weight_q` key):
    it went through a quantize_* transform, or was saved that way."""
    return any(k.endswith(".weight_q") for k in sd)


def reconcile_quantization(sd: Dict[str, torch.Tensor], transform: Callable,
                           want: bool, name: str) -> Dict[str, torch.Tensor]:
    """Bring a loaded state dict in line with the quant_int8 setting.

    want=True: a float state dict is transformed, a quantized one passes
    through (no double quantization). want=False: a float state dict passes
    through, a quantized one raises (the float module cannot load it)."""
    have = is_quantized_state_dict(sd)
    if want:
        return sd if have else transform(sd)
    if have:
        raise ValueError(f"{name} checkpoint is int8-quantized (weight_q entries present)"
                         " — pass --quant_int8, or convert a float checkpoint")
    return sd


def with_act_scale_placeholders(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`sd` with an `act_scale` of 1 beside every `weight_q` that has none:
    what a static model loads before its calibration writes the scales
    (`models.common.calibrate_act_scales_`). `sd` is not changed."""
    return {**{f"{k[:-len('weight_q')]}act_scale": torch.ones(())
               for k in sd if k.endswith(".weight_q")}, **sd}


def bake_act_scales(sd: Dict[str, torch.Tensor], absmax: Dict[str, torch.Tensor],
                    margin: float = 1.0) -> Dict[str, torch.Tensor]:
    """A new state dict with `{name}.act_scale = max(absmax * margin, eps) /
    127` for every module `name` of `absmax` (the record of
    `models.common.record_act_absmax`, made over calibration runs with the
    dynamic product). margin > 1 adds clipping headroom. `sd` is not changed."""
    out = dict(sd)
    for name, amax in absmax.items():
        a = float(amax)
        out[f"{name}.act_scale"] = torch.tensor(max(a * margin, EPS) / 127.0,
                                                dtype=torch.float32)
    return out

"""Tensor and sequence sharding of the 2D models over a mesh's `model`
axis. Mirrors `cm3d_tpu/parallel/sharding.py`.

The 2D stage (SAM ViT-H / Detic Swin-B) fits one card, so data (camera)
parallelism is the default; when one keyframe's latency matters the blocks
shard Megatron-style over a small `model` axis: column-parallel qkv / fc1,
row-parallel proj / fc2. JAX annotates the parameters and lets XLA insert
the collectives; here each rank holds only its shard and the row-parallel
layers make the all-reduce themselves (`shard_model_params`). The
sequence-sharded SAM encode (`make_sequence_sharded_encode`) splits the
token grid's rows over the axis instead, with its halos written out.

Both run on every rank of a started mesh group (`parallel/mesh.py`), each
rank building the same module: inside an SPMD program
(`DataParallelGroup.spmd`).
"""

from __future__ import annotations

import re
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.models.common import Dense, QuantLinear
from cm3d_tpu_torch.ops.quant import EPS, _dequantize, _div127, _product
from cm3d_tpu_torch.parallel.mesh import AxisGroup, Mesh, axis_group

# JAX's _RULES (`cm3d_tpu/parallel/sharding.py:25-29`) over the port's
# state-dict names: the released checkpoints' (`attn.qkv`, `mlp.fc1`,
# `mlp.lin1`, CLIP's `attn.in_proj_weight` and `mlp.c_fc` / `mlp.c_proj`
# for JAX's `in_proj` / `mlp_fc` / `mlp_proj`). A spec names the mesh axis
# each dim splits over; weights are [out, in], so a column-parallel layer
# splits dim 0 (and its bias and per-out-channel int8 scale), a row-parallel
# one dim 1 (its bias and scale replicate).
_COLUMN = r"(attn\.qkv|attn\.in_proj|mlp\.c_fc|fc1|lin1)"
_ROW = r"(attn\.proj|out_proj|mlp\.c_proj|fc2|lin2)"
_RULES = [
    (_COLUMN + r"(\.weight|\.weight_q|_weight)$", ("model", None)),
    (_COLUMN + r"(\.bias|\.weight_scale|_bias)$", ("model",)),
    (_ROW + r"\.weight(_q)?$", (None, "model")),
]
# column-parallel layers whose out rows are (q | k | v) x heads x head_dim:
# split by heads
_HEADS = re.compile(r"attn\.(qkv|in_proj)$")


def param_spec(name: str, ndim: int) -> Tuple:
    """The spec of state-dict entry `name` of rank `ndim`: () replicated."""
    for pattern, spec in _RULES:
        if re.search(pattern, name):
            # the full spec must fit the tensor's rank (JAX's guard)
            if len(spec) <= ndim:
                return spec
    return ()


def spec_tree(module_or_state_dict) -> dict:
    """{state-dict name: spec} of a module or a state dict."""
    sd = (module_or_state_dict.state_dict() if isinstance(module_or_state_dict, nn.Module)
          else module_or_state_dict)
    return {k: param_spec(k, v.ndim) for k, v in sd.items()}


# --- the parallel layers ---------------------------------------------------------

def _all_reduce(t: torch.Tensor, ax: AxisGroup, op=None) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=ax.group)
    return t


def _on_meta(make):
    with torch.device("meta"):
        return make()


def _keep(t: torch.Tensor, like) -> torch.Tensor:
    """`t` as a Parameter if `like` is one (its requires_grad kept)."""
    t = t.contiguous().clone()
    if isinstance(like, nn.Parameter):
        return nn.Parameter(t, requires_grad=like.requires_grad)
    return t


def _column_layer(layer: nn.Module, rows: torch.Tensor) -> nn.Module:
    """The layer's own class holding output rows `rows` only: the input
    stays whole, so nothing is communicated (an int8 layer's per-token
    scales come from the whole, replicated input, as unsharded)."""
    n_out, bias = len(rows), layer.bias is not None
    if isinstance(layer, QuantLinear):
        new = _on_meta(lambda: QuantLinear(layer.in_features, n_out, bias,
                                           static=layer.static))
        new.compute_dtype = layer.compute_dtype
        new.weight_q = layer.weight_q[rows].clone()
        new.weight_scale = layer.weight_scale[rows].clone()
        if layer.static:
            new.act_scale = layer.act_scale.clone()
    else:
        if isinstance(layer, Dense):
            new = _on_meta(lambda: Dense(layer.in_features, n_out, bias))
            new.compute_dtype = layer.compute_dtype
        else:
            new = _on_meta(lambda: nn.Linear(layer.in_features, n_out, bias))
        new.weight = _keep(layer.weight[rows], layer.weight)
    if bias:
        new.bias = _keep(layer.bias[rows], layer.bias)
    return new


class RowParallelLinear(nn.Module):
    """A float row-parallel layer (Dense or nn.Linear): the weight's input
    columns lo ... hi - 1 of `in_features`. An input with all the features
    (a replicated one, as SAM's decoder `out_proj` gets) is sliced to them.
    The partial products are summed over the axis (all-reduce); the bias
    rides in the partial of the axis's first rank, so it is added once and,
    with one rank, the layer computes what the plain one does, bit for bit."""

    def __init__(self, layer: nn.Module, lo: int, hi: int, ax: AxisGroup):
        super().__init__()
        self.in_features, self.lo, self.hi, self.ax = layer.in_features, lo, hi, ax
        self.compute_dtype = getattr(layer, "compute_dtype", None)
        self.weight = _keep(layer.weight[:, lo:hi], layer.weight)
        self.bias = layer.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] == self.in_features != self.hi - self.lo:
            x = x[..., self.lo:self.hi]
        dt = self.compute_dtype or self.weight.dtype
        b = self.bias.to(dt) if self.bias is not None and self.ax.index == 0 else None
        return _all_reduce(F.linear(x.to(dt), self.weight.to(dt), b), self.ax)


class RowParallelQuantLinear(QuantLinear):
    """An int8 row-parallel layer: weight_q's input columns lo ... hi - 1;
    weight_scale, bias and act_scale whole. Its input is sharded on
    features, so the dynamic per-token absmax takes an all-reduce(MAX)
    over the axis before quantizing (the static path uses its baked
    act_scale), and the int32 partial products are summed over the
    axis before the dequantize multiply: the same integers, scales and
    order as the unsharded `ops.quant` products. A calibration record
    keeps the axis's max."""

    def __init__(self, layer: QuantLinear, lo: int, hi: int, ax: AxisGroup):
        nn.Module.__init__(self)
        self.in_features, self.out_features = layer.in_features, layer.out_features
        self.compute_dtype, self.static = layer.compute_dtype, layer.static
        self.lo, self.hi, self.ax = lo, hi, ax
        self.register_buffer("weight_q", layer.weight_q[:, lo:hi].contiguous().clone())
        self.register_buffer("weight_scale", layer.weight_scale)
        self.register_buffer("bias", layer.bias)
        if layer.static:
            self.register_buffer("act_scale", layer.act_scale)
        self.act_absmax = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if x.shape[-1] == self.in_features != self.hi - self.lo:
            x = x[..., self.lo:self.hi]
        xf = x.float()
        recording = self.act_absmax is not None
        if recording:
            amax = _all_reduce(xf.abs().amax(), self.ax, dist.ReduceOp.MAX)
            self.act_absmax = torch.maximum(self.act_absmax, amax)
        if self.static and not recording:
            x_scale = torch.clamp(self.act_scale.float(), min=EPS)
            x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
        else:
            amax = _all_reduce(xf.abs().amax(dim=-1, keepdim=True), self.ax,
                               dist.ReduceOp.MAX)
            x_scale = _div127(torch.clamp(amax, min=EPS))
            x_q = torch.round(xf / x_scale).to(torch.int8)
        acc = _all_reduce(_product(x_q, self.weight_q), self.ax)
        return _dequantize(acc, x_scale, self.weight_scale, self.bias, self.compute_dtype)



def _whole_attention(module: nn.Module) -> list:
    """Prefixes of the attention layers that stay whole: those of the blocks
    that hand their qkv / proj / table to a kernel launcher (every Swin
    block: B3, `kernels/window_attn.py`; SAM's fused windowed blocks: B4,
    `kernels/window_attn_relpos.py`). The launchers take the [3C, C] qkv and
    the per-head table, so each model rank launches the kernel on the whole
    attention, as XLA's partitioner leaves a pallas_call whole."""
    from cm3d_tpu_torch.models.sam import Block as SamBlock
    from cm3d_tpu_torch.models.swin import SwinBlock

    return [f"{name}.attn." for name, m in module.named_modules()
            if isinstance(m, SwinBlock) or (isinstance(m, SamBlock) and m.fused)]


def _head_rows(n_rows: int, heads: int, index: int, size: int) -> torch.Tensor:
    """The rows of a [3 (q | k | v) x heads x head_dim, ...] weight that
    belong to heads index*heads/size ... (index+1)*heads/size - 1."""
    if heads % size:
        raise ValueError(f"{heads} heads do not split over a model axis of {size}")
    hd, local = n_rows // (3 * heads), heads // size
    per_part = torch.arange(index * local * hd, (index + 1) * local * hd)
    return torch.cat([per_part + p * heads * hd for p in range(3)])


@torch.no_grad()
def shard_model_params(module: nn.Module, mesh: Mesh, axis: str = "model") -> nn.Module:
    """This rank's shard of `module`, in place (and returned): every layer
    the rules match becomes a column- or row-parallel layer holding only
    its slice, cut from the full weights the module holds (so the
    converters carry weights as for the plain module). Call it on every
    rank of the mesh group with the same module.

    A qkv (and CLIP's fused in_proj) splits by heads: each rank keeps the
    q, k and v rows of its heads / n heads and its attention runs those
    heads (JAX's contiguous split of the [in, 3C] kernel would give rank 0
    all of q). The attention of the blocks that launch a kernel stays whole
    (`_whole_attention`); their MLPs shard."""
    ax = axis_group(axis)
    if mesh.shape.get(axis) != ax.size:
        raise ValueError(f"mesh {mesh.shape} does not match the running group's "
                         f"{axis!r} axis of {ax.size}")
    whole = _whole_attention(module)
    for name, layer in list(module.named_modules()):
        if any(name.startswith(w) for w in whole):
            continue
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        if isinstance(layer, (nn.Linear, QuantLinear)):
            quant = isinstance(layer, QuantLinear)
            spec = param_spec(f"{name}.weight_q" if quant else f"{name}.weight", 2)
            if spec == ("model", None):
                n_out = layer.out_features
                if _HEADS.search(name):
                    rows = _head_rows(n_out, parent.heads, ax.index, ax.size)
                    parent.heads //= ax.size
                else:
                    rows = torch.arange(ax.index * n_out // ax.size,
                                        (ax.index + 1) * n_out // ax.size)
                setattr(parent, child, _column_layer(layer, rows))
            elif spec == (None, "model"):
                lo = ax.index * layer.in_features // ax.size
                hi = (ax.index + 1) * layer.in_features // ax.size
                cls = RowParallelQuantLinear if quant else RowParallelLinear
                setattr(parent, child, cls(layer, lo, hi, ax))
        elif isinstance(getattr(layer, "in_proj_weight", None), nn.Parameter) and \
                param_spec(f"{name}.in_proj_weight", 2) == ("model", None):
            rows = _head_rows(layer.in_proj_weight.shape[0], layer.heads, ax.index, ax.size)
            layer.in_proj_weight = _keep(layer.in_proj_weight[rows], layer.in_proj_weight)
            layer.in_proj_bias = _keep(layer.in_proj_bias[rows], layer.in_proj_bias)
            layer.heads //= ax.size
    return module


# --- the sequence-sharded SAM encode -----------------------------------------------

def _all_gather_rows(x: torch.Tensor, ax: AxisGroup, dim: int = 1) -> torch.Tensor:
    """Every rank's rows (the same count on each) of a map, in rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def make_sequence_sharded_encode(mesh: Mesh, sam, axis: str = "model"):
    """Sequence parallelism for the SAM image encoder: the rows of the
    image, and with them the rows of the token grid, split over `axis` in
    contiguous blocks; the parameters replicate. Returns encode(image
    [S, S, 3]) -> the [S/16, S/16, C] embedding on the axis's first rank
    (this rank's rows elsewhere). Every rank of the axis calls it with the
    same image.

    JAX lets GSPMD insert the halos; here they are written out:
    - the 16x16 stride-16 patch embedding needs no halo;
    - a windowed block needs every row of each window that touches the
      rank's rows (ViT-H pads 64 rows to 70, so windows of 14 straddle the
      rank boundary at 2 and 4 ranks): the rank all-gathers the block's
      input, runs the block on those windows' rows and keeps its own (a
      fused block launches its kernel on them);
    - a global block takes its own rows' queries against all-gathered keys
      and values (the relative positions offset by the rank's first row);
    - LayerNorm, the MLP, the neck's 1x1 conv and its LayerNorm2d are
      local; the neck's 3x3 conv takes a one-row halo (zeros at the map's
      edges, as its padding).
    int8 per-token scales reduce over the feature axis, which stays whole,
    so they are local."""
    enc = sam.image_encoder
    patch = sam.cfg.patch_size
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no {axis!r} axis: {mesh.shape}")

    @torch.inference_mode()
    def encode(image: torch.Tensor) -> torch.Tensor:
        ax = axis_group(axis)
        gh, gw = image.shape[0] // patch, image.shape[1] // patch
        if gh % ax.size:
            raise ValueError(f"a {gh}-row token grid does not split over {ax.size} ranks")
        rows = gh // ax.size
        r0 = ax.index * rows
        x = enc.patch_embed(image[None, r0 * patch:(r0 + rows) * patch])
        x = x + enc.pos_embed[:, r0:r0 + rows, :gw]

        def gather_kv(k, v):  # [1, rows * gw, heads, hd] each
            return _all_gather_rows(k, ax), _all_gather_rows(v, ax)

        for blk in enc.blocks:
            if blk.window:
                w = blk.window
                lo, hi = r0 // w * w, min(-(-(r0 + rows) // w) * w, gh)
                ext = _all_gather_rows(x, ax)[:, lo:hi]
                x = blk(ext)[:, r0 - lo:r0 - lo + rows]
            else:
                shortcut = x
                x = shortcut + blk.attn(blk.norm1(x), gather_kv=gather_kv, row0=r0)
                x = x + blk.mlp(blk.norm2(x))
        conv1, ln1, conv2, ln2 = enc.neck
        x = ln1(conv1(x))
        full = _all_gather_rows(x, ax)
        halo = F.pad(full, (0, 0, 0, 0, 1, 1))[:, r0:r0 + rows + 2]  # zero rows at the edges
        dt = conv2.compute_dtype
        x = F.conv2d(halo.to(dt).permute(0, 3, 1, 2), conv2.weight.to(dt), None,
                     conv2.stride, (0, 1)).permute(0, 2, 3, 1)
        x = ln2(x)[0]
        full = _all_gather_rows(x, ax, dim=0)
        return full if ax.index == 0 else x

    return encode

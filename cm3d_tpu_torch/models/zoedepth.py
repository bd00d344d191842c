"""ZoeDepth metric monocular depth (MiDaS DPT-BEiT-L core + metric-bins
head). Mirrors `cm3d_tpu/models/zoedepth.py`.

The reference keeps ZoeDepth as an alternative depth source: the hub load
is commented out (src/nuscenes/gen_2d_masks_detic.py:117), `predict_depth`
(:121-124) wraps `model.infer_pil`, and the `use_zoedepth` branch (:408-451)
multiplies the predicted depth by each SAM mask and stores those masked
depth images in place of the mask artifacts (`pipelines/masks.py`).

Architecture (Bhat et al. 2023, isl-org/ZoeDepth; MiDaS 3.1 DPT core):
- BEiT-Large/16 backbone (24 blocks, dim 1024, 16 heads; no absolute
  position embedding; per-block relative position bias with the 3 cls-token
  entries; LayerScale gamma_1 / gamma_2; q / v bias only);
- DPT neck: 4 hooked blocks -> "project" readout (cls token concat + linear
  + GELU) -> 1x1 projection -> resample (x4 and x2 transposed convs,
  identity, stride-2 conv) -> 3x3 `layer_rn` convs -> RefineNet fusion
  blocks -> output head = relative depth;
- metric-bins head: seed bin regressor, 4 attractor layers refining the bin
  centres up the decoder scales, and a conditional log-binomial over the
  bins; depth = sum(probs * bin centres).

The modules carry the released ZoeD_N checkpoint's parameter names
(`core.core.pretrained.model.blocks.{i}.attn.qkv.weight`, ...), so a
released state dict loads as it is, but for `zoedepth_state_dict_from_released`'s
two changes: each block's relative-position table is interpolated when the
checkpoint's grid differs from the config's, and refinenet4's resConfUnit1
(built by torch but never run) is left out. Plain PyTorch in f32, as the
JAX default; every resize is align-corners bilinear (`F.interpolate`). The
same documented deviations as the JAX module: inference at the static
config resolution, and the single metric-bins head of ZoeD_N.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.models.common import Conv, LayerNorm


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    img_hw: Tuple[int, int] = (384, 512)  # network input (H, W)
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    hooks: Tuple[int, int, int, int] = (5, 11, 17, 23)
    dpt_dims: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    scratch_dim: int = 256
    head_dim1: int = 128  # output_conv1 channels
    head_dim2: int = 32  # output_conv2 feature channels (the Zoe tap)
    n_bins: int = 64
    bin_embedding_dim: int = 128
    n_attractors: Tuple[int, int, int, int] = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: float = 2.0
    min_depth: float = 1e-3
    max_depth: float = 10.0
    dtype: str = "float32"

    @property
    def grid_hw(self) -> Tuple[int, int]:
        return (self.img_hw[0] // self.patch_size, self.img_hw[1] // self.patch_size)


ZOE_N = ZoeDepthConfig()
ZOE_TEST = ZoeDepthConfig(
    img_hw=(64, 96), embed_dim=32, depth=4, num_heads=2,
    hooks=(0, 1, 2, 3), dpt_dims=(8, 12, 16, 16), scratch_dim=16,
    head_dim1=8, head_dim2=8, n_bins=8, bin_embedding_dim=8,
    n_attractors=(4, 2, 2, 1),
)

# ImageNet normalization (torchvision transforms in ZoeDepth's pipeline)
ZOE_PIXEL_MEAN = (0.485, 0.456, 0.406)
ZOE_PIXEL_STD = (0.229, 0.224, 0.225)


def resize_bilinear_ac(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] align-corners bilinear resize (torch's
    `F.interpolate(..., align_corners=True)`, as everywhere in
    ZoeDepth / MiDaS)."""
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def beit_rel_pos_index(gh: int, gw: int) -> np.ndarray:
    """BEiT relative-position index over [1 + gh*gw]^2 tokens (cls first):
    token-token entries index a (2gh-1)(2gw-1) table, the last 3 entries are
    cls->token, token->cls, cls->cls (timm's convention)."""
    n = gh * gw
    coords = np.stack(np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += gh - 1
    rel[:, :, 1] += gw - 1
    rel[:, :, 0] *= 2 * gw - 1
    num = (2 * gh - 1) * (2 * gw - 1)
    idx = np.zeros((n + 1, n + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num  # cls -> token
    idx[0:, 0] = num + 1  # token -> cls
    idx[0, 0] = num + 2  # cls -> cls
    return idx


# ---------------------------------------------------------------------------
# BEiT backbone
# ---------------------------------------------------------------------------

class BeitAttention(nn.Module):
    """qkv without bias + separate q / v biases, relative position bias."""

    def __init__(self, dim: int, heads: int, grid_hw: Tuple[int, int]):
        super().__init__()
        gh, gw = grid_hw
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * gh - 1) * (2 * gw - 1) + 3, heads))
        # torch.tensor, not from_numpy: built under torch.device("cuda") the
        # index lies on the card, not copied there by every forward
        self.register_buffer("relative_position_index",
                             torch.tensor(beit_rel_pos_index(gh, gw)), persistent=False)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape
        hd = dim // self.heads
        q, k, v = F.linear(x, self.qkv.weight).chunk(3, dim=-1)
        q, v = q + self.q_bias, v + self.v_bias

        def split(t):
            return t.reshape(b, n, self.heads, hd).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index]  # [n, n, heads]
        attn = torch.softmax((attn + bias.permute(2, 0, 1)[None]).float(), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, dim))


class BeitMlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class BeitBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, grid_hw):
        super().__init__()
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.gamma_2 = nn.Parameter(torch.ones(dim))
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = BeitAttention(dim, heads, grid_hw)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = BeitMlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.proj = Conv(3, cfg.embed_dim, cfg.patch_size, stride=cfg.patch_size)

    def forward(self, x):
        return self.proj(x)


class Beit(nn.Module):
    """BEiT-L trunk returning the token features at the 4 DPT hook depths."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            BeitBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, cfg.grid_hw)
            for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        b, gh, gw, d = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, d), x.reshape(b, gh * gw, d)], dim=1)
        feats = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.cfg.hooks:
                feats.append(x)
        return feats


# ---------------------------------------------------------------------------
# DPT neck + fusion decoder (MiDaS 3.1)
# ---------------------------------------------------------------------------

class Readout(nn.Module):
    """DPT "project" readout: concat the cls token onto every patch token,
    linear back to dim, GELU."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        cls, patches = tokens[:, :1], tokens[:, 1:]
        return self.project(torch.cat([patches, cls.expand_as(patches)], dim=-1))


class ConvTranspose(nn.ConvTranspose2d):
    """k x k, stride k transposed conv over [B, H, W, C] maps."""

    def __init__(self, c: int, k: int):
        super().__init__(c, c, k, stride=k)

    def forward(self, x):
        return F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                                  stride=self.stride).permute(0, 2, 3, 1)


class ResidualConvUnit(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = Conv(dim, dim, 3, padding=1)
        self.conv2 = Conv(dim, dim, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FusionBlock(nn.Module):
    """MiDaS FeatureFusionBlock_custom (align-corners x2 upsample)."""

    def __init__(self, dim: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(dim)
        self.resConfUnit2 = ResidualConvUnit(dim)
        self.out_conv = Conv(dim, dim, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = resize_bilinear_ac(x, (x.shape[1] * 2, x.shape[2] * 2))
        return self.out_conv(x)


class Pretrained(nn.Module):
    """The BEiT trunk (`model`) and its four readout / reassemble branches
    (`act_postprocess{1..4}`: 0 readout, 3 the 1x1 projection, 4 the
    resample, at the released Sequential's indices)."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.model = Beit(cfg)
        d = cfg.embed_dim
        for i, dd in enumerate(cfg.dpt_dims):
            branch = {"0": Readout(d), "3": Conv(d, dd, 1)}
            if i == 0:
                branch["4"] = ConvTranspose(dd, 4)
            elif i == 1:
                branch["4"] = ConvTranspose(dd, 2)
            elif i == 3:
                branch["4"] = Conv(dd, dd, 3, stride=2, padding=1)
            self.add_module(f"act_postprocess{i + 1}", nn.ModuleDict(branch))


class Scratch(nn.Module):
    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        s = cfg.scratch_dim
        for i, dd in enumerate(cfg.dpt_dims):
            self.add_module(f"layer{i + 1}_rn", Conv(dd, s, 3, padding=1, bias=False))
        for i in (1, 2, 3, 4):
            # refinenet4 has no lateral skip (torch builds its resConfUnit1
            # and never runs it)
            self.add_module(f"refinenet{i}", FusionBlock(s, skip=i != 4))
        # the released head is one Sequential: 0 conv -> head_dim1,
        # 1 interpolate, 2 conv -> head_dim2, 3 ReLU (the Zoe tap), 4 conv
        # -> 1, 5 ReLU
        self.output_conv = nn.ModuleDict({
            "0": Conv(s, cfg.head_dim1, 3, padding=1),
            "2": Conv(cfg.head_dim1, cfg.head_dim2, 3, padding=1),
            "4": Conv(cfg.head_dim2, 1, 1),
        })


class MidasCore(nn.Module):
    """BEiT-DPT relative-depth core; returns the Zoe taps (rel_depth
    [B, H, W], out32 [B, H, W, head_dim2], l4_rn, r4, r3, r2, r1)."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.cfg = cfg
        self.pretrained = Pretrained(cfg)
        self.scratch = Scratch(cfg)

    def forward(self, x):
        cfg = self.cfg
        b = x.shape[0]
        gh, gw = cfg.grid_hw
        pre, sc = self.pretrained, self.scratch
        maps = []
        for i, tokens in enumerate(pre.model(x)):
            branch = getattr(pre, f"act_postprocess{i + 1}")
            y = branch["0"](tokens).reshape(b, gh, gw, cfg.embed_dim)
            y = branch["3"](y)
            if "4" in branch:
                y = branch["4"](y)
            maps.append(getattr(sc, f"layer{i + 1}_rn")(y))
        l1, l2, l3, l4 = maps
        r4 = sc.refinenet4(l4)[:, :l3.shape[1], :l3.shape[2]]
        r3 = sc.refinenet3(r4, l3)[:, :l2.shape[1], :l2.shape[2]]
        r2 = sc.refinenet2(r3, l2)[:, :l1.shape[1], :l1.shape[2]]
        r1 = sc.refinenet1(r2, l1)
        y = sc.output_conv["0"](r1)
        y = resize_bilinear_ac(y, (y.shape[1] * 2, y.shape[2] * 2))
        out32 = F.relu(sc.output_conv["2"](y))
        rel_depth = F.relu(sc.output_conv["4"](out32))[..., 0].float()
        return rel_depth, out32, l4, r4, r3, r2, r1


class _CoreWrapper(nn.Module):
    """`core.core`: the released MidasCore sits one module deeper."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.core = MidasCore(cfg)


# ---------------------------------------------------------------------------
# Metric-bins head
# ---------------------------------------------------------------------------

class ConvMLP(nn.Module):
    """1x1 conv -> ReLU -> 1x1 conv: Zoe's small heads, whose two convs sit
    at the released indices 0 and 2 of a Sequential named `attr` (`_net`,
    or `mlp` in the conditional log-binomial)."""

    def __init__(self, cin: int, hidden: int, out: int, attr: str = "_net"):
        super().__init__()
        self.attr = attr
        self.add_module(attr, nn.ModuleDict({"0": Conv(cin, hidden, 1),
                                             "2": Conv(hidden, out, 1)}))

    def forward(self, x):
        layers = getattr(self, self.attr)
        return layers["2"](F.relu(layers["0"](x)))


class ZoeDepth(nn.Module):
    """Full metric-depth model: [B, H, W, 3] normalized image at cfg.img_hw
    -> (depth [B, H, W] meters, rel_depth [B, H, W])."""

    def __init__(self, cfg: ZoeDepthConfig = ZOE_N):
        super().__init__()
        self.cfg = cfg
        s, e = cfg.scratch_dim, cfg.bin_embedding_dim
        self.core = _CoreWrapper(cfg)
        self.conv2 = Conv(s, s, 1)
        self.seed_bin_regressor = ConvMLP(s, s, cfg.n_bins)
        # torch Projector / Attractor default mlp_dim=128 == bin_embedding_dim
        self.seed_projector = ConvMLP(s, e, e)
        self.projectors = nn.ModuleList(ConvMLP(s, e, e) for _ in range(4))
        self.attractors = nn.ModuleList(ConvMLP(e, e, cfg.n_attractors[i])
                                        for i in range(4))
        cin = cfg.head_dim2 + 1 + e
        self.conditional_log_binomial = ConvMLP(cin, cin // 2, 4, attr="mlp")

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        rel_depth, out32, l4_rn, r4, r3, r2, r1 = self.core.core(x)
        btl = self.conv2(l4_rn)
        b_prev = F.softplus(self.seed_bin_regressor(btl))  # [B, h, w, n_bins]
        prev_emb = self.seed_projector(btl)
        b_emb = prev_emb
        for i, xb in enumerate((r4, r3, r2, r1)):
            hw = (xb.shape[1], xb.shape[2])
            b_emb = self.projectors[i](xb)
            # attractor layer (unnormed, inverse attractor, mean reduction)
            attr = F.softplus(self.attractors[i](b_emb + resize_bilinear_ac(prev_emb, hw)))
            b_prev = resize_bilinear_ac(b_prev, hw)
            dx = attr[..., :, None] - b_prev[..., None, :]  # [B, h, w, nA, n_bins]
            delta = dx / (1.0 + cfg.attractor_alpha * dx.abs() ** cfg.attractor_gamma)
            b_prev = b_prev + delta.mean(dim=-2)
            prev_emb = b_emb

        # conditional log-binomial over the bins at full resolution
        hw_out = (out32.shape[1], out32.shape[2])
        last = torch.cat([out32.float(), rel_depth[..., None]], dim=-1)
        cond = resize_bilinear_ac(b_emb.float(), hw_out)
        pt = F.softplus(self.conditional_log_binomial(torch.cat([last, cond], dim=-1))) + 1e-4
        p = pt[..., 0] / (pt[..., 0] + pt[..., 1])  # [B, H, W] in (0, 1)
        t = pt[..., 2] / (pt[..., 2] + pt[..., 3])
        n = cfg.n_bins
        k = torch.arange(n, dtype=torch.float32, device=x.device)
        nf = torch.tensor(float(n), device=x.device)
        log_coef = torch.lgamma(nf) - torch.lgamma(k + 1.0) - torch.lgamma(nf - k)
        logp = torch.log(torch.clamp(p, 1e-8, 1 - 1e-8))
        log1p = torch.log(torch.clamp(1 - p, 1e-8, 1 - 1e-8))
        log_binom = log_coef + k * logp[..., None] + (n - 1 - k) * log1p[..., None]
        probs = torch.softmax(log_binom / t[..., None], dim=-1)
        centers = resize_bilinear_ac(b_prev, hw_out)  # [B, H, W, n_bins]
        depth = torch.clamp((probs * centers).sum(-1), cfg.min_depth, cfg.max_depth)
        return depth, rel_depth


# ---------------------------------------------------------------------------
# Inference wrapper (the reference's predict_depth contract)
# ---------------------------------------------------------------------------

def preprocess_zoe(image_u8: np.ndarray, img_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 RGB [H, W, 3] -> normalized f32 at the network resolution."""
    from PIL import Image

    im = Image.fromarray(image_u8).resize((img_hw[1], img_hw[0]), Image.BILINEAR)
    x = np.asarray(im, np.float32) / 255.0
    return (x - np.asarray(ZOE_PIXEL_MEAN, np.float32)) / np.asarray(ZOE_PIXEL_STD, np.float32)


def make_predict_depth(model: ZoeDepth, flip_aug: bool = True):
    """predict_depth(image_u8) -> metric depth [H, W] f32 at the INPUT
    resolution (reference gen_2d_masks_detic.py:121-124, infer_pil), on the
    model's device. Flip averaging mirrors DepthModel.infer's with_flip_aug
    default. `predict_depth.dispatch` is the asynchronous half: it queues the
    work and returns the device tensor (the mask stage copies it to the
    host on its finisher thread)."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def dispatch(image_u8: np.ndarray) -> torch.Tensor:
        h, w = image_u8.shape[:2]
        x = torch.as_tensor(preprocess_zoe(image_u8, model.cfg.img_hw), device=device)[None]
        d, _ = model(x)
        if flip_aug:
            d_f, _ = model(x.flip(2))
            d = 0.5 * (d + d_f.flip(2))
        return resize_bilinear_ac(d[..., None], (h, w))[0, ..., 0]

    def predict_depth(image_u8: np.ndarray) -> np.ndarray:
        return dispatch(image_u8).cpu().numpy().astype(np.float32)

    predict_depth.dispatch = dispatch
    return predict_depth


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

_BACKBONE = "core.core.pretrained.model"


def interp_rel_table(table: torch.Tensor, num_rel: int) -> torch.Tensor:
    """Resize a BEiT relative-position-bias table (minus its 3 cls rows) to
    `num_rel` entries by linear interpolation (checkpoint grid != config
    grid, e.g. a square 384 training grid against 384x512 inference)."""
    if table.shape[0] == num_rel:
        return table
    t = table.numpy()
    body, cls_rows = t[:-3], t[-3:]
    pos = np.linspace(0, body.shape[0] - 1, num_rel - 3)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, body.shape[0] - 1)
    frac = (pos - lo)[:, None].astype(t.dtype)
    return torch.from_numpy(np.concatenate([body[lo] * (1 - frac) + body[hi] * frac, cls_rows]))


def zoedepth_state_dict_from_released(sd: Dict[str, torch.Tensor],
                                      cfg: ZoeDepthConfig = ZOE_N) -> Dict[str, torch.Tensor]:
    """The released ZoeD_N state dict (isl-org/ZoeDepth torch hub layout) ->
    the port's ZoeDepth keys: the same keys, each block's relative-position
    table interpolated to the config's grid, refinenet4's never-run
    resConfUnit1 dropped. Keys the port does not read (timm's
    relative_position_index buffers, ...) stay, for the loader to report.
    The counterpart of `convert_zoedepth_params`."""
    gh, gw = cfg.grid_hw
    num_rel = (2 * gh - 1) * (2 * gw - 1) + 3
    out = {k: v for k, v in sd.items()
           if not k.startswith("core.core.scratch.refinenet4.resConfUnit1.")}
    for i in range(cfg.depth):
        key = f"{_BACKBONE}.blocks.{i}.attn.relative_position_bias_table"
        if key in out:
            out[key] = interp_rel_table(out[key], num_rel)
    return out


def _conv_from_flax(out, key, p):
    out[f"{key}.weight"] = torch.from_numpy(
        np.array(np.transpose(np.asarray(p["kernel"], np.float32), (3, 2, 0, 1))))
    if "bias" in p:
        out[f"{key}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))


def _dense_from_flax(out, key, p):
    out[f"{key}.weight"] = torch.from_numpy(np.array(np.asarray(p["kernel"], np.float32).T))
    out[f"{key}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))


def zoedepth_state_dict_from_flax(params: dict, cfg: ZoeDepthConfig = ZOE_N) -> dict:
    """`cm3d_tpu.models.zoedepth.ZoeDepthModel` params -> the port's state
    dict (the inverse of `convert_zoedepth_params`)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    out: Dict[str, torch.Tensor] = {}
    core = params["core"]
    beit = core["beit"]
    _conv_from_flax(out, f"{_BACKBONE}.patch_embed.proj", beit["patch_embed"])
    out[f"{_BACKBONE}.cls_token"] = t(beit["cls_token"])
    for i in range(cfg.depth):
        k, blk = f"{_BACKBONE}.blocks.{i}", beit[f"block{i}"]
        out[f"{k}.gamma_1"] = t(blk["gamma_1"])
        out[f"{k}.gamma_2"] = t(blk["gamma_2"])
        for n in ("norm1", "norm2"):
            out[f"{k}.{n}.weight"] = t(blk[n]["scale"])
            out[f"{k}.{n}.bias"] = t(blk[n]["bias"])
        a = blk["attn"]
        out[f"{k}.attn.qkv.weight"] = t(np.asarray(a["qkv_kernel"]).T)
        out[f"{k}.attn.q_bias"] = t(a["q_bias"])
        out[f"{k}.attn.v_bias"] = t(a["v_bias"])
        out[f"{k}.attn.relative_position_bias_table"] = t(a["relative_position_bias_table"])
        _dense_from_flax(out, f"{k}.attn.proj", a["proj"])
        _dense_from_flax(out, f"{k}.mlp.fc1", blk["mlp"]["lin1"])
        _dense_from_flax(out, f"{k}.mlp.fc2", blk["mlp"]["lin2"])
    pp = "core.core.pretrained"
    for i in range(4):
        ap = f"{pp}.act_postprocess{i + 1}"
        _dense_from_flax(out, f"{ap}.0.project.0", core[f"readout{i}"]["project"])
        _conv_from_flax(out, f"{ap}.3", core[f"project{i}"])
        if i in (0, 1):  # flax kernel HWIO, spatially flipped -> [I, O, kh, kw]
            p = core[f"resample{i}"]
            w = np.asarray(p["kernel"], np.float32)[::-1, ::-1]
            out[f"{ap}.4.weight"] = t(np.transpose(w, (2, 3, 0, 1)))
            out[f"{ap}.4.bias"] = t(p["bias"])
        elif i == 3:
            _conv_from_flax(out, f"{ap}.4", core["resample3"])
        _conv_from_flax(out, f"core.core.scratch.layer{i + 1}_rn", core[f"layer{i + 1}_rn"])
    for i in (1, 2, 3, 4):
        rk, r = f"core.core.scratch.refinenet{i}", core[f"refinenet{i}"]
        for unit, name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            if unit in r:
                for c in ("conv1", "conv2"):
                    _conv_from_flax(out, f"{rk}.{name}.{c}", r[unit][c])
        _conv_from_flax(out, f"{rk}.out_conv", r["out_conv"])
    for idx, name in (("0", "output_conv1"), ("2", "output_conv2a"), ("4", "output_conv2b")):
        _conv_from_flax(out, f"core.core.scratch.output_conv.{idx}", core[name])
    _conv_from_flax(out, "conv2", params["conv2"])
    heads = [("seed_bin_regressor._net", "seed_bin_regressor"),
             ("seed_projector._net", "seed_projector"),
             ("conditional_log_binomial.mlp", "conditional_log_binomial")]
    heads += [(f"projectors.{i}._net", f"projector{i}") for i in range(4)]
    heads += [(f"attractors.{i}._net", f"attractor{i}") for i in range(4)]
    for key, name in heads:
        _conv_from_flax(out, f"{key}.0", params[name]["conv1"])
        _conv_from_flax(out, f"{key}.2", params[name]["conv2"])
    return out


def synth_zoedepth_state_dict(cfg: ZoeDepthConfig, rng: np.random.Generator,
                              ckpt_grid: Optional[Tuple[int, int]] = None
                              ) -> Dict[str, np.ndarray]:
    """A state dict with the released key layout and N(0, 0.02) values
    (tests, and the card's smoke run: no released checkpoint is in the
    repository). The port's copy of the JAX package's function: the same
    keys in the same order, so the same `rng` gives the same arrays."""
    d = cfg.embed_dim
    gh, gw = ckpt_grid or cfg.grid_hw
    num_rel = (2 * gh - 1) * (2 * gw - 1) + 3

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    sd: Dict[str, np.ndarray] = {}
    bb = _BACKBONE
    sd[f"{bb}.patch_embed.proj.weight"] = t(d, 3, cfg.patch_size, cfg.patch_size)
    sd[f"{bb}.patch_embed.proj.bias"] = t(d)
    sd[f"{bb}.cls_token"] = t(1, 1, d)
    hidden = int(d * cfg.mlp_ratio)
    for i in range(cfg.depth):
        k = f"{bb}.blocks.{i}"
        sd[f"{k}.norm1.weight"] = t(d) + 1
        sd[f"{k}.norm1.bias"] = t(d)
        sd[f"{k}.norm2.weight"] = t(d) + 1
        sd[f"{k}.norm2.bias"] = t(d)
        sd[f"{k}.gamma_1"] = t(d) + 1
        sd[f"{k}.gamma_2"] = t(d) + 1
        sd[f"{k}.attn.qkv.weight"] = t(3 * d, d)
        sd[f"{k}.attn.q_bias"] = t(d)
        sd[f"{k}.attn.v_bias"] = t(d)
        sd[f"{k}.attn.relative_position_bias_table"] = t(num_rel, cfg.num_heads)
        sd[f"{k}.attn.proj.weight"] = t(d, d)
        sd[f"{k}.attn.proj.bias"] = t(d)
        sd[f"{k}.mlp.fc1.weight"] = t(hidden, d)
        sd[f"{k}.mlp.fc1.bias"] = t(hidden)
        sd[f"{k}.mlp.fc2.weight"] = t(d, hidden)
        sd[f"{k}.mlp.fc2.bias"] = t(d)

    pp = "core.core.pretrained"
    for i in range(4):
        dd = cfg.dpt_dims[i]
        sd[f"{pp}.act_postprocess{i + 1}.0.project.0.weight"] = t(d, 2 * d)
        sd[f"{pp}.act_postprocess{i + 1}.0.project.0.bias"] = t(d)
        sd[f"{pp}.act_postprocess{i + 1}.3.weight"] = t(dd, d, 1, 1)
        sd[f"{pp}.act_postprocess{i + 1}.3.bias"] = t(dd)
        if i == 0:
            sd[f"{pp}.act_postprocess1.4.weight"] = t(dd, dd, 4, 4)
            sd[f"{pp}.act_postprocess1.4.bias"] = t(dd)
        elif i == 1:
            sd[f"{pp}.act_postprocess2.4.weight"] = t(dd, dd, 2, 2)
            sd[f"{pp}.act_postprocess2.4.bias"] = t(dd)
        elif i == 3:
            sd[f"{pp}.act_postprocess4.4.weight"] = t(dd, dd, 3, 3)
            sd[f"{pp}.act_postprocess4.4.bias"] = t(dd)
        sd[f"core.core.scratch.layer{i + 1}_rn.weight"] = t(cfg.scratch_dim, dd, 3, 3)
    s = cfg.scratch_dim
    for i in (1, 2, 3, 4):
        rk = f"core.core.scratch.refinenet{i}"
        for u in ("resConfUnit1", "resConfUnit2"):
            sd[f"{rk}.{u}.conv1.weight"] = t(s, s, 3, 3)
            sd[f"{rk}.{u}.conv1.bias"] = t(s)
            sd[f"{rk}.{u}.conv2.weight"] = t(s, s, 3, 3)
            sd[f"{rk}.{u}.conv2.bias"] = t(s)
        sd[f"{rk}.out_conv.weight"] = t(s, s, 1, 1)
        sd[f"{rk}.out_conv.bias"] = t(s)
    sd["core.core.scratch.output_conv.0.weight"] = t(cfg.head_dim1, s, 3, 3)
    sd["core.core.scratch.output_conv.0.bias"] = t(cfg.head_dim1)
    sd["core.core.scratch.output_conv.2.weight"] = t(cfg.head_dim2, cfg.head_dim1, 3, 3)
    sd["core.core.scratch.output_conv.2.bias"] = t(cfg.head_dim2)
    sd["core.core.scratch.output_conv.4.weight"] = t(1, cfg.head_dim2, 1, 1)
    sd["core.core.scratch.output_conv.4.bias"] = t(1)

    sd["conv2.weight"] = t(s, s, 1, 1)
    sd["conv2.bias"] = t(s)
    sd["seed_bin_regressor._net.0.weight"] = t(s, s, 1, 1)
    sd["seed_bin_regressor._net.0.bias"] = t(s)
    sd["seed_bin_regressor._net.2.weight"] = t(cfg.n_bins, s, 1, 1)
    sd["seed_bin_regressor._net.2.bias"] = t(cfg.n_bins)
    sd["seed_projector._net.0.weight"] = t(cfg.bin_embedding_dim, s, 1, 1)
    sd["seed_projector._net.0.bias"] = t(cfg.bin_embedding_dim)
    sd["seed_projector._net.2.weight"] = t(cfg.bin_embedding_dim, cfg.bin_embedding_dim, 1, 1)
    sd["seed_projector._net.2.bias"] = t(cfg.bin_embedding_dim)
    e = cfg.bin_embedding_dim
    for i in range(4):
        sd[f"projectors.{i}._net.0.weight"] = t(e, s, 1, 1)
        sd[f"projectors.{i}._net.0.bias"] = t(e)
        sd[f"projectors.{i}._net.2.weight"] = t(e, e, 1, 1)
        sd[f"projectors.{i}._net.2.bias"] = t(e)
        sd[f"attractors.{i}._net.0.weight"] = t(e, e, 1, 1)
        sd[f"attractors.{i}._net.0.bias"] = t(e)
        sd[f"attractors.{i}._net.2.weight"] = t(cfg.n_attractors[i], e, 1, 1)
        sd[f"attractors.{i}._net.2.bias"] = t(cfg.n_attractors[i])
    cin = cfg.head_dim2 + 1 + e
    sd["conditional_log_binomial.mlp.0.weight"] = t(cin // 2, cin, 1, 1)
    sd["conditional_log_binomial.mlp.0.bias"] = t(cin // 2)
    sd["conditional_log_binomial.mlp.2.weight"] = t(4, cin // 2, 1, 1)
    sd["conditional_log_binomial.mlp.2.bias"] = t(4)
    return sd

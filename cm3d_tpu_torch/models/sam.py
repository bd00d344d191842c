"""Segment Anything (SAM): ViT image encoder, box prompt encoder, mask
decoder — the box-prompted mask model of the reference's 2D stage
(src/nuscenes/gen_2d_masks_detic.py:112,248-252,384-398; SamPredictor with
`multimask_output=False`). Mirrors `cm3d_tpu/models/sam.py`.

ViT-H/16 encoder at 1024x1024 with 14x14 window attention and decomposed
relative positions (4 global blocks), 256-d prompt/mask space, a 2-layer
two-way transformer decoder. Parameter names are the released
`sam_vit_h_4b8939.pth` state dict's. Windowed attention is plain PyTorch
(matmuls + an f32 softmax), as the JAX package leaves it to XLA; the global
blocks' attention is the flash kernel of `kernels/sam_global_attn.py` (the
same plain chain on the CPU). With `SamConfig(fused_window_attn=True)`
(opt-in, as in the JAX package) the windowed blocks' norm1 + qkv + rel-pos
attention + proj run the hand-written kernels of
`kernels/window_attn_relpos.py` instead; the
parameters and state-dict keys are the same in both modes. With
`SamConfig(quant_int8=True)` the encoder blocks' qkv / proj / MLP layers are
int8 w8a8 (`models.common.QuantLinear`, `ops/quant.py`; a load transform,
`quantize_sam_state_dict`, makes their buffers from a float state dict), with
per-token dynamic activation scales or, with `quant_static`, calibrated ones
(`calibrate_sam_act_scales`). int8 and the fused windowed blocks exclude
each other, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.kernels.sam_global_attn import sam_global_attn
from cm3d_tpu_torch.kernels.window_attn_relpos import window_attn_relpos
from cm3d_tpu_torch.models.common import (
    Conv,
    Dense,
    LayerNorm,
    LayerNorm2d,
    MLPBlock,
    linear,
    window_partition,
    window_unpartition,
)
from cm3d_tpu_torch.ops.relpos_attn import relpos_attention, resize_rel_pos


@dataclasses.dataclass(frozen=True)
class SamConfig:
    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280  # ViT-H
    encoder_depth: int = 32
    encoder_heads: int = 16
    encoder_global_attn: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    out_dim: int = 256  # prompt/mask embedding dim
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    dtype: str = "float32"  # compute dtype ("bfloat16" for production)
    # encode non-square images without padding to the full square (a small
    # documented deviation from SamPredictor; off by default for parity)
    rect_encode: bool = False
    # fused kernels for the WINDOWED encoder blocks (kernels/
    # window_attn_relpos.py): norm1 + qkv + decomposed-rel-pos attention +
    # proj. Opt-in; same parameters. True / False only: the JAX package's
    # "interpret" names its Pallas interpreter and means nothing here.
    fused_window_attn: bool | str = False
    # int8 w8a8 qkv / proj / MLP layers in the ENCODER blocks (ops/quant.py):
    # per-channel int8 weights (load transform `quantize_sam_state_dict`) and
    # per-token dynamic int8 activations. Patch embed, attention products,
    # neck and decoder stay in the compute dtype. A documented deviation
    # from the torch model, opt-in.
    quant_int8: bool = False
    # calibrated static activation scales (requires quant_int8): act_scale
    # buffers from `calibrate_sam_act_scales` replace the per-token amax
    quant_static: bool = False

    def __post_init__(self):
        if self.quant_int8 and self.fused_window_attn:
            raise ValueError("quant_int8 and fused_window_attn are mutually exclusive: "
                             "the fused kernel consumes float qkv/proj params")
        if self.quant_static and not self.quant_int8:
            raise ValueError("quant_static requires quant_int8")

    def quant_mode(self) -> bool | str:
        """The encoder layers' quant= value: False | True | "static"."""
        if self.quant_int8 and self.quant_static:
            return "static"
        return self.quant_int8

    @property
    def embed_hw(self) -> int:
        return self.img_size // self.patch_size


SAM_VIT_H = SamConfig()
SAM_VIT_L = SamConfig(encoder_dim=1024, encoder_depth=24, encoder_heads=16,
                      encoder_global_attn=(5, 11, 17, 23))
SAM_VIT_B = SamConfig(encoder_dim=768, encoder_depth=12, encoder_heads=12,
                      encoder_global_attn=(2, 5, 8, 11))
SAM_TEST = SamConfig(img_size=64, encoder_dim=32, encoder_depth=2,
                     encoder_heads=2, encoder_global_attn=(1,), window_size=2,
                     decoder_mlp_dim=64)

# released checkpoint family (sam_vit_{h,l,b}_*.pth share one state-dict
# layout; each size loads its own pos_embed and rel-pos table shapes)
SAM_PRESETS = {"vit_h": SAM_VIT_H, "vit_l": SAM_VIT_L, "vit_b": SAM_VIT_B}


def sam_config_for(size: str) -> SamConfig:
    """Preset lookup for --sam_size CLI flags (vit_h | vit_l | vit_b)."""
    try:
        return SAM_PRESETS[size]
    except KeyError:
        raise ValueError(
            f"unknown SAM size {size!r}; expected one of {sorted(SAM_PRESETS)}") from None


def _check_ported(cfg: SamConfig) -> None:
    if not isinstance(cfg.fused_window_attn, bool):
        raise ValueError(
            f"SamConfig.fused_window_attn={cfg.fused_window_attn!r}: the port takes True "
            f"or False; \"interpret\" is the JAX package's Pallas interpreter mode (on a "
            f"CPU tensor the port's fused blocks run the kernel's plain PyTorch version)")


class Attention(nn.Module):
    """Encoder attention with decomposed relative positions."""

    def __init__(self, dim: int, heads: int, input_hw: Tuple[int, int], dtype, quant=False,
                 global_attn: bool = False):
        super().__init__()
        # heads: this module's; a tensor-sharded copy holds heads / n of them
        # (`parallel.sharding.shard_model_params`)
        self.heads, self.dtype = heads, dtype
        # a global block's attention is the flash kernel of
        # kernels/sam_global_attn.py; a windowed block's is its plain chain
        self.global_attn = global_attn
        self._rel_tables = None  # (key, rel_h, rel_w) of rel_tables
        self.head_dim = hd = dim // heads
        self.qkv = linear(dim, 3 * dim, dtype=dtype, quant=quant)
        self.proj = linear(dim, dim, dtype=dtype, quant=quant)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_hw[0] - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_hw[1] - 1, hd))

    def rel_tables(self, kh: int, kw: int):
        """The rel-pos tables in the compute dtype, resized on their device to
        a kh x kw key map (f32 where resized). Kept between calls while the
        parameters are the same tensors at the same version, outside
        autograd: a ViT-B rect encode would otherwise interpolate its h
        table again in every call."""
        ph, pw = self.rel_pos_h, self.rel_pos_w
        if (torch.is_grad_enabled() and (ph.requires_grad or pw.requires_grad)) \
                or ph.is_inference() or pw.is_inference():
            return (resize_rel_pos(ph.to(self.dtype), 2 * kh - 1),
                    resize_rel_pos(pw.to(self.dtype), 2 * kw - 1))
        key = (kh, kw, ph.data_ptr(), pw.data_ptr(), ph._version, pw._version)
        if self._rel_tables is None or self._rel_tables[0] != key:
            self._rel_tables = (key, resize_rel_pos(ph.to(self.dtype), 2 * kh - 1),
                                resize_rel_pos(pw.to(self.dtype), 2 * kw - 1))
        return self._rel_tables[1:]

    def forward(self, x: torch.Tensor, gather_kv=None, row0: int = 0) -> torch.Tensor:
        """x: [b, h, w, dim]. A sequence-sharded global block passes its
        rank's rows (from `row0`) and `gather_kv(k, v)`, which returns the
        keys and values of the whole map."""
        b, h, w, dim = x.shape
        hd = self.head_dim
        qkv = self.qkv(x.reshape(b, h * w, dim)).reshape(b, h * w, 3, self.heads, hd)
        q, k, v = qkv.unbind(2)  # [b, n, heads, hd]
        kh = h
        if gather_kv is not None:
            k, v = gather_kv(k, v)
            kh = k.shape[1] // w
        attend = sam_global_attn if self.global_attn else relpos_attention
        x = attend(q, k, v, *self.rel_tables(kh, w), q_hw=(h, w), k_hw=(kh, w), row0=row0)
        return self.proj(x.reshape(b, h, w, self.heads * hd))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid_hw, dtype,
                 fused: bool = False, quant=False):
        super().__init__()
        self.window = window  # 0 = global attention
        self.fused = bool(fused and window)  # windowed blocks only
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, (window, window) if window else grid_hw, dtype,
                              quant=quant, global_attn=not window)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim, dim, dtype=dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.fused:
            a = self.attn
            x = shortcut + window_attn_relpos(
                x.contiguous(), self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
                a.proj.weight, a.proj.bias, a.rel_pos_h, a.rel_pos_w, heads=a.heads,
                window=self.window, dtype=a.dtype, eps=self.norm1.eps)
            return x + self.mlp(self.norm2(x))
        x = self.norm1(x)
        if self.window:
            hw = (x.shape[1], x.shape[2])
            x, pad_hw = window_partition(x, self.window)
        x = self.attn(x)
        if self.window:
            x = window_unpartition(x, self.window, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SamConfig, dtype):
        super().__init__()
        self.proj = Conv(3, cfg.encoder_dim, cfg.patch_size, stride=cfg.patch_size, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SamConfig, dtype):
        super().__init__()
        hw = cfg.embed_hw
        self.patch_embed = PatchEmbed(cfg, dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, hw, hw, cfg.encoder_dim))
        self.blocks = nn.ModuleList(
            Block(cfg.encoder_dim, cfg.encoder_heads,
                  0 if i in cfg.encoder_global_attn else cfg.window_size, (hw, hw), dtype,
                  fused=cfg.fused_window_attn, quant=cfg.quant_mode())
            for i in range(cfg.encoder_depth)
        )
        self.neck = nn.Sequential(
            Conv(cfg.encoder_dim, cfg.out_dim, 1, bias=False, dtype=dtype),
            LayerNorm2d(cfg.out_dim),
            Conv(cfg.out_dim, cfg.out_dim, 3, padding=1, bias=False, dtype=dtype),
            LayerNorm2d(cfg.out_dim),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, 3] normalized image -> [B, h, w, out_dim] f32."""
        x = self.patch_embed(x)
        gh, gw = x.shape[1], x.shape[2]
        if gh > self.pos_embed.shape[1] or gw > self.pos_embed.shape[2]:
            raise ValueError(f"SAM encoder: token grid {gh}x{gw} exceeds the "
                             f"{self.pos_embed.shape[1]}-square position table")
        x = x + self.pos_embed[:, :gh, :gw]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.zeros(2, d // 2))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """Random-fourier encoding of [..., 2] coords in [0, 1]."""
        coords = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    """Box prompts only (the pipeline never uses point/mask prompts)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        d = cfg.out_dim
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(d)
        # 4 point types: pos point, neg point, box corner 1, box corner 2
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.no_mask_embed = nn.Embedding(1, d)

    def dense_pe(self) -> torch.Tensor:
        hw = self.cfg.embed_hw
        dev = self.no_mask_embed.weight.device
        r = torch.arange(hw, device=dev, dtype=torch.float32)
        grid = (torch.stack(torch.meshgrid(r, r, indexing="ij"), -1) + 0.5) / hw
        return self.pe_layer(grid.flip(-1))  # encode as (x, y): [h, w, d]

    def forward(self, boxes: torch.Tensor, grid_hw=None):
        """boxes: [B, 4] (x0, y0, x1, y1) in input-image pixels. Returns
        (sparse [B, 2, d], dense [B, gh, gw, d])."""
        corners = boxes.reshape(-1, 2, 2) + 0.5
        emb = self.pe_layer(corners / self.cfg.img_size)
        emb = torch.stack([emb[:, 0] + self.point_embeddings[2].weight[0],
                           emb[:, 1] + self.point_embeddings[3].weight[0]], dim=1)
        gh, gw = grid_hw or (self.cfg.embed_hw, self.cfg.embed_hw)
        dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            boxes.shape[0], gh, gw, self.cfg.out_dim)
        return emb, dense


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1, dtype=torch.float32):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = Dense(dim, inner, dtype=dtype)
        self.k_proj = Dense(dim, inner, dtype=dtype)
        self.v_proj = Dense(dim, inner, dtype=dtype)
        self.out_proj = Dense(inner, dim, dtype=dtype)

    def forward(self, q, k, v):
        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        hd = qh.shape[-1]
        attn = torch.softmax(((qh / math.sqrt(hd)) @ kh.transpose(-2, -1)).float(),
                             dim=-1).to(vh.dtype)
        out = attn @ vh
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, skip_first_layer_pe: bool,
                 dtype):
        super().__init__()
        self.dtype, self.skip_first_layer_pe = dtype, skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, heads, dtype=dtype)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.cross_attn_token_to_image = DecoderAttention(dim, heads, 2, dtype=dtype)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = MLPBlock(dim, mlp_dim, dim, act="relu", dtype=dtype)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.norm4 = LayerNorm(dim, eps=1e-5)
        self.cross_attn_image_to_token = DecoderAttention(dim, heads, 2, dtype=dtype)

    def forward(self, queries, keys, query_pe, key_pe):
        dt = self.dtype
        if self.skip_first_layer_pe:
            # first layer: attention REPLACES the queries (no residual, no PE)
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries).to(dt)
        q, k = queries + query_pe, keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self.norm2(queries).to(dt)
        queries = queries + self.mlp(queries)
        queries = self.norm3(queries).to(dt)
        q, k = queries + query_pe, keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        keys = self.norm4(keys).to(dt)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamConfig, dtype):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg.out_dim, cfg.decoder_heads, cfg.decoder_mlp_dim,
                                 skip_first_layer_pe=(i == 0), dtype=dtype)
            for i in range(cfg.decoder_depth)
        )
        self.final_attn_token_to_image = DecoderAttention(cfg.out_dim, cfg.decoder_heads, 2,
                                                          dtype=dtype)
        self.norm_final_attn = LayerNorm(cfg.out_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        b, h, w, c = image_embedding.shape
        dt = self.dtype
        keys = image_embedding.reshape(b, h * w, c).to(dt)
        key_pe = image_pe.reshape(1, h * w, c).expand(b, h * w, c).to(dt)
        point_embedding = point_embedding.to(dt)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries).to(dt), keys


class MLP(nn.Module):
    """SAM's hypernetwork / IoU-head MLP: ReLU between layers."""

    def __init__(self, din: int, hidden: int, dout: int, depth: int = 3, dtype=None):
        super().__init__()
        dims = [din] + [hidden] * (depth - 1) + [dout]
        self.layers = nn.ModuleList(Dense(a, b, dtype=dtype) for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class Up2x2(nn.ConvTranspose2d):
    """2x2 stride-2 transposed conv over [B, H, W, C] maps in `dtype`."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__(cin, cout, 2, stride=2)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                               self.bias.to(dt), stride=2)
        return y.permute(0, 2, 3, 1)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig, dtype):
        super().__init__()
        d = cfg.out_dim
        self.dtype = dtype
        self.n_mask_tokens = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.n_mask_tokens, d)
        self.transformer = TwoWayTransformer(cfg, dtype)
        self.output_upscaling = nn.Sequential(
            Up2x2(d, d // 4, dtype), LayerNorm2d(d // 4), nn.GELU(),
            Up2x2(d // 4, d // 8, dtype), nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, dtype=dtype) for _ in range(self.n_mask_tokens))
        self.iou_prediction_head = MLP(d, d, self.n_mask_tokens)

    def forward(self, image_embedding, image_pe, sparse_prompt, dense_prompt):
        """Returns (masks [B, num_tokens, 4h, 4w] f32, iou_pred [B, num_tokens])."""
        b = sparse_prompt.shape[0]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([tokens[None].expand(b, -1, -1), sparse_prompt], dim=1)
        src = image_embedding + dense_prompt
        hs, keys = self.transformer(src, image_pe, tokens)
        iou_out, mask_out = hs[:, 0], hs[:, 1:1 + self.n_mask_tokens]
        h, w = src.shape[1], src.shape[2]
        up_mods = self.output_upscaling
        up = up_mods[0](keys.reshape(b, h, w, -1))
        up = F.gelu(up_mods[1](up).to(self.dtype))
        up = F.gelu(up_mods[3](up))  # [B, 4h, 4w, d/8]
        hyper = torch.stack([mlp(mask_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        # f32 island: the mask logits get thresholded at 0 downstream
        masks = torch.einsum("bnc,bhwc->bnhw", hyper.float(), up.float())
        return masks, self.iou_prediction_head(iou_out)


class Sam(nn.Module):
    """Box-prompted SAM (encode once, decode many boxes)."""

    def __init__(self, cfg: SamConfig = SAM_VIT_H):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.image_encoder = ImageEncoderViT(cfg, dtype)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg, dtype)

    def encode_image(self, x: torch.Tensor) -> torch.Tensor:
        return self.image_encoder(x)

    def decode_boxes(self, embedding: torch.Tensor, boxes: torch.Tensor,
                     multimask: bool = False):
        """embedding: [h, w, d] (one image); boxes: [P, 4] padded. Returns
        (mask_logits [P, 4h, 4w], iou [P]) of token 0 (multimask_output=
        False), or of the best multimask token."""
        gh, gw = embedding.shape[0], embedding.shape[1]
        sparse, dense = self.prompt_encoder(boxes, (gh, gw))
        # rect embeddings use the top-left crop of the square dense PE
        image_pe = self.prompt_encoder.dense_pe()[:gh, :gw]
        emb = embedding[None].expand(boxes.shape[0], *embedding.shape)
        masks, iou = self.mask_decoder(emb, image_pe, sparse, dense)
        if multimask:
            best = torch.argmax(iou[:, 1:], dim=-1) + 1
            ar = torch.arange(masks.shape[0], device=masks.device)
            return masks[ar, best], iou[ar, best]
        return masks[:, 0], iou[:, 0]


_ENCODER_LINEARS = ("attn.qkv", "attn.proj", "mlp.lin1", "mlp.lin2")


def quantize_sam_state_dict(sd: dict) -> dict:
    """Float Sam state dict -> the one `SamConfig(quant_int8=True)` loads:
    every encoder block's qkv / proj / lin1 / lin2 becomes QuantLinear
    buffers (`ops.quant.quantize_linear_state`); everything else is the same
    tensors. The counterpart of `quantize_sam_params`; `sd` is not changed."""
    from cm3d_tpu_torch.ops.quant import quantize_linear_state

    out = dict(sd)
    for key in sd:
        if key.startswith("image_encoder.blocks.") and key.endswith(".attn.qkv.weight"):
            blk = key[:-len(".attn.qkv.weight")]
            for name in _ENCODER_LINEARS:
                quantize_linear_state(out, f"{blk}.{name}")
    return out


def calibrate_sam_act_scales(cfg: SamConfig, sd: dict, images: torch.Tensor,
                             margin: float = 1.0) -> dict:
    """Static activation scales for a quantized SAM encoder: `sd` (a
    `quantize_sam_state_dict` output) loaded into the static model, ONE
    encode of `images` ([B, H, W, 3] normalized, on the device the caller
    wants) calibrating it in place (`models.common.calibrate_act_scales_`:
    the dynamic product, every QuantLinear's input absmax, baked). Returns
    `sd` with the `act_scale` entries: the state dict for
    `SamConfig(quant_static=True)`. Calibrate on the deploy distribution:
    activations past the envelope clip."""
    from cm3d_tpu_torch.models.common import calibrate_act_scales_
    from cm3d_tpu_torch.ops.quant import with_act_scale_placeholders

    with torch.device(images.device):
        model = Sam(dataclasses.replace(cfg, quant_static=True))
    model.load_state_dict(with_act_scale_placeholders(sd))
    calibrate_act_scales_(model, lambda: model.encode_image(images), margin)
    return {**sd, **{k: v.cpu() for k, v in model.state_dict().items()
                     if k.endswith(".act_scale")}}


SAM_PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def preprocess_image(img_hwc_uint8: np.ndarray, img_size: int = 1024) -> np.ndarray:
    """Resize the longest side to img_size (PIL bilinear), normalize,
    bottom/right zero-pad to the square."""
    from PIL import Image

    h, w = img_hwc_uint8.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    im = Image.fromarray(img_hwc_uint8).resize((nw, nh), Image.BILINEAR)
    arr = (np.asarray(im, np.float32) - SAM_PIXEL_MEAN) / SAM_PIXEL_STD
    out = np.zeros((img_size, img_size, 3), np.float32)
    out[:nh, :nw] = arr
    return out

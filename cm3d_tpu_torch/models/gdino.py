"""GroundingDINO (Swin-T OGC) open-vocabulary grounded detection.
Mirrors `cm3d_tpu/models/gdino.py`.

The reference keeps GroundingDINO as its alternative detector, commented
out (src/kitti/gen_2d_masks_detic.py:115-117 config / checkpoint, :633
`load_model(...)`, :192-238 `get_grounding_output1`, :383-447
`get_grounding_output`). This module is the published architecture, as the
JAX package rebuilds it:

- Swin-T backbone (`models/swin.py`, embed 96, depths 2/2/6/2, strides
  8/16/32) plus an extra stride-2 conv level, each projected to d_model=256
  with GroupNorm(32). Every block's attention goes through
  `kernels/window_attn.py` (the CUDA kernels on the card).
- BERT-base text encoder with GroundingDINO's sub-sentence masks (phrase-
  local attention, per-phrase position ids), then a `feat_map` Linear.
- Feature enhancer (6 layers): bidirectional image <-> text fusion,
  text self-attention, multi-scale deformable image self-attention.
- Language-guided query selection: the top `num_queries` memory tokens by
  their largest text-contrastive logit (`torch.topk`).
- Cross-modality decoder (6 layers) with iterative box refinement, and the
  parameter-free contrastive head.

`MSDeformAttn` is plain PyTorch: the four-corner bilinear gather the JAX
module writes (floor, validity mask, `torch.gather`); it is no Pallas
kernel in the JAX package and has no kernel here.

The modules carry the released `groundingdino_swint_ogc.pth` keys once
`module.` is stripped (`bert.encoder.layer.{i}...`, `backbone.0.layers...`,
`transformer.encoder.fusion_layers.{i}...`, `bbox_embed.{i}.layers.{j}`);
`gdino_state_dict_from_released` drops what the model does not read (the
`transformer.decoder.bbox_embed.*` aliases, `bert.pooler`, buffers).

The JAX package's deviations are copied: inference only, a static input
size with a zero-padded letterbox (no image masks, valid ratios 1), text
padded to `max_text_len`. So are two differences from the released model
(ROADMAP C7, C8): the extra level's stride-2 conv pads like flax's SAME
(W of 38 padded (0, 1), the release pads (1, 1)), and the input
projections' GroupNorm uses eps 1e-6 (the release 1e-5).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cm3d_tpu_torch.models.common import Conv, Dense, GroupNorm, LayerNorm
from cm3d_tpu_torch.models.swin import SwinConfig, SwinTransformer


# ---------------------------------------------------------------------------
# config


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    pad_id: int = 0
    cls_id: int = 101
    sep_id: int = 102
    unk_id: int = 100


@dataclasses.dataclass(frozen=True)
class GdinoConfig:
    img_hw: Tuple[int, int] = (800, 1216)  # static network input (H, W)
    d_model: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    num_queries: int = 900
    n_levels: int = 4
    n_points: int = 4
    max_text_len: int = 256
    # text enhancer layer: 4 heads, ffn 1024
    text_heads: int = 4
    text_ffn: int = 1024
    # fusion (BiAttentionBlock): embed = dim_feedforward // 2, heads = nheads // 2
    fusion_dim: int = 1024
    fusion_heads: int = 4
    swin: SwinConfig = SwinConfig(
        embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24),
        window_size=7, out_indices=(1, 2, 3),
    )
    bert: BertConfig = BertConfig()
    dtype: str = "float32"  # compute dtype (params stay f32)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.nheads


GDINO_SWINT = GdinoConfig()
GDINO_TEST = GdinoConfig(
    img_hw=(64, 96), d_model=16, nheads=2, enc_layers=2, dec_layers=2,
    dim_feedforward=32, num_queries=12, n_points=2, max_text_len=24,
    text_heads=2, text_ffn=16, fusion_dim=16, fusion_heads=2,
    swin=SwinConfig(embed_dim=8, depths=(1, 1, 1), num_heads=(1, 2, 2),
                    window_size=4, out_indices=(0, 1, 2)),
    bert=BertConfig(vocab_size=64, hidden=16, layers=2, heads=2,
                    intermediate=16, max_position=32),
)

# ImageNet normalization (the commented transform_image,
# kitti/gen_2d_masks_detic.py:165-174)
GDINO_PIXEL_MEAN = (0.485, 0.456, 0.406)
GDINO_PIXEL_STD = (0.229, 0.224, 0.225)
GN_EPS = 1e-6  # flax GroupNorm's default, as the JAX package (ROADMAP C8)


def gdino_config(base: GdinoConfig = GDINO_SWINT, dtype: str = "float32",
                 quant_int8: bool = False, **bert) -> GdinoConfig:
    """`base` computing in `dtype` (model and Swin), with int8 Swin MLPs
    under `quant_int8`, and BertConfig fields replaced by `bert`."""
    return dataclasses.replace(
        base, dtype=dtype, bert=dataclasses.replace(base.bert, **bert),
        swin=dataclasses.replace(base.swin, dtype=dtype, quant_int8=quant_int8))


# ---------------------------------------------------------------------------
# WordPiece tokenizer (bert-base-uncased semantics, host side)


class WordPieceTokenizer:
    """Greedy longest-match WordPiece behind BERT's basic tokenization
    (lowercase, split on whitespace and punctuation). `vocab` maps token ->
    id; continuation pieces carry the `##` prefix."""

    def __init__(self, vocab: Dict[str, int], cfg: BertConfig = BertConfig()):
        self.vocab = vocab
        self.inv = {i: t for t, i in vocab.items()}
        self.cfg = cfg

    @classmethod
    def from_file(cls, path: str, cfg: BertConfig = BertConfig()):
        with open(path) as f:
            vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        return cls(vocab, cfg)

    @staticmethod
    def _basic(text: str) -> List[str]:
        text = text.lower().strip()
        out: List[str] = []
        word = ""
        for ch in text:
            if ch.isspace():
                if word:
                    out.append(word)
                    word = ""
            elif not ch.isalnum():
                if word:
                    out.append(word)
                    word = ""
                out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        pieces: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.cfg.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def encode(self, caption: str) -> List[int]:
        """[CLS] pieces... [SEP]: the released pipeline's input_ids."""
        ids = [self.cfg.cls_id]
        for w in self._basic(caption):
            ids.extend(self._wordpiece(w))
        ids.append(self.cfg.sep_id)
        return ids

    def decode_piece(self, tid: int) -> str:
        return self.inv.get(tid, "[UNK]")


def prepare_caption(caption: str) -> str:
    """get_grounding_output1's preamble (kitti gen_2d_masks_detic.py:195-198):
    lower, strip, end with '.'."""
    caption = caption.lower().strip()
    if not caption.endswith("."):
        caption = caption + "."
    return caption


def special_token_masks(ids: np.ndarray, cfg: BertConfig, period_id: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """GroundingDINO's generate_masks_with_special_tokens_and_transfer_map
    over one padded id row: phrases are the runs between special tokens
    ([CLS] / [SEP] / '.'); a phrase's tokens attend to each other (a special
    token to itself) and position ids restart at 0 in each phrase.
    Returns (attn_mask [L, L] bool, position_ids [L], token_mask [L] bool)."""
    n = len(ids)
    special = (ids == cfg.cls_id) | (ids == cfg.sep_id) | (ids == period_id)
    token_mask = ids != cfg.pad_id
    attn = np.eye(n, dtype=bool)
    pos = np.zeros(n, np.int64)
    prev = 0
    for i in range(n):
        if not token_mask[i]:
            break
        if special[i]:
            prev = i + 1
        else:
            attn[prev:i + 1, prev:i + 1] = True
            pos[i] = i - prev
    return attn, pos, token_mask


# ---------------------------------------------------------------------------
# BERT text encoder (post-LN, inference)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    return t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)


def _masked_attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q [B, Lq, h, hd], k / v [B, Lk, h, hd], mask [B, Lq, Lk] bool or None
    -> [B, Lq, h * hd]: logits in the compute dtype, masked with -1e9,
    softmax in f32, as the JAX modules."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, None], logits, -1e9)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(*out.shape[:2], -1)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig, dt):
        super().__init__()
        self.heads = c.heads
        self.query = Dense(c.hidden, c.hidden, dtype=dt)
        self.key = Dense(c.hidden, c.hidden, dtype=dt)
        self.value = Dense(c.hidden, c.hidden, dtype=dt)

    def forward(self, x, attn_mask):
        h = self.heads
        return _masked_attention(_heads(self.query(x), h), _heads(self.key(x), h),
                                 _heads(self.value(x), h), attn_mask)


class _DenseNorm(nn.Module):
    """A Dense and the post-LN after its residual (BERT's `output` blocks)."""

    def __init__(self, din: int, dout: int, dt):
        super().__init__()
        self.dense = Dense(din, dout, dtype=dt)
        self.LayerNorm = LayerNorm(dout, eps=1e-12)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, c: BertConfig, dt):
        super().__init__()
        self.self = BertSelfAttention(c, dt)
        self.output = _DenseNorm(c.hidden, c.hidden, dt)


class BertIntermediate(nn.Module):
    def __init__(self, c: BertConfig, dt):
        super().__init__()
        self.dense = Dense(c.hidden, c.intermediate, dtype=dt)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, dt):
        super().__init__()
        self.attention = BertAttention(c, dt)
        self.intermediate = BertIntermediate(c, dt)
        self.output = _DenseNorm(c.intermediate, c.hidden, dt)

    def forward(self, x, attn_mask):
        x = self.attention.output(self.attention.self(x, attn_mask), x)
        h = F.gelu(self.intermediate.dense(x))
        return self.output(h, x)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden)
        self.position_embeddings = nn.Embedding(c.max_position, c.hidden)
        self.token_type_embeddings = nn.Embedding(c.type_vocab, c.hidden)
        self.LayerNorm = LayerNorm(c.hidden, eps=1e-12)


class BertEncoderLayers(nn.Module):
    def __init__(self, c: BertConfig, dt):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c, dt) for _ in range(c.layers))


class BertEncoder(nn.Module):
    """ids / position_ids [B, L] int, attn_mask [B, L, L] bool -> [B, L, H]
    in the compute dtype. Keys `embeddings.*`, `encoder.layer.{i}.*` (the
    released `bert.` subtree)."""

    def __init__(self, c: BertConfig, dt=torch.float32):
        super().__init__()
        self.dt = dt
        self.embeddings = BertEmbeddings(c)
        self.encoder = BertEncoderLayers(c, dt)

    def forward(self, ids, position_ids, attn_mask):
        e = self.embeddings
        x = (e.word_embeddings(ids) + e.position_embeddings(position_ids)
             + e.token_type_embeddings(torch.zeros_like(ids)))
        x = e.LayerNorm(x).to(self.dt)
        for layer in self.encoder.layer:
            x = layer(x, attn_mask)
        return x


# ---------------------------------------------------------------------------
# positional encodings


@functools.lru_cache(maxsize=16)
def sine_position_hw(h: int, w: int, dim: int, temperature: float = 20.0) -> np.ndarray:
    """PositionEmbeddingSineHW (temperature 20 on both axes), normalized
    with scale 2 pi: [h * w, dim], y half then x half. Cached: read only."""
    half = dim // 2
    scale = 2 * math.pi
    eps = 1e-6
    ys = np.arange(1, h + 1, dtype=np.float32)[:, None] / (h + eps) * scale
    xs = np.arange(1, w + 1, dtype=np.float32)[None, :] / (w + eps) * scale
    ys = np.broadcast_to(ys, (h, w))
    xs = np.broadcast_to(xs, (h, w))
    t = temperature ** (2 * (np.arange(half, dtype=np.float32) // 2) / half)
    py = ys[..., None] / t
    px = xs[..., None] / t
    py = np.stack([np.sin(py[..., 0::2]), np.cos(py[..., 1::2])], axis=-1)
    px = np.stack([np.sin(px[..., 0::2]), np.cos(px[..., 1::2])], axis=-1)
    out = np.concatenate([py.reshape(h, w, -1), px.reshape(h, w, -1)], axis=-1)
    out = out.reshape(h * w, dim)
    out.flags.writeable = False
    return out


def sine_box_embed(boxes: torch.Tensor, dim_per_coord: int = 128) -> torch.Tensor:
    """gen_sineembed_for_position: [..., 4] cxcywh in [0, 1] ->
    [..., 4 * dim_per_coord] in (y, x, w, h) order, temperature 10000."""
    t = 10000.0 ** (2 * (torch.arange(dim_per_coord, dtype=torch.float32,
                                      device=boxes.device) // 2) / dim_per_coord)

    def emb(coord):
        p = coord[..., None] * (2 * math.pi) / t
        return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                           dim=-1).reshape(*coord.shape, dim_per_coord)

    cx, cy, w, h = boxes.unbind(-1)
    return torch.cat([emb(cy), emb(cx), emb(w), emb(h)], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


@functools.lru_cache(maxsize=8)
def _sine_table(h: int, w: int, dim: int, device: torch.device) -> torch.Tensor:
    """`sine_position_hw` on `device`, uploaded once (read only)."""
    return torch.tensor(sine_position_hw(h, w, dim), device=device)


@functools.lru_cache(maxsize=8)
def _level_normalizer(shapes: tuple, device: torch.device) -> torch.Tensor:
    """[L, 2] (W, H) of each level on `device`, uploaded once (read only)."""
    return torch.tensor([[wl, hl] for hl, wl in shapes], dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# multi-scale deformable attention


class MSDeformAttn(nn.Module):
    """Deformable attention over the flattened multi-level memory:
    grid_sample bilinear (align_corners=False, zero padding) written as four
    corner gathers a sampling point, as the JAX module does."""

    def __init__(self, d_model: int, nheads: int, n_levels: int, n_points: int, dt):
        super().__init__()
        self.h, self.l, self.p = nheads, n_levels, n_points
        self.sampling_offsets = Dense(d_model, nheads * n_levels * n_points * 2, dtype=dt)
        self.attention_weights = Dense(d_model, nheads * n_levels * n_points, dtype=dt)
        self.value_proj = Dense(d_model, d_model, dtype=dt)
        self.output_proj = Dense(d_model, d_model, dtype=dt)

    def forward(self, query, ref_points, memory, shapes: Sequence[Tuple[int, int]]):
        """query [B, Lq, D], ref_points [B, Lq, 2 | 4] (normalized), memory
        [B, Lm, D] (levels flattened), shapes [(H, W)] a level."""
        H, L, P = self.h, self.l, self.p
        B, Lq, D = query.shape
        hd = D // H
        value = self.value_proj(memory)
        dt = value.dtype
        value = value.reshape(B, -1, H, hd).transpose(1, 2)  # [B, H, Lm, hd]
        off = self.sampling_offsets(query).reshape(B, Lq, H, L, P, 2)
        w = self.attention_weights(query).reshape(B, Lq, H, L * P)
        w = torch.softmax(w.float(), dim=-1).to(dt).reshape(B, Lq, H, L, P)
        if ref_points.shape[-1] == 2:
            norm = _level_normalizer(tuple(shapes), query.device)  # [L, 2] (x, y)
            loc = ref_points[:, :, None, None, None, :] + off / norm[:, None, :]
        else:
            cxcy = ref_points[..., None, None, None, :2]
            wh = ref_points[..., None, None, None, 2:]
            loc = cxcy + off / P * wh * 0.5
        out = None
        start = 0
        for lvl, (hl, wl) in enumerate(shapes):
            v = value[:, :, start:start + hl * wl]  # [B, H, HW, hd]
            start += hl * wl
            # grid_sample(align_corners=False) pixel coordinates, [B, H, Lq, P]
            x = (loc[:, :, :, lvl, :, 0] * wl - 0.5).transpose(1, 2)
            y = (loc[:, :, :, lvl, :, 1] * hl - 0.5).transpose(1, 2)
            x0, y0 = torch.floor(x), torch.floor(y)
            acc = None
            for dy in (0, 1):
                for dx in (0, 1):
                    xi, yi = x0 + dx, y0 + dy
                    wgt = (1 - (x - xi).abs()) * (1 - (y - yi).abs())
                    valid = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
                    idx = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)).long()
                    idx = idx.reshape(B, H, Lq * P, 1).expand(-1, -1, -1, hd)
                    g = torch.gather(v, 2, idx).reshape(B, H, Lq, P, hd)
                    g = g * (wgt * valid)[..., None].to(dt)
                    acc = g if acc is None else acc + g
            o = torch.einsum("bhqp,bhqpd->bqhd", w[:, :, :, lvl].transpose(1, 2), acc)
            out = o if out is None else out + o
        return self.output_proj(out.reshape(B, Lq, D))


# ---------------------------------------------------------------------------
# attention blocks


class MHA(nn.Module):
    """torch nn.MultiheadAttention's parameters (in_proj_weight [3D, D],
    in_proj_bias, out_proj), computed as the JAX module's four Denses."""

    def __init__(self, d_model: int, nheads: int, dt):
        super().__init__()
        self.heads, self.dt = nheads, dt
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Dense(d_model, d_model, dtype=dt)

    def forward(self, q, k, v, mask: Optional[torch.Tensor] = None):
        dt, d = self.dt, self.out_proj.in_features
        w, b = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        qh, kh, vh = (_heads(F.linear(t.to(dt), w[i * d:(i + 1) * d], b[i * d:(i + 1) * d]),
                             self.heads) for i, t in enumerate((q, k, v)))
        return self.out_proj(_masked_attention(qh, kh, vh, mask))


class BiAttention(nn.Module):
    """BiMultiHeadAttention: image <-> text attention from one logit matrix
    (image queries x text keys) softmaxed both ways, in f32 after the
    released model's max-subtraction and +-5e4 clamp."""

    def __init__(self, d_model: int, embed_dim: int, nheads: int, dt):
        super().__init__()
        self.heads = nheads
        self.v_proj = Dense(d_model, embed_dim, dtype=dt)
        self.l_proj = Dense(d_model, embed_dim, dtype=dt)
        self.values_v_proj = Dense(d_model, embed_dim, dtype=dt)
        self.values_l_proj = Dense(d_model, embed_dim, dtype=dt)
        self.out_v_proj = Dense(embed_dim, d_model, dtype=dt)
        self.out_l_proj = Dense(embed_dim, d_model, dtype=dt)

    def forward(self, vis, txt, txt_mask):
        h = self.heads
        q, k = _heads(self.v_proj(vis), h), _heads(self.l_proj(txt), h)
        vv, vl = _heads(self.values_v_proj(vis), h), _heads(self.values_l_proj(txt), h)
        dt = q.dtype
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])).float()
        logits = logits - logits.amax(dim=(-1, -2), keepdim=True)
        logits = logits.clamp(-50000.0, 50000.0)
        # image -> text: softmax over the text keys, pad tokens masked out
        a_v = torch.softmax(torch.where(txt_mask[:, None, None, :], logits, -1e9),
                            dim=-1).to(dt)
        # text -> image: softmax over the image keys, taken on the last axis
        # of the transposed logits (over an inner axis PyTorch's CUDA softmax
        # runs a kernel some 50x slower at 80,750 image tokens)
        a_l = torch.softmax(logits.transpose(-1, -2), dim=-1).to(dt)
        out_v = torch.einsum("bhqk,bkhd->bqhd", a_v, vl)
        out_l = torch.einsum("bhkq,bqhd->bkhd", a_l, vv)
        return (self.out_v_proj(out_v.reshape(*vis.shape[:-1], -1)),
                self.out_l_proj(out_l.reshape(*txt.shape[:-1], -1)))


class FusionLayer(nn.Module):
    """BiAttentionBlock: pre-LN on both streams, bi-attention, residuals
    scaled by the layer-scale gammas (drop path is identity)."""

    def __init__(self, c: GdinoConfig, dt):
        super().__init__()
        self.layer_norm_v = LayerNorm(c.d_model, eps=1e-5)
        self.layer_norm_l = LayerNorm(c.d_model, eps=1e-5)
        self.attn = BiAttention(c.d_model, c.fusion_dim, c.fusion_heads, dt)
        self.gamma_v = nn.Parameter(torch.full((c.d_model,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((c.d_model,), 1e-4))

    def forward(self, vis, txt, txt_mask):
        dv, dl = self.attn(self.layer_norm_v(vis), self.layer_norm_l(txt), txt_mask)
        return vis + self.gamma_v * dv, txt + self.gamma_l * dl


class _FFN(nn.Module):
    """linear1 -> relu -> linear2 and the norms of a post-LN layer."""

    def __init__(self, d: int, ffn: int, dt, norms: Sequence[str]):
        super().__init__()
        self.linear1 = Dense(d, ffn, dtype=dt)
        self.linear2 = Dense(ffn, d, dtype=dt)
        for n in norms:
            self.add_module(n, LayerNorm(d, eps=1e-5))

    def ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class TextSelfAttnLayer(_FFN):
    """Post-LN transformer encoder layer on the text stream, masked with
    the phrase-local attention mask."""

    def __init__(self, c: GdinoConfig, dt):
        super().__init__(c.d_model, c.text_ffn, dt, ("norm1", "norm2"))
        self.self_attn = MHA(c.d_model, c.text_heads, dt)

    def forward(self, txt, pos, attn_mask):
        q = txt + pos
        txt = self.norm1(txt + self.self_attn(q, q, txt, attn_mask))
        return self.norm2(txt + self.ffn(txt))


class DeformableEncoderLayer(_FFN):
    """Image-stream deformable self-attention layer (post-LN, relu FFN)."""

    def __init__(self, c: GdinoConfig, dt):
        super().__init__(c.d_model, c.dim_feedforward, dt, ("norm1", "norm2"))
        self.self_attn = MSDeformAttn(c.d_model, c.nheads, c.n_levels, c.n_points, dt)

    def forward(self, vis, pos, ref_points, shapes):
        vis = self.norm1(vis + self.self_attn(vis + pos, ref_points, vis, shapes))
        return self.norm2(vis + self.ffn(vis))


class DecoderLayer(_FFN):
    """Cross-modality decoder layer: query self-attention -> text
    cross-attention -> box-conditioned deformable image cross-attention ->
    FFN (post-LN)."""

    def __init__(self, c: GdinoConfig, dt):
        super().__init__(c.d_model, c.dim_feedforward, dt,
                         ("norm1", "norm2", "norm3", "catext_norm"))
        self.self_attn = MHA(c.d_model, c.nheads, dt)
        self.ca_text = MHA(c.d_model, c.nheads, dt)
        self.cross_attn = MSDeformAttn(c.d_model, c.nheads, c.n_levels, c.n_points, dt)

    def forward(self, tgt, query_pos, ref_boxes, memory, shapes, txt, txt_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        mask = txt_mask[:, None, :].expand(txt.shape[0], tgt.shape[1], txt.shape[1])
        tgt = self.catext_norm(tgt + self.ca_text(tgt + query_pos, txt, txt, mask))
        tgt = self.norm1(tgt + self.cross_attn(tgt + query_pos, ref_boxes, memory, shapes))
        return self.norm3(tgt + self.ffn(tgt))


class MLP(nn.Module):
    """n-layer relu MLP (DETR's box head); keys `layers.{j}`."""

    def __init__(self, din: int, hidden: int, dout: int, n_layers: int, dt):
        super().__init__()
        dims = [din] + [hidden] * (n_layers - 1) + [dout]
        self.layers = nn.ModuleList(Dense(a, b, dtype=dt) for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def contrastive_logits(feat, txt, txt_mask, max_text_len: int) -> torch.Tensor:
    """ContrastiveEmbed: a dot product against the text features, pad
    tokens and the tail up to max_text_len at -inf."""
    res = torch.einsum("bqd,btd->bqt", feat, txt)
    res = torch.where(txt_mask[:, None, :], res, -math.inf)
    pad = max_text_len - res.shape[-1]
    if pad > 0:
        res = F.pad(res, (0, pad), value=-math.inf)
    return res[..., :max_text_len]


# ---------------------------------------------------------------------------
# full model


class GdinoEncoder(nn.Module):
    def __init__(self, c: GdinoConfig, dt):
        super().__init__()
        self.layers = nn.ModuleList(DeformableEncoderLayer(c, dt) for _ in range(c.enc_layers))
        self.text_layers = nn.ModuleList(TextSelfAttnLayer(c, dt) for _ in range(c.enc_layers))
        self.fusion_layers = nn.ModuleList(FusionLayer(c, dt) for _ in range(c.enc_layers))


class GdinoDecoder(nn.Module):
    def __init__(self, c: GdinoConfig, dt):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(c, dt) for _ in range(c.dec_layers))
        # shared by every layer, as the released decoder's one MLP
        self.ref_point_head = MLP(2 * c.d_model, c.d_model, c.d_model, 2, dt)
        self.norm = LayerNorm(c.d_model, eps=1e-5)


class GdinoTransformer(nn.Module):
    def __init__(self, c: GdinoConfig, dt):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(c.n_levels, c.d_model))
        self.encoder = GdinoEncoder(c, dt)
        self.decoder = GdinoDecoder(c, dt)
        self.enc_output = Dense(c.d_model, c.d_model, dtype=dt)
        self.enc_output_norm = LayerNorm(c.d_model, eps=1e-5)
        self.enc_out_bbox_embed = MLP(c.d_model, c.d_model, 4, 3, dt)
        self.tgt_embed = nn.Embedding(c.num_queries, c.d_model)


def _gn_groups(d: int) -> int:
    return 32 if d % 32 == 0 else 1


class GroundingDino(nn.Module):
    def __init__(self, cfg: GdinoConfig = GDINO_SWINT):
        super().__init__()
        c = self.cfg = cfg
        dt = self.dt = getattr(torch, cfg.dtype)
        self.bert = BertEncoder(c.bert, dt)
        self.feat_map = Dense(c.bert.hidden, c.d_model, dtype=dt)
        self.backbone = nn.ModuleList([SwinTransformer(c.swin)])
        sw = c.swin
        cins = [sw.stage_dim(i) for i in sw.out_indices]
        proj = [nn.ModuleList([Conv(cin, c.d_model, 1, dtype=dt),
                               GroupNorm(_gn_groups(c.d_model), c.d_model, eps=GN_EPS)])
                for cin in cins]
        # the extra level: flax SAME padding (ROADMAP C7)
        proj.append(nn.ModuleList([
            Conv(cins[-1], c.d_model, 3, stride=2, padding="same", dtype=dt),
            GroupNorm(_gn_groups(c.d_model), c.d_model, eps=GN_EPS)]))
        assert len(proj) == c.n_levels
        self.input_proj = nn.ModuleList(proj)
        self.transformer = GdinoTransformer(c, dt)
        self.bbox_embed = nn.ModuleList(MLP(c.d_model, c.d_model, 4, 3, dt)
                                        for _ in range(c.dec_layers))

    def levels(self, image: torch.Tensor) -> List[torch.Tensor]:
        """image [B, H, W, 3] -> the n_levels maps [B, h, w, d_model] (f32)."""
        feats = self.backbone[0](image)
        maps = [feats[f"swin{i}"] for i in self.cfg.swin.out_indices]
        out = [gn(conv(f)) for (conv, gn), f in zip(self.input_proj, maps)]
        conv, gn = self.input_proj[len(maps)]
        return out + [gn(conv(maps[-1]))]

    def forward(self, image, text_ids, text_pos_ids, text_attn_mask, text_token_mask):
        """image [B, H, W, 3] ImageNet-normalized, text_ids / text_pos_ids
        [B, Lt], text_attn_mask [B, Lt, Lt] bool, text_token_mask [B, Lt]
        bool -> (pred_logits [B, nq, max_text_len], pred_boxes [B, nq, 4]
        cxcywh normalized)."""
        c, dt, tr = self.cfg, self.dt, self.transformer
        B, dev = image.shape[0], image.device
        txt = self.feat_map(self.bert(text_ids, text_pos_ids, text_attn_mask))

        levels = self.levels(image)
        shapes = [(f.shape[1], f.shape[2]) for f in levels]
        vis = torch.cat([f.reshape(B, -1, c.d_model) for f in levels], dim=1)
        pos = torch.cat([
            _sine_table(h, w, c.d_model, dev).to(dt)
            + tr.level_embed[lvl].to(dt)
            for lvl, (h, w) in enumerate(shapes)])[None]
        # per-level normalized centre grids (valid ratios 1: no padding masks)
        refs = torch.cat([
            torch.stack(torch.meshgrid(
                (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h,
                (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w,
                indexing="ij")[::-1], dim=-1).reshape(-1, 2)
            for h, w in shapes])[None].expand(B, -1, -1)

        # feature enhancer
        zeros = None
        for fusion, text_layer, enc_layer in zip(tr.encoder.fusion_layers,
                                                 tr.encoder.text_layers, tr.encoder.layers):
            vis, txt = fusion(vis, txt, text_token_mask)
            zeros = torch.zeros_like(txt) if zeros is None else zeros
            txt = text_layer(txt, zeros, text_attn_mask)
            vis = enc_layer(vis, pos, refs, shapes)

        # language-guided query selection (two-stage)
        mem = tr.enc_output_norm(tr.enc_output(vis))
        cls = contrastive_logits(mem, txt, text_token_mask, c.max_text_len)
        score = torch.where(torch.isfinite(cls), cls, -math.inf).amax(dim=-1)
        top_idx = torch.topk(score, c.num_queries, dim=1).indices  # [B, nq]
        # gen_encoder_output_proposals' anchors: grid centres, 0.05 * 2^l sizes
        wh = torch.cat([torch.full((h * w, 2), 0.05 * (2.0 ** lvl), device=dev)
                        for lvl, (h, w) in enumerate(shapes)])[None].expand(B, -1, -1)
        anchors = torch.cat([refs, wh], dim=-1)
        sel_mem = torch.gather(mem, 1, top_idx[..., None].expand(-1, -1, mem.shape[-1]))
        sel_anchor = torch.gather(anchors, 1, top_idx[..., None].expand(-1, -1, 4))
        ref_boxes = torch.sigmoid(tr.enc_out_bbox_embed(sel_mem) + inverse_sigmoid(sel_anchor))

        tgt = tr.tgt_embed.weight.to(dt)[None].expand(B, -1, -1)
        # cross-modality decoder with iterative refinement
        for layer, bbox in zip(tr.decoder.layers, self.bbox_embed):
            query_pos = tr.decoder.ref_point_head(sine_box_embed(ref_boxes, c.d_model // 2))
            tgt = layer(tgt, query_pos, ref_boxes, vis, shapes, txt, text_token_mask)
            ref_boxes = torch.sigmoid(bbox(tgt) + inverse_sigmoid(ref_boxes))
        tgt = tr.decoder.norm(tgt)
        return contrastive_logits(tgt, txt, text_token_mask, c.max_text_len), ref_boxes


@torch.no_grad()
def init_gdino_weights(model: GroundingDino, generator: torch.Generator) -> GroundingDino:
    """Random weights drawn from `generator` with flax's initializers, as
    the JAX module's `init` draws them (not the same numbers):
    `models.common.init_weights`, plus the parameters that are no Linear:
    each MHA's in_proj_weight lecun-normal per projection, level_embed
    normal(1)."""
    from cm3d_tpu_torch.models.common import init_weights

    init_weights(model, generator)
    for mod in model.modules():
        if isinstance(mod, MHA):
            d = mod.in_proj_weight.shape[1]
            std = math.sqrt(1.0 / d) / 0.87962566103423978
            nn.init.trunc_normal_(mod.in_proj_weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            mod.in_proj_bias.zero_()
    lvl = model.transformer.level_embed
    lvl.copy_(torch.randn(lvl.shape, generator=generator, device=lvl.device))
    return model


# ---------------------------------------------------------------------------
# host-side grounding contract (get_grounding_output1)


def preprocess_gdino(image_u8: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Resize (PIL bilinear) and ImageNet-normalize into the static network
    size, letterboxed top-left (the normalized output boxes refer to the
    letterboxed frame; the padding is -mean / std, as in the JAX package)."""
    from PIL import Image

    h, w = image_u8.shape[:2]
    oh, ow = out_hw
    scale = min(oh / h, ow / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    im = Image.fromarray(image_u8).resize((nw, nh), Image.BILINEAR)
    canvas = np.zeros((oh, ow, 3), np.float32)
    canvas[:nh, :nw] = np.asarray(im, np.float32) / 255.0
    canvas -= np.asarray(GDINO_PIXEL_MEAN, np.float32)
    canvas /= np.asarray(GDINO_PIXEL_STD, np.float32)
    return canvas


def encode_caption(tok: WordPieceTokenizer, caption: str, max_len: int) -> Dict[str, np.ndarray]:
    """Tokenize and build the sub-sentence masks, padded to max_len."""
    ids = tok.encode(prepare_caption(caption))[:max_len]
    arr = np.full(max_len, tok.cfg.pad_id, np.int32)
    arr[:len(ids)] = ids
    attn, pos, mask = special_token_masks(arr, tok.cfg, tok.vocab.get(".", -1))
    return {"ids": arr[None], "pos_ids": pos[None].astype(np.int32), "attn_mask": attn[None],
            "token_mask": mask[None], "n_tokens": len(ids)}


def decode_phrase(tok: WordPieceTokenizer, ids: Sequence[int], posmap: np.ndarray) -> str:
    """get_phrases_from_posmap: join the tokens whose logit cleared the text
    threshold, merging ## continuations."""
    words: List[str] = []
    for i in np.nonzero(posmap)[0]:
        piece = tok.decode_piece(int(ids[i]))
        if piece.startswith("##") and words:
            words[-1] += piece[2:]
        else:
            words.append(piece)
    return " ".join(words)


def text_inputs(enc: Dict[str, np.ndarray], n: int, device) -> tuple:
    """An encoded caption (`encode_caption`, `vocabulary_caption`) as the
    forward's four text tensors, batch n (ids and position ids int64)."""
    return tuple(torch.tensor(np.broadcast_to(enc[k], (n,) + enc[k].shape[1:]),
                              dtype=torch.int64 if k in ("ids", "pos_ids") else torch.bool,
                              device=device)
                 for k in ("ids", "pos_ids", "attn_mask", "token_mask"))


def make_ground_fn(model: GroundingDino, tok: WordPieceTokenizer):
    """ground(image_u8, caption, box_threshold, text_threshold) -> (boxes
    [N, 4] cxcywh normalized, ["phrase(score)"]): the get_grounding_output1
    contract (kitti gen_2d_masks_detic.py:192-238), on the model's device."""
    cfg = model.cfg
    device = next(model.parameters()).device

    @torch.inference_mode()
    def ground(image_u8: np.ndarray, caption: str, box_threshold: float = 0.15,
               text_threshold: float = 0.15):
        img = torch.as_tensor(preprocess_gdino(image_u8, cfg.img_hw), device=device)[None]
        enc = encode_caption(tok, caption, cfg.max_text_len)
        logits, boxes = model(img, *text_inputs(enc, 1, device))
        probs = np.nan_to_num(torch.sigmoid(logits[0]).float().cpu().numpy(), neginf=0.0)
        boxes = boxes[0].float().cpu().numpy()
        keep = probs.max(axis=1) > box_threshold
        ids = enc["ids"][0]
        phrases = [f"{decode_phrase(tok, ids, row > text_threshold)}({str(row.max())[:4]})"
                   for row in probs[keep]]
        return boxes[keep], phrases

    return ground


def caption_from_vocabulary(tok: WordPieceTokenizer, vocabulary: Sequence[str], max_len: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """The class-list caption ('syn . syn . ...', create_text_prompt in
    cfg/prompt_cfg.py:156-161) and its per-class positive map (the
    token_spans branch of get_grounding_output, kitti/gen_2d_masks_detic.py:
    419-447: a row averages its class's token span). A class that no longer
    fits under max_len gets an all-zero row. Returns (ids [max_len] int32,
    pos_map [C, max_len] f32)."""
    ids: List[int] = [tok.cfg.cls_id]
    period = tok.vocab.get(".")
    if period is None:
        raise ValueError("tokenizer vocab lacks '.'")
    spans: List[Tuple[int, int]] = []
    for cls in vocabulary:
        pieces: List[int] = []
        for w in tok._basic(cls.lower()):
            pieces.extend(tok._wordpiece(w))
        if len(ids) + len(pieces) + 2 <= max_len:  # room for '.' and [SEP]
            spans.append((len(ids), len(ids) + len(pieces)))
            ids.extend(pieces)
            ids.append(period)
        else:
            spans.append((0, 0))
    ids.append(tok.cfg.sep_id)
    arr = np.full(max_len, tok.cfg.pad_id, np.int32)
    arr[:len(ids)] = ids
    pos_map = np.zeros((len(vocabulary), max_len), np.float32)
    for c, (s, e) in enumerate(spans):
        if e > s:
            pos_map[c, s:e] = 1.0 / (e - s)
    return arr, pos_map


def vocabulary_caption(tok: WordPieceTokenizer, vocabulary: Sequence[str], max_len: int
                       ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The class-list caption encoded as `encode_caption` encodes one
    (batch 1), and its positive map [C, max_len]."""
    arr, pos_map = caption_from_vocabulary(tok, vocabulary, max_len)
    attn, pos_ids, token_mask = special_token_masks(arr, tok.cfg, tok.vocab["."])
    return {"ids": arr[None], "pos_ids": pos_ids[None], "attn_mask": attn[None],
            "token_mask": token_mask[None]}, pos_map


def make_gdino_detector(model: GroundingDino, tok: WordPieceTokenizer,
                        vocabulary: Sequence[str], max_detections: int = 128,
                        box_threshold: float = 0.15, max_batch: int = 3):
    """GroundingDINO behind the mask stage's detector contract
    (`pipelines.masks.MaskModels.detic`): frame dict -> (boxes xyxy image px
    [B, N, 4], scores [B, N], class ids [B, N], valid [B, N]), tensors on the
    model's device, queued with no host sync.

    Classification follows the reference's token_spans branch
    (logits_for_phrases = positive_map @ logits.T) over the class-list
    caption; box_threshold 0.15 as at the commented call site
    (kitti/gen_2d_masks_detic.py:697-704). The letterbox runs on the host
    (PIL) and uploads f32. A forward never carries more than `max_batch`
    images, the tail chunk padded with zero images, as the JAX detector
    chunks (its per-image numbers then come from the same batch shapes).
    `detect.model` is the model."""
    from cm3d_tpu_torch.datasets.types import to_device

    cfg = model.cfg
    device = next(model.parameters()).device
    max_detections = min(max_detections, cfg.num_queries)
    enc, pos_map = vocabulary_caption(tok, vocabulary, cfg.max_text_len)
    pos_map_t = torch.as_tensor(pos_map, device=device)
    gh, gw = cfg.img_hw
    text = {}  # batch size -> the four text tensors

    def fwd(imgs):
        n = imgs.shape[0]
        if n not in text:
            text[n] = text_inputs(enc, n, device)
        logits, boxes = model(imgs, *text[n])
        phrase = torch.einsum("bqt,ct->bqc", torch.sigmoid(logits), pos_map_t)
        scores, cids = phrase.max(dim=-1)
        top_s, top_i = torch.topk(scores, max_detections, dim=1)
        return (torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4)), top_s,
                torch.gather(cids, 1, top_i).to(torch.int32))

    @torch.inference_mode()
    def detect(frame):
        images = frame["images"]
        n_img = len(images)
        imgs = np.stack([preprocess_gdino(im, (gh, gw)) for im in images])
        scales = to_device(np.array([min(gh / im.shape[0], gw / im.shape[1])
                                     for im in images], np.float32), device)
        nb = min(max_batch, n_img)
        outs = []
        for i in range(0, n_img, nb):
            chunk = imgs[i:i + nb]
            if len(chunk) < nb:
                chunk = np.concatenate(
                    [chunk, np.zeros((nb - len(chunk),) + chunk.shape[1:], chunk.dtype)])
            outs.append(fwd(to_device(chunk, device)))
        nboxes, scores, cids = (torch.cat([o[j] for o in outs])[:n_img] for j in range(3))
        # cxcywh (normalized) -> xyxy in the original image's px, on the device
        nboxes = nboxes.float()
        cx, cy = nboxes[..., 0] * gw, nboxes[..., 1] * gh
        bw, bh = nboxes[..., 2] * gw, nboxes[..., 3] * gh
        xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                           dim=-1) / scales[:, None, None]
        scores = scores.float()
        return xyxy, scores, cids, scores > box_threshold

    detect.model = model
    return detect


# ---------------------------------------------------------------------------
# Weights


def quantize_gdino_state_dict(sd: dict) -> dict:
    """The int8 twin's state dict: the Swin backbone's MLPs int8 w8a8
    (`models.swin.quantize_swin_state_dict`), BERT, the enhancer and the
    decoder float, as the JAX package's `quantize_swin_backbone` boundary."""
    from cm3d_tpu_torch.models.swin import quantize_swin_state_dict

    return quantize_swin_state_dict(sd, prefix="backbone.0.")


@functools.lru_cache(maxsize=8)
def _module_keys(cfg: GdinoConfig) -> frozenset:
    with torch.device("meta"):
        return frozenset(GroundingDino(cfg).state_dict())


def gdino_state_dict_from_released(sd: Dict[str, torch.Tensor],
                                   cfg: GdinoConfig = GDINO_SWINT) -> Dict[str, torch.Tensor]:
    """A released GroundingDINO state dict (groundingdino_swint_ogc.pth,
    with or without the `module.` prefix) -> the port's keys: the same names,
    keeping only what the model reads, as `convert_gdino_params` reads them
    (the `transformer.decoder.bbox_embed.*` aliases of `bbox_embed.*`,
    `bert.pooler`, `bert.embeddings.position_ids` and Swin's index / mask
    buffers go). Arrays become f32 tensors."""
    keys = _module_keys(dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin,
                                                                          quant_int8=False)))
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k in keys:
            out[k] = torch.as_tensor(np.asarray(v, np.float32)) if isinstance(v, np.ndarray) \
                else v.float()
    return out


def gdino_state_dict_from_flax(params: dict, cfg: GdinoConfig = GDINO_SWINT) -> dict:
    """`cm3d_tpu.models.gdino.GroundingDino` params -> the port's state dict
    (the inverse of `convert_gdino_params`)."""
    from cm3d_tpu_torch.models.convert import _conv, _dense, _ln, _t, swin_state_dict_from_flax

    out = swin_state_dict_from_flax(params["backbone"], cfg.swin, prefix="backbone.0.")
    bert = params["bert"]
    for name, key in (("word", "word_embeddings"), ("position", "position_embeddings"),
                      ("token_type", "token_type_embeddings")):
        out[f"bert.embeddings.{key}.weight"] = _t(bert[name]["embedding"])
    _ln(out, "bert.embeddings.LayerNorm", bert["embed_ln"])
    for i in range(cfg.bert.layers):
        p, lay = f"bert.encoder.layer.{i}", bert[f"layer{i}"]
        for q in ("query", "key", "value"):
            _dense(out, f"{p}.attention.self.{q}", lay["self"][q])
        _dense(out, f"{p}.attention.output.dense", lay["attn_out"])
        _ln(out, f"{p}.attention.output.LayerNorm", lay["attn_ln"])
        _dense(out, f"{p}.intermediate.dense", lay["inter"])
        _dense(out, f"{p}.output.dense", lay["out"])
        _ln(out, f"{p}.output.LayerNorm", lay["out_ln"])

    def mha(prefix, p):
        out[f"{prefix}.in_proj_weight"] = torch.cat(
            [_t(np.asarray(p[n]["kernel"]).T) for n in ("wq", "wk", "wv")])
        out[f"{prefix}.in_proj_bias"] = torch.cat([_t(p[n]["bias"]) for n in ("wq", "wk", "wv")])
        _dense(out, f"{prefix}.out_proj", p["out"])

    def mlp(prefix, p):
        for j in range(len(p)):
            _dense(out, f"{prefix}.layers.{j}", p[f"layer{j}"])

    def dense_ln(prefix, p, dense=(), norms=()):
        for n in dense:
            _dense(out, f"{prefix}.{n}", p[n])
        for n in norms:
            _ln(out, f"{prefix}.{n}", p[n])

    deform = ("sampling_offsets", "attention_weights", "value_proj", "output_proj")
    _dense(out, "feat_map", params["feat_map"])
    for i in range(cfg.n_levels):
        _conv(out, f"input_proj.{i}.0", params[f"input_proj{i}_conv"])
        _ln(out, f"input_proj.{i}.1", params[f"input_proj{i}_gn"])
    out["transformer.level_embed"] = _t(params["level_embed"])
    _dense(out, "transformer.enc_output", params["enc_output"])
    _ln(out, "transformer.enc_output_norm", params["enc_output_norm"])
    mlp("transformer.enc_out_bbox_embed", params["enc_out_bbox_embed"])
    out["transformer.tgt_embed.weight"] = _t(params["tgt_embed"])
    mlp("transformer.decoder.ref_point_head", params["ref_point_head"])
    _ln(out, "transformer.decoder.norm", params["decoder_norm"])
    for i in range(cfg.enc_layers):
        p, lay = f"transformer.encoder.layers.{i}", params[f"enc_layer{i}"]
        dense_ln(f"{p}.self_attn", lay["self_attn"], deform)
        dense_ln(p, lay, ("linear1", "linear2"), ("norm1", "norm2"))
        p, lay = f"transformer.encoder.text_layers.{i}", params[f"text_layer{i}"]
        mha(f"{p}.self_attn", lay["self_attn"])
        dense_ln(p, lay, ("linear1", "linear2"), ("norm1", "norm2"))
        p, lay = f"transformer.encoder.fusion_layers.{i}", params[f"fusion{i}"]
        out[f"{p}.gamma_v"] = _t(lay["gamma_v"])
        out[f"{p}.gamma_l"] = _t(lay["gamma_l"])
        dense_ln(p, lay, (), ("layer_norm_v", "layer_norm_l"))
        dense_ln(f"{p}.attn", lay["attn"], ("v_proj", "l_proj", "values_v_proj",
                                            "values_l_proj", "out_v_proj", "out_l_proj"))
    for i in range(cfg.dec_layers):
        p, lay = f"transformer.decoder.layers.{i}", params[f"dec_layer{i}"]
        dense_ln(f"{p}.cross_attn", lay["cross_attn"], deform)
        mha(f"{p}.ca_text", lay["ca_text"])
        mha(f"{p}.self_attn", lay["self_attn"])
        dense_ln(p, lay, ("linear1", "linear2"), ("norm1", "norm2", "norm3", "catext_norm"))
        mlp(f"bbox_embed.{i}", params[f"bbox_embed{i}"])
    return out


def synth_gdino_state_dict(cfg: GdinoConfig, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A state dict with the released key layout and N(0, 0.05) values
    (tests, and the card's smoke run: no released checkpoint is in the
    repository). The port's copy of the JAX package's function: the same
    keys in the same order, so the same `rng` gives the same arrays."""
    sd: Dict[str, np.ndarray] = {}

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.05

    def lin(prefix, dout, din, bias=True):
        sd[f"{prefix}.weight"] = t(dout, din)
        if bias:
            sd[f"{prefix}.bias"] = t(dout)

    def ln(prefix, dim):
        sd[f"{prefix}.weight"] = 1.0 + t(dim)
        sd[f"{prefix}.bias"] = t(dim)

    def mha(prefix, dim):
        sd[f"{prefix}.in_proj_weight"] = t(3 * dim, dim)
        sd[f"{prefix}.in_proj_bias"] = t(3 * dim)
        lin(f"{prefix}.out_proj", dim, dim)

    def deform(prefix, d, H, L, P):
        lin(f"{prefix}.sampling_offsets", H * L * P * 2, d)
        lin(f"{prefix}.attention_weights", H * L * P, d)
        lin(f"{prefix}.value_proj", d, d)
        lin(f"{prefix}.output_proj", d, d)

    def mlp3(prefix, d, hidden, dout):
        lin(f"{prefix}.layers.0", hidden, d)
        lin(f"{prefix}.layers.1", hidden, hidden)
        lin(f"{prefix}.layers.2", dout, hidden)

    # swin backbone
    sw = cfg.swin
    bb = "backbone.0"
    sd[f"{bb}.patch_embed.proj.weight"] = t(sw.embed_dim, 3, sw.patch_size, sw.patch_size)
    sd[f"{bb}.patch_embed.proj.bias"] = t(sw.embed_dim)
    ln(f"{bb}.patch_embed.norm", sw.embed_dim)
    for i, depth in enumerate(sw.depths):
        dim = sw.stage_dim(i)
        for j in range(depth):
            b = f"{bb}.layers.{i}.blocks.{j}"
            ln(f"{b}.norm1", dim)
            ln(f"{b}.norm2", dim)
            sd[f"{b}.attn.relative_position_bias_table"] = t(
                (2 * sw.window_size - 1) ** 2, sw.num_heads[i])
            lin(f"{b}.attn.qkv", 3 * dim, dim)
            lin(f"{b}.attn.proj", dim, dim)
            lin(f"{b}.mlp.fc1", int(dim * sw.mlp_ratio), dim)
            lin(f"{b}.mlp.fc2", dim, int(dim * sw.mlp_ratio))
        if i < len(sw.depths) - 1:
            ln(f"{bb}.layers.{i}.downsample.norm", 4 * dim)
            sd[f"{bb}.layers.{i}.downsample.reduction.weight"] = t(2 * dim, 4 * dim)
        if i in sw.out_indices:
            ln(f"{bb}.norm{i}", dim)

    # bert
    bc = cfg.bert
    sd["bert.embeddings.word_embeddings.weight"] = t(bc.vocab_size, bc.hidden)
    sd["bert.embeddings.position_embeddings.weight"] = t(bc.max_position, bc.hidden)
    sd["bert.embeddings.token_type_embeddings.weight"] = t(bc.type_vocab, bc.hidden)
    ln("bert.embeddings.LayerNorm", bc.hidden)
    for i in range(bc.layers):
        p = f"bert.encoder.layer.{i}"
        for q in ("query", "key", "value"):
            lin(f"{p}.attention.self.{q}", bc.hidden, bc.hidden)
        lin(f"{p}.attention.output.dense", bc.hidden, bc.hidden)
        ln(f"{p}.attention.output.LayerNorm", bc.hidden)
        lin(f"{p}.intermediate.dense", bc.intermediate, bc.hidden)
        lin(f"{p}.output.dense", bc.hidden, bc.intermediate)
        ln(f"{p}.output.LayerNorm", bc.hidden)

    d = cfg.d_model
    lin("feat_map", d, bc.hidden)
    for i in range(cfg.n_levels):
        cin = (sw.stage_dim(sw.out_indices[i]) if i < len(sw.out_indices)
               else sw.stage_dim(sw.out_indices[-1]))
        k = 1 if i < len(sw.out_indices) else 3
        sd[f"input_proj.{i}.0.weight"] = t(d, cin, k, k)
        sd[f"input_proj.{i}.0.bias"] = t(d)
        ln(f"input_proj.{i}.1", d)
    sd["transformer.level_embed"] = t(cfg.n_levels, d)
    for i in range(cfg.enc_layers):
        p = f"transformer.encoder.layers.{i}"
        deform(f"{p}.self_attn", d, cfg.nheads, cfg.n_levels, cfg.n_points)
        ln(f"{p}.norm1", d)
        ln(f"{p}.norm2", d)
        lin(f"{p}.linear1", cfg.dim_feedforward, d)
        lin(f"{p}.linear2", d, cfg.dim_feedforward)
        p = f"transformer.encoder.text_layers.{i}"
        mha(f"{p}.self_attn", d)
        ln(f"{p}.norm1", d)
        ln(f"{p}.norm2", d)
        lin(f"{p}.linear1", cfg.text_ffn, d)
        lin(f"{p}.linear2", d, cfg.text_ffn)
        p = f"transformer.encoder.fusion_layers.{i}"
        sd[f"{p}.gamma_v"] = np.full(d, 1e-4, np.float32)
        sd[f"{p}.gamma_l"] = np.full(d, 1e-4, np.float32)
        ln(f"{p}.layer_norm_v", d)
        ln(f"{p}.layer_norm_l", d)
        for k in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
            lin(f"{p}.attn.{k}", cfg.fusion_dim, d)
        for k in ("out_v_proj", "out_l_proj"):
            lin(f"{p}.attn.{k}", d, cfg.fusion_dim)
    lin("transformer.enc_output", d, d)
    ln("transformer.enc_output_norm", d)
    mlp3("transformer.enc_out_bbox_embed", d, d, 4)
    sd["transformer.tgt_embed.weight"] = t(cfg.num_queries, d)
    lin("transformer.decoder.ref_point_head.layers.0", d, 2 * d)
    lin("transformer.decoder.ref_point_head.layers.1", d, d)
    ln("transformer.decoder.norm", d)
    for i in range(cfg.dec_layers):
        p = f"transformer.decoder.layers.{i}"
        deform(f"{p}.cross_attn", d, cfg.nheads, cfg.n_levels, cfg.n_points)
        mha(f"{p}.ca_text", d)
        mha(f"{p}.self_attn", d)
        for n in ("norm1", "norm2", "norm3", "catext_norm"):
            ln(f"{p}.{n}", d)
        lin(f"{p}.linear1", cfg.dim_feedforward, d)
        lin(f"{p}.linear2", d, cfg.dim_feedforward)
        mlp3(f"bbox_embed.{i}", d, d, 4)
    return sd

"""CLIP text encoder (ViT-B/32 text tower) + BPE tokenizer. Mirrors
`cm3d_tpu/models/clip_text.py`.

The reference builds Detic's open-vocabulary classifier head by embedding
"a <class>" prompts with CLIP's text encoder
(src/nuscenes/gen_2d_masks_detic.py:44-50,90-96: build_text_encoder ->
normalized 512-d embeddings, transposed into a [512, K] classifier).

Architecture (Radford et al. 2021): token embedding (49408), learned
positional embedding (77), 12 pre-LN transformer blocks (width 512, 8
heads) with causal masking, final LN, projection to 512, L2-normalized
output taken at the EOT token position (the highest token id).

Parameter names are CLIP's torch keys (`token_embedding.weight`,
`transformer.resblocks.{i}.attn.in_proj_weight`, `ln_final`,
`text_projection`, ...), so a CLIP state dict loads with only the
`text_encoder.` prefix of Detic's wrapper stripped
(`models/convert.py clip_state_dict_from_released`). Attention is plain torch ops. The
encoder runs in f32: `embed_vocabulary` is called once per run.

The byte-pair tokenizer (host Python, a copy of the JAX package's) loads
CLIP's published merges file (bpe_simple_vocab_16e6.txt.gz); tests
exercise it with a toy merge table.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import html
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512


CLIP_TEXT_B32 = ClipTextConfig()
CLIP_TEXT_TEST = ClipTextConfig(
    vocab_size=512, context_length=16, width=32, heads=2, layers=2, embed_dim=24
)


class _Attention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (fused in_proj, out_proj),
    computed with plain ops."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        # heads: this module's; a tensor-sharded copy holds heads / n of them
        # (`parallel.sharding.shard_model_params`)
        self.heads, self.head_dim = heads, width // heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        hd = self.head_dim
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        attn = (q / np.sqrt(hd)) @ k.transpose(-2, -1) + mask
        o = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(b, n, self.heads * hd)
        return self.out_proj(o)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c_fc(x)
        return self.c_proj(y * torch.sigmoid(1.702 * y))  # QuickGELU


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _Mlp(width)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads) for _ in range(cfg.layers))


class ClipTextEncoder(nn.Module):
    def __init__(self, cfg: ClipTextConfig = CLIP_TEXT_B32):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.transformer = _Transformer(cfg)
        self.ln_final = nn.LayerNorm(cfg.width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: [B, context_length] int -> normalized [B, embed_dim] f32."""
        n = self.cfg.context_length
        x = self.token_embedding(tokens.long()) + self.positional_embedding[None]
        mask = torch.full((n, n), -torch.inf, device=x.device).triu(1)
        for block in self.transformer.resblocks:
            x = block(x, mask)
        x = self.ln_final(x)
        # features at the EOT token (highest token id per sequence), in f32
        eot = tokens.long().argmax(dim=-1)
        feats = x[torch.arange(x.shape[0], device=x.device), eot].float()
        feats = feats @ self.text_projection.float()
        return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)


def init_clip_weights(model: ClipTextEncoder, generator: torch.Generator) -> ClipTextEncoder:
    """Random weights drawn from `generator` at CLIP's initial scales
    (openai/CLIP `initialize_parameters`): token embedding 0.02, positions
    0.01, attention and MLP projections width^-0.5 (the MLP's input
    (2 width)^-0.5), text projection width^-0.5; biases 0, LayerNorms 1 / 0.
    For runs without a released file."""
    w = model.cfg.width

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device) * std)

    with torch.no_grad():
        normal_(model.token_embedding.weight, 0.02)
        normal_(model.positional_embedding, 0.01)
        normal_(model.text_projection, w ** -0.5)
        for block in model.transformer.resblocks:
            normal_(block.attn.in_proj_weight, w ** -0.5)
            normal_(block.attn.out_proj.weight, w ** -0.5)
            normal_(block.mlp.c_fc.weight, (2 * w) ** -0.5)
            normal_(block.mlp.c_proj.weight, w ** -0.5)
            for bias in (block.attn.in_proj_bias, block.attn.out_proj.bias,
                         block.mlp.c_fc.bias, block.mlp.c_proj.bias):
                bias.zero_()
    return model


# ---------------------------------------------------------------------------
# Byte-pair tokenizer (CLIP's SimpleTokenizer semantics), host Python.
# ---------------------------------------------------------------------------

@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class SimpleTokenizer:
    """CLIP BPE tokenizer. merges: list of (a, b) string pairs."""

    # CLIP's pattern uses the `regex` module's \p{L} / \p{N} classes, and
    # `regex` is not a dependency; this is their ASCII equivalent, as in the
    # JAX package
    PATTERN = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]"
        r"|[^\sa-zA-Z0-9]+",
        re.IGNORECASE,
    )

    def __init__(self, merges: List[Tuple[str, str]]):
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for a, b in merges:
            vocab.append(a + b)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.cache: Dict[str, str] = {}

    @classmethod
    def from_file(cls, bpe_path: str) -> "SimpleTokenizer":
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1]]
        return cls(merges)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            a, b = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for tok in self.PATTERN.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def tokenize(self, texts: List[str], context_length: int = 77) -> np.ndarray:
        out = np.zeros((len(texts), context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


@torch.inference_mode()
def embed_vocabulary(
    model: ClipTextEncoder,
    tokenizer: SimpleTokenizer,
    vocabulary: List[str],
    prompt: str = "a ",
) -> np.ndarray:
    """[embed_dim, K] classifier matrix (reference get_clip_embeddings:44-50,
    which permutes embeddings to [dim, K]), computed on the model's device
    in f32. On the card the caller turns TF32 off (`utils.device.strict_f32`)
    first."""
    device = next(model.parameters()).device
    tokens = tokenizer.tokenize([prompt + v for v in vocabulary], model.cfg.context_length)
    emb = model.float().eval()(torch.as_tensor(tokens, device=device))
    return emb.cpu().numpy().T

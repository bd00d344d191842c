"""The port's CLIP text encoder, tokenizer and `embed_vocabulary` against
the JAX package on the CPU, at CLIP_TEXT_TEST width (vocabulary widened to
1024 so the toy tokenizer's ids, up to 517, index real rows; JAX clamps an
index past the table, torch raises).

One CLIP-layout state dict (torch keys, under Detic's `text_encoder.`
prefix) feeds both packages. Tolerances: normalized embeddings within 1e-5
absolute (f32, summation order only); token ids equal.
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cm3d_tpu.models.clip_text import ClipTextEncoder as JaxClip
from cm3d_tpu.models.clip_text import SimpleTokenizer as JaxTokenizer
from cm3d_tpu.models.clip_text import convert_clip_text_params
from cm3d_tpu.models.clip_text import embed_vocabulary as jax_embed_vocabulary
from cm3d_tpu.vocab import CUSTOM_VOCABULARY_NUSCENES, CUSTOM_VOCABULARY_WAYMO

from cm3d_tpu_torch.models.clip_text import (
    CLIP_TEXT_TEST,
    ClipTextEncoder,
    ResidualAttentionBlock,
    SimpleTokenizer,
    embed_vocabulary,
)
from cm3d_tpu_torch.models.convert import clip_state_dict_from_released, load_released_state_dict

CFG = dataclasses.replace(CLIP_TEXT_TEST, vocab_size=1024)
TOY_MERGES = [("c", "a</w>"), ("c", "ar</w>"), ("a", "r</w>"), ("ca", "r</w>"),
              ("t", "r"), ("tr", "u"), ("b", "u"), ("e", "s</w>"), ("p", "e"),
              ("r", "s"), ("o", "n</w>"), ("i", "c"), ("c", "l"), ("e", "r</w>")]


def fake_clip_sd(cfg, seed=0, prefix="text_encoder."):
    """A CLIP-layout text-tower state dict (torch keys) of random numpy
    arrays."""
    rng = np.random.default_rng(seed)
    sd = {}

    def add(name, *shape, scale=0.05):
        sd[prefix + name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    w = cfg.width
    add("token_embedding.weight", cfg.vocab_size, w, scale=0.5)
    add("positional_embedding", cfg.context_length, w, scale=0.1)
    add("text_projection", w, cfg.embed_dim, scale=w ** -0.5)
    add("ln_final.weight", w, scale=1.0)
    add("ln_final.bias", w)
    for i in range(cfg.layers):
        p = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            add(f"{p}.{ln}.weight", w, scale=1.0)
            add(f"{p}.{ln}.bias", w)
        add(f"{p}.attn.in_proj_weight", 3 * w, w, scale=w ** -0.5)
        add(f"{p}.attn.in_proj_bias", 3 * w)
        add(f"{p}.attn.out_proj.weight", w, w, scale=w ** -0.5)
        add(f"{p}.attn.out_proj.bias", w)
        add(f"{p}.mlp.c_fc.weight", 4 * w, w, scale=w ** -0.5)
        add(f"{p}.mlp.c_fc.bias", 4 * w)
        add(f"{p}.mlp.c_proj.weight", w, 4 * w, scale=(4 * w) ** -0.5)
        add(f"{p}.mlp.c_proj.bias", w)
    return sd


def write_toy_bpe(path, merges=TOY_MERGES):
    """A gzip BPE file in CLIP's layout: a header line, then one merge a
    line (no trailing newline: CLIP's reader takes every line after the
    header, up to its 48894 merges)."""
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: toy"] + [f"{a} {b}" for a, b in merges]))


def _port_encoder(sd, cfg=CFG):
    model = ClipTextEncoder(cfg)
    load_released_state_dict(model, clip_state_dict_from_released(
        {k: torch.from_numpy(v) for k, v in sd.items()}))
    return model.eval()


def test_clip_encoder_matches_jax():
    sd = fake_clip_sd(CFG)
    jax_params = convert_clip_text_params(sd, CFG)
    tok = SimpleTokenizer(TOY_MERGES)
    tokens = tok.tokenize(["a car", "a truck", "a bus", "a cyclist rides"], CFG.context_length)
    want = np.asarray(JaxClip(CFG).apply({"params": jax_params}, jnp.asarray(tokens)))
    with torch.no_grad():
        got = _port_encoder(sd)(torch.from_numpy(tokens)).numpy()
    assert got.dtype == np.float32 and got.shape == (4, CFG.embed_dim)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)


def test_attention_block_matches_torch_multihead_attention():
    """CLIP's block is torch's MultiheadAttention + QuickGELU MLP; the
    port's plain-op block reads the same parameters."""
    width, heads, n, b = 32, 4, 7, 2
    torch.manual_seed(0)
    blk = ResidualAttentionBlock(width, heads)
    for prm in blk.parameters():
        prm.data.normal_(0, 0.2)
    mha = torch.nn.MultiheadAttention(width, heads)
    mha.in_proj_weight.data.copy_(blk.attn.in_proj_weight)
    mha.in_proj_bias.data.copy_(blk.attn.in_proj_bias)
    mha.out_proj.load_state_dict(blk.attn.out_proj.state_dict())
    x = torch.randn(b, n, width)
    mask = torch.full((n, n), -torch.inf).triu(1)
    with torch.no_grad():
        y = blk.ln_1(x).transpose(0, 1)
        h = x + mha(y, y, y, need_weights=False, attn_mask=mask)[0].transpose(0, 1)
        want = h + blk.mlp(blk.ln_2(h))
        got = blk(x, mask)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("words", [
    ["ca car", "car", "a ca", "trucks and cars!", "12 people"],
    list(CUSTOM_VOCABULARY_NUSCENES),
    list(CUSTOM_VOCABULARY_WAYMO),
], ids=["toy", "nuscenes", "waymo"])
def test_tokenizer_matches_jax(words):
    got = SimpleTokenizer(TOY_MERGES).tokenize(["a " + w for w in words], 77)
    want = JaxTokenizer(TOY_MERGES).tokenize(["a " + w for w in words], 77)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == SimpleTokenizer(TOY_MERGES).sot).all()


def test_tokenizer_reads_a_gzip_bpe_file(tmp_path):
    write_toy_bpe(tmp_path / "bpe.txt.gz")
    tok = SimpleTokenizer.from_file(str(tmp_path / "bpe.txt.gz"))
    assert tok.bpe_ranks == SimpleTokenizer(TOY_MERGES).bpe_ranks
    ids = tok.encode("ca car")
    assert tok.encoder["ca</w>"] in ids and tok.encoder["car</w>"] in ids
    np.testing.assert_array_equal(
        tok.tokenize(list(CUSTOM_VOCABULARY_WAYMO), 16),
        JaxTokenizer.from_file(str(tmp_path / "bpe.txt.gz")).tokenize(
            list(CUSTOM_VOCABULARY_WAYMO), 16))


def test_embed_vocabulary_matches_jax():
    sd = fake_clip_sd(CFG, seed=3)
    vocab = list(CUSTOM_VOCABULARY_NUSCENES)
    want = jax_embed_vocabulary(convert_clip_text_params(sd, CFG), JaxTokenizer(TOY_MERGES),
                                vocab, cfg=CFG)
    got = embed_vocabulary(_port_encoder(sd), SimpleTokenizer(TOY_MERGES), vocab)
    assert got.shape == (CFG.embed_dim, len(vocab))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=0), 1.0, atol=1e-6)

"""The port's GroundingDINO (cm3d_tpu_torch/models/gdino.py) against the
JAX package's on the CPU, at GDINO_TEST size, f32 unless a test says bf16.

Weights: `synth_gdino_state_dict` (the released key layout, N(0, 0.05)),
with the fusion layers' layer-scale gammas redrawn from N(0, 0.5): at the
released init of 1e-4 the image <-> text fusion adds next to nothing, so a
wrong BiAttention would pass. JAX's params come from `convert_gdino_params`,
the port's from `gdino_state_dict_from_released` (or, in the module tests,
from `gdino_state_dict_from_flax`). Inputs are drawn with numpy from seeds.

Tolerances: atol 2e-5 for BERT and MSDeformAttn, as tests/test_gdino.py
holds them against transformers and grid_sample; 2e-5 for the fusion,
encoder and decoder layers; the whole forward's logits within 2e-5 of
their largest |value| and boxes within 2e-6 (f32 summation order through
the Swin, 2 + 2 layers and the selection); the detector's boxes within
1e-3 image px, scores 1e-6, class ids and valid equal. Top-k ties:
torch.topk and jax.lax.top_k may order tied scores differently, so the
tests check that the scores they select from hold no near tie (the query
selection's, at least 1e-4 apart; the detector's, all distinct) and then
compare the selections as sequences; the bf16 test, where rounding does
reorder near-tied queries, matches queries by their boxes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.models import gdino as jg

from cm3d_tpu_torch.models import gdino as tg

RNG_SEED = 0
SYN_VOCAB = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, ".": 4, "car": 5, "push": 6,
             "##bike": 7, "bike": 8, "traffic": 9, "cone": 10, "tree": 11, "fire": 12,
             "##truck": 13, "?": 14}
SYN_BERT = dict(pad_id=0, unk_id=1, cls_id=2, sep_id=3)
CLASSES = ("car", "push bike", "traffic cone", "firetruck", "tree", "bike")


def _jcfg(dtype="float32"):
    c = jg.GDINO_TEST
    return dataclasses.replace(c, dtype=dtype, bert=dataclasses.replace(c.bert, **SYN_BERT),
                               swin=dataclasses.replace(c.swin, dtype=dtype))


def _tcfg(dtype="float32", quant_int8=False):
    return tg.gdino_config(tg.GDINO_TEST, dtype, quant_int8, **SYN_BERT)


def _synth(seed=RNG_SEED):
    rng = np.random.default_rng(seed)
    sd = tg.synth_gdino_state_dict(tg.GDINO_TEST, rng)
    for k in sd:
        if k.endswith((".gamma_v", ".gamma_l")):
            sd[k] = (rng.standard_normal(sd[k].shape) * 0.5).astype(np.float32)
    return sd


def _port(sd, dtype="float32"):
    cfg = _tcfg(dtype)
    m = tg.GroundingDino(cfg)
    m.load_state_dict(tg.gdino_state_dict_from_released(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg))
    return m.eval()


def _text(n, rng):
    """n captions' text inputs from the synthetic vocabulary: ids, per-phrase
    positions, phrase masks, token masks (numpy)."""
    tok = jg.WordPieceTokenizer(SYN_VOCAB, _jcfg().bert)
    L = tg.GDINO_TEST.max_text_len
    caps = ["car . push bike . tree", "fire truck. traffic cone . bikes"]
    encs = [jg.encode_caption(tok, caps[i % 2] + " ." * int(rng.integers(0, 3)), L)
            for i in range(n)]
    return tuple(np.concatenate([e[k] for e in encs])
                 for k in ("ids", "pos_ids", "attn_mask", "token_mask"))


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind in "iu" else a)


@pytest.fixture(scope="module")
def case():
    """Synthetic weights, a 2-image input with two captions, and JAX's
    forward of it."""
    sd = _synth()
    params = jax.tree.map(jnp.asarray, jg.convert_gdino_params(sd, _jcfg()))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *tg.GDINO_TEST.img_hw, 3)).astype(np.float32)
    text = _text(2, rng)
    logits, boxes = jax.jit(jg.GroundingDino(_jcfg()).apply)({"params": params}, x, *text)
    return {"sd": sd, "params": params, "x": x, "text": text, "logits": np.asarray(logits),
            "boxes": np.asarray(boxes)}


@pytest.mark.parametrize("caption", [
    "car . push bike . tree", "Pushbike, FIRETRUCK?", "unknownword car", "", "tree.tree .",
])
def test_tokenizer_and_caption_masks_equal_jax(caption):
    tok_j = jg.WordPieceTokenizer(SYN_VOCAB, _jcfg().bert)
    tok_t = tg.WordPieceTokenizer(SYN_VOCAB, _tcfg().bert)
    assert tg.prepare_caption(caption) == jg.prepare_caption(caption)
    assert tok_t.encode(caption) == tok_j.encode(caption)
    for max_len in (24, 6):
        want, got = jg.encode_caption(tok_j, caption, max_len), tg.encode_caption(
            tok_t, caption, max_len)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        row = np.zeros(max_len, bool)
        row[1:4] = True
        assert tg.decode_phrase(tok_t, got["ids"][0], row) == jg.decode_phrase(
            tok_j, want["ids"][0], row)


@pytest.mark.parametrize("max_len", [24, 9])
def test_caption_from_vocabulary_equals_jax(max_len):
    """The class-list caption and its positive map; at 9 tokens the later
    classes no longer fit and get zero rows."""
    tok_j = jg.WordPieceTokenizer(SYN_VOCAB, _jcfg().bert)
    tok_t = tg.WordPieceTokenizer(SYN_VOCAB, _tcfg().bert)
    want = jg.caption_from_vocabulary(tok_j, CLASSES, max_len)
    got = tg.caption_from_vocabulary(tok_t, CLASSES, max_len)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    masks_w = jg.special_token_masks(want[0], tok_j.cfg, 4)
    masks_t = tg.special_token_masks(got[0], tok_t.cfg, 4)
    for g, w in zip(masks_t, masks_w):
        np.testing.assert_array_equal(g, w)


def test_position_encodings_match_jax():
    for h, w, d in ((16, 24, 16), (25, 38, 256)):
        np.testing.assert_array_equal(tg.sine_position_hw(h, w, d), jg.sine_position_hw(h, w, d))
    boxes = np.random.default_rng(2).random((3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(tg.sine_box_embed(torch.from_numpy(boxes), 8).numpy(),
                               np.asarray(jg.sine_box_embed(jnp.asarray(boxes), 8)), atol=1e-6)
    np.testing.assert_allclose(tg.inverse_sigmoid(torch.from_numpy(boxes)).numpy(),
                               np.asarray(jg.inverse_sigmoid(jnp.asarray(boxes))), atol=1e-6)


def _sub(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _port_sd(case):
    return tg.gdino_state_dict_from_flax(jax.tree.map(np.asarray, case["params"]), _tcfg())


def test_bert_matches_jax(case):
    sd = _port_sd(case)
    bert = tg.BertEncoder(_tcfg().bert)
    bert.load_state_dict(_sub(sd, "bert."))
    ids, pos, am, _ = case["text"]
    want = jg.BertEncoder(_jcfg().bert, jnp.float32).apply(
        {"params": case["params"]["bert"]}, ids, pos, am)
    with torch.no_grad():
        got = bert(_t(ids), _t(pos), _t(am))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeform_attn_matches_jax(case, ref_dim):
    """2-d reference points (the encoder's grid centres) and 4-d boxes (the
    decoder's), some of them sampling outside the maps."""
    c = tg.GDINO_TEST
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    name, jname = (("transformer.encoder.layers.0.self_attn.", "enc_layer0") if ref_dim == 2
                   else ("transformer.decoder.layers.0.cross_attn.", "dec_layer0"))
    attn = tg.MSDeformAttn(c.d_model, c.nheads, c.n_levels, c.n_points, torch.float32)
    attn.load_state_dict(_sub(_port_sd(case), name))
    rng = np.random.default_rng(3)
    lm = sum(h * w for h, w in shapes)
    q = rng.standard_normal((2, 7, c.d_model)).astype(np.float32) * 3
    mem = rng.standard_normal((2, lm, c.d_model)).astype(np.float32)
    refs = rng.uniform(-0.1, 1.1, (2, 7, ref_dim)).astype(np.float32)
    jparams = case["params"][jname]["self_attn" if ref_dim == 2 else "cross_attn"]
    want = jg.MSDeformAttn(c.d_model, c.nheads, c.n_levels, c.n_points, jnp.float32).apply(
        {"params": jparams}, q, refs, mem, shapes)
    with torch.no_grad():
        got = attn(_t(q), _t(refs), _t(mem), shapes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("layer", ["fusion", "text", "encoder", "decoder"])
def test_layers_match_jax(case, layer):
    c, jc = _tcfg(), _jcfg()
    sd = _port_sd(case)
    rng = np.random.default_rng(4)
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    lm, nq, lt = sum(h * w for h, w in shapes), c.num_queries, c.max_text_len
    vis = rng.standard_normal((2, lm, c.d_model)).astype(np.float32)
    txt = rng.standard_normal((2, lt, c.d_model)).astype(np.float32)
    _, _, am, tm = case["text"]
    f32 = jnp.float32
    if layer == "fusion":
        mod, jmod = tg.FusionLayer(c, torch.float32), jg.FusionLayer(jc, f32)
        prefix, jp, args = "transformer.encoder.fusion_layers.1.", "fusion1", (vis, txt, tm)
    elif layer == "text":
        mod, jmod = tg.TextSelfAttnLayer(c, torch.float32), jg.TextSelfAttnLayer(jc, f32)
        prefix, jp = "transformer.encoder.text_layers.1.", "text_layer1"
        args = (txt, rng.standard_normal(txt.shape).astype(np.float32), am)
    elif layer == "encoder":
        mod, jmod = tg.DeformableEncoderLayer(c, torch.float32), jg.DeformableEncoderLayer(jc, f32)
        prefix, jp = "transformer.encoder.layers.1.", "enc_layer1"
        args = (vis, rng.standard_normal(vis.shape).astype(np.float32),
                rng.random((2, lm, 2)).astype(np.float32), shapes)
    else:
        mod, jmod = tg.DecoderLayer(c, torch.float32), jg.DecoderLayer(jc, f32)
        prefix, jp = "transformer.decoder.layers.1.", "dec_layer1"
        boxes = np.concatenate([rng.random((2, nq, 2)), rng.uniform(0.05, 0.5, (2, nq, 2))], -1)
        args = (rng.standard_normal((2, nq, c.d_model)).astype(np.float32),
                rng.standard_normal((2, nq, c.d_model)).astype(np.float32),
                boxes.astype(np.float32), vis, shapes, txt, tm)
    mod.load_state_dict(_sub(sd, prefix))
    want = jmod.apply({"params": case["params"][jp]}, *args)
    with torch.no_grad():
        got = mod(*(a if isinstance(a, list) else _t(a) for a in args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def _assert_forward(got_logits, got_boxes, case):
    want = case["logits"]
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got_logits), fin)
    assert fin.any() and (~fin).any()  # pad tokens and the -inf tail
    np.testing.assert_allclose(got_logits[fin], want[fin], atol=2e-5 * np.abs(want[fin]).max())
    np.testing.assert_allclose(got_boxes, case["boxes"], atol=2e-6)


@pytest.mark.parametrize("source", ["flax", "released"])
def test_forward_matches_jax(case, source):
    """The whole forward, from JAX's params carried (`flax`) and from the
    released layout (`released`: `module.` prefixes, the decoder's
    bbox_embed aliases and bert.pooler, which the conversion drops) -- the
    same tensors either way."""
    cfg = _tcfg()
    if source == "flax":
        model = tg.GroundingDino(cfg)
        model.load_state_dict(_port_sd(case))
    else:
        sd = {f"module.{k}": torch.from_numpy(v) for k, v in case["sd"].items()}
        for i in range(cfg.dec_layers):
            for k, v in list(sd.items()):
                if k.startswith(f"module.bbox_embed.{i}."):
                    sd[k.replace("module.", "module.transformer.decoder.")] = v
        sd["module.bert.pooler.dense.weight"] = torch.zeros(16, 16)
        conv = tg.gdino_state_dict_from_released(sd, cfg)
        flax = _port_sd(case)
        assert set(conv) == set(flax)
        assert all(torch.equal(conv[k], flax[k]) for k in conv)
        model = tg.GroundingDino(cfg)
        model.load_state_dict(conv)
    ids, pos, am, tm = case["text"]
    seen = {}
    tr = model.transformer
    hooks = [tr.enc_output_norm.register_forward_hook(lambda m, i, o: seen.update(mem=o)),
             tr.encoder.text_layers[-1].register_forward_hook(
                 lambda m, i, o: seen.update(txt=o))]
    with torch.no_grad():
        logits, boxes = model.eval()(_t(case["x"]), _t(ids), _t(pos), _t(am), _t(tm))
    for h in hooks:
        h.remove()
    # the query selection's top num_queries + 1 scores hold no near tie, so
    # torch.topk and jax.lax.top_k select the same tokens in the same order
    score = tg.contrastive_logits(seen["mem"], seen["txt"], _t(tm), cfg.max_text_len)
    top = torch.sort(score.amax(-1), dim=1, descending=True).values[:, :cfg.num_queries + 1]
    assert float((top[:, :-1] - top[:, 1:]).min()) > 1e-4
    _assert_forward(logits.numpy(), boxes.numpy(), case)


def test_c7_c8_extra_level_padding_and_group_norm_eps_copied():
    """ROADMAP C7 / C8, reference faults copied on purpose: the extra
    level's stride-2 3x3 conv pads like flax's SAME -- at the 25 x 38 map
    of GDINO_SWINT H (1, 1) and W (0, 1), where the released model pads
    (1, 1) -- and the input projections' GroupNorm uses flax's eps 1e-6
    (the released model torch's 1e-5)."""
    import flax.linen as nn

    model = tg.GroundingDino(_tcfg())
    conv = model.input_proj[3][0]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 25, 38, conv.in_channels)).astype(np.float32)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(rng.standard_normal(conv.weight.shape)
                                           .astype(np.float32)))
        got = conv(_t(x)).numpy()
        xt = _t(x).permute(0, 3, 1, 2)
        same = torch.nn.functional.conv2d(torch.nn.functional.pad(xt, (0, 1, 1, 1)),
                                          conv.weight, conv.bias, stride=2)
        released = torch.nn.functional.conv2d(xt, conv.weight, conv.bias, stride=2, padding=1)
    assert got.shape == (1, 13, 19, conv.out_channels)
    np.testing.assert_allclose(got, same.permute(0, 2, 3, 1).numpy(), atol=1e-5)
    assert np.abs(got - released.permute(0, 2, 3, 1).numpy()).max() > 0.1
    flax_conv = nn.Conv(conv.out_channels, (3, 3), strides=(2, 2))
    kernel = np.transpose(conv.weight.detach().numpy(), (2, 3, 1, 0))
    want = flax_conv.apply({"params": {"kernel": kernel, "bias": conv.bias.detach().numpy()}}, x)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    eps = {model.input_proj[i][1].eps for i in range(4)}
    assert eps == {nn.GroupNorm().epsilon} == {1e-6}


def _detector_pair(case, dtype="float32", max_batch=3):
    tok_j = jg.WordPieceTokenizer(SYN_VOCAB, _jcfg(dtype).bert)
    tok_t = tg.WordPieceTokenizer(SYN_VOCAB, _tcfg(dtype).bert)
    jdet = jg.make_gdino_detector(jg.GroundingDino(_jcfg(dtype)), case["params"], tok_j,
                                  CLASSES, box_threshold=0.2, max_batch=max_batch)
    tdet = tg.make_gdino_detector(_port(case["sd"], dtype), tok_t, CLASSES,
                                  box_threshold=0.2, max_batch=max_batch)
    return jdet, tdet


def _images(n, seed=6):
    rng = np.random.default_rng(seed)
    sizes = [(48, 64), (64, 96), (90, 80), (30, 100), (64, 64)]
    return [rng.integers(0, 255, (*sizes[i % 5], 3)).astype(np.uint8) for i in range(n)]


@pytest.mark.parametrize("max_batch", [3, 8])
def test_detector_matches_jax(case, max_batch):
    """make_gdino_detector on 5 images of 5 sizes: chunks of 3 (the tail
    padded, JAX's default) and one unchunked call."""
    jdet, tdet = _detector_pair(case, max_batch=max_batch)
    frame = {"images": _images(5)}
    want = [np.asarray(a) for a in jdet(frame)]
    got = [a.numpy() for a in tdet(frame)]
    assert all(len(np.unique(s)) == len(s) for s in want[1])  # no tied scores
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert 0 < want[3].sum() < want[3].size
    assert got[2].dtype == np.int32 and got[3].dtype == bool


def test_ground_contract_matches_jax(case):
    """make_ground_fn: the same kept boxes and 'phrase(score)' strings."""
    tok_j = jg.WordPieceTokenizer(SYN_VOCAB, _jcfg().bert)
    tok_t = tg.WordPieceTokenizer(SYN_VOCAB, _tcfg().bert)
    jground = jg.make_ground_fn(jg.GroundingDino(_jcfg()), case["params"], tok_j)
    tground = tg.make_ground_fn(_port(case["sd"]), tok_t)
    img = _images(1, seed=8)[0]
    for thr in (0.3, 1.1):
        wb, wp = jground(img, "car . push bike", box_threshold=thr, text_threshold=0.3)
        gb, gp = tground(img, "car . push bike", box_threshold=thr, text_threshold=0.3)
        np.testing.assert_allclose(gb, wb, atol=2e-6)
        assert [p.split("(")[0] for p in gp] == [p.split("(")[0] for p in wp]
    assert len(wb) == 0 and len(tground(img, "car", box_threshold=0.0)[0]) == 12


def test_detector_bf16_close_to_jax_bf16(case):
    """bf16 (--gdino_bf16) against JAX's bf16 on the same weights: JAX runs
    its Swin unfused in bf16 (a TPU compile workaround), the port the fused
    branch (its plain version here); both round at other places. Queries
    whose selection scores lie within a rounding of each other come out in
    either order (seen: two adjacent queries swapped, as they are between
    JAX's own f32 and bf16 runs), so each of the port's queries is matched
    to JAX's query with the nearest box: the match is one to one and leaves
    all but at most two queries in place, boxes within 0.01 (seen: 1.6e-3),
    the logits of the queries in place within 0.02 of their largest |value|
    (seen: 3e-3); the detector's sorted top-8 scores within 0.03."""
    jmodel = jg.GroundingDino(_jcfg("bfloat16"))
    ids, pos, am, tm = case["text"]
    jl, jb = jax.jit(jmodel.apply)({"params": case["params"]}, case["x"], *case["text"])
    with torch.no_grad():
        tl, tb = _port(case["sd"], "bfloat16")(_t(case["x"]), _t(ids), _t(pos), _t(am), _t(tm))
    jl, jb = np.asarray(jl, np.float32), np.asarray(jb, np.float32)
    tl, tb = tl.numpy(), tb.numpy()
    for b in range(jb.shape[0]):
        match = np.abs(tb[b][:, None] - jb[b][None]).max(-1).argmin(1)
        assert sorted(match) == list(range(jb.shape[1]))
        np.testing.assert_allclose(tb[b], jb[b][match], atol=0.01)
        # a query slot's decoder embedding is its own: a swapped pair's logits
        # differ, so the logits are held on the slots that kept their query
        same = match == np.arange(len(match))
        assert same.sum() >= len(same) - 2
        fin = np.isfinite(jl[b])
        np.testing.assert_array_equal(np.isfinite(tl[b]), fin)
        got, want = tl[b][same][fin[same]], jl[b][same][fin[same]]
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max()
    jdet, tdet = _detector_pair(case, "bfloat16")
    frame = {"images": _images(2)}
    s_j = np.sort(np.asarray(jdet(frame)[1]), axis=1)[:, ::-1][:, :8]
    s_t = np.sort(tdet(frame)[1].numpy(), axis=1)[:, ::-1][:, :8]
    np.testing.assert_allclose(s_t, s_j, atol=0.03)

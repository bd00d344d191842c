"""Released-checkpoint loading into the port (Detic, SAM, CLIP) on the CPU.

Fake released files are written with `torch.save` (detectron2's
{"model": ..., "iteration": ...} for Detic, plain state dicts for SAM and
CLIP) at DETIC_TEST / SAM_TEST / CLIP_TEXT_TEST sizes, and the same arrays
go through the JAX package's converters. Tolerances as in
tests/test_torch_models.py and tests/test_torch_sam.py: boxes within 1e-4 px,
scores within 1e-5, classes / valid flags equal; SAM embeddings and logits
within 1e-5 of their largest magnitude (f32, summation order only).

The one recorded divergence from the JAX package: detectron2 flattens the
pooled ROI features as (c, y, x), the port's box head as (y, x, c), so the
port permutes fc1's input axis on load (`fc1_from_detectron2`); the JAX
converter does not. The JAX reference here gets that permutation applied to
its converted tree in this test only.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from cm3d_tpu.models.convert_detic import convert_detic_params
from cm3d_tpu.models.convert_sam import convert_sam_params
from cm3d_tpu.models.detic import DETIC_TEST as JAX_DETIC_TEST
from cm3d_tpu.models.detic import Detic as JaxDetic
from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu.models.sam import Sam as JaxSam
from test_sam import _fake_torch_sd as fake_sam_sd
from test_torch_clip_text import TOY_MERGES, fake_clip_sd, write_toy_bpe

from cm3d_tpu_torch.models import clip_text
from cm3d_tpu_torch.models import detic as detic_mod
from cm3d_tpu_torch.models.checkpoints import load_released_checkpoint, save_params
from cm3d_tpu_torch.models.convert import (
    detic_state_dict_from_released,
    fc1_from_detectron2,
    load_released_state_dict,
    load_torch_state_dict,
    released_report,
)
from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
from cm3d_tpu_torch.models.sam import SAM_PRESETS, SAM_TEST, Sam, sam_config_for
from cm3d_tpu_torch.models.verify_convert import (
    activation_stats,
    has_problems,
    verify_clip,
    verify_detic,
    verify_sam,
    verify_zoe,
)
from cm3d_tpu_torch.pipelines import masks

# the classifier's width is Detic's embedding width
CLIP_CFG = dataclasses.replace(clip_text.CLIP_TEXT_TEST, vocab_size=1024,
                               embed_dim=DETIC_TEST.embed_dim)


def _fake_detic_sd(cfg):
    """A detectron2-layout Detic state dict (copied from
    tests/test_convert_detic.py, whose module is marked slow)."""
    sd = {}
    r = np.random.default_rng(0)

    def add(name, *shape):
        sd[name] = (r.standard_normal(shape) * 0.02).astype(np.float32)

    swin = cfg.swin
    p = "backbone.bottom_up."
    add(f"{p}patch_embed.proj.weight", swin.embed_dim, 3, 4, 4)
    add(f"{p}patch_embed.proj.bias", swin.embed_dim)
    add(f"{p}patch_embed.norm.weight", swin.embed_dim)
    add(f"{p}patch_embed.norm.bias", swin.embed_dim)
    for i, depth in enumerate(swin.depths):
        d = swin.stage_dim(i)
        for j in range(depth):
            b = f"{p}layers.{i}.blocks.{j}"
            for n in ("norm1", "norm2"):
                add(f"{b}.{n}.weight", d)
                add(f"{b}.{n}.bias", d)
            add(f"{b}.attn.qkv.weight", 3 * d, d)
            add(f"{b}.attn.qkv.bias", 3 * d)
            add(f"{b}.attn.proj.weight", d, d)
            add(f"{b}.attn.proj.bias", d)
            add(f"{b}.attn.relative_position_bias_table",
                (2 * swin.window_size - 1) ** 2, swin.num_heads[i])
            add(f"{b}.mlp.fc1.weight", 4 * d, d)
            add(f"{b}.mlp.fc1.bias", 4 * d)
            add(f"{b}.mlp.fc2.weight", d, 4 * d)
            add(f"{b}.mlp.fc2.bias", d)
        if i < len(swin.depths) - 1:
            add(f"{p}layers.{i}.downsample.norm.weight", 4 * d)
            add(f"{p}layers.{i}.downsample.norm.bias", 4 * d)
            add(f"{p}layers.{i}.downsample.reduction.weight", 2 * d, 4 * d)
        if i in swin.out_indices:
            add(f"{p}norm{i}.weight", d)
            add(f"{p}norm{i}.bias", d)

    n_ins = len(swin.out_indices)
    for i in range(n_ins):
        lvl = 3 + i
        din = swin.stage_dim(swin.out_indices[i])
        add(f"backbone.fpn_lateral{lvl}.weight", cfg.fpn_dim, din, 1, 1)
        add(f"backbone.fpn_lateral{lvl}.bias", cfg.fpn_dim)
        add(f"backbone.fpn_output{lvl}.weight", cfg.fpn_dim, cfg.fpn_dim, 3, 3)
        add(f"backbone.fpn_output{lvl}.bias", cfg.fpn_dim)
    for j in range(len(cfg.strides) - n_ins):
        nm = ["p6", "p7"][j]
        add(f"backbone.top_block.{nm}.weight", cfg.fpn_dim, cfg.fpn_dim, 3, 3)
        add(f"backbone.top_block.{nm}.bias", cfg.fpn_dim)

    hp = "proposal_generator.centernet_head"
    for i in range(cfg.num_head_convs):
        for tower in ("share_tower", "bbox_tower"):
            add(f"{hp}.{tower}.{3*i}.weight", cfg.fpn_dim, cfg.fpn_dim, 3, 3)
            add(f"{hp}.{tower}.{3*i}.bias", cfg.fpn_dim)
            add(f"{hp}.{tower}.{3*i+1}.weight", cfg.fpn_dim)
            add(f"{hp}.{tower}.{3*i+1}.bias", cfg.fpn_dim)
    add(f"{hp}.agn_hm.weight", 1, cfg.fpn_dim, 3, 3)
    add(f"{hp}.agn_hm.bias", 1)
    add(f"{hp}.bbox_pred.weight", 4, cfg.fpn_dim, 3, 3)
    add(f"{hp}.bbox_pred.bias", 4)
    for li in range(len(cfg.strides)):
        sd[f"{hp}.scales.{li}.scale"] = np.ones(1, np.float32)

    pooled = cfg.fpn_dim * cfg.pooler_size * cfg.pooler_size
    for k in range(cfg.num_cascade_stages):
        add(f"roi_heads.box_head.{k}.fc1.weight", cfg.fc_dim, pooled)
        add(f"roi_heads.box_head.{k}.fc1.bias", cfg.fc_dim)
        add(f"roi_heads.box_head.{k}.fc2.weight", cfg.fc_dim, cfg.fc_dim)
        add(f"roi_heads.box_head.{k}.fc2.bias", cfg.fc_dim)
        add(f"roi_heads.box_predictor.{k}.cls_score.linear.weight",
            cfg.embed_dim, cfg.fc_dim)
        add(f"roi_heads.box_predictor.{k}.cls_score.linear.bias", cfg.embed_dim)
        add(f"roi_heads.box_predictor.{k}.bbox_pred.0.weight", cfg.fc_dim, cfg.fc_dim)
        add(f"roi_heads.box_predictor.{k}.bbox_pred.0.bias", cfg.fc_dim)
        add(f"roi_heads.box_predictor.{k}.bbox_pred.2.weight", 4, cfg.fc_dim)
        add(f"roi_heads.box_predictor.{k}.bbox_pred.2.bias", 4)
    return sd


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _save_detectron2(sd, path):
    """What a detectron2 checkpointer writes: the weights under "model",
    trainer state beside them, Swin's index buffers among the weights."""
    model = _tensors(sd)
    model["backbone.bottom_up.layers.0.blocks.0.attn.relative_position_index"] = \
        torch.zeros(4, 4, dtype=torch.int64)
    torch.save({"model": model, "iteration": 90000}, path)


def _jax_detic_params_detectron2_order(sd, cfg):
    """convert_detic_params(sd) with each fc1 kernel's input rows permuted
    from (c, y, x) to the JAX box head's (y, x, c) flatten: what the JAX
    converter leaves out (here only, to give the reference the released
    semantics)."""
    params = convert_detic_params(sd, cfg)
    c, p = cfg.fpn_dim, cfg.pooler_size
    for k in range(cfg.num_cascade_stages):
        fc1 = params[f"cascade{k}"]["fc1"]
        kern = fc1["kernel"]
        fc1["kernel"] = np.ascontiguousarray(
            kern.reshape(c, p, p, -1).transpose(1, 2, 0, 3).reshape(kern.shape))
    return params


@pytest.fixture(scope="module")
def detic_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "detic.pth"
    sd = _fake_detic_sd(DETIC_TEST)
    _save_detectron2(sd, path)
    return str(path), sd


def _port_detic(path):
    model = Detic(DETIC_TEST)
    load_released_state_dict(model, detic_state_dict_from_released(
        load_torch_state_dict(path), DETIC_TEST), verbose=False)
    return model.eval()


def test_detic_from_a_released_file_matches_jax(detic_file):
    path, sd = detic_file
    rng = np.random.default_rng(5)
    clf = rng.standard_normal((DETIC_TEST.embed_dim, 19)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    images = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    true_hw = np.array([[60, 90], [64, 70]], np.int32)
    params = _jax_detic_params_detectron2_order(sd, JAX_DETIC_TEST)
    apply = jax.jit(JaxDetic(JAX_DETIC_TEST).apply)
    with torch.no_grad():
        got = _port_detic(path)(torch.from_numpy(images), torch.from_numpy(clf),
                                torch.from_numpy(true_hw))
    for i in range(2):
        want = apply({"params": params}, images[i], clf, true_hw[i])
        s = np.asarray(want.scores)
        assert np.abs(s - JAX_DETIC_TEST.score_thresh).min() > 1e-5
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes[i].numpy(), np.asarray(want.classes))
        np.testing.assert_allclose(got.boxes[i].numpy(), np.asarray(want.boxes), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got.scores[i].numpy(), s, rtol=0, atol=1e-5)


def test_fc1_permutation_equals_a_detectron2_flatten(detic_file):
    """The loaded box head on pooled [R, P, P, C] features equals
    detectron2's: fc1 on torch.flatten of the (c, y, x) features."""
    path, sd = detic_file
    head = _port_detic(path).roi_heads.box_head[0]
    w1 = torch.from_numpy(sd["roi_heads.box_head.0.fc1.weight"])
    b1 = torch.from_numpy(sd["roi_heads.box_head.0.fc1.bias"])
    w2 = torch.from_numpy(sd["roi_heads.box_head.0.fc2.weight"])
    b2 = torch.from_numpy(sd["roi_heads.box_head.0.fc2.bias"])
    p, c = DETIC_TEST.pooler_size, DETIC_TEST.fpn_dim
    pooled = torch.randn(2, 5, p, p, c, generator=torch.Generator().manual_seed(0))
    chw = torch.flatten(pooled.permute(0, 1, 4, 2, 3), start_dim=2)  # (c, y, x)
    want = torch.relu(torch.relu(chw @ w1.T + b1) @ w2.T + b2)
    with torch.no_grad():
        got = head(pooled)
        direct = pooled.reshape(2, 5, -1) @ fc1_from_detectron2(w1, c, p).T + b1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(direct, chw @ w1.T + b1, rtol=1e-5, atol=1e-5)
    # and the permutation moves something: the unpermuted weight disagrees
    assert not torch.allclose(pooled.reshape(2, 5, -1) @ w1.T, chw @ w1.T, atol=1e-3)


def test_sam_from_a_released_file_matches_jax(tmp_path):
    sd = fake_sam_sd(JAX_SAM_TEST)
    torch.save(_tensors(sd), tmp_path / "sam.pth")
    model = Sam(SAM_TEST)
    rep = load_released_state_dict(model, load_torch_state_dict(str(tmp_path / "sam.pth")))
    assert rep == {"missing": [], "extra": [], "mismatched": []}
    params = convert_sam_params(sd, JAX_SAM_TEST)
    jax_model = JaxSam(JAX_SAM_TEST)
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    want_emb = np.asarray(jax_model.apply({"params": params}, x,
                                          method=jax_model.encode_image))
    boxes = np.array([[3, 4, 40, 30], [10, 10, 30, 20]], np.float32)
    want_lg, want_iou = jax_model.apply({"params": params}, want_emb[0], boxes,
                                        method=jax_model.decode_boxes)
    with torch.no_grad():
        emb = model.eval().encode_image(torch.from_numpy(x)).numpy()
        lg, iou = model.decode_boxes(torch.from_numpy(want_emb[0]), torch.from_numpy(boxes))
    for got, want in ((emb, want_emb), (lg.numpy(), want_lg), (iou.numpy(), want_iou)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _sam_encoder_shapes(cfg):
    """The released file's encoder shapes at `cfg` (segment-anything's
    image_encoder): pos_embed at the 64 x 64 grid, rel-pos tables of the
    full grid in global blocks and of the window elsewhere."""
    d, hd = cfg.encoder_dim, cfg.encoder_dim // cfg.encoder_heads
    out = {"image_encoder.pos_embed": (1, cfg.embed_hw, cfg.embed_hw, d)}
    for i in range(cfg.encoder_depth):
        size = cfg.embed_hw if i in cfg.encoder_global_attn else cfg.window_size
        out[f"image_encoder.blocks.{i}.attn.rel_pos_h"] = (2 * size - 1, hd)
        out[f"image_encoder.blocks.{i}.attn.qkv.weight"] = (3 * d, d)
    return out


@pytest.mark.parametrize("size", ["vit_h", "vit_l", "vit_b"])
def test_sam_presets_load_their_own_shapes(size):
    """Shapes only (meta tensors: nothing full-size is allocated): each
    preset's module has its released file's encoder shapes, and a file of
    another size is refused as a shape mismatch."""
    cfg = sam_config_for(size)
    with torch.device("meta"):
        model = Sam(cfg)
    have = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = _sam_encoder_shapes(cfg)
    assert {k: have[k] for k in want} == want
    assert have["image_encoder.pos_embed"] == (1, 64, 64, cfg.encoder_dim)
    other = sam_config_for("vit_b" if size != "vit_b" else "vit_l")
    alien = {k: torch.empty(s, device="meta") for k, s in _sam_encoder_shapes(other).items()}
    rep = released_report(model, {**{k: v for k, v in model.state_dict().items()}, **alien})
    assert any("pos_embed" in m for m in rep["mismatched"])
    with pytest.raises(ValueError):
        sam_config_for("vit_x")


def test_missing_key_and_shape_mismatch_raise_extra_key_is_reported(detic_file, capsys):
    path, _ = detic_file
    sd = detic_state_dict_from_released(load_torch_state_dict(path), DETIC_TEST)
    rep = load_released_state_dict(Detic(DETIC_TEST), sd, "detic.pth")
    assert rep["extra"] == [
        "backbone.bottom_up.layers.0.blocks.0.attn.relative_position_index"]
    assert "detic.pth: ignored 1 keys" in capsys.readouterr().out
    missing = dict(sd)
    del missing["backbone.fpn_output3.weight"]
    with pytest.raises(ValueError, match="missing keys.*fpn_output3"):
        load_released_state_dict(Detic(DETIC_TEST), missing, "detic.pth")
    bad = dict(sd)
    bad["backbone.bottom_up.patch_embed.proj.weight"] = torch.zeros(7, 3, 4, 4)
    with pytest.raises(ValueError, match="shape mismatches.*patch_embed"):
        load_released_state_dict(Detic(DETIC_TEST), bad, "detic.pth")


def test_scalars_take_the_ports_shape_and_cls_bias_defaults_to_zero(detic_file):
    path, sd = detic_file
    raw = load_torch_state_dict(path)
    hp = "proposal_generator.centernet_head"
    raw[f"{hp}.scales.0.scale"] = torch.tensor(2.5)  # a 0-d scalar
    conv = detic_state_dict_from_released(raw, DETIC_TEST)
    assert (conv["roi_heads.box_predictor.0.cls_score.cls_bias"] == 0).all()
    model = Detic(DETIC_TEST)
    load_released_state_dict(model, conv, verbose=False)
    got = model.state_dict()
    assert got[f"{hp}.scales.0.scale"].shape == (1,) and float(got[f"{hp}.scales.0.scale"]) == 2.5
    raw["roi_heads.box_predictor.1.cls_score.cls_bias"] = torch.tensor([-4.6])
    load_released_state_dict(model, detic_state_dict_from_released(raw, DETIC_TEST),
                             verbose=False)
    assert float(model.state_dict()["roi_heads.box_predictor.1.cls_score.cls_bias"]) == \
        pytest.approx(-4.6)


class _Opaque:
    pass


def test_a_file_that_needs_unpickling_code_is_refused(tmp_path):
    torch.save({"model": {"w": torch.zeros(2)}, "trainer": _Opaque()}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="bad.pth.*weights_only"):
        load_torch_state_dict(str(tmp_path / "bad.pth"))
    torch.save({"model": {"w": torch.ones(2)}, "iteration": 3}, tmp_path / "ok.pth")
    assert set(load_torch_state_dict(str(tmp_path / "ok.pth"))) == {"w"}


def test_load_dispatches_directory_vs_file(tmp_path):
    """A directory loads the port's own converted tree (no converter); a
    file path goes through the converter (the JAX package's contract,
    tests/test_vocab_checkpoints.py:66)."""
    sd = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    save_params(sd, str(tmp_path / "sam_vit_h"))

    def boom(_path):
        raise AssertionError("convert_fn must not run for a directory")

    back = load_released_checkpoint(str(tmp_path / "sam_vit_h"), boom)
    torch.testing.assert_close(back["w"], sd["w"])
    calls = []
    out = load_released_checkpoint(str(tmp_path / "sam.pth"),
                                   lambda p: calls.append(p) or {"ok": 1})
    assert out == {"ok": 1} and calls == [str(tmp_path / "sam.pth")]


# --- verify_convert: the five cases of tests/test_verify_convert.py --------

def test_clean_sam_checkpoint_verifies():
    rep = verify_sam(_tensors(fake_sam_sd(JAX_SAM_TEST)), probe=True, cfg=SAM_TEST,
                     device="cpu")
    assert not has_problems(rep), rep["tree"]
    assert rep["coverage"]["ignored"] == []
    acts = rep["activations"]
    assert any("image_encoder" in k for k in acts)
    assert any("mask_decoder" in k for k in acts)
    for st in acts.values():
        assert np.isfinite(st["mean"]) and np.isfinite(st["std"])


def test_clean_detic_and_clip_checkpoints_verify():
    rep = verify_detic(_tensors(_fake_detic_sd(DETIC_TEST)), probe=True, cfg=DETIC_TEST,
                       device="cpu")
    assert not has_problems(rep), rep["tree"]
    assert any(k.startswith("roi_heads") for k in rep["activations"])
    rep = verify_clip(_tensors(fake_clip_sd(CLIP_CFG)), probe=True, cfg=CLIP_CFG,
                      device="cpu")
    assert not has_problems(rep) and rep["coverage"]["ignored"] == []
    assert "ln_final" in rep["activations"]
    # ZoeDepth is ported (A13b): a clean ZoeD_N-layout file verifies too
    from cm3d_tpu_torch.models.zoedepth import ZOE_TEST, synth_zoedepth_state_dict

    rep = verify_zoe(_tensors(synth_zoedepth_state_dict(ZOE_TEST, np.random.default_rng(0))),
                     probe=True, cfg=ZOE_TEST, device="cpu")
    assert not has_problems(rep), rep["tree"]
    assert rep["coverage"]["ignored"] == [
        f"core.core.scratch.refinenet4.resConfUnit1.{c}.{p}"
        for c in ("conv1", "conv2") for p in ("bias", "weight")]
    assert rep["activations"]


def test_ignored_extra_checkpoint_key_reported():
    sd = _tensors(fake_sam_sd(JAX_SAM_TEST))
    sd["optimizer.momentum_buffer"] = torch.zeros(3)
    rep = verify_sam(sd, cfg=SAM_TEST, device="cpu")
    assert rep["coverage"]["ignored"] == ["optimizer.momentum_buffer"]
    assert not has_problems(rep)  # extras are reported, not fatal


def test_missing_checkpoint_key_is_fatal():
    sd = _tensors(fake_sam_sd(JAX_SAM_TEST))
    del sd["image_encoder.blocks.1.attn.qkv.weight"]
    rep = verify_sam(sd, cfg=SAM_TEST, device="cpu")
    assert has_problems(rep)
    assert rep["tree"]["missing"] == ["image_encoder.blocks.1.attn.qkv.weight"]


def test_shape_mismatch_reported(tmp_path):
    from cm3d_tpu_torch.models.verify_convert import main

    sd = _tensors(fake_sam_sd(JAX_SAM_TEST))
    sd["image_encoder.patch_embed.proj.weight"] = torch.zeros(7, 3, 4, 4)
    rep = verify_sam(sd, cfg=SAM_TEST, device="cpu")
    assert has_problems(rep)
    assert any("patch_embed" in m for m in rep["tree"]["mismatched"])
    # the CLI exits 1 on it (a full-size preset on the meta device: shapes
    # only, nothing allocated, no probe)
    torch.save(sd, tmp_path / "sam.pth")
    assert main(["--sam", str(tmp_path / "sam.pth"), "--sam_size", "vit_b",
                 "--device", "meta"]) == 1


def test_activation_stats_hook_every_submodule():
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU())
    stats = activation_stats(model, lambda: model(torch.ones(2, 3)))
    assert set(stats) == {"0", "1"} and stats["1"]["shape"] == [2, 4]


# --- build_real_models and the masks CLI on fake files ---------------------

@pytest.fixture(scope="module")
def released_files(tmp_path_factory, detic_file):
    """The four files of the CLIs' checkpoint flags, at the test sizes."""
    root = tmp_path_factory.mktemp("released")
    torch.save(_tensors(fake_sam_sd(JAX_SAM_TEST)), root / "sam.pth")
    torch.save(_tensors(fake_clip_sd(CLIP_CFG)), root / "clip.pt")
    write_toy_bpe(root / "bpe.txt.gz")
    return {"detic": detic_file[0], "sam": str(root / "sam.pth"),
            "clip": str(root / "clip.pt"), "bpe": str(root / "bpe.txt.gz"), "root": root}


@pytest.fixture
def test_presets(monkeypatch):
    """Full-size presets -> the test sizes, as the JAX tests monkeypatch."""
    monkeypatch.setattr(detic_mod, "DETIC_SWINB", DETIC_TEST)
    monkeypatch.setitem(SAM_PRESETS, "vit_h", SAM_TEST)
    monkeypatch.setattr(clip_text, "CLIP_TEXT_B32", CLIP_CFG)


def test_build_real_models_embeds_the_vocabulary_with_clip(released_files, test_presets,
                                                          monkeypatch):
    from cm3d_tpu_torch.models.convert import clip_state_dict_from_released

    f = released_files
    seen = {}
    real_fns = masks._batched_model_fns

    def spy(detic, classifier, sam, vocabulary, **kw):
        seen["classifier"] = classifier
        return real_fns(detic, classifier, sam, vocabulary, **kw)

    monkeypatch.setattr(masks, "_batched_model_fns", spy)
    models = masks.build_real_models(f["detic"], f["sam"], f["clip"], f["bpe"],
                                     dtype="float32", device="cpu", verbose=False)
    clip = clip_text.ClipTextEncoder(CLIP_CFG)
    load_released_state_dict(clip, clip_state_dict_from_released(
        _tensors(fake_clip_sd(CLIP_CFG))), verbose=False)
    want = clip_text.embed_vocabulary(clip, clip_text.SimpleTokenizer(TOY_MERGES),
                                      list(models.vocabulary))
    assert want.shape == (DETIC_TEST.embed_dim, 19)
    np.testing.assert_array_equal(seen["classifier"], want)
    frame = models.prepare([np.full((48, 64, 3), 90, np.uint8)] * 2)
    boxes, scores, classes, valid = models.detic(frame)
    assert boxes.shape[:2] == (2, DETIC_TEST.max_detections)
    # int8 is ported (A12): the same float files are quantized at load, and
    # the int8 twins run
    qmodels = masks.build_real_models(f["detic"], f["sam"], f["clip"], f["bpe"], device="cpu",
                                      dtype="float32", quant_int8=True, verbose=False)
    qboxes, _, _, qvalid = qmodels.detic(frame)
    assert qboxes.shape == boxes.shape and qvalid.shape == valid.shape
    assert torch.isfinite(qmodels.sam_encode(frame)).all()
    smodels = masks.build_real_models(f["detic"], f["sam"], f["clip"], f["bpe"], device="cpu",
                                      dtype="float32", quant_int8=True, quant_static=True,
                                      verbose=False)
    assert torch.isfinite(smodels.sam_encode(frame)).all()  # calibrates on this ring
    assert not smodels.sam_encode.calibration["pending"]
    # --detector gdino is ported (A13c): the Detic that attach_gdino swaps
    # out loads in the form of its file and is not quantized by --quant_int8
    gmodels = masks.build_real_models(f["detic"], f["sam"], f["clip"], f["bpe"], device="cpu",
                                      dtype="float32", quant_int8=True, detic_used=False,
                                      verbose=False)
    gboxes, _, _, gvalid = gmodels.detic(frame)
    assert torch.equal(gboxes, boxes) and torch.equal(gvalid, valid)
    gmodels = masks.attach_gdino(gmodels, test=True, quant_int8=True, device="cpu")
    assert gmodels.detic(frame)[0].shape == (2, 12, 4)  # GDINO_TEST's 12 queries


def test_masks_cli_with_the_checkpoint_flags(tmp_path, released_files, test_presets, capsys):
    """The masks CLI on released files equals it on the same weights saved
    as converted directories (the production load path): one frame's
    labels, scores and masks."""
    from nusc_fixture import VERSION, make_fake_nuscenes

    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.models.convert import clip_state_dict_from_released

    f = released_files
    root = tmp_path / "nusc"
    make_fake_nuscenes(root, tmp_path / "planted", n_frames=1, n_objects=4)
    dirs = {}
    for name, conv in (("detic", lambda p: detic_state_dict_from_released(
            load_torch_state_dict(p), DETIC_TEST)),
                       ("sam", load_torch_state_dict),
                       ("clip", lambda p: clip_state_dict_from_released(
                           load_torch_state_dict(p)))):
        dirs[name] = str(tmp_path / f"{name}_dir")
        save_params(conv(f[name]), dirs[name])
    base = ["--dataroot", str(root), "--version", VERSION, "--thumbnail", "96",
            "--device", "cpu", "--bpe_path", f["bpe"]]
    for tag, src in (("file", f), ("dir", dirs)):
        masks.main(base + ["--out_dir", str(tmp_path / tag), "--detic_ckpt", src["detic"],
                           "--sam_ckpt", src["sam"], "--clip_ckpt", src["clip"]])
    assert "1 frames done" in capsys.readouterr().out
    a = MaskArtifactStore(tmp_path / "file").read_frame("scene-0001", 0)
    b = MaskArtifactStore(tmp_path / "dir").read_frame("scene-0001", 0)
    assert len(a.labels) > 0
    assert a.labels == b.labels and a.cam_nums == b.cam_nums
    np.testing.assert_array_equal(a.detection_scores, b.detection_scores)
    np.testing.assert_array_equal(a.masks, b.masks)
    with pytest.raises(SystemExit):  # three of the four paths: argparse's error
        masks.main(base[:-2] + ["--out_dir", str(tmp_path / "x"), "--detic_ckpt",
                                f["detic"], "--sam_ckpt", f["sam"], "--clip_ckpt", f["clip"]])


def test_e2e_cli_loads_the_checkpoint_flags(released_files, test_presets, monkeypatch,
                                            tmp_path):
    """The e2e CLI builds its models from the four files too (Waymo run:
    the Waymo vocabulary's classifier)."""
    from cm3d_tpu_torch.pipelines import e2e
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_WAYMO

    f = released_files
    seen = {}
    real_fns = masks._batched_model_fns

    def spy(detic, classifier, sam, vocabulary, **kw):
        seen["classifier"] = classifier
        return real_fns(detic, classifier, sam, vocabulary, **kw)

    monkeypatch.setattr(masks, "_batched_model_fns", spy)
    monkeypatch.setattr(e2e, "run_e2e_waymo",
                        lambda root, scenes, out, models, **kw: seen.update(models=models))
    e2e.main(["--dataset", "waymo", "--dataroot", str(tmp_path), "--scenes", "s0",
              "--out", str(tmp_path / "o.bin"), "--device", "cpu", "--detic_ckpt",
              f["detic"], "--sam_ckpt", f["sam"], "--clip_ckpt", f["clip"],
              "--bpe_path", f["bpe"]])
    assert tuple(seen["models"].vocabulary) == tuple(CUSTOM_VOCABULARY_WAYMO)
    assert seen["classifier"].shape == (DETIC_TEST.embed_dim, len(CUSTOM_VOCABULARY_WAYMO))

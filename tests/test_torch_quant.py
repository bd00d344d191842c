"""The port's int8 w8a8 path (cm3d_tpu_torch/ops/quant.py, QuantLinear, the
quantized SAM / Swin / Detic, the mask stage's calibration and conform with
--quant_int8)
against the JAX package's on the CPU.

Inputs are seeded numpy; JAX weights come from its `init` and are carried
into the port by `models/convert.py` (quantized subtrees too). Tolerances:
- the ops are bit-equal to JAX's in f32 and bf16 (same quantize, exact
  int32 product, same dequantize order);
- a quantized model carried from JAX agrees with JAX's within ONE int8
  step of its largest output, max|ref| / 127: an upstream 1-ulp difference
  may flip one activation's int8 rounding, which moves an output by at most
  a step of its row's scale;
- the port's int8 against the port's float stays inside the JAX package's
  own envelopes (tests/test_quant.py: rel < 0.1, corr > 0.995; static:
  rel < 0.15 to float, < 0.1 to dynamic, corr > 0.99; mask IoU > 0.9);
- calibrated act_scales within rtol 1e-6 of JAX's (one f32 ulp of an
  absmax that went through a different summation order);

The masks CLI with the int8 flags is held to JAX's in
tests/test_torch_quant_cli.py.
"""

import dataclasses
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.models.detic import DETIC_TEST as JAX_DETIC_TEST
from cm3d_tpu.models.detic import Detic as JaxDetic
from cm3d_tpu.models.detic import quantize_detic_params
from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu.models.sam import Sam as JaxSam
from cm3d_tpu.models.sam import quantize_sam_params
from cm3d_tpu.models.swin import SWIN_TEST as JAX_SWIN_TEST
from cm3d_tpu.models.swin import SwinTransformer as JaxSwin
from cm3d_tpu.models.swin import quantize_swin_params
from cm3d_tpu.ops import quant as jq

from cm3d_tpu_torch.models.common import QuantLinear, record_act_absmax
from cm3d_tpu_torch.models.convert import (
    detic_state_dict_from_flax, sam_state_dict_from_flax, swin_state_dict_from_flax)
from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic, quantize_detic_state_dict
from cm3d_tpu_torch.models.sam import (
    SAM_TEST, Sam, calibrate_sam_act_scales, quantize_sam_state_dict)
from cm3d_tpu_torch.models.swin import SWIN_TEST, SwinTransformer, quantize_swin_state_dict
from cm3d_tpu_torch.ops import quant as tq
from cm3d_tpu_torch.pipelines import masks
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

INT8_STEP = 1.0 / 127


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# The ops, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,bias", [((32, 64), True), ((3, 50, 96), True),
                                        ((2, 3, 5, 16), False)])
def test_dynamic_and_static_ops_bit_equal_jax(dtype, shape, bias):
    """f32 and bf16, 2-d and N-d inputs, with and without bias, a zero
    weight column, and a static scale that clips the largest values."""
    rng = np.random.default_rng(sum(shape))
    k = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((k, 24)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero output channel
    b = rng.standard_normal(24).astype(np.float32) if bias else None
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    twq, tws = tq.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    assert np.isfinite(tws.numpy()).all() and (twq[3] == 0).all()

    xj, xt = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    bj = None if b is None else jnp.asarray(b)
    bt = None if b is None else torch.from_numpy(b)
    got = tq.dynamic_int8_matmul(xt, twq, tws, bt)
    assert got.dtype == xt.dtype and tuple(got.shape) == shape[:-1] + (24,)
    np.testing.assert_array_equal(got.float().numpy(), _np(jq.dynamic_int8_matmul(xj, jwq, jws, bj)))
    # half the envelope: the upper half of |x| clips to +-127
    s = np.float32(np.abs(x).max() / 127 / 2)
    got = tq.static_int8_matmul(xt, twq, tws, torch.tensor(s), bt)
    want = jq.static_int8_matmul(xj, jwq, jws, jnp.asarray(s), bj)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_quant_linear_records_absmax_only_inside_the_context():
    rng = np.random.default_rng(1)
    lin = QuantLinear(12, 8)
    w_q, scale = tq.quantize_weight(torch.from_numpy(rng.standard_normal((8, 12)).astype(
        np.float32)))
    lin.weight_q.copy_(w_q)
    lin.weight_scale.copy_(scale)
    x = torch.from_numpy(rng.standard_normal((5, 12)).astype(np.float32))
    lin(x)
    assert lin.act_absmax is None  # free outside the record
    with record_act_absmax(lin) as rec:
        lin(x)
        lin(2 * x)
    assert lin.act_absmax is None and set(rec) == {""}
    assert float(rec[""]) == float((2 * x).abs().max())


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sam_case():
    """JAX SAM_TEST float params (rel-pos tables and pos_embed noised, as in
    tests/test_torch_sam.py), its int8 trees (dynamic, and static calibrated
    on `img`), and JAX's float / int8 encodes of `img` and of a nearby
    `img2`."""
    model = JaxSam(JAX_SAM_TEST)
    params = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(1), jnp.zeros((64, 64, 3)), jnp.zeros((1, 4)))["params"])
    rng = np.random.default_rng(0)
    enc = params["image_encoder"]
    enc["pos_embed"] = 0.1 * rng.standard_normal(enc["pos_embed"].shape).astype(np.float32)
    for i in range(JAX_SAM_TEST.encoder_depth):
        for k in ("rel_pos_h", "rel_pos_w"):
            attn = enc[f"block{i}"]["attn"]
            attn[k] = 0.3 * rng.standard_normal(attn[k].shape).astype(np.float32)
    img = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    img2 = img + 0.05 * rng.standard_normal(img.shape).astype(np.float32)
    dyn_cfg = dataclasses.replace(JAX_SAM_TEST, quant_int8=True)
    st_cfg = dataclasses.replace(dyn_cfg, quant_static=True)
    qp = jax.tree.map(np.asarray, quantize_sam_params(params))
    # calibrate_sam_act_scales' two steps, its encode jitted (eager, it
    # compiles each op)
    dyn = JaxSam(dyn_cfg)
    _, state = jax.jit(lambda p, x: dyn.apply({"params": p}, x, method=dyn.encode_image,
                                              mutable=["intermediates"]))(qp, img)
    sp = jax.tree.map(np.asarray, jq.bake_act_scales(qp, state["intermediates"]))

    def enc_(cfg, p, x):
        m = JaxSam(cfg)
        return np.asarray(jax.jit(lambda p, x: m.apply({"params": p}, x,
                                                       method=m.encode_image))(p, x))

    return {"params": params, "qp": qp, "sp": sp, "img": img, "img2": img2,
            "float": enc_(JAX_SAM_TEST, params, img2), "dyn": enc_(dyn_cfg, qp, img2),
            "static": enc_(st_cfg, sp, img2)}


def _port_sam(sd, **kw):
    m = Sam(dataclasses.replace(SAM_TEST, **kw))
    m.load_state_dict(sd)
    return m.eval()


def _encode(model, x):
    with torch.no_grad():
        return model.encode_image(torch.from_numpy(x)).numpy()


def test_quantized_sam_state_dicts_equal_the_carried_jax_trees(sam_case):
    """quantize_sam_state_dict and calibrate_sam_act_scales on the carried
    float weights give JAX's quantize_sam_params / calibrate_sam_act_scales
    trees: int8 weights and scales bit-equal, act_scales within rtol 1e-6;
    the decoder, prompt encoder, patch embed and neck stay float."""
    float_sd = sam_state_dict_from_flax(sam_case["params"], SAM_TEST)
    own = quantize_sam_state_dict(float_sd)
    carried = sam_state_dict_from_flax(sam_case["qp"], SAM_TEST)
    assert set(own) == set(carried)
    for k in own:
        assert own[k].dtype == carried[k].dtype and torch.equal(own[k], carried[k]), k
    assert own["image_encoder.blocks.0.attn.qkv.weight_q"].dtype == torch.int8
    assert torch.equal(own["mask_decoder.iou_token.weight"], float_sd["mask_decoder.iou_token.weight"])
    Sam(dataclasses.replace(SAM_TEST, quant_int8=True)).load_state_dict(own)  # strict

    cfg = dataclasses.replace(SAM_TEST, quant_int8=True, quant_static=True)
    cal = calibrate_sam_act_scales(cfg, own, torch.from_numpy(sam_case["img"]))
    carried = sam_state_dict_from_flax(sam_case["sp"], SAM_TEST)
    scales = [k for k in carried if k.endswith(".act_scale")]
    assert len(scales) == 4 * SAM_TEST.encoder_depth and set(cal) == set(carried)
    for k in scales:
        np.testing.assert_allclose(cal[k].numpy(), carried[k].numpy(), rtol=1e-6, err_msg=k)
    assert not any(k.endswith(".act_scale") for k in own)  # the input is unchanged


@pytest.mark.parametrize("mode", ["dyn", "static"])
def test_sam_int8_encode_matches_jax(sam_case, mode):
    key = "qp" if mode == "dyn" else "sp"
    port = _port_sam(sam_state_dict_from_flax(sam_case[key], SAM_TEST), quant_int8=True,
                     quant_static=mode == "static")
    got, want = _encode(port, sam_case["img2"]), sam_case[mode]
    assert np.abs(got - want).max() <= INT8_STEP * np.abs(want).max()


def test_port_int8_sam_inside_the_jax_envelopes(sam_case):
    """The port's own quantize / calibrate against the port's float encode,
    held to tests/test_quant.py's envelopes; masks through the float
    decoder stay IoU-close."""
    float_sd = sam_state_dict_from_flax(sam_case["params"], SAM_TEST)
    fm = _port_sam(float_sd)
    qsd = quantize_sam_state_dict(float_sd)
    qm = _port_sam(qsd, quant_int8=True)
    scfg = dataclasses.replace(SAM_TEST, quant_int8=True, quant_static=True)
    sm = _port_sam(calibrate_sam_act_scales(scfg, qsd, torch.from_numpy(sam_case["img"])),
                   quant_int8=True, quant_static=True)
    ref, dyn, stat = (_encode(m, sam_case["img2"]) for m in (fm, qm, sm))

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(dyn, ref) < 0.1 and np.corrcoef(ref.ravel(), dyn.ravel())[0, 1] > 0.995
    assert rel(stat, ref) < 0.15 and rel(stat, dyn) < 0.1
    assert np.corrcoef(ref.ravel(), stat.ravel())[0, 1] > 0.99
    boxes = torch.tensor([[4.0, 4.0, 40.0, 40.0], [10.0, 16.0, 50.0, 60.0]])
    with torch.no_grad():
        mr = fm.decode_boxes(torch.from_numpy(ref[0]), boxes)[0].numpy() > 0
        mq = qm.decode_boxes(torch.from_numpy(dyn[0]), boxes)[0].numpy() > 0
    if (mr | mq).sum():
        assert (mr & mq).sum() / (mr | mq).sum() > 0.9


def test_reconcile_quantization_semantics(sam_case):
    """Float + want -> transformed; quantized + want -> passed through (no
    double quantization); quantized + not want -> an error."""
    float_sd = sam_state_dict_from_flax(sam_case["params"], SAM_TEST)
    qsd = quantize_sam_state_dict(float_sd)
    assert not tq.is_quantized_state_dict(float_sd) and tq.is_quantized_state_dict(qsd)
    out = tq.reconcile_quantization(float_sd, quantize_sam_state_dict, True, "SAM")
    assert tq.is_quantized_state_dict(out)
    assert tq.reconcile_quantization(qsd, quantize_sam_state_dict, True, "SAM") is qsd
    assert tq.reconcile_quantization(float_sd, quantize_sam_state_dict, False, "SAM") is float_sd
    with pytest.raises(ValueError, match="int8-quantized"):
        tq.reconcile_quantization(qsd, quantize_sam_state_dict, False, "SAM")


def test_config_refusals_match_jax():
    """int8 with the fused windowed blocks, and static without int8, are
    refused as in JAX (tests/test_quant.py:187, :574)."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        dataclasses.replace(SAM_TEST, quant_int8=True, fused_window_attn=True)
    with pytest.raises(ValueError, match="quant_static requires"):
        dataclasses.replace(SAM_TEST, quant_static=True)
    cfg = dataclasses.replace(SAM_TEST, quant_int8=True, quant_static=True)
    assert cfg.quant_mode() == "static"
    assert dataclasses.replace(SAM_TEST, quant_int8=True).quant_mode() is True
    with pytest.raises(ValueError, match="quant_static requires"):
        masks.build_real_models("d", "s", "c", "b", quant_static=True, device="cpu")


# ---------------------------------------------------------------------------
# Swin and Detic: int8 MLPs beside the fused window attention
# ---------------------------------------------------------------------------

def test_swin_int8_matches_jax():
    cfg = dataclasses.replace(JAX_SWIN_TEST, fused_attn=False)
    x = np.random.default_rng(2).standard_normal((1, 32, 48, 3)).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(JaxSwin(cfg).init)(jax.random.PRNGKey(0),
                                                                  x)["params"])
    qp = jax.tree.map(np.asarray, quantize_swin_params(params))
    want = jax.jit(JaxSwin(dataclasses.replace(cfg, quant_int8=True)).apply)({"params": qp}, x)
    own = quantize_swin_state_dict(swin_state_dict_from_flax(params, SWIN_TEST, prefix=""))
    carried = swin_state_dict_from_flax(qp, SWIN_TEST, prefix="")
    assert set(own) == set(carried) and all(torch.equal(own[k], carried[k]) for k in own)
    for fused in (True, False):  # the kernel's plain version, and the plain branch
        m = SwinTransformer(dataclasses.replace(SWIN_TEST, quant_int8=True, fused_attn=fused))
        m.load_state_dict(own)
        with torch.no_grad():
            got = m(torch.from_numpy(x))
        for k in want:
            w = np.asarray(want[k])
            assert np.abs(got[k].numpy() - w).max() <= INT8_STEP * np.abs(w).max(), (fused, k)


def test_detic_int8_matches_jax():
    """The test Detic with int8 Swin MLPs against JAX's quantized Detic on
    carried weights: equal valid flags and classes, boxes and scores within
    one int8 step of their largest value."""
    rng = np.random.default_rng(5)
    clf = rng.standard_normal((JAX_DETIC_TEST.embed_dim, 6)).astype(np.float32)
    img = rng.standard_normal((64, 96, 3)).astype(np.float32)
    model = JaxDetic(JAX_DETIC_TEST)
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), img,
                                                          clf)["params"])
    qp = jax.tree.map(np.asarray, quantize_detic_params(params))
    jcfg = dataclasses.replace(JAX_DETIC_TEST, swin=dataclasses.replace(
        JAX_DETIC_TEST.swin, quant_int8=True))
    want = jax.jit(JaxDetic(jcfg).apply)({"params": qp}, img, clf,
                                         jnp.asarray([64, 96], jnp.int32))
    own = quantize_detic_state_dict(detic_state_dict_from_flax(params, DETIC_TEST))
    carried = detic_state_dict_from_flax(qp, DETIC_TEST)
    assert set(own) == set(carried) and all(torch.equal(own[k], carried[k]) for k in own)
    m = Detic(dataclasses.replace(DETIC_TEST, swin=dataclasses.replace(
        DETIC_TEST.swin, quant_int8=True)))
    m.load_state_dict(own)
    with torch.no_grad():
        got = m(torch.from_numpy(img)[None], torch.from_numpy(clf),
                torch.tensor([[64, 96]]))
    v = np.asarray(want.valid)
    assert v.sum() > 0
    np.testing.assert_array_equal(got.valid[0].numpy(), v)
    np.testing.assert_array_equal(got.classes[0].numpy()[v], np.asarray(want.classes)[v])
    for name in ("boxes", "scores"):
        w = np.asarray(getattr(want, name))[v]
        g = getattr(got, name)[0].numpy()[v]
        assert np.abs(g - w).max() <= INT8_STEP * np.abs(w).max(), name


# ---------------------------------------------------------------------------
# The mask stage's first-ring calibration, and conform
# ---------------------------------------------------------------------------

def test_fake_models_static_calibrates_the_first_ring_only():
    """build_fake_models(quant_int8, quant_static): the FIRST ring
    calibrates once, later rings run the static path with its scales, and
    their embeddings stay close to the dynamic pipeline's (tests/
    test_quant.py's envelope)."""
    rng = np.random.default_rng(7)
    imgs = [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(2)]
    imgs2 = [rng.integers(0, 255, (64, 64, 3), np.uint8) for _ in range(2)]
    dyn = masks.build_fake_models(quant_int8=True, device="cpu")
    stat = masks.build_fake_models(quant_int8=True, quant_static=True, device="cpu")
    cal = stat.sam_encode.calibration
    assert cal["pending"] and cal["seconds"] is None
    stat.sam_encode(stat.prepare(imgs))
    seconds = cal["seconds"]
    assert not cal["pending"] and seconds > 0
    e_stat = stat.sam_encode(stat.prepare(imgs2)).float().numpy()
    assert cal["seconds"] == seconds  # a second ring does not recalibrate
    e_dyn = dyn.sam_encode(dyn.prepare(imgs2)).float().numpy()
    assert np.isfinite(e_stat).all()
    assert np.linalg.norm(e_stat - e_dyn) / np.linalg.norm(e_dyn) < 0.1
    assert np.corrcoef(e_dyn.ravel(), e_stat.ravel())[0, 1] > 0.99


def test_benches_build_int8_models_at_a_tiny_geometry(monkeypatch, one_torch_thread):
    """bench_mask_stage(quant_int8, quant_static) and bench_e2e(quant_int8)
    build their models through build_production_fake_models (here on the
    tiny float modules and a 64x48 camera): the int8 twins are built, the
    result names the modes, and the static models calibrate on the warm-up
    ring once."""
    import cm3d_tpu_torch.benchmarks as bench
    import cm3d_tpu_torch.config as config
    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.sam import SAM_TEST, Sam

    built = []

    def tiny_modules(dtype, device, seed, fused_window_attn, vocabulary, sam_size="vit_h",
                     rect_encode=False):
        assert (sam_size, rect_encode) == ("vit_h", False)  # the benches' defaults
        gen = torch.Generator()
        clf = np.random.default_rng(seed).standard_normal(
            (DETIC_TEST.embed_dim, len(vocabulary))).astype(np.float32)
        built.append(dtype)
        return (init_weights(Detic(DETIC_TEST), gen.manual_seed(seed)), clf,
                init_weights(Sam(SAM_TEST), gen.manual_seed(seed + 1)))

    monkeypatch.setattr(bench, "production_fake_modules", tiny_modules)
    monkeypatch.setattr(bench, "IMG_H", 48)
    monkeypatch.setattr(bench, "IMG_W", 64)
    small = LiftStageConfig(max_points=8192, max_points_per_mask=256, max_points_per_camera=4096,
                            max_points_in_masks=1024, max_lane_points=512)
    monkeypatch.setattr(config, "LiftStageConfig", lambda: small)
    out = bench.bench_mask_stage("float32", n_frames=2, io_sleep=0.0, device="cpu",
                                 quant_int8=True, quant_static=True)
    assert out["quant_int8"] is True and out["quant_static"] is True
    assert out["calibration_s"] > 0 and np.isfinite(out["value"])
    out = bench.bench_e2e("float32", n_frames=2, batch_size=2, device="cpu", quant_int8=True)
    assert out["quant_int8"] is True and out["quant_static"] is False
    assert out["boxes_kept"] > 0 and np.isfinite(out["value"])
    assert built == ["float32", "float32"]


def test_conform_quant_int8_writes_int8_dirs(tmp_path, monkeypatch):
    """conform --quant_int8 saves *_int8 SAM and Detic state dicts beside the
    float ones, the e2e phase loads them with --quant_int8, and the saved
    int8 SAM drives the int8 module."""
    import argparse

    from test_sam import _fake_torch_sd
    from test_torch_checkpoints import _fake_detic_sd, _save_detectron2

    from cm3d_tpu_torch import conform
    from cm3d_tpu_torch.models.checkpoints import load_params

    sam_path = tmp_path / "sam.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                _fake_torch_sd(JAX_SAM_TEST).items()}, sam_path)
    detic_path = tmp_path / "detic.pth"
    _save_detectron2(_fake_detic_sd(DETIC_TEST), detic_path)
    seen = {}
    monkeypatch.setattr(conform, "_e2e_main", lambda argv: seen.setdefault("argv", argv))
    args = argparse.Namespace(
        sam=str(sam_path), sam_size="vit_h", detic=str(detic_path), clip="", bpe="", zoe="",
        gdino="", gdino_vocab="", probe=False, quant_int8=True, dataset="kitti",
        dataroot="/x", version="v1.0-mini", scenes="0", out=str(tmp_path / "c"),
        fake_weights=False, skip_pipeline=False, skip_eval=True, device="cpu")
    report, _ = conform.run_conform(args, cfg_overrides={"sam": SAM_TEST, "detic": DETIC_TEST})
    for name, save in (("sam", "sam_vit_h"), ("detic", "detic_swinb")):
        entry = report["models"][name]
        assert entry["ok"], entry
        assert entry["converted_int8"] == str(tmp_path / "c" / "converted" / f"{save}_int8")
        assert tq.is_quantized_state_dict(load_params(entry["converted_int8"]))
        assert not tq.is_quantized_state_dict(load_params(entry["converted"]))
    argv = seen["argv"]
    assert "--quant_int8" in argv
    assert argv[argv.index("--sam_ckpt") + 1] == report["models"]["sam"]["converted_int8"]
    assert argv[argv.index("--detic_ckpt") + 1] == report["models"]["detic"]["converted_int8"]
    sam = Sam(dataclasses.replace(SAM_TEST, quant_int8=True))
    sam.load_state_dict(load_params(report["models"]["sam"]["converted_int8"]))

"""The port's ZoeDepth (cm3d_tpu_torch/models/zoedepth.py), its depth
payload in the mask stage and verify_zoe, against the JAX package's on the
CPU, at ZOE_TEST size, f32.

The forward runs on `synth_zoedepth_state_dict(ZOE_TEST)` scaled by 10: at
the synthetic std of 0.02 the depth map is flat to 1e-7 of its mean, so a
wrong port would pass; at x10 its std is about a fifth of its mean, all
finite. Tolerances: depth within rtol 1e-4 (f32 summation order through 4
blocks and the DPT decoder) at 99.9% of the pixels and 1e-3 at all: where
the log-binomial's temperature is near 1 and a bin centre sits near an
attractor (alpha 1000), rounding is amplified (seen: 1 pixel of 12288 at
5e-4, the next at 1e-4); rel_depth (ReLU chains reach about 3e5) by
relative norm, 1e-5; resizes within 1e-6 of their largest value (torch's
interpolate against JAX's separable matmuls); index tables, the checkpoint
grid interpolation and the masked depth of one handle exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.models import zoedepth as jz

from cm3d_tpu_torch.models import zoedepth as tz
from cm3d_tpu_torch.pipelines import masks
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)


def _torch_sd(sd):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def zoe_case():
    """x10 synthetic weights, an input batch, and JAX's forward of it."""
    rng = np.random.default_rng(0)
    sd = {k: v * 10 for k, v in tz.synth_zoedepth_state_dict(tz.ZOE_TEST, rng).items()}
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    params = jz.convert_zoedepth_params(sd, jz.ZOE_TEST)
    depth, rel = jax.jit(jz.ZoeDepthModel(jz.ZOE_TEST).apply)({"params": params}, x)
    return {"sd": sd, "x": x, "params": params, "depth": np.asarray(depth),
            "rel": np.asarray(rel)}


def _port_model(sd, cfg=tz.ZOE_TEST):
    m = tz.ZoeDepth(cfg)
    m.load_state_dict(tz.zoedepth_state_dict_from_released(_torch_sd(sd), cfg))
    return m.eval()


@pytest.mark.parametrize("out_hw", [(13, 20), (3, 4), (14, 18), (7, 9), (1, 5)])
def test_resize_bilinear_ac_matches_jax(out_hw):
    x = np.random.default_rng(1).standard_normal((2, 7, 9, 3)).astype(np.float32)
    got = tz.resize_bilinear_ac(torch.from_numpy(x), out_hw).numpy()
    want = np.asarray(jz.resize_bilinear_ac(jnp.asarray(x), out_hw))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("gh,gw", [(4, 6), (24, 32), (3, 3)])
def test_beit_rel_pos_index_exact(gh, gw):
    np.testing.assert_array_equal(tz.beit_rel_pos_index(gh, gw), jz._beit_rel_pos_index(gh, gw))


def test_ckpt_grid_interpolation_matches_jax():
    """A checkpoint trained on another grid (square 4x4 here) has each
    block's table interpolated to the config's 4x6 grid as JAX's converter
    does, bit for bit; every other tensor loads as it is."""
    sd = tz.synth_zoedepth_state_dict(tz.ZOE_TEST, np.random.default_rng(2), ckpt_grid=(4, 4))
    got = tz.zoedepth_state_dict_from_released(_torch_sd(sd), tz.ZOE_TEST)
    params = jz.convert_zoedepth_params(sd, jz.ZOE_TEST)
    gh, gw = tz.ZOE_TEST.grid_hw
    for i in range(tz.ZOE_TEST.depth):
        key = f"core.core.pretrained.model.blocks.{i}.attn.relative_position_bias_table"
        want = params["core"]["beit"][f"block{i}"]["attn"]["relative_position_bias_table"]
        assert got[key].shape == ((2 * gh - 1) * (2 * gw - 1) + 3, tz.ZOE_TEST.num_heads)
        np.testing.assert_array_equal(got[key].numpy(), want)
    assert not any("refinenet4.resConfUnit1" in k for k in got)
    tz.ZoeDepth(tz.ZOE_TEST).load_state_dict(got)  # strict


def test_weights_round_trip_through_flax(zoe_case):
    """zoedepth_state_dict_from_flax inverts convert_zoedepth_params (the
    transposed convs' spatial flip included): the released tensors back."""
    back = tz.zoedepth_state_dict_from_flax(jax.tree.map(np.asarray, zoe_case["params"]),
                                            tz.ZOE_TEST)
    released = tz.zoedepth_state_dict_from_released(_torch_sd(zoe_case["sd"]), tz.ZOE_TEST)
    assert set(back) == set(released)
    for k in back:
        np.testing.assert_array_equal(back[k].numpy(), released[k].numpy(), err_msg=k)


def test_forward_matches_jax(zoe_case):
    with torch.no_grad():
        depth, rel = _port_model(zoe_case["sd"])(torch.from_numpy(zoe_case["x"]))
    jd, jr = zoe_case["depth"], zoe_case["rel"]
    assert jd.std() > 0.1 * jd.mean()  # not flat: the x10 weights matter
    assert np.isfinite(depth.numpy()).all() and depth.shape == jd.shape
    err = np.abs(depth.numpy() - jd) / jd
    assert np.mean(err <= 1e-4) >= 0.999 and err.max() <= 1e-3
    assert np.linalg.norm(rel.numpy() - jr) / np.linalg.norm(jr) < 1e-5


@pytest.mark.parametrize("flip", [True, False])
def test_predict_depth_contract_and_flip_match_jax(zoe_case, flip):
    """predict_depth returns f32 metric depth at the INPUT resolution
    (reference :121-124), the flip average included, as JAX's does; its
    `dispatch` half returns the tensor on the model's device."""
    img = np.random.default_rng(3).integers(0, 255, (50, 70, 3)).astype(np.uint8)
    predict = tz.make_predict_depth(_port_model(zoe_case["sd"]), flip_aug=flip)
    d = predict(img)
    assert d.shape == (50, 70) and d.dtype == np.float32
    assert np.isfinite(d).all() and (d > 0).all()
    assert isinstance(predict.dispatch(img), torch.Tensor)
    params = jax.tree.map(jnp.asarray, zoe_case["params"])
    want = jz.make_predict_depth(jz.ZoeDepthModel(jz.ZOE_TEST), params, flip_aug=flip)(img)
    np.testing.assert_allclose(d, want, rtol=1e-4, atol=0)


def test_masked_depth_images_matches_jax():
    """One handle through both masked_depth_images: the same [M, H, W]
    array, bit for bit (masks crop their camera's depth, zero elsewhere)."""
    from cm3d_tpu.ops.bitmask import pack_masks_np
    from cm3d_tpu.pipelines.masks import masked_depth_images as jax_masked_depth_images

    rng = np.random.default_rng(4)
    w, h = 8, 6
    dense = (rng.random((3, w, h)) > 0.5).astype(np.uint8)
    depths = [rng.uniform(1, 9, (h, w)).astype(np.float32),
              rng.uniform(1, 9, (h - 1, w - 2)).astype(np.float32)]  # a smaller camera
    handle = {"planes": pack_masks_np(dense), "layout": "xy", "plane_wh": (w, h), "total": 3,
              "labels": ["car", "truck", "car"], "cams": [0, 1, 1], "depths": depths}
    want = jax_masked_depth_images(handle)
    planes = torch.from_numpy(np.asarray(handle["planes"]).view(np.int32))
    got = masks.masked_depth_images({**handle, "planes": planes, "planes_host": None})
    assert got.dtype == np.float32 and got.shape == (3, h, w)
    np.testing.assert_array_equal(got, want)
    empty = masks.masked_depth_images({**handle, "planes": None, "planes_host": None})
    assert empty.shape == (0, h, w) and empty.dtype == np.float32


def test_masks_cli_use_zoedepth_matches_jax_cli(tmp_path, monkeypatch, one_torch_thread):
    """JAX's masks CLI and the port's with --fake_weights --use_zoedepth on
    one fabricated nuScenes dataroot, on the same weights (JAX's, carried):
    the same labels, cameras and [M, H, W] f32 depth payloads (rtol 1e-4,
    masks equal); a frame without detections still writes a [0, H, W] f32
    payload (tests/test_zoedepth.py:294-320)."""
    from nusc_fixture import VERSION, make_fake_nuscenes
    from test_torch_quant_cli import (
        _jax_fake_models, _port_fake_models, _read_frame, make_fake_weights)

    from cm3d_tpu.pipelines import masks as jax_masks

    make_fake_nuscenes(tmp_path / "root", tmp_path / "planted", n_frames=1, n_objects=4)
    weights = make_fake_weights()
    zoe = {}

    def jax_attach(models, ckpt_path="", test=False, **kw):
        model = jz.ZoeDepthModel(jz.ZOE_TEST)
        zoe["params"] = jax.jit(model.init)(jax.random.PRNGKey(0),
                                            np.zeros((1, 64, 96, 3), np.float32))["params"]
        return dataclasses.replace(models, predict_depth=jz.make_predict_depth(
            model, zoe["params"], True))

    def port_attach(models, ckpt_path="", test=False, device=None, **kw):
        sd = tz.zoedepth_state_dict_from_flax(jax.tree.map(np.asarray, zoe["params"]),
                                              tz.ZOE_TEST)
        return masks_attach(models, test=test, device=device, state_dict=sd)

    masks_attach, masks_build = masks.attach_zoedepth, masks.build_fake_models
    monkeypatch.setattr(jax_masks, "build_fake_models", _jax_fake_models(weights))
    monkeypatch.setattr(jax_masks, "attach_zoedepth", jax_attach)
    monkeypatch.setattr(masks, "build_fake_models", _port_fake_models(weights))
    monkeypatch.setattr(masks, "attach_zoedepth", port_attach)
    argv = ["--dataroot", str(tmp_path / "root"), "--version", VERSION, "--thumbnail", "96",
            "--fake_weights", "--use_zoedepth"]
    jax_masks.main(argv + ["--out_dir", str(tmp_path / "jax")])
    masks.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    want, want_d = _read_frame(tmp_path / "jax", "scene-0001", 0)
    got, got_d = _read_frame(tmp_path / "port", "scene-0001", 0)
    assert got["labels"] == want["labels"] and got["cam_nums"] == want["cam_nums"]
    assert len(want["labels"]) > 0
    assert got_d.dtype == want_d.dtype == np.float32 and got_d.shape == want_d.shape
    np.testing.assert_array_equal(got_d > 0, want_d > 0)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-4, atol=0)

    # a frame without detections: the depth payload's type, [0, H, W] f32
    models = masks_attach(masks_build(seed=0, device="cpu"), test=True, device="cpu")
    c, d = 1, 8
    models = dataclasses.replace(models, detic=lambda frame: (
        torch.zeros(c, d, 4), torch.zeros(c, d), torch.zeros(c, d, dtype=torch.int64),
        torch.zeros(c, d, dtype=torch.bool)))
    from cm3d_tpu_torch.config import MaskStageConfig
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore

    image = (np.random.default_rng(5).random((48, 64, 3)) * 255).astype(np.uint8)
    masks.run_mask_stage(models, lambda s, f: [image], ["sc-e"], lambda s: 1,
                         str(tmp_path / "empty"), MaskStageConfig(use_zoedepth=True),
                         verbose=False)
    data, depths = MaskArtifactStore(tmp_path / "empty").read_frame_depths("sc-e", 0)
    assert isinstance(depths, np.ndarray) and depths.dtype == np.float32
    assert depths.shape == (0, 48, 64) and data["labels"] == []


def test_verify_zoe_report_matches_jax():
    """verify_zoe on a synthetic ZoeD_N-layout state dict (a 4x4 checkpoint
    grid): the report's keys, the consumed count and the ignored keys
    equal JAX's, and no tree problem; --probe adds activations."""
    from cm3d_tpu.models.verify_convert import verify_zoe as jax_verify_zoe

    from cm3d_tpu_torch.models.verify_convert import has_problems, verify_zoe

    sd = tz.synth_zoedepth_state_dict(tz.ZOE_TEST, np.random.default_rng(6), ckpt_grid=(4, 4))
    sd["core.core.pretrained.model.blocks.0.attn.relative_position_index"] = np.zeros(
        (17, 17), np.int64)  # a buffer timm saves and nothing reads
    want = jax_verify_zoe(sd, cfg=jz.ZOE_TEST)
    got = verify_zoe(_torch_sd(sd), probe=True, cfg=tz.ZOE_TEST, device="cpu")
    assert set(got) == set(want) | {"activations"}
    assert got["coverage"] == want["coverage"]
    assert not has_problems(got) and not any(want["tree"].values())
    assert got["activations"] and all(np.isfinite(v["mean"]) for v in got["activations"].values())


def test_conform_zoe_family_verifies_converts_and_saves(tmp_path):
    """conform --zoe on a ZoeD_N-layout file (ZOE_TEST, a 4x4 checkpoint
    grid): the verify phase finds no problem, and the saved state dict
    loads strictly into ZoeDepth(ZOE_TEST)."""
    import argparse

    from cm3d_tpu_torch import conform
    from cm3d_tpu_torch.models.checkpoints import load_params

    sd = tz.synth_zoedepth_state_dict(tz.ZOE_TEST, np.random.default_rng(7), ckpt_grid=(4, 4))
    path = tmp_path / "zoe.pt"
    torch.save(_torch_sd(sd), path)
    args = argparse.Namespace(
        sam="", sam_size="vit_h", detic="", clip="", bpe="", zoe=str(path), gdino="",
        gdino_vocab="", probe=False, quant_int8=True, dataset="nuscenes", dataroot="",
        version="v1.0-mini", scenes="", out=str(tmp_path / "c"), fake_weights=False,
        skip_pipeline=False, skip_eval=False, device="cpu")
    report, rc = conform.run_conform(args, cfg_overrides={"zoe": tz.ZOE_TEST})
    entry = report["models"]["zoe"]
    assert rc == 0 and entry["ok"] and "converted_int8" not in entry  # nothing to quantize
    tz.ZoeDepth(tz.ZOE_TEST).load_state_dict(load_params(entry["converted"]))

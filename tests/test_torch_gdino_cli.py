"""GroundingDINO in the port's pipelines, against the JAX package's on the
CPU: the masks CLI with --detector gdino (f32, and with --quant_int8) on
the fabricated nuScenes dataroot of tests/nusc_fixture.py, the int8
detector against JAX's, verify_gdino and the verify_convert CLI, and
conform's gdino family. (The e2e CLI's --detector gdino runs in
tests/test_torch_e2e.py, at its cut-down lift.)

Both CLIs run --fake_weights: Detic and SAM on one set of weights (JAX's
jitted `init`, carried; tests/test_torch_quant_cli.py), GroundingDINO at
GDINO_TEST over each package's synthetic vocabulary on
`synth_gdino_state_dict` for that configuration (JAX's `init` returns it;
the port loads it through `gdino_state_dict_from_released`). Tolerances:
the float path's artifacts as tests/test_torch_masks.py holds them
(labels, cameras and RLE masks equal, scores within 1e-5); with
--quant_int8 scores within one int8 step of the largest score, as
tests/test_torch_quant_cli.py holds the quantized Detic.
"""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.models import gdino as jg

from cm3d_tpu_torch.models import gdino as tg
from cm3d_tpu_torch.pipelines import masks
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

INT8_STEP = 1.0 / 127


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    from nusc_fixture import VERSION, make_fake_nuscenes

    tmp = tmp_path_factory.mktemp("nusc")
    make_fake_nuscenes(tmp / "root", tmp / "planted", n_frames=1, n_objects=4)
    return tmp / "root", VERSION


@pytest.fixture(scope="module")
def fake_weights():
    from test_torch_quant_cli import make_fake_weights

    return make_fake_weights()


def _attach_pair(monkeypatch):
    """JAX's attach_gdino with its `init` returning the synthetic released
    weights for the configuration it asks for (kept), and the port's
    attach_gdino loading those weights."""
    seen = {}

    def init(self, *args, **kw):
        seen["sd"] = jg.synth_gdino_state_dict(self.cfg, np.random.default_rng(11))
        return {"params": jax.tree.map(jnp.asarray, jg.convert_gdino_params(seen["sd"],
                                                                            self.cfg))}

    real = masks.attach_gdino

    def port_attach(models, ckpt_path="", vocab_path="", test=False, device=None, **kw):
        sd = {k: torch.from_numpy(v) for k, v in seen["sd"].items()}
        return real(models, test=test, device=device, state_dict=sd, **kw)

    monkeypatch.setattr(jg.GroundingDino, "init", init)
    monkeypatch.setattr(masks, "attach_gdino", port_attach)


@pytest.mark.parametrize("extra", [[], ["--quant_int8"]])
def test_masks_cli_detector_gdino_matches_jax_cli(tmp_path, monkeypatch, nusc_root,
                                                  fake_weights, extra, one_torch_thread):
    from test_torch_quant_cli import _jax_fake_models, _port_fake_models, _read_frame

    from cm3d_tpu.pipelines import masks as jax_masks

    root, version = nusc_root
    _attach_pair(monkeypatch)
    monkeypatch.setattr(jax_masks, "build_fake_models", _jax_fake_models(fake_weights))
    monkeypatch.setattr(masks, "build_fake_models", _port_fake_models(fake_weights))
    argv = ["--dataroot", str(root), "--version", version, "--thumbnail", "96",
            "--fake_weights", "--detector", "gdino"] + extra
    jax_masks.main(argv + ["--out_dir", str(tmp_path / "jax")])
    masks.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    want, want_rles = _read_frame(tmp_path / "jax", "scene-0001", 0)
    got, got_rles = _read_frame(tmp_path / "port", "scene-0001", 0)
    assert len(want["labels"]) > 0
    assert got["labels"] == want["labels"] and got["cam_nums"] == want["cam_nums"]
    w = np.asarray(want["detection_scores"])
    tol = INT8_STEP * w.max() if extra else 1e-5
    np.testing.assert_allclose(got["detection_scores"], w, atol=tol)
    if not extra:
        assert got_rles == want_rles


def test_int8_detector_close_to_float_as_jax(monkeypatch):
    """--detector gdino --quant_int8 against JAX's, on the weights of
    tests/test_quant.py:330 (JAX's attach_gdino(test=True) init, made
    jitted, carried): the port's float and int8 detectors each equal JAX's
    (boxes within 1e-3 px, seen 3e-5; scores 1e-5, seen 1e-6; class ids and
    valid equal); as in that test, int8 keeps as many detections as float;
    and that test's closeness statistic (the share of float boxes within 2
    px of their nearest int8 box, and the matched pairs' scores) is the
    same in both packages. (Its bar of two thirds is not met on this draw
    by either package: camera 0 reads 7 of 12.)"""
    from cm3d_tpu.pipelines import masks as jax_masks

    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 255, (64, 64, 3)).astype(np.uint8) for _ in range(2)]
    init, seen = jg.GroundingDino.init, {}

    def jit_init(self, *args):
        seen["params"] = jax.jit(lambda *a: init(self, *a))(*args)["params"]
        return {"params": seen["params"]}

    monkeypatch.setattr(jg.GroundingDino, "init", jit_init)
    out = {}
    for quant in (False, True):
        jm = jax_masks.attach_gdino(jax_masks.MaskModels(None, None, None, None), test=True,
                                    quant_int8=quant, box_threshold=0.0)
        out["jax", quant] = [np.asarray(a) for a in jm.detic({"images": imgs})]
    sd = tg.gdino_state_dict_from_flax(jax.tree.map(np.asarray, seen["params"]), tg.GDINO_TEST)
    for quant in (False, True):
        pm = masks.attach_gdino(masks.MaskModels(None, None, None, None), test=True,
                                quant_int8=quant, box_threshold=0.0, device="cpu",
                                state_dict=sd)
        out["port", quant] = [t.numpy() for t in pm.detic({"images": imgs})]
    for quant in (False, True):
        (gb, gs, gc, gv), (wb, ws, wc, wv) = out["port", quant], out["jax", quant]
        np.testing.assert_allclose(gb, wb, atol=1e-3)
        np.testing.assert_allclose(gs, ws, atol=1e-5)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gv, wv)

    def closeness(pkg):
        (b_f, s_f, _, v_f), (b_q, s_q, _, v_q) = out[pkg, False], out[pkg, True]
        assert (v_f > 0).sum() == (v_q > 0).sum() > 0
        stats = []
        for cam in range(v_f.shape[0]):
            fi, qi = np.where(v_f[cam] > 0)[0], np.where(v_q[cam] > 0)[0]
            d = np.abs(b_f[cam, fi][:, None] - b_q[cam, qi][None]).max(-1)
            j = d.argmin(1)
            ok = d[np.arange(len(fi)), j] < 2.0
            stats.append((ok, s_q[cam, qi[j[ok]]] - s_f[cam, fi[ok]]))
        return stats

    for (ok_p, ds_p), (ok_j, ds_j) in zip(closeness("port"), closeness("jax")):
        np.testing.assert_array_equal(ok_p, ok_j)
        np.testing.assert_allclose(ds_p, ds_j, atol=1e-5)


def test_int8_model_holds_quantized_swin_mlps():
    """The int8 twin's state dict: every Swin block's fc1 / fc2 int8
    buffers, nothing else quantized; a quantized state dict without
    quant_int8 raises, naming GroundingDINO."""
    sd = {k: torch.from_numpy(v)
          for k, v in tg.synth_gdino_state_dict(tg.GDINO_TEST, np.random.default_rng(3)).items()}
    q = tg.quantize_gdino_state_dict(sd)
    quantized = {k[:-len(".weight_q")] for k in q if k.endswith(".weight_q")}
    assert quantized == {k[:-len(".weight")] for k in sd
                         if k.startswith("backbone.0.layers.") and ".mlp.fc" in k
                         and k.endswith(".weight")}
    base = masks.build_fake_models(seed=0, device="cpu")
    with pytest.raises(ValueError, match="GroundingDINO"):
        masks.attach_gdino(base, test=True, state_dict=q, device="cpu")
    models = masks.attach_gdino(base, test=True, state_dict=q, quant_int8=True, device="cpu")
    assert models.detic is not base.detic


def test_verify_gdino_report_matches_jax():
    """verify_gdino on a synthetic released-layout file (with `module.`
    prefixes, the decoder's bbox_embed aliases, bert.pooler and a Swin
    index buffer): the coverage report equals JAX's (its keys stripped of
    `module.`), no tree problem; --probe adds finite activations."""
    from cm3d_tpu.models.verify_convert import verify_gdino as jax_verify

    from cm3d_tpu_torch.models.verify_convert import has_problems, verify_gdino

    sd = tg.synth_gdino_state_dict(tg.GDINO_TEST, np.random.default_rng(6))
    sd["bert.pooler.dense.weight"] = np.zeros((16, 16), np.float32)
    sd["transformer.decoder.bbox_embed.0.layers.0.weight"] = sd["bbox_embed.0.layers.0.weight"]
    sd["backbone.0.layers.0.blocks.0.attn.relative_position_index"] = np.zeros((16, 16),
                                                                               np.int64)
    want = jax_verify(sd, cfg=jg.GDINO_TEST)
    got = verify_gdino({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()},
                       probe=True, cfg=tg.GDINO_TEST, device="cpu")
    assert set(got) == set(want) | {"activations"}
    assert got["coverage"] == want["coverage"]
    assert len(got["coverage"]["ignored"]) == 3
    assert not has_problems(got) and not any(want["tree"].values())
    assert got["activations"] and all(np.isfinite(v["mean"]) for v in got["activations"].values())


def test_verify_convert_cli_gdino(tmp_path, capsys, monkeypatch):
    """verify_convert --gdino on a trainer-style file ({"model": ...},
    `module.` keys), at GDINO_TEST (in place of GDINO_SWINT)."""
    from cm3d_tpu_torch.models import verify_convert

    monkeypatch.setattr(tg, "GDINO_SWINT", tg.GDINO_TEST)
    path = tmp_path / "gdino.pth"
    sd = tg.synth_gdino_state_dict(tg.GDINO_TEST, np.random.default_rng(0))
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    assert verify_convert.main(["--gdino", str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[gdino] consumed={len(sd)} ignored=0 missing=0 extra=0 mismatched=0" in out


def _conform_args(tmp_path, path, **kw):
    return argparse.Namespace(**{**dict(
        sam="", sam_size="vit_h", detic="", clip="", bpe="", zoe="", gdino=str(path),
        gdino_vocab="", probe=False, quant_int8=True, dataset="nuscenes", dataroot="",
        version="v1.0-mini", scenes="", out=str(tmp_path / "c"), fake_weights=False,
        skip_pipeline=False, skip_eval=False, device="cpu"), **kw})


def test_conform_gdino_family_verifies_converts_and_saves(tmp_path):
    """conform --gdino --quant_int8 on a released-layout file (GDINO_TEST):
    the verify phase finds no problem, `gdino_swint` and `gdino_swint_int8`
    are saved, and each loads strictly into its model."""
    from cm3d_tpu_torch import conform
    from cm3d_tpu_torch.models.checkpoints import load_params

    sd = tg.synth_gdino_state_dict(tg.GDINO_TEST, np.random.default_rng(7))
    path = tmp_path / "gdino.pth"
    torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}}, path)
    report, rc = conform.run_conform(_conform_args(tmp_path, path),
                                     cfg_overrides={"gdino": tg.GDINO_TEST})
    entry = report["models"]["gdino"]
    assert rc == 0 and entry["ok"] and entry["verify"]["consumed"] == len(sd)
    assert entry["converted"].endswith("gdino_swint")
    tg.GroundingDino(tg.GDINO_TEST).load_state_dict(load_params(entry["converted"]))
    qcfg = tg.gdino_config(tg.GDINO_TEST, quant_int8=True)
    tg.GroundingDino(qcfg).load_state_dict(load_params(entry["converted_int8"]))

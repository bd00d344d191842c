"""The port's masks CLI with --quant_int8 and --quant_static against the
JAX package's CLI on the CPU, on the fabricated nuScenes dataroot of
tests/nusc_fixture.py.

Both CLIs run --fake_weights on one set of float weights: JAX's
build_fake_models' (made with a jitted init), carried into the port
(`models/convert.py`), where the port quantizes them itself; so both run the
same int8 models (the static one calibrating on the first ring). Tolerance: labels and cameras equal, as
tests/test_torch_masks.py holds the float path; but not the float path's
1e-5 on scores and RLE equality: the int8 Swin MLPs and SAM encoder pass an
f32 summation-order difference on as an int8 rounding flip, so scores are
held within one int8 step of the largest score (seen: 2e-4) and every mask
to an IoU above 0.99 with JAX's (seen: at least 0.998, a few boundary
pixels of about 3000).
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cm3d_tpu.models.detic import DETIC_TEST as JAX_DETIC_TEST
from cm3d_tpu.models.detic import Detic as JaxDetic
from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu.models.sam import Sam as JaxSam

from cm3d_tpu_torch.models.convert import detic_state_dict_from_flax, sam_state_dict_from_flax
from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
from cm3d_tpu_torch.models.sam import SAM_TEST, Sam
from cm3d_tpu_torch.ops import rle
from cm3d_tpu_torch.pipelines import masks
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

INT8_STEP = 1.0 / 127


def _read_frame(root, scene, f):
    with open(os.path.join(root, scene, f"{f}_data.json")) as fh:
        data = json.load(fh)
    with open(os.path.join(root, scene, f"{f}_masks.pkl"), "rb") as fh:
        return data, pickle.load(fh)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    from nusc_fixture import VERSION, make_fake_nuscenes

    tmp = tmp_path_factory.mktemp("nusc")
    make_fake_nuscenes(tmp / "root", tmp / "planted", n_frames=2, n_objects=4)
    return tmp / "root", VERSION


@pytest.fixture(scope="module")
def fake_weights():
    return make_fake_weights()


def make_fake_weights():
    """JAX build_fake_models' weights (seed 0: DETIC_TEST from PRNGKey(0),
    SAM_TEST from PRNGKey(1), the classifier from default_rng(0)), made
    with a jitted `init` (the eager one compiles each op, about a minute on
    the CPU)."""
    from cm3d_tpu.vocab import CUSTOM_VOCABULARY_NUSCENES

    rng = np.random.default_rng(0)
    clf = rng.standard_normal((JAX_DETIC_TEST.embed_dim, len(CUSTOM_VOCABULARY_NUSCENES)))
    clf = clf.astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    dp = jax.tree.map(np.asarray, jax.jit(JaxDetic(JAX_DETIC_TEST).init)(
        jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)), jnp.asarray(clf))["params"])
    sp = jax.tree.map(np.asarray, jax.jit(JaxSam(JAX_SAM_TEST).init)(
        jax.random.PRNGKey(1), jnp.zeros((64, 64, 3)), jnp.zeros((1, 4)))["params"])
    return clf, dp, sp


def _jax_fake_models(weights):
    """JAX's build_fake_models, line for line, on `weights`."""
    from cm3d_tpu.models.detic import quantize_detic_params
    from cm3d_tpu.models.sam import quantize_sam_params
    from cm3d_tpu.pipelines.masks import _batched_model_fns

    def build(vocabulary=None, rect_encode=False, mesh=None, encode_chunk=1,
              quant_int8=False, quant_static=False, detic_used=True, **kw):
        clf, dp, sp = weights
        detic_model = JaxDetic(JAX_DETIC_TEST)
        sam_model = JaxSam(dataclasses.replace(JAX_SAM_TEST, rect_encode=rect_encode))
        if quant_int8:
            sam_model = JaxSam(dataclasses.replace(
                JAX_SAM_TEST, rect_encode=rect_encode, quant_int8=True,
                quant_static=quant_static))
            sp = quantize_sam_params(sp)
            detic_model = JaxDetic(dataclasses.replace(
                JAX_DETIC_TEST, swin=dataclasses.replace(JAX_DETIC_TEST.swin, quant_int8=True)))
            dp = quantize_detic_params(dp)
        return _batched_model_fns(detic_model, dp, jnp.asarray(clf), sam_model, sp,
                                  vocabulary, mesh=mesh, encode_chunk=encode_chunk)

    return build


def _port_fake_models(weights):
    """The port's build_fake_models on the same weights, carried over; the
    port quantizes them itself."""
    def build(vocabulary=None, quant_int8=False, quant_static=False, device=None, **kw):
        clf, dp, sp = weights
        detic, sam = Detic(DETIC_TEST), Sam(SAM_TEST)
        detic.load_state_dict(detic_state_dict_from_flax(dp, DETIC_TEST))
        sam.load_state_dict(sam_state_dict_from_flax(sp, SAM_TEST))
        detic, sam = masks.quantized_models(detic, sam, quant_int8, quant_static)
        return masks._batched_model_fns(detic, clf, sam, vocabulary, device=device)

    return build


@pytest.mark.parametrize("extra", [["--quant_int8"], ["--quant_int8", "--quant_static"]])
def test_masks_cli_int8_matches_jax_cli(tmp_path, monkeypatch, nusc_root, fake_weights,
                                       extra, one_torch_thread):
    from cm3d_tpu.pipelines import masks as jax_masks

    root, version = nusc_root
    argv = ["--dataroot", str(root), "--version", version, "--thumbnail", "96",
            "--fake_weights"] + extra
    monkeypatch.setattr(jax_masks, "build_fake_models", _jax_fake_models(fake_weights))
    jax_masks.main(argv + ["--out_dir", str(tmp_path / "jax")])
    monkeypatch.setattr(masks, "build_fake_models", _port_fake_models(fake_weights))
    masks.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    n = 0
    for f in range(2):
        want, want_rles = _read_frame(tmp_path / "jax", "scene-0001", f)
        got, got_rles = _read_frame(tmp_path / "port", "scene-0001", f)
        assert got["labels"] == want["labels"] and got["cam_nums"] == want["cam_nums"]
        w = np.asarray(want["detection_scores"])
        assert np.abs(np.asarray(got["detection_scores"]) - w).max() <= INT8_STEP * w.max()
        assert len(got_rles) == len(want_rles)
        for a, b in zip(got_rles, want_rles):
            ma, mb = rle.decode(a).astype(bool), rle.decode(b).astype(bool)
            assert (ma & mb).sum() > 0.99 * (ma | mb).sum()
        n += len(want_rles)
    assert n > 0

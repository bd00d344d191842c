"""The port's Swin and Detic (and the ops Detic runs) against the JAX
package on the CPU, at SWIN_TEST / DETIC_TEST sizes, f32.

Weights come from the JAX models' `init`, carried into the port by
`cm3d_tpu_torch/models/convert.py`; inputs are numpy from a seed.
Tolerances: feature maps and logits within 1e-5 of their largest
magnitude, boxes within 1e-4 px and scores within 1e-5 (summation order
and the LayerNorm variance formula differ, nothing else); class ids, valid
flags and NMS keep sets equal (no score of these inputs lies within 1e-5 of
a threshold, which each test checks first).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.models.convert_detic import convert_detic_params
from cm3d_tpu.models.detic import DETIC_TEST as JAX_DETIC_TEST
from cm3d_tpu.models.detic import Detic as JaxDetic
from cm3d_tpu.models.detic import apply_deltas as jax_apply_deltas
from cm3d_tpu.models.detic import decode_proposals as jax_decode_proposals
from cm3d_tpu.models.detic import select_detections as jax_select_detections
from cm3d_tpu.models.swin import SwinTransformer as JaxSwin
from cm3d_tpu.ops.nms import nms_2d_classwise as jax_nms_2d
from cm3d_tpu.ops.roi_align import roi_align as jax_roi_align

from cm3d_tpu_torch.kernels.window_attn import rel_pos_index
from cm3d_tpu_torch.models.convert import detic_state_dict_from_flax, swin_state_dict_from_flax
from cm3d_tpu_torch.models.detic import (
    DETIC_TEST,
    Detic,
    apply_deltas,
    decode_proposals,
    select_detections,
)
from cm3d_tpu_torch.models.swin import SWIN_TEST, SwinTransformer, shrunk_table
from cm3d_tpu_torch.ops.nms import nms_2d_classwise
from cm3d_tpu_torch.ops.roi_align import roi_align

N_CLASSES = 19


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def detic_params():
    rng = np.random.default_rng(7)
    clf = rng.standard_normal((JAX_DETIC_TEST.embed_dim, N_CLASSES)).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    model = JaxDetic(JAX_DETIC_TEST)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)), clf)["params"]
    return jax.tree.map(np.asarray, params), clf


def _assert_rel(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("hw", [(64, 64), (40, 56)])  # 40x56: maps not divisible by window
@pytest.mark.parametrize("fused", ["interpret", False])  # Pallas interpret / the XLA branch
def test_swin_matches_jax(detic_params, hw, fused):
    params, _ = detic_params
    x = np.random.default_rng(hw[1]).standard_normal((2, *hw, 3)).astype(np.float32)
    jax_swin = JaxSwin(dataclasses.replace(JAX_DETIC_TEST.swin, fused_attn=fused))
    want = jax.jit(jax_swin.apply)({"params": params["backbone"]}, x)
    swin = SwinTransformer(SWIN_TEST)
    swin.load_state_dict(swin_state_dict_from_flax(params["backbone"], SWIN_TEST, prefix=""))
    with torch.no_grad():
        got = swin(_t(x))
    assert sorted(got) == sorted(want) == ["swin0", "swin1"]
    for k in want:
        _assert_rel(got[k].numpy(), want[k])


@pytest.mark.parametrize("fused", ["interpret", False])
def test_swin_shrunk_window_matches_jax(fused):
    """A 24x40 input leaves stage 1 a 3x5 map, so its window shrinks from 4
    to 3 (no shift). JAX then holds a (2*3-1)^2-row bias table; the port
    keeps its (2*4-1)^2-row table and reads a 3-window's offsets from the
    centre, so JAX's table is carried into that centre and the rest of the
    table is noise the port must not read."""
    x = np.random.default_rng(3).standard_normal((2, 24, 40, 3)).astype(np.float32)
    jax_swin = JaxSwin(dataclasses.replace(JAX_DETIC_TEST.swin, fused_attn=fused))
    params = jax.tree.map(np.asarray, jax.jit(jax_swin.init)(jax.random.PRNGKey(1), x)["params"])
    want = jax.jit(jax_swin.apply)({"params": params}, x)
    sd = swin_state_dict_from_flax(params, SWIN_TEST, prefix="")
    side, heads = 2 * SWIN_TEST.window_size - 1, SWIN_TEST.num_heads[1]
    noise = np.random.default_rng(4)
    for j in range(SWIN_TEST.depths[1]):
        key = f"layers.1.blocks.{j}.attn.relative_position_bias_table"
        # the converter carries JAX's 5 x 5 table into the centre of a zero
        # 7 x 7 one; the surround becomes noise here
        small = params[f"stage1_block{j}"]["attn"]["rel_pos_bias_table"]
        assert tuple(small.shape) == (5 * 5, heads)
        assert tuple(sd[key].shape) == (side * side, heads)
        carried = sd[key].numpy().reshape(side, side, heads)
        np.testing.assert_array_equal(carried[1:6, 1:6], small.reshape(5, 5, heads))
        assert np.count_nonzero(carried) == np.count_nonzero(small)  # zero around it
        full = noise.standard_normal((side, side, heads)).astype(np.float32)
        full[1:6, 1:6] = carried[1:6, 1:6]
        sd[key] = torch.from_numpy(full.reshape(-1, heads))
    swin = SwinTransformer(SWIN_TEST)
    swin.load_state_dict(sd)
    with torch.no_grad():
        got = swin(_t(x))
    assert got["swin1"].shape[1:3] == (3, 5)
    for k in want:
        _assert_rel(got[k].numpy(), want[k])


@pytest.mark.parametrize("window,win", [(7, 7), (7, 5), (4, 1)])
def test_shrunk_table_keeps_each_offset_bias(window, win):
    """Two tokens of a shrunk window get the bias the full window's table
    holds for their relative offset."""
    table = torch.arange((2 * window - 1) ** 2 * 3, dtype=torch.float32).reshape(-1, 3)
    small = shrunk_table(table, window, win)
    assert tuple(small.shape) == ((2 * win - 1) ** 2, 3)
    ys, xs = np.divmod(np.arange(win * win), win)
    full_index = ((ys[:, None] - ys[None] + window - 1) * (2 * window - 1)
                  + xs[:, None] - xs[None] + window - 1)
    np.testing.assert_array_equal(small[torch.from_numpy(rel_pos_index(win))].numpy(),
                                  table[torch.from_numpy(full_index)].numpy())


def test_detic_weights_round_trip_bit_exact(detic_params):
    params, _ = detic_params
    sd = detic_state_dict_from_flax(params, DETIC_TEST)
    back = convert_detic_params({k: v.numpy() for k, v in sd.items()}, JAX_DETIC_TEST)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    model = Detic(DETIC_TEST)
    model.load_state_dict(sd)  # strict: the port's keys are exactly these


def test_detic_matches_jax(detic_params):
    params, clf = detic_params
    rng = np.random.default_rng(11)
    images = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    true_hw = np.array([[60, 90], [64, 70]], np.int32)
    jax_model = JaxDetic(JAX_DETIC_TEST)
    apply = jax.jit(jax_model.apply)
    model = Detic(DETIC_TEST)
    model.load_state_dict(detic_state_dict_from_flax(params, DETIC_TEST))
    with torch.no_grad():
        got = model(_t(images), _t(clf), _t(true_hw))
    n_valid = 0
    for i in range(2):
        want = apply({"params": params}, images[i], clf, true_hw[i])
        s = np.asarray(want.scores)
        assert np.abs(s - JAX_DETIC_TEST.score_thresh).min() > 1e-5
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes[i].numpy(), np.asarray(want.classes))
        np.testing.assert_allclose(got.boxes[i].numpy(), np.asarray(want.boxes), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got.scores[i].numpy(), s, rtol=0, atol=1e-5)
        n_valid += int(np.asarray(want.valid).sum())
        assert (got.boxes[i, :, 2].numpy() <= true_hw[i, 1]).all()
    assert n_valid > 0


def test_roi_align_matches_jax():
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 12, 16, 8)).astype(np.float32)
    xy = rng.uniform(-3, 15, (2, 20, 2))
    wh = rng.uniform(0.0, 9, (2, 20, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = [-2.5, -2.0, -1.2, -1.1]  # every sample outside [-1, size]: zeros
    boxes[1, 1] = [14.0, 10.0, 17.5, 13.0]  # clamped at the far edges
    got = roi_align(_t(feats), _t(boxes), 7).numpy()
    for i in range(2):
        want = np.asarray(jax_roi_align(feats[i], boxes[i], 7))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-5)
    assert not got[0, 0].any()


@pytest.mark.parametrize("thresh", [0.3, 0.5, 0.75])
def test_nms_2d_classwise_matches_jax(thresh):
    rng = np.random.default_rng(int(thresh * 100))
    xy = rng.uniform(0, 40, (3, 80, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 15, (3, 80, 2))], -1).astype(np.float32)
    boxes[:, :4, 2:] = boxes[:, :4, :2]  # zero-area boxes: IoU 0 by the union rule
    scores = rng.choice(np.linspace(0.1, 1, 12), (3, 80)).astype(np.float32)  # many ties
    labels = rng.integers(0, 3, (3, 80))
    valid = rng.random((3, 80)) < 0.9
    got = nms_2d_classwise(_t(boxes), _t(scores), _t(labels), _t(valid), thresh).numpy()
    for i in range(3):
        want = np.asarray(jax_nms_2d(boxes[i], scores[i], labels[i].astype(np.int32), valid[i],
                                     thresh))
        np.testing.assert_array_equal(got[i], want)
    assert got.sum() > 0 and not (got & ~valid).any()


def test_decode_proposals_matches_jax():
    rng = np.random.default_rng(5)
    shapes = {3: (16, 16), 4: (8, 8)}
    hms = {lvl: rng.standard_normal((1, *hw)).astype(np.float32) for lvl, hw in shapes.items()}
    regs = {lvl: rng.uniform(0, 3, (1, *hw, 4)).astype(np.float32)
            for lvl, hw in shapes.items()}
    strides = {3: 8, 4: 16}
    want_b, want_s = jax_decode_proposals(hms, regs, strides, JAX_DETIC_TEST)
    got_b, got_s = decode_proposals({k: _t(v) for k, v in hms.items()},
                                    {k: _t(v) for k, v in regs.items()}, strides, DETIC_TEST)
    np.testing.assert_allclose(got_b[0].numpy(), np.asarray(want_b), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_s[0].numpy(), np.asarray(want_s), rtol=0, atol=1e-6)


def test_select_detections_and_apply_deltas_match_jax():
    rng = np.random.default_rng(9)
    xy = rng.uniform(0, 50, (2, 32, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (2, 32, 2))], -1).astype(np.float32)
    deltas = rng.standard_normal((2, 32, 4)).astype(np.float32) * 3
    deltas[0, 0, 2] = 60.0  # clipped at log(1000/16)
    weights = (10.0, 10.0, 5.0, 5.0)
    got_ref = apply_deltas(_t(boxes), _t(deltas), weights).numpy()
    scores = (rng.random((2, 32, N_CLASSES)) ** 3).astype(np.float32)
    got = select_detections(_t(boxes), _t(scores), DETIC_TEST)
    for i in range(2):
        np.testing.assert_allclose(got_ref[i], np.asarray(
            jax_apply_deltas(boxes[i], deltas[i], weights)), rtol=1e-6, atol=1e-4)
        assert np.abs(scores[i] - DETIC_TEST.score_thresh).min() > 1e-5
        want = jax_select_detections(boxes[i], scores[i], JAX_DETIC_TEST)
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.classes[i].numpy(), np.asarray(want.classes))
        np.testing.assert_array_equal(got.boxes[i].numpy(), np.asarray(want.boxes))
        np.testing.assert_array_equal(got.scores[i].numpy(), np.asarray(want.scores))
    assert got.valid.all()

"""The port's SAM and mask postprocess against the JAX package on the CPU,
at SAM_TEST size, f32.

Weights come from the JAX model's `init` (zero-initialised tables replaced
by numpy noise, so the decomposed rel-pos path computes something), carried
into the port by `cm3d_tpu_torch/models/convert.py`. Tolerances: embeddings
and logits within 1e-5 of their largest magnitude (summation order only);
packed planes bit-equal away from upsampled logits within 1e-4 of 0.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cm3d_tpu.models.common import get_rel_pos as jax_get_rel_pos
from cm3d_tpu.models.convert_sam import convert_sam_params
from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu.models.sam import Sam as JaxSam
from cm3d_tpu.ops.bitmask import unpack_masks_np
from cm3d_tpu.ops.maskpack import make_plane_postprocess as jax_plane_postprocess

from cm3d_tpu_torch.models.convert import sam_state_dict_from_flax
from cm3d_tpu_torch.models.sam import SAM_TEST, Sam
from cm3d_tpu_torch.ops.maskpack import make_plane_postprocess
from cm3d_tpu_torch.ops.relpos_attn import get_rel_pos


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def sam_params():
    model = JaxSam(JAX_SAM_TEST)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((64, 64, 3)),
                                 jnp.zeros((1, 4)))["params"]
    params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(0)
    enc = params["image_encoder"]
    enc["pos_embed"] = 0.1 * rng.standard_normal(enc["pos_embed"].shape).astype(np.float32)
    for i in range(JAX_SAM_TEST.encoder_depth):
        attn = enc[f"block{i}"]["attn"]
        for k in ("rel_pos_h", "rel_pos_w"):
            attn[k] = 0.3 * rng.standard_normal(attn[k].shape).astype(np.float32)
    return params


def _models(params, rect=False):
    jax_model = JaxSam(dataclasses.replace(JAX_SAM_TEST, rect_encode=rect))
    model = Sam(dataclasses.replace(SAM_TEST, rect_encode=rect))
    model.load_state_dict(sam_state_dict_from_flax(params, SAM_TEST))
    return jax_model, model.eval()


def _assert_rel(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_sam_weights_round_trip_bit_exact(sam_params):
    sd = sam_state_dict_from_flax(sam_params, SAM_TEST)
    back = convert_sam_params({k: v.numpy() for k, v in sd.items()}, JAX_SAM_TEST)
    assert jax.tree.structure(back) == jax.tree.structure(sam_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(sam_params)):
        assert a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)
    Sam(SAM_TEST).load_state_dict(sd)  # strict: the port's keys are exactly these


# (image h, w, rect_encode): the padded square, and a rect encode whose 3x4
# token grid makes the global block interpolate its rel-pos tables
@pytest.mark.parametrize("h,w,rect", [(64, 64, False), (48, 64, True)])
def test_sam_encode_and_decode_match_jax(sam_params, h, w, rect):
    jax_model, model = _models(sam_params, rect)
    rng = np.random.default_rng(h)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    want_emb = np.asarray(jax.jit(lambda p, x: jax_model.apply(
        {"params": p}, x, method=jax_model.encode_image))(sam_params, x))
    with torch.no_grad():
        got_emb = model.encode_image(_t(x)).numpy()
    _assert_rel(got_emb, want_emb)
    boxes = np.array([[3, 4, 40, 30], [10, 10, 30, 20], [0, 0, w - 1, h - 1],
                      [0, 0, 0, 0]], np.float32)
    want_lg, want_iou = jax.jit(lambda p, e, b: jax_model.apply(
        {"params": p}, e, b, method=jax_model.decode_boxes))(sam_params, want_emb[1], boxes)
    with torch.no_grad():
        got_lg, got_iou = model.decode_boxes(_t(want_emb[1]), _t(boxes))
    assert got_lg.shape == (4, 4 * want_emb.shape[1], 4 * want_emb.shape[2])
    _assert_rel(got_lg.numpy(), want_lg)
    _assert_rel(got_iou.numpy(), want_iou)


@pytest.mark.parametrize("q,k,n", [(4, 4, 7), (3, 3, 7), (14, 14, 27), (5, 9, 17)])
def test_get_rel_pos_matches_jax(q, k, n):
    table = np.random.default_rng(n).standard_normal((n, 6)).astype(np.float32)
    np.testing.assert_allclose(get_rel_pos(q, k, _t(table)).numpy(),
                               np.asarray(jax_get_rel_pos(q, k, table)), rtol=0, atol=1e-6)


def test_upsample_edges_match_jax_resize():
    """F.interpolate(bilinear, align_corners=False) is jax.image.resize's
    bilinear for upsampling, edge rows and columns included."""
    lg = np.random.default_rng(2).standard_normal((3, 16, 16)).astype(np.float32)
    want = np.asarray(jax.image.resize(lg, (3, 52, 52), "bilinear"))
    got = F.interpolate(_t(lg)[:, None], size=(52, 52), mode="bilinear",
                        align_corners=False)[:, 0].numpy()
    for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["xy", "yx"])
@pytest.mark.parametrize("rect", [False, True])
def test_plane_postprocess_matches_jax(layout, rect):
    rng = np.random.default_rng(3 + rect)
    cam_hw = ((30, 40), (40, 24), (36, 36))
    mask_wh = (40, 40)
    p = 12
    logits = rng.standard_normal((3, p, 10, 10)).astype(np.float32) * 3
    # 10 masks in one word; 36 masks in two; 36 masks over a one-word capacity
    cases = ((1, np.array([4, 0, 6])), (2, np.array([12, 12, 12])), (1, np.array([12, 12, 12])))
    for n_words, nb in cases:
        want = np.asarray(jax_plane_postprocess(mask_wh, cam_hw, n_words, rect=rect,
                                                layout=layout)(logits, nb))
        got = make_plane_postprocess(mask_wh, cam_hw, n_words, rect=rect, layout=layout)(
            _t(logits), nb).numpy().view(np.uint32)
        assert got.shape == want.shape
        # bits whose upsampled logit is within 1e-4 of 0 may differ
        near = np.zeros((32 * n_words,) + mask_wh, bool)
        off = 0
        for c, (h, w) in enumerate(cam_hw):
            up_hw = (40, 40) if rect else (max(h, w),) * 2
            up = np.asarray(jax.image.resize(logits[c], (p,) + up_hw, "bilinear"))[:, :h, :w]
            k = min(int(nb[c]), 32 * n_words - off)
            if k > 0:
                near[off:off + k, :w, :h] = (np.abs(up[:k]) < 1e-4).transpose(0, 2, 1)
            off += int(nb[c])
        if layout == "yx":
            got, want = np.swapaxes(got, 0, 1), np.swapaxes(want, 0, 1)
        g, wnt = unpack_masks_np(got, 32 * n_words), unpack_masks_np(want, 32 * n_words)
        assert not ((g != wnt) & ~near).any()
        assert wnt.any()


def test_unported_sam_options_raise():
    # "interpret" names the JAX package's Pallas interpreter: not a mode here
    with pytest.raises(ValueError, match="interpret"):
        Sam(dataclasses.replace(SAM_TEST, fused_window_attn="interpret"))
    # int8 is ported (A12); with the fused windowed blocks it is refused, as in JAX
    Sam(dataclasses.replace(SAM_TEST, quant_int8=True))
    with pytest.raises(ValueError, match="mutually exclusive"):
        dataclasses.replace(SAM_TEST, quant_int8=True, fused_window_attn=True)


# window 3 on SAM_TEST's 4x4 token grid pads it to 6x6 (the padding path of
# tests/test_window_attn_pallas.py test_sam_encoder_fused_full_parity); the
# (48, 64) rect encode gives a 3x4 grid
@pytest.mark.parametrize("h,w,rect", [(64, 64, False), (48, 64, True)])
def test_fused_sam_encoder_matches_jax_fused_and_unfused(sam_params, h, w, rect):
    """The port's fused encoder (the kernel's plain version on the CPU)
    against the JAX fused encoder in interpret mode, the JAX unfused one and
    the port's own unfused one, f32, 3e-4 (the JAX package's own bound
    between its two encoders); one state dict loads into both modes."""
    cfg = dataclasses.replace(SAM_TEST, window_size=3, rect_encode=rect)
    jax_cfg = dataclasses.replace(JAX_SAM_TEST, window_size=3, rect_encode=rect)
    # window 3's tables are [5, hd]: fresh noise of that shape
    params = jax.tree.map(np.array, sam_params)
    rng = np.random.default_rng(5)
    attn = params["image_encoder"]["block0"]["attn"]
    hd = cfg.encoder_dim // cfg.encoder_heads
    for k in ("rel_pos_h", "rel_pos_w"):
        attn[k] = 0.3 * rng.standard_normal((5, hd)).astype(np.float32)
    sd = sam_state_dict_from_flax(params, cfg)
    unfused, fused = Sam(cfg).eval(), Sam(dataclasses.replace(cfg, fused_window_attn=True)).eval()
    unfused.load_state_dict(sd)
    fused.load_state_dict(sd)  # strict: same keys in both modes
    assert [b.fused for b in fused.image_encoder.blocks] == [True, False]
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    with torch.no_grad():
        got = fused.encode_image(_t(x)).numpy()
        own = unfused.encode_image(_t(x)).numpy()
    for mode in ("interpret", False):
        jax_model = JaxSam(dataclasses.replace(jax_cfg, fused_window_attn=mode))
        want = np.asarray(jax_model.apply({"params": params}, x, method=jax_model.encode_image))
        np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, own, rtol=3e-4, atol=3e-4)
    assert np.abs(got - own).max() > 0  # the two paths do round differently

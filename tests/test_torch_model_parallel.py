"""Model parallelism in the port (`cm3d_tpu_torch/parallel/sharding.py`,
`parallel/mesh.py make_mesh`, the camera-parallel mask stage of
`pipelines/masks.py`) on gloo ranks on the CPU, against the JAX package's
`cm3d_tpu/parallel/sharding.py` and its camera-parallel mask stage.

Tolerances are JAX's own (tests/test_model_sharding.py, tests/test_quant.py):
the tensor-sharded SAM forward within 2e-4 of the unsharded one (float and
int8); the sequence-sharded encode within 2e-5 (int8: 2e-4); the
camera-parallel frame masks with equal labels and cameras, scores within
rtol 1e-5 / atol 1e-6 and bit-equal masks. Against JAX's unsharded results
the port is held where tests/test_torch_sam.py, tests/test_torch_masks.py
and tests/test_torch_quant_cli.py hold it unsharded.

Weights come from JAX's jitted `init` of DETIC_TEST / SAM_TEST, carried
across with `*_state_dict_from_flax`. The groups (about 4 s a start) are
shared between cases: one at a time, the tests of one mesh adjacent.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.models.clip_text import convert_clip_text_params
from cm3d_tpu.models.detic import DETIC_TEST as JAX_DETIC_TEST
from cm3d_tpu.models.detic import Detic as JaxDetic
from cm3d_tpu.models.detic import quantize_detic_params
from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu.models.sam import Sam as JaxSam
from cm3d_tpu.models.sam import quantize_sam_params
from cm3d_tpu.parallel.sharding import spec_tree as jax_spec_tree
from cm3d_tpu.pipelines.masks import _batched_model_fns as jax_model_fns
from cm3d_tpu.pipelines.masks import generate_frame_masks as jax_generate_frame_masks

from cm3d_tpu_torch.models.clip_text import CLIP_TEXT_TEST, ClipTextEncoder, init_clip_weights
from cm3d_tpu_torch.models.convert import detic_state_dict_from_flax, sam_state_dict_from_flax
from cm3d_tpu_torch.models.detic import DETIC_TEST
from cm3d_tpu_torch.models.sam import SAM_TEST
from cm3d_tpu_torch.parallel import make_mesh
from cm3d_tpu_torch.parallel.mesh import Program
from cm3d_tpu_torch.parallel.sharding import param_spec, spec_tree
from cm3d_tpu_torch.pipelines import masks
from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES as VOCAB
from test_torch_quant_cli import INT8_STEP, make_fake_weights
from torch_parallel_programs import detic_module, mask_models, mesh_groups, sam_module
from torch_parallel_programs import sharded_detic, sharded_sam

CPUS = [torch.device("cpu")] * 4
PROGRAMS = "torch_parallel_programs"
QUANT_SAM = dataclasses.replace(JAX_SAM_TEST, quant_int8=True)


groups = pytest.fixture(scope="module")(mesh_groups)


@pytest.fixture(scope="module")
def weights():
    """JAX build_fake_models' float weights and their int8 twins (JAX's
    quantize_*_params), as flax trees and as the port's state dicts."""
    clf, dp, sp = make_fake_weights()
    qdp = jax.tree.map(np.asarray, quantize_detic_params(dp))
    qsp = jax.tree.map(np.asarray, quantize_sam_params(sp))
    return {"clf": clf, "dp": dp, "sp": sp, "qdp": qdp, "qsp": qsp,
            "detic_sd": detic_state_dict_from_flax(dp, DETIC_TEST),
            "sam_sd": sam_state_dict_from_flax(sp, SAM_TEST),
            "qsam_sd": sam_state_dict_from_flax(qsp, SAM_TEST)}


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32)


# --- the rules -------------------------------------------------------------------

def test_param_spec_rules():
    """JAX's test_param_spec_rules and tests/test_quant.py:416-421 on the
    port's names: torch weights are [out, in], so JAX's P(None, 'model')
    on a [in, out] kernel is ("model", None) here."""
    col, row = ("model", None), (None, "model")
    assert param_spec("image_encoder.blocks.0.attn.qkv.weight", 2) == col
    assert param_spec("image_encoder.blocks.0.attn.proj.weight", 2) == row
    assert param_spec("blocks.1.mlp.lin1.weight", 2) == col
    assert param_spec("blocks.1.mlp.lin2.weight", 2) == row
    assert param_spec("image_encoder.pos_embed", 4) == ()
    assert param_spec("image_encoder.neck.0.weight", 4) == ()
    assert param_spec("odd.fc1.weight", 1) == ()  # the full spec outranks the tensor
    assert param_spec("blocks.0.attn.qkv.bias", 1) == ("model",)
    assert param_spec("blocks.0.attn.qkv.weight_q", 2) == col
    assert param_spec("blocks.0.attn.qkv.weight_scale", 1) == ("model",)
    assert param_spec("blocks.0.attn.proj.weight_q", 2) == row
    assert param_spec("blocks.0.attn.proj.weight_scale", 1) == ()
    assert param_spec("blocks.0.mlp.lin1.weight_q", 2) == col
    assert param_spec("blocks.0.mlp.lin2.weight_q", 2) == row
    # CLIP's fused in_proj and its MLP (JAX's in_proj / mlp_fc / mlp_proj)
    assert param_spec("transformer.resblocks.0.attn.in_proj_weight", 2) == col
    assert param_spec("transformer.resblocks.0.attn.in_proj_bias", 1) == ("model",)
    assert param_spec("transformer.resblocks.0.mlp.c_fc.weight", 2) == col
    assert param_spec("transformer.resblocks.0.mlp.c_proj.weight", 2) == row
    assert param_spec("mask_decoder.transformer.layers.0.self_attn.q_proj.weight", 2) == ()


def _jax_sharded(spec) -> bool:
    return any(axis is not None for axis in spec)


def _markers(tree):
    """Each leaf of a flax tree as ones where JAX's spec_tree shards it,
    zeros where it replicates."""
    return jax.tree.map(lambda x, s: np.full(np.shape(x), float(_jax_sharded(s)), np.float32),
                        tree, jax_spec_tree(tree))


def _sharded(sd: dict) -> set:
    return {k for k, v in sd.items() if v.numel() and bool((v != 0).all())}


@pytest.mark.parametrize("model", ["sam", "detic", "clip"])
def test_rules_shard_the_tensors_jax_shards(model):
    """The rules catch the same tensors as JAX's on the flax trees: each JAX
    leaf carried across as ones where JAX's spec_tree shards it, zeros
    elsewhere (CLIP the other way: the port's markers carried into the JAX
    tree), and the two sets are equal."""
    if model == "clip":
        cfg = CLIP_TEXT_TEST
        sd = init_clip_weights(ClipTextEncoder(cfg), torch.Generator().manual_seed(0)).state_dict()
        specs = spec_tree(sd)
        marked = {k: np.full(tuple(v.shape), float(len(specs[k]) > 0), np.float32)
                  for k, v in sd.items()}
        tree = convert_clip_text_params(marked, cfg)
        want = jax.tree.leaves(jax.tree.map(_jax_sharded, jax_spec_tree(tree)))
        got = [bool((np.asarray(x) != 0).all()) for x in jax.tree.leaves(tree)]
        assert got == want and sum(want) == 6 * cfg.layers  # 4 column, 2 row a block
        return
    if model == "sam":
        shapes = jax.eval_shape(JaxSam(JAX_SAM_TEST).init, jax.random.PRNGKey(0),
                                jnp.zeros((64, 64, 3)), jnp.zeros((1, 4)))["params"]
        to_port = lambda t: sam_state_dict_from_flax(t, SAM_TEST)  # noqa: E731
    else:
        shapes = jax.eval_shape(JaxDetic(JAX_DETIC_TEST).init, jax.random.PRNGKey(0),
                                jnp.zeros((64, 64, 3)),
                                jnp.zeros((JAX_DETIC_TEST.embed_dim, len(VOCAB))))["params"]
        to_port = lambda t: detic_state_dict_from_flax(t, DETIC_TEST)  # noqa: E731
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = _sharded(to_port(_markers(tree)))
    got = {k for k, s in spec_tree(to_port(tree)).items() if s}
    assert got == want and got


# --- tensor sharding over model = 2 ---------------------------------------------------

def _sam_inputs():
    rng = np.random.default_rng(3)
    img = rng.random((64, 64, 3)).astype(np.float32)
    boxes = np.array([[4, 4, 30, 40], [8, 8, 20, 28]], np.float32)
    return img, boxes


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_tensor_sharded_sam_matches_jax_and_unsharded(groups, weights, quant):
    """SAM_TEST (and its int8 twin) through shard_model_params over model =
    2: masks and IoU within JAX's 2e-4 of JAX's unsharded forward and of
    the port's. qkv splits by heads (one of two a rank), the int8 row
    layers sum their int32 partials before the dequantize."""
    g = groups(make_mesh(n_data=1, n_model=2, devices=CPUS))
    sd = weights["qsam_sd" if quant else "sam_sd"]
    img, boxes = _sam_inputs()
    jmodel = JaxSam(QUANT_SAM if quant else JAX_SAM_TEST)
    want_m, want_i = jax.jit(lambda p, i, b: jmodel.apply({"params": p}, i, b))(
        weights["qsp" if quant else "sp"], img, boxes)
    own = sam_module(sd, quant)
    with torch.inference_mode():
        own_m, own_i = own.decode_boxes(own.encode_image(torch.from_numpy(img)[None])[0],
                                        torch.from_numpy(boxes))
    local = sharded_sam(sd, quant, "cpu")  # rank 0's instance
    got_m, got_i = g.spmd(Program(f"{PROGRAMS}:sharded_sam", (sd, quant)), local=local)(
        torch.from_numpy(img), torch.from_numpy(boxes))
    attn = local.module.image_encoder.blocks[0].attn
    qkv = attn.qkv.weight_q if quant else attn.qkv.weight
    assert attn.heads == 1 and qkv.shape == (48, 32)
    assert type(attn.proj).__name__.startswith("RowParallel")
    for got, want in ((got_m, want_m), (got_i, want_i), (got_m, own_m), (got_i, own_i)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_tensor_sharded_detic_matches_unsharded(groups, weights):
    """DETIC_TEST over model = 2 on B3's plain path (CPU tensors): the Swin
    blocks' attention stays whole (the kernel launchers take the [3C, C]
    qkv), their MLPs and the box heads' fc1 / fc2 shard; the detections
    equal the unsharded ones (scores and boxes within 1e-4)."""
    g = groups(make_mesh(n_data=1, n_model=2, devices=CPUS))
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    clf = torch.from_numpy(weights["clf"])
    hw = torch.tensor([[64, 64], [48, 64]])
    with torch.inference_mode():
        want = detic_module(weights["detic_sd"])(images, clf, hw)
    local = sharded_detic(weights["detic_sd"], "cpu")
    got = g.spmd(Program(f"{PROGRAMS}:sharded_detic", (weights["detic_sd"],)), local=local)(
        images, clf, hw)
    boxes, scores, classes, valid = got
    assert torch.equal(valid, want.valid) and torch.equal(classes, want.classes)
    assert bool(valid.any())
    np.testing.assert_allclose(_np(scores), _np(want.scores), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(boxes), _np(want.boxes), rtol=1e-4, atol=1e-4)


def test_tensor_sharded_clip_matches_unsharded(groups):
    """CLIP's text tower over model = 2: the fused in_proj splits by heads
    (its parameter, not a layer), c_fc column, out_proj / c_proj row; the
    normalized embeddings within 1e-5 of the unsharded ones."""
    g = groups(make_mesh(n_data=1, n_model=2, devices=CPUS))
    sd = init_clip_weights(ClipTextEncoder(CLIP_TEXT_TEST),
                           torch.Generator().manual_seed(0)).state_dict()
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        1, CLIP_TEXT_TEST.vocab_size, (3, CLIP_TEXT_TEST.context_length)))
    want = ClipTextEncoder(CLIP_TEXT_TEST)
    want.load_state_dict(sd)
    with torch.inference_mode():
        want = want(tokens)
    got = g.spmd(Program(f"{PROGRAMS}:sharded_clip", (sd,)))(tokens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def _encode_refs(weights, quant, img):
    cfg = QUANT_SAM if quant else JAX_SAM_TEST
    jmodel = JaxSam(cfg)
    want = np.asarray(jax.jit(lambda p, x: jmodel.apply(
        {"params": p}, x[None], method=jmodel.encode_image)[0])(
        weights["qsp" if quant else "sp"], img))
    own = sam_module(weights["qsam_sd" if quant else "sam_sd"], quant)
    with torch.inference_mode():
        own_e = own.encode_image(torch.from_numpy(img)[None])[0].numpy()
    return want, own_e


@pytest.mark.parametrize("n_seq,quant", [(2, False), (2, True), (4, False), (4, True)],
                         ids=["p2-float", "p2-int8", "p4-float", "p4-int8"])
def test_sequence_sharded_encode_matches_jax_and_unsharded(groups, weights, n_seq, quant):
    """The token rows over n_seq ranks (SAM_TEST's 4-row grid: windows of 2
    straddle no boundary at 2 ranks and each rank is one row at 4; the
    global block gathers keys and values, the neck's 3x3 conv a one-row
    halo): within JAX's 2e-5 (int8 2e-4) of the port's unsharded encode,
    and of JAX's where the port's unsharded encode is held to it
    (tests/test_torch_sam.py: 1e-5 of the largest value; int8
    tests/test_torch_quant.py: one int8 step)."""
    g = groups(make_mesh(n_data=1, n_model=n_seq, devices=CPUS))
    img = np.random.default_rng(3).random((64, 64, 3)).astype(np.float32)
    want, own = _encode_refs(weights, quant, img)
    sd = weights["qsam_sd" if quant else "sam_sd"]
    got = g.spmd(Program(f"{PROGRAMS}:sequence_sharded_encode", (sd, quant)))(
        torch.from_numpy(img)).numpy()
    assert got.shape == want.shape == (4, 4, 256)
    tol = 2e-4 if quant else 2e-5
    np.testing.assert_allclose(got, own, rtol=tol, atol=tol)
    rel = INT8_STEP if quant else 1e-5
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# --- the camera-parallel mask stage over data = 2 -------------------------------------

def _ring():
    rng = np.random.default_rng(11)
    return [(rng.random((48, 64, 3)) * 255).astype(np.uint8) for _ in range(6)]


def _jax_models(weights, quant):
    import cm3d_tpu.models.detic as jd

    dcfg, scfg, dp, sp = JAX_DETIC_TEST, JAX_SAM_TEST, weights["dp"], weights["sp"]
    if quant:
        dcfg = dataclasses.replace(dcfg, swin=dataclasses.replace(dcfg.swin, quant_int8=True))
        scfg, dp, sp = QUANT_SAM, weights["qdp"], weights["qsp"]
    return jax_model_fns(jd.Detic(dcfg), dp, weights["clf"], JaxSam(scfg), sp, VOCAB)


def _camera_models(g, weights, **kw):
    return masks.camera_parallel_models(g, f"{PROGRAMS}:mask_models",
                                        detic_sd=weights["detic_sd"], sam_sd=weights["sam_sd"],
                                        classifier=weights["clf"], **kw)


def _assert_same(fm, ref):
    assert fm.labels == ref.labels and fm.cam_nums == ref.cam_nums
    np.testing.assert_allclose(fm.detection_scores, ref.detection_scores, rtol=1e-5, atol=1e-6)
    assert fm.masks.shape == ref.masks.shape
    assert (fm.masks != ref.masks).mean() == 0.0


def _iou(a, b):
    inter = np.logical_and(a, b).sum()
    return inter / max(np.logical_or(a, b).sum(), 1)


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_camera_parallel_matches_single_process_and_jax(groups, weights, quant):
    """generate_frame_masks with the ring over data = 2 (three cameras a
    rank) equals the port's single-process run (bit-equal masks), and
    JAX's generate_frame_masks on the same weights as the port is held to
    it unsharded: float labels, cameras and masks equal, scores within
    1e-5 (tests/test_torch_masks.py); int8 labels and cameras equal,
    scores within one int8 step of the largest, every mask at IoU > 0.99
    (tests/test_torch_quant_cli.py)."""
    g = groups(make_mesh(n_data=2, devices=CPUS))
    images = _ring()
    ref = masks.generate_frame_masks(
        mask_models(weights["detic_sd"], weights["sam_sd"], weights["clf"], quant,
                    device="cpu"), images)
    fm = masks.generate_frame_masks(_camera_models(g, weights, quant_int8=quant), images)
    _assert_same(fm, ref)
    assert len(fm.labels) > 0 and set(fm.cam_nums) == set(range(6))
    want = jax_generate_frame_masks(_jax_models(weights, quant), images)
    assert fm.labels == want.labels and fm.cam_nums == want.cam_nums
    scores, want_scores = np.asarray(fm.detection_scores), np.asarray(want.detection_scores)
    if not quant:
        np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-5)
        assert (fm.masks == want.masks).all()
        return
    assert np.abs(scores - want_scores).max() <= INT8_STEP * np.abs(want_scores).max()
    assert min(_iou(a, b) for a, b in zip(fm.masks, want.masks)) > 0.99


def test_camera_parallel_static_scales_are_the_ring_max(groups, weights):
    """quant_static calibrates on the first ring: over data = 2 each rank
    records its three cameras' absmax and the ranks take the max before the
    bake, so rank 0 holds the single-process scales (the ring's max) and
    the next ring's masks are bit-equal."""
    g = groups(make_mesh(n_data=2, devices=CPUS))
    first, second = _ring(), _ring()[::-1]
    single = mask_models(weights["detic_sd"], weights["sam_sd"], weights["clf"], True, True,
                         device="cpu")
    cam = _camera_models(g, weights, quant_int8=True, quant_static=True)
    for models in (single, cam):
        masks.generate_frame_masks(models, first)
    want = single.sam_encode.calibration["act_scales"]
    got = cam.sam_encode.calibration["act_scales"]
    assert set(got) == set(want) and len(want) == 4 * SAM_TEST.encoder_depth
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_same(masks.generate_frame_masks(cam, second),
                 masks.generate_frame_masks(single, second))


def test_camera_parallel_ring_size_must_divide(groups):
    g = groups(make_mesh(n_data=2, devices=CPUS))
    models = masks.build_fake_models(seed=0, mesh=g)
    with pytest.raises(ValueError, match="ring size"):
        models.prepare(_ring()[:5])


def test_make_mesh_refusals_and_layout():
    """JAX's make_mesh errors in JAX's words; the ranks row-major."""
    with pytest.raises(ValueError, match="mesh axes must be positive"):
        make_mesh(n_data=0, devices=CPUS)
    with pytest.raises(ValueError, match="exceeds 4 available devices"):
        make_mesh(n_data=3, n_model=2, devices=CPUS)
    mesh = make_mesh(n_model=2, devices=CPUS)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.axis_lines("model") == [(0, 1), (2, 3)]
    assert mesh.axis_lines("data") == [(0, 2), (1, 3)]


# --- the CLIs ---------------------------------------------------------------------

def _frames(root, scene, n):
    out = []
    for f in range(n):
        with open(os.path.join(root, scene, f"{f}_data.json")) as fh:
            data = json.load(fh)
        with open(os.path.join(root, scene, f"{f}_masks.pkl"), "rb") as fh:
            out.append((data, pickle.load(fh)))
    return out


def test_masks_cli_camera_mesh_writes_the_same_artifacts(groups, tmp_path, capsys):
    """`--camera_mesh 2 --device cpu` (two gloo ranks, three cameras each)
    writes the artifacts of the run without the flag."""
    from nusc_fixture import VERSION, make_fake_nuscenes

    groups.close()  # the CLI starts its own group
    root = tmp_path / "nusc"
    make_fake_nuscenes(root, tmp_path / "planted", n_frames=2, n_objects=4)
    argv = ["--dataroot", str(root), "--version", VERSION, "--fake_weights",
            "--thumbnail", "96", "--device", "cpu"]
    masks.main(argv + ["--out_dir", str(tmp_path / "one")])
    masks.main(argv + ["--out_dir", str(tmp_path / "mesh"), "--camera_mesh", "2"])
    assert "2 frames done" in capsys.readouterr().out
    one = _frames(tmp_path / "one", "scene-0001", 2)
    assert _frames(tmp_path / "mesh", "scene-0001", 2) == one
    assert sum(len(d["labels"]) for d, _ in one) > 0

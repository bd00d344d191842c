"""The port's 2D mask stage (cm3d_tpu_torch.pipelines.masks) against the
JAX package's on the CPU.

- One provider through both `run_mask_stage`s, with the JAX `init` weights
  of DETIC_TEST / SAM_TEST carried into the port: labels, cameras and RLE
  masks equal, scores within 1e-5 (f32 summation order only).
- The port's CLI (`main`, --fake_weights, --device cpu) on the
  fabricated nuScenes dataroot of tests/nusc_fixture.py: scenes complete,
  a resumed run re-processes nothing, frames readable.
- The host-side contract: vocabulary, class mapping, NMS, the caps and
  their counters, the benchmark's protocol at a tiny geometry.
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

from cm3d_tpu import vocab as jax_vocab
from cm3d_tpu.config import MaskStageConfig as JaxMaskStageConfig
from cm3d_tpu.models.detic import DETIC_TEST as JAX_DETIC_TEST
from cm3d_tpu.models.detic import Detic as JaxDetic
from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu.models.sam import Sam as JaxSam
from cm3d_tpu.pipelines.masks import _batched_model_fns as jax_model_fns
from cm3d_tpu.pipelines.masks import classwise_nms_np as jax_classwise_nms_np
from cm3d_tpu.pipelines.masks import run_mask_stage as jax_run_mask_stage

from cm3d_tpu_torch import vocab
from cm3d_tpu_torch.config import MaskStageConfig
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
from cm3d_tpu_torch.models.convert import detic_state_dict_from_flax, sam_state_dict_from_flax
from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
from cm3d_tpu_torch.models.sam import SAM_TEST, Sam
from cm3d_tpu_torch.pipelines import masks
from cm3d_tpu_torch.utils.observability import MaskCounters
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

VOCAB = vocab.CUSTOM_VOCABULARY_NUSCENES


def _read_frame(root, scene, f):
    with open(os.path.join(root, scene, f"{f}_data.json")) as fh:
        data = json.load(fh)
    with open(os.path.join(root, scene, f"{f}_masks.pkl"), "rb") as fh:
        return data, pickle.load(fh)


def test_run_mask_stage_matches_jax(tmp_path, one_torch_thread):
    rng = np.random.default_rng(0)
    clf = rng.standard_normal((JAX_DETIC_TEST.embed_dim, len(VOCAB))).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    jax_detic, jax_sam = JaxDetic(JAX_DETIC_TEST), JaxSam(JAX_SAM_TEST)
    dp = jax.tree.map(np.asarray, jax.jit(jax_detic.init)(
        jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)), clf)["params"])
    sp = jax.tree.map(np.asarray, jax.jit(jax_sam.init)(
        jax.random.PRNGKey(1), jnp.zeros((64, 64, 3)), jnp.zeros((1, 4)))["params"])
    detic, sam = Detic(DETIC_TEST), Sam(SAM_TEST)
    detic.load_state_dict(detic_state_dict_from_flax(dp, DETIC_TEST))
    sam.load_state_dict(sam_state_dict_from_flax(sp, SAM_TEST))

    frames = {f: [(rng.random((48, 64, 3)) * 255).astype(np.uint8) for _ in range(6)]
              for f in range(2)}

    def provider(scene, f):
        return frames[f]

    jax_run_mask_stage(jax_model_fns(jax_detic, dp, clf, jax_sam, sp, VOCAB), provider,
                       ["s"], lambda s: 2, str(tmp_path / "jax"),
                       JaxMaskStageConfig(dtype="float32"), verbose=False)
    masks.run_mask_stage(masks._batched_model_fns(detic, clf, sam, VOCAB, device="cpu"),
                         provider, ["s"], lambda s: 2, str(tmp_path / "port"),
                         MaskStageConfig(dtype="float32"), verbose=False)
    n_masks = 0
    for f in range(2):
        want, want_rles = _read_frame(tmp_path / "jax", "s", f)
        got, got_rles = _read_frame(tmp_path / "port", "s", f)
        assert got["labels"] == want["labels"]
        assert got["cam_nums"] == want["cam_nums"]
        np.testing.assert_allclose(got["detection_scores"], want["detection_scores"],
                                   rtol=0, atol=1e-5)
        assert got_rles == want_rles
        n_masks += len(want_rles)
    assert n_masks > 0
    assert MaskArtifactStore(tmp_path / "port").load_manifest() == {"s": 2}


def test_masks_cli_on_the_fixture_dataroot(tmp_path, capsys, one_torch_thread):
    from nusc_fixture import VERSION, make_fake_nuscenes

    root = tmp_path / "nusc"
    make_fake_nuscenes(root, tmp_path / "planted", n_frames=2, n_objects=4)
    out = tmp_path / "masks_out"
    argv = ["--dataroot", str(root), "--version", VERSION, "--out_dir", str(out),
            "--fake_weights", "--thumbnail", "96", "--device", "cpu"]
    masks.main(argv)
    assert "2 frames done" in capsys.readouterr().out
    store = MaskArtifactStore(out)
    assert store.remaining_scenes(["scene-0001"]) == []
    written = {}
    for f in range(2):
        fm = store.read_frame("scene-0001", f)
        assert fm is not None
        assert len(fm.labels) == len(fm.cam_nums) == fm.masks.shape[0]
        if fm.labels:  # masks stored [W, H] at the thumbnailed canvas
            assert fm.masks.shape[1:] == (96, 54) and max(fm.cam_nums) < 6
        written[f] = os.stat(out / "scene-0001" / f"{f}_masks.pkl").st_mtime_ns
    masks.main(argv)  # resumed: the scene is complete, nothing re-processed
    assert "frames/sec" not in capsys.readouterr().out
    assert all(os.stat(out / "scene-0001" / f"{f}_masks.pkl").st_mtime_ns == t
               for f, t in written.items())
    with pytest.raises(SystemExit):  # neither --fake_weights nor the four checkpoints
        masks.main([a for a in argv if a != "--fake_weights"])


# item None: ported since (the checkpoint flags and --sam_size in A6, Waymo
# in A8, KITTI in A9, int8 in A12, ZoeDepth in A13b, GroundingDINO in A13c,
# --host_shard in A14a, --camera_mesh in A14e: every flag of the JAX CLI);
# the flag is accepted and the run goes on to read the dataroot
@pytest.mark.parametrize("extra,item", [
    (["--detic_ckpt", "x.pth"], None), (["--sam_ckpt", "x.pth"], None),
    (["--clip_ckpt", "c.pt"], None), (["--bpe_path", "b.txt.gz"], None),
    (["--sam_size", "vit_l"], None), (["--quant_int8"], None), (["--quant_static"], None),
    (["--use_zoedepth"], None), (["--zoe_ckpt", "z.pt"], None), (["--detector", "gdino"], None),
    (["--gdino_ckpt", "g.pth"], None), (["--gdino_vocab", "v.txt"], None),
    (["--gdino_bf16"], None), (["--camera_mesh", "2"], None), (["--host_shard"], None),
    (["--dataset", "waymo"], None), (["--dataset", "kitti"], None),
])
def test_masks_cli_names_the_roadmap_item_of_a_jax_flag(tmp_path, extra, item):
    """The JAX CLI's flags are accepted and refused with the ROADMAP item
    that ports them, not with argparse's usage error (exit 2); the refusal
    comes before any dataroot is read. A ported flag is accepted: the run
    fails only at the missing dataroot."""
    argv = ["--dataroot", str(tmp_path / "none"), "--out_dir", str(tmp_path / "out"),
            "--fake_weights", "--device", "cpu"]
    with pytest.raises(FileNotFoundError if item is None else NotImplementedError,
                       match=None if item is None else item):
        masks.main(argv + extra)


def test_vocabulary_and_config_match_jax():
    assert vocab.CUSTOM_VOCABULARY_NUSCENES == jax_vocab.CUSTOM_VOCABULARY_NUSCENES
    assert vocab.CUSTOM_VOCABULARY_WAYMO == jax_vocab.CUSTOM_VOCABULARY_WAYMO
    names = set(VOCAB) | set(jax_vocab.OLD_MAPS) | {"suv", "pickup", "lorry", "bike", "x"}
    for name in sorted(names):
        assert vocab.map_class(name) == jax_vocab.map_class(name)
    want = dataclasses.asdict(JaxMaskStageConfig())
    for key, value in dataclasses.asdict(MaskStageConfig()).items():
        assert want[key] == value, key


def test_classwise_nms_np_matches_jax():
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 50, (60, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 25, (60, 2))], 1)
    scores = rng.random(60)
    labels = list(rng.choice(["car", "truck", "pedestrian"], 60))
    for thresh in (0.3, 0.75):
        assert masks.classwise_nms_np(boxes, scores, labels, thresh) == \
            jax_classwise_nms_np(boxes, scores, labels, thresh)


def _stub_models(n_det, scores=None):
    """Host-side stand-ins: a detector with n_det disjoint boxes a camera."""
    if scores is None:
        scores = np.linspace(0.9, 0.5, n_det, dtype=np.float32)

    def detic(frame):
        c = len(frame["images"])
        boxes = np.zeros((c, n_det, 4), np.float32)
        for i in range(n_det):
            boxes[:, i] = [20 * i, 0, 20 * i + 10, 10]
        return (torch.from_numpy(boxes), torch.from_numpy(np.tile(scores, (c, 1))),
                torch.zeros((c, n_det), dtype=torch.int64),
                torch.ones((c, n_det), dtype=torch.bool))

    def decode(emb, boxes, n_boxes, cam_hw, mask_wh, nw, layout="xy"):
        w, h = mask_wh
        return torch.zeros((w, h, nw) if layout == "xy" else (h, w, nw), dtype=torch.int32)

    return masks.MaskModels(lambda images: {"images": images}, detic, lambda frame: None,
                            decode, VOCAB)


def test_caps_drop_lowest_scores_and_are_counted():
    handle = masks.start_frame_masks(
        _stub_models(10), [np.zeros((16, 200, 3), np.uint8)] * 2,
        MaskStageConfig(max_detections=4, max_masks_total=6))
    c = handle["counts"]
    assert (c["detections"], c["nms_suppressed"]) == (20, 0)
    assert c["dropped_max_detections"] == 12  # 10 -> 4 per camera
    assert c["dropped_masks_total"] == 2  # camera 1 keeps 6 - 4 = 2 of its 4
    assert c["masks_written"] == 6 == handle["total"]
    asc = np.linspace(0.1, 0.6, 6, dtype=np.float32)
    handle = masks.start_frame_masks(
        _stub_models(6, scores=asc), [np.zeros((16, 200, 3), np.uint8)],
        MaskStageConfig(max_detections=3, run_nms=False))
    np.testing.assert_allclose(handle["scores"], asc[3:], rtol=1e-6)  # order kept


def test_run_mask_stage_accumulates_counters(tmp_path):
    cnt = MaskCounters()
    masks.run_mask_stage(_stub_models(5), lambda s, f: [np.zeros((16, 100, 3), np.uint8)],
                         ["sc"], lambda s: 3, str(tmp_path), verbose=False,
                         cfg=MaskStageConfig(max_detections=2), counters=cnt)
    assert (cnt.frames, cnt.detections, cnt.masks_written) == (3, 15, 6)
    assert cnt.dropped_max_detections == cnt.dropped_total == 9
    assert MaskArtifactStore(tmp_path).read_frame("sc", 2).labels == ["bus", "bus"]  # id 0


def test_bench_mask_stage_protocol_at_a_tiny_geometry(monkeypatch, one_torch_thread):
    import cm3d_tpu_torch.benchmarks as bench

    monkeypatch.setattr(bench, "IMG_H", 48)
    monkeypatch.setattr(bench, "IMG_W", 64)
    models = bench._realistic_load(masks.build_fake_models(device="cpu"))
    out = bench.bench_mask_stage("float32", n_frames=2, models=models, io_sleep=0.0,
                                 device="cpu")
    assert out["metric"] == "mask_stage_keyframes_per_sec_per_chip"
    assert out["warmup_masks"] > 0
    assert np.isfinite(out["value"]) and out["value"] == 1000.0 / out["pipelined_ms"]

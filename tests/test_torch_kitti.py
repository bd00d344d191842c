"""The port's KITTI path (calib -> frontend -> lift -> label txts, the
KITTI mask provider and the fused path on KITTI's changing frame sizes)
against the JAX package on the CPU, on a seeded KITTI root made here.

Tolerances:
- frontend keyframes: extrinsics and intrinsics within 1e-6 (both go
  through the same numpy / scipy chain, then f32), every other field equal;
- the step on the SAME numpy keyframes (the JAX frontend's): has_points,
  point counts, truncation flags and keep sets equal; medoid centroids
  equal but where the two smallest medoid sums lie within 1e-5 relative (a
  near tie: the two packages sum in other orders); PCA yaws as
  tests/test_torch_lift.py;
- label txts of the lift CLI against JAX's run_lift_kitti: the same objects
  frame for frame, type and score equal, t / ry / alpha / box2d within 1e-4
  (the floats are written with Python's repr, so the files are parsed and
  compared, not diffed), but for medoid near ties.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

import cm3d_tpu.datasets.kitti.calib as jax_calib
import cm3d_tpu.datasets.kitti.frontend as jax_frontend
import cm3d_tpu.pipelines.lift_kitti as jax_lift_kitti
import test_kitti as jax_kitti_tests
from cm3d_tpu.config import KITTI_LIFT as JAX_KITTI_LIFT
from cm3d_tpu.config import LiftStageConfig as JaxLiftStageConfig
from cm3d_tpu.datasets.artifacts import MaskArtifactStore as JaxStore
from cm3d_tpu.datasets.types import stack_keyframes as jax_stack_keyframes
from kitti_fixture import CANVAS_WH, IMAGE_WH, make_kitti_root
from test_kitti import CALIB_TXT

from cm3d_tpu_torch import config as port_config
from cm3d_tpu_torch.config import LiftStageConfig, MaskStageConfig
from cm3d_tpu_torch.datasets import artifacts
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
from cm3d_tpu_torch.datasets.kitti import calib, frontend
from cm3d_tpu_torch.datasets.kitti.calib import read_label
from cm3d_tpu_torch.datasets.kitti.frontend import KittiFrontend
from cm3d_tpu_torch.datasets.types import keyframe_from_numpy
from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows_plain
from cm3d_tpu_torch.pipelines import e2e, lift_kitti, masks

TRIG = dict(rtol=1e-6, atol=1e-5)
LABEL_ATOL = 1e-4
SMALL_K = dict(num_sweeps=1, image_ratio=0.8366, sqrt_min_dist_load_filter=False,
               max_points=8192, max_masks=16, max_points_per_mask=512,
               max_points_per_camera=4096, max_points_in_masks=2048, max_lane_points=64)


@pytest.fixture(scope="module")
def kitti_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    mask_dir = tmp_path_factory.mktemp("kmasks")
    make_kitti_root(root, mask_dir)
    return root, mask_dir


# --- the JAX package's KITTI tests on the port's modules ----------------------

JAX_TESTS = ("test_calibration_chain_roundtrip", "test_rect_chain_matches_projection",
             "test_label_roundtrip", "test_velo_yaw_to_ry",
             "test_boxes_to_kitti_objects_box2d_and_alpha",
             "test_project_depth_to_velo_matches_pixelwise_oracle",
             "test_build_keyframe_respects_cfg_image_ratio", "test_kitti_lift_end_to_end")


@pytest.mark.parametrize("name", JAX_TESTS)
def test_port_passes_the_jax_kitti_tests(name, monkeypatch, tmp_path):
    """tests/test_kitti.py with the port's calib, frontend, store and lift in
    place of the JAX package's (the same assertions, the port's code; the
    lift on the CPU)."""
    for attr in ("Calibration", "Object3d", "read_label", "write_label"):
        monkeypatch.setattr(jax_kitti_tests, attr, getattr(calib, attr))
    monkeypatch.setattr(jax_kitti_tests, "compute_box_3d", calib.compute_box_3d)
    for attr in ("KittiFrontend", "velo_yaw_to_kitti_ry"):
        monkeypatch.setattr(jax_kitti_tests, attr, getattr(frontend, attr))
    for attr in ("MaskArtifactStore", "FrameMasks"):
        monkeypatch.setattr(jax_kitti_tests, attr, getattr(artifacts, attr))
    monkeypatch.setattr(jax_kitti_tests, "LiftStageConfig", LiftStageConfig)
    # the tests' function-local imports read these module attributes
    monkeypatch.setattr(jax_frontend, "boxes_to_kitti_objects", frontend.boxes_to_kitti_objects)
    monkeypatch.setattr(jax_calib, "Calibration", calib.Calibration)
    monkeypatch.setattr(jax_lift_kitti, "run_lift_kitti",
                        functools.partial(lift_kitti.run_lift_kitti, device="cpu"))
    root = tmp_path / "kitti"
    for sub in ("calib", "velodyne", "label_2", "image_2"):
        (root / "training" / sub).mkdir(parents=True)
    (root / "training" / "calib" / "000000.txt").write_text(CALIB_TXT)
    fn = getattr(jax_kitti_tests, name)
    args = {"kitti_root": root, "tmp_path": tmp_path}
    fn(*[args[a] for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]])


# --- frontend, step, lift CLI -------------------------------------------------

def _frontends(kitti_world):
    root, mask_dir = kitti_world
    jax_fe = jax_frontend.KittiFrontend(root, JaxStore(mask_dir), JaxLiftStageConfig(**SMALL_K))
    port_fe = KittiFrontend(root, MaskArtifactStore(mask_dir), LiftStageConfig(**SMALL_K))
    return jax_fe, port_fe


def test_frontend_keyframes_match_jax(kitti_world):
    import kitti_fixture

    assert kitti_fixture.CALIB_TXT == CALIB_TXT  # the JAX tests' calibration
    want = dataclasses.asdict(JAX_KITTI_LIFT)
    for key, value in dataclasses.asdict(port_config.KITTI_LIFT).items():
        assert want[key] == value, key
    jax_fe, port_fe = _frontends(kitti_world)
    want = list(jax_fe.iter_frames([0, 1, 2]))
    got = list(port_fe.iter_frames([0, 1, 2]))
    assert [i for _, i in got] == [i for _, i in want] == [0, 1, 2]
    for (kf, _), (jkf, _) in zip(got, want):
        assert kf.point_valid.sum() > 3000 and kf.mask_valid.sum() >= 4
        # one camera; the P2 baseline column makes the camera translation
        # non-zero (a sign slip moves every box by ~6 cm)
        assert kf.cameras.intrinsics.shape == (1, 3, 3)
        assert np.abs(kf.cameras.cam_translation).max() > 0.05
        for f in kf._fields:
            a, b = getattr(kf, f), getattr(jkf, f)
            if f == "cameras":
                for g in a._fields:
                    assert getattr(a, g).dtype == getattr(b, g).dtype, g
                    np.testing.assert_allclose(getattr(a, g), getattr(b, g), rtol=0,
                                               atol=1e-6, err_msg=g)
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


def _near_tie(rows, valid):
    """Rows whose two smallest medoid sums lie within 1e-5 relative."""
    sums = torch.where(valid, medoid_distance_sums_rows_plain(rows, valid),
                       torch.tensor(float("inf")))
    two = torch.topk(sums, 2, dim=1, largest=False).values
    return (valid.sum(1) > 1) & ((two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs())


def test_kitti_step_matches_jax(kitti_world, monkeypatch):
    """make_kitti_step_fn on the JAX frontend's keyframes against JAX's
    make_kitti_step_fn: B1 / B2's plain versions at one camera."""
    import cm3d_tpu_torch.ops.lift as lift_ops

    jax_fe, _ = _frontends(kitti_world)
    batch = jax_stack_keyframes([kf for kf, _ in jax_fe.iter_frames([0, 1, 2])])
    want_lift, want_keep = jax.tree.map(np.asarray, jax.jit(jax_lift_kitti.make_kitti_step_fn(
        JaxLiftStageConfig(**SMALL_K)))(batch.frames))
    medoid_rows = []
    real = lift_ops.masked_medoid_rows

    def spy(rows, valid):
        medoid_rows.append((rows.clone(), valid.clone()))
        return real(rows, valid)

    monkeypatch.setattr(lift_ops, "masked_medoid_rows", spy)
    step = lift_kitti.make_kitti_step_fn(LiftStageConfig(**SMALL_K), device="cpu")
    lift, keep = step(keyframe_from_numpy(batch, "cpu"))
    assert want_keep.sum() >= 8 and batch.frames.cameras.intrinsics.shape[1] == 1
    for name in ("has_points", "point_counts", "truncated", "cam_truncated"):
        np.testing.assert_array_equal(getattr(lift, name).numpy(), getattr(want_lift, name),
                                      err_msg=name)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    tie = _near_tie(*medoid_rows[0]).reshape(keep.shape).numpy()
    same = (lift.centroids.numpy() == want_lift.centroids).all(-1)
    assert (same | tie).all()
    np.testing.assert_allclose(lift.pca_yaws.numpy(), want_lift.pca_yaws, **TRIG)


def _assert_labels_match(got_dir, want_dir, indices):
    total = 0
    for idx in indices:
        for kind in ("pred", "pseudo"):
            a = read_label(got_dir / kind / f"{idx:06d}.txt")
            b = read_label(want_dir / kind / f"{idx:06d}.txt")
            assert len(a) == len(b), (idx, kind)
            total += len(a)
            for oa, ob in zip(a, b):
                assert (oa.type, oa.truncation, oa.occlusion) == (ob.type, ob.truncation,
                                                                  ob.occlusion)
                assert (oa.h, oa.w, oa.l) == (ob.h, ob.w, ob.l)
                np.testing.assert_allclose(
                    [*oa.t, oa.ry, oa.alpha, *oa.box2d], [*ob.t, ob.ry, ob.alpha, *ob.box2d],
                    rtol=0, atol=LABEL_ATOL)
                if kind == "pred":
                    assert oa.score == ob.score
                else:
                    assert np.isnan(oa.score) and np.isnan(ob.score)
    return total


def test_lift_kitti_cli_writes_jaxs_labels(kitti_world, tmp_path, capsys):
    """`python -m cm3d_tpu_torch.pipelines.lift_kitti` (batch 2 over 3
    frames: the last batch padded with its last frame) against JAX's
    run_lift_kitti on the same root and artifacts."""
    root, mask_dir = kitti_world
    lift_cfg = LiftStageConfig(**SMALL_K)
    n = lift_kitti.run_lift_kitti(str(root), str(mask_dir), [0, 1, 2], str(tmp_path / "port"),
                                  lift_cfg, batch_size=2, verbose=False, device="cpu")
    n_jax = jax_lift_kitti.run_lift_kitti(str(root), str(mask_dir), [0, 1, 2],
                                          str(tmp_path / "jax"), JaxLiftStageConfig(**SMALL_K),
                                          batch_size=2, verbose=False)
    assert n == n_jax == _assert_labels_match(tmp_path / "port", tmp_path / "jax",
                                              [0, 1, 2]) // 2 >= 9
    # 2D boxes clipped to each frame's own image (KITTI's sizes vary)
    for idx in range(3):
        w, h = IMAGE_WH[idx]
        for o in read_label(tmp_path / "port" / "pred" / f"{idx:06d}.txt"):
            assert 0 <= o.box2d[0] < o.box2d[2] <= w - 1 and 0 <= o.box2d[1] < o.box2d[3] <= h - 1


def test_lift_kitti_cli_flags(kitti_world, tmp_path, capsys, monkeypatch):
    """The CLI's --indices default (the store's frames), --split reaching
    the frontend (tests/test_kitti.py:313 on the port), --data_parallel
    reaching its validation (tests/test_torch_data_parallel.py runs it)."""
    root, mask_dir = kitti_world
    out = tmp_path / "out"
    # the CLI's production caps (KITTI_LIFT), cut to the fixture's size
    monkeypatch.setattr(lift_kitti, "KITTI_LIFT", LiftStageConfig(**SMALL_K))
    lift_kitti.main(["--root", str(root), "--mask_dir", str(mask_dir), "--out_dir", str(out),
                     "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    assert sorted(p.name for p in (out / "pred").iterdir()) == [f"{i:06d}.txt" for i in range(3)]
    seen = {}
    real_init = lift_kitti.KittiFrontend.__init__

    def spy(self, root, store, cfg=None, split="training", **kw):
        seen["split"] = split
        real_init(self, root, store, cfg, split=split, **kw)

    monkeypatch.setattr(lift_kitti.KittiFrontend, "__init__", spy)
    (root / "testing" / "velodyne").mkdir(parents=True, exist_ok=True)
    lift_kitti.run_lift_kitti(str(root), str(tmp_path / "m2"), [], str(tmp_path / "o"),
                              split="testing", device="cpu")
    assert seen["split"] == "testing"
    with pytest.raises(SystemExit, match="must divide --batch_size 8"):
        lift_kitti.main(["--root", str(root), "--mask_dir", str(mask_dir), "--data_parallel",
                         "3", "--device", "cpu"])


# --- the mask provider and the fused path ------------------------------------

MASK_CFG = MaskStageConfig(max_detections=8, max_masks_total=16)


def _fixed_detic(frame):
    """Deterministic detections (the tests target the plane handoff, not
    the random-weight detector): car + pedestrian (tests/test_e2e_kitti.py)."""
    c, d = frame["dev"].shape[0], MASK_CFG.max_detections
    boxes = torch.zeros((c, d, 4))
    boxes[:, 0] = torch.tensor([350.0, 80, 700, 280])
    boxes[:, 1] = torch.tensor([100.0, 120, 330, 300])
    scores = torch.zeros((c, d))
    scores[:, 0], scores[:, 1] = 0.9, 0.7
    classes = torch.zeros((c, d), dtype=torch.int64)
    classes[:, 0], classes[:, 1] = 3, 4  # car, pedestrian
    valid = torch.zeros((c, d), dtype=torch.bool)
    valid[:, :2] = True
    return boxes, scores, classes, valid


def test_fused_kitti_equals_two_stage(tmp_path):
    """tests/test_e2e_kitti.py:46 on the port: the KITTI mask provider ->
    artifacts -> run_lift_kitti against run_e2e_kitti with the same models
    (the packed planes go straight from the decode into the keyframe); the
    fused run's artifacts are the provider's."""
    root = make_kitti_root(tmp_path / "kitti", tmp_path / "planted", n_frames=2, seed=5,
                           image_wh=[CANVAS_WH])
    models = dataclasses.replace(masks.build_fake_models(device="cpu"), detic=_fixed_detic)
    provider, scenes, n_frames = masks._kitti_provider(type("A", (), dict(
        dataroot=str(root), scenes="0,1", thumbnail=1024)))
    assert scenes == ["kitti"] and n_frames("kitti") == 2
    lift_cfg = LiftStageConfig(**SMALL_K)
    masks.run_mask_stage(models, provider, scenes, n_frames, str(tmp_path / "masks"), MASK_CFG,
                         verbose=False)
    lift_kitti.run_lift_kitti(str(root), str(tmp_path / "masks"), [0, 1], str(tmp_path / "two"),
                              lift_cfg, batch_size=2, verbose=False, device="cpu")
    n = e2e.run_e2e_kitti(str(root), [0, 1], str(tmp_path / "fused"), models, lift_cfg=lift_cfg,
                          mask_cfg=MASK_CFG, batch_size=2, verbose=False, device="cpu",
                          mask_dir=str(tmp_path / "fused_masks"))
    assert n == 2
    assert _assert_labels_match(tmp_path / "fused", tmp_path / "two", [0, 1]) > 0
    two, fused = MaskArtifactStore(tmp_path / "masks"), MaskArtifactStore(
        tmp_path / "fused_masks")
    for idx in (0, 1):
        a, b = two.read_frame("kitti", idx), fused.read_frame("kitti", idx)
        assert a.labels == b.labels and np.array_equal(a.masks, b.masks)
    assert fused.completed_scenes() == set()  # frame by frame, no scene mark


def test_fused_kitti_mixed_image_sizes(tmp_path, monkeypatch):
    """tests/test_e2e_kitti.py:150 on the port: frames of 1242x375 and
    1224x370 thumbnail to 1024x309 and 1024x310; the canvas is pinned at
    1024 x 320, so the keyframe batch stacks, and one batch holds both."""
    root = make_kitti_root(tmp_path / "kitti", tmp_path / "planted", n_frames=2, seed=7)
    assert IMAGE_WH[:2] == ((1242, 375), (1224, 370))
    models = dataclasses.replace(masks.build_fake_models(device="cpu"), detic=_fixed_detic)
    seen_hw, steps = [], []
    real_prepare, real_step_fn = models.prepare, lift_kitti.make_kitti_step_fn

    def prepare(images):
        seen_hw.append(images[0].shape[:2])
        return real_prepare(images)

    def step_fn(*a, **kw):
        step = real_step_fn(*a, **kw)

        def counted(frames):
            steps.append(tuple(frames.mask_bits.shape))
            return step(frames)

        return counted

    monkeypatch.setattr(lift_kitti, "make_kitti_step_fn", step_fn)
    n = e2e.run_e2e_kitti(str(root), [0, 1], str(tmp_path / "fused"),
                          dataclasses.replace(models, prepare=prepare),
                          lift_cfg=LiftStageConfig(**SMALL_K), mask_cfg=MASK_CFG,
                          batch_size=2, verbose=False, device="cpu")
    assert n == 2
    assert seen_hw == [(309, 1024), (310, 1024)]
    assert steps == [(2, 1024, 320, 1)]
    assert sum(len(read_label(tmp_path / "fused" / "pred" / f"{i:06d}.txt"))
               for i in (0, 1)) > 0
    assert (tmp_path / "fused" / "pseudo" / "000001.txt").exists()
    assert e2e.kitti_canvas_wh(768) == (768, 240)


@pytest.mark.parametrize("cli", ["masks", "e2e"])
def test_cli_run_nms_default_for_kitti(cli, monkeypatch, tmp_path):
    """The reference's KITTI flow runs without 2D NMS ("wo_2d_nms"): kitti ->
    run_nms False unless --run_nms 1; nuScenes -> True. Both CLIs."""
    seen = {}
    monkeypatch.setattr(masks, "build_models", lambda p, args, vocab, device, mesh=None: "models")
    monkeypatch.setattr(e2e, "build_models", lambda p, args, vocab, device, mesh=None: "models")
    if cli == "masks":
        monkeypatch.setattr(masks, "run_mask_stage",
                            lambda m, prov, scenes, fn, out, cfg, resume: seen.update(cfg=cfg))
        monkeypatch.setattr(masks, "_nuscenes_provider", lambda args: (None, [], None))
        base = ["--dataroot", str(tmp_path), "--out_dir", str(tmp_path / "o"),
                "--fake_weights", "--device", "cpu"]
        main = masks.main
    else:
        monkeypatch.setattr(e2e, "run_e2e_kitti",
                            lambda root, idx, out, m, **kw: seen.update(cfg=kw["mask_cfg"],
                                                                        idx=idx))
        monkeypatch.setattr(e2e, "run_e2e", lambda *a, **kw: seen.update(cfg=kw["mask_cfg"]))
        base = ["--dataroot", str(tmp_path), "--scenes", "0,3", "--out", str(tmp_path / "o"),
                "--fake_weights", "--device", "cpu"]
        main = e2e.main
    main(["--dataset", "kitti"] + base)
    assert seen["cfg"].run_nms is False
    if cli == "e2e":
        assert seen["idx"] == [0, 3]
    main(["--dataset", "kitti", "--run_nms", "1"] + base)
    assert seen["cfg"].run_nms is True
    main(["--dataset", "nuscenes"] + base)
    assert seen["cfg"].run_nms is True


def test_masks_cli_on_a_kitti_root(kitti_world, tmp_path, capsys):
    """`python -m cm3d_tpu_torch.pipelines.masks --dataset kitti`: image_2
    through the tiny models, artifacts under scene "kitti".

    A fault of the reference, kept on purpose (ROADMAP C): run_mask_stage
    numbers a scene's frames by position, so `--scenes 2,0` writes KITTI
    frame 2's masks as artifact frame 0 and frame 0's as frame 1, while
    lift_kitti and run_e2e_kitti use the KITTI index. The two providers map
    the positions to the same images."""
    from cm3d_tpu.pipelines.masks import _kitti_provider as jax_kitti_provider

    root, _ = kitti_world
    out = tmp_path / "masks_out"
    masks.main(["--dataset", "kitti", "--dataroot", str(root), "--out_dir", str(out),
                "--scenes", "2,0", "--fake_weights", "--thumbnail", "128", "--device", "cpu"])
    assert "2 frames done" in capsys.readouterr().out
    store = MaskArtifactStore(out)
    assert store.completed_scenes() == {"kitti"} and store.frame_numbers("kitti") == [0, 1]
    fm = store.read_frame("kitti", 1)
    assert fm is not None and set(fm.cam_nums) <= {0}
    args = type("A", (), dict(dataroot=str(root), scenes="2,0", thumbnail=128))
    provider, scenes, n_frames = masks._kitti_provider(args)
    jax_provider, jax_scenes, jax_n_frames = jax_kitti_provider(args)
    assert scenes == jax_scenes == ["kitti"] and n_frames("kitti") == jax_n_frames("kitti") == 2
    for pos, idx in ((0, 2), (1, 0)):
        (im,) = provider("kitti", pos)
        np.testing.assert_array_equal(im, jax_provider("kitti", pos)[0])
        w, h = IMAGE_WH[idx]
        assert im.shape == (round(h * 128 / w), 128, 3)

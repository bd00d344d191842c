"""`--data_parallel 2` on the CPU (gloo, one spawned worker rank) against
the port's single-process run and the JAX package's data-parallel run.

The lifts must give the single-device results exactly (the same
submission, a byte-identical Waymo .bin and KITTI label txts); training
follows the single-device trajectory within JAX's own tolerances for its
data-parallel tests (tests/test_pretrain_detect.py:91,232: rtol 1e-5 /
atol 1e-6 LiDAR-only, rtol 1e-3 / atol 1e-5 with the camera): BatchNorm's
global statistics and the summed gradients add in another order than the
single-process run. Detection is exact LiDAR-only, translations within
1e-4 with the camera. The `axis_name` step is JAX's
test_augment_decorrelates_across_devices on two gloo ranks.

Each run with data_parallel spawns its worker (about 4 s here: torch's
import), so the scenarios share runs where they can.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from cm3d_tpu_torch.config import LiftStageConfig
from cm3d_tpu_torch.models.checkpoints import load_params
from cm3d_tpu_torch.parallel.mesh import DataParallelGroup, Program
from cm3d_tpu_torch.pipelines import detect as tdetect
from cm3d_tpu_torch.pipelines import lift as tlift
from cm3d_tpu_torch.pipelines import lift_kitti, lift_waymo
from cm3d_tpu_torch.pipelines import pretrain as tpretrain
from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig
from cm3d_tpu_torch.train import train as ttrain

SMALL_LIFT = dict(max_points=16384, max_masks=32, max_points_per_mask=512,
                  max_points_per_camera=8192, max_points_in_masks=2048, max_lane_points=1024)
GEO = dict(x_min=-25.6, x_max=25.6, y_min=-25.6, y_max=25.6, resolution=0.8)
PILLAR, MODEL = PillarConfig(**GEO), CenterPointConfig(trunk_channels=(16, 16), head_channels=16)
DETECT_KW = dict(batch_size=2, top_k=16, score_thresh=0.0, max_points=4096, verbose=False,
                 pillar_cfg=PILLAR, device="cpu")
VERSION = "v1.0-fake"


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    """The fixture dataroot (3 keyframes, mask artifacts) and pseudo-labels
    over its samples, as tests/test_torch_pretrain_detect.py makes them."""
    from nusc_fixture import make_fake_nuscenes

    from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables

    tmp = tmp_path_factory.mktemp("dp")
    root, masks = tmp / "data", tmp / "masks"
    info = make_fake_nuscenes(root, masks, n_frames=3, n_objects=6)
    tables = NuScenesTables(root, VERSION)
    rng = np.random.default_rng(7)
    results = {}
    for sample in tables.table("sample"):
        ego_t = np.asarray(tables.sample_lidar_ego_pose(sample)["translation"], np.float64)
        boxes = []
        for name, off in (("car", (5.0, 3.0)), ("pedestrian", (-4.0, 6.0))):
            t = ego_t + [off[0] + rng.normal(0, 0.5), off[1] + rng.normal(0, 0.5), 0.0]
            boxes.append({"sample_token": sample["token"], "translation": [float(v) for v in t],
                          "size": [1.8, 4.5, 1.4] if name == "car" else [0.7, 0.7, 1.7],
                          "rotation": [1.0, 0.0, 0.0, 0.0], "velocity": [0, 0],
                          "detection_name": name, "detection_score": 0.9,
                          "attribute_name": ""})
        results[sample["token"]] = boxes
    labels = tmp / "labels.json"
    labels.write_text(json.dumps({"meta": {}, "results": results}))
    return root, masks, info["scene_name"], str(labels), tmp


def _train(root, labels, out_dir, **kw):
    base = dict(steps=6, batch_size=2, learning_rate=1e-3, verbose=False,
                pillar_cfg=PILLAR, model_cfg=MODEL, device="cpu")
    base.update(kw)
    return tpretrain.run_pretrain(str(root), VERSION, labels, str(out_dir), **base)


def _assert_trees_close(a, b, rtol, atol, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_trees_close(a[k], b[k], rtol, atol, f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol, err_msg=where)
    else:
        assert a == b, where


# --- the lifts ---------------------------------------------------------------

def test_nuscenes_lift_equals_single_process_and_jax_data_parallel(nusc):
    """run_lift(data_parallel=2) gives the single-process submission (==)
    and JAX's run_lift(data_parallel=2) on the same fixture (within
    test_torch_cli's tolerances); the resumed tail batch pads and splits
    like any other."""
    from test_torch_cli import _assert_same_submission

    from cm3d_tpu.config import LiftStageConfig as JaxLiftStageConfig
    from cm3d_tpu.pipelines.lift import run_lift as jax_run_lift

    root, masks, scene, _, tmp = nusc
    args = (str(root), VERSION, str(masks), [scene])
    kw = dict(lift_cfg=LiftStageConfig(**SMALL_LIFT), batch_size=2, verbose=False,
              device="cpu")
    single = tlift.run_lift(*args, str(tmp / "single.json"), **kw)
    dp = tlift.run_lift(*args, str(tmp / "dp.json"), data_parallel=2, **kw)
    assert dp["results"] == single["results"]
    assert json.loads((tmp / "dp.json").read_text()) == dp
    want = jax_run_lift(*args, str(tmp / "jax_dp.json"), batch_size=2, verbose=False,
                        lift_cfg=JaxLiftStageConfig(**SMALL_LIFT), data_parallel=2)
    _assert_same_submission(dp, want)


def test_waymo_and_kitti_lifts_write_the_same_bytes(tmp_path):
    """run_lift_waymo / run_lift_kitti with data_parallel=2: the .bin and
    every label txt byte-identical to the single-process run (the KITTI
    tail batch of one frame is padded to two and split)."""
    from kitti_fixture import make_kitti_root
    from test_torch_kitti import SMALL_K
    from test_torch_waymo import SMALL
    from waymo_fixture import make_fake_waymo

    frames, wmasks = tmp_path / "wframes", tmp_path / "wmasks"
    info = make_fake_waymo(frames, wmasks, n_frames=2, n_objects=8)
    kw = dict(lift_cfg=LiftStageConfig(**SMALL), batch_size=2, verbose=False, device="cpu")
    n1 = lift_waymo.run_lift_waymo(str(frames), str(wmasks), [info["scene"]],
                                   str(tmp_path / "single.bin"), **kw)
    n2 = lift_waymo.run_lift_waymo(str(frames), str(wmasks), [info["scene"]],
                                   str(tmp_path / "dp.bin"), data_parallel=2, **kw)
    assert n1 == n2 >= 8
    assert (tmp_path / "dp.bin").read_bytes() == (tmp_path / "single.bin").read_bytes()

    root, kmasks = tmp_path / "kitti", tmp_path / "kmasks"
    make_kitti_root(root, kmasks)
    kw = dict(lift_cfg=LiftStageConfig(**SMALL_K), batch_size=2, verbose=False, device="cpu")
    n1 = lift_kitti.run_lift_kitti(str(root), str(kmasks), [0, 1, 2], str(tmp_path / "k1"), **kw)
    n2 = lift_kitti.run_lift_kitti(str(root), str(kmasks), [0, 1, 2], str(tmp_path / "k2"),
                                   data_parallel=2, **kw)
    assert n1 == n2 >= 9
    for kind in ("pred", "pseudo"):
        names = sorted(p.name for p in (tmp_path / "k1" / kind).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "k2" / kind).iterdir())
        assert len(names) == 3
        for name in names:
            assert ((tmp_path / "k2" / kind / name).read_bytes()
                    == (tmp_path / "k1" / kind / name).read_bytes())


# --- training and detection ----------------------------------------------------

def test_pretrain_follows_single_process_and_resumes_exactly(nusc, tmp_path):
    """LiDAR-only, 6 steps with augmentation (the global batch's draw, each
    rank its rows): within rtol 1e-5 / atol 1e-6 of the single-process run,
    as JAX's test_pretrain_data_parallel_matches_single_device; 3 steps +
    save + resume to 6 under data parallelism equals the 6 straight steps
    (1e-6); then run_detect with data_parallel=2 writes the single-process
    submission exactly."""
    root, _, _, labels, _ = nusc
    single = _train(root, labels, tmp_path / "single", augment=True)
    dp = _train(root, labels, tmp_path / "dp", augment=True, data_parallel=2, save_every=3)
    assert dp.keys() == single.keys()
    for k in single:
        np.testing.assert_allclose(dp[k], single[k], rtol=1e-5, err_msg=k)
    a = load_params(str(tmp_path / "single" / "centerpoint"))
    b = load_params(str(tmp_path / "dp" / "centerpoint"))
    _assert_trees_close(a, b, rtol=1e-5, atol=1e-6)

    (tmp_path / "resumed").mkdir()
    shutil.copytree(tmp_path / "dp" / "state_000003", tmp_path / "resumed" / "state_000003")
    _train(root, labels, tmp_path / "resumed", augment=True, data_parallel=2, resume=True,
           save_every=3)
    for name in ("state_000006", "centerpoint"):
        _assert_trees_close(load_params(str(tmp_path / "dp" / name)),
                            load_params(str(tmp_path / "resumed" / name)),
                            rtol=0, atol=1e-6, where=name)

    ckpt = str(tmp_path / "dp" / "centerpoint")
    want = tdetect.run_detect(str(root), VERSION, ckpt, str(tmp_path / "d1.json"),
                              model_cfg=MODEL, **DETECT_KW)
    got = tdetect.run_detect(str(root), VERSION, ckpt, str(tmp_path / "d2.json"),
                             model_cfg=MODEL, data_parallel=2, **DETECT_KW)
    assert got["results"] == want["results"]
    assert sum(len(v) for v in got["results"].values()) > 0


def test_pretrain_without_augmentation_follows_single_process(nusc, tmp_path):
    """The same tolerance with the plain batch (no draw), and the flags'
    validation with JAX's words."""
    root, _, _, labels, _ = nusc
    _train(root, labels, tmp_path / "single")
    _train(root, labels, tmp_path / "dp", data_parallel=2)
    _assert_trees_close(load_params(str(tmp_path / "single" / "centerpoint")),
                        load_params(str(tmp_path / "dp" / "centerpoint")),
                        rtol=1e-5, atol=1e-6)
    with pytest.raises(SystemExit, match="divide"):
        _train(root, labels, tmp_path / "bad", data_parallel=3, batch_size=2)


def test_fusion_pretrain_and_detect(nusc, tmp_path):
    """BEVFusion-lite with the conv camera, 3 steps: within JAX's rtol
    1e-3 / atol 1e-5 (tests/test_pretrain_detect.py:243); run_detect with
    data_parallel=2 (the camera operands split too): the same boxes, the
    translations within 1e-4."""
    from cm3d_tpu_torch.train.bevfusion import BevFusionConfig

    root, _, _, labels, _ = nusc
    fusion = BevFusionConfig(centerpoint=MODEL, cam_trunk=(4, 8), cam_channels=4, depth_bins=4,
                             d_min=1.0, d_max=25.0)
    hw = (48, 64)
    kw = dict(steps=3, use_camera=True, image_hw=hw, fusion_cfg=fusion)
    _train(root, labels, tmp_path / "single", **kw)
    _train(root, labels, tmp_path / "dp", data_parallel=2, **kw)
    _assert_trees_close(load_params(str(tmp_path / "single" / "bevfusion")),
                        load_params(str(tmp_path / "dp" / "bevfusion")),
                        rtol=1e-3, atol=1e-5)
    ckpt = str(tmp_path / "single" / "bevfusion")
    dkw = dict(DETECT_KW, use_camera=True, image_hw=hw, fusion_cfg=fusion)
    want = tdetect.run_detect(str(root), VERSION, ckpt, str(tmp_path / "d1.json"), **dkw)
    got = tdetect.run_detect(str(root), VERSION, ckpt, str(tmp_path / "d2.json"),
                             data_parallel=2, **dkw)
    assert set(got["results"]) == set(want["results"])
    n = 0
    for tok, boxes in want["results"].items():
        assert len(got["results"][tok]) == len(boxes)
        for ba, bb in zip(boxes, got["results"][tok]):
            assert ba["detection_name"] == bb["detection_name"]
            np.testing.assert_allclose(ba["translation"], bb["translation"], rtol=0, atol=1e-4)
            n += 1
    assert n > 0


# --- the axis_name step ------------------------------------------------------------

AXIS_SEED, AXIS_AUG_SEED = 0, 7


def axis_program(device):
    """One rank of the `axis_name` train step (a data-parallel worker
    rebuilds it by this name): the rows of each call are this rank's
    batch; returns the BatchNorm running statistics after the step, one
    row a rank."""
    from cm3d_tpu_torch.train.augment import AugmentConfig

    state, model, tx = ttrain.init_state(AXIS_SEED, PILLAR, MODEL, device=device)
    step = ttrain.make_train_step(model, tx, PILLAR, axis_name="data",
                                  augment=AugmentConfig(), aug_seed=AXIS_AUG_SEED)

    def program(points, point_valid, boxes, box_valid):
        batch = ttrain.TrainBatch(points, point_valid, boxes, box_valid)
        step(state, batch)
        return {k: v.detach().clone()[None] for k, v in state.batch_stats.items()}

    return program


def test_axis_name_step_decorrelates_augmentation_and_syncs_statistics():
    """JAX's test_augment_decorrelates_across_devices (tests/test_train.py:
    289) on two gloo ranks with identical batches: each rank folds its rank
    into the augmentation generator, so the ranks' transforms differ; the
    BatchNorm running statistics are averaged over the group, so they are
    bit-equal across ranks, and differ from the run without axis_name (the
    draw a rank would make without the fold)."""
    from test_torch_train import _make_batch, _torch_batch

    from cm3d_tpu_torch.train.augment import AugmentConfig

    one = _torch_batch(_make_batch(b=1, n=1024, m=2))
    both = tuple(torch.cat([t, t]) for t in one)  # rank r gets row r: the same batch
    with DataParallelGroup(2, "cpu", Program(f"{__name__}:axis_program")) as group:
        stats = group.run(axis_program("cpu"), both)
    assert stats
    for name, rows in stats.items():
        assert torch.equal(rows[0], rows[1]), name

    state, model, tx = ttrain.init_state(AXIS_SEED, PILLAR, MODEL, device="cpu")
    ttrain.make_train_step(model, tx, PILLAR, augment=AugmentConfig(),
                           aug_seed=AXIS_AUG_SEED)(state, ttrain.TrainBatch(*one))
    spread = max(float((stats[k][0] - v).abs().max()) for k, v in state.batch_stats.items())
    assert spread > 0, "the ranks drew the transforms of the unfolded generator"


def test_a_worker_failure_reaches_rank_0_as_an_error():
    """A worker whose factory raises: rank 0 gets a RuntimeError carrying
    the worker's traceback, not a hang; a group started after it works."""
    with pytest.raises(RuntimeError, match="no such factory|has no attribute"):
        with DataParallelGroup(2, "cpu", Program(f"{__name__}:no_such_factory")) as group:
            group.run(lambda x: x, (torch.zeros(2, 3),))
    with DataParallelGroup(2, "cpu", Program(f"{__name__}:_identity_program")) as group:
        got = group.run(lambda x: x + 1, (torch.arange(4.0).reshape(4, 1),))
    np.testing.assert_array_equal(got.numpy().ravel(), [1, 2, 3, 4])


def _identity_program(device):
    return lambda x: x + 1

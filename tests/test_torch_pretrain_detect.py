"""The port's pretrain -> detect -> eval loop on the nuScenes fixture, on the
CPU: checkpoint and resume of the full train state (exact), warm start,
label sources, the box cap, the submission the eval CLI scores, the BEVFusion
loop, and the JAX package's trained parameters converted into the port, which
must give `run_detect` the JAX `run_detect`'s boxes.

The dataroot is `tests/nusc_fixture.py`'s; the pseudo-labels are made from a
numpy seed. Tolerances are stated where they are used.
"""

import json

import jax
import numpy as np
import pytest
import torch

from cm3d_tpu.train import CenterPointConfig as JCenterPointConfig
from cm3d_tpu.train import PillarConfig as JPillarConfig
from cm3d_tpu_torch.models.checkpoints import (
    load_params,
    load_released_checkpoint,
    save_params,
)
from cm3d_tpu_torch.models.convert import centerpoint_state_dict_from_flax
from cm3d_tpu_torch.pipelines import detect as tdetect
from cm3d_tpu_torch.pipelines import pretrain as tpretrain
from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig
from nusc_fixture import VERSION, make_fake_nuscenes

GEO = dict(x_min=-25.6, x_max=25.6, y_min=-25.6, y_max=25.6, resolution=0.8)
MODEL_KW = dict(trunk_channels=(16, 16), head_channels=16)
PILLAR, MODEL = PillarConfig(**GEO), CenterPointConfig(**MODEL_KW)
JPILLAR, JMODEL = JPillarConfig(**GEO), JCenterPointConfig(**MODEL_KW)
DETECT_KW = dict(batch_size=2, top_k=16, score_thresh=0.0, max_points=4096, verbose=False)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Fixture dataroot + a pseudo-label submission JSON over its samples."""
    from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables

    tmp = tmp_path_factory.mktemp("pretrain")
    root = tmp / "nusc"
    make_fake_nuscenes(root, tmp / "planted", n_frames=3, n_objects=2)
    nusc = NuScenesTables(root, VERSION)
    results = {}
    rng = np.random.default_rng(7)
    for sample in nusc.table("sample"):
        ego_t = np.asarray(nusc.sample_lidar_ego_pose(sample)["translation"], np.float64)
        boxes = []
        for name, off in (("car", (5.0, 3.0)), ("pedestrian", (-4.0, 6.0))):
            t = ego_t + [off[0] + rng.normal(0, 0.5), off[1] + rng.normal(0, 0.5), 0.0]
            boxes.append({
                "sample_token": sample["token"],
                "translation": [float(v) for v in t],
                "size": [1.8, 4.5, 1.4] if name == "car" else [0.7, 0.7, 1.7],
                "rotation": [1.0, 0.0, 0.0, 0.0],
                "velocity": [0, 0],
                "detection_name": name,
                "detection_score": 0.9,
                "attribute_name": "",
            })
        results[sample["token"]] = boxes
    labels = tmp / "labels.json"
    labels.write_text(json.dumps({"meta": {}, "results": results}))
    return root, str(labels), nusc


def _train(root, labels, out_dir, **kw):
    base = dict(steps=6, batch_size=2, learning_rate=1e-3, verbose=False,
                pillar_cfg=PILLAR, model_cfg=MODEL, device="cpu")
    base.update(kw)
    return tpretrain.run_pretrain(str(root), VERSION, labels, str(out_dir), **base)


def _assert_trees_equal(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_pretrain_resume_equals_uninterrupted(dataset, tmp_path):
    """Kill-and-restart: 3 steps + save + resume to 6 equals an uninterrupted
    6-step run exactly: the full train state round-trips and the
    (seed, step)-keyed batch picking replays."""
    root, labels, _ = dataset
    m = _train(root, labels, tmp_path / "A")
    assert np.isfinite(m["loss"]) and set(m) == {"loss", "loss_heatmap", "loss_reg"}
    _train(root, labels, tmp_path / "B", steps=3, save_every=3)
    assert tpretrain.latest_state_dir(str(tmp_path / "B")).endswith("state_000003")
    state = load_params(str(tmp_path / "B" / "state_000003"))
    assert state["step"] == 3 and state["opt_state"]["count"] == 3
    assert state["ema_params"] is None
    _train(root, labels, tmp_path / "B", steps=6, save_every=3, resume=True)
    a = load_params(str(tmp_path / "A" / "centerpoint"))
    b = load_params(str(tmp_path / "B" / "centerpoint"))
    assert set(a) == {"params", "batch_stats"}
    _assert_trees_equal(a, b)
    # the three resumed steps moved the parameters
    c = load_params(str(tmp_path / "B" / "state_000003"))["params"]
    assert any(not torch.equal(c[k], b["params"][k]) for k in c)
    with pytest.raises(SystemExit, match="no state_"):
        _train(root, labels, tmp_path / "empty", resume=True)
    assert tpretrain.latest_state_dir(str(tmp_path / "nowhere")) is None


def test_recipe_flags_ema_deploy_and_resume_with_ema(dataset, tmp_path):
    """Schedule, warm-up, clip, EMA and augmentation through run_pretrain:
    the deploy checkpoint is the EMA (differs from a run without it), and a
    resumed run with all of them on equals the uninterrupted one exactly,
    the augmentation's (seed, step) draws included."""
    root, labels, _ = dataset
    kw = dict(steps=4, lr_schedule="cosine", warmup_steps=1, grad_clip=1.0, augment=True)
    m = _train(root, labels, tmp_path / "ema", ema_decay=0.9, save_every=2, **kw)
    assert np.isfinite(m["loss"])
    _train(root, labels, tmp_path / "raw", **kw)
    a = load_params(str(tmp_path / "ema" / "centerpoint"))
    b = load_params(str(tmp_path / "raw" / "centerpoint"))
    assert max(float((a["params"][k] - b["params"][k]).abs().max()) for k in a["params"]) > 0
    saved = load_params(str(tmp_path / "ema" / "state_000004"))
    _assert_trees_equal(saved["ema_params"], a["params"])
    _train(root, labels, tmp_path / "ema2", ema_decay=0.9, save_every=2, **{**kw, "steps": 2})
    _train(root, labels, tmp_path / "ema2", ema_decay=0.9, save_every=2, resume=True, **kw)
    _assert_trees_equal(a, load_params(str(tmp_path / "ema2" / "centerpoint")))
    # a state saved with EMA does not resume into a run without it
    with pytest.raises(ValueError, match="disagree on EMA"):
        _train(root, labels, tmp_path / "ema2", resume=True, **kw)


def test_finetune_gt_split_warm_start(dataset, tmp_path):
    """--labels_gt --split --init_from: parameters and batch statistics start
    from the checkpoint, with a fresh optimizer at step 0."""
    root, labels, _ = dataset
    _train(root, labels, tmp_path / "pre", steps=2)
    pre = str(tmp_path / "pre" / "centerpoint")
    # a 0-step fine-tune saves the warm start itself
    _train(root, None, tmp_path / "ft0", steps=0, labels_gt=True, split="scene-0001",
           init_from=pre)
    _assert_trees_equal(load_params(pre), load_params(str(tmp_path / "ft0" / "centerpoint")))
    m = _train(root, None, tmp_path / "ft", steps=2, labels_gt=True, split="scene-0001",
               init_from=pre, save_every=2)
    assert np.isfinite(m["loss"])
    assert load_params(str(tmp_path / "ft" / "state_000002"))["opt_state"]["count"] == 2
    with pytest.raises(ValueError, match="not in the loaded tables"):
        _train(root, None, tmp_path / "x", labels_gt=True, split="scene-9999")
    with pytest.raises(KeyError, match="expected keys"):
        tpretrain.run_pretrain(str(root), VERSION, labels, str(tmp_path / "y"), steps=1,
                               batch_size=2, verbose=False, pillar_cfg=PILLAR, device="cpu",
                               model_cfg=CenterPointConfig(trunk_channels=(16,), head_channels=16),
                               init_from=pre)


def test_label_source_and_flag_validation(dataset, tmp_path):
    root, labels, _ = dataset
    with pytest.raises(SystemExit, match="exactly one label source"):
        _train(root, None, tmp_path / "x")
    with pytest.raises(SystemExit, match="exactly one label source"):
        _train(root, labels, tmp_path / "x", labels_gt=True)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        _train(root, labels, tmp_path / "x", resume=True, init_from=str(tmp_path / "nowhere"))
    # --data_parallel (A14a; test_torch_data_parallel.py runs it) is
    # validated with JAX's words before any work
    with pytest.raises(SystemExit, match="must divide --batch_size 2"):
        _train(root, labels, tmp_path / "x", data_parallel=3)
    with pytest.raises(SystemExit, match="must divide --batch_size 4"):
        tdetect.run_detect(str(root), VERSION, str(tmp_path / "x"), str(tmp_path / "d.json"),
                           data_parallel=3, device="cpu")
    with pytest.raises(SystemExit, match="require --use_camera"):
        tpretrain.main(["--dataroot", str(root), "--labels", labels, "--camera_bf16"])
    with pytest.raises(SystemExit, match="requires --use_camera"):
        tdetect.main(["--dataroot", str(root), "--ckpt", "c", "--camera_backbone", "swin_t"])
    with pytest.raises(SystemExit, match="no training samples"):
        _train(root, _empty_labels(tmp_path), tmp_path / "x")


def _empty_labels(tmp_path):
    path = tmp_path / "none.json"
    path.write_text(json.dumps({"meta": {}, "results": {"no-such-token": []}}))
    return str(path)


def test_build_gt_labels_and_box_cap_by_score(dataset):
    from cm3d_tpu_torch.eval.config import CATEGORY_TO_DETECTION_NAME

    root, labels, nusc = dataset
    results = tpretrain.build_gt_labels(str(root), VERSION, tables=nusc)
    samples = nusc.table("sample")
    assert set(results) == {s["token"] for s in samples}
    for s in samples:
        expect = [a for a in (nusc.get("sample_annotation", t) for t in s["anns"])
                  if a["category_name"] in CATEGORY_TO_DETECTION_NAME]
        assert len(results[s["token"]]) == len(expect) > 0
        for o, a in zip(results[s["token"]], expect):
            assert o["detection_name"] == CATEGORY_TO_DETECTION_NAME[a["category_name"]]
            np.testing.assert_allclose(o["translation"], a["translation"])
            np.testing.assert_allclose(o["size"], a["size"])
    assert tpretrain.split_sample_tokens(nusc, "scene-0001") == set(results)

    with open(labels) as f:
        pseudo = json.load(f)["results"]
    token = next(iter(pseudo))
    tpl = pseudo[token][0]

    def mk(name, score):
        # the width encodes the score, so the kept set shows in the boxes
        return dict(tpl, detection_name=name, detection_score=score, size=[score * 10.0, 4.5, 1.4])

    # 4 unmapped names first, then 4 cars: max_boxes=2 keeps the two
    # highest-scoring mapped ones
    capped = {token: [mk("not_a_class", 0.99)] * 4 + [mk("car", s) for s in (0.1, 0.4, 0.2, 0.8)]}
    rows = list(tpretrain.build_train_batches(str(root), VERSION, max_boxes=2, results=capped))
    assert len(rows) == 1
    _, points, n_pts, boxes, bvalid = rows[0]
    assert points.shape == (n_pts, 4) and 0 < n_pts <= tpretrain.MAX_POINTS
    assert bvalid.sum() == 2
    np.testing.assert_allclose(sorted(float(w) for w in boxes[bvalid][:, 3]), [4.0, 8.0],
                               rtol=1e-6)


def test_detect_writes_a_submission_the_eval_scores(dataset, tmp_path):
    from cm3d_tpu_torch.datasets.nuscenes import load_gt_for_eval
    from cm3d_tpu_torch.eval.__main__ import main as eval_main
    from cm3d_tpu_torch.eval.boxes import EvalBoxes

    root, labels, nusc = dataset
    out = tmp_path / "ck"
    _train(root, labels, out, steps=2)
    sub = tdetect.run_detect(str(root), VERSION, str(out / "centerpoint"),
                             str(tmp_path / "det.json"), pillar_cfg=PILLAR, model_cfg=MODEL,
                             device="cpu", **DETECT_KW)
    tokens = {s["token"] for s in nusc.table("sample")}
    assert set(sub["results"]) == tokens
    assert json.loads((tmp_path / "det.json").read_text())["results"] == sub["results"]
    eb = EvalBoxes.deserialize(sub["results"])
    n_boxes = 0
    for token in tokens:
        for box in eb[token]:
            n_boxes += 1
            assert 0.0 <= box.detection_score <= 1.0
            assert all(s > 0 for s in box.size)  # exp-decoded sizes
            np.testing.assert_allclose(np.linalg.norm(box.rotation), 1.0, atol=1e-6)
    assert n_boxes > 0  # score_thresh 0: circle NMS keeps at least the top box

    # the scene filter
    scene = nusc.table("scene")[0]["name"]
    one = tdetect.run_detect(str(root), VERSION, str(out / "centerpoint"),
                             str(tmp_path / "one.json"), scenes=[scene], pillar_cfg=PILLAR,
                             model_cfg=MODEL, device="cpu", **DETECT_KW)
    assert set(one["results"]) == {s["token"] for s in
                                   nusc.iter_samples(nusc.scene_by_name(scene))}

    # the whole loop: the eval CLI scores the trained detector's submission,
    # against the tables and in hermetic mode (2 steps from random weights
    # score about 0: the point is that every stage connects)
    summary = eval_main([str(tmp_path / "det.json"), "--dataroot", str(root), "--version",
                         VERSION, "--eval_set", "all", "--output_dir", str(tmp_path / "m1"),
                         "--verbose", "0"])
    assert np.isfinite(summary["mean_ap"]) and np.isfinite(summary["nd_score"])
    gt, egos, _, _ = load_gt_for_eval(root, VERSION)
    (tmp_path / "gt.json").write_text(json.dumps(
        {"ego_translations": {k: list(v) for k, v in egos.items()}, "boxes": gt.serialize()}))
    hermetic = eval_main([str(tmp_path / "det.json"), "--gt_json", str(tmp_path / "gt.json"),
                          "--output_dir", str(tmp_path / "m2"), "--verbose", "0"])
    assert np.isfinite(hermetic["mean_ap"])


def test_jax_trained_parameters_give_the_jax_detections(dataset, tmp_path):
    """Two steps of the JAX package's run_pretrain, its checkpoint converted
    into the port's deploy tree, then run_detect in both packages: the same
    samples, the same number of boxes each, the same classes, centres and
    sizes within 1e-3 m and scores within 1e-5 (f32 convolutions in another
    addition order under a top-k and an NMS)."""
    from cm3d_tpu.models.checkpoints import load_params as jload_params
    from cm3d_tpu.pipelines.detect import run_detect as jrun_detect
    from cm3d_tpu.pipelines.pretrain import run_pretrain as jrun_pretrain

    root, labels, _ = dataset
    jout = tmp_path / "jax"
    jrun_pretrain(str(root), VERSION, labels, str(jout), steps=2, batch_size=2,
                  learning_rate=1e-3, verbose=False, pillar_cfg=JPILLAR, model_cfg=JMODEL)
    want = jrun_detect(str(root), VERSION, str(jout / "centerpoint"), str(tmp_path / "j.json"),
                       pillar_cfg=JPILLAR, model_cfg=JMODEL, **DETECT_KW)
    tree = jax.tree.map(np.asarray, jload_params(str(jout / "centerpoint")))
    sd = centerpoint_state_dict_from_flax(tree["params"], tree["batch_stats"], MODEL)
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    save_params({"params": {k: v for k, v in sd.items() if k not in stats},
                 "batch_stats": stats}, str(tmp_path / "converted"))
    got = tdetect.run_detect(str(root), VERSION, str(tmp_path / "converted"),
                             str(tmp_path / "t.json"), pillar_cfg=PILLAR, model_cfg=MODEL,
                             device="cpu", **DETECT_KW)
    assert set(got["results"]) == set(want["results"])
    n_boxes = 0
    for token, boxes in want["results"].items():
        mine = got["results"][token]
        assert len(mine) == len(boxes), token
        for a, b in zip(mine, boxes):
            assert a["detection_name"] == b["detection_name"]
            np.testing.assert_allclose(a["translation"], b["translation"], atol=1e-3)
            np.testing.assert_allclose(a["size"], b["size"], rtol=1e-4)
            np.testing.assert_allclose(a["rotation"], b["rotation"], atol=1e-4)
            np.testing.assert_allclose(a["detection_score"], b["detection_score"], atol=1e-5)
        n_boxes += len(boxes)
    assert n_boxes > 0


@pytest.mark.parametrize("backbone", ["conv", "swin_t"])
def test_fusion_pretrain_then_detect(dataset, tmp_path, backbone):
    """pretrain --use_camera trains the camera+LiDAR model on the fixture's
    ring JPEGs; detect --use_camera turns its checkpoint into a submission;
    resume equals uninterrupted here too."""
    from cm3d_tpu_torch.models.swin import SwinConfig
    from cm3d_tpu_torch.train.bevfusion import BevFusionConfig

    root, labels, nusc = dataset
    kw = dict(cam_channels=4, depth_bins=4, d_min=1.0, d_max=25.0)
    if backbone == "conv":
        fusion = BevFusionConfig(centerpoint=MODEL, cam_trunk=(4, 8), **kw)
    else:
        fusion = BevFusionConfig(
            centerpoint=MODEL, camera_backbone="swin_t",
            swin=SwinConfig(embed_dim=8, depths=(1, 1, 1), num_heads=(1, 2, 2),
                            out_indices=(1, 2)), **kw)
    hw = (48, 64)
    cam = dict(use_camera=True, image_hw=hw, fusion_cfg=fusion)
    out = tmp_path / "ckf"
    m = _train(root, labels, out, steps=4, **cam)
    assert np.isfinite(m["loss"]) and (out / "bevfusion").is_dir()
    _train(root, labels, tmp_path / "ckf2", steps=2, save_every=2, **cam)
    _train(root, labels, tmp_path / "ckf2", steps=4, save_every=2, resume=True, **cam)
    _assert_trees_equal(load_params(str(out / "bevfusion")),
                        load_params(str(tmp_path / "ckf2" / "bevfusion")))
    sub = tdetect.run_detect(str(root), VERSION, str(out / "bevfusion"),
                             str(tmp_path / "detf.json"), pillar_cfg=PILLAR, device="cpu",
                             **cam, **DETECT_KW)
    assert set(sub["results"]) == {s["token"] for s in nusc.table("sample")}
    assert sum(len(v) for v in sub["results"].values()) > 0
    # a LiDAR-only checkpoint does not load into the fusion model
    with pytest.raises(KeyError, match="expected keys"):
        _train(root, labels, tmp_path / "lidar", steps=1)
        tdetect.run_detect(str(root), VERSION, str(tmp_path / "lidar" / "centerpoint"),
                           str(tmp_path / "bad.json"), pillar_cfg=PILLAR, device="cpu",
                           **cam, **DETECT_KW)


def test_deterministic_training_restores_its_settings(monkeypatch):
    """Inside: deterministic algorithms on and cuBLAS's workspace fixed;
    afterwards both as they were (a set variable slows every later matrix
    product's host side)."""
    import os

    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert not torch.are_deterministic_algorithms_enabled()
    with tpretrain.deterministic_training():
        assert torch.are_deterministic_algorithms_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")  # the caller's own setting stays
    with pytest.raises(RuntimeError, match="boom"):
        with tpretrain.deterministic_training():
            assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
            raise RuntimeError("boom")
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    assert not torch.are_deterministic_algorithms_enabled()


def test_checkpoint_save_and_load(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "step": 3, "ema_params": None,
            "opt_state": {"count": 3, "mu": {"w": torch.ones(2, 3)}}}
    save_params(tree, str(tmp_path / "ck"))
    _assert_trees_equal(load_params(str(tmp_path / "ck"), like=tree), tree)
    with pytest.raises(FileExistsError):
        save_params(tree, str(tmp_path / "ck"))
    save_params(tree, str(tmp_path / "ck"), overwrite=True)
    assert [p.name for p in (tmp_path / "ck").iterdir()] == ["tree.pt"]  # no temp file stays
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "none"))
    with pytest.raises(KeyError, match="expected keys"):
        load_params(str(tmp_path / "ck"), like={"params": {"v": torch.zeros(2, 3)}})
    with pytest.raises(ValueError, match="shape"):
        load_params(str(tmp_path / "ck"), like={**tree, "params": {"w": torch.zeros(3, 2)}})
    with pytest.raises(TypeError, match="unsupported leaf"):
        save_params({"fn": print}, str(tmp_path / "bad"))
    # a directory loads the port's own tree; a file goes to the converter
    assert set(load_released_checkpoint(str(tmp_path / "ck"), None)) == set(tree)
    with pytest.raises(FileNotFoundError):
        load_released_checkpoint(str(tmp_path / "detic.pth"),
                                 lambda p: torch.load(p, weights_only=True))


def test_train_benchmarks_run_small_on_the_cpu():
    """bench_train / bench_fusion_train with small shapes on the CPU: the
    metric names and the protocol's fields, and nothing of another device's
    baselines."""
    from cm3d_tpu_torch.benchmarks import bench_fusion_train, bench_train
    from cm3d_tpu_torch.train.bevfusion import BevFusionConfig

    small = PillarConfig(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0, resolution=1.0)
    cp = CenterPointConfig(num_classes=3, trunk_channels=(8, 8))
    got = bench_train(2, 2, device="cpu", pillar_cfg=small, model_cfg=cp, n_pts=512, n_box=4)
    assert got["metric"] == "train_step_ms_batch8" and got["n_iters"] == 2
    assert got["value"] > 0 and got["steps_per_sec"] == pytest.approx(1e3 / got["value"])
    assert np.isfinite(got["first_loss"]) and np.isfinite(got["last_loss"])
    fusion = BevFusionConfig(centerpoint=cp, cam_channels=4, cam_trunk=(4, 8), depth_bins=4,
                             d_min=1.0, d_max=7.0)
    got = bench_fusion_train(2, 2, (24, 32), device="cpu", pillar_cfg=small, fusion_cfg=fusion,
                             n_pts=512, n_box=4)
    assert got["metric"] == "fusion_train_step_ms_batch8"
    assert got["camera_backbone"] == "conv" and np.isfinite(got["last_loss"])
    for result in (got,):
        assert "vs_baseline" not in result and "lidar_only_step_ms" not in result

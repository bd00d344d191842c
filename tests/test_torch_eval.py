"""The port's nuScenes eval (cm3d_tpu_torch.eval, datasets/nuscenes/
{tables,splits,gt}.py) against the JAX package's.

Both are the same numpy code, so every metric must be EQUAL, not close: on
seeded random boxes, and on the fabricated dataroot of tests/nusc_fixture.py
whose ground truth both packages load from the raw tables. The port's own
fused pipeline then writes a submission on that dataroot and the port's
eval scores it: images -> boxes -> NDS inside the port.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cm3d_tpu import eval as jax_eval
from cm3d_tpu.datasets.nuscenes import load_gt_for_eval as jax_load_gt_for_eval
from cm3d_tpu.datasets.nuscenes import splits as jax_splits
from cm3d_tpu.datasets.nuscenes.tables import NuScenesTables as JaxNuScenesTables
from cm3d_tpu.eval.__main__ import main as jax_eval_main

from cm3d_tpu_torch import eval as port_eval
from cm3d_tpu_torch.datasets.nuscenes import load_gt_for_eval, splits
from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables
from cm3d_tpu_torch.eval.__main__ import main as eval_main
from cm3d_tpu_torch.eval.boxes import add_center_dist_from_poses, load_prediction

CLASSES = ("car", "truck", "bus", "pedestrian", "bicycle", "motorcycle", "barrier",
           "traffic_cone", "trailer", "construction_vehicle")


def _random_boxes(mod, rng, tokens, n, scored):
    eb = mod.EvalBoxes()
    for t in tokens:
        boxes = []
        for _ in range(n):
            yaw = rng.uniform(-np.pi, np.pi)
            name = str(rng.choice(CLASSES))
            boxes.append(mod.DetectionBox(
                sample_token=t,
                translation=tuple(float(v) for v in rng.uniform(-40, 40, 3)),
                size=tuple(float(v) for v in rng.uniform(0.5, 5, 3)),
                rotation=(float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))),
                velocity=tuple(float(v) for v in rng.uniform(-3, 3, 2)),
                detection_name=name,
                detection_score=float(rng.random()) if scored else -1.0,
                attribute_name="",
                num_pts=-1 if scored else int(rng.integers(1, 50)),
            ))
        eb.add_boxes(t, boxes)
    return eb


def _same(a, b, path="summary"):
    """Exact equality of two metric trees (NaN equals NaN)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg_name,object_only", [
    ("DETECTION_CVPR_2019", False), ("DETECTION_CVPR_2019", True), ("SAM3D_CONFIG", False)])
def test_metrics_equal_on_random_boxes(seed, cfg_name, object_only):
    tokens = [f"tok{i}" for i in range(4)]
    egos = {t: (0.0, 0.0, 0.0) for t in tokens}
    out = []
    for mod in (jax_eval, port_eval):
        rng = np.random.default_rng(seed)  # the same draws for both
        gt = _random_boxes(mod, rng, tokens, 12, scored=False)
        # half the predictions sit near a ground-truth box, so TP errors exist
        pred = _random_boxes(mod, rng, tokens, 16, scored=True)
        for t in tokens:
            for p, g in zip(pred[t][::2], gt[t]):
                p.translation = tuple(v + 0.3 for v in g.translation)
                p.detection_name = g.detection_name
        ev_mod = sys.modules[mod.__name__ + ".evaluate"]
        ev = ev_mod.DetectionEval(gt_boxes=gt, pred_boxes=pred, cfg=getattr(mod, cfg_name),
                                  ego_translations=egos, object_only=object_only,
                                  verbose=False)
        summary = ev.main()
        summary.pop("eval_time", None)
        out.append(summary)
    _same(out[1], out[0])
    assert out[0]["mean_ap"] > 0.0


def test_primitives_equal():
    from cm3d_tpu.eval import algo as jalgo
    from cm3d_tpu_torch.eval import algo

    rng = np.random.default_rng(3)
    for _ in range(20):
        a, b = rng.uniform(-7, 7, 2)
        assert algo.angle_diff(a, b, 2 * np.pi) == jalgo.angle_diff(a, b, 2 * np.pi)
        q = (float(np.cos(a / 2)), 0.0, 0.0, float(np.sin(a / 2)))
        assert algo.quaternion_yaw(q) == jalgo.quaternion_yaw(q)
    x = rng.random(50)
    x[::7] = np.nan
    np.testing.assert_array_equal(algo.cummean(x), jalgo.cummean(x))
    for name in ("DETECTION_CVPR_2019", "SAM3D_CONFIG", "RARE_CONFIG"):
        assert getattr(port_eval, name).serialize() == getattr(jax_eval, name).serialize()


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from nusc_fixture import VERSION, make_fake_nuscenes

    tmp = tmp_path_factory.mktemp("torch_eval")
    root = tmp / "data"
    info = make_fake_nuscenes(root, tmp / "masks", n_frames=3, n_objects=6)
    return root, VERSION, info, tmp


def test_tables_and_gt_equal_on_the_fixture(fake_root):
    root, version, info, _ = fake_root
    port, ref = NuScenesTables(root, version), JaxNuScenesTables(root, version)
    for name in ("sample_annotation", "attribute", "sample"):
        assert port.table(name) == ref.table(name)
    scene = port.scene_by_name(info["scene_name"])
    assert port.count_frames(scene) == ref.count_frames(scene) == 3
    for ann in port.table("sample_annotation")[:12]:
        np.testing.assert_array_equal(port.box_velocity(ann["token"]),
                                      ref.box_velocity(ann["token"]))
    assert port.field2token("sample", "scene_token", scene["token"]) == \
        ref.field2token("sample", "scene_token", scene["token"])
    for kw in ({}, {"rare": True}, {"eval_split_scenes": [info["scene_name"]]}):
        got_gt, got_egos, got_racks, _ = load_gt_for_eval(root, version, **kw)
        want_gt, want_egos, want_racks, _ = jax_load_gt_for_eval(root, version, **kw)
        assert got_gt.serialize() == want_gt.serialize()
        assert got_egos == want_egos
        assert (got_racks or {}) == (want_racks or {})
        assert len(got_gt.all) > 0


def test_splits_equal():
    assert (splits.VAL, splits.MINI_TRAIN, splits.MINI_VAL) == (
        jax_splits.VAL, jax_splits.MINI_TRAIN, jax_splits.MINI_VAL)
    # a v1.0-trainval scene table: the 150 val scenes + 700 others
    names = list(splits.VAL) + [f"scene-{i:04d}" for i in range(2000, 2700)]
    for eval_set in ("val", "val25", "mini_val", "all", "train", "train25",
                     "scene-0003, scene-0012"):
        assert splits.resolve_eval_set(eval_set, names) == \
            jax_splits.resolve_eval_set(eval_set, names)
    assert splits.resolve_eval_set("scene-0003,scene-0012") == ["scene-0003", "scene-0012"]
    for bad, kw in (("train_detect50", dict(scene_names=names)), ("train25", {}), ("all", {}),
                    (" , ", {})):
        with pytest.raises(ValueError):
            splits.resolve_eval_set(bad, **kw)
    with pytest.raises(ValueError, match="not in the loaded tables"):
        splits.resolve_eval_set("val", ["scene-0003"])


def _perfect_submission(root, version, path):
    gt, _, _, _ = load_gt_for_eval(root, version)
    results = {}
    for token in gt.sample_tokens:
        results[token] = []
        for b in gt[token]:
            d = b.serialize()
            d["detection_score"] = 0.9
            results[token].append(d)
    with open(path, "w") as f:
        json.dump({"meta": {}, "results": results}, f)


def test_cli_table_mode_equals_jax(fake_root):
    root, version, _, tmp = fake_root
    sub = tmp / "perfect.json"
    _perfect_submission(root, version, sub)
    out = []
    for main, name in ((jax_eval_main, "jax"), (eval_main, "port")):
        summary = main([str(sub), "--dataroot", str(root), "--version", version, "--eval_set",
                        "all", "--output_dir", str(tmp / f"m_{name}"), "--verbose", "0",
                        "--render_curves", "1"])
        summary.pop("eval_time", None)
        out.append(summary)
        assert os.path.exists(tmp / f"m_{name}" / "metrics_summary.json")
        assert os.listdir(tmp / f"m_{name}" / "plots")
    _same(out[1], out[0])
    assert out[1]["mean_ap"] > 0.35  # perfect predictions on the present classes


def test_port_scores_its_own_fused_submission(fake_root):
    """images -> Detic -> SAM -> lift -> submission -> NDS, all in the port
    (CPU, tiny random models): the eval reads what run_e2e wrote."""
    from cm3d_tpu_torch.config import LiftStageConfig, MaskStageConfig
    from cm3d_tpu_torch.pipelines.e2e import run_e2e
    from cm3d_tpu_torch.pipelines.masks import build_fake_models

    root, version, info, tmp = fake_root
    lift_cfg = LiftStageConfig(max_points=16384, max_masks=32, max_points_per_mask=512,
                               max_points_per_camera=8192, max_points_in_masks=2048,
                               max_lane_points=1024, image_ratio=0.1)
    sub = run_e2e(str(root), version, [info["scene_name"]], str(tmp / "own.json"),
                  build_fake_models(device="cpu"), lift_cfg=lift_cfg,
                  mask_cfg=MaskStageConfig(max_detections=16, max_masks_total=32,
                                           dtype="float32"),
                  batch_size=2, verbose=False, mask_wh=(160, 90), device="cpu")
    assert len(sub["results"]) > 0
    summary = eval_main([str(tmp / "own.json"), "--dataroot", str(root), "--version", version,
                         "--eval_set", "all", "--output_dir", str(tmp / "m_own"),
                         "--verbose", "0", "--object_only", "1"])
    assert set(summary) >= {"mean_ap", "nd_score", "tp_errors"}
    assert 0.0 <= summary["mean_ap"] <= 1.0 and np.isfinite(summary["nd_score"])
    want = jax_eval_main([str(tmp / "own.json"), "--dataroot", str(root), "--version", version,
                          "--eval_set", "all", "--output_dir", str(tmp / "m_own_jax"),
                          "--verbose", "0", "--object_only", "1"])
    for s in (summary, want):
        s.pop("eval_time", None)
    _same(summary, want)


def _hermetic_files(tmp_path, mod=port_eval):
    def box(token, xy, score=-1.0):
        return mod.DetectionBox(sample_token=token, translation=(xy[0], xy[1], 1.0),
                                size=(2.0, 4.0, 1.5), rotation=(1.0, 0.0, 0.0, 0.0),
                                velocity=(0.0, 0.0), detection_name="car",
                                detection_score=score, attribute_name="", num_pts=-1)

    gt, pred = mod.EvalBoxes(), mod.EvalBoxes()
    gt.add_boxes("tok0", [box("tok0", (1.0, 1.0))])
    gt.add_boxes("tok1", [box("tok1", (-3.0, 2.0))])
    pred.add_boxes("tok0", [box("tok0", (1.2, 1.0), 0.9)])
    pred.add_boxes("tok1", [box("tok1", (-3.0, 2.1), 0.8)])
    (tmp_path / "gt.json").write_text(json.dumps({
        "ego_translations": {"tok0": [0, 0, 0], "tok1": [0, 0, 0]},
        "boxes": gt.serialize()}))
    (tmp_path / "pred.json").write_text(json.dumps({
        "meta": {"use_camera": True},
        "results": {t: [b.serialize() for b in pred[t]] for t in pred.sample_tokens}}))
    return str(tmp_path / "pred.json"), str(tmp_path / "gt.json")


def test_cli_hermetic_mode_and_error_paths(tmp_path, fake_root):
    pred, gt = _hermetic_files(tmp_path)
    base = [pred, "--gt_json", gt, "--output_dir", str(tmp_path / "m"), "--verbose", "0"]
    summary = eval_main(base + ["--plot_examples", "2", "--dataroot", "/nonexistent/nuscenes"])
    want = jax_eval_main(base + ["--output_dir", str(tmp_path / "mj")])
    for s in (summary, want):
        s.pop("eval_time", None)
    _same(summary, want)
    assert summary["mean_ap"] > 0.0
    assert len(os.listdir(tmp_path / "m" / "examples")) == 2  # boxes-only examples
    with pytest.raises(SystemExit, match="drivable_filtering"):
        eval_main(base + ["--drivable_filtering", "1"])
    # a prediction token without a pose: loud, and names the token
    sub = json.loads(open(pred).read())
    sub["results"]["tok9"] = [dict(sub["results"]["tok0"][0], sample_token="tok9")]
    (tmp_path / "extra.json").write_text(json.dumps(sub))
    with pytest.raises(SystemExit, match="tok9"):
        eval_main([str(tmp_path / "extra.json")] + base[1:])
    with pytest.raises(KeyError, match="ego pose for sample 'tok9'"):
        add_center_dist_from_poses(load_prediction(str(tmp_path / "extra.json"))[0],
                                   {"tok0": (0, 0, 0), "tok1": (0, 0, 0)})
    # table mode's example plots draw the lidar points behind the boxes
    # through the pretraining pipeline's points frontend
    root, version, _, tmp = fake_root
    _perfect_submission(root, version, tmp / "perfect2.json")
    eval_main([str(tmp / "perfect2.json"), "--dataroot", str(root), "--version", version,
               "--eval_set", "all", "--output_dir", str(tmp_path / "mt"), "--verbose", "0",
               "--plot_examples", "1"])
    assert len(os.listdir(tmp_path / "mt" / "examples")) == 1
    with pytest.raises(FileNotFoundError):
        eval_main([pred, "--dataroot", "/nonexistent/nuscenes", "--output_dir",
                   str(tmp_path / "mn"), "--verbose", "0"])


def test_eval_imports_neither_jax_nor_cm3d_tpu():
    code = (
        "import sys\n"
        "import cm3d_tpu_torch.eval, cm3d_tpu_torch.eval.__main__, cm3d_tpu_torch.eval.render\n"
        "import cm3d_tpu_torch.datasets.nuscenes.gt, cm3d_tpu_torch.datasets.nuscenes.splits\n"
        "import cm3d_tpu_torch.pipelines.e2e, cm3d_tpu_torch.kernels.window_attn_relpos\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'flax' or m == 'cm3d_tpu' or m.startswith('cm3d_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == ""

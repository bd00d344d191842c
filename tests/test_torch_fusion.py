"""The port's late fusion (cm3d_tpu_torch.pipelines.fusion) and shape-prior
extractor (pipelines.get_priors) against the JAX package on the CPU.

The JAX fusion tests run on the port's module; on the same seeded inputs
both packages pick the same alpha with the same score and write the same
fused submission (nuScenes JSON, equal) and Objects .bin (equal bytes):
the work is host numpy and the same native Hungarian matcher, so nothing
needs a tolerance. The priors JSON equals JAX's and loads through the
port's `config.load_priors_file`.
"""

import json

import numpy as np
import pytest

import cm3d_tpu.pipelines.fusion as jax_fusion
import test_fusion as jax_fusion_tests
from cm3d_tpu.datasets.waymo.proto import LABEL_TYPE_VEHICLE, WaymoBox, WaymoObject, encode_objects
from cm3d_tpu.pipelines.get_priors import compute_priors as jax_compute_priors

from cm3d_tpu_torch.config import SHAPE_PRIORS_CHATGPT, load_priors_file
from cm3d_tpu_torch.pipelines import fusion, get_priors

JAX_TESTS = ("test_matching_and_merge_semantics", "test_run_fusion_nuscenes_improves",
             "test_run_fusion_waymo", "test_size_round_trips_and_zero_min_semantics",
             "test_alpha_grid_waymo_quirks", "test_alpha_grid_rejects_degenerate_extrema")


def test_the_list_is_every_jax_fusion_test():
    assert sorted(JAX_TESTS) == sorted(n for n in dir(jax_fusion_tests) if n.startswith("test_"))


@pytest.mark.parametrize("name", JAX_TESTS)
def test_port_passes_the_jax_fusion_tests(name, monkeypatch, tmp_path):
    """tests/test_fusion.py with the port's fusion functions in place of
    the JAX package's (the same assertions, the port's code; the pred-only
    baseline stays the JAX eval's)."""
    for attr in ("alpha_grid", "compute_matches", "merge_for_alpha", "run_fusion_nuscenes",
                 "run_fusion_waymo", "submission_to_7dof"):
        monkeypatch.setattr(jax_fusion_tests, attr, getattr(fusion, attr))
    # the tests' function-local imports read these module attributes
    for attr in ("alpha_grid", "alpha_grid_waymo"):
        monkeypatch.setattr(jax_fusion, attr, getattr(fusion, attr))
    fn = getattr(jax_fusion_tests, name)
    fn(tmp_path) if fn.__code__.co_argcount else fn()


def _nusc_inputs(tmp_path, seed):
    """Three samples of eight GT boxes (cars and pedestrians); CM3D finds
    some, SAM3D others and many of the same (matched pairs on both sides of
    alpha)."""
    rng = np.random.default_rng(seed)
    sub = jax_fusion_tests._sub_box
    gt, pred, sam, egos = {}, {}, {}, {}
    for t in ("s0", "s1", "s2"):
        egos[t] = [0.0, 0.0, 0.0]
        gt[t], pred[t], sam[t] = [], [], []
        for j in range(8):
            name = ("car", "pedestrian")[j % 2]
            size = (2.0, 4.5, 1.6) if name == "car" else (0.7, 0.7, 1.8)
            xy = rng.uniform(-30, 30, 2)
            yaw = float(rng.uniform(-np.pi, np.pi))
            g = sub(t, xy, name=name, score=-1.0, size=size, yaw=yaw)
            g["num_pts"] = 10
            gt[t].append(g)
            if j % 4 != 3:
                pred[t].append(sub(t, xy + rng.normal(0, 0.2, 2), name=name,
                                   score=rng.uniform(0.3, 0.9), size=size, yaw=yaw))
            if j % 4 != 0:
                sam[t].append(sub(t, xy + rng.normal(0, 0.2, 2), name=name,
                                  score=rng.uniform(0.05, 0.6), size=size, yaw=yaw))
    paths = {k: tmp_path / f"{k}.json" for k in ("pred", "sam", "gt")}
    for k, res in (("pred", pred), ("sam", sam)):
        paths[k].write_text(json.dumps({"meta": {}, "results": res}))
    paths["gt"].write_text(json.dumps({"ego_translations": egos, "boxes": gt}))
    return paths


def test_fusion_nuscenes_equals_jax(tmp_path):
    paths = _nusc_inputs(tmp_path, seed=3)
    args = [str(paths["pred"]), str(paths["sam"]), str(paths["gt"])]
    got = fusion.run_fusion_nuscenes(*args, str(tmp_path / "port.json"), verbose=False)
    want = jax_fusion.run_fusion_nuscenes(*args, str(tmp_path / "jax.json"), verbose=False)
    assert got == want and got[1] > 0
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    # the merge at every alpha of the grid, not only the best
    pb, ps, pmin, pmax = fusion.submission_to_7dof(json.loads(paths["pred"].read_text()))
    sb, ss, smin, smax = fusion.submission_to_7dof(json.loads(paths["sam"].read_text()),
                                                   exclude_zero_min=True)
    jpb, jps, *jp_ext = jax_fusion.submission_to_7dof(json.loads(paths["pred"].read_text()))
    jsb, jss, *js_ext = jax_fusion.submission_to_7dof(json.loads(paths["sam"].read_text()),
                                                      exclude_zero_min=True)
    assert [pmin, pmax, smin, smax] == jp_ext + js_ext
    assert fusion.compute_matches(pb, sb) == jax_fusion.compute_matches(jpb, jsb)
    pm, sm = fusion.compute_matches(pb, sb)
    assert sum(len(v) for v in pm.values()) >= 6
    grid = fusion.alpha_grid(pmin, pmax, smin, smax)
    assert grid == jax_fusion.alpha_grid(pmin, pmax, smin, smax) and len(grid) > 3
    for alpha in grid:
        assert fusion.merge_for_alpha(alpha, pb, ps, sb, ss, pm, sm) == \
            jax_fusion.merge_for_alpha(alpha, jpb, jps, jsb, jss, pm, sm)


def test_fusion_waymo_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(9)

    def obj(xy, score, ts, oid):
        return WaymoObject(
            box=WaymoBox(float(xy[0]), float(xy[1]), 1.0, 2.0, 4.5, 1.6,
                         float(rng.uniform(-0.2, 0.2))),
            type=LABEL_TYPE_VEHICLE, score=score, frame_timestamp_micros=ts,
            context_name="ctx", id=oid, num_lidar_points_in_box=20)

    gts, preds, sams = [], [], []
    for ts in range(3):
        for j in range(5):
            xy = rng.uniform(-30, 30, 2)
            gts.append(obj(xy, 0.5, ts, f"g{j}"))
            if j != 4:
                preds.append(obj(xy + rng.normal(0, 0.1, 2), float(rng.uniform(0.4, 0.9)), ts,
                                 f"p{j}"))
            if j >= 2:
                sams.append(obj(xy + rng.normal(0, 0.1, 2), float(rng.uniform(0.05, 0.5)), ts,
                                f"s{j}"))
    for name, objs in (("gt", gts), ("pred", preds), ("sam", sams)):
        (tmp_path / f"{name}.bin").write_bytes(encode_objects(objs))
    args = [str(tmp_path / f"{n}.bin") for n in ("pred", "sam", "gt")]
    got = fusion.run_fusion_waymo(*args, str(tmp_path / "port.bin"), verbose=False)
    want = jax_fusion.run_fusion_waymo(*args, str(tmp_path / "jax.bin"), verbose=False)
    assert got == want and got[1] > 0.3
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()
    # the CLI writes the same file
    fusion.main(["waymo", "--pred", args[0], "--sam3d", args[1], "--gt", args[2],
                 "--out", str(tmp_path / "cli.bin")])
    assert f"Best Score: {got[1]}, Best Alpha: {got[0]}" in capsys.readouterr().out
    assert (tmp_path / "cli.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_get_priors_equals_jax_and_loads(tmp_path, capsys):
    """The reference's quirks (the first annotation of each category and the
    last sample of each scene dropped) on the nuScenes fixture, through the
    CLI; the JSON loads as `LiftStageConfig.priors_file` expects."""
    from nusc_fixture import VERSION, make_fake_nuscenes

    root = tmp_path / "data"
    make_fake_nuscenes(root, tmp_path / "masks", n_frames=4, n_objects=8)
    out = tmp_path / "priors.json"
    get_priors.main(["--dataroot", str(root), "--version", VERSION, "--out", str(out)])
    assert "categories to" in capsys.readouterr().out
    got = json.loads(out.read_text())
    assert got == jax_compute_priors(str(root), VERSION) and len(got) >= 3
    priors = load_priors_file(str(out))
    assert set(SHAPE_PRIORS_CHATGPT) <= set(priors)
    assert priors["car"] == tuple(got["vehicle.car"])
    (root / VERSION / "sample_annotation.json").unlink()
    with pytest.raises(FileNotFoundError, match="sample_annotation"):
        get_priors.compute_priors(str(root), VERSION)

"""The port's lift CLI (cm3d_tpu_torch.pipelines.lift) against the JAX
package's on a fabricated nuScenes dataroot, plus the port's import
isolation: it must load neither JAX nor any module of cm3d_tpu."""

import json
import subprocess
import sys

import numpy as np
import pytest

from cm3d_tpu.config import LiftStageConfig as JaxLiftStageConfig
from cm3d_tpu.pipelines.lift import run_lift as jax_run_lift

from cm3d_tpu_torch.config import LiftStageConfig
from cm3d_tpu_torch.pipelines.lift import main, run_lift

SMALL_LIFT = dict(
    max_points=16384, max_masks=32, max_points_per_mask=512,
    max_points_per_camera=8192, max_points_in_masks=2048,
    max_lane_points=1024,
)


@pytest.fixture(scope="module")
def fake_root(tmp_path_factory):
    from nusc_fixture import make_fake_nuscenes

    tmp = tmp_path_factory.mktemp("torch_cli")
    root, masks = tmp / "data", tmp / "masks"
    info = make_fake_nuscenes(root, masks, n_frames=3, n_objects=6)
    return root, masks, info, tmp


def _assert_same_submission(got, want):
    assert set(got["results"]) == set(want["results"])
    n_boxes = 0
    for tok, want_boxes in want["results"].items():
        got_boxes = got["results"][tok]
        assert len(got_boxes) == len(want_boxes), tok
        for g, w in zip(got_boxes, want_boxes):
            assert g["detection_name"] == w["detection_name"]
            assert g["attribute_name"] == w["attribute_name"]
            for key in ("translation", "size", "rotation"):
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4, err_msg=key)
            np.testing.assert_allclose(g["detection_score"], w["detection_score"],
                                       rtol=0, atol=1e-6)
        n_boxes += len(want_boxes)
    assert n_boxes > 0


def test_run_lift_matches_jax(fake_root):
    from nusc_fixture import VERSION

    root, masks, info, tmp = fake_root
    scene = info["scene_name"]
    want = jax_run_lift(str(root), VERSION, str(masks), [scene], str(tmp / "jax.json"),
                        lift_cfg=JaxLiftStageConfig(**SMALL_LIFT), batch_size=2,
                        verbose=False)
    got = run_lift(str(root), VERSION, str(masks), [scene], str(tmp / "torch.json"),
                   lift_cfg=LiftStageConfig(**SMALL_LIFT), batch_size=2,
                   verbose=False, device="cpu")
    _assert_same_submission(got, want)
    with open(tmp / "torch.json") as f:
        assert json.load(f) == got


@pytest.mark.cuda
def test_run_lift_cuda_matches_cpu(fake_root):
    """The CLI path on the card (kernels, pinned copies, the one copy back
    per batch) writes the CPU path's submission box for box."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from nusc_fixture import VERSION

    root, masks, info, tmp = fake_root
    args = (str(root), VERSION, str(masks), [info["scene_name"]])
    kw = dict(lift_cfg=LiftStageConfig(**SMALL_LIFT), batch_size=2, verbose=False)
    cpu = run_lift(*args, str(tmp / "cpu.json"), device="cpu", **kw)
    gpu = run_lift(*args, str(tmp / "cuda.json"), device="cuda", **kw)
    _assert_same_submission(gpu, cpu)


def test_cli_resume_is_idempotent(fake_root, monkeypatch, capsys):
    """`main` end to end on the CPU: a run resumed from a partial output
    converges to the full run's submission."""
    from nusc_fixture import VERSION

    import cm3d_tpu_torch.pipelines.lift as lift_mod

    root, masks, info, tmp = fake_root
    # the CLI's production caps, cut to the fixture's size
    monkeypatch.setattr(lift_mod, "LiftStageConfig",
                        lambda: LiftStageConfig(**SMALL_LIFT))
    args = ["--dataroot", str(root), "--version", VERSION, "--mask_dir", str(masks),
            "--scenes", info["scene_name"], "--batch_size", "2", "--device", "cpu"]
    main(args + ["--out", str(tmp / "cli_full.json")])
    assert "keyframes/sec" in capsys.readouterr().out
    full = json.load(open(tmp / "cli_full.json"))
    first = sorted(full["results"])[0]
    json.dump({"meta": full["meta"], "results": {first: full["results"][first]}},
              open(tmp / "cli_resumed.json", "w"))
    main(args + ["--out", str(tmp / "cli_resumed.json"), "--resume"])
    assert json.load(open(tmp / "cli_resumed.json")) == full


def test_cli_timers_are_the_lift_spans_totals(fake_root, monkeypatch, capsys):
    """The CLI's timers keep the reference's keys (io / device / write /
    total), taken from the lift's spans; with --profile its chrome trace
    holds those spans, once a batch (3 keyframes in batches of 2), and the
    keyframe counters match the CLI's."""
    from nusc_fixture import VERSION

    import cm3d_tpu_torch.pipelines.lift as lift_mod
    from cm3d_tpu_torch.utils.observability import COUNTERS

    root, masks, info, tmp = fake_root
    monkeypatch.setattr(lift_mod, "LiftStageConfig",
                        lambda: LiftStageConfig(**SMALL_LIFT))
    before = COUNTERS["lift.frames"]
    main(["--dataroot", str(root), "--version", VERSION, "--mask_dir", str(masks),
          "--scenes", info["scene_name"], "--batch_size", "2", "--device", "cpu",
          "--out", str(tmp / "profiled.json"), "--profile", str(tmp / "prof")])
    lines = capsys.readouterr().out.splitlines()
    timers = json.loads(next(x for x in lines if x.startswith('{"timers_sec"')))["timers_sec"]
    assert list(timers) == ["io", "device", "write", "total"]
    assert 0 < timers["device"] < timers["total"] and timers["io"] > 0
    assert [x.split(" :")[0] for x in lines if " :\t\t " in x] == list(timers)
    assert any(x.startswith("keyframes/sec: ") for x in lines)
    counters = json.loads(next(x for x in lines if x.startswith('{"counters"')))["counters"]
    assert COUNTERS["lift.frames"] - before == counters["frames"] == 3  # not the tail's pad
    events = json.loads((tmp / "prof" / "lift.json").read_text())["traceEvents"]
    names = [e["name"] for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith("cm3d.")]
    assert names.count("cm3d.lift.flush") == names.count("cm3d.lift.step") == 2
    assert names.count("cm3d.lift.write") == 2  # the submission's, after the trace, not
    assert names.count("cm3d.lift.io.wait") == 4  # three keyframes, then the end
    assert not (tmp / "prof" / "lift.spans.json").exists()


def test_cli_parses_the_jax_lift_command_line(monkeypatch, tmp_path):
    """C1: a command line of the JAX lift CLI (every flag of
    cm3d_tpu/pipelines/lift.py:175-199) reaches run_lift with its values;
    --host_shard takes host 1 of 2's stride of the scenes."""
    import cm3d_tpu_torch.pipelines.lift as lift_mod

    seen = {}
    monkeypatch.setattr(lift_mod, "run_lift", lambda *args, **kw: seen.update(args=args, kw=kw))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    priors = tmp_path / "priors.json"
    main(["--dataroot", "D", "--version", "v1.0-trainval", "--mask_dir", str(tmp_path),
          "--scenes", "s0,s1,s2,s3", "--out", "o.json", "--batch_size", "16",
          "--data_parallel", "2", "--resume", "--host_shard", "--profile", "prof",
          "--drivable_filter", "--lane_dist_filter", "--dataset_priors",
          "--priors_file", str(priors)])
    assert seen["args"] == ("D", "v1.0-trainval", str(tmp_path), ["s1", "s3"], "o.json")
    kw = seen["kw"]
    assert (kw["batch_size"], kw["data_parallel"], kw["resume"], kw["profile_dir"]) == \
        (16, 2, True, "prof")
    cfg = kw["lift_cfg"]
    assert (cfg.drivable_filter, cfg.lane_dist_filter, cfg.use_chatgpt_priors,
            cfg.priors_file) == (True, True, False, str(priors))
    assert kw["device"] == "cuda"


def test_port_imports_neither_jax_nor_cm3d_tpu():
    code = (
        "import sys\n"
        "import cm3d_tpu_torch, cm3d_tpu_torch.pipelines.lift, cm3d_tpu_torch.benchmarks\n"
        "import cm3d_tpu_torch.ops.lift, cm3d_tpu_torch.parallel.pipeline\n"
        "import cm3d_tpu_torch.kernels.compact, cm3d_tpu_torch.kernels.medoid\n"
        "import cm3d_tpu_torch.datasets.nuscenes, cm3d_tpu_torch.datasets.synthetic\n"
        "import cm3d_tpu_torch.utils.observability, cm3d_tpu_torch.utils.fetch\n"
        "import cm3d_tpu_torch.pipelines.masks, cm3d_tpu_torch.kernels.window_attn\n"
        "import cm3d_tpu_torch.models.swin, cm3d_tpu_torch.models.detic\n"
        "import cm3d_tpu_torch.models.sam, cm3d_tpu_torch.models.convert\n"
        "import cm3d_tpu_torch.ops.maskpack, cm3d_tpu_torch.ops.roi_align, cm3d_tpu_torch.vocab\n"
        "import cm3d_tpu_torch.models.clip_text, cm3d_tpu_torch.models.verify_convert\n"
        "import cm3d_tpu_torch.models.checkpoints, cm3d_tpu_torch.pipelines.e2e\n"
        "import cm3d_tpu_torch.ops.range_image, cm3d_tpu_torch.ops.nms\n"
        "import cm3d_tpu_torch.datasets.waymo, cm3d_tpu_torch.datasets.waymo.frontend\n"
        "import cm3d_tpu_torch.datasets.waymo.frame_proto, cm3d_tpu_torch.pipelines.lift_waymo\n"
        "import cm3d_tpu_torch.geometry.boxes, cm3d_tpu_torch.eval.waymo_metrics\n"
        "import cm3d_tpu_torch.native, cm3d_tpu_torch.config\n"
        "import cm3d_tpu_torch.parallel.multihost, cm3d_tpu_torch.parallel.mesh\n"
        "import cm3d_tpu_torch.pipelines.pretrain, cm3d_tpu_torch.pipelines.detect\n"
        "import cm3d_tpu_torch.deploy, cm3d_tpu_torch.serve, cm3d_tpu_torch.conform\n"
        "import cm3d_tpu_torch.kernels.ops, cm3d_tpu_torch.ops.erosion\n"
        "import cm3d_tpu_torch.ops.quant, cm3d_tpu_torch.models.zoedepth\n"
        "import cm3d_tpu_torch.models.gdino\n"
        "import cm3d_tpu_torch.datasets.kitti.viz, cm3d_tpu_torch.datasets.kitti.viz3d\n"
        "cm3d_tpu_torch.deploy._register_serializations()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'flax' or m == 'cm3d_tpu' or m.startswith('cm3d_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == ""


def test_port_fixtures_import_neither_jax_nor_cm3d_tpu():
    """The dataroots `chip_smoke.py` and the card tests fabricate
    (tests/torch_nusc_fixture.py, tests/kitti_fixture.py) load no JAX."""
    import os

    tests = os.path.dirname(os.path.abspath(__file__))
    code = (
        "import sys\n"
        f"sys.path[:0] = [{tests!r}, {os.path.dirname(tests)!r}]\n"
        "import torch_nusc_fixture, kitti_fixture\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'flax' or m == 'cm3d_tpu' or m.startswith('cm3d_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == ""

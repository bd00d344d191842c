"""Deployment artifacts of the port (cm3d_tpu_torch/deploy.py): export ->
save -> load -> call must be bit-exact against the in-process step, with
the framework NamedTuples preserved across the `.pt2` boundary; the port's
tests/test_deploy.py, plus the artifacts held to the JAX package's own
(load_artifact(...).call on the same batch).

Tolerances against JAX: the lift is exact in counts, flags, keep, labels,
sizes and centroids, and its trig outputs agree to rtol 1e-6 / atol 1e-5
(tests/test_torch_lift.py); the detector on JAX's PRNGKey(0) parameters
keeps the same boxes of the same classes, centres within 1e-3 m, sizes
rtol 1e-4, yaws 1e-4 and scores 1e-5
(tests/test_torch_pretrain_detect.py: f32 convolutions in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from test_deploy import SMALL as JSMALL
from test_deploy import _small_batch
from test_torch_lift import _assert_step_matches

from cm3d_tpu_torch import deploy
from cm3d_tpu_torch.config import DATASET_LIFT_PRESETS, LiftStageConfig, class_arrays
from cm3d_tpu_torch.datasets.types import keyframe_from_numpy
from cm3d_tpu_torch.parallel import make_keyframe_step_fn
from cm3d_tpu_torch.pipelines.detect import make_detect_fn
from cm3d_tpu_torch.train.train import model_tensors

CAPS = dict(num_sweeps=1, max_points=2048, max_masks=16, max_points_per_mask=256,
            max_points_per_camera=1024, max_points_in_masks=512, max_lane_points=64)
SMALL = LiftStageConfig(**CAPS)  # tests/test_deploy.py's SMALL
BOX_TOL = dict(translation=1e-3, size=1e-4, yaw=1e-4, score=1e-5)


@pytest.fixture(scope="module")
def lift_artifacts(tmp_path_factory):
    """The port's and JAX's SMALL lift artifacts at batch 2, saved and
    loaded back."""
    from cm3d_tpu.deploy import export_lift_step as jexport
    from cm3d_tpu.deploy import load_artifact as jload
    from cm3d_tpu.deploy import save_artifact as jsave

    tmp = tmp_path_factory.mktemp("lift")
    port = deploy.save_artifact(deploy.export_lift_step(SMALL, batch_size=2, device="cpu"),
                                tmp / "lift_b2.pt2")
    jax_path = jsave(jexport(JSMALL, batch_size=2), tmp / "lift_b2.stablehlo")
    return deploy.load_artifact(port), jload(jax_path), port


def test_lift_artifact_roundtrip(lift_artifacts):
    """Bit-equal to the port's in-process step, leaf for leaf, with the
    NamedTuple structure back; and held to JAX's artifact on the same
    batch as tests/test_torch_lift.py holds the step."""
    loaded, jloaded, path = lift_artifacts
    assert path.stat().st_size > 0 and loaded.platforms == ["cpu"]
    batch = _small_batch()
    frames = keyframe_from_numpy(batch, "cpu")
    lift, boxes = loaded.call(frames)
    ref_lift, ref_boxes = make_keyframe_step_fn(SMALL, device="cpu")(frames)
    assert type(lift).__name__ == "LiftOutputs"
    assert type(boxes).__name__ == "BoxOutputs"
    for a, b in zip(pytree.tree_leaves((lift, boxes)), pytree.tree_leaves((ref_lift, ref_boxes))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(boxes.keep.sum()) > 0  # the artifact does real work

    want = jax.tree.map(np.asarray, jloaded.call(batch.frames))
    _assert_step_matches((lift, boxes), want)


def _avals(program):
    return [(tuple(a.shape), a.dtype) for a in deploy.in_avals(program)]


def _jax_avals(exported):
    """JAX's avals in the port's dtypes (uint32 mask words ride as int32)."""
    dtypes = {"float32": torch.float32, "bool": torch.bool, "int32": torch.int32,
              "uint32": torch.int32}
    return [(tuple(a.shape), dtypes[str(a.dtype)]) for a in exported.in_avals]


@pytest.mark.parametrize("dataset", sorted(DATASET_LIFT_PRESETS))
def test_lift_export_dataset_preset(dataset):
    """export_lift_step traces the preset it is handed, at JAX's input
    shapes for each dataset preset (cut to SMALL's capacities): as in the
    JAX package, one synthetic frame fixes the shapes, so the presets share
    them, and a differing capacity flows into them."""
    from cm3d_tpu.config import DATASET_LIFT_PRESETS as JPRESETS
    from cm3d_tpu.deploy import export_lift_step as jexport

    port = deploy.export_lift_step(dataclasses.replace(DATASET_LIFT_PRESETS[dataset], **CAPS),
                                   batch_size=1, device="cpu")
    want = _jax_avals(jexport(dataclasses.replace(JPRESETS[dataset], **CAPS), batch_size=1))
    assert _avals(port) == want
    assert _avals(deploy.export_lift_step(SMALL, batch_size=1, device="cpu")) == want
    smaller = deploy.export_lift_step(dataclasses.replace(SMALL, max_points=1024),
                                      batch_size=1, device="cpu")
    assert _avals(smaller) != want


def test_lift_export_takes_a_frames_geometry():
    """`frame` fixes the per-frame shapes (here a 5-camera ring at another
    mask canvas, Waymo's geometry), which the synthetic default does not
    have: the artifact's inputs follow it."""
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe

    cfg = dataclasses.replace(DATASET_LIFT_PRESETS["waymo"], max_points=1024, max_masks=8,
                              max_lane_points=16)
    syn = SyntheticConfig(num_cameras=5, image_w=256, image_h=171, points_per_frame=500,
                          objects_per_frame=4)
    frame = make_keyframe(syn, cfg, np.random.default_rng(0))
    avals = pytree.tree_unflatten(
        deploy.in_avals(deploy.export_lift_step(cfg, batch_size=3, device="cpu", frame=frame)),
        pytree.tree_structure(((frame,), {})))[0][0]
    assert avals.cameras.intrinsics.shape == (3, 5, 3, 3)
    assert avals.mask_bits.shape == (3, 256, 171, 1)
    assert avals.mask_bits.dtype == torch.int32


@pytest.fixture(scope="module")
def jax_detector():
    return jax_centerpoint()


def jax_centerpoint():
    """JAX's CenterPoint at PRNGKey(0) (the JAX exporter's seed): its
    variables, and its parameters and statistics carried into the port's
    state-dict names."""
    from cm3d_tpu.train import CenterPointConfig as JCenterPointConfig
    from cm3d_tpu.train import PillarConfig as JPillarConfig
    from cm3d_tpu.train.centerpoint import CenterPointDetector as JDetector

    from cm3d_tpu_torch.models.convert import centerpoint_state_dict_from_flax
    from cm3d_tpu_torch.train import CenterPointConfig

    h, w = JPillarConfig().grid_hw
    variables = JDetector(JCenterPointConfig()).init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, JPillarConfig().num_features)), train=True)
    tree = jax.tree.map(np.asarray, variables)
    sd = centerpoint_state_dict_from_flax(tree["params"], tree["batch_stats"],
                                          CenterPointConfig())
    stats = {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    params = {k: v for k, v in sd.items() if k not in stats}
    return variables, params, stats


def _cloud(batch, n, seed=1):
    rng = np.random.default_rng(seed)
    pts = np.zeros((batch, n, 4), np.float32)
    pts[..., :3] = rng.uniform(-40, 40, (batch, n, 3))
    pts[..., 3] = rng.uniform(0, 1, (batch, n))
    return pts, np.ones((batch, n), bool)


def assert_detections_close(got, want):
    """The same kept boxes of the same classes within BOX_TOL."""
    boxes, scores, classes, keep = (np.asarray(x) for x in got)
    jboxes, jscores, jclasses, jkeep = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(keep, jkeep)
    k = keep
    np.testing.assert_array_equal(classes[k], jclasses[k])
    np.testing.assert_allclose(boxes[k][:, :3], jboxes[k][:, :3], atol=BOX_TOL["translation"])
    np.testing.assert_allclose(boxes[k][:, 3:6], jboxes[k][:, 3:6], rtol=BOX_TOL["size"])
    np.testing.assert_allclose(boxes[k][:, 6], jboxes[k][:, 6], atol=BOX_TOL["yaw"])
    np.testing.assert_allclose(scores[k], jscores[k], atol=BOX_TOL["score"])


def test_detect_artifact_roundtrip(tmp_path, jax_detector):
    """The detect artifact on JAX's PRNGKey(0) parameters: bit-equal to the
    port's make_detect_fn on the same weights, and within BOX_TOL of the
    JAX package's artifact on the same cloud."""
    from cm3d_tpu.deploy import export_detect_step as jexport
    from cm3d_tpu.deploy import load_artifact as jload
    from cm3d_tpu.deploy import save_artifact as jsave

    from cm3d_tpu_torch.train import PillarConfig

    variables, params, stats = jax_detector
    max_points, top_k = 512, 16
    path = deploy.save_artifact(
        deploy.export_detect_step(batch_size=1, max_points=max_points, top_k=top_k,
                                  score_thresh=0.0, device="cpu"), tmp_path / "detect_b1.pt2")
    loaded = deploy.load_artifact(path)

    model = deploy.detect_model()
    model.load_state_dict({**params, **stats})
    _, _, radii = class_arrays()
    detect = make_detect_fn(model, PillarConfig(), radii[: model.cfg.num_classes],
                            top_k=top_k, score_thresh=0.0)
    pts, valid = _cloud(1, max_points)
    got = loaded.call(params, stats, torch.from_numpy(pts), torch.from_numpy(valid))
    want = detect(torch.from_numpy(pts), torch.from_numpy(valid))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3].sum()) > 0

    jloaded = jload(jsave(jexport(batch_size=1, max_points=max_points, top_k=top_k,
                                  score_thresh=0.0), tmp_path / "detect_b1.stablehlo"))
    jgot = jloaded.call(variables["params"], variables["batch_stats"], jnp.asarray(pts),
                        jnp.asarray(valid))
    assert_detections_close(got, jgot)


@pytest.mark.parametrize("backbone", ["conv", "swin_t"])
def test_fusion_detect_artifact_roundtrip(tmp_path, backbone):
    """BEVFusion-lite (conv camera, Swin-T camera) at a small configuration:
    the loaded artifact equals make_detect_fn(fusion=True) on the same
    seeded weights and inputs."""
    from test_torch_bevfusion import CONV, PILLAR, SWIN

    from cm3d_tpu_torch.train.bevfusion import BevFusionDetector

    cfg, hw = {"conv": (CONV, (24, 32)), "swin_t": (SWIN, (48, 64))}[backbone]
    torch.manual_seed(0)
    model = BevFusionDetector(cfg, PILLAR)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # BatchNorm statistics away from their init
        for name, b in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    batch, max_points = 2, 256
    path = deploy.save_artifact(
        deploy.export_detect_step(batch_size=batch, top_k=8, score_thresh=0.0,
                                  max_points=max_points, use_camera=True, image_hw=hw,
                                  device="cpu", model=model, pillar_cfg=PILLAR),
        tmp_path / f"fusion_{backbone}.pt2")
    loaded = deploy.load_artifact(path)
    _, _, radii = class_arrays()
    detect = make_detect_fn(model, PILLAR, radii[: cfg.centerpoint.num_classes], top_k=8,
                            score_thresh=0.0, fusion=True)
    rng = np.random.default_rng(2)
    pts = np.zeros((batch, max_points, 4), np.float32)
    pts[..., :3] = rng.uniform(-7, 7, (batch, max_points, 3))
    valid = rng.random((batch, max_points)) < 0.9
    images = rng.uniform(0, 255, (batch, 6) + hw + (3,)).astype(np.float32)
    intr = np.tile(np.array([[20.0, 0, hw[1] / 2], [0, 20.0, hw[0] / 2], [0, 0, 1]],
                            np.float32), (batch, 6, 1, 1))
    c2e = np.tile(np.eye(4, dtype=np.float32), (batch, 6, 1, 1))
    inputs = [torch.from_numpy(x) for x in (pts, valid, images, intr, c2e)]
    params, stats = model_tensors(model)
    got = loaded.call({k: v.detach() for k, v in params.items()}, stats, *inputs)
    want = detect(*inputs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_artifact_holds_no_example_inputs_and_no_parameters(tmp_path):
    """The saved program carries neither a batch nor the model's weights:
    its state dict is empty and its only constant is the NMS radius table;
    the file is smaller than the parameters it takes."""
    program = deploy.export_detect_step(batch_size=1, max_points=256, top_k=8, device="cpu")
    path = deploy.save_artifact(program, tmp_path / "d.pt2")
    loaded = deploy.load_artifact(path).program
    assert loaded.example_inputs is None
    assert dict(loaded.state_dict) == {}
    assert [tuple(c.shape) for c in loaded.constants.values()] == [(10,)]
    params, stats = model_tensors(deploy.detect_model())
    n_bytes = sum(v.numel() * v.element_size() for v in [*params.values(), *stats.values()])
    assert path.stat().st_size < n_bytes


def test_export_cli(tmp_path, capsys):
    """The detect and lift CLIs print JAX's `wrote ... platforms=[...]
    in_avals=N` line; the lift one at full nuScenes geometry is traced on
    fake tensors (nothing computed) and takes the 17 Keyframe leaves."""
    out = tmp_path / "artifact.pt2"
    deploy.main(["--what", "detect", "--batch", "1", "--max_points", "256",
                 "--top_k", "8", "--platform", "cpu", "--out", str(out)])
    line = capsys.readouterr().out
    assert line.startswith(f"wrote {out} (") and "platforms=['cpu']" in line
    loaded = deploy.load_artifact(out)
    assert len(loaded.in_avals) >= 4 and line.strip().endswith(f"in_avals={len(loaded.in_avals)}")

    deploy.main(["--what", "lift", "--batch", "1", "--dataset", "kitti", "--platform", "cpu",
                 "--out", str(tmp_path / "lift.pt2")])
    assert capsys.readouterr().out.strip().endswith("platforms=['cpu'] in_avals=17")


def test_export_cli_rejects_inapplicable_flags(tmp_path, capsys):
    """Flags the selected artifact would silently ignore fail loud, and so
    does a platform the port cannot trace for: a TPU, or more than one
    device type in one program."""
    out = str(tmp_path / "a.pt2")
    for argv in (["--what", "lift", "--use_camera"],
                 ["--what", "lift", "--max_points", "1024"],
                 ["--what", "detect", "--dataset", "kitti"],
                 ["--platform", "tpu"],
                 ["--platform", "cpu,cuda"]):
        with pytest.raises(SystemExit) as e:
            deploy.main(argv + ["--out", out])
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "--platform tpu" in err and "one device type" in err
    assert not (tmp_path / "a.pt2").exists()


def test_default_platform_is_cuda():
    """No --platform means the card (resolve_device): without one it
    raises instead of tracing for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default traces for it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy.export_lift_step(SMALL, batch_size=1)


def test_saved_artifact_loads_in_a_fresh_process(tmp_path, lift_artifacts):
    """A serving host imports only the port: a new interpreter loads the
    saved lift program (the NamedTuples and the kernels' ops register on
    load_artifact) and runs it on a zero batch."""
    import subprocess
    import sys

    _, _, path = lift_artifacts
    code = (
        "import torch, torch.utils._pytree as pt\n"
        "from cm3d_tpu_torch.deploy import load_artifact\n"
        f"a = load_artifact({str(path)!r})\n"
        "args, _ = pt.tree_unflatten(a.in_avals, a.in_tree)\n"
        "zeros = pt.tree_map(lambda v: torch.zeros(v.shape, dtype=v.dtype), args[0])\n"
        "lift, boxes = a.call(zeros)\n"
        "print(type(lift).__name__, type(boxes).__name__, int(boxes.keep.sum()))\n"
        "import sys; assert 'jax' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parents[1]),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["LiftOutputs", "BoxOutputs", "0"]

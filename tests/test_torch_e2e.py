"""The port's fused images -> boxes path (cm3d_tpu_torch.pipelines.e2e)
against the JAX package's on the CPU, on the fabricated nuScenes dataroot of
tests/nusc_fixture.py.

The JAX `init` weights of DETIC_TEST / SAM_TEST are carried into the port by
`models/convert.py`, so both packages run the same models on the same
images. Tolerances: box centres, sizes and rotations within 1e-4 (f32
summation order; the lift CLI test's), scores within 1e-5.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cm3d_tpu.config import LiftStageConfig as JaxLiftStageConfig
from cm3d_tpu.config import MaskStageConfig as JaxMaskStageConfig
from cm3d_tpu.models.detic import DETIC_TEST as JAX_DETIC_TEST
from cm3d_tpu.models.detic import Detic as JaxDetic
from cm3d_tpu.models.sam import SAM_TEST as JAX_SAM_TEST
from cm3d_tpu.models.sam import Sam as JaxSam
from cm3d_tpu.pipelines.e2e import _scale_ratio_for_thumbnail as jax_scale_ratio
from cm3d_tpu.pipelines.e2e import run_e2e as jax_run_e2e
from cm3d_tpu.pipelines.masks import _batched_model_fns as jax_model_fns

from cm3d_tpu_torch import vocab
from cm3d_tpu_torch.config import LiftStageConfig, MaskStageConfig
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
from cm3d_tpu_torch.datasets.nuscenes import NuScenesFrontend, SubmissionWriter
from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes, to_device
from cm3d_tpu_torch.models.convert import detic_state_dict_from_flax, sam_state_dict_from_flax
from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
from cm3d_tpu_torch.models.sam import SAM_TEST, Sam
from cm3d_tpu_torch.parallel import make_keyframe_step_fn
from cm3d_tpu_torch.pipelines import e2e, masks
from cm3d_tpu_torch.utils.fetch import device_fetch
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

VOCAB = vocab.CUSTOM_VOCABULARY_NUSCENES
# the fixture's camera jpgs are 160x90 (nominal 1600x900 -> ratio 0.1)
SMALL = dict(max_points=16384, max_masks=32, max_points_per_mask=512,
             max_points_per_camera=8192, max_points_in_masks=2048,
             max_lane_points=1024, image_ratio=0.1)
MASK = dict(max_detections=16, max_masks_total=32, dtype="float32")
WH = (160, 90)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The dataroot, and the same random models in both packages."""
    from nusc_fixture import VERSION, make_fake_nuscenes

    tmp = tmp_path_factory.mktemp("torch_e2e")
    root = tmp / "data"
    info = make_fake_nuscenes(root, tmp / "planted", n_frames=2, n_objects=6)
    rng = np.random.default_rng(0)
    clf = rng.standard_normal((JAX_DETIC_TEST.embed_dim, len(VOCAB))).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    jax_detic, jax_sam = JaxDetic(JAX_DETIC_TEST), JaxSam(JAX_SAM_TEST)
    dp = jax.tree.map(np.asarray, jax.jit(jax_detic.init)(
        jax.random.PRNGKey(0), jnp.zeros((64, 64, 3)), clf)["params"])
    sp = jax.tree.map(np.asarray, jax.jit(jax_sam.init)(
        jax.random.PRNGKey(1), jnp.zeros((64, 64, 3)), jnp.zeros((1, 4)))["params"])
    # flax initialises the rel-pos tables to zero: give the bias something to do
    for i in range(JAX_SAM_TEST.encoder_depth):
        attn = sp["image_encoder"][f"block{i}"]["attn"]
        for k in ("rel_pos_h", "rel_pos_w"):
            attn[k] = 0.3 * rng.standard_normal(attn[k].shape).astype(np.float32)

    def port_models(fused=False):
        detic = Detic(DETIC_TEST)
        sam = Sam(dataclasses.replace(SAM_TEST, fused_window_attn=fused))
        detic.load_state_dict(detic_state_dict_from_flax(dp, DETIC_TEST))
        sam.load_state_dict(sam_state_dict_from_flax(sp, SAM_TEST))
        return masks._batched_model_fns(detic, clf, sam, VOCAB, device="cpu")

    return dict(root=root, version=VERSION, scene=info["scene_name"], tmp=tmp,
                jax_models=jax_model_fns(jax_detic, dp, clf, jax_sam, sp, VOCAB),
                port_models=port_models)


def _run_port(world, models, name, **kw):
    return e2e.run_e2e(str(world["root"]), world["version"], [world["scene"]],
                       str(world["tmp"] / name), models, lift_cfg=LiftStageConfig(**SMALL),
                       mask_cfg=MaskStageConfig(**MASK), batch_size=2, mask_wh=WH,
                       device="cpu", **kw)


@pytest.fixture(scope="module")
def port_submission(world):
    return _run_port(world, world["port_models"](), "port.json", verbose=False)


def _assert_same_submission(got, want, atol=1e-4, score_atol=1e-5):
    assert set(got["results"]) == set(want["results"])
    n_boxes = 0
    for tok, want_boxes in want["results"].items():
        got_boxes = got["results"][tok]
        assert len(got_boxes) == len(want_boxes), tok
        for g, w in zip(got_boxes, want_boxes):
            assert g["detection_name"] == w["detection_name"]
            assert g["attribute_name"] == w["attribute_name"]
            for key in ("translation", "size", "rotation"):
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=atol, err_msg=key)
            np.testing.assert_allclose(g["detection_score"], w["detection_score"],
                                       rtol=0, atol=score_atol)
        n_boxes += len(want_boxes)
    assert n_boxes > 0  # the fixture must actually produce boxes


def test_run_e2e_matches_jax(world, port_submission):
    want = jax_run_e2e(str(world["root"]), world["version"], [world["scene"]],
                       str(world["tmp"] / "jax.json"), world["jax_models"],
                       lift_cfg=JaxLiftStageConfig(**SMALL),
                       mask_cfg=JaxMaskStageConfig(**MASK), batch_size=2, verbose=False,
                       mask_wh=WH)
    _assert_same_submission(port_submission, want)
    with open(world["tmp"] / "port.json") as f:
        assert json.load(f) == port_submission


@pytest.fixture(scope="module")
def two_stage(world):
    """The mask stage's own artifacts for the scene: (directory, samples)."""
    from PIL import Image

    from cm3d_tpu_torch.datasets.nuscenes.tables import CAM_LIST, NuScenesTables

    root, scene = world["root"], world["scene"]
    nusc = NuScenesTables(root, world["version"])
    samples = list(nusc.iter_samples(nusc.scene_by_name(scene)))

    def provider(s, frame):
        return [np.asarray(Image.open(root / nusc.get(
            "sample_data", samples[frame]["data"][cam])["filename"]).convert("RGB"))
            for cam in CAM_LIST]

    mask_dir = world["tmp"] / "two_stage_masks"
    masks.run_mask_stage(world["port_models"](), provider, [scene], lambda s: len(samples),
                         str(mask_dir), MaskStageConfig(**MASK), verbose=False)
    return mask_dir, samples


def test_fused_e2e_matches_two_stage(world, port_submission, two_stage):
    """Mask artifacts -> RLE store -> frontend -> lift gives the fused
    path's submission: handing the planes over on the device loses nothing."""
    mask_dir, samples = two_stage
    root, scene = world["root"], world["scene"]
    lift_cfg = LiftStageConfig(**SMALL)
    fe = NuScenesFrontend(root, world["version"], MaskArtifactStore(mask_dir), lift_cfg,
                          mask_wh=WH)
    lanes = fe._map_for_scene(fe.nusc.scene_by_name(scene)).all_lane_points(0.5)
    kfs = [fe.build_keyframe(scene, f, s, lanes) for f, s in enumerate(samples)]
    _, boxes = make_keyframe_step_fn(lift_cfg, device="cpu")(
        to_device(stack_keyframes([kf for kf, _ in kfs]).frames, "cpu"))
    boxes = device_fetch(boxes)
    writer = SubmissionWriter()
    for i, (_, meta) in enumerate(kfs):
        writer.add_device_outputs(meta.sample_token, map_fields(lambda x: x[i], boxes))
    two = writer.write(str(world["tmp"] / "two.json"))
    _assert_same_submission(port_submission, two, atol=1e-5, score_atol=1e-6)


def test_fused_window_attn_gives_the_same_boxes(world, port_submission, capsys):
    """SAM's windowed block through the fused kernels' plain version: the
    same keep sets and names; centres within 1e-4, scores within 1e-5 (the
    two encoders differ by f32 rounding, 3e-4 at most on the embeddings)."""
    got = _run_port(world, world["port_models"](fused=True), "fused.json", verbose=True)
    _assert_same_submission(got, port_submission)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{"mask_counters"')]
    assert lines, "the fused path must print its mask counters"
    mc = json.loads(lines[-1])["mask_counters"]
    assert mc["frames"] == 2 and mc["masks_written"] > 0


def test_planes_reach_the_step_as_the_decodes_tensor(world):
    """The handle's planes go into the keyframe batch as the tensor the
    decode returned: no copy to the host is started for them."""
    models = world["port_models"]()
    decoded, stepped, host_copies = [], [], []
    raw_decode = models.sam_decode_planes

    def decode(*a, **kw):
        decoded.append(raw_decode(*a, **kw))
        return decoded[-1]

    real_step = make_keyframe_step_fn(LiftStageConfig(**SMALL), device="cpu")

    def step(batch):
        stepped.append(batch.mask_bits)
        return real_step(batch)

    def frames():
        rng = np.random.default_rng(1)
        from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe

        syn = SyntheticConfig(image_w=WH[0], image_h=WH[1], points_per_frame=4096,
                              objects_per_frame=8, focal=80.0)
        base = make_keyframe(syn, LiftStageConfig(**SMALL), rng)
        for i in range(3):
            images = [(rng.random((WH[1], WH[0], 3)) * 255).astype(np.uint8) for _ in range(6)]

            def assemble(handle, i=i):
                host_copies.append(handle["planes_host"])
                if handle["planes"] is None:
                    return None
                return base._replace(mask_bits=handle["planes"]), i

            yield images, assemble

    seen = []
    n = e2e.run_fused(dataclasses.replace(models, sam_decode_planes=decode), step, frames(),
                      MaskStageConfig(**MASK), lambda tok, b: seen.append((tok, b.keep.shape)),
                      batch_size=2, mask_wh=WH, device="cpu")
    assert n == len(decoded) == 3 and host_copies == [None] * 3
    # batches of 2: the tail batch repeats its last keyframe, delivered once
    assert [tok for tok, _ in seen] == [0, 1, 2]
    assert all(shape == (SMALL["max_masks"],) for _, shape in seen)
    assert len(stepped) == 2 and all(isinstance(b, torch.Tensor) for b in stepped)
    assert torch.equal(stepped[0], torch.stack(decoded[:2]))
    assert torch.equal(stepped[1], torch.stack([decoded[2], decoded[2]]))


def _no_detections(frame):
    c, d = 6, MASK["max_detections"]
    return (torch.zeros((c, d, 4)), torch.zeros((c, d)),
            torch.zeros((c, d), dtype=torch.int64), torch.zeros((c, d), dtype=torch.bool))


def test_empty_frames_write_artifacts_and_manifest(world):
    """A zero-detection frame still writes (empty) reference-layout
    artifacts, and the scene is marked complete by the in-order write."""
    models = dataclasses.replace(world["port_models"](), detic=_no_detections)
    mask_dir = world["tmp"] / "empty_masks"
    sub = _run_port(world, models, "empty.json", verbose=False, mask_dir=str(mask_dir))
    assert sub["results"] == {}  # nothing lifted
    store = MaskArtifactStore(mask_dir)
    for f in range(2):  # but every frame has (empty) artifacts
        fm = store.read_frame(world["scene"], f)
        assert fm is not None and len(fm.labels) == 0
    assert store.completed_scenes() == {world["scene"]}


def test_mask_dir_artifacts_equal_the_mask_stages(world, port_submission, two_stage):
    """--mask_dir: the fused run's artifacts are the mask stage's own (the
    planes' copy to the host starts only for this write)."""
    mask_dir = world["tmp"] / "fused_masks"
    sub = _run_port(world, world["port_models"](), "with_masks.json", verbose=False,
                    mask_dir=str(mask_dir))
    assert sub == port_submission
    got, want = MaskArtifactStore(mask_dir), MaskArtifactStore(two_stage[0])
    assert got.completed_scenes() == want.completed_scenes() == {world["scene"]}
    for f in range(2):
        a, b = got.read_frame(world["scene"], f), want.read_frame(world["scene"], f)
        assert a.labels == b.labels and a.cam_nums == b.cam_nums
        assert np.array_equal(a.masks, b.masks)


def test_capacity_mismatch_raises(world):
    with pytest.raises(ValueError, match="bit-plane capacity"):
        e2e.run_e2e(str(world["root"]), world["version"], [world["scene"]],
                    str(world["tmp"] / "x.json"), None, lift_cfg=LiftStageConfig(**SMALL),
                    mask_cfg=MaskStageConfig(max_masks_total=64), device="cpu")


def test_scale_ratio_for_thumbnail():
    cfg = LiftStageConfig(image_ratio=0.64)
    assert e2e._scale_ratio_for_thumbnail(cfg, 1024) is cfg
    for thumb in (512, 160, 2048):
        scaled = e2e._scale_ratio_for_thumbnail(cfg, thumb)
        assert scaled.image_ratio == pytest.approx(
            jax_scale_ratio(JaxLiftStageConfig(image_ratio=0.64), thumb).image_ratio)
        assert scaled.max_masks == cfg.max_masks  # everything else untouched


def test_merge_submissions(tmp_path):
    a = {"meta": {"use_camera": True}, "results": {"t0": [{"n": 1}], "t1": [{"n": 2}]}}
    b = {"meta": {"use_camera": False}, "results": {"t1": [{"n": 3}], "t2": []}}
    for name, sub in (("a", a), ("b", b)):
        (tmp_path / f"{name}.json").write_text(json.dumps(sub))
    merged = e2e.merge_submissions([str(tmp_path / "a.json"), str(tmp_path / "b.json")],
                                   str(tmp_path / "m.json"))
    assert merged == {"meta": {"use_camera": True},
                      "results": {"t0": [{"n": 1}], "t1": [{"n": 2}, {"n": 3}], "t2": []}}
    assert json.loads((tmp_path / "m.json").read_text()) == merged


def test_cli_runs_on_the_fixture_and_names_what_is_not_ported(world, monkeypatch, capsys,
                                                              one_torch_thread):
    real = e2e.run_e2e

    def small_run_e2e(*a, **kw):  # the CLI's production caps, cut to the fixture's size
        kw.update(lift_cfg=LiftStageConfig(**SMALL), batch_size=2,
                  mask_cfg=dataclasses.replace(kw["mask_cfg"], **MASK))
        return real(*a, **kw)

    monkeypatch.setattr(e2e, "run_e2e", small_run_e2e)
    out = world["tmp"] / "cli.json"
    argv = ["--dataroot", str(world["root"]), "--version", world["version"], "--scenes",
            world["scene"], "--out", str(out), "--fake_weights", "--thumbnail", "160",
            "--device", "cpu", "--mask_dir", str(world["tmp"] / "cli_masks")]
    e2e.main(argv)
    assert "e2e: " in capsys.readouterr().out
    sub = json.loads(out.read_text())
    assert set(sub) == {"meta", "results"}
    assert MaskArtifactStore(world["tmp"] / "cli_masks").completed_scenes() == {world["scene"]}
    # --host_shard is ported (A14a): tests/test_torch_multihost.py drives
    # it; --quant_int8 / --quant_static (A12) run the int8 models
    out.unlink()
    e2e.main(argv + ["--quant_int8", "--quant_static"])
    assert set(json.loads(out.read_text())) == {"meta", "results"}
    # --detector gdino is ported (A13c): the tiny GroundingDINO replaces
    # Detic, in f32 and with --gdino_bf16
    for extra in (["--detector", "gdino"], ["--detector", "gdino", "--gdino_bf16"]):
        out.unlink()
        e2e.main(argv + extra)
        assert set(json.loads(out.read_text())) == {"meta", "results"}
    # --camera_mesh is ported (A14e): the 2D stage over two gloo ranks, the
    # lift on rank 0, the submission of the run without the flag
    out.unlink()
    e2e.main(argv + ["--camera_mesh", "2"])
    assert json.loads(out.read_text())["results"] == sub["results"]
    # the checkpoint flags are ported (A6): without --fake_weights all four
    # paths are needed, else argparse's error
    for extra in ([], ["--sam_ckpt", "x.pth", "--sam_size", "vit_b"]):
        with pytest.raises(SystemExit):
            e2e.main([a for a in argv if a != "--fake_weights"] + extra)


def test_bench_e2e_protocol_at_a_tiny_geometry(monkeypatch, one_torch_thread):
    """bench_e2e on the CPU with the tiny models: a warm-up run of one
    batch, then n_frames timed keyframes, all through run_fused; with
    fused_window_attn the fused blocks' plain version runs."""
    import cm3d_tpu_torch.benchmarks as bench
    import cm3d_tpu_torch.config as config

    monkeypatch.setattr(bench, "IMG_H", 48)
    monkeypatch.setattr(bench, "IMG_W", 64)
    small = LiftStageConfig(max_points=8192, max_points_per_mask=256, max_points_per_camera=4096,
                            max_points_in_masks=1024, max_lane_points=512)
    monkeypatch.setattr(config, "LiftStageConfig", lambda: small)
    calls = []
    real = e2e.run_fused
    monkeypatch.setattr(e2e, "run_fused", lambda *a, **kw: calls.append(a[4:6]) or real(*a, **kw))
    models = bench._realistic_load(masks.build_fake_models(device="cpu", fused_window_attn=True))
    out = bench.bench_e2e("float32", n_frames=3, batch_size=2, models=models, device="cpu")
    assert out["metric"] == "e2e_keyframes_per_sec_per_chip" and out["unit"] == "keyframes/sec"
    assert "vs_baseline" not in out  # the JAX package's 50 is a TPU target
    assert out["n_frames"] == 3 and out["batch_size"] == 2
    assert np.isfinite(out["value"]) and out["value"] == pytest.approx(
        1000.0 / out["ms_per_keyframe"])
    assert out["boxes_kept"] > 0
    assert len(calls) == 2 and all(c[1] == 2 for c in calls)  # warm-up, then the timed run

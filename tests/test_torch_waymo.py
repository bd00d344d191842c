"""The port's Waymo path (range image -> frontend -> lift -> Objects .bin,
the Waymo mask provider and the fused path) against the JAX package on the
CPU, on the fabricated frame-lite scenes of tests/waymo_fixture.py.

Tolerances:
- points from the range image within 2e-3 m absolute of JAX's (both f32;
  the rolling-shutter path goes through the global frame, 1e2-1e4 m, where
  one f32 ulp is 1e-5-1e-3 m and the two packages round in different
  orders); every other keyframe field equal;
- the lift step on the SAME numpy keyframe (the JAX frontend's) equal to
  JAX's where JAX is exact (counts, flags, medoid centroids, keep sets,
  labels, sizes), trig outputs as tests/test_torch_lift.py;
- the Objects .bin of the port's lift CLI and JAX's run_lift_waymo: same
  count, classes, timestamps and scores; box centres within 1e-3 m, sizes
  equal, headings within 1e-5.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_waymo_frame_proto as jax_frame_proto_tests
import test_waymo_io as jax_io_tests
from cm3d_tpu.config import LiftStageConfig as JaxLiftStageConfig
from cm3d_tpu.config import WAYMO_LIFT as JAX_WAYMO_LIFT
from cm3d_tpu.datasets.artifacts import MaskArtifactStore as JaxStore
from cm3d_tpu.datasets.types import stack_keyframes as jax_stack_keyframes
from cm3d_tpu.datasets.waymo import frame_proto as jax_frame_proto
from cm3d_tpu.datasets.waymo.frontend import WaymoFrontend as JaxWaymoFrontend
from cm3d_tpu.ops import range_image as jax_ri
from cm3d_tpu.parallel import make_keyframe_step_fn as jax_step_fn
from cm3d_tpu.pipelines.lift_waymo import run_lift_waymo as jax_run_lift_waymo
from test_torch_lift import _assert_step_matches
from waymo_fixture import make_fake_waymo

from cm3d_tpu_torch import config as port_config
from cm3d_tpu_torch.config import MaskStageConfig
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
from cm3d_tpu_torch.datasets.types import keyframe_from_numpy
from cm3d_tpu_torch.datasets.waymo import frame_proto, proto, tfrecord
from cm3d_tpu_torch.datasets.waymo.frontend import WaymoFrontend, create_gt_bin
from cm3d_tpu_torch.ops import range_image
from cm3d_tpu_torch.parallel import make_keyframe_step_fn
from cm3d_tpu_torch.pipelines import e2e, lift_waymo, masks
from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES, CUSTOM_VOCABULARY_WAYMO

POINTS_ATOL = 2e-3
SMALL = dict(num_sweeps=1, image_ratio=1024.0 / 1920.0, sqrt_min_dist_load_filter=False,
             max_points=32768, max_masks=32, max_points_per_mask=1024,
             max_points_per_camera=16384, max_points_in_masks=8192, max_lane_points=1024)


@pytest.fixture(scope="module")
def fake_waymo(tmp_path_factory):
    frames = tmp_path_factory.mktemp("wframes")
    mask_dir = tmp_path_factory.mktemp("wmasks")
    info = make_fake_waymo(frames, mask_dir, n_frames=2, n_objects=8)
    return frames, mask_dir, info


# --- range image ------------------------------------------------------------

def _ri_inputs(seed, h=16, w=96):
    rng = np.random.default_rng(seed)
    ri = rng.uniform(2, 75, (h, w)).astype(np.float32)
    ri[rng.random((h, w)) < 0.2] = 0.0
    ri[0, :3] = -1.0  # no-return flag
    incl = np.linspace(0.04, -0.3, h).astype(np.float32)
    yaw = 0.4
    ext = np.eye(4, dtype=np.float32)
    ext[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    ext[:3, 3] = [1.4, -0.5, 2.0]
    # rolling shutter: a global pose around (3000, -1200) m, drifting by
    # column, as a highway-speed sweep does
    pose6 = np.zeros((h, w, 6), np.float32)
    pose6[..., 2] = 0.7 + 0.001 * np.arange(w)[None]
    pose6[..., 3] = 3000.0 + 0.01 * np.arange(w)[None]
    pose6[..., 4] = -1200.0
    pose6[..., 5] = 30.0
    frame_pose = np.eye(4)
    frame_pose[:2, :2] = [[np.cos(0.75), -np.sin(0.75)], [np.sin(0.75), np.cos(0.75)]]
    frame_pose[:3, 3] = [3000.5, -1200.0, 30.0]
    return ri, incl, ext, pose6, np.linalg.inv(frame_pose).astype(np.float32)


@pytest.mark.parametrize("with_pose", [False, True])
def test_range_image_to_points_matches_jax(with_pose):
    ri, incl, ext, pose6, inv = _ri_inputs(3)
    jkw, tkw = {}, {}
    if with_pose:
        jkw = dict(pixel_pose=jax_ri.pixel_pose_matrices(jnp.asarray(pose6)),
                   frame_pose_inv=jnp.asarray(inv))
        tkw = dict(pixel_pose=range_image.pixel_pose_matrices(torch.from_numpy(pose6)),
                   frame_pose_inv=torch.from_numpy(inv))
        np.testing.assert_allclose(tkw["pixel_pose"].numpy(), np.asarray(jkw["pixel_pose"]),
                                   rtol=0, atol=1e-6)
    want_p, want_v = jax_ri.range_image_to_points(jnp.asarray(ri), jnp.asarray(incl),
                                                  jnp.asarray(ext), **jkw)
    got_p, got_v = range_image.range_image_to_points(torch.from_numpy(ri),
                                                     torch.from_numpy(incl),
                                                     torch.from_numpy(ext), **tkw)
    assert got_p.dtype == torch.float32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.sum() < ri.size and not got_v.reshape(ri.shape)[0, :3].any()
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=POINTS_ATOL)
    with pytest.raises(ValueError, match="frame_pose_inv"):
        range_image.range_image_to_points(
            torch.from_numpy(ri), torch.from_numpy(incl), torch.from_numpy(ext),
            pixel_pose=range_image.pixel_pose_matrices(torch.from_numpy(pose6)))


def test_range_image_round_trip_and_helpers_match_jax():
    h, w = 32, 256
    got_incl = range_image.uniform_inclinations(h, -0.3, 0.1)
    want_incl = np.asarray(jax_ri.uniform_inclinations(h, -0.3, 0.1))
    np.testing.assert_allclose(got_incl.numpy(), want_incl, rtol=0, atol=1e-7)
    _, _, ext, _, _ = _ri_inputs(0)
    np.testing.assert_allclose(range_image.azimuth_grid(w, torch.from_numpy(ext)).numpy(),
                               np.asarray(jax_ri.azimuth_grid(w, jnp.asarray(ext))),
                               rtol=0, atol=1e-6)
    ri = (np.random.default_rng(41).random((h, w)) * 50 + 5).astype(np.float32)
    pts, valid = range_image.range_image_to_points(torch.from_numpy(ri), got_incl,
                                                   torch.from_numpy(ext))
    assert valid.all()
    back = range_image.points_to_range_image(pts, got_incl, torch.from_numpy(ext), h, w)
    np.testing.assert_allclose(back.numpy(), ri, rtol=1e-3, atol=1e-2)
    want = jax_ri.points_to_range_image(jnp.asarray(pts.numpy()), jnp.asarray(want_incl),
                                        jnp.asarray(ext), h, w)
    np.testing.assert_allclose(back.numpy(), np.asarray(want), rtol=0, atol=1e-4)


# --- frame-lite / tfrecord / proto: the JAX tests run on the port's modules -

IO_TESTS = ("test_crc32c_known_vectors", "test_tfrecord_roundtrip",
            "test_tfrecord_crc_detects_corruption", "test_proto_objects_roundtrip",
            "test_proto_skips_unknown_fields")
FRAME_TESTS = ("test_frame_wire_roundtrip",
               "test_parse_frame_accepts_uncompressed_and_missing_inclinations",
               "test_pose_image_contracts")


@pytest.mark.parametrize("name", IO_TESTS + FRAME_TESTS)
def test_port_passes_the_jax_waymo_io_tests(name, monkeypatch, tmp_path):
    """tests/test_waymo_io.py and tests/test_waymo_frame_proto.py with the
    port's tfrecord / proto / frame_proto modules in place of the JAX
    package's (the same assertions, the port's code)."""
    for attr in ("TFRecordReader", "TFRecordWriter", "crc32c", "masked_crc"):
        monkeypatch.setattr(jax_io_tests, attr, getattr(tfrecord, attr))
    for attr in ("WaymoBox", "WaymoObject", "decode_objects", "encode_objects",
                 "LABEL_TYPE_VEHICLE", "LABEL_TYPE_PEDESTRIAN"):
        monkeypatch.setattr(jax_io_tests, attr, getattr(proto, attr))
    monkeypatch.setattr(jax_frame_proto_tests, "frame_proto", frame_proto)
    module = jax_io_tests if name in IO_TESTS else jax_frame_proto_tests
    fn = getattr(module, name)
    fn(tmp_path) if fn.__code__.co_argcount else fn()


def test_frame_lite_encoding_matches_jax_bytes():
    fr = jax_frame_proto_tests._fake_frame_lite(seed=4)
    fr["range_image_pose"] = np.random.default_rng(4).normal(
        0, 1, fr["range_image"].shape + (6,)).astype(np.float32)
    buf = frame_proto.encode_frame_lite(fr)
    assert buf == jax_frame_proto.encode_frame_lite(fr)
    a, b = frame_proto.parse_frame(buf), jax_frame_proto.parse_frame(buf)
    for k in ("range_image", "range_image_pose", "inclinations", "pose", "labels_box"):
        np.testing.assert_array_equal(a[k], b[k])


# --- frontend, lift step, lift CLI ------------------------------------------

def _frontends(fake_waymo, **cfg):
    """Both frontends on the fixture, at the JAX frontend's mask canvas
    (1024 x 664, the fixture's; the port's default is 1024 x 683)."""
    frames, mask_dir, info = fake_waymo
    jax_fe = JaxWaymoFrontend(frames, JaxStore(mask_dir), JaxLiftStageConfig(**cfg))
    port_fe = WaymoFrontend(frames, MaskArtifactStore(mask_dir),
                            port_config.LiftStageConfig(**cfg), device="cpu",
                            mask_wh=jax_fe.mask_wh)
    return jax_fe, port_fe, info["scene"]


def test_frontend_keyframes_match_jax(fake_waymo):
    jax_fe, port_fe, scene = _frontends(fake_waymo, **SMALL)
    want = list(jax_fe.iter_scene(scene))
    got = list(port_fe.iter_scene(scene))
    assert len(got) == len(want) == 2
    for (kf, meta), (jkf, jmeta) in zip(got, want):
        assert dataclasses.astuple(meta)[:4] == dataclasses.astuple(jmeta)[:4]
        assert kf.point_valid.sum() > 2000 and kf.mask_valid.sum() >= 6
        for f in kf._fields:
            a, b = getattr(kf, f), getattr(jkf, f)
            if f == "cameras":
                for g in a._fields:
                    np.testing.assert_array_equal(getattr(a, g), getattr(b, g), err_msg=g)
            elif f == "points":
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_allclose(a, b, rtol=0, atol=POINTS_ATOL)
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_waymo_intrinsics_ignore_the_thumbnail_ratio_as_in_jax(fake_waymo, tmp_path):
    """A fault of the reference, kept on purpose (ROADMAP C): the Waymo
    frontend scales the intrinsics by the constant WAYMO_IMAGE_RATIO
    (1024/1920, reference waymo/2d_to_3d.py:523), not by
    LiftStageConfig.image_ratio, so at --thumbnail 768 the ratio that
    `_scale_ratio_for_thumbnail` rescales never reaches the projection and
    the points land on the 1024-wide canvas while the masks are 768 wide.
    The port and JAX do the same thing. The KITTI frontend does honour the
    ratio (tests/test_kitti.py:280): its intrinsics follow it."""
    from cm3d_tpu.pipelines.e2e import _scale_ratio_for_thumbnail as jax_scale
    from kitti_fixture import make_kitti_root

    from cm3d_tpu_torch.datasets.kitti.frontend import KittiFrontend
    from cm3d_tpu_torch.datasets.waymo.frontend import WAYMO_IMAGE_RATIO

    at_768 = e2e._scale_ratio_for_thumbnail(port_config.LiftStageConfig(**SMALL), 768)
    assert at_768.image_ratio == jax_scale(JaxLiftStageConfig(**SMALL), 768).image_ratio
    assert at_768.image_ratio == pytest.approx(WAYMO_IMAGE_RATIO * 0.75)
    intr = {}
    for thumb, cfg in ((1024, SMALL), (768, dataclasses.asdict(at_768))):
        jax_fe, port_fe, scene = _frontends(fake_waymo, **cfg)
        (kf, _), (jkf, _) = next(port_fe.iter_scene(scene)), next(jax_fe.iter_scene(scene))
        np.testing.assert_array_equal(kf.cameras.intrinsics, jkf.cameras.intrinsics)
        intr[thumb] = kf.cameras.intrinsics
    np.testing.assert_array_equal(intr[768], intr[1024])  # the ratio did not reach them

    root = make_kitti_root(tmp_path / "kitti", tmp_path / "kmasks", n_frames=1, image_wh=())
    kitti = {}
    for thumb in (1024, 768):
        cfg = e2e._scale_ratio_for_thumbnail(port_config.KITTI_LIFT, thumb)
        fe = KittiFrontend(root, MaskArtifactStore(tmp_path / "kmasks"), cfg)
        kitti[thumb] = fe.build_keyframe(0)[0].cameras.intrinsics[0]
    np.testing.assert_allclose(kitti[768][:2], kitti[1024][:2] * 0.75, rtol=1e-6)


def test_lift_step_on_the_jax_frontends_keyframes_is_exact(fake_waymo):
    """B1 / B2's plain versions at Waymo's ring (5 cameras, one return) on
    the same numpy keyframes: counts, medoid centroids, keep sets equal."""
    jax_fe, _, scene = _frontends(fake_waymo, **SMALL)
    batch = jax_stack_keyframes([kf for kf, _ in jax_fe.iter_scene(scene)])
    want = jax.tree.map(np.asarray, jax.jit(jax_step_fn(JaxLiftStageConfig(**SMALL)))(
        batch.frames))
    step = make_keyframe_step_fn(port_config.LiftStageConfig(**SMALL), device="cpu")
    got = step(keyframe_from_numpy(batch, "cpu"))
    assert want[1].keep.sum() >= 8 and batch.frames.cameras.intrinsics.shape[1] == 5
    _assert_step_matches(got, want)


def test_lift_waymo_cli_writes_jaxs_objects(fake_waymo, tmp_path, capsys):
    """`python -m cm3d_tpu_torch.pipelines.lift_waymo` at WAYMO_LIFT's
    production caps (batch 2 for the two frames) against JAX's
    run_lift_waymo on the same frames and artifacts."""
    frames, mask_dir, info = fake_waymo
    lift_waymo.main(["--frames_root", str(frames), "--mask_dir", str(mask_dir),
                     "--out", str(tmp_path / "port.bin"), "--batch_size", "2",
                     "--device", "cpu"])
    assert "wrote" in capsys.readouterr().out
    jax_run_lift_waymo(str(frames), str(mask_dir), [info["scene"]], str(tmp_path / "jax.bin"),
                       lift_cfg=JAX_WAYMO_LIFT, batch_size=2, verbose=False)
    got = proto.decode_objects((tmp_path / "port.bin").read_bytes())
    want = proto.decode_objects((tmp_path / "jax.bin").read_bytes())
    assert len(got) == len(want) >= 8
    for a, b in zip(got, want):
        assert (a.type, a.frame_timestamp_micros, a.context_name, a.score) == \
            (b.type, b.frame_timestamp_micros, b.context_name, b.score)
        np.testing.assert_allclose([a.box.center_x, a.box.center_y, a.box.center_z],
                                   [b.box.center_x, b.box.center_y, b.box.center_z],
                                   rtol=0, atol=1e-3)
        assert (a.box.width, a.box.length, a.box.height) == \
            (b.box.width, b.box.length, b.box.height)
        assert abs(a.box.heading - b.box.heading) < 1e-5
    # --data_parallel reaches its validation (test_torch_data_parallel.py runs it)
    with pytest.raises(SystemExit, match="must divide --batch_size 8"):
        lift_waymo.main(["--frames_root", str(frames), "--mask_dir", str(mask_dir),
                         "--data_parallel", "3", "--device", "cpu"])


def test_raw_segment_and_gt_bin_match_the_npz_path(fake_waymo, tmp_path):
    frames, mask_dir, info = fake_waymo
    scene = info["scene"]
    fe = WaymoFrontend(frames, MaskArtifactStore(mask_dir),
                       port_config.LiftStageConfig(**SMALL), device="cpu")
    raw = tmp_path / "raw"
    raw.mkdir()
    with tfrecord.TFRecordWriter(raw / f"{scene}.tfrecord") as w:
        for path in fe.frame_files(scene):
            w.write(frame_proto.encode_frame_lite(fe.load_frame(path)))
    fe_raw = WaymoFrontend(raw, MaskArtifactStore(mask_dir),
                           port_config.LiftStageConfig(**SMALL), device="cpu")
    for (a, _), (b, _) in zip(fe.iter_scene(scene), fe_raw.iter_scene(scene)):
        for f in ("points", "point_valid", "mask_bits", "lane_points"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert create_gt_bin(frames, str(tmp_path / "a.bin")) == 16
    assert create_gt_bin(raw, str(tmp_path / "b.bin")) == 16
    assert (tmp_path / "a.bin").read_bytes() == (tmp_path / "b.bin").read_bytes()


# --- mask stage and the fused path ------------------------------------------

MASK_CFG = MaskStageConfig(max_detections=16, max_masks_total=32)
SMALL_FUSED = dict(SMALL, max_points=16384, max_points_per_mask=512,
                   max_points_per_camera=8192, max_points_in_masks=2048)


def _fixed_detic(frame):
    """Deterministic detections (the test targets the plane handoff, not
    the random-weight detector): two boxes a camera, car + pedestrian."""
    c, d = frame["dev"].shape[0], MASK_CFG.max_detections
    boxes = torch.zeros((c, d, 4))
    boxes[:, 0] = torch.tensor([380.0, 220, 700, 460])
    boxes[:, 1] = torch.tensor([150.0, 100, 420, 380])
    scores = torch.zeros((c, d))
    scores[:, 0], scores[:, 1] = 0.9, 0.7
    classes = torch.zeros((c, d), dtype=torch.int64)
    classes[:, 0], classes[:, 1] = 3, 4  # car, pedestrian
    valid = torch.zeros((c, d), dtype=torch.bool)
    valid[:, :2] = True
    return boxes, scores, classes, valid


def test_fused_waymo_equals_two_stage(tmp_path):
    """tests/test_e2e_waymo.py:55 on the port: the fused path from a RAW
    segment writes the objects of mask artifacts -> lift on the npz cache,
    with the same models; the ring is Waymo's mixed one at its real sizes
    (1920x1280 front -> 1024x683, 1920x886 side -> 1024x473), so the
    two-stage frontend's default canvas must hold a front camera's masks
    (the JAX frontend's 1024 x 664 refuses them)."""
    from PIL import Image

    frames_root = tmp_path / "frames"
    make_fake_waymo(frames_root, tmp_path / "planted", n_frames=2, n_objects=8,
                    jpg_wh=(1920, 1280))
    scene = "segment-000"
    fe = WaymoFrontend(frames_root, MaskArtifactStore(tmp_path / "none"), device="cpu")
    raw_root = tmp_path / "raw"
    raw_root.mkdir()
    with tfrecord.TFRecordWriter(raw_root / f"{scene}.tfrecord") as w:
        for i, path in enumerate(fe.frame_files(scene)):
            fr = fe.load_frame(path)
            for ci in (3, 4):  # side cameras: 1920 x 886
                im = Image.open(io.BytesIO(bytes(fr["cam_images_jpeg"][ci]))).crop(
                    (0, 0, 1920, 886))
                buf = io.BytesIO()
                im.save(buf, format="JPEG")
                fr["cam_images_jpeg"][ci] = np.frombuffer(buf.getvalue(), np.uint8)
            np.savez(path, **fr)
            w.write(frame_proto.encode_frame_lite(fr))
    models = dataclasses.replace(masks.build_fake_models(device="cpu"), detic=_fixed_detic)
    provider, _, _ = masks._waymo_provider(type("A", (), dict(
        dataroot=str(frames_root), out_dir=str(tmp_path / "x"), scenes="", thumbnail=1024)))
    shapes = [im.shape for im in provider(scene, 0)]
    assert shapes == [(683, 1024, 3)] * 3 + [(473, 1024, 3)] * 2
    lift_cfg = port_config.LiftStageConfig(**SMALL_FUSED)
    masks.run_mask_stage(models, provider, [scene], lambda s: 2, str(tmp_path / "masks"),
                         MASK_CFG, verbose=False)
    lift_waymo.run_lift_waymo(str(frames_root), str(tmp_path / "masks"), [scene],
                              str(tmp_path / "two.bin"), lift_cfg=lift_cfg, batch_size=2,
                              verbose=False, device="cpu")
    n = e2e.run_e2e_waymo(str(raw_root), [scene], str(tmp_path / "fused.bin"), models,
                          lift_cfg=lift_cfg, mask_cfg=MASK_CFG, batch_size=2,
                          verbose=False, device="cpu",
                          mask_dir=str(tmp_path / "fused_masks"))
    assert n == 2
    two = proto.decode_objects((tmp_path / "two.bin").read_bytes())
    fused = proto.decode_objects((tmp_path / "fused.bin").read_bytes())
    assert len(two) == len(fused) > 0
    for a, b in zip(two, fused):
        assert (a.type, a.frame_timestamp_micros, a.context_name) == \
            (b.type, b.frame_timestamp_micros, b.context_name)
        np.testing.assert_allclose(
            [a.box.center_x, a.box.center_y, a.box.center_z, a.box.width, a.box.length,
             a.box.height, a.box.heading],
            [b.box.center_x, b.box.center_y, b.box.center_z, b.box.width, b.box.length,
             b.box.height, b.box.heading], rtol=0, atol=1e-5)
        assert a.score == pytest.approx(b.score, abs=1e-6)
    assert MaskArtifactStore(tmp_path / "fused_masks").completed_scenes() == {scene}


def test_masks_cli_on_a_waymo_dataroot(fake_waymo, tmp_path, capsys):
    frames, _, info = fake_waymo
    out = tmp_path / "masks_out"
    masks.main(["--dataset", "waymo", "--dataroot", str(frames), "--out_dir", str(out),
                "--fake_weights", "--thumbnail", "96", "--device", "cpu"])
    assert "2 frames done" in capsys.readouterr().out
    fm = MaskArtifactStore(out).read_frame(info["scene"], 1)
    assert fm is not None and len(fm.labels) == len(fm.cam_nums)
    assert all(c < 5 for c in fm.cam_nums)


def test_e2e_cli_waymo_gets_the_waymo_vocabulary(monkeypatch, tmp_path):
    seen = {}

    def fake_run(frames_root, scenes, out, models, **kw):
        seen.update(root=frames_root, scenes=scenes, out=out, models=models, **kw)
        return 0

    monkeypatch.setattr(e2e, "run_e2e_waymo", fake_run)
    e2e.main(["--dataset", "waymo", "--dataroot", str(tmp_path), "--scenes", "s0,s1",
              "--out", str(tmp_path / "o.bin"), "--fake_weights", "--device", "cpu"])
    assert tuple(seen["models"].vocabulary) == tuple(CUSTOM_VOCABULARY_WAYMO)
    assert seen["scenes"] == ["s0", "s1"] and seen["device"] == "cpu"
    # --host_shard (A14a): host 1 of 2 keeps the stride [1::2] and writes
    # {out}.host1; merge_host_outputs concatenates the hosts' .bin files
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    e2e.main(["--dataset", "waymo", "--dataroot", str(tmp_path), "--scenes", "s0,s1,s2",
              "--out", str(tmp_path / "o.bin"), "--fake_weights", "--device", "cpu",
              "--host_shard"])
    assert seen["scenes"] == ["s1"] and seen["out"] == str(tmp_path / "o.bin") + ".host1"
    (tmp_path / "o.bin.host0").write_bytes(b"\x0a\x01a")
    (tmp_path / "o.bin.host1").write_bytes(b"\x0a\x01b")
    e2e.merge_host_outputs([str(tmp_path / "o.bin.host0"), str(tmp_path / "o.bin.host1")],
                           str(tmp_path / "o.bin"), dataset="waymo")
    assert (tmp_path / "o.bin").read_bytes() == b"\x0a\x01a\x0a\x01b"
    monkeypatch.delenv("RANK")
    monkeypatch.delenv("WORLD_SIZE")
    # KITTI (ported in A9) keeps the nuScenes vocabulary, as in JAX
    monkeypatch.setattr(e2e, "run_e2e_kitti",
                        lambda root, indices, out, models, **kw: seen.update(
                            root=root, scenes=indices, models=models, **kw))
    e2e.main(["--dataset", "kitti", "--dataroot", str(tmp_path), "--scenes", "0,4",
              "--out", str(tmp_path / "k"), "--fake_weights", "--device", "cpu"])
    assert tuple(seen["models"].vocabulary) == tuple(CUSTOM_VOCABULARY_NUSCENES)
    assert seen["scenes"] == [0, 4]

"""The port's Waymo metrics (its own build of native/waymo_metrics.cc),
rotated-box geometry and polygon NMS against the JAX package on the CPU.

- Every test of tests/test_waymo_metrics.py and
  tests/test_waymo_metrics_contract.py runs again with the port's functions
  put in place of the JAX package's in that module (the same assertions,
  the port's code). They need g++ and skip without it, as there.
- The port's metrics binary prints the JAX binary's bytes on the same .bin
  files.
- `rotated_iou_bev` within 1e-6 of JAX's (f32); `polygon_nms_keep` keep sets
  equal; the numpy fallback of the matcher equals the native one.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_waymo_metrics as jax_metrics_tests
import test_waymo_metrics_contract as jax_contract_tests
from cm3d_tpu.datasets.waymo.proto import encode_objects as jax_encode_objects
from cm3d_tpu.eval import waymo_metrics as jax_waymo_metrics
from cm3d_tpu.geometry import boxes as jax_boxes
from cm3d_tpu.ops.nms import polygon_nms_keep as jax_polygon_nms_keep

from cm3d_tpu_torch.datasets.waymo import proto
from cm3d_tpu_torch.eval import waymo_metrics
from cm3d_tpu_torch.geometry import boxes
from cm3d_tpu_torch.ops.nms import polygon_nms_keep

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the binary")

PORT_NAMES = ("box_iou_7dof", "hungarian_match", "metrics_binary_path", "run_detection_metrics",
              "parse_metrics_stdout")
PROTO_NAMES = ("WaymoBox", "WaymoObject", "encode_objects")


def _use_port(monkeypatch, module):
    for name in PORT_NAMES:
        if hasattr(module, name):
            monkeypatch.setattr(module, name, getattr(waymo_metrics, name))
    for name in PROTO_NAMES:
        if hasattr(module, name):
            monkeypatch.setattr(module, name, getattr(proto, name))


def _test_names(module):
    return sorted(n for n in dir(module) if n.startswith("test_"))


@needs_gxx
@pytest.mark.parametrize("name", _test_names(jax_metrics_tests))
def test_port_passes_the_jax_metrics_tests(name, monkeypatch, tmp_path):
    _use_port(monkeypatch, jax_metrics_tests)
    fn = getattr(jax_metrics_tests, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()


@needs_gxx
@pytest.mark.parametrize("name", _test_names(jax_contract_tests))
def test_port_passes_the_jax_metrics_contract_tests(name, monkeypatch, tmp_path):
    _use_port(monkeypatch, jax_contract_tests)
    fn = getattr(jax_contract_tests, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()


@needs_gxx
def test_port_binary_prints_the_jax_binarys_bytes(tmp_path):
    pred_bin, gt_bin = jax_contract_tests._fixture_bins(tmp_path)
    rng = np.random.default_rng(3)
    objs = [proto.WaymoObject(box=proto.WaymoBox(*rng.uniform(-30, 30, 2), 1.0, 2.0, 4.5, 1.8,
                                                 rng.uniform(-3, 3)),
                              type=int(t), score=float(rng.uniform(0.2, 1)),
                              frame_timestamp_micros=1234567890, context_name="fixture_context")
            for t in rng.choice([1, 2, 4], 20)]
    (tmp_path / "noisy.bin").write_bytes(proto.encode_objects(objs))
    assert (tmp_path / "noisy.bin").read_bytes() == jax_encode_objects(objs)
    for pred in (pred_bin, str(tmp_path / "noisy.bin")):
        got = subprocess.check_output([waymo_metrics.metrics_binary_path(), pred, gt_bin])
        want = subprocess.check_output([jax_waymo_metrics.metrics_binary_path(), pred, gt_bin])
        assert got == want and b"[mAP " in got
    # built into the port's own (git-ignored) build directory
    assert waymo_metrics.metrics_binary_path().startswith(
        str(Path(waymo_metrics.__file__).parents[1] / "native" / "_build"))


def _random_bev(rng, n):
    return np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(0.5, 4, (n, 2)),
                           rng.uniform(-3, 3, (n, 1))], 1).astype(np.float32)


def test_rotated_iou_bev_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _random_bev(rng, 30), _random_bev(rng, 20)
    a[3] = b[4]  # an identical pair
    want = np.asarray(jax_boxes.rotated_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = boxes.rotated_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (want > 0).sum() > 20
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[3, 4] == pytest.approx(1.0, abs=1e-6)


def test_box_corners_and_7dof_match_jax():
    rng = np.random.default_rng(1)
    c = rng.uniform(-10, 10, (6, 3)).astype(np.float32)
    s = rng.uniform(0.5, 5, (6, 3)).astype(np.float32)
    y = rng.uniform(-3, 3, 6).astype(np.float32)
    for name in ("box_corners_3d", "boxes_to_7dof"):
        want = np.asarray(getattr(jax_boxes, name)(jnp.asarray(c), jnp.asarray(s),
                                                    jnp.asarray(y)))
        got = getattr(boxes, name)(torch.from_numpy(c), torch.from_numpy(s),
                                   torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygon_nms_keep_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b = _random_bev(rng, 48)
    s = rng.uniform(0, 1, 48).astype(np.float32)
    v = rng.uniform(0, 1, 48) > 0.1
    want = np.asarray(jax_polygon_nms_keep(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v)))
    got = polygon_nms_keep(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(v))
    assert want.sum() > 0 and (~want & v & (s > 0.3)).sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


@needs_gxx
def test_matcher_fallback_equals_native(monkeypatch):
    rng = np.random.default_rng(7)
    pred = np.stack([[*rng.uniform(-20, 20, 2), 0, 2, 4, 2, rng.uniform(-1, 1)]
                     for _ in range(10)])
    gt = pred[rng.permutation(10)[:7]].copy()
    gt[:, :2] += rng.normal(0, 0.3, (7, 2))
    native = waymo_metrics.hungarian_match(pred, gt, 0.3)
    iou_native = waymo_metrics.box_iou_7dof(pred[0], gt[0])
    monkeypatch.setattr(waymo_metrics, "_lib", lambda: None)
    fallback = waymo_metrics.hungarian_match(pred, gt, 0.3)
    assert len(native[0]) >= 5
    for a, b in zip(native, fallback):
        np.testing.assert_allclose(np.sort(a), np.sort(b), atol=1e-6)
    assert waymo_metrics.box_iou_7dof(pred[0], gt[0]) == pytest.approx(iou_native, abs=1e-9)

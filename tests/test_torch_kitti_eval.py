"""The port's KITTI devkit-protocol eval (cm3d_tpu_torch.eval.kitti, a copy
of the JAX package's numpy module) against the JAX package: the JAX eval's
own tests run on the port's module, the rotated BEV clipper agrees with the
port's torch `rotated_iou_bev` (within 1e-5: f64 against f64, other clip
order) and its native `box_iou_7dof` (within 1e-9), and both evals give the
same AP table, bit for bit, on seeded label files."""

import numpy as np
import pytest
import torch

import test_kitti_eval as jax_eval_tests
from cm3d_tpu.datasets.kitti.calib import write_label as jax_write_label
from cm3d_tpu.eval import kitti as jax_kitti_eval

from cm3d_tpu_torch.datasets.kitti import calib
from cm3d_tpu_torch.eval import kitti
from cm3d_tpu_torch.eval.waymo_metrics import box_iou_7dof
from cm3d_tpu_torch.geometry.boxes import rotated_iou_bev

JAX_TESTS = (
    "test_rotated_iou_np_matches_jax_and_native", "test_iou_hand_values",
    "test_image_box_overlap_criteria", "test_get_thresholds_dense_and_sparse",
    "test_perfect_predictions_ap_one", "test_two_gt_recall_quantization",
    "test_fp_precision_curve", "test_neighbor_class_ignored",
    "test_dontcare_absorbs_bbox_fp_only", "test_difficulty_gating",
    "test_short_detection_ignored", "test_cli_end_to_end", "test_aos_sentinel_disables_aos",
    "test_load_frames_default_ids_from_gt_and_orphan_preds",
    "test_load_frames_missing_pred_and_nan_score",
)


def test_the_list_is_every_jax_eval_test():
    assert sorted(JAX_TESTS) == sorted(n for n in dir(jax_eval_tests) if n.startswith("test_"))


@pytest.mark.parametrize("name", JAX_TESTS)
def test_port_passes_the_jax_kitti_eval_tests(name, monkeypatch, tmp_path, capsys):
    """tests/test_kitti_eval.py with the port's eval and label classes in
    place of the JAX package's (the same assertions, the port's code)."""
    monkeypatch.setattr(jax_eval_tests, "Object3d", calib.Object3d)
    monkeypatch.setattr(jax_eval_tests, "write_label", calib.write_label)
    for attr in ("DIFFICULTIES", "N_SAMPLE_PTS", "box_overlap_3d", "eval_class",
                 "evaluate_kitti", "get_thresholds", "image_box_overlap", "load_frames",
                 "rotated_iou_bev_np"):
        monkeypatch.setattr(jax_eval_tests, attr, getattr(kitti, attr))
    monkeypatch.setattr(jax_eval_tests, "kitti_eval_main", kitti.main)
    fn = getattr(jax_eval_tests, name)
    args = {"tmp_path": tmp_path, "capsys": capsys}
    fn(*[args[a] for a in fn.__code__.co_varnames[:fn.__code__.co_argcount]])


def test_rotated_iou_np_matches_the_ports_torch_and_native_iou():
    rng = np.random.default_rng(11)
    n, m = 9, 7

    def boxes(k):
        return np.column_stack([rng.uniform(-6, 6, k), rng.uniform(-6, 6, k),
                                rng.uniform(0.5, 3.0, k), rng.uniform(0.5, 6.0, k),
                                rng.uniform(-np.pi, np.pi, k)])

    a, b = boxes(n), boxes(m)
    b[:3] = a[:3]  # identical pairs: IoU 1
    got = kitti.rotated_iou_bev_np(a, b)
    assert (got > 0).sum() > n and np.allclose(np.diag(got[:3, :3]), 1.0)
    want = rotated_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for i in range(n):
        for j in range(m):
            a7 = np.array([a[i, 0], a[i, 1], 0.0, a[i, 2], a[i, 3], 1.0, a[i, 4]])
            b7 = np.array([b[j, 0], b[j, 1], 0.0, b[j, 2], b[j, 3], 1.0, b[j, 4]])
            assert abs(got[i, j] - box_iou_7dof(a7, b7, mode_2d=True)) < 1e-9


def test_eval_tables_equal_jax(tmp_path, capsys):
    """Seeded GT and noisy, partly wrong predictions over three classes
    (with Van / DontCare rows): both CLIs give the same results."""
    rng = np.random.default_rng(5)
    gt_dir, pred_dir = tmp_path / "label_2", tmp_path / "pred"
    gt_dir.mkdir()
    pred_dir.mkdir()
    classes = ("Car", "Pedestrian", "Cyclist", "Van", "DontCare")
    for f in range(4):
        gts, dets = [], []
        for i in range(12):
            cls = classes[int(rng.integers(len(classes)))]
            x, z = rng.uniform(-15, 15), rng.uniform(8, 50)
            u0, v0 = rng.uniform(0, 1100), rng.uniform(100, 250)
            kw = dict(cls=cls, x=x, z=z, ry=rng.uniform(-np.pi, np.pi),
                      occ=int(rng.integers(3)), trunc=float(rng.uniform(0, 0.5)),
                      bbox=(u0, v0, u0 + rng.uniform(10, 120), v0 + rng.uniform(20, 100)))
            gts.append(jax_eval_tests.make_obj(**kw))
            if cls != "DontCare" and rng.random() < 0.8:
                kw.update(x=x + rng.normal(0, 0.3), z=z + rng.normal(0, 0.3),
                          alpha=rng.uniform(-np.pi, np.pi))
                dets.append(jax_eval_tests.make_obj(score=float(rng.uniform(0.1, 1)), **kw))
        jax_write_label(gt_dir / f"{f:06d}.txt", gts)
        jax_write_label(pred_dir / f"{f:06d}.txt", dets)
    argv = ["--gt_dir", str(gt_dir), "--pred_dir", str(pred_dir)]
    got = kitti.main(argv)
    got_text = capsys.readouterr().out
    want = jax_kitti_eval.main(argv)
    assert got == want and got_text == capsys.readouterr().out
    assert 0 < got["Car"]["bbox"]["moderate"] < 1 and "aos" in got["Car"]

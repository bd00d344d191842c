"""KITTI 3D object detection evaluation — official devkit protocol, in-framework.
A copy of `cm3d_tpu/eval/kitti.py` (host numpy, unchanged).

The reference writes KITTI-format prediction txts (src/kitti/2d_to_3d.py:879-885
``save_pred``) but never scores them: evaluation happened outside the repo with
the KITTI devkit binary (``evaluate_object_3d_offline``). This module closes
that loop so the KITTI path runs end-to-end inside the port:

    masks → lift (pipelines/lift_kitti.py, pred/ txts) → AP here.

Protocol follows the official devkit (cpp/evaluate_object.cpp), which is also
what mmdetection3d's KITTI eval reimplements:

- three metrics: 2D image bbox IoU, BEV rotated IoU, 3D IoU (all exact);
- three difficulty buckets gating GT by 2D-box height / occlusion / truncation
  (easy 40px/0/0.15, moderate 25px/1/0.30, hard 25px/2/0.50);
- neighbor-class handling (Van ↔ Car, Person_sitting ↔ Pedestrian: neither TP
  nor FP), DontCare regions absorbing unmatched 2D detections;
- 41 recall sample points; score thresholds taken from matched-GT detection
  scores (``get_thresholds``); greedy per-GT assignment — highest score in the
  thresholds pass, largest overlap in the precision pass;
- AP|R40 = mean precision over recalls 1/40 … 40/40 after max-from-the-right
  smoothing, and AOS (orientation similarity) for the bbox metric.

Everything is host-side numpy: evaluation is file-IO bookkeeping over a few
thousand small label files, not device work (same stance as the nuScenes eval
in eval/algo.py). The rotated-BEV clipper is a numpy port of
geometry/boxes._rect_intersection_area and is parity-pinned in tests against
the port's torch ``rotated_iou_bev`` and the native C ``box_iou_7dof``.

Note: ``datasets.kitti.calib.Object3d.difficulty()`` reproduces the
*reference's* quirky estimate (it uses the 2D box WIDTH, kitti_utils.py:83-96).
This module implements the official definition instead — the two serve
different parity contracts.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from cm3d_tpu_torch.datasets.kitti.calib import Object3d, read_label

N_SAMPLE_PTS = 41
# Per-difficulty GT gates (official devkit; index = easy, moderate, hard).
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.30, 0.50)
DIFFICULTIES = ("easy", "moderate", "hard")
METRICS = ("bbox", "bev", "3d")
# Official minimum overlaps (the evaluation-server row: car 0.7, rest 0.5).
DEFAULT_MIN_OVERLAP = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# Classes that are "almost" the evaluated class: their GT is ignored (a
# detection matching them is neither TP nor FP).
NEIGHBOR_CLASSES = {
    "Car": ("Van",),
    "Pedestrian": ("Person_sitting",),
}
_NO_DETECTION = -np.inf


# ---------------------------------------------------------------------------
# Overlap computations (vectorized numpy)
# ---------------------------------------------------------------------------


def image_box_overlap(
    boxes_a: np.ndarray, boxes_b: np.ndarray, criterion: int = -1
) -> np.ndarray:
    """Axis-aligned overlap of [A, 4] vs [B, 4] (xmin ymin xmax ymax).

    criterion -1: IoU (union); 0: intersection / area_a (the devkit's
    DontCare-absorption denominator, first argument = detections)."""
    a = np.asarray(boxes_a, np.float64).reshape(-1, 4)
    b = np.asarray(boxes_b, np.float64).reshape(-1, 4)
    ix = np.maximum(
        0.0,
        np.minimum(a[:, None, 2], b[None, :, 2])
        - np.maximum(a[:, None, 0], b[None, :, 0]),
    )
    iy = np.maximum(
        0.0,
        np.minimum(a[:, None, 3], b[None, :, 3])
        - np.maximum(a[:, None, 1], b[None, :, 1]),
    )
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    if criterion == 0:
        denom = np.broadcast_to(area_a[:, None], inter.shape).copy()
    else:
        denom = area_a[:, None] + area_b[None, :] - inter
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


def _bev_corners(boxes5: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, w, l, yaw) → CCW corners [N, 4, 2]; l along heading."""
    w, length, yaw = boxes5[:, 2], boxes5[:, 3], boxes5[:, 4]
    dx = np.stack([length, length, -length, -length], -1) / 2.0
    dy = np.stack([w, -w, -w, w], -1) / 2.0
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    gx = boxes5[:, :1] + c * dx - s * dy
    gy = boxes5[:, 1:2] + s * dx + c * dy
    # same CW→CCW flip as geometry.boxes.rotated_iou_bev
    return np.stack([gx, gy], -1)[:, ::-1, :]


def _rect_intersection_area_np(
    corners_a: np.ndarray, corners_b: np.ndarray
) -> np.ndarray:
    """numpy port of geometry/boxes._rect_intersection_area (Sutherland–
    Hodgman with fixed K=8 vertex buffers). corners CCW. Returns [A, B]."""
    A, B = corners_a.shape[0], corners_b.shape[0]
    if A == 0 or B == 0:
        return np.zeros((A, B))
    K = 8
    poly = np.zeros((A, B, K, 2))
    poly[:, :, :4, :] = corners_a[:, None, :, :]
    n = np.full((A, B), 4, np.int64)

    eb0 = corners_b
    eb1 = np.roll(corners_b, -1, axis=1)
    k_idx = np.arange(K)

    for e in range(4):
        p0, p1 = eb0[:, e], eb1[:, e]  # [B, 2]
        d = p1 - p0
        rel = poly - p0[None, :, None, :]
        side = d[None, :, None, 0] * rel[..., 1] - d[None, :, None, 1] * rel[..., 0]
        inside = side >= 0

        valid = k_idx[None, None, :] < n[..., None]
        nxt = np.where(k_idx[None, None, :] + 1 < n[..., None], k_idx + 1, 0)
        v_next = np.take_along_axis(poly, nxt[..., None], axis=2)
        side_next = np.take_along_axis(side, nxt, axis=2)
        inside_next = side_next >= 0

        denom = side - side_next
        t = side / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        ipt = poly + t[..., None] * (v_next - poly)

        out_pts = np.zeros((A, B, 2 * K, 2))
        out_pts[:, :, 0::2, :] = poly
        out_pts[:, :, 1::2, :] = ipt
        emit = np.zeros((A, B, 2 * K), bool)
        emit[:, :, 0::2] = inside & valid
        emit[:, :, 1::2] = (inside ^ inside_next) & valid

        order = np.argsort(~emit, axis=-1, kind="stable")
        out_sorted = np.take_along_axis(out_pts, order[..., None], axis=2)
        n = np.minimum(emit.sum(-1), K).astype(np.int64)
        poly = out_sorted[:, :, :K, :]

    valid = k_idx[None, None, :] < n[..., None]
    nxt = np.where(k_idx[None, None, :] + 1 < n[..., None], k_idx + 1, 0)
    x, y = poly[..., 0], poly[..., 1]
    x2 = np.take_along_axis(x, nxt, axis=-1)
    y2 = np.take_along_axis(y, nxt, axis=-1)
    cross = x * y2 - x2 * y
    area = 0.5 * np.abs(np.where(valid, cross, 0.0).sum(-1))
    return np.where(n >= 3, area, 0.0)


def rotated_iou_bev_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Exact rotated BEV IoU, [A, 5] × [B, 5] (cx, cy, w, l, yaw) → [A, B]."""
    a = np.asarray(boxes_a, np.float64).reshape(-1, 5)
    b = np.asarray(boxes_b, np.float64).reshape(-1, 5)
    inter = _rect_intersection_area_np(_bev_corners(a), _bev_corners(b))
    area_a = a[:, 2] * a[:, 3]
    area_b = b[:, 2] * b[:, 3]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _objects_bev5(objs: Sequence[Object3d]) -> np.ndarray:
    """KITTI rect-camera boxes → BEV 5-DoF on the ground (x, z) plane.

    ry rotates about the (downward) camera y axis; mapping (x, z) → (cx, cy)
    with yaw=-ry keeps the geometry rigid. IoU is isometry-invariant so any
    consistent mapping scores identically."""
    if not objs:
        return np.zeros((0, 5))
    return np.array(
        [[o.t[0], o.t[2], o.w, o.l, -o.ry] for o in objs], np.float64
    )


def _objects_y_extent(objs: Sequence[Object3d]) -> np.ndarray:
    """[N, 2] vertical (camera-y, downward) interval [y_top, y_bottom]:
    t is the BOTTOM center, the box spans y ∈ [t_y - h, t_y]."""
    if not objs:
        return np.zeros((0, 2))
    return np.array([[o.t[1] - o.h, o.t[1]] for o in objs], np.float64)


def box_overlap_3d(
    objs_a: Sequence[Object3d], objs_b: Sequence[Object3d]
) -> np.ndarray:
    """Exact 3D IoU matrix between two KITTI object lists."""
    a5, b5 = _objects_bev5(objs_a), _objects_bev5(objs_b)
    if a5.shape[0] == 0 or b5.shape[0] == 0:
        return np.zeros((a5.shape[0], b5.shape[0]))
    inter_bev = _rect_intersection_area_np(_bev_corners(a5), _bev_corners(b5))
    ya, yb = _objects_y_extent(objs_a), _objects_y_extent(objs_b)
    y_ov = np.maximum(
        0.0,
        np.minimum(ya[:, None, 1], yb[None, :, 1])
        - np.maximum(ya[:, None, 0], yb[None, :, 0]),
    )
    inter = inter_bev * y_ov
    vol_a = a5[:, 2] * a5[:, 3] * (ya[:, 1] - ya[:, 0])
    vol_b = b5[:, 2] * b5[:, 3] * (yb[:, 1] - yb[:, 0])
    union = vol_a[:, None] + vol_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _overlap_matrix(
    dets: Sequence[Object3d], gts: Sequence[Object3d], metric: str
) -> np.ndarray:
    if metric == "bbox":
        da = np.array([d.box2d for d in dets]).reshape(-1, 4)
        ga = np.array([g.box2d for g in gts]).reshape(-1, 4)
        return image_box_overlap(da, ga)
    if metric == "bev":
        return rotated_iou_bev_np(_objects_bev5(dets), _objects_bev5(gts))
    if metric == "3d":
        return box_overlap_3d(dets, gts)
    raise ValueError(f"unknown metric {metric!r}")


# ---------------------------------------------------------------------------
# Devkit matching machinery
# ---------------------------------------------------------------------------


def clean_data(
    gts: Sequence[Object3d],
    dets: Sequence[Object3d],
    current_class: str,
    difficulty: int,
):
    """Devkit cleanData: classify GT/detections for one (class, difficulty).

    Returns (ignored_gt, ignored_det, dontcare_boxes, n_valid_gt) where the
    ignored codes are 0 = evaluate, 1 = ignore (no TP/FP effect), -1 = other
    class (invisible)."""
    cls_l = current_class.lower()
    neighbors = tuple(
        n.lower() for n in NEIGHBOR_CLASSES.get(current_class, ())
    )
    ignored_gt: List[int] = []
    dontcare: List[np.ndarray] = []
    n_valid = 0
    for g in gts:
        if g.type == "DontCare":
            dontcare.append(np.asarray(g.box2d, np.float64))
            ignored_gt.append(-1)
            continue
        if g.type.lower() == cls_l:
            valid_class = 1
        elif g.type.lower() in neighbors:
            valid_class = 0
        else:
            ignored_gt.append(-1)
            continue
        height = float(g.box2d[3] - g.box2d[1])
        hard_to_see = (
            g.occlusion > MAX_OCCLUSION[difficulty]
            or g.truncation > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not hard_to_see:
            ignored_gt.append(0)
            n_valid += 1
        else:
            ignored_gt.append(1)
    ignored_det: List[int] = []
    for d in dets:
        # devkit order: too-short detections are "ignored" (can absorb an
        # ignored GT, never a FP) REGARDLESS of class; class gates after.
        if float(d.box2d[3] - d.box2d[1]) < MIN_HEIGHT[difficulty]:
            ignored_det.append(1)
        elif d.type.lower() == cls_l:
            ignored_det.append(0)
        else:
            ignored_det.append(-1)
    dc = np.array(dontcare).reshape(-1, 4)
    return ignored_gt, ignored_det, dc, n_valid


def compute_statistics(
    overlaps: np.ndarray,  # [n_det, n_gt]
    gts: Sequence[Object3d],
    dets: Sequence[Object3d],
    ignored_gt: Sequence[int],
    ignored_det: Sequence[int],
    dontcare: np.ndarray,
    metric: str,
    min_overlap: float,
    thresh: float = 0.0,
    compute_fp: bool = False,
    compute_aos: bool = False,
):
    """Devkit computeStatistics for one frame at one score threshold.

    Returns (tp, fp, fn, similarity_sum, tp_scores). Pass 1
    (compute_fp=False) only gathers matched-detection scores for
    get_thresholds; pass 2 (compute_fp=True) counts tp/fp/fn at ``thresh``."""
    n_det, n_gt = len(dets), len(gts)
    assigned = [False] * n_det
    below_thresh = [False] * n_det
    if compute_fp:
        for j, d in enumerate(dets):
            if d.score < thresh:
                below_thresh[j] = True

    tp = fp = fn = 0
    similarity = 0.0
    tp_scores: List[float] = []

    for i in range(n_gt):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(n_det):
            if ignored_det[j] == -1 or assigned[j] or below_thresh[j]:
                continue
            overlap = overlaps[j, i]
            if (
                not compute_fp
                and overlap > min_overlap
                and dets[j].score > valid_detection
            ):
                det_idx = j
                valid_detection = dets[j].score
            elif (
                compute_fp
                and overlap > min_overlap
                and (overlap > max_overlap or assigned_ignored_det)
                and ignored_det[j] == 0
            ):
                max_overlap = overlap
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = False
            elif (
                compute_fp
                and overlap > min_overlap
                and valid_detection == _NO_DETECTION
                and ignored_det[j] == 1
            ):
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = True

        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != _NO_DETECTION and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            tp_scores.append(float(dets[det_idx].score))
            assigned[det_idx] = True
            if compute_aos:
                delta = gts[i].alpha - dets[det_idx].alpha
                similarity += (1.0 + np.cos(delta)) / 2.0

    if compute_fp:
        for j in range(n_det):
            if not (
                assigned[j]
                or ignored_det[j] in (-1, 1)
                or below_thresh[j]
            ):
                fp += 1
        # DontCare regions absorb 2D false positives (bbox metric only);
        # denominator is the DETECTION area (devkit boxoverlap criterion 0).
        if metric == "bbox" and dontcare.shape[0] > 0:
            det_boxes = np.array([d.box2d for d in dets]).reshape(-1, 4)
            ov_dc = image_box_overlap(det_boxes, dontcare, criterion=0)
            for j in range(n_det):
                if (
                    assigned[j]
                    or ignored_det[j] in (-1, 1)
                    or below_thresh[j]
                ):
                    continue
                if (ov_dc[j] > min_overlap).any():
                    fp -= 1
    return tp, fp, fn, similarity, tp_scores


def get_thresholds(scores: np.ndarray, n_gt: int) -> np.ndarray:
    """Devkit getThresholds: pick matched-detection scores closest to each of
    the 41 evenly spaced recall positions."""
    scores = np.sort(np.asarray(scores, np.float64))[::-1]
    current_recall = 0.0
    thresholds: List[float] = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(scores) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and i < (
            len(scores) - 1
        ):
            continue
        thresholds.append(float(score))
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return np.array(thresholds)


# ---------------------------------------------------------------------------
# Per-class evaluation
# ---------------------------------------------------------------------------


def eval_class(
    gt_frames: Sequence[Sequence[Object3d]],
    det_frames: Sequence[Sequence[Object3d]],
    current_class: str,
    difficulty: int,
    metric: str,
    min_overlap: float,
    compute_aos: bool = False,
    frame_overlaps: Sequence[np.ndarray] | None = None,
) -> Dict[str, object]:
    """AP|R40 (and AOS for bbox) for one (class, difficulty, metric).

    frame_overlaps: precomputed per-frame [n_det, n_gt] overlap matrices for
    this metric (they depend only on (metric, frame), so evaluate_kitti
    hoists them across the class x difficulty grid instead of re-running the
    rotated-BEV clipper 9x)."""
    assert len(gt_frames) == len(det_frames)
    per_frame = []
    total_gt = 0
    all_tp_scores: List[float] = []
    for f, (gts, dets) in enumerate(zip(gt_frames, det_frames)):
        ignored_gt, ignored_det, dc, n_valid = clean_data(
            gts, dets, current_class, difficulty
        )
        overlaps = (
            frame_overlaps[f]
            if frame_overlaps is not None
            else _overlap_matrix(dets, gts, metric)
        )
        total_gt += n_valid
        _, _, _, _, tp_scores = compute_statistics(
            overlaps, gts, dets, ignored_gt, ignored_det, dc,
            metric, min_overlap,
        )
        all_tp_scores.extend(tp_scores)
        per_frame.append((gts, dets, ignored_gt, ignored_det, dc, overlaps))

    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    if total_gt > 0 and all_tp_scores:
        thresholds = get_thresholds(np.array(all_tp_scores), total_gt)
        for k, t in enumerate(thresholds):
            tp = fp = fn = 0
            sim = 0.0
            for gts, dets, ignored_gt, ignored_det, dc, overlaps in per_frame:
                r = compute_statistics(
                    overlaps, gts, dets, ignored_gt, ignored_det, dc,
                    metric, min_overlap, thresh=t, compute_fp=True,
                    compute_aos=compute_aos,
                )
                tp += r[0]
                fp += r[1]
                fn += r[2]
                sim += r[3]
            precision[k] = tp / max(tp + fp, 1)
            recall[k] = tp / max(tp + fn, 1)
            if compute_aos:
                aos[k] = sim / max(tp + fp, 1)
        # max-from-the-right smoothing (devkit)
        for k in range(N_SAMPLE_PTS):
            precision[k] = precision[k:].max()
            if compute_aos:
                aos[k] = aos[k:].max()

    out: Dict[str, object] = {
        "ap": float(precision[1:].sum() / (N_SAMPLE_PTS - 1)),
        "precision": precision,
        "recall": recall,
        "n_gt": total_gt,
    }
    if compute_aos:
        out["aos"] = float(aos[1:].sum() / (N_SAMPLE_PTS - 1))
    return out


def evaluate_kitti(
    gt_frames: Sequence[Sequence[Object3d]],
    det_frames: Sequence[Sequence[Object3d]],
    classes: Sequence[str] = ("Car", "Pedestrian", "Cyclist"),
    metrics: Sequence[str] = METRICS,
    min_overlaps: Dict[str, float] | None = None,
    compute_aos: bool = True,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Full evaluation → {class: {metric: {difficulty: AP, ...}, "aos": ...}}."""
    ov = dict(DEFAULT_MIN_OVERLAP)
    if min_overlaps:
        ov.update(min_overlaps)
    # Devkit behavior: a detection carrying the alpha == -10 sentinel means
    # "orientation unavailable" and disables AOS for the whole run (the
    # reference's own txts carry it, kitti/2d_to_3d.py:1535).
    if compute_aos and any(
        d.alpha == -10 for frame in det_frames for d in frame
    ):
        compute_aos = False
    # Overlap matrices depend only on (metric, frame); hoist them across the
    # class x difficulty grid (the rotated clipper dominates eval wall time).
    overlaps_by_metric = {
        m: [
            _overlap_matrix(dets, gts, m)
            for gts, dets in zip(gt_frames, det_frames)
        ]
        for m in metrics
    }
    results: Dict[str, Dict[str, Dict[str, float]]] = {}
    for cls in classes:
        mo = ov.get(cls, 0.5)
        results[cls] = {"min_overlap": mo}  # type: ignore[assignment]
        for metric in metrics:
            row: Dict[str, float] = {}
            aos_row: Dict[str, float] = {}
            for d, dname in enumerate(DIFFICULTIES):
                r = eval_class(
                    gt_frames, det_frames, cls, d, metric, mo,
                    compute_aos=compute_aos and metric == "bbox",
                    frame_overlaps=overlaps_by_metric[metric],
                )
                row[dname] = r["ap"]
                if "aos" in r:
                    aos_row[dname] = r["aos"]  # type: ignore[index]
            results[cls][metric] = row
            if aos_row:
                results[cls]["aos"] = aos_row
    return results


# ---------------------------------------------------------------------------
# File loading + CLI
# ---------------------------------------------------------------------------


def load_frames(
    gt_dir: str | Path, pred_dir: str | Path, ids: Sequence[int] | None = None
):
    """Read matched GT/pred label files. ids defaults to every GT txt
    present (a missing pred for a listed id = zero detections — so a
    partial lift run still pays its false negatives; deriving ids from
    pred_dir would silently drop GT-only frames and inflate AP). Pred txts
    with no GT counterpart mean the dirs are mismatched and fail loud."""
    gt_dir, pred_dir = Path(gt_dir), Path(pred_dir)
    if ids is None:
        ids = sorted(int(p.stem) for p in gt_dir.glob("*.txt"))
        if not ids:
            raise FileNotFoundError(f"no GT label txts under {gt_dir}")
        id_set = set(ids)
        orphans = sorted(
            int(p.stem)
            for p in pred_dir.glob("*.txt")
            if int(p.stem) not in id_set
        )
        if orphans:
            raise ValueError(
                f"{len(orphans)} prediction txts have no GT counterpart "
                f"(first: {orphans[:5]}) — wrong --gt_dir/--pred_dir "
                "pairing? Pass --ids explicitly to evaluate a subset."
            )
    gt_frames, det_frames = [], []
    for i in ids:
        gt_path = gt_dir / f"{i:06d}.txt"
        if not gt_path.exists():
            raise FileNotFoundError(f"GT label missing: {gt_path}")
        gt_frames.append(read_label(gt_path))
        pred_path = pred_dir / f"{i:06d}.txt"
        det_frames.append(read_label(pred_path) if pred_path.exists() else [])
    areas = []
    for frame in det_frames:
        for d in frame:
            if np.isnan(d.score):
                raise ValueError(
                    "prediction without a score column — KITTI eval needs "
                    "the 16-column pred format (lift_kitti's pred/ dir, not "
                    "pseudo/)"
                )
            areas.append(
                float(
                    (d.box2d[2] - d.box2d[0]) * (d.box2d[3] - d.box2d[1])
                )
            )
    if areas and max(areas) <= 0:
        raise ValueError(
            "every prediction has a degenerate 2D bbox (the reference's "
            "ltrb=[0,0,0,0] quirk) — the devkit protocol gates detections "
            "on 2D box height, so these would all be ignored. Regenerate "
            "with boxes_to_kitti_objects(project_box2d=True) (the default)."
        )
    return gt_frames, det_frames, list(ids)


def format_results(results: Dict[str, Dict[str, Dict[str, float]]]) -> str:
    lines = []
    for cls, metrics in results.items():
        mo = metrics.get("min_overlap", 0.5)
        lines.append(f"{cls} AP@{mo:.2f} (R40, easy moderate hard):")
        for metric in ("bbox", "bev", "3d", "aos"):
            if metric not in metrics:
                continue
            row = metrics[metric]
            vals = " ".join(
                f"{100.0 * row[d]:6.2f}" for d in DIFFICULTIES if d in row
            )
            lines.append(f"  {metric:<4s} AP: {vals}")
    return "\n".join(lines)


def main(argv=None) -> Dict[str, Dict[str, Dict[str, float]]]:
    p = argparse.ArgumentParser(
        description="KITTI 3D detection eval (official devkit protocol, AP|R40)"
    )
    p.add_argument("--gt_dir", required=True,
                   help="directory of GT label txts (label_2)")
    p.add_argument("--pred_dir", required=True,
                   help="directory of scored prediction txts (lift_kitti pred/)")
    p.add_argument("--ids", default="",
                   help="comma-separated frame ids (default: every GT txt, so "
                        "frames missing a prediction file count their false "
                        "negatives; orphan pred txts fail loud)")
    p.add_argument("--classes", default="Car,Pedestrian,Cyclist")
    p.add_argument("--metrics", default="bbox,bev,3d")
    p.add_argument("--car_overlap", type=float, default=0.7)
    p.add_argument("--other_overlap", type=float, default=0.5)
    p.add_argument("--out", default="", help="write results JSON here")
    args = p.parse_args(argv)

    ids = [int(x) for x in args.ids.split(",") if x] or None
    classes = [c for c in args.classes.split(",") if c]
    metrics = [m for m in args.metrics.split(",") if m]
    gt_frames, det_frames, ids = load_frames(args.gt_dir, args.pred_dir, ids)
    ov = {c: (args.car_overlap if c == "Car" else args.other_overlap)
          for c in classes}
    results = evaluate_kitti(
        gt_frames, det_frames, classes=classes, metrics=metrics,
        min_overlaps=ov,
    )
    print(f"evaluated {len(ids)} frames")
    if "bbox" in metrics and not any("aos" in r for r in results.values()):
        print("AOS skipped: detections carry the alpha=-10 sentinel "
              "(orientation unavailable)")
    print(format_results(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()

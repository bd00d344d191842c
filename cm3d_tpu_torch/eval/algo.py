"""Matching, accumulation and AP/TP computation.

Behavioral contract: the reference's accumulate_with_recall /
accumulate_object_class (src/nuscenes/eval_custom.py:542-863) and the devkit
calc_ap/calc_tp they feed. Reference quirks reproduced on purpose:

- Confidence sort is `sorted((conf, idx))[::-1]` — ties on confidence break
  toward the HIGHER original index (eval_custom.py:582,749).
- Matching is greedy over that order; each pred takes the closest untaken GT
  of its class in its sample; a match requires dist < dist_th (strict).
- vel/orient/attr errors are NaN-ed for cone/barrier per the same class
  rules (object-class mode keys off the MATCHED GT's class,
  eval_custom.py:632-649).
- Interpolation to 101 recall points with right=0; TP errors cummean'ed then
  interpolated on confidence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from cm3d_tpu_torch.eval.boxes import DetectionBox, EvalBoxes

NELEM = 101


# ---------------------------------------------------------------------------
# Distance / TP-error primitives (devkit-equivalent semantics).
# ---------------------------------------------------------------------------

def center_distance(gt: DetectionBox, pred: DetectionBox) -> float:
    return float(
        np.hypot(
            pred.translation[0] - gt.translation[0],
            pred.translation[1] - gt.translation[1],
        )
    )


def velocity_l2(gt: DetectionBox, pred: DetectionBox) -> float:
    return float(
        np.hypot(pred.velocity[0] - gt.velocity[0], pred.velocity[1] - gt.velocity[1])
    )


def scale_iou(gt: DetectionBox, pred: DetectionBox) -> float:
    """IoU of size-aligned boxes (translation/rotation ignored)."""
    sa = np.asarray(gt.size, np.float64)
    sb = np.asarray(pred.size, np.float64)
    assert (sa > 0).all() and (sb > 0).all(), "box sizes must be positive"
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa)) + float(np.prod(sb)) - inter
    return inter / union


def quaternion_yaw(q: Tuple[float, float, float, float]) -> float:
    """Yaw of a (w,x,y,z) quaternion: heading of the rotated x-axis."""
    w, x, y, z = q
    # Rotate [1,0,0]: vx = 1-2(y^2+z^2), vy = 2(xy+wz)
    return float(np.arctan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z)))


def angle_diff(a: float, b: float, period: float) -> float:
    """Smallest signed difference (a-b) modulo period, in (-period/2, period/2]."""
    diff = (a - b + period / 2) % period - period / 2
    if diff > np.pi:
        diff = diff - (2 * np.pi)
    return diff


def yaw_diff(gt: DetectionBox, pred: DetectionBox, period: float = 2 * np.pi) -> float:
    ya = quaternion_yaw(gt.rotation)
    yb = quaternion_yaw(pred.rotation)
    return float(abs(angle_diff(ya, yb, period)))


def attr_acc(gt: DetectionBox, pred: DetectionBox) -> float:
    """1 if attributes match, 0 if not, NaN when the GT has no attribute."""
    if gt.attribute_name == "":
        return float("nan")
    return float(gt.attribute_name == pred.attribute_name)


def cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs; all-NaN input -> ones."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    sums = np.nancumsum(x.astype(float))
    counts = np.cumsum(~np.isnan(x))
    return np.divide(sums, counts, out=np.zeros_like(sums), where=counts > 0)


# ---------------------------------------------------------------------------
# Metric data container.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MetricData:
    """Per-(class, dist_th) PR + TP-error curves on 101 recall points."""

    recall: np.ndarray
    precision: np.ndarray
    confidence: np.ndarray
    trans_err: np.ndarray
    vel_err: np.ndarray
    scale_err: np.ndarray
    orient_err: np.ndarray
    attr_err: np.ndarray

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls) -> "MetricData":
        return cls(
            recall=np.linspace(0, 1, NELEM),
            precision=np.zeros(NELEM),
            confidence=np.zeros(NELEM),
            trans_err=np.ones(NELEM),
            vel_err=np.ones(NELEM),
            scale_err=np.ones(NELEM),
            orient_err=np.ones(NELEM),
            attr_err=np.ones(NELEM),
        )

    def serialize(self) -> dict:
        return {
            "recall": self.recall.tolist(),
            "precision": self.precision.tolist(),
            "confidence": self.confidence.tolist(),
            "trans_err": self.trans_err.tolist(),
            "vel_err": self.vel_err.tolist(),
            "scale_err": self.scale_err.tolist(),
            "orient_err": self.orient_err.tolist(),
            "attr_err": self.attr_err.tolist(),
        }


def _conf_sort_indices(confs: List[float]) -> List[int]:
    """Reference tie-break: sorted((conf, idx)) ascending, reversed —
    equal confidences yield DESCENDING original index."""
    return [i for (_, i) in sorted((v, i) for (i, v) in enumerate(confs))][::-1]


def accumulate(
    gt_boxes: EvalBoxes,
    pred_boxes: EvalBoxes,
    class_name: Optional[str],
    dist_th: float,
) -> Tuple[float, MetricData]:
    """Greedy-match preds to GT and build interpolated PR/TP curves.

    class_name=None runs the reference's class-agnostic "object" mode
    (accumulate_object_class, eval_custom.py:542-707): every GT and every
    pred participates regardless of class, and the per-match NaN rules key
    off the matched GT's class.

    Returns (actual_max_recall, MetricData).
    """
    object_mode = class_name is None

    if object_mode:
        npos = len(gt_boxes.all)
    else:
        npos = sum(1 for b in gt_boxes.all if b.detection_name == class_name)
    if npos == 0:
        return 0.0, MetricData.no_predictions()

    if object_mode:
        preds = list(pred_boxes.all)
    else:
        preds = [b for b in pred_boxes.all if b.detection_name == class_name]
    confs = [b.detection_score for b in preds]

    tp: List[int] = []
    fp: List[int] = []
    conf: List[float] = []
    match_data: Dict[str, List[float]] = {
        "trans_err": [],
        "vel_err": [],
        "scale_err": [],
        "orient_err": [],
        "attr_err": [],
        "conf": [],
    }

    taken = set()
    for ind in _conf_sort_indices(confs):
        pred = preds[ind]
        min_dist = np.inf
        match_idx = None
        for gt_idx, gt in enumerate(gt_boxes[pred.sample_token]):
            if not object_mode and gt.detection_name != class_name:
                continue
            if (pred.sample_token, gt_idx) in taken:
                continue
            d = center_distance(gt, pred)
            if d < min_dist:
                min_dist = d
                match_idx = gt_idx

        if min_dist < dist_th:
            taken.add((pred.sample_token, match_idx))
            tp.append(1)
            fp.append(0)
            conf.append(pred.detection_score)

            gt = gt_boxes[pred.sample_token][match_idx]
            gt_name = gt.detection_name
            match_data["trans_err"].append(center_distance(gt, pred))
            if object_mode:
                # object mode NaN rules (eval_custom.py:632-649):
                vel = (
                    np.nan
                    if gt_name in ("traffic_cone", "barrier")
                    else velocity_l2(gt, pred)
                )
                orient = (
                    np.nan
                    if gt_name == "traffic_cone"
                    else yaw_diff(gt, pred, period=np.pi)  # always pi here
                )
                attr = (
                    np.nan
                    if gt_name in ("barrier", "traffic_cone")
                    else 1 - attr_acc(gt, pred)
                )
            else:
                vel = velocity_l2(gt, pred)
                period = np.pi if class_name == "barrier" else 2 * np.pi
                orient = yaw_diff(gt, pred, period=period)
                attr = 1 - attr_acc(gt, pred)
            match_data["vel_err"].append(vel)
            match_data["orient_err"].append(orient)
            match_data["scale_err"].append(1 - scale_iou(gt, pred))
            match_data["attr_err"].append(attr)
            match_data["conf"].append(pred.detection_score)
        else:
            tp.append(0)
            fp.append(1)
            conf.append(pred.detection_score)

    if len(match_data["trans_err"]) == 0:
        return 0.0, MetricData.no_predictions()

    tp_c = np.cumsum(tp).astype(float)
    fp_c = np.cumsum(fp).astype(float)
    conf_a = np.array(conf)

    prec = tp_c / (fp_c + tp_c)
    rec = tp_c / float(npos)
    rec_actual = float(np.max(rec))

    rec_interp = np.linspace(0, 1, NELEM)
    prec = np.interp(rec_interp, rec, prec, right=0)
    conf_a = np.interp(rec_interp, rec, conf_a, right=0)

    out_errs = {}
    for key in ("trans_err", "vel_err", "scale_err", "orient_err", "attr_err"):
        tmp = cummean(np.array(match_data[key]))
        out_errs[key] = np.interp(
            conf_a[::-1], np.array(match_data["conf"])[::-1], tmp[::-1]
        )[::-1]

    return rec_actual, MetricData(
        recall=rec_interp,
        precision=prec,
        confidence=conf_a,
        trans_err=out_errs["trans_err"],
        vel_err=out_errs["vel_err"],
        scale_err=out_errs["scale_err"],
        orient_err=out_errs["orient_err"],
        attr_err=out_errs["attr_err"],
    )


def calc_ap(md: MetricData, min_recall: float, min_precision: float) -> float:
    """Clipped-interpolated AP (devkit calc_ap semantics)."""
    assert 0 <= min_precision < 1
    assert 0 <= min_recall <= 1
    prec = np.copy(md.precision)
    prec = prec[round(100 * min_recall) + 1 :]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: MetricData, min_recall: float, metric_name: str) -> float:
    """Mean TP error over achieved recall range (devkit calc_tp semantics)."""
    first_ind = round(100 * min_recall) + 1
    last_ind = md.max_recall_ind
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(getattr(md, metric_name)[first_ind : last_ind + 1]))

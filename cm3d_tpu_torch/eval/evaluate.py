"""DetectionEval orchestration: filtering, accumulation, metric aggregation.

Behavioral contract: reference DetectionEval (src/nuscenes/eval_custom.py:
866-1155) and its filter_eval_boxes (:441-535). Data access is decoupled:
this module receives plain EvalBoxes + per-sample ego poses + optional map
geometry, so it runs hermetically (tests) or from the nuScenes frontend.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cm3d_tpu_torch.eval.algo import MetricData, accumulate, calc_ap, calc_tp
from cm3d_tpu_torch.eval.boxes import EvalBoxes, add_center_dist_from_poses
from cm3d_tpu_torch.eval.config import TP_METRICS, DetectionEvalConfig


def point_in_polygon(x: float, y: float, ring: np.ndarray) -> bool:
    """Ray-casting point-in-polygon on an [N, 2] exterior ring."""
    xs, ys = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(xs, -1), np.roll(ys, -1)
    crosses = ((ys > y) != (y2 > y)) & (
        x < (x2 - xs) * (y - ys) / np.where(y2 == ys, np.inf, y2 - ys) + xs
    )
    return bool(np.count_nonzero(crosses) % 2)


@dataclasses.dataclass
class MapGeometry:
    """Pre-extracted map geometry for drivable-area filtering.

    Each polygon is (exterior [N,2], [holes [M,2], ...]).
    """

    drivable_polygons: List[Tuple[np.ndarray, List[np.ndarray]]]

    def contains(self, x: float, y: float) -> bool:
        for exterior, holes in self.drivable_polygons:
            if point_in_polygon(x, y, exterior):
                if not any(point_in_polygon(x, y, h) for h in holes):
                    return True
        return False


def points_in_box_3d(
    center: Sequence[float],
    size: Sequence[float],
    rotation_wxyz: Sequence[float],
    points_xyz: np.ndarray,
) -> np.ndarray:
    """Axis test in the box frame (devkit points_in_box semantics);
    size is (w, l, h): x extent = l, y extent = w, z extent = h."""
    w, x, y, z = rotation_wxyz
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    local = (points_xyz - np.asarray(center)[None, :]) @ rot
    wd, ld, hd = size
    return (
        (np.abs(local[:, 0]) <= ld / 2)
        & (np.abs(local[:, 1]) <= wd / 2)
        & (np.abs(local[:, 2]) <= hd / 2)
    )


def filter_eval_boxes(
    eval_boxes: EvalBoxes,
    max_dist: Dict[str, float],
    bikerack_boxes: Optional[Dict[str, List[dict]]] = None,
    map_geometry: Optional[MapGeometry] = None,
    verbose: bool = False,
) -> EvalBoxes:
    """Distance, num_pts, bike-rack and (optional) drivable-area filters
    (reference filter_eval_boxes, eval_custom.py:441-535).

    bikerack_boxes: sample_token -> list of {"translation", "size",
    "rotation"} dicts for static_object.bicycle_rack annotations.
    map_geometry: when given, keep only boxes whose center is inside the
    drivable area (the reference resolves ONE map for the whole box set from
    its first sample — we take explicit geometry instead).
    """
    total, dist_f, pts_f, rack_f, driv_f = 0, 0, 0, 0, 0
    for token in eval_boxes.sample_tokens:
        total += len(eval_boxes[token])
        eval_boxes.boxes[token] = [
            b for b in eval_boxes[token] if b.ego_dist < max_dist[b.detection_name]
        ]
        dist_f += len(eval_boxes[token])

        eval_boxes.boxes[token] = [b for b in eval_boxes[token] if b.num_pts != 0]
        pts_f += len(eval_boxes[token])

        racks = (bikerack_boxes or {}).get(token, [])
        if racks:
            kept = []
            for b in eval_boxes[token]:
                if b.detection_name in ("bicycle", "motorcycle"):
                    in_rack = any(
                        points_in_box_3d(
                            r["translation"],
                            r["size"],
                            r["rotation"],
                            np.asarray(b.translation)[None, :],
                        ).any()
                        for r in racks
                    )
                    if not in_rack:
                        kept.append(b)
                else:
                    kept.append(b)
            eval_boxes.boxes[token] = kept
        rack_f += len(eval_boxes[token])

    if verbose:
        print("> Original number of boxes: %d" % total)
        print("> After distance based filtering: %d" % dist_f)
        print("> After LIDAR and RADAR points based filtering: %d" % pts_f)
        print("> After bike rack filtering: %d" % rack_f)

    if map_geometry is not None:
        for token in eval_boxes.sample_tokens:
            eval_boxes.boxes[token] = [
                b
                for b in eval_boxes[token]
                if map_geometry.contains(b.translation[0], b.translation[1])
            ]
            driv_f += len(eval_boxes[token])
        if verbose:
            print("> After drivable area filtering: %d" % driv_f)

    return eval_boxes


@dataclasses.dataclass
class DetectionMetrics:
    """Aggregated metrics (devkit DetectionMetrics serialization contract)."""

    cfg: DetectionEvalConfig
    label_aps: Dict[str, Dict[float, float]] = dataclasses.field(default_factory=dict)
    label_tp_errors: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    eval_time: float = 0.0

    def add_label_ap(self, name: str, dist_th: float, ap: float) -> None:
        self.label_aps.setdefault(name, {})[dist_th] = ap

    def add_label_tp(self, name: str, metric: str, tp: float) -> None:
        self.label_tp_errors.setdefault(name, {})[metric] = tp

    @property
    def mean_dist_aps(self) -> Dict[str, float]:
        return {n: float(np.mean(list(d.values()))) for n, d in self.label_aps.items()}

    @property
    def mean_ap(self) -> float:
        vals = list(self.mean_dist_aps.values())
        return float(np.mean(vals)) if vals else 0.0

    @property
    def tp_errors(self) -> Dict[str, float]:
        out = {}
        for metric in TP_METRICS:
            errs = [self.label_tp_errors[n][metric] for n in self.label_tp_errors]
            out[metric] = float(np.nanmean(errs)) if errs else np.nan
        return out

    @property
    def tp_scores(self) -> Dict[str, float]:
        return {m: max(0.0, 1.0 - e) for m, e in self.tp_errors.items()}

    @property
    def nd_score(self) -> float:
        total = self.cfg.mean_ap_weight * self.mean_ap + float(
            np.nansum(list(self.tp_scores.values()))
        )
        return total / (self.cfg.mean_ap_weight + len(TP_METRICS))

    def serialize(self) -> dict:
        return {
            "label_aps": {n: dict(d) for n, d in self.label_aps.items()},
            "mean_dist_aps": self.mean_dist_aps,
            "mean_ap": self.mean_ap,
            "label_tp_errors": {n: dict(d) for n, d in self.label_tp_errors.items()},
            "tp_errors": self.tp_errors,
            "tp_scores": self.tp_scores,
            "nd_score": self.nd_score,
            "eval_time": self.eval_time,
            "cfg": self.cfg.serialize(),
        }


def evaluate_boxes(
    gt_boxes: EvalBoxes,
    pred_boxes: EvalBoxes,
    cfg: DetectionEvalConfig,
    object_only: bool = False,
    verbose: bool = False,
) -> Tuple[DetectionMetrics, Dict, List[float]]:
    """Accumulate + aggregate (reference DetectionEval.evaluate,
    eval_custom.py:953-1043). Returns (metrics, metric_data_list, recall_list).
    """
    start = time.time()
    metric_data: Dict[Tuple[str, float], MetricData] = {}
    recall_list: List[float] = []

    names = ["object"] if object_only else cfg.class_names
    for name in names:
        class_arg = None if object_only else name
        recs = []
        for dist_th in cfg.dist_ths:
            rec, md = accumulate(gt_boxes, pred_boxes, class_arg, dist_th)
            metric_data[(name, dist_th)] = md
            recs.append(rec)
        recall_list.append(sum(recs) / len(recs))

    metrics = DetectionMetrics(cfg)
    for name in names:
        for dist_th in cfg.dist_ths:
            ap = calc_ap(metric_data[(name, dist_th)], cfg.min_recall, cfg.min_precision)
            metrics.add_label_ap(name, dist_th, ap)
        for metric_name in TP_METRICS:
            md = metric_data[(name, cfg.dist_th_tp)]
            if not object_only and name == "traffic_cone" and metric_name in (
                "attr_err",
                "vel_err",
                "orient_err",
            ):
                tp = np.nan
            elif not object_only and name == "barrier" and metric_name in (
                "attr_err",
                "vel_err",
            ):
                tp = np.nan
            else:
                tp = calc_tp(md, cfg.min_recall, metric_name)
            metrics.add_label_tp(name, metric_name, tp)

    metrics.eval_time = time.time() - start
    return metrics, metric_data, recall_list


_ERR_NAME_MAPPING = {
    "trans_err": "mATE",
    "scale_err": "mASE",
    "orient_err": "mAOE",
    "vel_err": "mAVE",
    "attr_err": "mAAE",
}


class DetectionEval:
    """Full evaluation over pre-loaded boxes.

    Mirrors reference DetectionEval (eval_custom.py:866-1155) minus the
    devkit data access: callers supply GT/pred boxes, per-sample ego poses,
    and optional bike-rack/map geometry (see cm3d_tpu_torch.datasets.nuscenes for
    the table-backed loaders).
    """

    def __init__(
        self,
        gt_boxes: EvalBoxes,
        pred_boxes: EvalBoxes,
        cfg: DetectionEvalConfig,
        ego_translations: Dict[str, Sequence[float]],
        output_dir: Optional[str] = None,
        bikerack_boxes: Optional[Dict[str, List[dict]]] = None,
        map_geometry: Optional[MapGeometry] = None,
        drivable_filtering: bool = False,
        object_only: bool = False,
        meta: Optional[dict] = None,
        verbose: bool = True,
    ):
        self.cfg = cfg
        self.output_dir = output_dir
        self.object_only = object_only
        self.meta = meta or {}
        self.verbose = verbose

        pred_boxes = add_center_dist_from_poses(pred_boxes, ego_translations)
        gt_boxes = add_center_dist_from_poses(gt_boxes, ego_translations)
        self.ego_translations = dict(ego_translations)

        geom = map_geometry if drivable_filtering else None
        if verbose:
            print("Filtering predictions")
        self.pred_boxes = filter_eval_boxes(
            pred_boxes, cfg.class_range, bikerack_boxes, geom, verbose
        )
        if verbose:
            print("Filtering ground truth annotations")
        self.gt_boxes = filter_eval_boxes(
            gt_boxes, cfg.class_range, bikerack_boxes, geom, verbose
        )
        self.sample_tokens = self.gt_boxes.sample_tokens

    def main(self, render_curves: bool = False, plot_examples: int = 0,
             points_provider=None) -> dict:
        if plot_examples > 0 and self.output_dir:
            # reference example visualizations (eval_custom.py:1080-1097):
            # fixed random subset (seed 42), {output_dir}/examples/{token}.png
            from cm3d_tpu_torch.eval.render import plot_examples as _examples

            if self.verbose:
                print(f"Rendering {plot_examples} example visualizations")
            _examples(
                self.gt_boxes, self.pred_boxes, self.sample_tokens,
                self.ego_translations, plot_examples,
                max(self.cfg.class_range.values()), self.output_dir,
                points_provider=points_provider,
            )
        metrics, metric_data, recall_list = evaluate_boxes(
            self.gt_boxes,
            self.pred_boxes,
            self.cfg,
            object_only=self.object_only,
            verbose=self.verbose,
        )

        summary = metrics.serialize()
        summary["meta"] = dict(self.meta)
        if render_curves and self.output_dir:
            # reference plots-dir layout (eval_custom.py:917-921,1045-1068)
            from cm3d_tpu_torch.eval.render import render_curves as _render

            if self.verbose:
                print("Rendering PR and TP curves")
            _render(
                metric_data, metrics, self.cfg,
                os.path.join(self.output_dir, "plots"),
                object_only=self.object_only,
            )
        if self.output_dir:
            os.makedirs(self.output_dir, exist_ok=True)
            with open(os.path.join(self.output_dir, "metrics_summary.json"), "w") as f:
                json.dump(summary, f, indent=2)
            with open(os.path.join(self.output_dir, "metrics_details.json"), "w") as f:
                json.dump(
                    {
                        f"{n}:{d}": md.serialize()
                        for (n, d), md in metric_data.items()
                    },
                    f,
                    indent=2,
                )

        # Same stdout contract as the reference (eval_custom.py:1122-1151).
        print("mAP: %.4f" % summary["mean_ap"])
        for tp_name, tp_val in summary["tp_errors"].items():
            print("%s: %.4f" % (_ERR_NAME_MAPPING[tp_name], tp_val))
        print("mRec: %.4f" % (sum(recall_list) / len(recall_list)))
        print("NDS: %.4f" % summary["nd_score"])
        print("Eval time: %.1fs" % summary["eval_time"])
        print()
        print("Per-class results:")
        print(
            "%-20s\t%-6s\t%-6s\t%-6s\t%-6s\t%-6s\t%-6s\t%-6s"
            % ("Object Class", "AP", "ATE", "ASE", "AOE", "AVE", "AAE", "avgRec")
        )
        class_aps = summary["mean_dist_aps"]
        class_tps = summary["label_tp_errors"]
        for i, name in enumerate(class_aps.keys()):
            print(
                "%-20s\t%-6.3f\t%-6.3f\t%-6.3f\t%-6.3f\t%-6.3f\t%-6.3f\t%-6.3f"
                % (
                    name,
                    class_aps[name],
                    class_tps[name]["trans_err"],
                    class_tps[name]["scale_err"],
                    class_tps[name]["orient_err"],
                    class_tps[name]["vel_err"],
                    class_tps[name]["attr_err"],
                    recall_list[i],
                )
            )
        summary["recall_list"] = recall_list
        return summary

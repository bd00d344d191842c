"""Late fusion with SAM3D predictions: Hungarian matching + alpha grid search.
Mirrors `cm3d_tpu/pipelines/fusion.py` (host numpy and scipy, on the port's
eval and native Waymo metrics).

Rebuild of the reference's linear_matching (src/nuscenes/linear_matching.py
and src/waymo/linear_matching.py): match CM3D boxes with SAM3D boxes per
frame (Hungarian, BEV IoU 0.2), grid-search a confidence scale alpha for the
SAM3D scores, merge (matched pairs keep the higher-scored geometry but
ALWAYS the CM3D class/attribute; unmatched boxes pass through, SAM3D ones
rescaled), evaluate each alpha, keep the best.

Reference quirks reproduced on purpose:
- 7-DoF matching boxes [cx, cy, bottom_z, size_w, size_l, h, heading]; the
  TF op's "length" slot receives size[0] (nuScenes width) — reproduced by
  placing size[0] in our along-heading slot (nuscenes/linear_matching.py:
  164-172).
- heading extracted via scipy from_quat fed the (w,x,y,z) list in the
  (x,y,z,w) slot — the same quirk as push_centroid (:170).
- alpha grid: arange(pred_min/sam3d_max, pred_max/sam3d_min, 0.04) (:270-276);
  the Waymo variant extends the stop by one step, reverses, and drops the
  three largest alphas (waymo/linear_matching.py:317-325).
- zero scores are excluded from the MIN confidence for SAM3D only
  (:186-189); pred mins update unconditionally (:224-228).
- merged SAM3D scores clipped to [0, 1] (:349,397).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from cm3d_tpu_torch.eval.waymo_metrics import hungarian_match


def _heading_from_quat_quirk(rotation_wxyz) -> float:
    """Literal reproduction of `R.from_quat(rotation).as_euler('xyz')[0]`
    on a (w, x, y, z) list (reference :170,209)."""
    from scipy.spatial.transform import Rotation as R

    return float(R.from_quat(list(rotation_wxyz)).as_euler("xyz")[0])


def _yaw_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def submission_to_7dof(submission: dict, exclude_zero_min: bool = False):
    """Per-sample [N, 7] matcher boxes + supp lists (attr, score, vel, name).

    Matcher layout (see module docstring): [cx, cy, bottom_z,
    across=size1, along=size0, h, heading_quirk].

    exclude_zero_min: the reference skips zero scores when updating the
    MIN confidence for SAM3D only ("Box score is zero, omitting",
    :186-189); the prediction min updates unconditionally (:224-228), so
    a zero-scored pred box pins the alpha-grid start at 0.
    """
    box_dict: Dict[str, List[np.ndarray]] = {}
    supp_dict: Dict[str, List[list]] = {}
    cmin, cmax = 1e7, -1e7
    for sample, objs in submission["results"].items():
        box_dict.setdefault(sample, [])
        supp_dict.setdefault(sample, [])
        for obj in objs:
            heading = _heading_from_quat_quirk(obj["rotation"])
            box_dict[sample].append(
                np.array(
                    [
                        obj["translation"][0],
                        obj["translation"][1],
                        obj["translation"][2] - obj["size"][2] / 2,
                        obj["size"][1],  # across-heading slot
                        obj["size"][0],  # along-heading slot (reference quirk)
                        obj["size"][2],
                        heading,
                    ],
                    float,
                )
            )
            supp_dict[sample].append(
                [
                    obj["attribute_name"],
                    obj["detection_score"],
                    obj.get("velocity", [0, 0]),
                    obj["detection_name"],
                ]
            )
            s = obj["detection_score"]
            cmax = max(cmax, s)
            if s != 0 or not exclude_zero_min:
                cmin = min(cmin, s)
    return box_dict, supp_dict, cmin, cmax


def compute_matches(pred_boxes, sam3d_boxes, iou: float = 0.2):
    """Per-sample Hungarian matches (reference :268-297)."""
    pred_m: Dict[str, List[int]] = {}
    sam_m: Dict[str, List[int]] = {}
    for ts in pred_boxes:
        pred_m[ts] = []
        sam_m[ts] = []
        if ts not in sam3d_boxes or not sam3d_boxes[ts] or not pred_boxes[ts]:
            continue
        pi, gi, _ = hungarian_match(
            np.stack(pred_boxes[ts]), np.stack(sam3d_boxes[ts]), iou,
            mode_2d=True,
        )
        pred_m[ts] = [int(i) for i in pi]
        sam_m[ts] = [int(i) for i in gi]
    return pred_m, sam_m


def _box_dict_from_7dof(sample, box7, name, score, attr):
    """Matcher 7-DoF back to a submission dict (reference :303-327).

    The in-conversion put size[1] in slot 3 and size[0] in slot 4 (the
    matcher quirk, see submission_to_7dof); the reference's slots hold
    size[0], size[1] and it writes them back in slot order (:321-324), so
    restoring the original [w, l, h] here means reading slot 4 first."""
    heading = float(box7[6])
    return {
        "sample_token": sample,
        "translation": [
            float(box7[0]), float(box7[1]), float(box7[2]) + float(box7[5]) / 2
        ],
        "size": [float(box7[4]), float(box7[3]), float(box7[5])],
        "rotation": _yaw_quat(heading),
        "velocity": [0, 0],
        "detection_name": name,
        "detection_score": score,
        "attribute_name": attr,
    }


def merge_for_alpha(
    alpha: float,
    pred_boxes, pred_supp, sam_boxes, sam_supp, pred_m, sam_m,
) -> dict:
    """One alpha's merged submission (reference :326-463)."""
    merged = {
        "meta": {
            "use_camera": True, "use_lidar": True, "use_radar": False,
            "use_map": True, "use_external": False,
        },
        "results": {},
    }

    def add(sample, d):
        merged["results"].setdefault(sample, []).append(d)

    pred_matched = {ts: set(v) for ts, v in pred_m.items()}
    sam_matched = {ts: set(v) for ts, v in sam_m.items()}

    for ts, boxes in pred_boxes.items():
        for i, b in enumerate(boxes):
            if i in pred_matched.get(ts, ()):
                continue
            s = pred_supp[ts][i]
            add(ts, _box_dict_from_7dof(ts, b, s[3], s[1], s[0]))

    for ts, boxes in sam_boxes.items():
        for i, b in enumerate(boxes):
            if i in sam_matched.get(ts, ()):
                continue
            s = sam_supp[ts][i]
            add(ts, _box_dict_from_7dof(
                ts, b, s[3], float(np.clip(s[1] * alpha, 0, 1)), s[0]
            ))

    for ts in pred_m:
        for k, pred_id in enumerate(pred_m[ts]):
            sam_id = sam_m[ts][k]
            pb, sb = pred_boxes[ts][pred_id], sam_boxes[ts][sam_id]
            ps, ss = pred_supp[ts][pred_id], sam_supp[ts][sam_id]
            sam_score = ss[1] * alpha
            if sam_score > ps[1]:
                # SAM3D geometry, CM3D class/attribute (reference :390-410)
                add(ts, _box_dict_from_7dof(
                    ts, sb, ps[3], float(np.clip(sam_score, 0, 1)), ps[0]
                ))
            else:
                add(ts, _box_dict_from_7dof(ts, pb, ps[3], ps[1], ps[0]))
    return merged


def _check_conf_extrema(pred_min, pred_max, sam_min, sam_max):
    """Degenerate submissions must fail with the diagnostic the callers
    promise, not a ZeroDivisionError (all-zero SAM3D scores leave
    sam_max=0 under exclude_zero_min) or a meaningless one-point grid
    (an EMPTY submission leaves the 1e7/-1e7 sentinels, whose ratio
    sneaks past the not-alphas guard)."""
    if (pred_min > pred_max or sam_min > sam_max
            or sam_max <= 0 or sam_min <= 0):
        raise SystemExit(
            f"degenerate confidence extrema (pred [{pred_min}, {pred_max}]"
            f", sam3d [{sam_min}, {sam_max}]) — empty submission or "
            "all-zero SAM3D scores; nothing to alpha-search"
        )


def alpha_grid(pred_min, pred_max, sam_min, sam_max, step: float = 0.04):
    """nuScenes grid (reference nuscenes/linear_matching.py:270-276):
    arange with an EXCLUSIVE stop at pred_max/sam_min."""
    _check_conf_extrema(pred_min, pred_max, sam_min, sam_max)
    return list(np.arange(pred_min / sam_max, pred_max / sam_min, step))


def alpha_grid_waymo(pred_min, pred_max, sam_min, sam_max,
                     step: float = 0.04):
    """Waymo grid quirks (reference waymo/linear_matching.py:317-325):
    the stop is pred_max/sam_min + step (one extra point vs nuScenes),
    then the list is REVERSED and its first three entries (the three
    largest alphas) dropped — search order matters because ties keep the
    first-seen best."""
    _check_conf_extrema(pred_min, pred_max, sam_min, sam_max)
    full = np.arange(pred_min / sam_max, pred_max / sam_min + step, step)
    return list(full)[::-1][3:]


def run_fusion_nuscenes(
    pred_json: str,
    sam3d_json: str,
    gt_json: str,
    out_path: str,
    object_only: bool = False,
    verbose: bool = True,
) -> Tuple[float, float]:
    """Full nuScenes alpha search; GT in the hermetic eval format.
    Returns (best_alpha, best_mAP); best merged submission at out_path."""
    from cm3d_tpu_torch.eval import DETECTION_CVPR_2019
    from cm3d_tpu_torch.eval.boxes import EvalBoxes
    from cm3d_tpu_torch.eval.evaluate import DetectionEval

    with open(pred_json) as f:
        pred = json.load(f)
    with open(sam3d_json) as f:
        sam3d = json.load(f)
    with open(gt_json) as f:
        gt_data = json.load(f)

    pred_boxes, pred_supp, pmin, pmax = submission_to_7dof(pred)
    sam_boxes, sam_supp, smin, smax = submission_to_7dof(
        sam3d, exclude_zero_min=True
    )
    pred_m, sam_m = compute_matches(pred_boxes, sam_boxes)

    import contextlib
    import io

    # GT parsing hoisted out of the loop: add_center_dist and the range
    # filter are idempotent on the same values, so every alpha sees the
    # same GT (the per-alpha work is the merged-pred side only)
    ego_translations = {
        t: tuple(v) for t, v in gt_data["ego_translations"].items()
    }
    gt_boxes = EvalBoxes.deserialize(gt_data["boxes"])

    alphas = alpha_grid(pmin, pmax, smin, smax)
    if not alphas:
        raise SystemExit(
            f"empty alpha grid (pred conf [{pmin}, {pmax}], sam3d conf "
            f"[{smin}, {smax}]) — empty or degenerate submissions"
        )
    best_alpha, best_score, best_merged = 0.0, -1.0, None
    for alpha in alphas:
        merged = merge_for_alpha(
            alpha, pred_boxes, pred_supp, sam_boxes, sam_supp, pred_m, sam_m
        )
        ev = DetectionEval(
            gt_boxes=gt_boxes,
            pred_boxes=EvalBoxes.deserialize(merged["results"]),
            cfg=DETECTION_CVPR_2019,
            ego_translations=ego_translations,
            # same hermetic-GT contract as the eval CLI (__main__.py:95):
            # without it the per-alpha scores here would differ from
            # `python -m cm3d_tpu_torch.eval` on identical inputs whenever the
            # GT carries bike-rack geometry (rack filtering is idempotent,
            # so the hoisted shared gt_boxes stays valid across alphas)
            bikerack_boxes=gt_data.get("bikerack_boxes"),
            object_only=object_only,
            verbose=False,
        )
        with contextlib.redirect_stdout(io.StringIO()):
            summary = ev.main()
        score = float(summary["mean_ap"])
        if score > best_score:
            best_score, best_alpha, best_merged = score, alpha, merged
        if verbose:
            print(f"Curr Score: {score},  Curr Alpha: {alpha}")
            print(f"Best Score: {best_score}, Best Alpha: {best_alpha}")
    with open(out_path, "w") as f:
        json.dump(best_merged, f)
    return best_alpha, best_score


def _objects_to_frames(objs, exclude_zero_min: bool = False):
    """Waymo objects grouped by (context, timestamp) into matcher arrays.

    supp rows follow the reference layout [context, score, object id,
    type] (waymo/linear_matching.py:198-205,241-248) — ids are preserved
    through the merge. exclude_zero_min: like the nuScenes side, the
    reference skips zero scores only for the SAM3D min (:211-214); the
    pred min updates unconditionally (:251-254)."""
    box_dict, supp_dict = {}, {}
    cmin, cmax = 1e7, -1e7
    for o in objs:
        key = f"{o.context_name}|{o.frame_timestamp_micros}"
        box_dict.setdefault(key, []).append(
            np.array(
                [o.box.center_x, o.box.center_y, o.box.center_z - o.box.height / 2,
                 o.box.width, o.box.length, o.box.height, o.box.heading],
                float,
            )
        )
        supp_dict.setdefault(key, []).append(
            [o.context_name, o.score, o.id, o.type]
        )
        cmax = max(cmax, o.score)
        if o.score != 0 or not exclude_zero_min:
            cmin = min(cmin, o.score)
    return box_dict, supp_dict, cmin, cmax


def run_fusion_waymo(
    pred_bin: str,
    sam3d_bin: str,
    gt_bin: str,
    out_path: str,
    verbose: bool = True,
) -> Tuple[float, float]:
    """Waymo alpha search evaluated by the native metrics binary
    (reference waymo/linear_matching.py:168-542). Returns
    (best_alpha, best Overall/L2 mAP)."""
    import tempfile

    from cm3d_tpu_torch.datasets.waymo.proto import (
        WaymoBox, WaymoObject, decode_objects, encode_objects,
    )
    from cm3d_tpu_torch.eval.waymo_metrics import run_detection_metrics

    with open(pred_bin, "rb") as f:
        pred = decode_objects(f.read())
    with open(sam3d_bin, "rb") as f:
        sam3d = decode_objects(f.read())
    pred_boxes, pred_supp, pmin, pmax = _objects_to_frames(pred)
    sam_boxes, sam_supp, smin, smax = _objects_to_frames(
        sam3d, exclude_zero_min=True
    )
    pred_m, sam_m = compute_matches(pred_boxes, sam_boxes)
    pred_matched = {ts: set(v) for ts, v in pred_m.items()}
    sam_matched = {ts: set(v) for ts, v in sam_m.items()}

    def to_objects(merged_rows):
        out = []
        for key, rows in merged_rows.items():
            ctx, ts = key.rsplit("|", 1)
            for b, typ, score, oid in rows:
                out.append(
                    WaymoObject(
                        box=WaymoBox(
                            center_x=float(b[0]), center_y=float(b[1]),
                            center_z=float(b[2]) + float(b[5]) / 2,
                            width=float(b[3]), length=float(b[4]),
                            height=float(b[5]), heading=float(b[6]),
                        ),
                        type=int(typ), score=float(score),
                        frame_timestamp_micros=int(ts), context_name=ctx,
                        id=str(oid),
                    )
                )
        return out

    alphas = alpha_grid_waymo(pmin, pmax, smin, smax)
    if not alphas:
        raise SystemExit(
            f"empty alpha grid (pred conf [{pmin}, {pmax}], sam3d conf "
            f"[{smin}, {smax}]) — empty or degenerate prediction bins"
        )
    best_alpha, best_score, best_bytes = 0.0, -1.0, b""
    for alpha in alphas:
        rows: Dict[str, list] = {}

        def add(key, b, typ, score, oid):
            rows.setdefault(key, []).append((b, typ, score, oid))

        for ts, boxes in pred_boxes.items():
            for i, b in enumerate(boxes):
                if i not in pred_matched.get(ts, ()):
                    s = pred_supp[ts][i]
                    add(ts, b, s[3], s[1], s[2])
        for ts, boxes in sam_boxes.items():
            for i, b in enumerate(boxes):
                if i not in sam_matched.get(ts, ()):
                    s = sam_supp[ts][i]
                    add(ts, b, s[3], float(np.clip(s[1] * alpha, 0, 1)),
                        s[2])
        for ts in pred_m:
            for k, pred_id in enumerate(pred_m[ts]):
                sam_id = sam_m[ts][k]
                ps, ss = pred_supp[ts][pred_id], sam_supp[ts][sam_id]
                if ss[1] * alpha > ps[1]:
                    add(ts, sam_boxes[ts][sam_id], ps[3],
                        float(np.clip(ss[1] * alpha, 0, 1)), ss[2])
                else:
                    # reference quirk (:458): the pred-wins id indexes the
                    # PRED supp list with the SAM3D id; out of range would
                    # crash there — fall back to the pred's own id
                    # (documented deviation)
                    supp = pred_supp[ts]
                    oid = (supp[sam_id][2] if sam_id < len(supp)
                           else ps[2])
                    add(ts, pred_boxes[ts][pred_id], ps[3], ps[1], oid)

        buf = encode_objects(to_objects(rows))
        with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as tf_:
            tf_.write(buf)
            tmp = tf_.name
        try:
            _, ap = run_detection_metrics(tmp, gt_bin)
        finally:
            os.unlink(tmp)
        score = ap["Overall/L2 mAP"]
        if score > best_score:
            best_score, best_alpha, best_bytes = score, alpha, buf
        if verbose:
            print(f"Curr Score: {score},  Curr Alpha: {alpha}")
            print(f"Best Score: {best_score}, Best Alpha: {best_alpha}")
    with open(out_path, "wb") as f:
        f.write(best_bytes)
    return best_alpha, best_score


def main(argv=None):
    """CLI: reference linear_matching __main__ for both datasets (host
    only, no device)."""
    import argparse

    p = argparse.ArgumentParser(description="CM3D + SAM3D late fusion")
    sub = p.add_subparsers(dest="dataset", required=True)

    pn = sub.add_parser("nuscenes")
    pn.add_argument("--pred", required=True, help="CM3D submission JSON")
    pn.add_argument("--sam3d", required=True, help="SAM3D submission JSON")
    pn.add_argument("--gt_json", required=True, help="hermetic GT file")
    pn.add_argument("--out", default="best_matched_pseudolabels.json")
    pn.add_argument("--object_only", type=int, default=0)

    pw = sub.add_parser("waymo")
    pw.add_argument("--pred", required=True, help="CM3D pred .bin")
    pw.add_argument("--sam3d", required=True, help="SAM3D pred .bin")
    pw.add_argument("--gt", required=True, help="GT .bin")
    pw.add_argument("--out", default="best_matched_pseudolabels.bin")

    args = p.parse_args(argv)
    if args.dataset == "nuscenes":
        alpha, score = run_fusion_nuscenes(
            args.pred, args.sam3d, args.gt_json, args.out,
            object_only=bool(args.object_only),
        )
    else:
        alpha, score = run_fusion_waymo(args.pred, args.sam3d, args.gt, args.out)
    print(f"Best Score: {score}, Best Alpha: {alpha}")


if __name__ == "__main__":
    main()

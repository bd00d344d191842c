"""Detection-eval CLI (reference eval_custom.py argparse main, :1164-1215).

Two GT sources:
  --gt_json: hermetic mode — a JSON file {"ego_translations": {token: [x,y,z]},
    "boxes": {token: [DetectionBox dicts]}} (used by tests/CI and by the
    fusion alpha search).
  --dataroot/--version/--eval_set: nuScenes table mode (loads GT through
    cm3d_tpu_torch.datasets.nuscenes).

Usage:
  python -m cm3d_tpu_torch.eval RESULTS.json --gt_json GT.json [--object_only 1]
"""

from __future__ import annotations

import argparse
import json
import os

from cm3d_tpu_torch.eval.boxes import EvalBoxes, load_prediction
from cm3d_tpu_torch.eval.config import (
    DETECTION_CVPR_2019,
    RARE_CONFIG,
    DetectionEvalConfig,
)
from cm3d_tpu_torch.eval.evaluate import DetectionEval


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Evaluate nuScenes-format detection results.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("result_path", type=str, help="submission JSON")
    parser.add_argument("--output_dir", type=str, default="./nuscenes-metrics")
    parser.add_argument("--eval_set", type=str, default="val",
                        help="split name (val, val25, mini_val, train25, "
                        "train_detect50, ...), 'all', or comma-separated "
                        "scene names")
    parser.add_argument("--splits_json", type=str, default="",
                        help="JSON overriding/providing split scene lists "
                        "(required for train_detect*)")
    parser.add_argument("--dataroot", type=str, default="")
    parser.add_argument("--version", type=str, default="v1.0-trainval")
    parser.add_argument("--gt_json", type=str, default="",
                        help="hermetic GT file (see module docstring)")
    parser.add_argument("--config_path", type=str, default="",
                        help="DetectionEvalConfig JSON; '' = cvpr_2019, "
                        "'rare' = rare-class config")
    parser.add_argument("--verbose", type=int, default=1)
    parser.add_argument("--drivable_filtering", type=int, default=0)
    parser.add_argument("--object_only", type=int, default=0)
    parser.add_argument("--render_curves", type=int, default=0,
                        help="write summary/per-class PR+TP/dist_pr plots "
                        "to {output_dir}/plots (reference :1172-1177)")
    parser.add_argument("--plot_examples", type=int, default=0,
                        help="write N example-sample BEV visualizations to "
                        "{output_dir}/examples (reference :1181; its CLI "
                        "default is 10 — opt-in here)")
    args = parser.parse_args(argv)

    if args.config_path == "":
        cfg = DETECTION_CVPR_2019
    elif args.config_path == "rare":
        cfg = RARE_CONFIG
    else:
        with open(args.config_path) as f:
            cfg = DetectionEvalConfig.deserialize(json.load(f))

    pred_boxes, meta = load_prediction(
        os.path.expanduser(args.result_path), cfg.max_boxes_per_sample
    )

    if args.gt_json:
        if args.drivable_filtering:
            raise SystemExit(
                "--drivable_filtering needs the map tables; hermetic "
                "--gt_json mode has none — run with --dataroot instead"
            )
        with open(os.path.expanduser(args.gt_json)) as f:
            gt_data = json.load(f)
        gt_boxes = EvalBoxes.deserialize(gt_data["boxes"])
        ego_translations = {
            t: tuple(v) for t, v in gt_data["ego_translations"].items()
        }
        missing = [t for t in pred_boxes.sample_tokens
                   if t not in ego_translations]
        if missing:
            raise SystemExit(
                f"--gt_json: {len(missing)} prediction sample_token(s) have "
                f"no ego_translations entry (e.g. {missing[0]!r}); hermetic "
                "mode cannot look poses up — add them to the GT file or "
                "filter the submission"
            )
        bikeracks = gt_data.get("bikerack_boxes")
        map_geometry = None
    else:
        from cm3d_tpu_torch.datasets.nuscenes import load_gt_for_eval
        from cm3d_tpu_torch.datasets.nuscenes.splits import resolve_eval_set
        from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables

        # one eager table parse shared by split resolution, GT loading and
        # (optionally) the example-plot points frontend below
        eval_tables = NuScenesTables(args.dataroot, args.version)
        table_scene_names = [s["name"] for s in eval_tables.table("scene")]
        scenes = resolve_eval_set(
            args.eval_set, table_scene_names, args.splits_json or None
        )
        gt_boxes, ego_translations, bikeracks, map_geometry = load_gt_for_eval(
            args.dataroot,
            args.version,
            eval_split_scenes=scenes,
            # rare mode iff the config actually evaluates the rare classes
            # (a class-COUNT heuristic misrouted custom 11+-class configs
            # into the child/stroller GT mapping, then filter_eval_boxes
            # KeyErrors on the range lookup)
            rare={"child", "stroller"} <= set(cfg.class_range),
            need_map=bool(args.drivable_filtering),
            tables=eval_tables,
        )
        # predictions outside the eval split still evaluate (as FPs) in the
        # reference, whose add_center_dist looks poses up in the full DB
        # (eval_custom.py:111-113, token assert commented out :934) — do
        # the same from the already-parsed tables
        missing = [t for t in pred_boxes.sample_tokens
                   if t not in ego_translations]
        if missing:
            token_to_sample = {
                s["token"]: s for s in eval_tables.table("sample")
            }
            for t in missing:
                s = token_to_sample.get(t)
                if s is None:
                    raise SystemExit(
                        f"prediction sample_token {t!r} is not in the "
                        f"{args.version} DB"
                    )
                pose = eval_tables.sample_lidar_ego_pose(s)
                ego_translations[t] = tuple(pose["translation"])

    ev = DetectionEval(
        gt_boxes=gt_boxes,
        pred_boxes=pred_boxes,
        cfg=cfg,
        ego_translations=ego_translations,
        output_dir=os.path.expanduser(args.output_dir),
        bikerack_boxes=bikeracks,
        map_geometry=map_geometry,
        drivable_filtering=bool(args.drivable_filtering),
        object_only=bool(args.object_only),
        meta=meta,
        verbose=bool(args.verbose),
    )
    points_provider = None
    if args.plot_examples > 0 and args.dataroot and not args.gt_json:
        # table mode can draw the lidar points behind the boxes; hermetic
        # --gt_json mode renders boxes-only examples (even when a dataroot
        # happens to be set: its tables need not exist for fabricated GT)
        from cm3d_tpu_torch.pipelines.pretrain import make_points_frontend

        fe = make_points_frontend(args.dataroot, args.version, 32768, tables=eval_tables)
        token_to_sample = {s["token"]: s for s in fe.nusc.table("sample")}

        def points_provider(token):
            sample = token_to_sample.get(token)
            return None if sample is None else fe.aggregate_sweeps(sample)[:, :2]

    return ev.main(render_curves=bool(args.render_curves),
                   plot_examples=args.plot_examples,
                   points_provider=points_provider)


if __name__ == "__main__":
    main()

"""GT loading for evaluation from raw nuScenes tables.

Reference load_gt (eval_custom.py:296-404): per-sample annotations mapped to
detection names (standard or rare), velocities from neighboring annotations,
num_pts = lidar + radar, single attribute per box. Plus the bike-rack and
map-geometry side inputs filter_eval_boxes needs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from cm3d_tpu_torch.datasets.nuscenes.maps import NuScenesMapLite
from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables
from cm3d_tpu_torch.eval.boxes import DetectionBox, EvalBoxes
from cm3d_tpu_torch.eval.config import (
    CATEGORY_TO_DETECTION_NAME,
    CATEGORY_TO_DETECTION_NAME_RARE,
)
from cm3d_tpu_torch.eval.evaluate import MapGeometry


def load_gt_for_eval(
    dataroot: str,
    version: str,
    eval_split_scenes: Optional[List[str]] = None,
    rare: bool = False,
    need_map: bool = False,
    tables: Optional[NuScenesTables] = None,
) -> Tuple[EvalBoxes, Dict, Dict, Optional[MapGeometry]]:
    """Returns (gt_boxes, ego_translations, bikerack_boxes, map_geometry).

    eval_split_scenes: scene names to keep; None = all scenes in the DB.
    tables: an already-parsed NuScenesTables to reuse (the table set is
        parsed eagerly, so callers that hold one should pass it).
    """
    nusc = tables if tables is not None else NuScenesTables(dataroot, version)
    mapping = CATEGORY_TO_DETECTION_NAME_RARE if rare else CATEGORY_TO_DETECTION_NAME
    attribute_map = {a["token"]: a["name"] for a in nusc.table("attribute")}

    gt = EvalBoxes()
    ego_translations: Dict[str, tuple] = {}
    bikeracks: Dict[str, List[dict]] = {}
    first_scene = None

    for scene in nusc.table("scene"):
        if eval_split_scenes is not None and scene["name"] not in eval_split_scenes:
            continue
        if first_scene is None:
            first_scene = scene
        for sample in nusc.iter_samples(scene):
            token = sample["token"]
            pose = nusc.sample_lidar_ego_pose(sample)
            ego_translations[token] = tuple(pose["translation"])
            boxes = []
            racks = []
            for ann_token in sample["anns"]:
                ann = nusc.get("sample_annotation", ann_token)
                if ann["category_name"] == "static_object.bicycle_rack":
                    racks.append(
                        {
                            "translation": ann["translation"],
                            "size": ann["size"],
                            "rotation": ann["rotation"],
                        }
                    )
                name = mapping.get(ann["category_name"])
                if name is None:
                    continue
                attr_tokens = ann.get("attribute_tokens", [])
                if len(attr_tokens) > 1:
                    raise ValueError("GT annotations must have at most one attribute")
                attribute = attribute_map[attr_tokens[0]] if attr_tokens else ""
                vel = nusc.box_velocity(ann_token)[:2]
                boxes.append(
                    DetectionBox(
                        sample_token=token,
                        translation=tuple(ann["translation"]),
                        size=tuple(ann["size"]),
                        rotation=tuple(ann["rotation"]),
                        velocity=tuple(float(v) for v in vel),
                        num_pts=int(ann.get("num_lidar_pts", 0))
                        + int(ann.get("num_radar_pts", 0)),
                        detection_name=name,
                        detection_score=-1.0,
                        attribute_name=attribute,
                    )
                )
            gt.add_boxes(token, boxes)
            if racks:
                bikeracks[token] = racks

    geometry = None
    if need_map and first_scene is not None:
        # Reference quirk: ONE map resolved from the first sample's scene is
        # used for the whole box set (eval_custom.py:498-508).
        location = nusc.scene_location(first_scene)
        nmap = NuScenesMapLite(dataroot, location)
        geometry = MapGeometry(nmap.drivable_polygons())

    return gt, ego_translations, bikeracks, geometry

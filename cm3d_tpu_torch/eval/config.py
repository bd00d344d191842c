"""Evaluation configuration presets.

Values are the published nuScenes CVPR-2019 detection config plus the
reference's two JSON variants (src/nuscenes/cfg/sam3d_config.json,
rare_config.json — the latter adds child/stroller for rare-class eval).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


@dataclasses.dataclass(frozen=True)
class DetectionEvalConfig:
    class_range: Dict[str, float]
    dist_fcn: str = "center_distance"
    dist_ths: tuple = (0.5, 1.0, 2.0, 4.0)
    dist_th_tp: float = 2.0
    min_recall: float = 0.1
    min_precision: float = 0.1
    max_boxes_per_sample: int = 500
    mean_ap_weight: int = 5

    def __post_init__(self):
        assert self.dist_th_tp in self.dist_ths, "dist_th_tp must be in dist_ths"

    @property
    def class_names(self) -> List[str]:
        return list(self.class_range.keys())

    def serialize(self) -> dict:
        return {
            "class_range": dict(self.class_range),
            "dist_fcn": self.dist_fcn,
            "dist_ths": list(self.dist_ths),
            "dist_th_tp": self.dist_th_tp,
            "min_recall": self.min_recall,
            "min_precision": self.min_precision,
            "max_boxes_per_sample": self.max_boxes_per_sample,
            "mean_ap_weight": self.mean_ap_weight,
        }

    @classmethod
    def deserialize(cls, content: dict) -> "DetectionEvalConfig":
        return cls(
            class_range=dict(content["class_range"]),
            dist_fcn=content["dist_fcn"],
            dist_ths=tuple(content["dist_ths"]),
            dist_th_tp=content["dist_th_tp"],
            min_recall=content["min_recall"],
            min_precision=content["min_precision"],
            max_boxes_per_sample=content["max_boxes_per_sample"],
            mean_ap_weight=content["mean_ap_weight"],
        )


_STD_RANGES = {
    "car": 50.0,
    "truck": 50.0,
    "bus": 50.0,
    "trailer": 50.0,
    "construction_vehicle": 50.0,
    "pedestrian": 40.0,
    "motorcycle": 40.0,
    "bicycle": 40.0,
    "traffic_cone": 30.0,
    "barrier": 30.0,
}

# The official CVPR-2019 nuScenes detection challenge configuration.
DETECTION_CVPR_2019 = DetectionEvalConfig(class_range=dict(_STD_RANGES))

# Reference cfg/sam3d_config.json — cvpr_2019 ranges but min_recall and
# min_precision are 0 (rare_config.json:18-19, sam3d_config.json:16-17):
# calc_ap drops only recall index 0 with no precision rescale, and
# calc_tp averages from the first confidence bin.
SAM3D_CONFIG = DetectionEvalConfig(
    class_range=dict(_STD_RANGES), min_recall=0.0, min_precision=0.0
)

# Reference cfg/rare_config.json — adds the rare classes (GT mapping then
# routes human.pedestrian.child -> child, .stroller -> stroller;
# eval_custom.py:204-233,928-931) with the same min_recall=min_precision=0.
RARE_CONFIG = DetectionEvalConfig(
    class_range={**_STD_RANGES, "child": 40.0, "stroller": 40.0},
    min_recall=0.0, min_precision=0.0,
)


# GT category -> detection-name mapping, standard 10-class
# (devkit category_to_detection_name semantics).
CATEGORY_TO_DETECTION_NAME = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}

# Rare-class variant: child/stroller become their own classes
# (reference category_to_detection_name_rare, eval_custom.py:204-233).
CATEGORY_TO_DETECTION_NAME_RARE = {
    **CATEGORY_TO_DETECTION_NAME,
    "human.pedestrian.child": "child",
    "human.pedestrian.stroller": "stroller",
}

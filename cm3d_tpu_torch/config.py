"""Typed configuration of the lift stage and its class tables.

A copy of the JAX package's `cm3d_tpu/config.py` class tables,
`MaskStageConfig` and `LiftStageConfig` (the port may not import that
package, which pulls in JAX).

The reference scatters configuration over three mechanisms — hand-edited
module constants, `cfg/prompt_cfg.py`, and JSON files — plus commented-out
code blocks acting as feature flags (SURVEY.md §5). Here every knob is a
dataclass field with the reference behavior as the default, and every
"commentable block" is a real boolean.

Class/threshold/prior VALUES are the reference's published configuration
data (src/nuscenes/cfg/shape_priors_chatgpt.json, cfg/prompt_cfg.py:261-285,
src/nuscenes/2d_to_3d.py:850-861,70-81) — they are part of the behavioral
contract, not code.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

# Canonical nuScenes detection classes, fixed id order used on device.
NUSCENES_CLASSES: tuple[str, ...] = (
    "car",
    "truck",
    "bus",
    "trailer",
    "construction_vehicle",
    "pedestrian",
    "motorcycle",
    "bicycle",
    "traffic_cone",
    "barrier",
)

CLASS_TO_ID: Mapping[str, int] = {c: i for i, c in enumerate(NUSCENES_CLASSES)}

# Per-class box size priors (w, l, h) — reference cfg/shape_priors_chatgpt.json.
SHAPE_PRIORS_CHATGPT: Mapping[str, tuple[float, float, float]] = {
    "car": (1.8, 4.5, 1.4),
    "truck": (2.6, 8.0, 3.6),
    "bus": (2.5, 12.0, 4.0),
    "trailer": (2.6, 12.0, 3.6),
    "construction_vehicle": (2.0, 4.5, 2.5),
    "pedestrian": (0.4, 0.7, 1.7),
    "motorcycle": (0.8, 2.1, 1.7),
    "bicycle": (0.6, 1.8, 1.4),
    "traffic_cone": (0.3, 0.3, 0.7),
    "barrier": (0.5, 1.2, 0.9),
}

# Dataset-mean box size priors (w, l, h) — reference cfg/shape_priors.json,
# produced by get_priors.py over v1.0-trainval GT; selected when
# use_chatgpt_priors=False (reference get_shape_prior, 2d_to_3d.py:134-161).
SHAPE_PRIORS_DATASET_MEAN: Mapping[str, tuple[float, float, float]] = {
    "car": (1.924766, 4.620188, 1.689568),
    "truck": (2.350704, 6.489163, 2.616678),
    "bus": (2.953850, 11.471948, 3.803556),
    "trailer": (2.278211, 10.150105, 3.707421),
    "construction_vehicle": (2.574395, 5.566216, 2.372426),
    "pedestrian": (0.683835, 0.733622, 1.759913),
    "motorcycle": (0.676513, 1.950588, 1.471838),
    "bicycle": (0.637729, 1.827585, 1.395962),
    "traffic_cone": (0.466605, 0.447860, 0.777212),
    "barrier": (2.321657, 0.606584, 1.062876),
}

# Detection name -> full nuScenes category key in a get_priors-produced
# dataset-mean priors file (reference get_shape_prior, 2d_to_3d.py:137-158).
# Deviation: the reference's non-chatgpt branch has no "barrier" case (it
# would fall through and crash); we map it to movable_object.barrier.
DATASET_MEAN_PRIOR_KEYS: Mapping[str, str] = {
    "car": "vehicle.car",
    "bicycle": "vehicle.bicycle",
    "bus": "vehicle.bus.rigid",
    "truck": "vehicle.truck",
    "pedestrian": "human.pedestrian.adult",
    "traffic_cone": "movable_object.trafficcone",
    "construction_vehicle": "vehicle.construction",
    "motorcycle": "vehicle.motorcycle",
    "trailer": "vehicle.trailer",
    "barrier": "movable_object.barrier",
    "child": "human.pedestrian.child",
    "stroller": "human.pedestrian.adult",
}

# Classes that get lane-yaw orientation + centroid pushback
# (reference 2d_to_3d.py:763).
VEHICLE_CLASSES: frozenset[str] = frozenset(
    {"car", "truck", "bus", "construction_vehicle", "trailer", "barrier"}
)

# Classes the (optional) drivable-area filter drops when off-road: the
# reference's commented block exempts construction_vehicle/trailer/barrier
# inside the vehicle branch (2d_to_3d.py:774-779).
DRIVABLE_FILTER_CLASSES: frozenset[str] = frozenset({"car", "truck", "bus"})

# BEV circle-NMS per-class thresholds, compared against SQUARED center
# distance (reference 2d_to_3d.py:850-861, borrowed from CenterPoint).
CIRCLE_NMS_THRESH: Mapping[str, float] = {
    "barrier": 1.0,
    "traffic_cone": 0.175,
    "bicycle": 0.85,
    "motorcycle": 0.85,
    "pedestrian": 0.175,
    "car": 4.0,
    "bus": 10.0,
    "construction_vehicle": 12.0,
    "trailer": 10.0,
    "truck": 12.0,
}

# Fixed attribute string per class in the submission JSON
# (reference 2d_to_3d.py:70-81).
ATTRIBUTE_NAMES: Mapping[str, str] = {
    "barrier": "",
    "traffic_cone": "",
    "bicycle": "cycle.without_rider",
    "motorcycle": "cycle.without_rider",
    "pedestrian": "pedestrian.standing",
    "car": "vehicle.stopped",
    "bus": "vehicle.stopped",
    "construction_vehicle": "vehicle.stopped",
    "trailer": "vehicle.stopped",
    "truck": "vehicle.stopped",
}

# Detection-name normalization (reference get_detection_name,
# 2d_to_3d.py:122-132).
DETECTION_NAME_FIXUPS: Mapping[str, str] = {
    "trafficcone": "traffic_cone",
    "constructionvehicle": "construction_vehicle",
    "human": "pedestrian",
}

# Per-class 2D detector score thresholds (reference cfg/prompt_cfg.py:261-272;
# all 0.10 in the shipped config).
BOX_THRESHOLDS: Mapping[str, float] = {c: 0.10 for c in NUSCENES_CLASSES}


def load_priors_file(path: str) -> Mapping[str, tuple[float, float, float]]:
    """Map a get_priors-produced JSON (full category keys -> [w, l, h]) to
    detection names via the reference's get_shape_prior name switch
    (2d_to_3d.py:137-158). Missing categories fall back to the chatgpt table."""
    import json

    with open(path) as f:
        raw = json.load(f)
    out = dict(SHAPE_PRIORS_CHATGPT)
    for name, key in DATASET_MEAN_PRIOR_KEYS.items():
        if key in raw:
            out[name] = tuple(float(v) for v in raw[key])
    return out


def class_arrays(
    classes: Sequence[str] = NUSCENES_CLASSES,
    use_chatgpt_priors: bool = True,
    priors_file: str | None = None,
):
    """Device-ready per-class arrays: (shape_priors [C,3], is_vehicle [C],
    nms_radius_sq [C]).

    Prior source (reference 2d_to_3d.py:385 switch + get_shape_prior):
    chatgpt table (default), the bundled dataset-mean table
    (use_chatgpt_priors=False), or a get_priors-produced JSON (priors_file).
    """
    if priors_file is not None:
        table = load_priors_file(priors_file)
    elif use_chatgpt_priors:
        table = SHAPE_PRIORS_CHATGPT
    else:
        table = SHAPE_PRIORS_DATASET_MEAN
    priors = np.array([table[c] for c in classes], np.float32)
    is_vehicle = np.array([c in VEHICLE_CLASSES for c in classes], bool)
    radii = np.array([CIRCLE_NMS_THRESH[c] for c in classes], np.float32)
    return priors, is_vehicle, radii


def drivable_class_array(classes: Sequence[str] = NUSCENES_CLASSES) -> np.ndarray:
    """[C] bool: classes subject to the drivable-area filter."""
    return np.array([c in DRIVABLE_FILTER_CLASSES for c in classes], bool)


@dataclasses.dataclass(frozen=True)
class MaskStageConfig:
    """2D mask generation stage (reference gen_2d_masks_detic.py)."""

    score_thresh: float = 0.1  # Detic ROI_HEADS.SCORE_THRESH_TEST (:35)
    nms_iou: float = 0.75  # class-wise 2D NMS (:361)
    run_nms: bool = True  # ":349 run_nms = True"
    thumbnail: int = 1024  # PIL thumbnail max side (:293)
    multimask_output: bool = False  # SAM (:397)
    max_detections: int = 128  # padded detections per image
    max_masks_total: int = 128  # bit-plane capacity per keyframe (= lift max_masks)
    # SAM prompt padding buckets: each frame's decode pads its prompts to the
    # smallest bucket >= its busiest camera (most frames have ~25 boxes per
    # camera; always padding to 128 wastes ~4x decode time)
    prompt_buckets: tuple = (32,)
    dtype: str = "bfloat16"  # model compute dtype ("float32" for strict parity)
    # reference gen_2d_masks_detic.py:408 `use_zoedepth = False`: when on
    # (and MaskModels.predict_depth is set), the artifact payload becomes
    # per-mask masked metric depth instead of RLE masks (:412-451,484-486)
    use_zoedepth: bool = False


@dataclasses.dataclass(frozen=True)
class LiftStageConfig:
    """2D->3D lifting stage (reference 2d_to_3d.py __main__)."""

    num_sweeps: int = 3  # :437 (future sweeps via ['next'])
    min_dist: float = 2.3  # :348
    sqrt_min_dist_load_filter: bool = True  # :443-444 quirk
    erode_masks: bool = True  # :526-528
    image_ratio: float = 0.64  # :419,484 (1024/1600)
    use_chatgpt_priors: bool = True  # :385 (False -> dataset-mean table)
    priors_file: str | None = None  # get_priors JSON overriding the tables
    drivable_filter: bool = False  # :774-779 commented out in reference
    lane_dist_filter: bool = False  # :757,781-786 commented out
    object_lane_thresh: float = 20.0  # "Object lane thresh" (:756-758)
    vehicle_lane_thresh: float = 4.0  # "Vehicle lane thresh" (:782-785)
    drivable_grid_size: int = 512  # G: per-keyframe raster crop (device lookup)
    drivable_resolution: float = 0.5  # meters per raster cell
    max_points: int = 131072  # padded aggregated cloud size
    max_masks: int = 128  # padded masks per keyframe (bit-packed on device)
    max_points_per_mask: int = 2048
    max_points_per_camera: int = 32768  # per-camera frustum compaction depth
    max_points_in_masks: int = 8192  # per-camera any-mask union compaction depth
    max_lane_points: int = 32768  # padded per-scene lane points
    # Inert: nothing reads it, here or in the JAX package (the circle NMS
    # always runs). Kept only so that the two config trees hold the same
    # fields; no code may branch on it.
    run_circle_nms: bool = True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    mask_stage: MaskStageConfig = MaskStageConfig()
    lift_stage: LiftStageConfig = LiftStageConfig()
    classes: tuple[str, ...] = NUSCENES_CLASSES


# Per-dataset presets (data only; as `cm3d_tpu/config.py`).
NUSCENES_LIFT = LiftStageConfig()  # 3 sweeps, ratio 0.64 (reference defaults)
WAYMO_LIFT = LiftStageConfig(
    num_sweeps=1,  # single return, no aggregation (waymo/2d_to_3d.py:484-486)
    image_ratio=1024.0 / 1920.0,  # :523
    sqrt_min_dist_load_filter=False,  # no load-time filter on range images
)
KITTI_LIFT = LiftStageConfig(
    num_sweeps=1,
    image_ratio=0.8366,  # kitti/2d_to_3d.py:1103
    sqrt_min_dist_load_filter=False,
)

DATASET_LIFT_PRESETS: Mapping[str, LiftStageConfig] = {
    "nuscenes": NUSCENES_LIFT,
    "waymo": WAYMO_LIFT,
    "kitti": KITTI_LIFT,
}

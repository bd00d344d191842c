"""Class tables of the nuScenes pipeline, as published data.

Frozen copies of the reference's configuration values (CM3D
src/nuscenes/cfg/prompt_cfg.py, cfg/shape_priors_chatgpt.json and
2d_to_3d.py's circle-NMS radii), as the port states them in
cm3d_tpu_torch/vocab.py and cm3d_tpu_torch/config.py. The reference side of
the benchmark reads these copies, never the port's.
"""

from __future__ import annotations

import numpy as np

# Detic custom vocabulary, nuScenes (gen_2d_masks_detic.py:66-87), and the
# class each word maps to (prompt_cfg.py OLD_MAPS, which covers every word).
VOCABULARY = (
    "bus", "truck", "dumptruck", "car", "pedestrian", "person", "human", "bicycle", "sedan",
    "pickup_truck", "traffic_cone", "barrier", "road_barrier", "trailer", "truck_trailer",
    "semi_trailer", "tank_trailer", "construction_vehicle", "motorcycle",
)
WORD_TO_CLASS = {
    "bus": "bus", "truck": "truck", "dumptruck": "truck", "car": "car",
    "pedestrian": "pedestrian", "person": "pedestrian", "human": "pedestrian",
    "bicycle": "bicycle", "sedan": "car", "pickup_truck": "truck",
    "traffic_cone": "traffic_cone", "barrier": "barrier", "road_barrier": "barrier",
    "trailer": "trailer", "truck_trailer": "trailer", "semi_trailer": "trailer",
    "tank_trailer": "trailer", "construction_vehicle": "construction_vehicle",
    "motorcycle": "motorcycle",
}

CLASSES = ("car", "truck", "bus", "trailer", "construction_vehicle", "pedestrian",
           "motorcycle", "bicycle", "traffic_cone", "barrier")
CLASS_TO_ID = {c: i for i, c in enumerate(CLASSES)}

SHAPE_PRIORS = {  # (w, l, h), shape_priors_chatgpt.json
    "car": (1.8, 4.5, 1.4), "truck": (2.6, 8.0, 3.6), "bus": (2.5, 12.0, 4.0),
    "trailer": (2.6, 12.0, 3.6), "construction_vehicle": (2.0, 4.5, 2.5),
    "pedestrian": (0.4, 0.7, 1.7), "motorcycle": (0.8, 2.1, 1.7),
    "bicycle": (0.6, 1.8, 1.4), "traffic_cone": (0.3, 0.3, 0.7), "barrier": (0.5, 1.2, 0.9),
}
VEHICLE_CLASSES = frozenset({"car", "truck", "bus", "construction_vehicle", "trailer",
                             "barrier"})
CIRCLE_NMS_RADIUS_SQ = {
    "barrier": 1.0, "traffic_cone": 0.175, "bicycle": 0.85, "motorcycle": 0.85,
    "pedestrian": 0.175, "car": 4.0, "bus": 10.0, "construction_vehicle": 12.0,
    "trailer": 10.0, "truck": 12.0,
}

# normalisation statistics of both image models (RGB, ImageNet order)
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


def class_arrays():
    """(shape priors [K, 3], is_vehicle [K], circle-NMS squared radii [K])."""
    return (np.array([SHAPE_PRIORS[c] for c in CLASSES], np.float32),
            np.array([c in VEHICLE_CLASSES for c in CLASSES], bool),
            np.array([CIRCLE_NMS_RADIUS_SQ[c] for c in CLASSES], np.float32))

"""Open-vocabulary prompt configuration: detector vocabulary + class maps.

A copy of the JAX package's `cm3d_tpu/vocab.py` (pure Python; the port
may not import that package, which pulls in JAX).

Reference data tables (src/nuscenes/cfg/prompt_cfg.py): the custom Detic
vocabulary (gen_2d_masks_detic.py:66-87), the synonym->class maps, and the
`map_class` fallback heuristics (:219-238). These VALUES are the published
behavioral contract, reproduced as configuration data. The Waymo variant
drops cone/barrier (waymo/gen_2d_masks_detic.py:66-87); KITTI renames
classes (kitti/cfg/prompt_cfg.py:20-72).
"""

from __future__ import annotations

from typing import Dict, List, Mapping

# Detic custom vocabulary, nuScenes (gen_2d_masks_detic.py:66-87).
CUSTOM_VOCABULARY_NUSCENES: tuple = (
    "bus",
    "truck",
    "dumptruck",
    "car",
    "pedestrian",
    "person",
    "human",
    "bicycle",
    "sedan",
    "pickup_truck",
    "traffic_cone",
    "barrier",
    "road_barrier",
    "trailer",
    "truck_trailer",
    "semi_trailer",
    "tank_trailer",
    "construction_vehicle",
    "motorcycle",
)

# Waymo variant: no cone/barrier classes in Waymo's taxonomy.
CUSTOM_VOCABULARY_WAYMO: tuple = tuple(
    v for v in CUSTOM_VOCABULARY_NUSCENES
    if v not in ("traffic_cone", "barrier", "road_barrier")
)

# Synonym table (TEXT_PROMPT_MAPS, prompt_cfg.py:19-91).
TEXT_PROMPT_MAPS: Mapping[str, List[str]] = {
    "bicycle": ["bicycle", "cycle"],
    "car": ["sedan car", "car", "sedan", "suv"],
    "pedestrian": ["human", "man", "woman", "pedestrian", "person"],
    "truck": ["truck", "semi", "lorry", "pickup truck"],
    "bus": ["bus"],
    "traffic_cone": ["traffic cone"],
    "barrier": ["road barrier", "traffic barrier"],
    "construction_vehicle": ["construction vehicle", "bulldozer", "excavator"],
    "motorcycle": ["motorcycle", "motorbike"],
    "trailer": ["truck trailer"],
}

MAPS: Dict[str, str] = {
    syn: cls for cls, syns in TEXT_PROMPT_MAPS.items() for syn in syns
}

# Legacy synonym->class map actually used by map_class (prompt_cfg.py:192-258).
OLD_MAPS: Mapping[str, str] = {
    "bicycle": "bicycle",
    "cycle": "bicycle",
    "pedal cycle": "bicycle",
    "push bike": "bicycle",
    "pushbike": "bicycle",
    "car": "car",
    "hatchback": "car",
    "convertible": "car",
    "jeep": "car",
    "sedan": "car",
    "sedan car": "car",
    "suv": "car",
    "suv car": "car",
    "hatchback car": "car",
    "convertible car": "car",
    "jeep car": "car",
    "pickup truck": "truck",
    "pickup": "truck",
    "pick-up truck": "truck",
    "pickup_truck": "truck",
    "human": "pedestrian",
    "man": "pedestrian",
    "woman": "pedestrian",
    "child": "pedestrian",
    "kid": "pedestrian",
    "boy": "pedestrian",
    "girl": "pedestrian",
    "pedestrian": "pedestrian",
    "person": "pedestrian",
    "truck": "truck",
    "semi": "truck",
    "semitrailer": "trailer",
    "semi_trailer": "trailer",
    "tank_trailer": "trailer",
    "semi-trailer": "trailer",
    "eighteen-wheeler": "trailer",
    "lorry": "truck",
    "lorry truck": "truck",
    "bus": "bus",
    "autobus": "bus",
    "motorbus": "bus",
    "traffic cone": "traffic_cone",
    "traffic_cone": "traffic_cone",
    "barrier": "barrier",
    "road barrier": "barrier",
    "road_barrier": "barrier",
    "traffic barrier": "barrier",
    "traffic_barrier": "barrier",
    "construction vehicle": "construction_vehicle",
    "construction_vehicle": "construction_vehicle",
    "dumptruck": "truck",
    "dump truck": "truck",
    "forklift": "construction_vehicle",
    "cement mixer": "construction_vehicle",
    "bulldozer": "construction_vehicle",
    "crane": "construction_vehicle",
    "motorcycle": "motorcycle",
    "motorbike": "motorcycle",
    "trailer": "trailer",
    "rv": "trailer",
    "camper": "trailer",
    "truck trailer": "trailer",
    "truck_trailer": "trailer",
}

# KITTI class renames (kitti/cfg/prompt_cfg.py:20-72).
NUSC_TO_KITTI: Mapping[str, str] = {
    "car": "Car",
    "pedestrian": "Pedestrian",
    "bicycle": "Cyclist",
    "truck": "Truck",
    "bus": "Tram",
    "trailer": "Misc",
    "construction_vehicle": "Misc",
    "motorcycle": "Cyclist",
}

# nuScenes class -> Waymo label (waymo/cfg/prompt_cfg.py:286-296).
NUSC_TO_WAYMO: Mapping[str, str] = {
    "car": "vehicle",
    "truck": "vehicle",
    "bus": "vehicle",
    "trailer": "vehicle",
    "construction_vehicle": "vehicle",
    "pedestrian": "pedestrian",
    "bicycle": "cyclist",
    "motorcycle": "cyclist",
}


def map_class(name: str) -> str:
    """Reference map_class (gen_2d_masks_detic.py:219-238): OLD_MAPS lookup
    then substring heuristics; unknowns fall back to 'car' after a warning."""
    name = name.lower()
    if name in OLD_MAPS:
        return OLD_MAPS[name]
    if ("car" in name or "sedan" in name or "suv" in name
            or "pickup truck" in name):
        return "car"
    if "pickup" in name:
        return "car"
    if "human" in name or "person" in name or "pedestrian" in name:
        return "pedestrian"
    if "bicycle" in name or "bike" in name:
        return "bicycle"
    if "truck" in name or "lorry" in name:
        return "truck"
    if "bus" in name:
        return "bus"
    print("couldn't assign class. <<<<<<<<<<<<<<<<<<<<<<<<<<<<<<<<<<")
    return "car"

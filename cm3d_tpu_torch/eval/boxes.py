"""Evaluation box containers.

Behavioral contract from the reference's DetectionBox/EvalBoxes usage
(src/nuscenes/eval_custom.py:129-200 and the devkit classes it subclasses),
re-expressed as plain dataclasses + a per-sample dict container.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DetectionBox:
    """One GT or predicted box in GLOBAL frame.

    rotation is a (w, x, y, z) quaternion; size is (w, l, h) — nuScenes
    convention. ego_translation is filled by add_center_dist.
    """

    sample_token: str = ""
    translation: tuple = (0.0, 0.0, 0.0)
    size: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (1.0, 0.0, 0.0, 0.0)
    velocity: tuple = (0.0, 0.0)
    ego_translation: tuple = (0.0, 0.0, 0.0)
    num_pts: int = -1  # LIDAR+RADAR points inside; -1 = unknown (preds)
    detection_name: str = "car"
    detection_score: float = -1.0  # GT boxes keep -1
    attribute_name: str = ""

    @property
    def ego_dist(self) -> float:
        """Cylindrical (xy) distance from the ego vehicle."""
        return float(np.hypot(self.ego_translation[0], self.ego_translation[1]))

    def serialize(self) -> dict:
        return {
            "sample_token": self.sample_token,
            "translation": list(self.translation),
            "size": list(self.size),
            "rotation": list(self.rotation),
            "velocity": list(self.velocity),
            "ego_translation": list(self.ego_translation),
            "num_pts": self.num_pts,
            "detection_name": self.detection_name,
            "detection_score": self.detection_score,
            "attribute_name": self.attribute_name,
        }

    @classmethod
    def deserialize(cls, content: dict) -> "DetectionBox":
        return cls(
            sample_token=content["sample_token"],
            translation=tuple(content["translation"]),
            size=tuple(content["size"]),
            rotation=tuple(content["rotation"]),
            velocity=tuple(content.get("velocity", (0.0, 0.0))),
            ego_translation=tuple(content.get("ego_translation", (0.0, 0.0, 0.0))),
            num_pts=int(content.get("num_pts", -1)),
            detection_name=content["detection_name"],
            detection_score=float(content.get("detection_score", -1.0)),
            attribute_name=content.get("attribute_name", ""),
        )


class EvalBoxes:
    """sample_token -> list[DetectionBox], insertion-ordered."""

    def __init__(self) -> None:
        self.boxes: Dict[str, List[DetectionBox]] = {}

    @property
    def sample_tokens(self) -> List[str]:
        return list(self.boxes.keys())

    @property
    def all(self) -> List[DetectionBox]:
        out: List[DetectionBox] = []
        for token in self.boxes:
            out.extend(self.boxes[token])
        return out

    def add_boxes(self, sample_token: str, boxes: Sequence[DetectionBox]) -> None:
        self.boxes.setdefault(sample_token, [])
        self.boxes[sample_token].extend(boxes)

    def __getitem__(self, sample_token: str) -> List[DetectionBox]:
        return self.boxes.get(sample_token, [])

    def __iter__(self) -> Iterator[str]:
        return iter(self.boxes)

    def __len__(self) -> int:
        return len(self.boxes)

    def serialize(self) -> dict:
        return {t: [b.serialize() for b in bs] for t, bs in self.boxes.items()}

    @classmethod
    def deserialize(cls, content: dict) -> "EvalBoxes":
        out = cls()
        for token, box_dicts in content.items():
            out.add_boxes(token, [DetectionBox.deserialize(d) for d in box_dicts])
        return out


def load_prediction(
    result_path: str, max_boxes_per_sample: Optional[int] = None
) -> tuple:
    """Load a nuScenes-format submission JSON: {"meta": ..., "results": {...}}.

    Reference contract: load_prediction (devkit) called at
    eval_custom.py:926; enforces the per-sample box cap.
    """
    with open(result_path) as f:
        data = json.load(f)
    if "results" not in data:
        raise ValueError(
            "No 'results' field in submission file — wrong format?"
        )
    boxes = EvalBoxes.deserialize(data["results"])
    meta = data.get("meta", {})
    if max_boxes_per_sample is not None:
        for token in boxes.sample_tokens:
            if len(boxes[token]) > max_boxes_per_sample:
                raise ValueError(
                    f"sample {token} has {len(boxes[token])} boxes; "
                    f"only <= {max_boxes_per_sample} allowed"
                )
    return boxes, meta


def add_center_dist_from_poses(
    eval_boxes: EvalBoxes, ego_translations: Dict[str, Sequence[float]]
) -> EvalBoxes:
    """Set each box's ego_translation from per-sample ego poses
    (reference add_center_dist, eval_custom.py:103-127; z of ego pose is 0)."""
    for token in eval_boxes.sample_tokens:
        try:
            pose = ego_translations[token]
        except KeyError:
            raise KeyError(
                f"no ego pose for sample {token!r} — every evaluated "
                "sample (GT or prediction) needs an ego_translations "
                "entry; the CLI fills extra prediction tokens from the "
                "DB tables (reference eval_custom.py:111-113)"
            ) from None
        for box in eval_boxes[token]:
            box.ego_translation = (
                box.translation[0] - pose[0],
                box.translation[1] - pose[1],
                box.translation[2] - pose[2],
            )
    return eval_boxes

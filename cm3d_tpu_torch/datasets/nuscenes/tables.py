"""Relational nuScenes table access (devkit-free).

The nuScenes DB is a set of JSON tables keyed by token; the devkit's
NuScenes class is an in-memory index over them. This reader loads exactly
the tables the pipeline touches (reference usage: 2d_to_3d.py:381-506,
eval_custom.py:296-404) without the 300-dependency devkit.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

# Camera ring in the reference's processing order (2d_to_3d.py:60-67).
CAM_LIST = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_FRONT_LEFT",
)

# exactly the tables the pipeline reads (grep-verified): the devkit's
# category/sensor/instance/map tables are never touched here and are not
# loaded. sample_annotation is the one table allowed to be absent
# (v1.0-test ships no GT); a missing CORE table means a corrupt/partial
# extraction and must fail loudly, like the version dir itself.
_TABLES = (
    "attribute",
    "calibrated_sensor",
    "ego_pose",
    "log",
    "scene",
    "sample",
    "sample_data",
    "sample_annotation",
)
_OPTIONAL_TABLES = frozenset({"sample_annotation"})


class NuScenesTables:
    """Token-indexed access to a nuScenes version directory."""

    def __init__(self, dataroot: str | Path, version: str = "v1.0-mini"):
        self.dataroot = Path(dataroot)
        self.version = version
        table_dir = self.dataroot / version
        if not table_dir.is_dir():
            raise FileNotFoundError(
                f"nuScenes version dir not found: {table_dir} (a missing "
                f"version must fail loudly, not run over empty tables)"
            )
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for name in _TABLES:
            p = table_dir / f"{name}.json"
            if p.exists():
                rows = json.loads(p.read_text())
            elif name in _OPTIONAL_TABLES:
                rows = []
            else:
                raise FileNotFoundError(
                    f"nuScenes table missing: {p} — a corrupt or partially "
                    f"extracted version dir must fail loudly (only "
                    f"{sorted(_OPTIONAL_TABLES)} may be absent, e.g. "
                    f"v1.0-test)"
                )
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}

    # -- devkit-like primitives --------------------------------------------

    def table(self, name: str) -> List[dict]:
        return self._tables[name]

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def field2token(self, table: str, field: str, value) -> List[str]:
        return [r["token"] for r in self._tables[table] if r.get(field) == value]

    # -- scene / sample traversal ------------------------------------------

    def scene_by_name(self, name: str) -> dict:
        row = next((r for r in self._tables["scene"] if r["name"] == name),
                   None)
        if row is None:
            raise KeyError(f"no scene named {name}")
        return row

    def iter_samples(self, scene: dict) -> Iterator[dict]:
        sample = self.get("sample", scene["first_sample_token"])
        while True:
            yield sample
            if sample["next"] == "":
                break
            sample = self.get("sample", sample["next"])

    def count_frames(self, scene: dict) -> int:
        return sum(1 for _ in self.iter_samples(scene))

    def scene_location(self, scene: dict) -> str:
        return self.get("log", scene["log_token"])["location"]

    # -- annotation helpers (devkit box_velocity semantics) -----------------

    def box_velocity(self, ann_token: str, max_time_diff: float = 1.5) -> np.ndarray:
        """Velocity from neighboring annotations of the same instance;
        NaNs when neighbors are missing or too far apart in time."""
        current = self.get("sample_annotation", ann_token)
        has_prev = current["prev"] != ""
        has_next = current["next"] != ""
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.get("sample_annotation", current["prev"]) if has_prev else current
        last = self.get("sample_annotation", current["next"]) if has_next else current
        pos_first = np.asarray(first["translation"], float)
        pos_last = np.asarray(last["translation"], float)
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        dt = t_last - t_first
        if has_next and has_prev:
            # devkit doubles the window when differencing across BOTH
            # neighbors (prev->next spans two keyframe intervals)
            max_time_diff *= 2
        if dt > max_time_diff or dt <= 0:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / dt

    def sample_lidar_ego_pose(self, sample: dict) -> dict:
        sd = self.get("sample_data", sample["data"]["LIDAR_TOP"])
        return self.get("ego_pose", sd["ego_pose_token"])

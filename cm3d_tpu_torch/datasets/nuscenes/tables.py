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

# Camera ring in the reference's processing order (2d_to_3d.py:60-67).
CAM_LIST = (
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_FRONT_LEFT",
)

# exactly the tables the lift reads: the devkit's category/sensor/instance/
# map tables and the annotation tables are never touched here and are not
# loaded. A missing table means a corrupt/partial extraction and must fail
# loudly, like the version dir itself.
_TABLES = (
    "calibrated_sensor",
    "ego_pose",
    "log",
    "scene",
    "sample",
    "sample_data",
)


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
            if not p.exists():
                raise FileNotFoundError(
                    f"nuScenes table missing: {p} — a corrupt or partially "
                    f"extracted version dir must fail loudly"
                )
            rows = json.loads(p.read_text())
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}

    # -- devkit-like primitives --------------------------------------------

    def table(self, name: str) -> List[dict]:
        return self._tables[name]

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

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

    def scene_location(self, scene: dict) -> str:
        return self.get("log", scene["log_token"])["location"]

    def sample_lidar_ego_pose(self, sample: dict) -> dict:
        sd = self.get("sample_data", sample["data"]["LIDAR_TOP"])
        return self.get("ego_pose", sd["ego_pose_token"])

"""KITTI calibration + label parsing (numpy). A copy of
`cm3d_tpu/datasets/kitti/calib.py` (host numpy, unchanged).

Behavioral contract: the reference's torch-ified Calibration
(src/kitti/kitti_utils.py:114-375) and Object3d (:52-111). Frames:
  velodyne (x fwd, y left, z up) -> ref cam (V2C) -> rect cam (R0)
  -> image2 (P2, with the baked stereo baseline column).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List

import numpy as np


def _read_calib_file(path: str | Path) -> Dict[str, np.ndarray]:
    data = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip()
            if not line:
                continue
            key, value = line.split(":", 1)
            try:
                data[key] = np.array([float(x) for x in value.split()])
            except ValueError:
                pass
    return data


# velodyne-frame constraint box for depth unprojection
# (reference kitti_utils.py:26)
CBOX = ((0.0, 70.4), (-40.0, 40.0), (-3.0, 2.0))


def inverse_rigid_trans(tr: np.ndarray) -> np.ndarray:
    """Inverse of a [3, 4] rigid transform (reference kitti_utils.py:368-375)."""
    inv = np.zeros_like(tr)
    inv[:3, :3] = tr[:3, :3].T
    inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return inv


class Calibration:
    """P2 / Tr_velo_to_cam / R0_rect and the projection chains."""

    def __init__(self, calib_filepath: str | Path):
        calibs = _read_calib_file(calib_filepath)
        self.P = calibs["P2"].reshape(3, 4)
        self.V2C = calibs["Tr_velo_to_cam"].reshape(3, 4)
        self.C2V = inverse_rigid_trans(self.V2C)
        self.R0 = calibs["R0_rect"].reshape(3, 3)
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @staticmethod
    def _hom(pts: np.ndarray) -> np.ndarray:
        return np.concatenate([pts, np.ones((len(pts), 1))], axis=1)

    # 3d <-> 3d
    def project_velo_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return self._hom(pts) @ self.V2C.T

    def project_ref_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self._hom(pts) @ self.C2V.T

    def project_ref_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return (self.R0 @ pts.T).T

    def project_rect_to_ref(self, pts: np.ndarray) -> np.ndarray:
        return (np.linalg.inv(self.R0) @ pts.T).T

    def project_velo_to_rect(self, pts: np.ndarray) -> np.ndarray:
        return self.project_ref_to_rect(self.project_velo_to_ref(pts))

    def project_rect_to_velo(self, pts: np.ndarray) -> np.ndarray:
        return self.project_ref_to_velo(self.project_rect_to_ref(pts))

    # 3d -> 2d
    def project_rect_to_image(self, pts: np.ndarray) -> np.ndarray:
        p = self._hom(pts) @ self.P.T
        return p[:, :2] / p[:, 2:3]

    def project_velo_to_image(self, pts: np.ndarray) -> np.ndarray:
        return self.project_rect_to_image(self.project_velo_to_rect(pts))

    # 2d -> 3d
    def project_image_to_rect(self, uv_depth: np.ndarray) -> np.ndarray:
        x = (uv_depth[:, 0] - self.c_u) * uv_depth[:, 2] / self.f_u + self.b_x
        y = (uv_depth[:, 1] - self.c_v) * uv_depth[:, 2] / self.f_v + self.b_y
        return np.stack([x, y, uv_depth[:, 2]], axis=1)

    def project_image_to_velo(self, uv_depth: np.ndarray) -> np.ndarray:
        return self.project_rect_to_velo(self.project_image_to_rect(uv_depth))

    def project_depth_to_velo(self, depth: np.ndarray,
                              constraint_box: bool = True) -> np.ndarray:
        """Dense depth image [H, W] (meters) -> velodyne-frame points
        [N, 3] (reference kitti_utils.py:310-330). Mirrors the reference's
        quirks: EVERY pixel unprojects (zero-depth pixels included —
        get_depth_pt3d iterates all of them) and constraint_box clips to
        the fixed cbox x:[0,70.4) y:[-40,40) z:[-3,2) (kitti_utils.py:26).
        Vectorized instead of the reference's per-pixel Python loop."""
        h, w = depth.shape
        vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        uvd = np.stack(
            [uu.ravel(), vv.ravel(), np.asarray(depth, np.float64).ravel()],
            axis=1,
        )
        pts = self.project_image_to_velo(uvd)
        if constraint_box:
            keep = (
                (pts[:, 0] >= CBOX[0][0]) & (pts[:, 0] < CBOX[0][1])
                & (pts[:, 1] >= CBOX[1][0]) & (pts[:, 1] < CBOX[1][1])
                & (pts[:, 2] >= CBOX[2][0]) & (pts[:, 2] < CBOX[2][1])
            )
            pts = pts[keep]
        return pts

    # decomposition for the device pipeline: p_rect = A @ p_velo + b,
    # with the P2 baseline column folded in so a pure K applies after.
    def rect_chain(self):
        """(A [3,3], b [3]) such that image = K @ (A p_velo + b) with
        K = [[f_u, 0, c_u], [0, f_v, c_v], [0, 0, 1]]."""
        a = self.R0 @ self.V2C[:3, :3]
        b = self.R0 @ self.V2C[:3, 3]
        k = np.array(
            [[self.f_u, 0, self.c_u], [0, self.f_v, self.c_v], [0, 0, 1.0]]
        )
        extra = np.linalg.solve(k, self.P[:, 3])  # baked baseline column
        return a, b + extra, k


@dataclasses.dataclass
class Object3d:
    """KITTI label line (reference kitti_utils.py:52-111)."""

    type: str
    truncation: float
    occlusion: int
    alpha: float
    box2d: np.ndarray  # [4] xmin ymin xmax ymax
    h: float
    w: float
    l: float
    t: tuple  # (x, y, z) rect camera frame, BOTTOM center
    ry: float
    score: float = float("nan")

    @classmethod
    def from_line(cls, line: str) -> "Object3d":
        data = line.split(" ")
        vals = [float(x) for x in data[1:]]
        return cls(
            type=data[0],
            truncation=vals[0],
            occlusion=int(vals[1]),
            alpha=vals[2],
            box2d=np.array(vals[3:7]),
            h=vals[7],
            w=vals[8],
            l=vals[9],
            t=(vals[10], vals[11], vals[12]),
            ry=vals[13],
            score=vals[14] if len(vals) > 14 else float("nan"),
        )

    def to_line(self) -> str:
        base = (
            f"{self.type} {self.truncation} {self.occlusion} {self.alpha} "
            f"{self.box2d[0]} {self.box2d[1]} {self.box2d[2]} {self.box2d[3]} "
            f"{self.h} {self.w} {self.l} "
            f"{self.t[0]} {self.t[1]} {self.t[2]} {self.ry}"
        )
        if not np.isnan(self.score):
            base += f" {self.score}"
        return base

    def difficulty(self) -> str:
        """Reference estimate_diffculty (kitti_utils.py:83-96) — including
        its quirk of using the 2D box WIDTH as 'height'."""
        bb_height = abs(self.box2d[2] - self.box2d[0])
        if bb_height >= 40 and self.occlusion == 0 and self.truncation <= 0.15:
            return "Easy"
        if bb_height >= 25 and self.occlusion in (0, 1) and self.truncation <= 0.30:
            return "Moderate"
        if bb_height >= 25 and self.occlusion in (0, 1, 2) and self.truncation <= 0.50:
            return "Hard"
        return "Unknown"


def read_label(path: str | Path) -> List[Object3d]:
    with open(path) as f:
        return [Object3d.from_line(l.rstrip()) for l in f if l.strip()]


def write_label(path: str | Path, objects: List[Object3d]) -> None:
    with open(path, "w") as f:
        for o in objects:
            f.write(o.to_line() + "\n")


def compute_box_3d(obj: Object3d) -> np.ndarray:
    """8 corners [8, 3] in rect camera frame (reference kitti_utils.py:605-640):
    t is the BOTTOM center; ry rotates about the camera Y axis."""
    c, s = np.cos(obj.ry), np.sin(obj.ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    l, w, h = obj.l, obj.w, obj.h
    xs = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    ys = [0, 0, 0, 0, -h, -h, -h, -h]
    zs = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    corners = rot @ np.array([xs, ys, zs])
    return (corners + np.asarray(obj.t)[:, None]).T

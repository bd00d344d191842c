"""Fabricated mini nuScenes dataroot with known geometry, for the port.

The same dataroot as tests/nusc_fixture.py (real v1.0-format JSON tables,
LiDAR sweep .bin files, a map-expansion JSON and 2D mask artifacts), written
through the port's config and artifact store: it needs only numpy, scipy,
PIL and the port (no JAX), so `chip_smoke.py` and the card tests can use it.
"""

from __future__ import annotations

import json
import secrets
from pathlib import Path

import numpy as np

from cm3d_tpu_torch.config import SHAPE_PRIORS_CHATGPT
from cm3d_tpu_torch.datasets.artifacts import FrameMasks, MaskArtifactStore

VERSION = "v1.0-fake"
LOCATION = "fakeville"
FULL_W, FULL_H = 1600, 900
MASK_W, MASK_H = 1024, 576
RATIO = 0.64
FOCAL = 800.0

CAM_LIST = [
    "CAM_FRONT",
    "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT",
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_FRONT_LEFT",
]

CLASS_TO_CATEGORY = {
    "car": "vehicle.car",
    "truck": "vehicle.truck",
    "pedestrian": "human.pedestrian.adult",
    "traffic_cone": "movable_object.trafficcone",
}
ATTR_FOR_CLASS = {
    "car": "vehicle.stopped",
    "truck": "vehicle.stopped",
    "pedestrian": "pedestrian.standing",
    "traffic_cone": "",
}


def _tok() -> str:
    return secrets.token_hex(16)


def _axes_swap():
    # optical frame: z forward, x right, y down
    return np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], float)


def _rotmat_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], float)


def _mat_to_quat(m):
    from scipy.spatial.transform import Rotation as R

    q = R.from_matrix(m).as_quat()  # xyzw
    return [float(q[3]), float(q[0]), float(q[1]), float(q[2])]


def make_fake_nuscenes(
    root: Path,
    mask_dir: Path,
    n_frames: int = 2,
    n_objects: int = 8,
    seed: int = 0,
    bg_points: int = 4000,
):
    """Build the dataroot; returns per-frame GT object list."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    (root / VERSION).mkdir(parents=True, exist_ok=True)
    (root / "sweeps").mkdir(exist_ok=True)
    (root / "maps" / "expansion").mkdir(parents=True, exist_ok=True)

    scene_name = "scene-0001"
    scene_token = _tok()
    log_token = _tok()

    # --- sensors / calibration ---
    lidar_cs_token = _tok()
    lidar_cs = {
        "token": lidar_cs_token,
        "sensor_token": _tok(),
        "translation": [0.0, 0.0, 1.8],
        "rotation": [1.0, 0.0, 0.0, 0.0],
        "camera_intrinsic": [],
    }
    cam_cs = []
    for ci, cam in enumerate(CAM_LIST):
        heading = 2 * np.pi * ci / len(CAM_LIST)
        rot = _rotmat_z(heading) @ _axes_swap()
        cam_cs.append(
            {
                "token": _tok(),
                "sensor_token": _tok(),
                "translation": [1.0, 0.0, 1.6],
                "rotation": _mat_to_quat(rot),
                "camera_intrinsic": [
                    [FOCAL, 0.0, FULL_W / 2],
                    [0.0, FOCAL, FULL_H / 2],
                    [0.0, 0.0, 1.0],
                ],
            }
        )

    # --- objects (static across frames, known global geometry) ---
    objects = []
    names = list(CLASS_TO_CATEGORY.keys())
    for j in range(n_objects):
        cam_idx = j % len(CAM_LIST)
        heading = 2 * np.pi * cam_idx / len(CAM_LIST)
        dist = rng.uniform(8, 30)
        name = names[j % len(names)]
        w, l, h = SHAPE_PRIORS_CHATGPT[name]
        center = np.array(
            [dist * np.cos(heading), dist * np.sin(heading), 0.2 + h / 2]
        )
        objects.append(
            {"name": name, "center": center, "size": (w, l, h), "cam": cam_idx}
        )

    # --- per-frame tables + data ---
    samples, sample_datas, ego_poses, annotations, instances = [], [], [], [], []
    attr_tokens = {}
    attributes = []
    for attr in set(ATTR_FOR_CLASS.values()):
        if attr:
            t = _tok()
            attr_tokens[attr] = t
            attributes.append({"token": t, "name": attr, "description": ""})

    categories = [
        {"token": _tok(), "name": cat, "description": ""}
        for cat in set(CLASS_TO_CATEGORY.values())
    ]

    sample_tokens = [_tok() for _ in range(n_frames)]
    lidar_sd_tokens = [_tok() for _ in range(n_frames)]
    inst_tokens = [_tok() for _ in objects]
    ann_tokens = [[_tok() for _ in objects] for _ in range(n_frames)]

    store = MaskArtifactStore(mask_dir)
    ego_t = np.zeros(3)

    for f in range(n_frames):
        ts = 1_000_000 * (1 + f)
        sample = {
            "token": sample_tokens[f],
            "timestamp": ts,
            "scene_token": scene_token,
            "next": sample_tokens[f + 1] if f + 1 < n_frames else "",
            "prev": sample_tokens[f - 1] if f > 0 else "",
            "data": {},
            "anns": ann_tokens[f],
        }
        ego_pose_token = _tok()
        ego_poses.append(
            {
                "token": ego_pose_token,
                "timestamp": ts,
                "translation": list(ego_t),
                "rotation": [1.0, 0.0, 0.0, 0.0],
            }
        )

        # LiDAR points in SENSOR frame: object clusters + ground
        pts = []
        for obj in objects:
            local = obj["center"] - np.array([0.0, 0.0, 1.8])  # sensor frame
            npts = int(rng.integers(60, 200))
            spread = np.array(obj["size"]) / 4
            cluster = rng.normal(0, 1, (npts, 3)) * spread
            if obj["name"] in ("car", "truck"):
                # LiDAR sees the NEAR surface: reflect the cluster onto the
                # ego-facing half (the lift's pushback assumes this).
                u = obj["center"][:2] / np.linalg.norm(obj["center"][:2])
                radial = cluster[:, :2] @ u
                cluster[:, :2] -= ((radial + np.abs(radial)))[:, None] * u[None, :]
            pts.append(local + cluster)
        ground = rng.uniform([-50, -50, -1.9], [50, 50, -1.5], (bg_points, 3))
        pts.append(ground)
        pts = np.concatenate(pts).astype(np.float32)
        raw = np.zeros((len(pts), 5), np.float32)
        raw[:, :3] = pts
        raw[:, 3] = rng.random(len(pts))
        fname = f"sweeps/lidar_{f}.bin"
        raw.tofile(root / fname)

        sample_datas.append(
            {
                "token": lidar_sd_tokens[f],
                "sample_token": sample_tokens[f],
                "ego_pose_token": ego_pose_token,
                "calibrated_sensor_token": lidar_cs_token,
                "timestamp": ts,
                "fileformat": "bin",
                "is_key_frame": True,
                "filename": fname,
                "channel": "LIDAR_TOP",
                "next": lidar_sd_tokens[f + 1] if f + 1 < n_frames else "",
                "prev": lidar_sd_tokens[f - 1] if f > 0 else "",
            }
        )
        sample["data"]["LIDAR_TOP"] = lidar_sd_tokens[f]

        # cameras + masks
        masks = np.zeros((len(objects), MASK_W, MASK_H), np.uint8)
        labels, scores, cams = [], [], []
        mi = 0
        for ci, cam in enumerate(CAM_LIST):
            # tiny camera jpg so the mask-stage CLI can run on the fixture
            from PIL import Image

            (root / "samples" / cam).mkdir(parents=True, exist_ok=True)
            img = (rng.random((90, 160, 3)) * 80 + 60).astype(np.uint8)
            Image.fromarray(img).save(root / "samples" / cam / f"fake_{f}.jpg")
            sd_token = _tok()
            sample_datas.append(
                {
                    "token": sd_token,
                    "sample_token": sample_tokens[f],
                    "ego_pose_token": ego_pose_token,
                    "calibrated_sensor_token": cam_cs[ci]["token"],
                    "timestamp": ts,
                    "fileformat": "jpg",
                    "is_key_frame": True,
                    "filename": f"samples/{cam}/fake_{f}.jpg",
                    "channel": cam,
                    "next": "",
                    "prev": "",
                }
            )
            sample["data"][cam] = sd_token

        for obj in objects:
            ci = obj["cam"]
            cs = cam_cs[ci]
            rot = np.array(
                _rotmat_z(2 * np.pi * ci / len(CAM_LIST)) @ _axes_swap()
            )
            p = obj["center"] - np.asarray(cs["translation"])
            p = rot.T @ p
            if p[2] < 1.0:
                continue
            k = np.asarray(cs["camera_intrinsic"]) * RATIO
            k[2, 2] = 1.0
            uvw = k @ p
            px, py = uvw[0] / uvw[2], uvw[1] / uvw[2]
            if not (4 < px < MASK_W - 4 and 4 < py < MASK_H - 4):
                continue
            rx = max(6, int(FOCAL * RATIO * max(obj["size"][:2]) / (2 * p[2])))
            ry = max(6, int(FOCAL * RATIO * obj["size"][2] / (2 * p[2])))
            xs = np.arange(MASK_W)[:, None]
            ys = np.arange(MASK_H)[None, :]
            masks[mi] = (((xs - px) / rx) ** 2 + ((ys - py) / ry) ** 2 <= 1.0)
            labels.append(obj["name"])
            scores.append(float(rng.uniform(0.5, 1.0)))
            cams.append(ci)
            mi += 1
        store.write_frame(
            scene_name,
            f,
            FrameMasks(labels, scores, cams, masks[:mi]),
        )

        # annotations
        for j, obj in enumerate(objects):
            w, l, h = obj["size"]
            attr = ATTR_FOR_CLASS[obj["name"]]
            annotations.append(
                {
                    "token": ann_tokens[f][j],
                    "sample_token": sample_tokens[f],
                    "instance_token": inst_tokens[j],
                    "translation": [float(v) for v in obj["center"]],
                    "size": [w, l, h],
                    "rotation": [1.0, 0.0, 0.0, 0.0],
                    "num_lidar_pts": 100,
                    "num_radar_pts": 0,
                    "category_name": CLASS_TO_CATEGORY[obj["name"]],
                    "attribute_tokens": [attr_tokens[attr]] if attr else [],
                    "visibility_token": "4",
                    "prev": ann_tokens[f - 1][j] if f > 0 else "",
                    "next": ann_tokens[f + 1][j] if f + 1 < n_frames else "",
                }
            )
        samples.append(sample)

    store.mark_scene_complete(scene_name, n_frames)

    for j, obj in enumerate(objects):
        instances.append(
            {
                "token": inst_tokens[j],
                "category_token": categories[0]["token"],
                "nbr_annotations": n_frames,
                "first_annotation_token": ann_tokens[0][j],
                "last_annotation_token": ann_tokens[-1][j],
            }
        )

    scene = {
        "token": scene_token,
        "name": scene_name,
        "log_token": log_token,
        "nbr_samples": n_frames,
        "first_sample_token": sample_tokens[0],
        "last_sample_token": sample_tokens[-1],
        "description": "fabricated",
    }
    log = {
        "token": log_token,
        "logfile": "fake",
        "vehicle": "fake",
        "date_captured": "2026-01-01",
        "location": LOCATION,
    }

    tables = {
        "scene": [scene],
        "log": [log],
        "sample": samples,
        "sample_data": sample_datas,
        "ego_pose": ego_poses,
        "calibrated_sensor": [lidar_cs] + cam_cs,
        "sample_annotation": annotations,
        "instance": instances,
        "category": categories,
        "attribute": attributes,
        "sensor": [],
        "map": [],
    }
    for name, rows in tables.items():
        (root / VERSION / f"{name}.json").write_text(json.dumps(rows))

    # --- map expansion: drivable square + 4 straight lanes ---
    corners = [(-60, -60), (60, -60), (60, 60), (-60, 60)]
    nodes = [{"token": _tok(), "x": float(x), "y": float(y)} for x, y in corners]
    polygon = {
        "token": _tok(),
        "exterior_node_tokens": [n["token"] for n in nodes],
        "holes": [],
    }
    lanes = []
    arclines = {}
    for i, yaw in enumerate([0.0, np.pi / 2, np.pi, -np.pi / 2]):
        t = _tok()
        lanes.append({"token": t, "lane_type": "CAR"})
        start = [-40 * np.cos(yaw), -40 * np.sin(yaw), yaw]
        arclines[t] = [
            {
                "start_pose": [float(v) for v in start],
                "end_pose": [float(-start[0]), float(-start[1]), float(yaw)],
                "shape": "LSR",
                "radius": 1e6,
                "segment_length": [0.0, 80.0, 0.0],
            }
        ]
    map_json = {
        "node": nodes,
        "polygon": [polygon],
        "line": [],
        "drivable_area": [{"token": _tok(), "polygon_tokens": [polygon["token"]]}],
        "lane": lanes,
        "lane_connector": [],
        "arcline_path_3": arclines,
    }
    (root / "maps" / "expansion" / f"{LOCATION}.json").write_text(
        json.dumps(map_json)
    )

    return {
        "scene_name": scene_name,
        "sample_tokens": sample_tokens,
        "objects": objects,
    }

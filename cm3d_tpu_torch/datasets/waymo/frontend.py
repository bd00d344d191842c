"""Waymo keyframe builder + prediction/GT writers. Mirrors
`cm3d_tpu/datasets/waymo/frontend.py`; the range-image unprojection runs
the port's torch op (`ops/range_image.py`) on the device the frontend is
given, and keyframes come back as numpy `Keyframe`s.

Input is the "frame-lite" exchange format: per-scene directories of
per-frame ``.npz`` files holding exactly what the pipeline needs from a
dataset_pb2.Frame (scripts/export_waymo_frames.py produces them in an
environment that has tensorflow + waymo_open_dataset; this framework itself
is TF-free). Fields:

  context_name (str), timestamp_micros (int64), pose [4,4] vehicle->global,
  range_image [H,W] float32 (first return),
  range_image_pose [H,W,6] float32 (roll pitch yaw x y z per-pixel
  vehicle->global, TOP rolling shutter; empty [0] when the segment lacks
  it — points then stay uncorrected), inclinations [H],
  lidar_extrinsic [4,4], cam_intrinsic [C,9] (f_u f_v c_u c_v k1 k2 p1 p2 k3),
  cam_extrinsic [C,4,4] camera->vehicle (Waymo x-forward axes),
  lane_polylines: object array of [Ni,3] global xyz polylines,
  labels_box [L,7] (cx cy cz w l h heading, vehicle frame),
  labels_type [L], labels_num_points [L], labels_id [L] strings.

Reference semantics reproduced (src/waymo/2d_to_3d.py):
- single return, no sweep aggregation (:484-486)
- camera extrinsic times the inverse optical-axes swap (:561-575)
- lane yaws by finite differences, first point copying the second (:374-388)
- vehicle->global via frame.pose for lane assignment (:682-690) and back to
  vehicle frame for the emitted boxes (:812-816)
- intrinsics scaled by the 1024/1920 thumbnail ratio (:523)
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cm3d_tpu_torch.config import CLASS_TO_ID, LiftStageConfig, NUSCENES_CLASSES
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore, paste_mask_canvas
from cm3d_tpu_torch.datasets.nuscenes.frontend import get_detection_name
from cm3d_tpu_torch.datasets.types import CameraParams, Keyframe
from cm3d_tpu_torch.datasets.waymo.proto import (
    LABEL_TYPE_CYCLIST,
    LABEL_TYPE_PEDESTRIAN,
    LABEL_TYPE_VEHICLE,
    WaymoBox,
    WaymoObject,
    encode_objects,
)
from cm3d_tpu_torch.ops.bitmask import pack_masks_np
from cm3d_tpu_torch.vocab import NUSC_TO_WAYMO

# reference axes_transformation (waymo/2d_to_3d.py:557-563): optical->waymo
_AXES = np.array(
    [[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0], [0, 0, 0, 1]], np.float64
)

WAYMO_IMAGE_RATIO = 1024.0 / 1920.0  # reference :523
# The two-stage path's mask canvas: the 1920x1280 front cameras after the
# 1024 thumbnail (PIL rounds 682.7 to 683; the side cameras' 1920x886 give
# 1024x473 and fit inside). DIVERGENCE: the JAX frontend's default is
# (1024, 664), shorter than a front camera's masks, so its two-stage path
# refuses real-size artifacts (`paste_mask_canvas` raises).
WAYMO_MASK_WH = (1024, 683)

NUSC_CLASS_TO_WAYMO_TYPE = {
    "vehicle": LABEL_TYPE_VEHICLE,
    "pedestrian": LABEL_TYPE_PEDESTRIAN,
    "cyclist": LABEL_TYPE_CYCLIST,
}


def lane_yaws_from_polyline(poly_xyz: np.ndarray) -> np.ndarray:
    """Reference get_yaws_from_lane_coords (:374-388): finite-difference
    yaws with prev starting at the origin; first yaw copies the second."""
    out = np.zeros((len(poly_xyz), 3), np.float64)
    prev = np.zeros(2)
    for i, p in enumerate(poly_xyz):
        out[i, :2] = p[:2]
        out[i, 2] = np.arctan2(p[1] - prev[1], p[0] - prev[0])
        prev = p[:2]
    if len(out) > 1:
        out[0, 2] = out[1, 2]
    return out


def _mat_to_quat_wxyz(m: np.ndarray) -> np.ndarray:
    from scipy.spatial.transform import Rotation as R

    q = R.from_matrix(m).as_quat()
    return np.array([q[3], q[0], q[1], q[2]], np.float32)


@dataclasses.dataclass
class WaymoFrameMeta:
    context_name: str
    timestamp_micros: int
    scene_name: str
    frame_num: int
    pose: np.ndarray  # [4,4] vehicle -> global


class WaymoFrontend:
    def __init__(
        self,
        frames_root: str | Path,
        mask_store: MaskArtifactStore,
        lift_cfg: LiftStageConfig = None,
        mask_wh: Tuple[int, int] = WAYMO_MASK_WH,
        device=None,
    ):
        """device: where the range image is unprojected (CUDA unless the
        caller asks for another; resolved at the first keyframe, so a
        frontend that only reads frames needs no card)."""
        from cm3d_tpu_torch.config import WAYMO_LIFT

        self.device = device
        self.root = Path(frames_root)
        self.store = mask_store
        self.cfg = lift_cfg if lift_cfg is not None else WAYMO_LIFT
        self.mask_wh = mask_wh
        self._seg_index: dict = {}  # raw segment -> [(offset, length)]

    def scene_names(self) -> List[str]:
        """Frame-lite scene dirs AND raw .tfrecord segments, both first-
        class (raw ingestion is TF-free via frame_proto.parse_frame).
        A scene present in BOTH forms (npz cache exported next to its raw
        segment) is listed once; load_frame_by_index prefers the raw
        segment, which is the source of truth the cache was exported
        from."""
        dirs = sorted(p.name for p in self.root.iterdir() if p.is_dir())
        segs = sorted(
            p.name[: -len(".tfrecord")] for p in self.root.glob("*.tfrecord")
        )
        seen = set(dirs)
        return dirs + [s for s in segs if s not in seen]

    def _segment_path(self, scene: str) -> Optional[Path]:
        p = self.root / f"{scene}.tfrecord"
        return p if p.exists() else None

    def _index(self, seg: Path) -> list:
        if seg not in self._seg_index:
            from cm3d_tpu_torch.datasets.waymo.tfrecord import index_records

            self._seg_index[seg] = index_records(seg)
        return self._seg_index[seg]

    def num_frames(self, scene: str) -> int:
        seg = self._segment_path(scene)
        if seg is not None:
            return len(self._index(seg))
        return len(self.frame_files(scene))

    def load_frame_by_index(
        self, scene: str, i: int, want_pose: bool = True
    ) -> dict:
        """Frame dict (frame-lite contract) by scene + frame number, from
        either the npz cache or a raw TFRecord segment. want_pose=False
        skips the rolling-shutter pose image decompress for consumers that
        never unproject points (the mask stage)."""
        seg = self._segment_path(scene)
        if seg is not None:
            from cm3d_tpu_torch.datasets.waymo.frame_proto import parse_frame
            from cm3d_tpu_torch.datasets.waymo.tfrecord import read_record

            off, ln = self._index(seg)[i]
            return parse_frame(read_record(seg, off, ln), want_pose=want_pose)
        return self.load_frame(self.frame_files(scene)[i])

    def frame_files(self, scene: str) -> List[Path]:
        return sorted((self.root / scene).glob("frame_*.npz"))

    def load_frame(self, path: Path) -> dict:
        with np.load(path, allow_pickle=True) as z:
            return {k: z[k] for k in z.files}

    def build_keyframe(
        self, scene: str, frame_num: int, fr: dict, packed: Optional[Tuple] = None
    ) -> Optional[Tuple[Keyframe, WaymoFrameMeta]]:
        """Keyframe from a frame dict + masks.

        packed: optional (labels [M] str, scores [M], cams [M], mask_bits
        [W, H, ceil(max_masks/32)] uint32) — the fused masks->lift path
        (mask-stage device bit-planes pass straight through, mirroring
        NuScenesFrontend.assemble_keyframe). None reads the artifact store
        (the reference's two-stage on-disk contract, waymo/2d_to_3d.py
        :437-455)."""
        import torch

        from cm3d_tpu_torch.ops.range_image import pixel_pose_matrices, range_image_to_points
        from cm3d_tpu_torch.utils.device import resolve_device

        cfg = self.cfg
        if packed is None:
            fm = self.store.read_frame(scene, frame_num)
            if fm is None:
                return None
            labels_raw, scores_raw, cams_raw = (
                fm.labels, fm.detection_scores, fm.cam_nums
            )
        else:
            labels_raw, scores_raw, cams_raw, packed_bits = packed

        pose = np.asarray(fr["pose"], np.float64)
        # points: vehicle frame, then vehicle->global (lane frame).
        # TOP-lidar rolling shutter: when the frame carries the per-pixel
        # pose image, points are corrected to the frame's vehicle frame
        # exactly like the reference's convert_range_image_to_point_cloud
        # (waymo/2d_to_3d.py:473-474) — up to ~1 m at highway speed.
        ri_pose = np.asarray(fr.get("range_image_pose",
                                    np.zeros(0, np.float32)))
        ri_shape = tuple(np.asarray(fr["range_image"]).shape)
        if ri_pose.size and (
            ri_pose.ndim != 3
            or ri_pose.shape[:2] != ri_shape
            or ri_pose.shape[-1] != 6
        ):
            # npz caches bypass parse_frame's validation; keep the
            # skip-and-log contract instead of a cryptic einsum crash.
            print(f"{scene} frame {frame_num}: range_image_pose shape "
                  f"{ri_pose.shape} mismatches range image {ri_shape} — "
                  f"frame skipped")
            return None
        device = resolve_device(self.device)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        pose_kw = {}
        if ri_pose.size:
            pose_kw = dict(
                pixel_pose=pixel_pose_matrices(dev(ri_pose)),
                frame_pose_inv=dev(np.linalg.inv(pose)),
            )
        pts_veh, valid = range_image_to_points(
            dev(fr["range_image"]),
            dev(fr["inclinations"]),
            dev(fr["lidar_extrinsic"]),
            **pose_kw,
        )
        pts_veh = pts_veh[valid].cpu().numpy()
        pts_global = pts_veh @ pose[:3, :3].T + pose[:3, 3]

        n = cfg.max_points
        points = np.zeros((n, 4), np.float32)
        point_valid = np.zeros(n, bool)
        n_real = min(len(pts_global), n)
        points[:n_real, :3] = pts_global[:n_real]
        point_valid[:n_real] = True

        # cameras: vehicle pose is the per-camera "ego pose"
        cam_intr = np.asarray(fr["cam_intrinsic"], np.float64)
        cam_ext = np.asarray(fr["cam_extrinsic"], np.float64)
        c = cam_ext.shape[0]
        ego_t = np.tile(pose[:3, 3].astype(np.float32), (c, 1))
        ego_q = np.tile(_mat_to_quat_wxyz(pose[:3, :3]), (c, 1))
        cam_t = np.zeros((c, 3), np.float32)
        cam_q = np.zeros((c, 4), np.float32)
        intr = np.zeros((c, 3, 3), np.float32)
        for i in range(c):
            tm = cam_ext[i] @ np.linalg.inv(_AXES)  # reference :561-566
            cam_t[i] = tm[:3, 3]
            cam_q[i] = _mat_to_quat_wxyz(tm[:3, :3])
            k = np.array(
                [
                    [cam_intr[i][0], 0, cam_intr[i][2]],
                    [0, cam_intr[i][1], cam_intr[i][3]],
                    [0, 0, 1],
                ]
            )
            k = k * WAYMO_IMAGE_RATIO
            k[2, 2] = 1.0
            intr[i] = k

        w, h = self.mask_wh
        m_pad = cfg.max_masks
        m_real = min(len(labels_raw), m_pad)
        if packed is None:
            masks = np.zeros((m_pad, w, h), bool)
        mask_cam = np.zeros(m_pad, np.int32)
        mask_label = np.zeros(m_pad, np.int32)
        mask_score = np.zeros(m_pad, np.float32)
        mask_valid = np.zeros(m_pad, bool)
        for i in range(m_real):
            name = get_detection_name(labels_raw[i])
            if name not in CLASS_TO_ID:
                continue
            if packed is None:
                paste_mask_canvas(masks, i, fm.masks[i], w, h)
            mask_cam[i] = cams_raw[i]
            mask_label[i] = CLASS_TO_ID[name]
            mask_score[i] = scores_raw[i]
            mask_valid[i] = True
        mask_bits = packed_bits if packed is not None else pack_masks_np(masks)

        lane_pts = []
        for poly in fr["lane_polylines"]:
            lane_pts.append(lane_yaws_from_polyline(np.asarray(poly)))
        lanes_all = (
            np.concatenate(lane_pts, axis=0) if lane_pts else np.zeros((0, 3))
        )
        l_pad = cfg.max_lane_points
        lanes = np.zeros((l_pad, 3), np.float32)
        lane_valid = np.zeros(l_pad, bool)
        l_real = min(len(lanes_all), l_pad)
        lanes[:l_real] = lanes_all[:l_real]
        lane_valid[:l_real] = True

        kf = Keyframe(
            points=points,
            point_valid=point_valid,
            cameras=CameraParams(ego_t, ego_q, cam_t, cam_q, intr),
            mask_bits=mask_bits,
            mask_cam=mask_cam,
            mask_label=mask_label,
            mask_score=mask_score,
            mask_valid=mask_valid,
            lane_points=lanes,
            lane_valid=lane_valid,
            ego_translation=pose[:3, 3].astype(np.float32),
        )
        meta = WaymoFrameMeta(
            str(fr["context_name"]),
            int(fr["timestamp_micros"]),
            scene,
            frame_num,
            pose,
        )
        return kf, meta

    def iter_scene(self, scene: str) -> Iterator[Tuple[Keyframe, WaymoFrameMeta]]:
        """Skip-and-log on corrupt frames (SURVEY.md §5 failure-detection
        contract): a proto that fails to parse drops that frame only; a
        container-level error (CRC mismatch / truncation) loses record
        framing, so the scene stops there with a log instead of crashing
        the whole run."""
        seg = self._segment_path(scene)
        if seg is not None:  # raw segment: one sequential pass, no index
            from cm3d_tpu_torch.datasets.waymo.frame_proto import parse_frame
            from cm3d_tpu_torch.datasets.waymo.tfrecord import TFRecordReader

            records = iter(enumerate(TFRecordReader(seg)))
            while True:
                try:
                    frame_num, payload = next(records)
                except StopIteration:
                    return
                except (IOError, struct.error) as e:
                    print(f"{scene}: segment unreadable, stopping scene "
                          f"({e})")
                    return
                try:
                    fr = parse_frame(payload)
                except Exception as e:
                    print(f"{scene} frame {frame_num}: corrupt frame "
                          f"skipped ({e})")
                    continue
                built = self.build_keyframe(scene, frame_num, fr)
                if built is not None:
                    yield built
        for frame_num, path in enumerate(self.frame_files(scene)):
            try:
                fr = self.load_frame(path)
            except Exception as e:
                print(f"{scene} frame {frame_num}: corrupt frame-lite "
                      f"skipped ({path.name}: {e})")
                continue
            built = self.build_keyframe(scene, frame_num, fr)
            if built is not None:
                yield built


def ring_images(fr: dict, thumbnail: int = 1024) -> List[np.ndarray]:
    """A frame's camera JPEGs as RGB uint8 arrays, each thumbnailed to
    `thumbnail` on its longest side (PIL, as the reference): the mask
    stage's ring, mixed in size (1920x1280 front, 1920x886 side)."""
    import io

    from PIL import Image

    images = []
    for buf in fr["cam_images_jpeg"]:
        im = Image.open(io.BytesIO(bytes(buf))).convert("RGB")
        im.thumbnail((thumbnail, thumbnail))
        images.append(np.asarray(im))
    return images


def boxes_to_waymo_objects(
    meta: WaymoFrameMeta,
    centers: np.ndarray,  # [M, 3] GLOBAL frame
    sizes: np.ndarray,  # [M, 3] (w, l, h)
    yaws: np.ndarray,  # [M] global-frame yaw
    scores: np.ndarray,
    labels: np.ndarray,
    keep: np.ndarray,
    classes=NUSCENES_CLASSES,
) -> List[WaymoObject]:
    """Device outputs -> metrics_pb2 Objects in the VEHICLE frame
    (reference :812-816, 1031-1061). Classes outside NUSC_TO_WAYMO are
    dropped (cone/barrier have no Waymo type)."""
    inv = np.linalg.inv(meta.pose)
    pose_yaw = np.arctan2(meta.pose[1, 0], meta.pose[0, 0])
    out = []
    for i in np.flatnonzero(np.asarray(keep)):
        name = classes[int(labels[i])]
        wname = NUSC_TO_WAYMO.get(name)
        if wname is None:
            continue
        cv = inv[:3, :3] @ np.asarray(centers[i], np.float64) + inv[:3, 3]
        o = WaymoObject(
            box=WaymoBox(
                center_x=float(cv[0]),
                center_y=float(cv[1]),
                center_z=float(cv[2]),
                width=float(sizes[i][0]),
                length=float(sizes[i][1]),
                height=float(sizes[i][2]),
                heading=float(yaws[i] - pose_yaw),
            ),
            type=NUSC_CLASS_TO_WAYMO_TYPE[wname],
            id="unique object tracking ID",  # reference :1044
            score=float(scores[i]),
            frame_timestamp_micros=meta.timestamp_micros,
            context_name=meta.context_name,
        )
        out.append(o)
    return out


def create_gt_bin(frames_root: str | Path, out_path: str) -> int:
    """Reference create_gt_bin.py: laser_labels -> metrics_pb2.Objects bin.

    Consumes frame-lite npz scene dirs AND raw .tfrecord segments (via the
    TF-free frame_proto parser)."""
    root = Path(frames_root)
    objs: List[WaymoObject] = []

    def _add(fr: dict) -> None:
        ctx = str(fr["context_name"])
        ts = int(fr["timestamp_micros"])
        for b, t, np_, oid in zip(
            fr["labels_box"], fr["labels_type"], fr["labels_num_points"],
            fr["labels_id"],
        ):
            objs.append(
                WaymoObject(
                    box=WaymoBox(*[float(v) for v in b]),
                    type=int(t),
                    id=str(oid),
                    num_lidar_points_in_box=int(np_),
                    score=0.5,  # reference create_gt_bin.py:24
                    frame_timestamp_micros=ts,
                    context_name=ctx,
                )
            )

    for scene_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        for path in sorted(scene_dir.glob("frame_*.npz")):
            with np.load(path, allow_pickle=True) as z:
                _add({k: z[k] for k in z.files})
    for seg in sorted(root.glob("*.tfrecord")):
        from cm3d_tpu_torch.datasets.waymo.frame_proto import parse_frame
        from cm3d_tpu_torch.datasets.waymo.tfrecord import TFRecordReader

        for payload in TFRecordReader(seg):
            _add(parse_frame(payload, want_pose=False))
    with open(out_path, "wb") as f:
        f.write(encode_objects(objs))
    return len(objs)

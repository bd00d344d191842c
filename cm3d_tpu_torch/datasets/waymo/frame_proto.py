"""TF-free dataset_pb2.Frame subset codec (raw Waymo TFRecord ingestion).

The reference consumes raw Waymo segments via TensorFlow + the
waymo_open_dataset wheel (src/waymo/2d_to_3d.py:444-446 TFRecord ->
Frame.ParseFromString; range image decode :472-474). This module parses the
Frame subset the pipeline needs straight off the protobuf wire — range
image (zlib MatrixFloat), laser/camera calibrations, pose, camera JPEG
bytes, map lane polylines, laser_labels — so `WaymoFrontend` reads
`.tfrecord` segments directly and `scripts/export_waymo_frames.py` becomes
an optional cache step.

Field numbers are NOT hand-copied from documentation: they are validated
against the serialized FileDescriptorProto embedded in the reference's own
compute_detection_metrics_main ELF (extracted to
tests/fixtures/waymo_{dataset,map}_descriptor.bin;
tests/test_waymo_frame_proto.py re-derives every number below from those
descriptors). dataset.proto: Frame{context=1, timestamp_micros=2, pose=3,
images=4, lasers=5, laser_labels=6, map_features=10}; Context{name=1,
camera_calibrations=2, laser_calibrations=3}; CameraCalibration{name=1,
intrinsic=2, extrinsic=3, width=4, height=5}; LaserCalibration{name=1,
beam_inclinations=2, beam_inclination_min=3, beam_inclination_max=4,
extrinsic=5}; Transform{transform=1}; Laser{name=1, ri_return1=2};
RangeImage{range_image=1 (deprecated), range_image_compressed=2,
range_image_pose_compressed=4 — the TOP lidar's per-pixel rolling-shutter
pose [H, W, 6] (roll, pitch, yaw, x, y, z), vehicle->global at each
pixel's capture time};
MatrixFloat{data=1 packed, shape=2}; MatrixShape{dims=1};
CameraImage{name=1, image=2}. map.proto: MapFeature{id=1, lane=3};
LaneCenter{polyline=8}; MapPoint{x=1, y=2, z=3}. Protos are proto2:
repeated doubles are unpacked on the wire (MatrixFloat.data IS packed);
the readers below accept both forms.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np

from cm3d_tpu_torch.datasets.waymo.proto import (
    _bytes_field,
    _double_field,
    _iter_fields,
    _read_varint,
    _varint_field,
)

LASER_TOP = 1  # LaserName.TOP


def _object_array(items: list) -> np.ndarray:
    """1-D object array of arbitrary payloads. np.array(list, dtype=object)
    COLLAPSES to a 2-D object array when the payloads happen to have equal
    length (or when there is exactly one), after which bytes(row) returns
    pointer garbage — build the array explicitly instead."""
    out = np.empty(len(items), object)
    for i, it in enumerate(items):
        out[i] = it
    return out


def _repeated_double(values: list, wire: int, v) -> None:
    """Accumulate a repeated double field: unpacked (wire 1) or packed."""
    if wire == 1:
        values.append(float(v))
    elif wire == 2:
        if len(v) % 8:
            raise ValueError("packed double field not a multiple of 8 bytes")
        values.extend(np.frombuffer(v, "<f8"))


def _transform(buf: bytes) -> np.ndarray:
    vals: List[float] = []
    for field, wire, v in _iter_fields(buf):
        if field == 1:
            _repeated_double(vals, wire, v)
    return np.array(vals, np.float64).reshape(4, 4)


def _matrix_float(buf: bytes) -> np.ndarray:
    chunks: List[np.ndarray] = []
    dims: List[int] = []
    for field, wire, v in _iter_fields(buf):
        if field == 1:  # packed floats (packed=true in dataset.proto)
            if wire == 2:
                # zero-copy view: the TOP range image is ~680k floats/frame
                # and the raw-ingest hot path parses one per frame
                if len(v) % 4:
                    raise ValueError(
                        "packed float field not a multiple of 4 bytes"
                    )
                chunks.append(np.frombuffer(v, "<f4"))
            elif wire == 5:
                chunks.append(np.array([v], np.float32))
        elif field == 2 and wire == 2:  # MatrixShape
            for sf, sw, sv in _iter_fields(v):
                if sf == 1:
                    if sw == 0:
                        dims.append(int(sv))
                    elif sw == 2:  # packed varints
                        pos = 0
                        while pos < len(sv):
                            x, pos = _read_varint(sv, pos)
                            dims.append(x)
    data = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return data.astype(np.float32, copy=False).reshape(dims)


def _parse_laser_calibration(buf: bytes) -> dict:
    out = {"name": 0, "beam_inclinations": [], "beam_inclination_min": 0.0,
           "beam_inclination_max": 0.0, "extrinsic": None}
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 0:
            out["name"] = int(v)
        elif field == 2:
            _repeated_double(out["beam_inclinations"], wire, v)
        elif field == 3 and wire == 1:
            out["beam_inclination_min"] = float(v)
        elif field == 4 and wire == 1:
            out["beam_inclination_max"] = float(v)
        elif field == 5 and wire == 2:
            out["extrinsic"] = _transform(v)
    return out


def _parse_camera_calibration(buf: bytes) -> dict:
    out = {"name": 0, "intrinsic": [], "extrinsic": None, "width": 0,
           "height": 0}
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 0:
            out["name"] = int(v)
        elif field == 2:
            _repeated_double(out["intrinsic"], wire, v)
        elif field == 3 and wire == 2:
            out["extrinsic"] = _transform(v)
        elif field == 4 and wire == 0:
            out["width"] = int(v)
        elif field == 5 and wire == 0:
            out["height"] = int(v)
    return out


def _parse_label(buf: bytes) -> dict:
    """label_pb2.Label subset (box=1, type=3, id=4, num_points=7)."""
    from cm3d_tpu_torch.datasets.waymo.proto import WaymoBox

    out = {"box": None, "type": 0, "id": "", "num_points": 0}
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 2:
            out["box"] = WaymoBox.from_bytes(v)
        elif field == 3 and wire == 0:
            out["type"] = int(v)
        elif field == 4 and wire == 2:
            out["id"] = v.decode(errors="replace")
        elif field == 7 and wire == 0:
            out["num_points"] = int(v)
    return out


def _parse_lane_polyline(lane_buf: bytes) -> Optional[np.ndarray]:
    pts: List[List[float]] = []
    for field, wire, v in _iter_fields(lane_buf):
        if field == 8 and wire == 2:  # repeated MapPoint polyline
            x = y = z = 0.0
            for pf, pw, pv in _iter_fields(v):
                if pf == 1 and pw == 1:
                    x = float(pv)
                elif pf == 2 and pw == 1:
                    y = float(pv)
                elif pf == 3 and pw == 1:
                    z = float(pv)
            pts.append([x, y, z])
    if not pts:
        return None
    return np.array(pts, np.float64)


def parse_frame(buf: bytes, want_pose: bool = True) -> Dict:
    """Parse one serialized dataset_pb2.Frame into the frame-lite dict
    consumed by WaymoFrontend (same field contract as the npz exchange
    format — scripts/export_waymo_frames.py mirrors this logic under TF).

    want_pose=False skips decompressing the ~4 MB per-pixel rolling-shutter
    pose image (range_image_pose comes back empty) — consumers that never
    unproject points (the mask stage, create_gt_bin) shouldn't pay its zlib
    + reshape on every frame."""
    context_name = ""
    timestamp = 0
    pose = np.eye(4)
    laser_calibs: List[dict] = []
    cam_calibs: List[dict] = []
    images: List[tuple] = []  # (name, jpeg bytes)
    ri_compressed: Optional[bytes] = None
    ri_uncompressed: Optional[np.ndarray] = None
    ri_pose_compressed: Optional[bytes] = None
    lane_polylines: List[np.ndarray] = []
    labels: List[dict] = []

    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 2:  # Context
            for cf, cw, cv in _iter_fields(v):
                if cf == 1 and cw == 2:
                    context_name = cv.decode(errors="replace")
                elif cf == 2 and cw == 2:
                    cam_calibs.append(_parse_camera_calibration(cv))
                elif cf == 3 and cw == 2:
                    laser_calibs.append(_parse_laser_calibration(cv))
        elif field == 2 and wire == 0:
            timestamp = int(v)
        elif field == 3 and wire == 2:
            pose = _transform(v)
        elif field == 4 and wire == 2:  # CameraImage
            name, img = 0, b""
            for imf, imw, imv in _iter_fields(v):
                if imf == 1 and imw == 0:
                    name = int(imv)
                elif imf == 2 and imw == 2:
                    img = imv
            images.append((name, img))
        elif field == 5 and wire == 2:  # Laser
            lname, ri1 = 0, b""
            for lf, lw, lv in _iter_fields(v):
                if lf == 1 and lw == 0:
                    lname = int(lv)
                elif lf == 2 and lw == 2:
                    ri1 = lv
            if lname == LASER_TOP and ri1:
                for rf, rw, rv in _iter_fields(ri1):
                    if rf == 2 and rw == 2:
                        ri_compressed = rv
                    elif rf == 4 and rw == 2:  # rolling-shutter pixel pose
                        ri_pose_compressed = rv
                    elif rf == 1 and rw == 2:  # deprecated uncompressed
                        ri_uncompressed = _matrix_float(rv)
        elif field == 6 and wire == 2:
            labels.append(_parse_label(v))
        elif field == 10 and wire == 2:  # MapFeature
            for mf, mw, mv in _iter_fields(v):
                if mf == 3 and mw == 2:  # LaneCenter
                    poly = _parse_lane_polyline(mv)
                    if poly is not None:
                        lane_polylines.append(poly)

    # --- range image: [H, W, 4] MatrixFloat, channel 0 = range ---
    if ri_compressed is not None:
        ri = _matrix_float(zlib.decompress(ri_compressed))
    elif ri_uncompressed is not None:
        ri = ri_uncompressed
    else:
        raise ValueError("Frame has no TOP-laser first-return range image")
    range_image = ri[..., 0] if ri.ndim == 3 else ri
    # [H, W, 6] per-pixel vehicle->global pose (TOP rolling shutter); the
    # reference passes it into convert_range_image_to_point_cloud
    # (waymo/2d_to_3d.py:473-474) so unprojected points are corrected for
    # ego motion during the scan. Empty when the segment lacks it.
    if want_pose and ri_pose_compressed is not None:
        ri_pose = _matrix_float(zlib.decompress(ri_pose_compressed))
        if (
            ri_pose.ndim != 3
            or ri_pose.shape[:2] != range_image.shape
            or ri_pose.shape[2] != 6
        ):
            # caught by iter_scene's skip-and-log (SURVEY.md §5): a pose
            # image that parses but can't align with the range image must
            # not crash the run deep inside build_keyframe's einsum.
            raise ValueError(
                f"range_image_pose shape {ri_pose.shape} does not match "
                f"range image {range_image.shape}"
            )
    else:
        ri_pose = np.zeros((0,), np.float32)

    top = next((c for c in laser_calibs if c["name"] == LASER_TOP), None)
    if top is None:
        raise ValueError("Frame has no TOP laser calibration")
    if top["beam_inclinations"]:
        incl = np.array(top["beam_inclinations"], np.float32)[::-1]
    else:  # uniform spacing from min/max (frame_utils semantics)
        h = range_image.shape[0]
        ratios = (np.arange(h) + 0.5) / h
        incl = (
            top["beam_inclination_max"]
            + ratios * (top["beam_inclination_min"]
                        - top["beam_inclination_max"])
        ).astype(np.float32)

    cam_calibs.sort(key=lambda c: c["name"])
    images.sort(key=lambda im: im[0])

    boxes = np.array(
        [[l["box"].center_x, l["box"].center_y, l["box"].center_z,
          l["box"].width, l["box"].length, l["box"].height,
          l["box"].heading] for l in labels if l["box"] is not None],
        np.float64,
    ).reshape(-1, 7)
    with_box = [l for l in labels if l["box"] is not None]

    return {
        "context_name": context_name,
        "timestamp_micros": np.int64(timestamp),
        # real per-camera sensor sizes (CameraCalibration fields 4/5) —
        # informational: the projection ratio itself stays the reference's
        # hardcoded 1024/1920 (waymo/2d_to_3d.py:523)
        "cam_width": np.array([c["width"] for c in cam_calibs], np.int32),
        "cam_height": np.array([c["height"] for c in cam_calibs], np.int32),
        "pose": pose,
        "range_image": np.ascontiguousarray(range_image, np.float32),
        "range_image_pose": np.ascontiguousarray(ri_pose, np.float32),
        "inclinations": np.ascontiguousarray(incl),
        "lidar_extrinsic": top["extrinsic"]
        if top["extrinsic"] is not None else np.eye(4),
        "cam_intrinsic": np.stack(
            [np.array(c["intrinsic"], np.float64) for c in cam_calibs]
        ) if cam_calibs else np.zeros((0, 9)),
        "cam_extrinsic": np.stack(
            [c["extrinsic"] if c["extrinsic"] is not None else np.eye(4)
             for c in cam_calibs]
        ) if cam_calibs else np.zeros((0, 4, 4)),
        "cam_images_jpeg": _object_array(
            [np.frombuffer(img, np.uint8) for _, img in images]
        ),
        "lane_polylines": _object_array(lane_polylines),
        "labels_box": boxes,
        "labels_type": np.array([l["type"] for l in with_box], np.int32),
        "labels_num_points": np.array(
            [l["num_points"] for l in with_box], np.int32
        ),
        "labels_id": np.array([l["id"] for l in with_box]),
    }


# ---------------------------------------------------------------------------
# Frame encoder (test fixtures + round-trip validation). Writes canonical
# proto2 wire form: unpacked repeated doubles, packed MatrixFloat.data —
# matching what the real wheel serializes.
# ---------------------------------------------------------------------------

def encode_frame_lite(fr: Dict) -> bytes:
    """Serialize a frame-lite dict (the npz exchange contract) back to a
    dataset_pb2.Frame wire message — fixture synthesis + cache round trips.
    Inverse of parse_frame up to the documented normalizations (inclination
    reversal, range-image channel extraction)."""
    pose_img = np.asarray(fr.get("range_image_pose",
                                  np.zeros((0,), np.float32)), np.float32)
    return encode_frame(
        str(fr["context_name"]),
        int(fr["timestamp_micros"]),
        np.asarray(fr["pose"], np.float64),
        np.asarray(fr["range_image"], np.float32),
        np.asarray(fr["inclinations"], np.float32)[::-1],  # proto order
        np.asarray(fr["lidar_extrinsic"], np.float64),
        np.asarray(fr["cam_intrinsic"], np.float64),
        np.asarray(fr["cam_extrinsic"], np.float64),
        [bytes(bytearray(b)) for b in fr["cam_images_jpeg"]],
        [np.asarray(p, np.float64) for p in fr["lane_polylines"]],
        [
            {"box": b, "type": int(t), "id": str(i), "num_points": int(n)}
            for b, t, i, n in zip(
                fr["labels_box"], fr["labels_type"], fr["labels_id"],
                fr["labels_num_points"],
            )
        ],
        range_image_pose=pose_img if pose_img.size else None,
    )


def _encode_transform(m: np.ndarray) -> bytes:
    return b"".join(
        _double_field(1, float(x)) for x in np.asarray(m, np.float64).ravel()
    )


def _encode_matrix_float(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    data = arr.astype("<f4").tobytes()
    shape = b"".join(_varint_field(1, int(d)) for d in arr.shape)
    return _bytes_field(1, data) + _bytes_field(2, shape)


def encode_frame(
    context_name: str,
    timestamp_micros: int,
    pose: np.ndarray,
    range_image: np.ndarray,  # [H, W] or [H, W, 4]; stored as [H, W, 4]
    inclinations: np.ndarray,  # [H] TOP-of-array = LAST beam (pre-reversal)
    lidar_extrinsic: np.ndarray,
    cam_intrinsics: np.ndarray,  # [C, 9]
    cam_extrinsics: np.ndarray,  # [C, 4, 4]
    cam_images_jpeg: Optional[List[bytes]] = None,
    lane_polylines: Optional[List[np.ndarray]] = None,
    labels: Optional[List[dict]] = None,  # box [7], type, id, num_points
    range_image_pose: Optional[np.ndarray] = None,  # [H, W, 6]
) -> bytes:
    ri = np.asarray(range_image, np.float32)
    if ri.ndim == 2:
        full = np.zeros(ri.shape + (4,), np.float32)
        full[..., 0] = ri
        ri = full

    laser_calib = b"".join([
        _varint_field(1, LASER_TOP),
        b"".join(_double_field(2, float(x)) for x in inclinations),
        _bytes_field(5, _encode_transform(lidar_extrinsic)),
    ])
    context = b"".join(
        [_bytes_field(1, context_name.encode())]
        + [
            _bytes_field(2, b"".join([
                _varint_field(1, i + 1),
                b"".join(
                    _double_field(2, float(x)) for x in cam_intrinsics[i]
                ),
                _bytes_field(3, _encode_transform(cam_extrinsics[i])),
            ]))
            for i in range(len(cam_intrinsics))
        ]
        + [_bytes_field(3, laser_calib)]
    )
    ri_msg = _bytes_field(
        2, zlib.compress(_encode_matrix_float(ri))
    )
    if range_image_pose is not None:
        ri_msg += _bytes_field(
            4,
            zlib.compress(
                _encode_matrix_float(
                    np.asarray(range_image_pose, np.float32)
                )
            ),
        )
    laser = _bytes_field(
        5, _varint_field(1, LASER_TOP) + _bytes_field(2, ri_msg)
    )
    parts = [
        _bytes_field(1, context),
        _varint_field(2, timestamp_micros),
        _bytes_field(3, _encode_transform(pose)),
    ]
    for i, img in enumerate(cam_images_jpeg or []):
        parts.append(_bytes_field(
            4, _varint_field(1, i + 1) + _bytes_field(2, bytes(img))
        ))
    parts.append(laser)
    for lab in labels or []:
        from cm3d_tpu_torch.datasets.waymo.proto import WaymoBox

        box = WaymoBox(*[float(x) for x in lab["box"]])
        lbytes = b"".join([
            _bytes_field(1, box.to_bytes()),
            _varint_field(3, int(lab.get("type", 0))),
            _bytes_field(4, str(lab.get("id", "")).encode()),
            _varint_field(7, int(lab.get("num_points", 0))),
        ])
        parts.append(_bytes_field(6, lbytes))
    for poly in lane_polylines or []:
        pts = b"".join(
            _bytes_field(8, (
                _double_field(1, float(p[0]))
                + _double_field(2, float(p[1]))
                + _double_field(3, float(p[2]))
            ))
            for p in np.asarray(poly, np.float64)
        )
        parts.append(_bytes_field(10, _varint_field(1, 1) + _bytes_field(3, pts)))
    return b"".join(parts)

"""Minimal protobuf wire codec for the Waymo detection-metrics messages.

Hand-rolled (no protobuf runtime/version coupling): varint + fixed64 +
length-delimited encoding for exactly the messages the pipeline and the
metrics tool exchange — metrics_pb2.Objects / Object and label_pb2.Label /
Label.Box. The reference writes/reads these through the waymo_open_dataset
wheel (src/waymo/2d_to_3d.py:1034-1065, create_gt_bin.py:8-25,
linear_matching.py:183-254).

Field numbers follow the published waymo-open-dataset protos
(label.proto: Box{center_x=1,center_y=2,center_z=3,width=4,length=5,
height=6,heading=7}, Label{box=1,metadata=2,type=3,id=4,
detection_difficulty_level=5,tracking_difficulty_level=6,
num_lidar_points_in_box=7}; metrics.proto: Object{object=1,score=2,
overlap_with_nlz=3,frame_timestamp_micros=4,context_name=5},
Objects{objects=1}). All numbers are centralized HERE; validating against
upstream-produced .bin files only ever touches this module.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator, List, Tuple

LABEL_TYPE_UNKNOWN = 0
LABEL_TYPE_VEHICLE = 1
LABEL_TYPE_PEDESTRIAN = 2
LABEL_TYPE_SIGN = 3
LABEL_TYPE_CYCLIST = 4


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

def _varint(x: int) -> bytes:
    out = bytearray()
    x &= (1 << 64) - 1
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    x = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        x |= (b & 0x7F) << shift
        if not b & 0x80:
            return x, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _varint_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _bytes_field(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, pos = _read_varint(buf, pos)
        elif wire == 1:
            v = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 5:
            v = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                # a short slice would silently parse a truncated message
                # as a shorter valid one; corrupt data must fail loudly so
                # skip-and-log consumers (WaymoFrontend.iter_scene) fire
                raise ValueError(
                    f"truncated length-delimited field {field}: "
                    f"{ln} bytes declared, {n - pos} left"
                )
            v = buf[pos : pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, v


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WaymoBox:
    center_x: float = 0.0
    center_y: float = 0.0
    center_z: float = 0.0
    width: float = 0.0
    length: float = 0.0
    height: float = 0.0
    heading: float = 0.0

    def to_bytes(self) -> bytes:
        return b"".join(
            [
                _double_field(1, self.center_x),
                _double_field(2, self.center_y),
                _double_field(3, self.center_z),
                _double_field(4, self.width),
                _double_field(5, self.length),
                _double_field(6, self.height),
                _double_field(7, self.heading),
            ]
        )

    @classmethod
    def from_bytes(cls, buf: bytes) -> "WaymoBox":
        b = cls()
        names = {1: "center_x", 2: "center_y", 3: "center_z", 4: "width",
                 5: "length", 6: "height", 7: "heading"}
        for field, wire, v in _iter_fields(buf):
            if field in names and wire == 1:
                setattr(b, names[field], float(v))
        return b


@dataclasses.dataclass
class WaymoObject:
    """metrics_pb2.Object + the Label fields the pipeline uses."""

    box: WaymoBox = dataclasses.field(default_factory=WaymoBox)
    type: int = LABEL_TYPE_UNKNOWN
    id: str = ""
    num_lidar_points_in_box: int = 0
    score: float = 0.0
    frame_timestamp_micros: int = 0
    context_name: str = ""

    # Label: box=1, type=3, id=4, num_lidar_points_in_box=7
    def _label_bytes(self) -> bytes:
        out = [_bytes_field(1, self.box.to_bytes()), _varint_field(3, self.type)]
        if self.id:
            out.append(_bytes_field(4, self.id.encode()))
        if self.num_lidar_points_in_box:
            out.append(_varint_field(7, self.num_lidar_points_in_box))
        return b"".join(out)

    def to_bytes(self) -> bytes:
        out = [
            _bytes_field(1, self._label_bytes()),
            _float_field(2, self.score),
            _varint_field(4, self.frame_timestamp_micros),
            _bytes_field(5, self.context_name.encode()),
        ]
        return b"".join(out)

    @classmethod
    def from_bytes(cls, buf: bytes) -> "WaymoObject":
        o = cls()
        for field, wire, v in _iter_fields(buf):
            if field == 1 and wire == 2:
                for lf, lw, lv in _iter_fields(v):
                    if lf == 1 and lw == 2:
                        o.box = WaymoBox.from_bytes(lv)
                    elif lf == 3 and lw == 0:
                        o.type = int(lv)
                    elif lf == 4 and lw == 2:
                        o.id = lv.decode(errors="replace")
                    elif lf == 7 and lw == 0:
                        o.num_lidar_points_in_box = int(lv)
            elif field == 2 and wire == 5:
                o.score = float(v)
            elif field == 4 and wire == 0:
                o.frame_timestamp_micros = int(v)
            elif field == 5 and wire == 2:
                o.context_name = v.decode(errors="replace")
        return o


def encode_objects(objects: List[WaymoObject]) -> bytes:
    """metrics_pb2.Objects: repeated Object objects = 1."""
    return b"".join(_bytes_field(1, o.to_bytes()) for o in objects)


def decode_objects(buf: bytes) -> List[WaymoObject]:
    out = []
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 2:
            out.append(WaymoObject.from_bytes(v))
    return out

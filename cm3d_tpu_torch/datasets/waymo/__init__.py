"""Waymo Open Dataset frontend (TF-free). Mirrors `cm3d_tpu/datasets/waymo`.

Replaces the reference's tensorflow + waymo_open_dataset dependency stack
(src/waymo/2d_to_3d.py:336-348): a native TFRecord reader/writer, a minimal
protobuf wire codec for the detection-metrics messages, a torch range-image
unprojection op, and keyframe assembly feeding the same device step as
nuScenes.
"""

from cm3d_tpu_torch.datasets.waymo.tfrecord import TFRecordReader, TFRecordWriter
from cm3d_tpu_torch.datasets.waymo.proto import (
    WaymoBox,
    WaymoObject,
    decode_objects,
    encode_objects,
    LABEL_TYPE_VEHICLE,
    LABEL_TYPE_PEDESTRIAN,
    LABEL_TYPE_SIGN,
    LABEL_TYPE_CYCLIST,
)

__all__ = [
    "TFRecordReader",
    "TFRecordWriter",
    "WaymoBox",
    "WaymoObject",
    "decode_objects",
    "encode_objects",
    "LABEL_TYPE_VEHICLE",
    "LABEL_TYPE_PEDESTRIAN",
    "LABEL_TYPE_SIGN",
    "LABEL_TYPE_CYCLIST",
]

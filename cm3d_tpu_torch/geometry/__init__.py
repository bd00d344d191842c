"""Geometry core: quaternions, SE(3) transforms, camera projection, boxes.

Batched PyTorch functions over fixed-shape tensors, the counterparts of
`cm3d_tpu/geometry/` (the reference's per-dataset copies of `utils/pcd.py`
and KITTI's `Calibration` class: src/*/utils/pcd.py, src/kitti/kitti_utils.py).
"""

from cm3d_tpu_torch.geometry.se3 import (
    quat_to_rotmat,
    rotmat_to_quat,
    yaw_to_quat,
    quat_to_yaw,
    quat_multiply,
    quat_inverse,
    transform_matrix,
    invert_se3,
    compose,
    apply_se3,
    yaw_rotmat,
)
from cm3d_tpu_torch.geometry.pointcloud import (
    remove_close_mask,
    transform_points,
    rotate_points,
    translate_points,
    view_points,
    project_to_camera,
)
from cm3d_tpu_torch.geometry.boxes import (
    box_corners_3d,
    box_corners_bev,
    boxes_to_7dof,
    rotated_iou_bev,
)

__all__ = [
    "quat_to_rotmat",
    "rotmat_to_quat",
    "yaw_to_quat",
    "quat_to_yaw",
    "quat_multiply",
    "quat_inverse",
    "transform_matrix",
    "invert_se3",
    "compose",
    "apply_se3",
    "yaw_rotmat",
    "remove_close_mask",
    "transform_points",
    "rotate_points",
    "translate_points",
    "view_points",
    "project_to_camera",
    "box_corners_3d",
    "box_corners_bev",
    "boxes_to_7dof",
    "rotated_iou_bev",
]

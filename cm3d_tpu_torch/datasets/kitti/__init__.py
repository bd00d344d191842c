"""KITTI dataset frontend. Mirrors `cm3d_tpu/datasets/kitti` (the viz
modules, `viz` and `viz3d`, import on their own).

Rebuild of the reference's kitti_object / kitti_utils layer
(src/kitti/kitti_object.py, kitti_utils.py) and the (broken-in-reference,
fixed here) KITTI lifting path (src/kitti/2d_to_3d.py; its second pass
dead-ends at :1528 on copied nuScenes code).
"""

from cm3d_tpu_torch.datasets.kitti.calib import Calibration, Object3d, read_label, write_label
from cm3d_tpu_torch.datasets.kitti.frontend import KittiDataset, KittiFrontend

__all__ = [
    "Calibration",
    "Object3d",
    "read_label",
    "write_label",
    "KittiDataset",
    "KittiFrontend",
]

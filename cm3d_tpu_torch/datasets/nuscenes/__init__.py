"""nuScenes dataset frontend (devkit-free).

Reads the v1.0 relational JSON tables, the map expansion, and raw LiDAR
sweeps directly and normalizes every keyframe to the canonical `Keyframe`
consumed by the device step.
"""

from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables, CAM_LIST
from cm3d_tpu_torch.datasets.nuscenes.maps import NuScenesMapLite
from cm3d_tpu_torch.datasets.nuscenes.frontend import NuScenesFrontend
from cm3d_tpu_torch.datasets.nuscenes.writer import SubmissionWriter, boxes_to_dicts
from cm3d_tpu_torch.datasets.nuscenes.gt import load_gt_for_eval

__all__ = [
    "NuScenesTables",
    "CAM_LIST",
    "NuScenesMapLite",
    "NuScenesFrontend",
    "SubmissionWriter",
    "boxes_to_dicts",
    "load_gt_for_eval",
]

"""Detection evaluation subsystem (host-side numpy).

A devkit-free rebuild of the reference's forked nuScenes detection eval
(src/nuscenes/eval_custom.py): greedy center-distance matching, 101-point
interpolated AP, TP error metrics, class-agnostic "object" AP, actual-recall
reporting, rare classes, and NDS. Matching is not throughput-critical
(SURVEY.md §7: host-side by design); the device pipeline ends at the
submission JSON.
"""

from cm3d_tpu_torch.eval.boxes import DetectionBox, EvalBoxes
from cm3d_tpu_torch.eval.config import (
    DetectionEvalConfig,
    DETECTION_CVPR_2019,
    SAM3D_CONFIG,
    RARE_CONFIG,
)
from cm3d_tpu_torch.eval.algo import accumulate, calc_ap, calc_tp, MetricData
from cm3d_tpu_torch.eval.evaluate import DetectionEval, evaluate_boxes

__all__ = [
    "DetectionBox",
    "EvalBoxes",
    "DetectionEvalConfig",
    "DETECTION_CVPR_2019",
    "SAM3D_CONFIG",
    "RARE_CONFIG",
    "accumulate",
    "calc_ap",
    "calc_tp",
    "MetricData",
    "DetectionEval",
    "evaluate_boxes",
]

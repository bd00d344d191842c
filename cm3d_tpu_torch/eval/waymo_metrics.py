"""Python access to the native Waymo metrics: CLI runner + Hungarian matcher.
A copy of `cm3d_tpu/eval/waymo_metrics.py` with its own build of the C++.

Replaces the reference's subprocess call to the prebuilt ELF binaries
(src/waymo/linear_matching.py:478-527) and the py_metrics_ops.match TF op
(:110-118). The binary and the shared library build lazily from
cm3d_tpu_torch/native/waymo_metrics.cc.
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

from cm3d_tpu_torch.native import build_binary, build_shared_lib

_LIB = None
_LIB_TRIED = False

AP_KEYS = [
    "Vehicle/L1 mAP", "Vehicle/L1 mAPH", "Vehicle/L2 mAP", "Vehicle/L2 mAPH",
    "Pedestrian/L1 mAP", "Pedestrian/L1 mAPH",
    "Pedestrian/L2 mAP", "Pedestrian/L2 mAPH",
    "Sign/L1 mAP", "Sign/L1 mAPH", "Sign/L2 mAP", "Sign/L2 mAPH",
    "Cyclist/L1 mAP", "Cyclist/L1 mAPH", "Cyclist/L2 mAP", "Cyclist/L2 mAPH",
]


def metrics_binary_path(fast: bool = False) -> Optional[str]:
    """The reference ships main + fast variants; one implementation covers
    both contracts here (it IS the fast path)."""
    stem = ("compute_detection_metrics_fast" if fast
            else "compute_detection_metrics_main")
    p = build_binary(["waymo_metrics.cc"], stem, extra_flags=["-DMETRICS_MAIN"])
    return str(p) if p else None


def parse_metrics_stdout(text: str) -> Dict[str, float]:
    """Parse the metrics tool stdout — string-splitting identical to the
    reference (linear_matching.py:486-527). The positional assumption (the
    first 8 "mAP "/"mAPH " occurrences are the OBJECT_TYPE lines) holds for
    the REAL binary's full output including its range-bucket breakdown,
    pinned by tests/fixtures/waymo_metrics_real_stdout.txt."""
    ap_dict = {k: 0.0 for k in AP_KEYS}
    map_splits = text.split("mAP ")
    maph_splits = text.split("mAPH ")
    for idx, key in enumerate(ap_dict.keys()):
        split_idx = idx // 2 + 1
        if idx % 2 == 0:
            ap_dict[key] = float(map_splits[split_idx].split("]")[0])
        else:
            ap_dict[key] = float(maph_splits[split_idx].split("]")[0])
    for lvl in ("L1", "L2"):
        ap_dict[f"Overall/{lvl} mAP"] = (
            ap_dict[f"Vehicle/{lvl} mAP"] + ap_dict[f"Pedestrian/{lvl} mAP"]
            + ap_dict[f"Cyclist/{lvl} mAP"]
        ) / 3
        ap_dict[f"Overall/{lvl} mAPH"] = (
            ap_dict[f"Vehicle/{lvl} mAPH"] + ap_dict[f"Pedestrian/{lvl} mAPH"]
            + ap_dict[f"Cyclist/{lvl} mAPH"]
        ) / 3
    return ap_dict


def run_detection_metrics(pred_bin: str, gt_bin: str) -> Tuple[str, Dict[str, float]]:
    """Invoke the binary; returns (stdout_text, ap_dict)."""
    binary = metrics_binary_path()
    if binary is None:
        raise RuntimeError("could not build compute_detection_metrics_main")
    text = subprocess.check_output([binary, pred_bin, gt_bin]).decode()
    return text, parse_metrics_stdout(text)


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        lib = build_shared_lib(["waymo_metrics.cc"], "libwaymo_metrics")
        if lib is not None:
            lib.box_iou_7dof.restype = ctypes.c_double
            lib.hungarian_match_boxes.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def box_iou_7dof(a: np.ndarray, b: np.ndarray, mode_2d: bool = False) -> float:
    """IoU of two [cx, cy, cz, w, l, h, heading] boxes (BEV or 3D)."""
    lib = _lib()
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    if lib is not None:
        return float(
            lib.box_iou_7dof(
                a.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_int(1 if mode_2d else 0),
            )
        )
    return _iou_np(a, b, mode_2d)


def hungarian_match(
    pred: np.ndarray,  # [N, 7] (cx, cy, cz, w, l, h, heading)
    gt: np.ndarray,  # [M, 7]
    iou_thresh: float,
    mode_2d: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Hungarian max-IoU matching gated at iou_thresh; returns
    (pred_idx [Q], gt_idx [Q], ious [Q]) — the py_metrics_ops.match contract."""
    pred = np.ascontiguousarray(pred, np.float64)
    gt = np.ascontiguousarray(gt, np.float64)
    n, m = len(pred), len(gt)
    if n == 0 or m == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0)
    lib = _lib()
    if lib is not None:
        pi = np.zeros(n, np.int32)
        gi = np.zeros(n, np.int32)
        io = np.zeros(n, np.float64)
        q = lib.hungarian_match_boxes(
            pred.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int(n),
            gt.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int(m),
            ctypes.c_double(iou_thresh),
            ctypes.c_int(1 if mode_2d else 0),
            pi.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            gi.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            io.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return pi[:q], gi[:q], io[:q]
    # numpy fallback: scipy Hungarian
    from scipy.optimize import linear_sum_assignment

    iou = np.zeros((n, m))
    for i in range(n):
        for j in range(m):
            iou[i, j] = _iou_np(pred[i], gt[j], mode_2d)
    cost = np.where(iou >= iou_thresh, -iou, 0.0)
    ri, ci = linear_sum_assignment(cost)
    keep = iou[ri, ci] >= iou_thresh
    return ri[keep].astype(np.int32), ci[keep].astype(np.int32), iou[ri, ci][keep]


def _iou_np(a, b, mode_2d):
    """Fallback rotated IoU via the BEV clipper (cm3d_tpu_torch.geometry),
    in float64 on the CPU."""
    import torch

    from cm3d_tpu_torch.geometry.boxes import rotated_iou_bev

    # geometry API: (cx, cy, w, l, yaw)
    ba = torch.tensor([[a[0], a[1], a[3], a[4], a[6]]], dtype=torch.float64)
    bb = torch.tensor([[b[0], b[1], b[3], b[4], b[6]]], dtype=torch.float64)
    bev = float(rotated_iou_bev(ba, bb)[0, 0])
    if mode_2d:
        return bev
    area_a, area_b = a[3] * a[4], b[3] * b[4]
    # recover the intersection area from the BEV IoU
    inter_bev = bev * (area_a + area_b) / (1.0 + bev)
    zo = max(
        0.0,
        min(a[2] + a[5] / 2, b[2] + b[5] / 2)
        - max(a[2] - a[5] / 2, b[2] - b[5] / 2),
    )
    inter = inter_bev * zo
    u = area_a * a[5] + area_b * b[5] - inter
    return inter / u if u > 0 else 0.0

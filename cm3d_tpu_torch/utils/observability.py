"""Structured pipeline observability: stage timers + data-loss counters.

The reference's instrumentation is a wall-clock timer dict printed at exit
(src/nuscenes/2d_to_3d.py:368-378,937-938) and print() spam; masks that
gather zero points are dropped silently (:626-628). Here the same stage
taxonomy is kept, every drop is counted, and both emit one structured JSON
line for log scraping; `trace()` wraps a block in a torch.profiler trace
written for Perfetto / chrome://tracing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class StageTimer:
    """Reference taxonomy: io / device / write / total (+ custom stages)."""

    stages: Dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def add(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def report(self) -> str:
        return json.dumps({"timers_sec": {k: round(v, 4) for k, v in self.stages.items()}})


@dataclasses.dataclass
class LiftCounters:
    """Per-run data-flow accounting (silent loss in the reference)."""

    frames: int = 0
    frames_skipped: int = 0  # missing/corrupt artifacts
    masks_valid: int = 0
    masks_no_points: int = 0  # reference drops these silently (:626-628)
    masks_truncated: int = 0  # gathered points exceeded K
    cameras_truncated: int = 0  # frustum compaction overflowed NC
    boxes_written: int = 0
    boxes_suppressed_nms: int = 0

    def update_from_outputs(self, frames_mask_valid, lift, keep) -> None:
        """Accumulate from a batch of host (numpy) outputs."""
        valid = np.asarray(frames_mask_valid)
        has = np.asarray(lift.has_points)
        trunc = np.asarray(lift.truncated)
        cam_trunc = np.asarray(lift.cam_truncated)
        kp = np.asarray(keep)
        self.frames += valid.shape[0]
        self.masks_valid += int(valid.sum())
        self.masks_no_points += int((valid & ~has).sum())
        self.masks_truncated += int((valid & trunc).sum())
        self.cameras_truncated += int(cam_trunc.sum())
        self.boxes_written += int(kp.sum())
        self.boxes_suppressed_nms += int((has & ~kp).sum())

    def report(self) -> str:
        return json.dumps({"counters": dataclasses.asdict(self)})


@dataclasses.dataclass
class MaskCounters:
    """2D-stage data-flow accounting, mirroring LiftCounters: every
    detection dropped at the max_detections / max_masks_total caps is
    counted (the caps are where data can vanish)."""

    frames: int = 0
    detections: int = 0  # valid detector outputs before NMS
    nms_suppressed: int = 0
    dropped_max_detections: int = 0  # per-camera prompt cap
    dropped_masks_total: int = 0  # per-frame mask budget
    masks_written: int = 0

    def update(self, frame_counts: Dict[str, int]) -> None:
        for k, v in frame_counts.items():
            setattr(self, k, getattr(self, k) + int(v))
        self.frames += 1

    @property
    def dropped_total(self) -> int:
        return self.dropped_max_detections + self.dropped_masks_total

    def report(self) -> str:
        return json.dumps({"mask_counters": dataclasses.asdict(self)})


@contextlib.contextmanager
def trace(label: str, profile_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler trace of the block (CPU and, where present, CUDA
    activity) exported to `profile_dir/<label>.json` when profile_dir is
    set; no-op otherwise."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"{label}.json"))

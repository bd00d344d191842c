"""Structured pipeline observability: spans, counters and data-loss accounting.

The reference's instrumentation is a wall-clock timer dict printed at exit
(src/nuscenes/2d_to_3d.py:368-378,937-938) and print() spam; masks that
gather zero points are dropped silently (:626-628). Here every drop is
counted, the CLIs emit structured JSON lines for log scraping, and the
port's loop, mask stage and lift step mark what they do with spans that
land in a profiler's trace beside the device's activity.

Spans: `span(name)`, named `cm3d.<layer>.<what>`; a span around a blocking
wait of the host (for the device, or for another thread) ends in `.wait`.
Readers of a trace classify the host's time by this convention: device idle
time under a `.wait` span is a sync bubble (under `cm3d.e2e.io.wait`, the
wait for the IO thread's next frame, the front end), under any other
`cm3d.` span the host was still queuing work.

- Off (no torch.profiler session, no `totals`): one check, and the shared
  no-op context.
- Under a torch.profiler session: a `torch.profiler.record_function` range
  of that name, in the same trace and on the same clock as the device's
  activity, on the thread that opened it. The profiler records the
  thread that started it only: a span opened on another thread (the
  fused loop's IO and finisher threads) is off. A range must end in the
  session it began in: ending it under a later session writes into the
  earlier one's freed events (a caller may stop one session and start the
  next inside a span, as the benchmark's traced parts do). So the spans count the sessions that
  start; when a span opens under a new session, the ranges of the spans
  still open on its thread from an earlier one are parked (ended once the
  new session has stopped) and opened again in the new session, so that
  it sees every span open on the thread from its first span on.
- `totals`: a dict the caller owns; the span's wall seconds are added
  under its name whether or not anything traces (the lift CLIs' timers).

`COUNTERS`: process-wide integer counts, always on (a few adds a keyframe):
`masks.prompts` and `masks.prompt_slots` (prompts decoded, and the slots of
the decodes that ran: cameras x prompt bucket), and every field of
`MaskCounters` / `LiftCounters` under `masks.` / `lift.`.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

COUNTERS: collections.Counter = collections.Counter()

_NOOP = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_local = threading.local()  # .ranges: the thread's profiled spans, innermost last
_sessions = None  # torch.profiler sessions started since the first profiled span
_parked: list = []  # ranges of a finished session, ended once the running one stops


def _watch_sessions() -> None:
    """Count the profiler sessions that start from now on, and end the
    parked ranges once a session has stopped (torch.autograd.profiler
    calls `_run_on_profiler_start` as a session starts, and
    `_run_on_profiler_stop` once it has stopped)."""
    global _sessions
    from torch.autograd import profiler

    started, stopped = profiler._run_on_profiler_start, profiler._run_on_profiler_stop

    def on_start():
        global _sessions
        _sessions += 1
        started()

    def on_stop():
        stopped()
        while _parked:
            _parked.pop().__exit__(None, None, None)

    profiler._run_on_profiler_start, profiler._run_on_profiler_stop = on_start, on_stop
    _sessions = 0


def span(name: str, totals: Optional[dict] = None):
    """A context that marks its block as `name` (module docstring)."""
    if totals is None and not _profiling():
        return _NOOP
    return _Span(name, totals)


class _Span:
    __slots__ = ("name", "totals", "range", "session", "t0")

    def __init__(self, name: str, totals: Optional[dict]):
        self.name, self.totals, self.range = name, totals, None

    def __enter__(self):
        if self.totals is not None:
            self.t0 = time.perf_counter()
        if _profiling():
            if _sessions is None:
                _watch_sessions()
            stack = _local.__dict__.setdefault("ranges", [])
            for outer in stack:
                if outer.session != _sessions:  # begun under a session that has stopped
                    _parked.append(outer.range)
                    outer._open_range()
            self._open_range()
            stack.append(self)
        return self

    def _open_range(self):
        self.range, self.session = torch.profiler.record_function(self.name), _sessions
        self.range.__enter__()

    def __exit__(self, *exc):
        if self.range is not None:
            _local.ranges.pop()  # spans nest on a thread: this one is innermost
            if self.session != _sessions and _profiling():
                _parked.append(self.range)
            else:
                self.range.__exit__(*exc)
        if self.totals is not None:
            self.totals[self.name] = (self.totals.get(self.name, 0.0)
                                      + time.perf_counter() - self.t0)
        return False


# the lift CLIs' timers (the reference's taxonomy, 2d_to_3d.py:368-378):
# each stage is the total of one span; "total" is the run's wall time
LIFT_STAGES = {"io": "cm3d.lift.io.wait", "device": "cm3d.lift.flush",
               "write": "cm3d.lift.write"}


def lift_timers(totals: dict, total_s: float) -> Dict[str, float]:
    """{io, device, write, total} seconds from the lift spans' `totals`."""
    out = {stage: totals.get(name, 0.0) for stage, name in LIFT_STAGES.items()}
    out["total"] = total_s
    return out


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
        """Accumulate from a batch of host (numpy) outputs (and into
        COUNTERS, under `lift.`)."""
        valid = np.asarray(frames_mask_valid)
        has = np.asarray(lift.has_points)
        trunc = np.asarray(lift.truncated)
        cam_trunc = np.asarray(lift.cam_truncated)
        kp = np.asarray(keep)
        add = {"frames": valid.shape[0], "masks_valid": int(valid.sum()),
               "masks_no_points": int((valid & ~has).sum()),
               "masks_truncated": int((valid & trunc).sum()),
               "cameras_truncated": int(cam_trunc.sum()), "boxes_written": int(kp.sum()),
               "boxes_suppressed_nms": int((has & ~kp).sum())}
        for k, v in add.items():
            setattr(self, k, getattr(self, k) + v)
            COUNTERS[f"lift.{k}"] += v

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
        """Add one frame's counts (and into COUNTERS, under `masks.`)."""
        for k, v in {**frame_counts, "frames": 1}.items():
            setattr(self, k, getattr(self, k) + int(v))
            COUNTERS[f"masks.{k}"] += int(v)

    @property
    def dropped_total(self) -> int:
        return self.dropped_max_detections + self.dropped_masks_total

    def report(self) -> str:
        return json.dumps({"mask_counters": dataclasses.asdict(self)})


@contextlib.contextmanager
def trace(label: str, profile_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler trace of the block (CPU and, where present, CUDA
    activity, with the spans of the thread that opens it) exported to
    `profile_dir/<label>.json` when profile_dir is set; no-op otherwise."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(label):
            yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"{label}.json"))

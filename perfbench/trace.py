"""A traced part of a run (after its window), read from torch.profiler's chrome trace.

Device activity (kernels, copies, fills) is tied to the host call that
launched it through the launch's correlation id, and to the ranges that
were open on the launching thread at that moment: the harness's own ranges
around calls into the port ("detic", "sam", "lift_step", "int8_linear") and
the port's `cm3d_torch::` dispatcher ops. A trace of the device's activity
alone has no ranges: its window is the host clock's length of the traced
part, from its first device activity (the device was drained at both
edges). All times are in seconds.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path

WINDOW = "perfbench.traced"
OUT = Path(__file__).resolve().parent / ".out"  # where a trace is exported, then deleted
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CATS = ("user_annotation", "cpu_op")


class Trace:
    def __init__(self, events: list, window_s: float | None = None):
        self.device = []  # (cat, name, start us, dur us, correlation)
        self.launch = {}  # correlation -> (tid, ts)
        self.ranges = defaultdict(list)  # name -> [(tid, start, end)]
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            corr = e.get("args", {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((cat, e["name"], float(e["ts"]), float(e.get("dur", 0)), corr))
            elif cat in LAUNCH_CATS and corr is not None:
                self.launch[corr] = (e["tid"], float(e["ts"]))
            elif cat in RANGE_CATS:
                ts = float(e["ts"])
                self.ranges[e["name"]].append((e["tid"], ts, ts + float(e.get("dur", 0))))
        self.device.sort(key=lambda d: d[2])
        if self.ranges.get(WINDOW):
            _, self.t0, self.t1 = self.ranges[WINDOW][0]
        elif window_s is not None:
            self.t0 = self.device[0][2] if self.device else 0.0
            self.t1 = self.t0 + window_s * 1e6
        else:
            raise ValueError("the trace holds no traced window")

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _inside(self, names) -> dict:
        """tid -> sorted, merged [start, end] lists of the named ranges."""
        per = defaultdict(list)
        for name in names:
            for tid, a, b in self.ranges.get(name, ()):
                per[tid].append((a, b))
        out = {}
        for tid, iv in per.items():
            iv.sort()
            merged = [list(iv[0])]
            for a, b in iv[1:]:
                if a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            out[tid] = ([m[0] for m in merged], [m[1] for m in merged])
        return out

    def device_s_under(self, names, cats=DEVICE_CATS) -> float:
        """Seconds of device activity launched inside any range named in
        `names` (summed durations)."""
        inside = self._inside(names)
        total = 0.0
        for cat, _, _, dur, corr in self.device:
            if cat not in cats or corr not in self.launch:
                continue
            tid, ts = self.launch[corr]
            if tid not in inside:
                continue
            starts, ends = inside[tid]
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= ends[i]:
                total += dur
        return total * 1e-6

    def count(self, name: str) -> int:
        """Ranges of that name that lie whole inside the traced window."""
        return sum(self.t0 <= a and b <= self.t1 for _, a, b in self.ranges.get(name, ()))

    def copies_s(self, kind: str = "HtoD") -> float:
        return 1e-6 * sum(d[3] for d in self.device if d[0] == "gpu_memcpy" and kind in d[1])

    def _busy(self) -> list:
        merged = []
        for _, _, ts, dur, _ in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        """Seconds in the window in which anything ran on the device."""
        return 1e-6 * sum(b - a for a, b in self._busy())

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host range open at the gap's start."""
        per = defaultdict(float)
        for _, name, _, dur, _ in self.device:
            per[name[:160]] += dur * 1e-6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:n]
        busy = self._busy()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self._host_at(a), (b - a) * 1e-6] for a, b in gaps]}

    def _host_at(self, t: float) -> str:
        best, start = "host (no range)", -1.0
        for name, items in self.ranges.items():
            if name == WINDOW:
                continue
            for _, a, b in items:
                if a <= t <= b and a > start:
                    best, start = name, a
        return best[:160]


def read_profile(profiler, out_dir: Path, window_s: float | None = None) -> Trace:
    """Export the profiler's trace inside the checkout, read it, delete it."""
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    profiler.export_chrome_trace(str(path))
    try:
        return Trace(json.loads(path.read_text())["traceEvents"], window_s)
    finally:
        path.unlink(missing_ok=True)

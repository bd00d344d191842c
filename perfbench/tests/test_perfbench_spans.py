"""The readers of the port's spans and counters (metrics/_spans.py and the
metrics that use it) on a hand-made chrome trace, and on a tiny traced run
of the harness on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench.metrics import (_spans, dispatch_host_ms_per_kf, idle_dispatch_ms_per_kf,
                               idle_io_ms_per_kf, idle_sync_ms_per_kf,
                               sam_decode_device_ms_per_kf, sam_decode_slot_use_pct)
from perfbench.tests import tiny
from perfbench.trace import WINDOW, Trace

SPAN_METRICS = ("idle_dispatch_ms_per_kf", "idle_sync_ms_per_kf", "idle_io_ms_per_kf",
                "dispatch_host_ms_per_kf", "sam_decode_device_ms_per_kf",
                "sam_decode_slot_use_pct")


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, a, b, tid=1):
    return _x("user_annotation", name, a, b - a, tid)


# The window is [0, 1000] us. The device runs [50, 150], [250, 350],
# [500, 550], [750, 850], [960, 980]; idle in between:
#   [0, 50]      io.wait                                   io 50
#   [150, 250]   masks.detic (an aten op open: skipped)    dispatch 100
#   [350, 500]   d2h.wait 40, detic.wait 10, lift.step 100 sync 50, dispatch 100
#   [550, 750]   lift.step 50, keyframe 100, harness 50    dispatch 150, none 50
#   [850, 960]   deliver.wait 50, none 50, sam_encode 10   sync 50, none 50, dispatch 10
#   [980, 1000]  sam_encode, cut by the window's end       dispatch 20
# Thread 2's spans lie over every gap, and count for nothing.
EVENTS = [
    _span(WINDOW, 0, 1000),
    _span("cm3d.e2e.io.wait", 0, 100),
    _span("cm3d.e2e.keyframe", 100, 700),
    _span("cm3d.masks.detic", 100, 300),
    _x("cpu_op", "aten::mm", 150, 10),
    _span("cm3d.masks.detic.wait", 300, 400),
    _span("cm3d.d2h.wait", 320, 390),
    _span("cm3d.lift.step", 400, 600),
    _span("sam", 700, 800),  # a harness range: not the port's
    _span("cm3d.e2e.deliver.wait", 800, 900),
    _span("cm3d.masks.sam_encode", 950, 1100),
    _span("cm3d.e2e.prepare", 0, 1000, tid=2),
    _span("cm3d.e2e.deliver", 0, 1000, tid=2),
    _x("kernel", "k1", 50, 100, tid=7),
    _x("kernel", "k2", 250, 100, tid=7),
    _x("kernel", "k3", 500, 50, tid=7),
    _x("gpu_memcpy", "Memcpy DtoH", 750, 100, tid=8),
    _x("kernel", "k4", 960, 20, tid=7),
]
FRAMES = 2


def _ctx(events=EVENTS, frames=FRAMES):
    return {"trace": Trace(events), "probe": SimpleNamespace(traced={"frames": frames})}


def test_the_idle_time_splits_by_the_innermost_span_of_the_dispatch_thread():
    parts = _spans.split(_ctx())
    want = {"io": 50, "dispatch": 380, "sync": 100, "unattributed": 100}
    for k, us in want.items():
        assert parts[k] == pytest.approx(us * 1e-6), k
    assert parts["idle"] == pytest.approx(630e-6)
    assert sum(parts[k] for k in want) == pytest.approx(parts["idle"])
    # own time of keyframe 100 + masks.detic 200 + lift.step 200 + sam_encode 50 (clipped)
    assert parts["host"] == pytest.approx(550e-6)


def test_the_readers_per_keyframe():
    ctx = _ctx()
    assert idle_io_ms_per_kf.read(ctx) == pytest.approx(50e-3 / FRAMES)
    assert idle_dispatch_ms_per_kf.read(ctx) == pytest.approx(380e-3 / FRAMES)
    assert idle_sync_ms_per_kf.read(ctx) == pytest.approx(100e-3 / FRAMES)
    assert dispatch_host_ms_per_kf.read(ctx) == pytest.approx(550e-3 / FRAMES)


def test_the_dispatch_thread_is_the_lift_steps():
    """The same spans on thread 2 but the lift step's: the other thread's
    spans are the ones that count."""
    moved = [dict(e, tid=3 - e["tid"]) if e["tid"] in (1, 2) and e["name"] != WINDOW else e
             for e in EVENTS]
    assert _spans.dispatch_tid(Trace(moved)) == 2
    assert _spans.split(_ctx(moved)) == pytest.approx(_spans.split(_ctx()))


def test_a_trace_without_the_ports_spans_reads_nothing():
    bare = [e for e in EVENTS if not e["name"].startswith("cm3d.")]
    for reader in (idle_dispatch_ms_per_kf, idle_sync_ms_per_kf, idle_io_ms_per_kf,
                   dispatch_host_ms_per_kf, sam_decode_device_ms_per_kf):
        assert reader.read(_ctx(bare)) is None


def test_the_decode_device_time_and_slot_use(monkeypatch):
    events = [_span(WINDOW, 0, 1000), _span("cm3d.masks.sam_decode", 100, 200),
              _x("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=1),
              _x("cuda_runtime", "cudaLaunchKernel", 250, 1, corr=2),
              _x("kernel", "decode", 300, 40, tid=7, corr=1),
              _x("kernel", "other", 400, 60, tid=7, corr=2)]
    assert sam_decode_device_ms_per_kf.read(_ctx(events)) == pytest.approx(40e-3 / FRAMES)
    from cm3d_tpu_torch.utils import observability

    monkeypatch.setattr(observability, "COUNTERS",
                        {"masks.prompts": 150, "masks.prompt_slots": 768})
    assert sam_decode_slot_use_pct.read({}) == pytest.approx(100 * 150 / 768)
    monkeypatch.setattr(observability, "COUNTERS", {})
    assert sam_decode_slot_use_pct.read({}) is None


@pytest.mark.parametrize("cell", ["tiny.e2e", "tiny.lift"])
def test_a_tiny_traced_run_reports_the_span_metrics(monkeypatch, cell):
    """The harness's traced run of the port on the CPU, with the new
    metrics listed for the tiny cells: each is reported where its entry
    would list the cell (but the decode's device time: the CPU has no
    device activity), the split adds up to the traced part's idle time."""
    spec = tiny.bench()
    e2e_only = {"idle_io_ms_per_kf", "sam_decode_device_ms_per_kf", "sam_decode_slot_use_pct"}
    for m in spec["per_layer"]:
        if m["name"] in SPAN_METRICS and (cell == "tiny.e2e" or m["name"] not in e2e_only):
            m["workloads"] = m["workloads"] + [cell]
    monkeypatch.setattr(tiny, "bench", lambda: spec)
    seen = []
    split = _spans.split

    def keep(ctx):
        seen.append(ctx)
        return split(ctx)

    monkeypatch.setattr(_spans, "split", keep)
    r = tiny.run(cell, trace=1)
    assert r["correct"], r["checks"]
    want = {m for m in SPAN_METRICS if cell == "tiny.e2e" or m not in e2e_only}
    assert want - {"sam_decode_device_ms_per_kf"} <= set(r["metrics"])
    parts = split(seen[-1])
    trace = seen[-1]["trace"]
    idle = trace.window_s - trace.busy_s()
    assert parts["idle"] == pytest.approx(idle)
    assert sum(parts[k] for k in ("dispatch", "sync", "io", "unattributed")) == \
        pytest.approx(idle)
    assert parts["host"] > 0

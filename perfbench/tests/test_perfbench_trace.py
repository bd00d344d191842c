"""The reduction from a profiler trace to the per-layer metrics, on a
hand-made chrome trace."""

from __future__ import annotations

import pytest

from perfbench.trace import WINDOW, Trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", WINDOW, 0, 1000),
    _x("user_annotation", "detic", 10, 100),
    _x("cpu_op", "cm3d_torch::window_attn_heads", 20, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 22, 1, corr=1),  # in detic and the op
    _x("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=2),  # in detic only
    _x("cuda_runtime", "cudaLaunchKernel", 200, 1, corr=3),  # in no range
    _x("cuda_runtime", "cudaMemcpyAsync", 300, 1, tid=2, corr=4),  # another thread
    _x("user_annotation", "detic", 290, 20, tid=1),  # same name, other thread's launch
    _x("kernel", "k1", 100, 40, tid=7, corr=1),
    _x("kernel", "k2", 130, 30, tid=7, corr=2),  # overlaps k1: busy is a union
    _x("kernel", "k3", 400, 100, tid=7, corr=3),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 600, 50, tid=8, corr=4),
    _x("kernel", "k4", 990, 50, tid=7, corr=99),  # runs past the window's end
]


def test_device_time_under_ranges_and_ops():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    assert t.device_s_under(["detic"]) == pytest.approx(70e-6)
    assert t.device_s_under(["cm3d_torch::window_attn_heads"]) == pytest.approx(40e-6)
    assert t.device_s_under(["nothing"]) == 0.0
    assert t.count("detic") == 2
    assert t.copies_s("HtoD") == pytest.approx(50e-6)


def test_busy_union_and_breakdown():
    t = Trace(EVENTS)
    # [100, 160] + [400, 500] + [600, 650] + [990, 1000] inside the window
    assert t.busy_s() == pytest.approx(220e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k3", pytest.approx(100e-6)]
    gaps = b["idle_gaps"]
    assert gaps[0][1] == pytest.approx(340e-6)  # 650 -> 990
    assert gaps[1][1] == pytest.approx(240e-6)  # 160 -> 400
    assert gaps[1][0] == "host (no range)"
    assert len(gaps) == 4 and len(b["device_ops"]) == 5


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(ValueError):
        Trace(EVENTS[1:])


def test_a_device_only_trace_takes_its_window_from_the_host_clock():
    device_only = [e for e in EVENTS if e["cat"] in ("kernel", "gpu_memcpy")]
    t = Trace(device_only, window_s=2e-3)
    assert t.window_s == pytest.approx(2e-3)
    # [100, 160] + [400, 500] + [600, 650] + [990, 1040], from the first at 100
    assert t.busy_s() == pytest.approx(260e-6)

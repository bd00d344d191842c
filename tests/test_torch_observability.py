"""The port's spans and counters (cm3d_tpu_torch/utils/observability.py) on
the CPU: a span costs a check and no `record_function` with nothing
tracing; under a profiler, the fused loop over tiny fake models and a lift
step leave every span on the dispatching thread (the profiled one: the
fused loop's IO and finisher threads open none), nested as the code nests
them, once per keyframe or step; the prompt counters equal hand counts."""

import dataclasses
import json
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cm3d_tpu_torch.config import LiftStageConfig, MaskStageConfig
from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
from cm3d_tpu_torch.parallel import make_keyframe_step_fn
from cm3d_tpu_torch.pipelines import e2e, masks
from cm3d_tpu_torch.utils import observability as obs
from cm3d_tpu_torch.utils.fetch import device_fetch

SMALL = dict(max_points=8192, max_masks=32, max_points_per_mask=256,
             max_points_per_camera=4096, max_points_in_masks=1024, max_lane_points=512,
             image_ratio=0.1)
MASK = MaskStageConfig(max_detections=16, max_masks_total=32, prompt_buckets=(4, 8),
                       dtype="float32")
WH = (160, 90)
CAMS = 6
# valid detections a camera, frame by frame: bucket 8, bucket 4, none (no
# decode, no lift), past the 8 bucket (16, the cap) and the frame's 32-mask
# budget (the fourth camera keeps 2)
DETECTIONS = [[3, 0, 5, 1, 2, 0], [2, 2, 2, 1, 1, 1], [0] * CAMS, [10, 10, 10, 10, 0, 0]]
N_BOXES = [[3, 0, 5, 1, 2, 0], [2, 2, 2, 1, 1, 1], [0] * CAMS, [10, 10, 10, 2, 0, 0]]
BUCKETS = [8, 4, None, 16]
LIFTED = [0, 1, 3]  # frames with masks: batches (0, 1), (3, 3 padded)

PARENT = {  # span: the spans it may lie directly inside
    "cm3d.masks.detic": {"cm3d.e2e.keyframe"},
    "cm3d.masks.sam_encode": {"cm3d.e2e.keyframe"},
    "cm3d.masks.detic.wait": {"cm3d.e2e.keyframe"},
    "cm3d.masks.prompts": {"cm3d.e2e.keyframe"},
    "cm3d.masks.sam_decode": {"cm3d.e2e.keyframe"},
    "cm3d.e2e.assemble": {"cm3d.e2e.keyframe"},
    "cm3d.e2e.flush": {"cm3d.e2e.keyframe", None},  # the tail batch's: after the loop
    "cm3d.e2e.deliver.wait": {"cm3d.e2e.flush", None},
    "cm3d.lift.step": {"cm3d.e2e.flush"},
    "cm3d.d2h.start": {"cm3d.e2e.flush"},
    "cm3d.detic.backbone": {"cm3d.masks.detic"},
    "cm3d.detic.proposals": {"cm3d.masks.detic"},
    "cm3d.detic.cascade": {"cm3d.masks.detic"},
    "cm3d.quant.linear": {"cm3d.detic.backbone", "cm3d.masks.sam_encode"},
    "cm3d.h2d": {"cm3d.e2e.flush", "cm3d.masks.sam_encode", "cm3d.masks.sam_decode"},
    "cm3d.d2h.wait": {"cm3d.masks.detic.wait"},
    "cm3d.nms.wait": {"cm3d.detic.proposals", "cm3d.detic.cascade", "cm3d.lift.step"},
    "cm3d.maskpack.wait": {"cm3d.masks.sam_decode"},
    "cm3d.h2d.wait": {"cm3d.masks.sam_encode"},  # SAM's rel-pos indices
    "cm3d.e2e.keyframe": {None}, "cm3d.e2e.io.wait": {None},
}


def _detections(counts):
    d = MASK.max_detections
    boxes = torch.zeros((CAMS, d, 4))
    valid = torch.zeros((CAMS, d), dtype=torch.bool)
    for c, k in enumerate(counts):
        for j in range(k):  # side by side, so the class-wise NMS keeps them all
            boxes[c, j] = torch.tensor([10.0 * j, 0.0, 10.0 * j + 8, 8.0])
            valid[c, j] = True
    scores = torch.linspace(0.9, 0.5, d).expand(CAMS, d).contiguous()
    return boxes, scores, torch.zeros((CAMS, d), dtype=torch.int64), valid


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    """run_fused over four frames of the int8 fake models inside `trace()`
    (Detic runs in full; its detections are swapped for DETECTIONS), and
    then one lift step on its own. Returns the chrome traces' spans, the
    counters' change, and the calling thread's id."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)  # torch ops from three threads (tests/torch_threads.py)
    try:
        models = masks.build_fake_models(device="cpu", quant_int8=True)
        raw_detic = models.detic
        calls = iter(DETECTIONS)

        def detic(frame):
            raw_detic(frame)
            return _detections(next(calls))

        models = dataclasses.replace(models, detic=detic)
        lift_cfg = LiftStageConfig(**SMALL)
        step = make_keyframe_step_fn(lift_cfg, device="cpu")
        rng = np.random.default_rng(0)
        syn = SyntheticConfig(image_w=WH[0], image_h=WH[1], points_per_frame=2048,
                              objects_per_frame=4, focal=80.0)
        base = make_keyframe(syn, lift_cfg, rng)

        def frames():
            for i in range(len(DETECTIONS)):
                images = [(rng.random((WH[1], WH[0], 3)) * 255).astype(np.uint8)
                          for _ in range(CAMS)]

                def assemble(handle, i=i):
                    if handle["planes"] is None:
                        return None
                    return base._replace(mask_bits=handle["planes"]), i

                yield images, assemble

        delivered = []
        before = Counter(obs.COUNTERS)
        out = tmp_path_factory.mktemp("observability")
        with obs.trace("fused", str(out)):
            n = e2e.run_fused(models, step, frames(), MASK,
                              lambda tok, b: delivered.append(tok), batch_size=2,
                              device="cpu")
        counted = Counter(obs.COUNTERS)
        counted.subtract(before)
        with obs.trace("step", str(out)):
            batch = stack_keyframes([base, base]).frames
            device_fetch(step(to_device(batch, "cpu")))
    finally:
        torch.set_num_threads(n_threads)
    assert n == len(LIFTED) and delivered == LIFTED

    def load(label):
        events = json.loads((out / f"{label}.json").read_text())["traceEvents"]
        return [e for e in events if e.get("ph") == "X" and e["name"].startswith("cm3d.")]

    return {"fused": load("fused"), "step": load("step"), "counted": counted,
            "main": threading.get_native_id()}


def _innermost_parents(spans):
    """Each chrome-trace span with the innermost span of the same thread
    that holds it (None at the top)."""
    out = []
    for e in spans:
        a, b = e["ts"], e["ts"] + e["dur"]
        holders = [p for p in spans if p is not e and p["tid"] == e["tid"]
                   and p["ts"] <= a and b <= p["ts"] + p["dur"]
                   and (p["dur"], -p["ts"]) > (e["dur"], -a)]
        inner = min(holders, key=lambda p: p["dur"], default=None)
        out.append((e, inner["name"] if inner else None))
    return out


def test_a_span_with_nothing_tracing_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record_function was made with nothing tracing")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    s = obs.span("cm3d.test.block")
    assert s is obs.span("cm3d.test.other") is obs._NOOP
    with s:
        pass


def test_totals_time_a_span_with_nothing_tracing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", None)
    totals = {}
    for _ in range(2):
        with obs.span("cm3d.test.io.wait", totals=totals):
            pass
    assert set(totals) == {"cm3d.test.io.wait"} and totals["cm3d.test.io.wait"] >= 0.0
    assert obs.lift_timers({"cm3d.lift.flush": 2.0}, 5.0) == {
        "io": 0.0, "device": 2.0, "write": 0.0, "total": 5.0}


def test_a_range_ends_in_the_session_it_began_in():
    """A span open while one profiler session stops and the next starts
    (the benchmark switches its traced parts inside a call into the port)
    does not end its range under the second: the range is parked, and
    ended once the second has stopped. The next span opened under the
    second opens the outer span's range again there, so the second session
    sees both, nested."""
    from torch.profiler import ProfilerActivity, profile

    first = profile(activities=[ProfilerActivity.CPU])
    first.start()
    outer = obs.span("cm3d.test.outer")
    outer.__enter__()
    first_range = outer.range
    first.stop()
    second = profile(activities=[ProfilerActivity.CPU])
    second.start()
    with obs.span("cm3d.test.inner"):
        torch.ones(2).sum()
    assert obs._parked == [first_range] and outer.range is not first_range
    outer.__exit__(None, None, None)
    second.stop()
    assert obs._parked == []
    events = {e.name: e for e in second.events()}
    inner, again = events["cm3d.test.inner"], events["cm3d.test.outer"]
    assert again.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= again.time_range.end


def test_every_span_of_the_fused_loop_on_its_thread(fused_run):
    spans = fused_run["fused"]
    # the dispatching thread's: the IO thread's canvas upload (`cm3d.h2d`)
    # and the finisher's copy wait (`cm3d.d2h.wait`) are not profiled
    assert {e["tid"] for e in spans} == {fused_run["main"]}
    n, batches = len(DETECTIONS), 2
    count = Counter(e["name"] for e in spans)
    for name in ("cm3d.e2e.keyframe", "cm3d.masks.detic",
                 "cm3d.masks.sam_encode", "cm3d.masks.detic.wait", "cm3d.masks.prompts",
                 "cm3d.e2e.assemble", "cm3d.detic.backbone", "cm3d.detic.proposals",
                 "cm3d.detic.cascade"):
        assert count[name] == n, name
    # the two pulls in flight at the end find the source spent
    assert count["cm3d.e2e.io.wait"] == n + 2
    assert count["cm3d.masks.sam_decode"] == n - 1  # the frame without detections decodes none
    for name in ("cm3d.e2e.flush", "cm3d.lift.step", "cm3d.d2h.start"):
        assert count[name] == batches, name
    assert count["cm3d.e2e.deliver.wait"] == batches  # the second flush's, the loop's end
    assert count["cm3d.d2h.wait"] == n  # Detic's boxes
    assert count["cm3d.quant.linear"] > 0 and count["cm3d.nms.wait"] > 0
    # two host reads and one boolean index a 16-prompt chunk of a camera (one word)
    chunks = sum(-(-k // 16) for k in sum(N_BOXES, []))
    assert count["cm3d.maskpack.wait"] == 2 * chunks


def test_spans_nest_as_the_code_nests_them(fused_run):
    spans = fused_run["fused"]
    seen = set()
    for e, parent in _innermost_parents(spans):
        assert parent in PARENT[e["name"]], (e["name"], parent)
        seen.add(e["name"])
    assert seen == set(PARENT)


def test_a_lift_step_leaves_its_spans_on_the_calling_thread(fused_run):
    spans = fused_run["step"]
    assert {e["tid"] for e in spans} == {fused_run["main"]}
    got = [(e["name"], p) for e, p in _innermost_parents(spans)
           if e["name"] != "cm3d.nms.wait"]
    assert sorted(got) == sorted([("cm3d.h2d", None), ("cm3d.lift.step", None),
                                  ("cm3d.d2h.start", None), ("cm3d.d2h.wait", None)])


def test_the_prompt_counters_equal_hand_counts(fused_run):
    c = fused_run["counted"]
    assert c["masks.prompts"] == sum(map(sum, N_BOXES))
    assert c["masks.prompt_slots"] == sum(CAMS * b for b in BUCKETS if b)
    assert c["masks.frames"] == len(DETECTIONS)
    assert c["masks.masks_written"] == c["masks.prompts"]
    assert c["masks.dropped_masks_total"] == 8 and c["masks.detections"] == 60


def test_a_span_off_the_profiled_thread_is_off():
    """The profiler records the thread that started it: on another thread
    (the fused loop's IO and finisher threads) a span is the no-op, and the
    trace holds the calling thread's span alone."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ThreadPoolExecutor(max_workers=1) as pool:
            assert pool.submit(obs.span, "cm3d.test.io").result() is obs._NOOP
        with obs.span("cm3d.test.main") as s:
            assert s is not obs._NOOP
    assert [e.name for e in prof.events() if e.name.startswith("cm3d.")] == ["cm3d.test.main"]


def test_trace_writes_one_chrome_trace_with_the_spans(tmp_path):
    with obs.trace("block", str(tmp_path)):
        with obs.span("cm3d.test.outer"):
            with obs.span("cm3d.test.inner.wait"):
                torch.ones(4).sum()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["block.json"]
    events = json.loads((tmp_path / "block.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("cm3d.test.outer") == names.count("cm3d.test.inner.wait") == 1
    assert "block" in names
    with obs.trace("none", None):
        pass

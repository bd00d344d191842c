"""What the benchmark drives of the program (cm3d_tpu_torch), and nothing
else: the port's modules built from a configuration file and loaded with the
benchmark's weights, its MaskModels callables, its fused loop `run_fused`,
and its lift step with `run_lift`'s upload and copy back.

The harness wraps calls into the port from outside: the content swap
(frontend.py), ranges around each call for the traced run, and the capture
of what the timed path produced for the sample that `correct` compares.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


def tuples(v):
    """A configuration file's lists as tuples, as the port's configs hold them."""
    return tuple(tuples(x) for x in v) if isinstance(v, list) else v


def sam_config(cfg: dict):
    from cm3d_tpu_torch.models.sam import SamConfig

    return SamConfig(**{k: tuples(v) for k, v in cfg["sam"].items()}, dtype=cfg["precision"])


def lift_config(cfg: dict):
    from cm3d_tpu_torch.config import LiftStageConfig

    return LiftStageConfig(**cfg["lift"])


def mask_config(cfg: dict):
    from cm3d_tpu_torch.config import MaskStageConfig

    return MaskStageConfig(**{k: tuples(v) for k, v in cfg["mask_stage"].items()},
                           dtype=cfg["precision"])


def port_sam(cfg: dict, state: dict, device):
    """The port's float SAM, holding the state's weights."""
    from cm3d_tpu_torch.models.sam import Sam

    with torch.device("meta"):
        sam = Sam(sam_config(cfg))
    sam = sam.to_empty(device=device)
    sam.load_state_dict(state["sam"])
    return sam


def make_step(cfg: dict, device):
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn

    return make_keyframe_step_fn(lift_config(cfg), device=device)


def port_keyframe(kf: dict, **override):
    """The port's Keyframe from a frame's arrays (frontend.make_keyframe)."""
    from cm3d_tpu_torch.datasets.types import CameraParams, Keyframe

    f = {**kf, **override}
    cams = CameraParams(f["cam_ego_t"], f["cam_ego_q"], f["cam_t"], f["cam_q"], f["intrinsics"])
    return Keyframe(points=f["points"], point_valid=f["point_valid"], cameras=cams,
                    mask_bits=f["mask_bits"], mask_cam=f["mask_cam"], mask_label=f["mask_label"],
                    mask_score=f["mask_score"], mask_valid=f["mask_valid"],
                    lane_points=f["lane_points"], lane_valid=f["lane_valid"],
                    ego_translation=f["ego_translation"])


class Frame(list):
    """A keyframe's camera images as run_fused takes them, carrying its pool
    index and its swapped-in detections."""

    def __init__(self, images, idx: int, dets: dict):
        super().__init__(images)
        self.idx, self.dets = idx, dets


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _rf(name: str, on: bool):
    import contextlib

    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


@dataclasses.dataclass
class Probe:
    """The harness's hold on a run: the window's clock, and after the window
    has closed, in a traced run its two traced parts, then the sample's
    captures. The traced parts: `light` (the device's activity alone, which
    slows the host little: device_idle_pct, busy_s) and then `traced` (with
    the host's ranges, which tie each launch to the call into the port that
    made it). Dispatches count from 0 in the measured run; the n-th
    delivery is the n-th dispatch's keyframe."""

    batch_size: int
    seconds: float
    trace: bool = False
    capture_offsets: tuple = ()  # dispatches after the window's close to capture
    trace_frames: int = 0  # dispatches in each traced part
    dispatched: int = 0  # dispatches so far
    close_dispatch: Optional[int] = None  # `dispatched` when the window closed
    delivered: int = 0
    batch_times: list = dataclasses.field(default_factory=list)  # window's deliveries
    batch_delivered: list = dataclasses.field(default_factory=list)  # `delivered` at each
    boxes: dict = dataclasses.field(default_factory=dict)  # dispatch number -> boxes decoded
    stop: bool = False
    captures: dict = dataclasses.field(default_factory=dict)  # dispatch number -> outputs
    profiler: object = None
    active: Optional[dict] = None  # the traced part now recording
    light: dict = dataclasses.field(default_factory=dict)
    traced: dict = dataclasses.field(default_factory=dict)

    def after_close(self) -> Optional[int]:
        """Dispatches since the window closed (None before)."""
        return None if self.close_dispatch is None else self.dispatched - self.close_dispatch

    def on_delivery(self, now: float) -> None:
        """A keyframe's boxes were handed over; a batch is whole at every
        batch_size-th. The window runs from the first whole batch to the
        first one `seconds` after it."""
        self.delivered += 1
        if self.delivered % self.batch_size or self.stop:
            return
        self.batch_times.append(now)
        self.batch_delivered.append(self.delivered)
        if now - self.batch_times[0] >= self.seconds:
            self.stop, self.close_dispatch = True, self.dispatched

    def done(self) -> bool:
        return (self.stop and len(self.captures) >= len(self.capture_offsets)
                and (not self.trace or "window_s" in self.traced))

    def trace_edge(self, device) -> None:
        """Before a dispatch: open or close the traced parts where the
        dispatch count after the window's close says."""
        n = self.after_close()
        if not self.trace or n is None:
            return
        k = self.trace_frames
        if n == 0 and not self.light:
            _start_trace(self, device, light=True)
        elif n == k and self.active is self.light:
            _stop_trace(self, device)
            _start_trace(self, device, light=False)
        elif n == 2 * k and self.active is self.traced:
            _stop_trace(self, device)

    def count(self, key: str, v: int = 1) -> None:
        """Add to the traced part now recording."""
        if self.active is not None:
            self.active[key] = self.active.get(key, 0) + v

    def window_work(self) -> tuple:
        """(keyframes, boxes decoded for them) delivered in the window after
        its first batch."""
        first, last = self.batch_delivered[0], self.batch_delivered[-1]
        return last - first, sum(self.boxes.get(d, 0) for d in range(first, last))


def swap_content(models, captured: list, probe: Probe, planes: dict, device):
    """MaskModels whose detections and decoded planes are the frame's
    swapped-in ones (benchmarks.py `_realistic_load`, copied): the detector,
    the SAM encode and the SAM decode run in full on the stream, and the
    swapped tensors are queued behind them. Captures the outputs of the
    `captured` (key, submodule) pairs of the detector for the frames the
    probe samples, and opens and closes the traced parts."""
    from cm3d_tpu_torch.datasets.types import to_device

    raw_detic, raw_enc, raw_dec = models.detic, models.sam_encode, models.sam_decode_planes
    state = {"frame": None, "capture": None}

    def _hooks(cap):
        def keep(key):
            def hook(_m, _i, out):
                cap.setdefault(key, []).append(_clone(out))
            return hook

        return [m.register_forward_hook(keep(k)) for k, m in captured]

    def detic(frame):
        images = frame["images"]
        probe.trace_edge(device)
        n = probe.after_close()
        cap = None
        if n is not None and n in probe.capture_offsets:
            cap = probe.captures[probe.dispatched] = {"idx": images.idx}
        probe.count("frames")
        probe.dispatched += 1
        state["frame"], state["capture"] = images, cap
        handles = _hooks(cap) if cap is not None else []
        try:
            with _rf("detic", probe.trace):
                out = raw_detic(frame)
        finally:
            for h in handles:
                h.remove()
        d = images.dets
        return tuple(to_device(d[k], out[0].device)
                     for k in ("boxes", "scores", "class_ids", "valid"))

    def sam_encode(frame):
        with _rf("sam", probe.trace):
            emb = raw_enc(frame)
        if state["capture"] is not None:
            state["capture"]["embedding"] = emb.clone()
        return emb

    def sam_decode_planes(emb, boxes, n_boxes, cam_hw, mask_wh, nw, layout="xy"):
        with _rf("sam", probe.trace):
            real = raw_dec(emb, boxes, n_boxes, cam_hw, mask_wh, nw, layout)
        probe.boxes[probe.dispatched - 1] = int(np.sum(n_boxes))
        cap = state["capture"]
        if cap is not None:
            cap.update(planes=real.clone(), prompts=np.array(boxes, np.float32),
                       n_boxes=np.array(n_boxes, np.int64))
        return planes[state["frame"].idx]

    return dataclasses.replace(models, detic=detic, sam_encode=sam_encode,
                               sam_decode_planes=sam_decode_planes)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.detach().clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    return type(out)(_clone(v) for v in out)


def _start_trace(probe: Probe, device, light: bool):
    """Open a traced part, the device drained: `light` records the device's
    activity alone (on a card; the host's ops where there is none), the
    other the host's ops and ranges too, inside the range the trace reader
    takes for its window."""
    sync(device)
    act = torch.profiler.ProfilerActivity
    cuda = device.type == "cuda"
    activities = [act.CUDA] if light and cuda else [act.CPU] + ([act.CUDA] if cuda else [])
    seg = probe.light if light else probe.traced
    probe.profiler, probe.active = torch.profiler.profile(activities=activities), seg
    probe.profiler.start()
    if not light:
        seg["range"] = torch.profiler.record_function("perfbench.traced")
        seg["range"].__enter__()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
    seg["t0"] = time.perf_counter()


def _stop_trace(probe: Probe, device):
    """Close the traced part, the device drained, and read its trace at once
    (a later profiler session may not leave an earlier one's device
    activity readable)."""
    from perfbench import trace

    seg = probe.active
    sync(device)
    seg["window_s"] = time.perf_counter() - seg.pop("t0")
    light = "range" not in seg
    if not light:
        seg["peak_bytes"] = peak_bytes(device)
        seg.pop("range").__exit__(None, None, None)
    probe.profiler.stop()
    seg["trace"] = trace.read_profile(probe.profiler, trace.OUT,
                                      seg["window_s"] if light else None)
    probe.profiler, probe.active = None, None


def int8_ranges(module) -> list:
    """Forward pre / post hooks that open a range around every QuantLinear
    of `module`; returns the handles."""
    from cm3d_tpu_torch.models.common import QuantLinear

    handles = []

    def pre(m, _i):
        m._perfbench_range = torch.profiler.record_function("int8_linear")
        m._perfbench_range.__enter__()

    def post(m, _i, _o):
        m._perfbench_range.__exit__(None, None, None)

    for m in module.modules():
        if isinstance(m, QuantLinear):
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    return handles


def assemble_fn(kf: dict, m_pad: int):
    """run_fused's assemble for one frame: the frame's keyframe with the
    mask stage's planes and metadata (NuScenesFrontend.assemble_keyframe's
    mask fields, as benchmarks.py `bench_e2e` fills them)."""
    from cm3d_tpu_torch.config import CLASS_TO_ID
    from cm3d_tpu_torch.datasets.nuscenes.frontend import get_detection_name

    def assemble(handle, token):
        if handle["planes"] is None:
            return None
        labels = handle["labels"]
        mask_cam = np.zeros(m_pad, np.int32)
        mask_label = np.zeros(m_pad, np.int32)
        mask_score = np.zeros(m_pad, np.float32)
        mask_valid = np.zeros(m_pad, bool)
        for j in range(min(len(labels), m_pad)):
            name = get_detection_name(labels[j])
            if name not in CLASS_TO_ID:
                continue
            mask_cam[j] = handle["cams"][j]
            mask_label[j] = CLASS_TO_ID[name]
            mask_score[j] = handle["scores"][j]
            mask_valid[j] = True
        return port_keyframe(kf, mask_bits=handle["planes"], mask_cam=mask_cam,
                             mask_label=mask_label, mask_score=mask_score,
                             mask_valid=mask_valid), token

    return assemble


def run_e2e(models, step, mask_cfg, frames, keyframes, batch_size: int,
            probe: Optional[Probe], device) -> int:
    """run_fused over `frames` (a list of Frame) in order. Without a probe:
    the warm-up, over the list once. With one: cycled until the probe is
    done (the window closed, the sample captured, the trace taken); every
    delivery goes to the probe, and a sampled frame's boxes to its capture."""
    from cm3d_tpu_torch.pipelines.e2e import run_fused

    m_pad = keyframes[0]["mask_cam"].shape[0]
    asm = [assemble_fn(kf, m_pad) for kf in keyframes]
    if probe is not None:
        probe.dispatched = 0  # the i-th frame the source yields is the i-th dispatched

    def source():
        i = 0
        while (i < len(frames)) if probe is None else not probe.done():
            f = frames[i % len(frames)]
            yield f, (lambda h, f=f, i=i: asm[f.idx](h, (f.idx, i)))
            i += 1

    def on_boxes(token, boxes):
        if probe is None:
            return
        probe.on_delivery(time.perf_counter())
        cap = probe.captures.get(token[1])
        if cap is not None:
            cap["boxes"] = boxes

    return run_fused(models, step, source(), mask_cfg, on_boxes, batch_size, device=device)


def lift_batches(pool: list, batch_size: int, device) -> list:
    """The pool as the lift's batches, each (pool indices, Keyframe of
    stacked host tensors, pinned when the step runs on a card): the pool
    is held in pinned host memory, and a batch goes up through `to_device`
    with no host copy. Batch i holds keyframes i*B ... i*B + B - 1 of the
    pool, cycled."""
    from math import gcd

    from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes

    def host(x):
        t = torch.from_numpy(np.ascontiguousarray(x.view(np.int32) if x.dtype == np.uint32
                                                  else x))
        return t.pin_memory() if device.type == "cuda" else t

    out = []
    for i in range(len(pool) // gcd(len(pool), batch_size)):
        idx = [(i * batch_size + j) % len(pool) for j in range(batch_size)]
        frames = stack_keyframes([port_keyframe(pool[j]) for j in idx]).frames
        out.append((idx, map_fields(host, frames)))
    return out


def run_lift(step, batches: list, probe: Optional[Probe], steps: int, device):
    """run_lift's loop (pipelines/lift.py `flush`) over the pool's batches,
    cycled: `to_device`, the step, one copy back of (boxes, lift), waited
    for. Without a probe: `steps` steps (the warm-up). With one: until the
    probe is done; a sampled step's batch and boxes go to its capture, the
    traced steps run between two drains."""
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.utils.fetch import device_fetch

    i = 0
    while (i < steps) if probe is None else not probe.done():
        idx, frames = batches[i % len(batches)]
        n = None
        if probe is not None:
            probe.trace_edge(device)
            n = probe.after_close()
        with _rf("lift_step", probe is not None and probe.trace):
            lift, boxes = step(to_device(frames, device))
        boxes_np, _ = device_fetch((boxes, lift))
        if probe is not None:
            probe.count("steps")
            probe.count("frames", len(idx))
            if probe.active is probe.traced:
                probe.traced.setdefault("step_pool", []).append(idx)
            if n is not None and n in probe.capture_offsets:
                probe.captures[probe.dispatched] = {"idx": idx, "boxes": boxes_np}
            probe.dispatched += 1
            for _ in idx:
                probe.on_delivery(time.perf_counter())
        i += 1
    return i

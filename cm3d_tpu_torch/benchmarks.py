"""Benchmarks of the port, at production geometry.

  bench_lift       — the batched lift step on synthetic keyframes.
  bench_mask_stage — the pipelined 2D stage loop (run_mask_stage) with
                     full-width random-weight Detic Swin-B + SAM (ViT-H
                     unless `sam_size` says otherwise).
  bench_e2e        — the fused images -> boxes loop (pipelines.e2e.run_fused)
                     with the same models and the production lift step.
  bench_e2e_fast_profile — bench_e2e over the composed speed modes (SAM
                     size x rect encode x int8), the fastest point first.
  bench_train      — the CenterPoint pretraining step at production pillar
                     scale (128 x 128 grid, full trunk, batch 8).
  bench_fusion_train — the BEVFusion step: the same plus a 6-camera ring
                     through the camera backbone and the lift-splat pooling.

Model content caveat (mask stage): random full-width weights give the
production FLOPs and geometry but meaningless detections, so the detector's
output is replaced with a realistic ~25 boxes per camera and the decoded
planes with realistic blob masks. The device work (Detic, SAM encode, SAM
decode + bit-pack) is all real and stays in the timeline: each swapped
tensor is queued on the stream after the real work it stands for, so a copy
that waits for it waits for that work (see `_realistic_load`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

C = 6  # nuScenes camera ring
IMG_H, IMG_W = 576, 1024  # 1024-thumbnail geometry (reference :293)


def bench_lift(batch_size: int = 8, n_iters: int = 10, device=None) -> dict:
    """Lift-stage throughput: the fused per-keyframe step (reference
    src/nuscenes/2d_to_3d.py main loop) at realistic nuScenes scale —
    131072 aggregated sweep points, 128 masks at 1024x576, 6 cameras.

    Protocol: `batch_size` default-`SyntheticConfig` keyframes moved to the
    device once, one warm-up step, then `n_iters` timed steps, with the
    device synchronised before the clock is read. Runs on CUDA unless
    `device` says otherwise."""
    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    lift_cfg = LiftStageConfig()
    syn = SyntheticConfig()
    rng = np.random.default_rng(0)

    frames = [make_keyframe(syn, lift_cfg, rng) for _ in range(batch_size)]
    batch = stack_keyframes(frames)
    device_frames = to_device(batch.frames, device)
    step = make_keyframe_step_fn(lift_cfg, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    step(device_frames)  # warm-up: kernel build and load, allocator
    sync()

    t0 = time.perf_counter()
    for _ in range(n_iters):
        step(device_frames)
    sync()
    dt = time.perf_counter() - t0

    kf_per_sec = n_iters * batch_size / dt
    target = 50.0  # BASELINE.json's target: >= 50 keyframes/sec per chip
    return {
        "metric": "lift_keyframes_per_sec_per_chip",
        "value": round(kf_per_sec, 2),
        "unit": "keyframes/sec",
        "vs_baseline": round(kf_per_sec / target, 3),
    }


def production_fake_modules(dtype: str = "bfloat16", device=None, seed: int = 0,
                            fused_window_attn: bool = False, vocabulary=None,
                            sam_size: str = "vit_h", rect_encode: bool = False):
    """The modules of `build_production_fake_models`, float, unwrapped:
    (Detic Swin-B, classifier [embed_dim, len(vocabulary)], SAM `sam_size`).
    Detic's weights come from `seed` alone, so they are the same at every
    SAM size."""
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.detic import DETIC_SWINB, Detic
    from cm3d_tpu_torch.models.sam import Sam, sam_config_for
    from cm3d_tpu_torch.utils.device import resolve_device
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES

    device = resolve_device(device)
    vocabulary = vocabulary or CUSTOM_VOCABULARY_NUSCENES
    detic_cfg = dataclasses.replace(
        DETIC_SWINB, dtype=dtype, swin=dataclasses.replace(DETIC_SWINB.swin, dtype=dtype))
    sam_cfg = dataclasses.replace(sam_config_for(sam_size), dtype=dtype, rect_encode=rect_encode,
                                  fused_window_attn=fused_window_attn)
    clf = np.random.default_rng(seed).standard_normal(
        (detic_cfg.embed_dim, len(vocabulary))).astype(np.float32)
    with torch.device(device):
        gen = torch.Generator(device=device)
        detic = init_weights(Detic(detic_cfg), gen.manual_seed(seed))
        sam = init_weights(Sam(sam_cfg), gen.manual_seed(seed + 1))
    return detic, clf, sam


def build_production_fake_models(dtype: str = "bfloat16", device=None, seed: int = 0,
                                 fused_window_attn: bool = False, vocabulary=None,
                                 quant_int8: bool = False, quant_static: bool = False,
                                 sam_size: str = "vit_h", rect_encode: bool = False):
    """Full-width Detic Swin-B + SAM with random weights drawn from a
    torch.Generator seeded with `seed` (the FLOPs of converted
    checkpoints), built on `device` behind the standard batched wrappers.
    `sam_size` picks the SAM encoder scale (vit_h = the reference's deploy,
    vit_l / vit_b = the released smaller checkpoints); `rect_encode` encodes
    the 1024x576 image without padding it to the square.
    `fused_window_attn` runs SAM's windowed blocks through the fused
    kernels (same weights from the same seed); `quant_int8` /
    `quant_static` the int8 twins of the same weights
    (`pipelines.masks.quantized_models`). `vocabulary` is the nuScenes one
    unless given."""
    from cm3d_tpu_torch.pipelines.masks import _batched_model_fns, quantized_models
    from cm3d_tpu_torch.utils.device import resolve_device
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES

    device = resolve_device(device)
    vocabulary = vocabulary or CUSTOM_VOCABULARY_NUSCENES
    detic, clf, sam = production_fake_modules(dtype, device, seed, fused_window_attn, vocabulary,
                                              sam_size=sam_size, rect_encode=rect_encode)
    detic, sam = quantized_models(detic, sam, quant_int8, quant_static)
    return _batched_model_fns(detic, clf, sam, vocabulary, device=device)


def _realistic_load(models, boxes_per_cam: int = 25, seed: int = 0):
    """Wrap MaskModels so the DETECTOR CONTENT is a realistic ~25
    boxes/camera and the PLANE CONTENT realistic blob masks, while the real
    device work stays in the timeline: the swapped tensors are uploaded
    (pinned, non-blocking) on the stream after the real Detic / decode, so
    the pipeline's copies back wait for that work as they would for the
    real outputs."""
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.ops.bitmask import pack_masks_np
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES as VOCAB

    rng = np.random.default_rng(seed)
    raw_detic, raw_dec = models.detic, models.sam_decode_planes

    def detic_realistic(frame):
        boxes, _, _, _ = raw_detic(frame)
        n, d = boxes.shape[:2]
        vb = np.zeros((n, d), bool)
        vb[:, :boxes_per_cam] = True
        fake_boxes = rng.uniform(0, 500, (n, d, 4)).astype(np.float32)
        fake_boxes[..., 2:] += fake_boxes[..., :2] + 30
        fake = (fake_boxes, rng.random((n, d)).astype(np.float32) * 0.9 + 0.1,
                rng.integers(0, len(VOCAB), (n, d)), vb)
        return tuple(to_device(a, boxes.device) for a in fake)

    blob_planes: dict = {}  # (nw, layout) -> int32 planes on the device

    def _blobs(nw: int, layout: str, device) -> torch.Tensor:
        if (nw, layout) not in blob_planes:
            m = nw * 32
            blob = np.zeros((m, IMG_W, IMG_H), np.uint8)
            # ~120x90 px instance blobs at the production canvas
            bw, bh = min(120, IMG_W), min(90, IMG_H)
            for i in range(m):
                x = rng.integers(0, max(IMG_W - bw - 30, 1))
                y = rng.integers(0, max(IMG_H - bh - 10, 1))
                blob[i, x:x + bw, y:y + bh] = 1
            packed = pack_masks_np(blob)
            if layout == "yx":
                packed = np.swapaxes(packed, 0, 1)
            blob_planes[(nw, layout)] = to_device(packed, device)
        return blob_planes[(nw, layout)]

    def dec_blob(emb, boxes, n_boxes, cam_hw, mask_wh, nw, layout="xy"):
        real = raw_dec(emb, boxes, n_boxes, cam_hw, mask_wh, nw, layout)
        if tuple(mask_wh) != (IMG_W, IMG_H):
            return real
        # uploaded once; its download is queued on the stream after the
        # real decode, so it waits for the decode as the real planes' would
        return _blobs(nw, layout, real.device)

    return dataclasses.replace(models, detic=detic_realistic, sam_decode_planes=dec_blob)


def bench_mask_stage(dtype: str = "bfloat16", n_frames: int = 8, models=None,
                     io_sleep: float = 0.15, device=None, quant_int8: bool = False,
                     quant_static: bool = False, rect_encode: bool = False,
                     sam_size: str = "vit_h") -> dict:
    """Pipelined 2D-stage throughput: run_mask_stage (IO prefetch + device
    pipeline + host RLE writes) at production geometry, 6 cameras at
    1024x576.

    Protocol (the JAX package's): one warm-up frame, unpipelined
    generate_frame_masks calls (`per_frame_ms`), a warmed run_mask_stage,
    then `n_frames` pipelined frames (`pipelined_ms`, the reported rate).
    The provider sleeps `io_sleep` s per frame as a stand-in for 6 JPEG
    reads + thumbnails, which caps the rate at 1 / io_sleep. The device is
    synchronised before every clock read. `quant_int8` / `quant_static`
    pick the int8 models when they are built here (a static model
    calibrates on the warm-up frame), `sam_size` / `rect_encode` the SAM
    encoder's scale and its rectangular encode."""
    import shutil
    import tempfile

    from cm3d_tpu_torch.config import MaskStageConfig
    from cm3d_tpu_torch.pipelines.masks import generate_frame_masks, run_mask_stage
    from cm3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    built = models is None
    if built:
        models = _realistic_load(build_production_fake_models(
            dtype, device=device, quant_int8=quant_int8, quant_static=quant_static,
            sam_size=sam_size, rect_encode=rect_encode))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(0)
    frames = [[rng.integers(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8) for _ in range(C)]
              for _ in range(2)]
    cfg = MaskStageConfig(dtype=dtype)
    n_warm = len(generate_frame_masks(models, frames[0], cfg).labels)

    n_unpiped = max(n_frames // 2, 2)
    sync()
    t0 = time.perf_counter()
    for i in range(n_unpiped):
        generate_frame_masks(models, frames[i % 2], cfg)
    sync()
    per_frame_ms = (time.perf_counter() - t0) / n_unpiped * 1000

    def provider(scene, frame):
        time.sleep(io_sleep)  # stand-in for 6 JPEG reads + thumbnail
        return frames[frame % 2]

    warm_dir = tempfile.mkdtemp(prefix="maskbench_warm_")
    out = tempfile.mkdtemp(prefix="maskbench_")
    try:
        run_mask_stage(models, provider, ["warm"], lambda s: 1, warm_dir, cfg, verbose=False)
        sync()
        t0 = time.perf_counter()
        run_mask_stage(models, provider, ["bench"], lambda s: n_frames, out, cfg,
                       verbose=False)
        sync()
        pipelined_ms = (time.perf_counter() - t0) / n_frames * 1000
    finally:
        shutil.rmtree(warm_dir, ignore_errors=True)
        shutil.rmtree(out, ignore_errors=True)
    return {
        "metric": "mask_stage_keyframes_per_sec_per_chip",
        "value": 1000.0 / pipelined_ms,
        "unit": "keyframes/sec",
        "per_frame_ms": per_frame_ms,
        "pipelined_ms": pipelined_ms,
        "n_frames": n_frames,
        "io_sleep": io_sleep,
        "warmup_masks": n_warm,
        "dtype": dtype,
        # the modes the models were built with here; None for passed models
        "rect_encode": rect_encode if built else None,
        "quant_int8": quant_int8 if built else None,
        "quant_static": quant_static if built else None,
        "sam_size": sam_size if built else None,
        # a static model's first-ring calibration (the warm-up frame), once
        "calibration_s": getattr(models.sam_encode, "calibration", {}).get("seconds"),
    }


def bench_e2e(dtype: str = "bfloat16", n_frames: int = 12, batch_size: int = 4, models=None,
              fused_window_attn: bool = False, device=None, quant_int8: bool = False,
              quant_static: bool = False, rect_encode: bool = False,
              sam_size: str = "vit_h") -> dict:
    """Fused end-to-end throughput: images -> Detic -> SAM -> bit-planes ->
    lift step -> boxes, through pipelines.e2e.run_fused (the production
    fused loop; planes stay on the device). The synthetic keyframes carry
    production-scale LiDAR / lane payloads; the mask planes come from the
    real SAM decode dispatch (content swapped to realistic blobs).

    Protocol (the JAX package's): one warm-up run of `batch_size` frames,
    then `n_frames` timed frames in batches of `batch_size`, the device
    synchronised before each clock read. `fused_window_attn`, `quant_int8`,
    `quant_static`, `rect_encode` and `sam_size` set the configs when the
    models are built here; passed `models` run as built."""
    from cm3d_tpu_torch.config import CLASS_TO_ID, LiftStageConfig, MaskStageConfig
    from cm3d_tpu_torch.datasets.nuscenes.frontend import get_detection_name
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.pipelines.e2e import run_fused
    from cm3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    lift_cfg = LiftStageConfig()
    mask_cfg = MaskStageConfig(dtype=dtype)
    if mask_cfg.max_masks_total != lift_cfg.max_masks:
        raise ValueError("the fused path needs MaskStageConfig.max_masks_total == "
                         "LiftStageConfig.max_masks")
    rng = np.random.default_rng(0)
    built = models is None
    if built:
        models = _realistic_load(build_production_fake_models(
            dtype, device=device, fused_window_attn=fused_window_attn,
            quant_int8=quant_int8, quant_static=quant_static, sam_size=sam_size,
            rect_encode=rect_encode))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    syn = SyntheticConfig(image_w=IMG_W, image_h=IMG_H)
    base_kfs = [make_keyframe(syn, lift_cfg, rng) for _ in range(2)]
    images = [[rng.integers(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8) for _ in range(C)]
              for _ in range(2)]
    step = make_keyframe_step_fn(lift_cfg, device=device)
    m_pad = lift_cfg.max_masks

    def frame_source(n):
        for i in range(n):
            base = base_kfs[i % 2]

            def assemble(handle, base=base, token=i):
                # mirror NuScenesFrontend.assemble_keyframe's mask fields,
                # with the rest of the keyframe from the synthetic frontend
                if handle["planes"] is None:  # run_fused calls us always
                    return None
                labels = handle["labels"]
                m_real = min(len(labels), m_pad)
                mask_cam = np.zeros(m_pad, np.int32)
                mask_label = np.zeros(m_pad, np.int32)
                mask_score = np.zeros(m_pad, np.float32)
                mask_valid = np.zeros(m_pad, bool)
                for j in range(m_real):
                    name = get_detection_name(labels[j])
                    if name not in CLASS_TO_ID:
                        continue
                    mask_cam[j] = handle["cams"][j]
                    mask_label[j] = CLASS_TO_ID[name]
                    mask_score[j] = handle["scores"][j]
                    mask_valid[j] = True
                kf = base._replace(
                    # stays a device tensor: run_fused stacks device leaves
                    # on the device (the real path's planes never visit the host)
                    mask_bits=handle["planes"],
                    mask_cam=mask_cam, mask_label=mask_label, mask_score=mask_score,
                    mask_valid=mask_valid,
                )
                return kf, token

            yield images[i % 2], assemble

    boxes_seen = [0]

    def on_boxes(token, b):
        boxes_seen[0] += int(np.asarray(b.keep).sum())

    # warm-up: kernel builds and loads, the allocator, cuDNN's choices
    run_fused(models, step, frame_source(batch_size), mask_cfg, on_boxes, batch_size,
              device=device)
    sync()

    boxes_seen[0] = 0
    t0 = time.perf_counter()
    done = run_fused(models, step, frame_source(n_frames), mask_cfg, on_boxes, batch_size,
                     device=device)
    sync()
    dt = time.perf_counter() - t0
    return {
        "metric": "e2e_keyframes_per_sec_per_chip",
        "value": done / dt,
        "unit": "keyframes/sec",
        "ms_per_keyframe": dt / done * 1000,
        "n_frames": done,
        "batch_size": batch_size,
        "boxes_kept": boxes_seen[0],
        "dtype": dtype,
        # the modes the models were built with here; None for passed models
        "rect_encode": rect_encode if built else None,
        "quant_int8": quant_int8 if built else None,
        "quant_static": quant_static if built else None,
        "sam_size": sam_size if built else None,
    }


# The accuracy envelopes of the opt-in speed modes against the exact path,
# on the same random full-width weights, each naming where its figure was
# measured; re-validate on real checkpoints with `conform`.
_SPEED_MODE_ACCURACY = {
    "rect_encode": (
        "SAM ViT-H bf16 image-region embedding rel err 0.354 against the square "
        "encode, random weights (chip_smoke.py phase 23, NVIDIA H100 80GB HBM3, "
        "700.00 W)"
    ),
    "quant_int8": (
        "SAM ViT-H embedding rel err 0.0331, corr 0.99945 against bf16, random "
        "weights (chip_smoke.py phase 20, NVIDIA H100 80GB HBM3, 700.00 W)"
    ),
    "sam_size": (
        "architecture swap to the released smaller SAM checkpoints: accuracy "
        "against vit_h is a question of model quality that random weights "
        "cannot measure (not measured); the reference deploys vit_h "
        "(gen_2d_masks_detic.py:112)"
    ),
}


def bench_e2e_fast_profile(dtype: str = "bfloat16", n_frames: int = 12, batch_size: int = 4,
                           device=None) -> dict:
    """The max-throughput deploy profile: the opt-in speed modes (SAM
    encoder scale x rect_encode x int8) composed through the same fused
    `bench_e2e` in one process, so the points are comparable. The headline
    is the fastest point; every point carries its ms a keyframe, its kept
    boxes (the content swap makes them comparable across modes: equal
    counts mean the modes did not perturb the pipeline) and its accuracy
    envelope against the exact path. The points build their full-width
    models one after another; each point's go out of scope before the
    next is built, and the card's peak memory of each goes to stderr."""
    import gc
    import sys

    from cm3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    grid = [
        ("exact_vit_h", dict(sam_size="vit_h")),
        ("vit_h_rect_int8", dict(sam_size="vit_h", rect_encode=True, quant_int8=True)),
        ("vit_l_rect_int8", dict(sam_size="vit_l", rect_encode=True, quant_int8=True)),
        ("vit_b_rect_int8", dict(sam_size="vit_b", rect_encode=True, quant_int8=True)),
    ]
    points = []
    for name, kw in grid:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        r = bench_e2e(dtype=dtype, n_frames=n_frames, batch_size=batch_size, device=device, **kw)
        gc.collect()  # the point's models, before the next point builds its own
        if device.type == "cuda":
            torch.cuda.empty_cache()
            print(f"{name}: peak device memory "
                  f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB", file=sys.stderr)
        accuracy = [_SPEED_MODE_ACCURACY[mode] for mode in ("rect_encode", "quant_int8")
                    if kw.get(mode)]
        if kw.get("sam_size", "vit_h") != "vit_h":
            accuracy.append(_SPEED_MODE_ACCURACY["sam_size"])
        points.append({
            "profile": name,
            "ms_per_keyframe": r["ms_per_keyframe"],
            "keyframes_per_sec": r["value"],
            "boxes_kept": r["boxes_kept"],
            "accuracy_envelope": accuracy or ["exact baseline"],
            **{k: r[k] for k in ("rect_encode", "quant_int8", "sam_size")},
        })
    counts = {p["boxes_kept"] for p in points}
    fastest = min(points, key=lambda p: p["ms_per_keyframe"])
    return {
        "metric": "e2e_fast_profile_keyframes_per_sec_per_chip",
        "value": fastest["keyframes_per_sec"],
        "unit": "keyframes/sec",
        # BASELINE.json's target of 50 keyframes/s, not a measurement
        "vs_baseline": round(fastest["keyframes_per_sec"] / 50.0, 4),
        "fastest_profile": fastest["profile"],
        "boxes_invariant_across_modes": len(counts) == 1,
        "points": points,
        "note": ("composed opt-in speed modes on the fused bench_e2e (random full-width "
                 "weights, content swap: see cm3d_tpu_torch/benchmarks.py); exact_vit_h "
                 "is the accuracy baseline"),
    }


def _synthetic_train_arrays(batch_size: int, pillar_cfg, num_classes: int,
                            n_pts: int = 32768, n_box: int = 64, seed: int = 0):
    """Shared synthetic LiDAR training workload for bench_train and
    bench_fusion_train (the JAX package's arrays, from the same seed): one
    definition so the LiDAR-only and fusion step numbers stay comparable."""
    rng = np.random.default_rng(seed)
    pts = np.empty((batch_size, n_pts, 4), np.float32)
    pts[..., 0] = rng.uniform(pillar_cfg.x_min, pillar_cfg.x_max, (batch_size, n_pts))
    pts[..., 1] = rng.uniform(pillar_cfg.y_min, pillar_cfg.y_max, (batch_size, n_pts))
    pts[..., 2] = rng.uniform(-2.0, 1.0, (batch_size, n_pts))
    pts[..., 3] = rng.uniform(0.0, 1.0, (batch_size, n_pts))
    boxes = np.zeros((batch_size, n_box, 8), np.float32)
    boxes[..., 0] = rng.uniform(-45, 45, (batch_size, n_box))
    boxes[..., 1] = rng.uniform(-45, 45, (batch_size, n_box))
    boxes[..., 3:6] = rng.uniform(0.5, 4.5, (batch_size, n_box, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (batch_size, n_box))
    boxes[..., 7] = rng.integers(0, num_classes, (batch_size, n_box))
    return pts, boxes, n_pts, n_box


def _timed_steps(step, state, batch, n_iters: int, device):
    """One warm-up step, then `n_iters` timed ones with one synchronisation
    at the end; returns (seconds, first loss, last loss)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    state, metrics = step(state, batch)  # warm-up: kernel build, cuDNN's choices
    sync()
    first = float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(n_iters):
        state, metrics = step(state, batch)
    sync()  # one stream: the last sync covers all
    dt = time.perf_counter() - t0
    return dt, first, float(metrics["loss"])


def train_bench_setup(batch_size: int = 8, device=None, pillar_cfg=None, model_cfg=None,
                      n_pts: int = 32768, n_box: int = 64):
    """(step, state, batch) of bench_train: a seed-0 CenterPointDetector and
    one fixed synthetic batch on `device`."""
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig, make_train_step
    from cm3d_tpu_torch.train.train import TrainBatch, init_state
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32

    device = resolve_device(device)
    strict_f32()
    pillar_cfg = pillar_cfg or PillarConfig()
    model_cfg = model_cfg or CenterPointConfig()
    state, model, tx = init_state(0, pillar_cfg, model_cfg, device=device)
    step = make_train_step(model, tx, pillar_cfg)
    pts, boxes, n_pts, n_box = _synthetic_train_arrays(
        batch_size, pillar_cfg, model_cfg.num_classes, n_pts, n_box)
    batch = to_device(TrainBatch(
        points=pts, point_valid=np.ones((batch_size, n_pts), bool),
        boxes=boxes, box_valid=np.ones((batch_size, n_box), bool)), device)
    return step, state, batch


def bench_train(batch_size: int = 8, n_iters: int = 20, device=None, **setup) -> dict:
    """Pretraining step time at production pillar scale (128 x 128 grid,
    full trunk): voxelize -> CenterPoint forward -> focal + L1 -> AdamW, on
    one fixed synthetic batch. Protocol: one warm-up step, `n_iters` timed,
    one synchronisation at the end. Runs on CUDA unless `device` says
    otherwise; `setup` (see train_bench_setup) lets a test run it small."""
    from cm3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    step, state, batch = train_bench_setup(batch_size, device, **setup)
    dt, first, last = _timed_steps(step, state, batch, n_iters, device)
    return {
        "metric": "train_step_ms_batch8",
        "value": dt / n_iters * 1000,
        "unit": f"ms/step (batch {batch_size})",
        "steps_per_sec": n_iters / dt,
        "first_loss": first,
        "last_loss": last,
        "n_iters": n_iters,
    }


def fusion_bench_setup(batch_size: int = 8, image_hw=(144, 256), camera_backbone: str = "conv",
                       camera_bf16: bool = False, camera_fused: bool = True, device=None,
                       pillar_cfg=None, fusion_cfg=None, n_pts: int = 32768, n_box: int = 64):
    """(step, state, batch) of bench_fusion_train: bench_train's LiDAR
    workload plus a random 6-camera ring with identity extrinsics."""
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig
    from cm3d_tpu_torch.train.bevfusion import (
        BevFusionConfig,
        FusionBatch,
        init_fusion_state,
        make_fusion_train_step,
    )
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32

    device = resolve_device(device)
    strict_f32()
    pillar_cfg = pillar_cfg or PillarConfig()
    cfg = fusion_cfg or BevFusionConfig(
        centerpoint=CenterPointConfig(), camera_backbone=camera_backbone,
        camera_bf16=camera_bf16, camera_fused=camera_fused)
    state, model, tx = init_fusion_state(0, pillar_cfg, cfg, image_hw, n_cams=C, device=device)
    step = make_fusion_train_step(model, tx, pillar_cfg)

    rng = np.random.default_rng(0)
    ih, iw = image_hw
    pts, boxes, n_pts, n_box = _synthetic_train_arrays(
        batch_size, pillar_cfg, cfg.centerpoint.num_classes, n_pts, n_box)
    k = np.array([[260.0, 0, iw / 2], [0, 260.0, ih / 2], [0, 0, 1]], np.float32)
    batch = to_device(FusionBatch(
        points=pts, point_valid=np.ones((batch_size, n_pts), bool),
        boxes=boxes, box_valid=np.ones((batch_size, n_box), bool),
        images=rng.random((batch_size, C, ih, iw, 3)).astype(np.float32),
        intrinsics=np.tile(k, (batch_size, C, 1, 1)),
        cam_to_ego=np.tile(np.eye(4, dtype=np.float32), (batch_size, C, 1, 1))), device)
    return step, state, batch, cfg


def bench_fusion_train(batch_size: int = 8, n_iters: int = 20, image_hw=(144, 256),
                       device=None, **setup) -> dict:
    """BEVFusion training-step time at production pillar scale: bench_train's
    LiDAR workload plus the 6-camera ring through the camera backbone (lite
    conv trunk or full Swin-T, `camera_backbone`) + depth head + lift-splat
    BEV pooling (82944 splat elements a sample at 144 x 256 / 24 bins). Same
    protocol as bench_train; `setup` as fusion_bench_setup takes it."""
    from cm3d_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    step, state, batch, cfg = fusion_bench_setup(batch_size, image_hw, device=device, **setup)
    dt, first, last = _timed_steps(step, state, batch, n_iters, device)
    ih, iw = image_hw
    return {
        "metric": "fusion_train_step_ms_batch8",
        "value": dt / n_iters * 1000,
        "unit": f"ms/step (batch {batch_size}, {C}x{ih}x{iw} ring)",
        "steps_per_sec": n_iters / dt,
        "first_loss": first,
        "last_loss": last,
        "n_iters": n_iters,
        "camera_backbone": cfg.camera_backbone,
        "camera_bf16": cfg.camera_bf16,
        "camera_fused": cfg.camera_fused,
    }

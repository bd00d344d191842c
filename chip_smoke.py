#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cm3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times   # timings only, see kernel_times
    python3 chip_smoke.py --host-benches   # end-to-end timings only, see host_benches
    python3 chip_smoke.py --quant-zoe-phase   # phase 20 alone
    python3 chip_smoke.py --gdino-phase   # phase 21 alone
    python3 chip_smoke.py --model-parallel-phase   # phase 22 alone
    python3 chip_smoke.py --bench-entry-phase   # phase 23 alone
    python3 chip_smoke.py --sam-global-attn-phase   # phase 7's global-block part alone

Phases, each of which raises on a failed check (exit code != 0):

1. Card and build: print the card's name and power limit, build every CUDA
   kernel from csrc/ (one nvcc per source, all at once); from `cuobjdump
   -sass` of the built libraries, every bf16 instance of the shared GEMM
   (qkv_gemm_kernel, proj_gemm_kernel) must hold HGMMA (wgmma) and UTMALDG
   (TMA loads) and no HMMA (mma.sync).
2. Kernels: capture each kernel's inputs from a real batch-8 lift step at
   production geometry, then hold the kernel against its plain PyTorch
   version on those inputs — compaction bit-exact at all three stages,
   medoid sums to rtol=1e-5 with equal argmins wherever the two smallest
   sums differ by more than 1e-5 relative, and equal bits from a second
   call of each — and time kernel, plain version and (medoid) torch.cdist
   with CUDA events; each compaction stage's device span (device_span_ms:
   a spin kernel holds the card while the host queues the calls), its
   kernels' durations (kernels_ms, torch.profiler) and their split over
   count and scatter, and the share of value sectors holding a kept source.
3. Main path: the benchmark entry's default run (`python -m
   cm3d_tpu_torch.bench`, no stage: bench_lift at batch 8, one JSON line
   with its note), in this process, with every launch count reset just
   before; each step must launch the compaction kernel 3 times and the
   medoid kernel once. One more step is checked for sane outputs and
   against the port's plain CPU path on 2 of its keyframes.
4. Window attention: one full-width bf16 Detic Swin-B forward on a
   6-camera 1024x576 ring records the kernel's inputs at each of the 8
   distinct (stage, shift) shapes. At each, the bf16 kernels are held to
   the plain version run in f32 on the same bf16-rounded inputs and weights
   (max abs error <= 2^-5 of max|plain|, four bf16 ulps at the top of the
   range), the f32 kernels to the f32 plain version (<= 1e-4 of max|plain|),
   and kernels and bf16 plain version are timed with CUDA events beside the
   bound; the heads launcher's time is split over its three kernels (LN
   pass, qkv GEMM, attention; torch.profiler device times), the attention
   kernel beside its own bound (qkv read once, o written once), and two
   yardsticks the port never calls are timed beside them: one
   scaled_dot_product_attention call on the same q / k / v with the bias and
   shift mask, and F.linear on the window-ordered o. The bf16 GEMM alone, at
   both entries: device time, TFLOP/s over the real rows, tiles and waves
   over the SMs, beside F.linear on the same operands (for qkv on
   round_bf16(LN(x)) in window order).
5. Mask stage: bench_mask_stage at production geometry (Detic Swin-B +
   SAM ViT-H, bf16, 6 x 1024x576, 8 frames) with the window-attention
   counts reset just before; every Detic forward must launch each of the two
   kernels 24 times (one per Swin block). Run with the JAX protocol's 0.15 s
   IO stand-in, and again without it, so the device-side rate shows. One
   keyframe is profiled.
6. Mask-path CPU check: DETIC_TEST / SAM_TEST from one torch.Generator
   seed, one 6-camera keyframe through generate_frame_masks on the card
   (f32, TF32 off) and on the CPU (plain versions): equal valid flags and
   class ids, boxes within 1e-3 px, planes bit-equal except bits whose
   upsampled logit lies within 1e-3 of 0.
7. Rel-pos window attention (SAM): the inputs of the first windowed block
   of a full-width bf16 ViT-H encode at the square grid [1, 64, 64, 1280],
   and their top 36 rows as the rect grid [1, 36, 64, 1280]. The bf16
   kernels (heads, then the shared projection) against the f32 plain
   version on the same bf16-rounded inputs (<= 2^-5 of max|plain|), the f32
   kernels against the f32 plain version (<= 1e-4 of max|plain|); CUDA-event
   times beside the bound, the launcher's split over its three kernels, the
   attention kernel beside its own bound, the GEMM and its F.linear
   yardsticks as in phase 4, and one
   scaled_dot_product_attention call on the same q / k / v with the
   decomposed rel-pos bias materialised as its float mask (a yardstick for
   the attention kernel). The global blocks' flash kernel at ViT-H's square
   and ViT-B's rect grid (one camera, random bf16 q / k / v and tables; also
   alone: `chip_smoke.py --sam-global-attn-phase`): its error against
   float64 no larger than the plain chain's, its time beside its bound, the
   chain's and one SDPA call's with the bias as a float mask (a yardstick).
   Then one 6-camera ViT-H encode with
   the fused blocks and without, same weights: ms per camera and the
   difference of the embeddings.
8. Fused path: bench_e2e (images -> Detic -> SAM -> planes on the card ->
   lift step -> boxes; 4 warm-up + 12 timed keyframes in batches of 4) with
   SAM's windowed blocks fused, every count reset just before: each
   keyframe must launch each rel-pos kernel 28 x 6 = 168 times, each Detic
   forward 24 + 24 Swin launches, each lift step 3 compactions and 1 medoid.
   Then the same unfused (0 rel-pos launches) for the A/B.
9. Fused-path CPU check: DETIC_TEST / SAM_TEST (fused blocks, f32, TF32
   off), run_fused over 4 synthetic keyframes on the card and on the CPU:
   equal point counts, keep flags and labels, centroids within 1e-4 m but
   for medoid ties.
10. Segment kernels (training): the inputs of one real batch-8 pillarize and
   of the batch-8 lift-splat pooling, the latter twice: with the identity
   extrinsics of bench_fusion_train (the main path's inputs: a few cells hold
   runs of hundreds of elements) and with a ring of six outward cameras (most
   elements in range); the callers pass n_cells = h*w, so their sink id h*w
   matches no column. segment_sum_max and segment_sum against their plain
   scatter versions (sums rtol 1e-5 / atol 1e-5 and within k 2^-24 sum|v| of
   the f64 sums; maxima, empty-cell -inf / 0 exact), the backward against
   autograd of the plain version (exact: it is a gather; sink elements 0),
   each run twice with bit-equal outputs; CUDA-event times of kernel, plain
   version and the one-call library form (scatter_add_, plus
   scatter_reduce_ for the maximum; torch.gather for the backward), the
   forward's device span and kernel duration, beside two byte bounds: the
   work the function has (the id and values of each element with a real id,
   the outputs) and every id and value read (the sink's included).
11. Window attention at Swin-T's shapes: one f32 forward of the BEVFusion
   Swin-T camera on a batch-8 ring of 6 x 144 x 256 images records the
   wrapper's inputs at its 7 (stage, shift) shapes (12 blocks; stage 3 runs
   on a 5 x 8 map with the window shrunk to 5). Forward as in phase 4, plus
   the f32 launches' times, the recompute backward's time, and one
   backward through the whole camera trunk: every parameter's gradient is
   finite and non-zero, the shrunk window's only in its table's centre.
12. Training: bench_train, then bench_fusion_train with the conv camera, the
   Swin-T camera in f32 and in bf16, at full width (PillarConfig(),
   CenterPointConfig(), batch 8 x 32768 points x 64 boxes, 6 x 144 x 256
   ring, 24 depth bins, 32 channels), every count reset just before each:
   per step 1 segment_sum_max launch; with a camera 1 segment_sum and 1
   segment_sum_bwd; with Swin-T 12 + 12 window-attention launches. The loss
   is finite and falls on the fixed batch. One step of each is profiled.
13. Training card-against-CPU: the small configurations of the CPU tests
   (CenterPoint; fusion with the conv and a tiny Swin camera) from one state
   dict, 3 steps on both: losses within 1e-3 relative, first-step gradients
   within 1e-3 of each tensor's largest; then detect on both from the same
   weights: the same kept boxes.
14. In a child process with CUBLAS_WORKSPACE_CONFIG set (PyTorch's
   deterministic algorithms want cuBLAS's workspace fixed before a process's
   first matrix product, and with the variable set the host side of every
   matrix product is slower, which the phases above must not feel): at Swin-T's
   shapes a random cotangent through window_attn's autograd.Function against
   autograd through the plain branch, in f32 and bf16: every gradient
   non-zero and equal bit for bit (the backward IS that branch); bench_train
   as it is and under deterministic algorithms (what run_pretrain turns on);
   replay: 4 steps straight against 2 + save + load + 2 on the card, with
   augmentation, EMA, clip and cosine schedule: bit-equal parameters, batch
   statistics, optimizer moments and EMA.

Phases 15-17 run after phase 9, before the training phases.
15. Released weights: full-width Detic Swin-B, SAM ViT-H and CLIP B/32
   from seeded random weights, written as released files (detectron2's
   layout with fc1 in (c, y, x) order, SAM's keys, CLIP's under Detic's
   `text_encoder.` prefix, a gzip BPE file) and loaded by build_real_models
   on the card (load seconds printed): Detic's outputs and SAM's planes on
   a 6 x 1024x576 ring bit-equal to the same modules in memory through
   _batched_model_fns; the CLIP classifier against the CPU within 1e-4;
   one keyframe of run_mask_stage, 24 + 24 window-attention launches.
16. Waymo: 8 frame-lite frames at real geometry fabricated here (a
   64 x 2650 range image ray-cast on the card with a rolling-shutter pose
   image, 5 cameras 3 x 1920x1280 + 2 x 1920x886 as JPEGs, 128 masks a
   keyframe): the frontend on the card against the CPU (points within
   2e-3 m, the rest equal; the 131072-point cap binds); B1 / B2 on a
   batch-8 Waymo step's inputs against their plain versions; the step
   counted (3 + 1 launches) and timed (ms a step, keyframes/s); 2 keyframes
   against the CPU lift (counts, keep sets equal, medoids but for near
   ties); run_lift_waymo counted; run_e2e_waymo on the tiny random-weight
   models; then one thumbnailed ring (3 x 1024x683 + 2 x 1024x473, canvas
   704 x 1024) through the full-width bf16 Detic Swin-B, B3's heads and
   projection held to their plain versions at each of its 8 (stage, shift)
   shapes as in phase 4, 24 + 24 launches a forward; and run_e2e_waymo at
   full width (Swin-B + ViT-H), counted and timed.
17. KITTI: 8 frames at real geometry fabricated here (a 64 x 1900 velodyne
   sweep ray-cast on the card, about 120k points; calib txts of three
   drives with P2's baseline column; image_2 PNGs at KITTI's mixed native
   sizes; label_2 with the boxes; masks on the 1024 x 320 canvas): the
   frontend's calibration chain projected on the card against the CPU and
   the f64 host chain (within 1e-2 px); B1 / B2 on a batch-8 KITTI step's
   inputs against their plain versions (the camera stage at R = 8 rows);
   the step counted (3 + 1 launches) and timed (ms a step, keyframes/s); 2
   keyframes against the CPU lift; run_lift_kitti counted and its pred/
   scored by eval/kitti.py against label_2 (the AP table printed, finite);
   run_e2e_kitti on the tiny models over the mixed sizes (309 and 310 row
   thumbnails on the pinned 1024 x 320 canvas); B3 held to its plain version
   at the KITTI frame's 8 shapes of a full-width Detic forward as in phase 4
   and run_e2e_kitti at full width (Swin-B + ViT-H, unfused SAM), 24 + 24
   launches a keyframe, counted and timed; one KITTI frame encoded with
   SAM's windowed blocks fused against unfused (within ENCODE_AB_TOL, 28 +
   28 launches) and B4 held to its plain version at that grid as in phase 7.
18. Data parallelism at world size 1 (one card: NCCL refuses two ranks on
   one device), in a child process (`chip_smoke.py --data-parallel-phase`,
   CUBLAS_WORKSPACE_CONFIG set: run_pretrain's deterministic algorithms
   want it before the first matrix product). Every path through its
   group's command broadcast, scatter, gather and collectives: the lift step
   at batch 8 on bench_lift's keyframes and on phase 16 / 17's fabricated
   Waymo and KITTI frames (outputs equal to the plain step's, 3 + 1
   launches, ms a step with and without the group in turns);
   run_lift_waymo / run_lift_kitti with data_parallel=1 (the .bin and the
   label txts byte-equal to the plain run's, 3 + 1 launches); run_pretrain
   at bench_train's width (PillarConfig(), CenterPointConfig(), batch 8 x
   32768 points x 64 boxes, a fabricated LIDAR_TOP dataroot) for 3 steps
   with and without data_parallel=1 (losses within 1e-3 relative,
   parameters reported: see DP_TRAJECTORY_RTOL; 1 segment_sum_max launch a
   step); run_detect with data_parallel=1 (the same kept boxes); on
   bench_train's batch the first step's loss (within 1e-5) and gradients
   (within 1e-3 in norm: the global BatchNorm's two-pass statistics against
   cuDNN's) through the group against the plain step's from the same
   weights, then a training step with and without the group, in turns. The card's name and
   power limit beside the times.
19. Deploy and serve (deploy_serve_phase): the op dispatch's host cost a
   compaction call (through the op against its CUDA implementation called
   directly, in turns); the lift step exported at LiftStageConfig(), batch
   8, on the card, saved and loaded (bytes, export and load seconds): tracing
   launches nothing, a call of the loaded program launches 3 + 1 and is
   bit-equal (every leaf of LiftOutputs and BoxOutputs) to the in-process
   step on bench_lift's keyframes, ms a step of both in turns; the same for
   WAYMO_LIFT and KITTI_LIFT on phase 16 / 17's batches against
   make_keyframe_step_fn(preset); /v1/lift over localhost with buckets 1
   and 8, 16 keyframes at a concurrency of 8, every response equal to the
   in-process step's slot, each device call 3 + 1 launches (keyframes/s,
   latency p50 / p99); the detect step exported at the defaults (batch 4,
   32768 points, top_k 128) with seeded weights as inputs, CenterPoint and
   BEVFusion-lite with the conv and the Swin-T camera: the program holds no
   parameter, each call equal to make_detect_fn's with 1 segment_sum_max (+ 1
   segment_sum with a camera, + 12 + 12 window attention with Swin-T);
   /v1/detect with 16 clouds likewise; conform --fake_weights --skip_eval on
   the port's nuScenes fixture, tests/torch_nusc_fixture.py (exit 0, its
   report, e2e on the card launching the compaction and the medoid).
   Each line beside the card's name and power limit; the phase's seconds.
20. int8 and ZoeDepth (quant_zoe_phase; `chip_smoke.py --quant-zoe-phase`
   runs it alone): dynamic_int8_matmul / static_int8_matmul at ViT-H's four
   layer shapes (4096 tokens, bf16), the card's rows bit-equal to the CPU
   path's, ms of torch._int_mm alone, of each op and of F.linear in bf16,
   the kernels an op queues; full-width Detic and SAM built once, their
   int8 twins from the same weights; a ViT-H encode in bf16, int8 and int8
   static (calibrated in place on another camera), ms a camera in turns,
   the int8 embeddings within the JAX package's envelopes (rel < 0.1, corr
   > 0.995; static rel < 0.15, corr > 0.99); Detic Swin-B bf16 and with
   int8 MLPs, B3 counted from 0 (24 + 24 launches a forward), the
   detections in tests/test_quant.py's envelope, ms a forward;
   bench_mask_stage bf16 / int8 / int8 static and bench_e2e bf16 / int8
   (the int8 models built by the benches' quant_int8 / quant_static;
   launches checked as in phase 8) in turns, keyframes/s, the first ring's
   calibration seconds; ZoeDepth ZOE_N with flip averaging on the six
   1024x576 cameras (ms a camera), run_mask_stage with use_zoedepth on the
   full-width models and cameras (keyframes/s, the [M, 576, 1024] f32
   payload read back, finite, its bytes a frame), ZOE_TEST card vs CPU on
   depth maps and payloads, with the cell where they differ most.
21. GroundingDINO (gdino_phase; `chip_smoke.py --gdino-phase` runs it
   alone): a full-size GDINO_SWINT released-layout file
   (synth_gdino_state_dict, seeded) and a fabricated 30,522-line vocab.txt
   loaded through attach_gdino on the card (seconds); B3 held to its plain
   version at the 8 (stage, shift) shapes of a chunk's Swin-T forward (3 x
   800x1216, f32 capture, bf16 and f32 launches, phase 4's tolerances), with
   times and bounds; 24 + 24 B3 launches a six-camera keyframe in f32, bf16
   and int8; int8 against f32 (the Swin-T maps within rel 0.1, as many
   detections); ms a chunk forward (events) and a keyframe (host
   clock, letterbox included), f32 and bf16 in turns; the host letterbox's
   ms and upload; MSDeformAttn's and BiAttention's device ms a chunk and
   the profiler's top kernels; one image card vs CPU in f32 with TF32 off
   (gdino_cpu_check); bench_mask_stage with GroundingDINO and with Detic in
   turns (SAM ViT-H bf16, io 0, 24 + 24 launches a keyframe checked).
22. Model parallelism at world size 1 (one card: NCCL refuses two ranks on
   one device), in a child process (`chip_smoke.py --model-parallel-phase`):
   the camera-parallel mask stage with camera_mesh=1 over NCCL at full width
   (Detic Swin-B + SAM ViT-H bf16, six 1024x576 cameras): a keyframe equal
   to the plain one, the decode's planes on 6 x 25 prompts bit-equal, 24 +
   24 B3 launches a Detic forward through the group, bench_mask_stage
   keyframes/s with and without the group in turns; `e2e --camera_mesh 1`
   on tests/torch_nusc_fixture.py (the plain submission, 3 + 1 lift
   launches a step); ViT-H bf16, its int8 twin and the fused variant
   through shard_model_params and the sequence-sharded encode on a model
   group of one (each against the plain encode, 28 + 28 B4 launches fused,
   ms an encode in turns); one all-reduce's ms over the one-rank group;
   GPipe over CLIP B/32's 12 text blocks at S = 1, M = 4 (forward and
   gradients against the sequential apply, ms a step in turns).
23. The benchmark entry, in a child process (`chip_smoke.py
   --bench-entry-phase`): `python -m cm3d_tpu_torch.bench` once for each
   stage (lift, masks, e2e, masks with the rect encode and ViT-L, train,
   fusion_train conv and Swin-T bf16; the default run is phase 3's), each
   in its own process: exit 0 and exactly one stdout line, JSON, naming
   the stage's metric with a finite positive value; `--stage lfit` and
   `--stage lift --rect_encode` refused with the JAX entry's message and
   no stdout; `--stage e2e --profile fast` through the entry in the
   phase's own process (its one line: four points, boxes kept invariant),
   every count set to 0 just before each point and read just after (3 B1
   + 1 B2 a lift step, 24 + 24 B3 a Detic forward, no B4); the A16 geometry
   helpers card vs CPU and `medoid_index` on a lift step's compacted rows
   against the plain index (one B2 launch a call); SAM ViT-H / L / B bf16,
   the rect encode's embedding against the square one's and ms an encode
   of each in turns.
24. One JSON line per kernel summary, then the card's name and power limit,
   then the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the cm3d_tpu package. Without a CUDA device,
or without the cm3d_tpu_torch package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PEAK_BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
WA_BF16_TOL = 2.0 ** -5  # window attention, bf16 kernel vs f32 plain, x max|plain|
WA_F32_TOL = 1e-4  # window attention, f32 kernel vs f32 plain, x max|plain|
SWIN_BLOCKS_PER_FORWARD = 24  # Swin-B depths (2, 2, 18, 2)
SAM_WINDOWED_BLOCKS = 28  # ViT-H: 32 blocks, 4 of them global
SAM_GLOBAL_BLOCKS = 4
# fused vs unfused ViT-H embeddings in bf16, x max|unfused|: each of the 28
# fused branches rounds at other places than the unfused block (about 2^-8
# relative a value), and the differences add up through the 32 blocks
ENCODE_AB_TOL = 2.0 ** -4
BOX_ATOL = 1e-3  # mask-path CPU check: box corners, image px
LOGIT_EPS = 1e-3  # mask-path CPU check: bits this close to 0 may flip
# f32 operations per unordered pair {i, j} of valid points of the medoid
# sums (d(i, j) and d(j, i) are the same bits, so the function needs each
# once): 3 sub, 3 mul, 2 add, sqrt, and an add into each of the two sums
MEDOID_OPS_PER_PAIR = 11
STAGES = ("camera", "union", "mask")
N_CAMERAS = 6  # nuScenes ring
REPS = 20
SPIN_CYCLES = 5_000_000  # device_span_ms's first spin, about 2.5-3 ms
SPIN_TRIES = 5
SWIN_T_BLOCKS = 12  # Swin-T depths (2, 2, 6, 2)
TRAIN_BATCH = 8
TRAIN_IMAGE_HW = (144, 256)
TRAIN_LOSS_RTOL = 1e-3  # training card vs CPU: loss of each of 3 steps
TRAIN_GRAD_TOL = 1e-3  # first-step gradients, x the tensor's largest |gradient|
DETERMINISTIC_FLAG = "--deterministic-phases"  # the child process of phase 14
KERNEL_TIMES_FLAG = "--kernel-times"  # kernel_times alone
HOST_BENCHES_FLAG = "--host-benches"  # host_benches alone
DETERMINISTIC_WORKSPACE = ":4096:8"  # what deterministic cuBLAS asks for


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Mean device time of fn over `reps` back-to-back calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_span_ms(torch, fn, reps: int = REPS) -> float:
    """Mean device span of fn over `reps` back-to-back calls (CUDA events
    from the first call's first kernel to the last call's end, the gaps
    between a call's kernels included), after one warm-up call. A spin
    kernel holds the card while the host queues every call, so the host's
    time between calls does not count; the spin doubles until the start
    event is still pending when the last call has been queued."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError(f"check failed: a spin of {cycles // 2} cycles ended before the host had "
                       f"queued {reps} calls")


def capture_kernel_inputs(torch, step, frames):
    """Run one lift step, recording the inputs each kernel wrapper gets."""
    import cm3d_tpu_torch.ops.lift as lift_ops

    compactions, medoids = [], []
    real_compact, real_medoid = lift_ops.compact_rows, lift_ops.masked_medoid_rows

    def compact_spy(sel, values, limit):
        compactions.append((sel.clone(), values.clone(), limit))
        return real_compact(sel, values, limit)

    def medoid_spy(rows, valid):
        medoids.append((rows.contiguous().clone(), valid.clone()))
        return real_medoid(rows, valid)

    lift_ops.compact_rows, lift_ops.masked_medoid_rows = compact_spy, medoid_spy
    try:
        step(frames)
    finally:
        lift_ops.compact_rows, lift_ops.masked_medoid_rows = real_compact, real_medoid
    torch.cuda.synchronize()
    check(len(compactions) == 3 and len(medoids) == 1,
          f"one step makes 3 compactions and 1 medoid call, saw "
          f"{len(compactions)} and {len(medoids)}")
    return compactions, medoids[0]


def compaction_phase(torch, compactions):
    from cm3d_tpu_torch.kernels.compact import compact_rows, compact_rows_plain

    stages = []
    for name, (sel, values, limit) in zip(STAGES, compactions):
        r, d, s = values.shape
        got = compact_rows(sel, values, limit)
        again = compact_rows(sel, values, limit)
        want = compact_rows_plain(sel, values, limit)
        torch.cuda.synchronize()
        exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
        diff = (got.view(torch.int32).to(torch.int64) - want.view(torch.int32).to(torch.int64))
        max_err = float(diff.abs().max()) if diff.numel() else 0.0
        check(exact, f"compaction {name} stage bit-exact vs plain")
        check(torch.equal(again.view(torch.int32), got.view(torch.int32)),
              f"compaction {name} stage: a second call gives the same bits")
        kept = int(sel.sum(1).clamp(max=limit).sum())
        # bytes the function must move: the selection mask, the kept
        # sources' D words, and the [R, D, L] output
        n_bytes = r * s + kept * d * 4 + r * d * limit * 4
        ms = time_ms(torch, lambda: compact_rows(sel, values, limit))
        span_ms = device_span_ms(torch, lambda: compact_rows(sel, values, limit))
        plain_ms = time_ms(torch, lambda: compact_rows_plain(sel, values, limit))
        stages.append({
            "stage": name, "rows": r, "sources": s, "words": d, "limit": limit,
            "selected": int(sel.sum()), "kept": kept, "max_abs_err": max_err,
            "sectors_read": sectors_read(torch, sel, limit),
            "ms": ms, "device_span_ms": span_ms, "plain_ms": plain_ms,
            "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
        })
        print(f"compaction {name}: R={r} S={s} D={d} L={limit} kept {kept} bit-exact, "
              f"equal bits twice; kernel {ms:.4f} ms, device span {span_ms:.4f} ms; plain "
              f"{plain_ms:.4f} ms bound {stages[-1]['bound_ms']:.4f} ms; value sectors "
              f"holding a kept source {stages[-1]['sectors_read']:.4f}", flush=True)
    # the kernels' durations after every stage's events: once torch.profiler
    # has run in a process, each launch costs the host more
    for stage, (sel, values, limit) in zip(stages, compactions):
        prof = profiled_kernels(torch, lambda: compact_rows(sel, values, limit))
        stage["kernels_ms"] = kernels_ms(prof)
        stage["split_ms"] = by_launcher_kernel(prof)
        print(f"compaction {stage['stage']}: kernels {_ms_text(stage['kernels_ms'])} = "
              f"{_split_text(stage['split_ms'])}", flush=True)
    return stages


def sectors_read(torch, sel, limit: int) -> float:
    """The share of the values' 32-byte sectors (8 sources of a word) that
    hold a kept source: what the scatter reads, beside the kept words that
    the bound counts."""
    kept = sel & (torch.cumsum(sel.to(torch.int32), 1) <= limit)
    r, s = kept.shape
    return float(kept[:, : s // 8 * 8].reshape(r, -1, 8).any(-1).float().mean())


def medoid_phase(torch, rows, valid):
    from cm3d_tpu_torch.kernels.medoid import (
        medoid_distance_sums,
        medoid_distance_sums_rows,
        medoid_distance_sums_rows_plain,
    )

    r, _, k = rows.shape
    got = medoid_distance_sums_rows(rows, valid)
    want = medoid_distance_sums_rows_plain(rows, valid)
    got_kn3 = medoid_distance_sums(rows.transpose(1, 2).contiguous(), valid)
    again = medoid_distance_sums_rows(rows, valid)
    torch.cuda.synchronize()
    check(torch.equal(got_kn3, got), "[R, K, 3] layout wrapper equals the D-major kernel")
    check(torch.equal(again, got), "medoid sums: a second call gives the same bits")
    g, w = got[valid], want[valid]
    max_err = float((g - w).abs().max()) if g.numel() else 0.0
    rel = float(((g - w).abs() / w.abs().clamp(min=1e-30)).max()) if g.numel() else 0.0
    check(rel <= 1e-5, f"medoid sums within rtol 1e-5 of plain (worst {rel:.3g})")

    inf = torch.tensor(float("inf"), device=rows.device)
    masked_g = torch.where(valid, got, inf)
    masked_w = torch.where(valid, want, inf)
    counts = valid.sum(1)
    two = torch.topk(masked_w, 2, dim=1, largest=False).values
    near_tie = (counts > 1) & ((two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs())
    idx_equal = torch.argmin(masked_g, 1) == torch.argmin(masked_w, 1)
    has = counts > 0
    check(bool((idx_equal | near_tie | ~has).all()),
          "medoid argmin equal wherever the two smallest sums differ by > 1e-5 rel")
    pairs = int((counts.to(torch.int64) ** 2).sum())
    unordered = (pairs - int(counts.sum())) // 2
    points = rows.detach().transpose(1, 2).contiguous()
    # the [R, K, 3] entry (TPU kernel medoid_pallas.py:89): a transpose, then
    # the same kernel; off the main path
    kn3_ms = time_ms(torch, lambda: medoid_distance_sums(points, valid))
    kn3_plain_ms = time_ms(torch, lambda: medoid_distance_sums_rows_plain(
        points.transpose(1, 2), valid), reps=1)
    ms = time_ms(torch, lambda: medoid_distance_sums_rows(rows, valid))
    plain_ms = time_ms(torch, lambda: medoid_distance_sums_rows_plain(rows, valid), reps=3)
    # torch.cdist's exact mode refuses the whole [1024, 2048, 2048] launch
    # ("invalid configuration argument"), so the yardstick runs in row
    # chunks of at most 2^30 (i, j) pairs (all K x K pairs, unmasked)
    chunk = max(1, 2**30 // (k * k))
    library_ms = time_ms(torch, lambda: [torch.cdist(
        points[i:i + chunk], points[i:i + chunk],
        compute_mode="donot_use_mm_for_euclid_dist").sum(-1)
        for i in range(0, r, chunk)], reps=1)
    ops_ms = unordered * MEDOID_OPS_PER_PAIR / PEAK_F32_OPS_PER_S * 1e3
    bytes_ms = (r * k * (3 * 4 + 1 + 4)) / PEAK_BYTES_PER_S * 1e3
    out = {
        "rows": r, "k": k, "pairs": pairs, "unordered_pairs": unordered,
        "near_tie_rows": int(near_tie.sum()),
        "rows_with_points": int(has.sum()), "max_abs_err": max_err, "max_rel_err": rel,
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "kn3_ms": kn3_ms, "kn3_plain_ms": kn3_plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "near_tie": near_tie,
    }
    print(f"medoid: R={r} K={k} pairs={pairs} max rel err {rel:.3g} "
          f"near-tie rows {out['near_tie_rows']} kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms cdist {library_ms:.4f} ms bound {out['bound_ms']:.4f} ms; "
          f"[R, K, 3] entry {kn3_ms:.4f} ms, its plain version {kn3_plain_ms:.4f} ms",
          flush=True)
    return out


def profile_phase(torch, step, n_steps: int = 3) -> None:
    """Device time of `step()` by kernel (torch.profiler) and the device's
    busy share of the wall time, over `n_steps` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    # device-side entries only (kernels, memcpy, memset): the host-side aten
    # ops that launched them report the same device time again
    busy = sorted(
        ((e.device_time_total / 1e3 / n_steps, e.count // n_steps, e.key)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    busy_ms = sum(b[0] for b in busy)
    if not busy:
        print("profile: the profiler recorded no device time (busy share not measured)",
              flush=True)
        return
    print(f"profile over {n_steps} steps: wall {wall_ms:.3f} ms/step, device busy "
          f"{busy_ms:.3f} ms/step ({100 * busy_ms / wall_ms:.1f}%), "
          f"{sum(b[1] for b in busy)} device kernels/step", flush=True)
    for ms, calls, name in busy[:15]:
        print(f"  {ms:8.4f} ms  x{calls:<4d} {name[:90]}", flush=True)


# the kernels a launcher call queues, by a part of their names: window
# attention, then the compaction's two
LAUNCHER_KERNELS = ("ln_stats_kernel", "ln_rows_kernel", "qkv_gemm_kernel", "window_attn_core",
                    "relpos_attn_kernel", "proj_gemm_kernel", "compact_count_kernel",
                    "compact_scatter_kernel")
GEMM_TILE_M = 128  # the bf16 GEMM's output tile rows (csrc/window_attn_common.cuh)


def gemm_tile_n(m: int, n: int, sms: int) -> int:
    """The bf16 GEMM's tile width at [m, k] x [k, n], as
    csrc/window_attn_common.cuh tile_width picks it."""
    tiles256 = -(-m // GEMM_TILE_M) * (n // 256)
    return 256 if n % 256 == 0 and n >= 3 * 256 and tiles256 >= 2 * sms else 128


def profiled_kernels(torch, fn, reps: int = 5) -> dict:
    """{kernel name: (device ms, launches)} of the kernels that `reps` calls
    of fn queue (torch.profiler, after a warm-up call), over the launches
    the profiler recorded, which late in a long process are not always all
    of them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count}


def kernels_ms(prof: dict) -> float | None:
    """A call's kernel time on the device, launch gaps left out: the sum of
    each kernel's mean duration (a call launches each kernel once). None
    when the profiler recorded no kernel."""
    return sum(ms / n for ms, n in prof.values()) if prof else None


def by_launcher_kernel(prof: dict) -> dict:
    """Mean device ms a launch of each LAUNCHER_KERNELS kernel in prof."""
    total, count = {}, {}
    for key, (ms, n) in prof.items():
        part = next((k for k in LAUNCHER_KERNELS if k in key), None)
        if part:
            total[part] = total.get(part, 0.0) + ms
            count[part] = count.get(part, 0) + n
    return {k: total[k] / count[k] for k in total}


def launcher_split(torch, fn, reps: int = 5) -> dict:
    """Device ms a launch of each kernel that a launcher call `fn()` queues,
    by LAUNCHER_KERNELS name. Empty when the profiler records none."""
    return by_launcher_kernel(profiled_kernels(torch, fn, reps))


def _ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _split_text(split: dict) -> str:
    return " + ".join(f"{k} {v:.4f}" for k, v in split.items()) or "not measured"


def gemm_record(torch, x, ln_w, ln_b, wqkv_b, bqkv, o, wproj_b, bproj, *, window: int,
                shift: int, eps: float, heads_split: dict, proj_split: dict) -> dict:
    """The bf16 GEMM at one block's shapes: each kernel's device time (from
    the launchers' profiler splits), its TFLOP/s over the real rows, its
    tiles and waves over the card's SMs, and one F.linear call on the same
    operands as a yardstick the port never calls: for qkv on round_bf16(LN(x))
    in window order (the rows the GEMM reads), for the projection on o."""
    from cm3d_tpu_torch.kernels.window_attn import window_ln_rows_plain

    bf16 = torch.bfloat16
    c = x.shape[-1]
    m, tokens = o.shape[0], x.numel() // c
    lnx = window_ln_rows_plain(x, ln_w, ln_b, window=window, shift=shift, eps=eps).to(bf16)
    bq, bp = bqkv.to(bf16), bproj.to(bf16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rec = {}
    for name, a, w, bias, ms in (("qkv", lnx, wqkv_b, bq, heads_split.get("qkv_gemm_kernel")),
                                 ("proj", o, wproj_b, bp, proj_split.get("proj_gemm_kernel"))):
        n = w.shape[0]
        linear_ms = time_ms(torch, lambda: torch.nn.functional.linear(a, w, bias))
        tile_n = gemm_tile_n(m, n, sms)
        tiles = -(-m // GEMM_TILE_M) * -(-n // tile_n)
        flop = 2 * tokens * c * n
        nbytes = (m * c + n * c + m * n) * 2
        rec[name] = {"m": m, "n": n, "k": c, "kernel_ms": ms, "linear_yardstick_ms": linear_ms,
                     "vs_linear": ms / linear_ms if ms else None,
                     "tflops_real_rows": flop / ms / 1e9 if ms else None,
                     "tile": [GEMM_TILE_M, tile_n], "tiles": tiles, "waves": tiles / sms,
                     "bound_ms": max(flop / PEAK_BF16_OPS_PER_S, nbytes / PEAK_BYTES_PER_S) * 1e3}
    del lnx
    return rec


def _gemm_text(rec: dict) -> str:
    def one(name):
        r = rec[name]
        if not r["kernel_ms"]:
            return f"{name} not measured"
        return (f"{name} [{r['m']}x{r['k']}]x[{r['k']}x{r['n']}] {r['kernel_ms']:.4f} ms "
                f"({r['tflops_real_rows']:.1f} TFLOP/s, {r['tiles']} tiles of "
                f"{r['tile'][0]}x{r['tile'][1]} = {r['waves']:.2f} waves, bound "
                f"{r['bound_ms']:.4f}), F.linear {r['linear_yardstick_ms']:.4f} ms "
                f"(x{r['vs_linear']:.2f})")
    return f"{one('qkv')}; {one('proj')}"


def sass_facts() -> dict:
    """From `cuobjdump -sass` of the two window-attention libraries: per
    GEMM kernel instance (compute type, tile width), its count of HGMMA
    (wgmma), UTMALDG (TMA loads) and HMMA (mma.sync) instructions."""
    from cm3d_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = {}
    for lib in ("window_attn", "window_attn_relpos"):
        sass = subprocess.run([tool, "-sass", str(build._lib_path(lib)[0])], capture_output=True,
                              text=True, check=True, timeout=120).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split("\n", 1)[0].strip()
            kind = next((k for k in ("qkv_gemm_kernel", "proj_gemm_kernel") if k in name), None)
            if kind:
                dtype = "bf16" if "nv_bfloat16" in name else "f32"
                width = re.search(r"Li(\d+)E", name)  # the tile width, a template argument
                key = f"{lib}:{kind}:{dtype}" + (f":{width.group(1)}" if width else "")
                out[key] = {"HGMMA": block.count("HGMMA"), "UTMALDG": block.count("UTMALDG"),
                            "HMMA": block.count("HMMA")}
    return out


def attn_kernel_record(ms, sdpa_ms: float, *, tokens: int, rows: int, c: int, n: int,
                       two: int = 0) -> dict:
    """The attention kernel of a heads launcher alone, `ms` from the
    launcher's split: its bound is q k^T and p v over n keys (and, for
    SAM, the two table products over 2 win - 1 entries) a real token, against
    qkv [rows, 3C] read once and o [rows, C] written once, in bf16."""
    ops_ms = tokens * (4 * n * c + 4 * two * c) / PEAK_BF16_OPS_PER_S * 1e3
    bytes_ms = rows * 4 * c * 2 / PEAK_BYTES_PER_S * 1e3
    return {"ms": ms, "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "sdpa_yardstick_ms": sdpa_ms}


def _attn_text(a: dict) -> str:
    ms = f"{a['ms']:.4f} ms" if a["ms"] else "not measured"
    return (f"attention kernel {ms} (bound {a['bound_ms']:.4f} by {a['bound_by']}), "
            f"SDPA {a['sdpa_yardstick_ms']:.4f} ms")


def sdpa_yardstick_ms(torch, qkv, table, x_shape, heads: int, window: int, shift: int) -> float:
    """The attention of the heads launcher as one
    scaled_dot_product_attention call on the same q / k / v (window order,
    the compute type) with the table bias and the shift mask as its additive
    mask. A yardstick only: the port never calls it."""
    from cm3d_tpu_torch.kernels.window_attn import padded_hw, rel_pos_index, shift_attn_mask

    b, h, w, c = x_shape
    hd, n = c // heads, window * window
    hp, wp = padded_hw(h, w, window)
    q, k, v = (t.contiguous() for t in
               qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4))
    idx = torch.as_tensor(rel_pos_index(window), device=qkv.device).reshape(-1)
    mask = table.float()[idx].reshape(n, n, heads).permute(2, 0, 1)[None]
    if shift:
        sm = torch.as_tensor(shift_attn_mask(hp, wp, window, shift), device=qkv.device)
        mask = (mask[None] + sm[None, :, None]).expand(b, -1, -1, -1, -1).reshape(-1, heads, n, n)
    mask = mask.to(q.dtype).contiguous()
    return time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=hd ** -0.5))


def relpos_sdpa_yardstick_ms(torch, qkv, rel_h, rel_w, heads: int, window: int) -> float:
    """The attention of the rel-pos heads launcher as one
    scaled_dot_product_attention call on the same q / k / v (window order,
    the compute type), the decomposed bias q . rel_h + q . rel_w
    materialised as its float mask. A yardstick only: the port never calls
    it."""
    from cm3d_tpu_torch.kernels.window_attn_relpos import rel_index

    n, c = window * window, qkv.shape[1] // 3
    hd = c // heads
    q, k, v = (t.contiguous() for t in qkv.reshape(-1, n, 3, heads, hd).permute(2, 0, 3, 1, 4))
    idx_h, idx_w = (torch.as_tensor(i, device=qkv.device).expand(*q.shape[:2], n, n)
                    for i in rel_index(window))
    ph = (q @ rel_h.to(q.dtype).T).float()  # [windows, heads, n, 2w-1]
    pw = (q @ rel_w.to(q.dtype).T).float()
    mask = (torch.gather(ph, -1, idx_h) + torch.gather(pw, -1, idx_w)).to(q.dtype).contiguous()
    del ph, pw
    return time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=hd ** -0.5))


def capture_window_attn_inputs(torch, forward, n_blocks=SWIN_BLOCKS_PER_FORWARD, n_shapes=8):
    """Run one Swin forward (`forward()`), recording the window-attention
    wrapper's inputs at the first block of each distinct (C, shift) and how
    many blocks of the forward run at each."""
    import cm3d_tpu_torch.models.swin as swin

    shapes, mult = {}, {}
    real = swin.window_attn

    def spy(x, *params, heads, window, shift, dtype):
        key = (x.shape[-1], shift)
        mult[key] = mult.get(key, 0) + 1
        if key not in shapes:
            shapes[key] = (x.clone(), tuple(p.detach().clone() for p in params),
                           dict(heads=heads, window=window, shift=shift, dtype=dtype))
        return real(x, *params, heads=heads, window=window, shift=shift, dtype=dtype)

    swin.window_attn = spy
    try:
        forward()
    finally:
        swin.window_attn = real
    torch.cuda.synchronize()
    check(sum(mult.values()) == n_blocks,
          f"one Swin forward runs {n_blocks} blocks, saw {sum(mult.values())}")
    check(len(shapes) == n_shapes, f"{n_shapes} distinct (stage, shift) shapes, saw "
          f"{sorted(shapes)}")
    return [(key, shapes[key], mult[key]) for key in sorted(shapes)]


def window_attn_phase(torch, captured, model_dtype=None, time_f32: bool = False):
    """Both launches against their plain versions at each captured shape,
    bf16 and f32, and the bf16 launches' times beside the bound.
    `model_dtype` is the compute type the capturing forward ran in (bf16
    unless given); `time_f32` also times the f32 launches."""
    from cm3d_tpu_torch.kernels.window_attn import (
        EPS,
        window_attn_heads,
        window_attn_heads_plain,
        window_attn_plain,
        window_attn_proj,
        window_attn_proj_plain,
        window_attn_qkv_plain,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    model_dtype = model_dtype or bf16
    out = []
    for (c, shift), (x, (g, b, wqkv, bqkv, wproj, bproj, table), kw), mult in captured:
        heads, win = kw["heads"], kw["window"]
        check(kw["dtype"] == model_dtype, f"the capturing forward computes in {model_dtype}")
        bsz, h, w, _ = x.shape
        geo = dict(heads=heads, window=win, shift=shift)
        # weights as the kernels read them (bf16 qkv / proj, f32 rest)
        wqkv_b, wproj_b = wqkv.to(bf16), wproj.to(bf16)
        heads_args = (x, g, b, wqkv_b, bqkv, table)
        # bf16 kernels against the f32 plain version on the same bf16-rounded
        # inputs and weights
        r_qkv, r_proj = wqkv.to(bf16).float(), wproj.to(bf16).float()
        ref_args = (x.float(), g, b, r_qkv, bqkv, table)
        o = window_attn_heads(*heads_args, dtype=bf16, **geo)
        got = window_attn_proj(o, wproj_b, bproj, out_shape=tuple(x.shape), dtype=bf16, **geo)
        o_ref = window_attn_heads_plain(*ref_args, dtype=f32, **geo)
        ref = window_attn_proj_plain(o.float(), r_proj, bproj, out_shape=tuple(x.shape),
                                     window=win, shift=shift, dtype=f32)
        full_ref = window_attn_plain(x.float(), g, b, r_qkv, bqkv, r_proj, bproj, table,
                                     dtype=f32, **geo)
        torch.cuda.synchronize()
        errs = {}
        for name, gv, rv in (("heads", o, o_ref), ("proj", got, ref), ("branch", got, full_ref)):
            err = float((gv.float() - rv).abs().max())
            scale = float(rv.abs().max())
            errs[name] = (err, err / scale)
            check(err <= WA_BF16_TOL * scale, f"window attention C={c} shift={shift} "
                  f"{name}: bf16 kernel vs f32 plain {err:.3g} > 2^-5 x {scale:.3g}")
        # f32 kernels against the f32 plain version
        xf = x.float()
        got32 = window_attn_proj(window_attn_heads(xf, g, b, wqkv, bqkv, table, dtype=f32, **geo),
                                 wproj, bproj, out_shape=tuple(x.shape), dtype=f32, **geo)
        ref32 = window_attn_plain(xf, g, b, wqkv, bqkv, wproj, bproj, table, dtype=f32, **geo)
        torch.cuda.synchronize()
        err32 = float((got32 - ref32).abs().max())
        check(err32 <= WA_F32_TOL * float(ref32.abs().max()),
              f"window attention C={c} shift={shift}: f32 kernel vs plain {err32:.3g}")
        # times (CUDA events) and bounds of the bf16 launches
        ms_h = time_ms(torch, lambda: window_attn_heads(*heads_args, dtype=bf16, **geo))
        ms_p = time_ms(torch, lambda: window_attn_proj(o, wproj_b, bproj,
                                                       out_shape=tuple(x.shape), dtype=bf16, **geo))
        plain_h = time_ms(torch, lambda: window_attn_heads_plain(*heads_args, dtype=bf16, **geo),
                          reps=5)
        plain_p = time_ms(torch, lambda: window_attn_proj_plain(
            o, wproj_b, bproj, out_shape=tuple(x.shape), window=win, shift=shift, dtype=bf16),
            reps=5)
        # the heads launcher's three kernels; yardsticks (never called by the
        # port): one SDPA call on the same q / k / v with bias + mask, and
        # F.linear on the window-ordered o (no scatter)
        split = launcher_split(torch, lambda: window_attn_heads(*heads_args, dtype=bf16, **geo))
        qkv = window_attn_qkv_plain(x, g, b, wqkv_b, bqkv, window=win, shift=shift, dtype=bf16)
        sdpa_ms = sdpa_yardstick_ms(torch, qkv, table, tuple(x.shape), heads, win, shift)
        del qkv
        # the bf16 GEMM alone, both entries, beside F.linear on the same operands
        proj_split = launcher_split(torch, lambda: window_attn_proj(
            o, wproj_b, bproj, out_shape=tuple(x.shape), dtype=bf16, **geo))
        gemm = gemm_record(torch, x, g, b, wqkv_b, bqkv, o, wproj_b, bproj, window=win,
                           shift=shift, eps=EPS, heads_split=split, proj_split=proj_split)
        linear_ms = gemm["proj"]["linear_yardstick_ms"]
        # the work the branch needs, counted on the real tokens: a padding
        # token's output is cropped, and its k / v are the bare biases (its
        # LN output is 0), so neither needs a product. o ([tokens, C] bf16)
        # is written by the first launch and read by the second.
        tokens = bsz * h * w
        n = win * win
        ops_h = tokens * (2 * 3 * c * c + 4 * n * c)
        bytes_h = x.numel() * x.element_size() + 3 * c * c * 2 + tokens * c * 2
        ops_p = tokens * 2 * c * c
        bytes_p = tokens * c * 2 + c * c * 2 + tokens * c * 2
        rec = {
            "channels": c, "shift": shift, "shape": list(x.shape),
            "x_dtype": str(x.dtype).replace("torch.", ""), "num_heads": heads, "window": win,
            "blocks_per_forward": mult, "max_abs_err": errs["branch"][0],
            "max_rel_err": errs["branch"][1], "f32_max_abs_err": err32,
            "gflop": (ops_h + ops_p) / 1e9,
            # the qkv scratch: written by the GEMM, read by the attention
            "qkv_scratch_bytes": o.shape[0] * 3 * c * 2,
            "qkv_scratch_ms": 2 * o.shape[0] * 3 * c * 2 / PEAK_BYTES_PER_S * 1e3,
        }
        for name, ms, plain, ops, nbytes in (("heads", ms_h, plain_h, ops_h, bytes_h),
                                              ("proj", ms_p, plain_p, ops_p, bytes_p)):
            ops_ms = ops / PEAK_BF16_OPS_PER_S * 1e3
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            rec[name] = {"ms": ms, "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
                         "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                         "max_abs_err": errs[name][0], "max_rel_err": errs[name][1]}
        rec["heads"]["split_ms"] = split
        rec["heads"]["sdpa_yardstick_ms"] = sdpa_ms
        rec["heads"]["attn"] = attn_kernel_record(split.get("window_attn_core"), sdpa_ms,
                                                  tokens=tokens, rows=o.shape[0], c=c, n=n)
        rec["proj"]["linear_yardstick_ms"] = linear_ms
        rec["gemm"] = gemm
        if time_f32:
            # the f32 launches (SIMT, no tensor cores): f32 words, f32 peak
            o32 = window_attn_heads(xf, g, b, wqkv, bqkv, table, dtype=f32, **geo)
            f_h = time_ms(torch, lambda: window_attn_heads(xf, g, b, wqkv, bqkv, table,
                                                           dtype=f32, **geo), reps=5)
            f_p = time_ms(torch, lambda: window_attn_proj(o32, wproj, bproj,
                                                          out_shape=tuple(x.shape), dtype=f32,
                                                          **geo), reps=5)
            fp_h = time_ms(torch, lambda: window_attn_heads_plain(xf, g, b, wqkv, bqkv, table,
                                                                  dtype=f32, **geo), reps=5)
            fp_p = time_ms(torch, lambda: window_attn_proj_plain(
                o32, wproj, bproj, out_shape=tuple(x.shape), window=win, shift=shift,
                dtype=f32), reps=5)
            split32 = launcher_split(torch, lambda: window_attn_heads(
                xf, g, b, wqkv, bqkv, table, dtype=f32, **geo))
            bytes_h32 = x.numel() * 4 + 3 * c * c * 4 + tokens * c * 4
            for name, ms, plain, ops, nbytes in (("heads", f_h, fp_h, ops_h, bytes_h32),
                                                  ("proj", f_p, fp_p, ops_p, 2 * bytes_p)):
                ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
                bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
                rec[f"{name}_f32"] = {"ms": ms, "plain_ms": plain,
                                      "bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms,
                                      "bytes_ms": bytes_ms, "max_abs_err": err32}
            rec["heads_f32"]["split_ms"] = split32
            print(f"  f32 launches: heads {f_h:.4f} ms ({_split_text(split32)}) + proj "
                  f"{f_p:.4f} ms, plain {fp_h:.4f} + {fp_p:.4f} ms, bound "
                  f"{rec['heads_f32']['bound_ms']:.4f} + {rec['proj_f32']['bound_ms']:.4f} ms",
                  flush=True)
        out.append(rec)
        print(f"window attention C={c} shift {shift} {list(x.shape)} h{heads}: "
              f"bf16 rel err {errs['branch'][1]:.3g} (heads {errs['heads'][1]:.3g}, proj "
              f"{errs['proj'][1]:.3g}), f32 abs err {err32:.3g}; heads {ms_h:.4f} ms + proj "
              f"{ms_p:.4f} ms, plain {plain_h:.4f} + {plain_p:.4f} ms, bound "
              f"{rec['heads']['bound_ms']:.4f} + {rec['proj']['bound_ms']:.4f} ms; heads split "
              f"{_split_text(split)}; yardsticks SDPA {sdpa_ms:.4f} ms, F.linear "
              f"{linear_ms:.4f} ms", flush=True)
        print(f"  {_attn_text(rec['heads']['attn'])}", flush=True)
        print(f"  bf16 GEMM: {_gemm_text(gemm)}", flush=True)
    return out


def mask_stage_phase(torch, models, n_frames: int = 8):
    """bench_mask_stage at production geometry with the window-attention
    counts reset just before each run; each Detic forward must launch each
    kernel once per Swin block."""
    from cm3d_tpu_torch.benchmarks import bench_mask_stage
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj

    forwards = [0]
    raw = models.detic

    def counted(frame):
        forwards[0] += 1
        return raw(frame)

    models = dataclasses.replace(models, detic=counted)
    results = []
    for io_sleep in (0.15, 0.0):
        forwards[0] = 0
        window_attn_heads.launches = 0
        window_attn_proj.launches = 0
        bench = bench_mask_stage("bfloat16", n_frames=n_frames, models=models,
                                 io_sleep=io_sleep, device="cuda")
        launches = {"window_attn_heads": window_attn_heads.launches,
                    "window_attn_proj": window_attn_proj.launches}
        bench["detic_forwards"] = forwards[0]
        bench["launches"] = launches
        print(json.dumps(bench), flush=True)
        for name, count in launches.items():
            check(count == SWIN_BLOCKS_PER_FORWARD * forwards[0],
                  f"{name}: {SWIN_BLOCKS_PER_FORWARD} launches per Detic forward x "
                  f"{forwards[0]} forwards, got {count}")
        results.append(bench)
    return results


def mask_cpu_check(torch, device="cuda"):
    """One small 6-camera keyframe through generate_frame_masks on the card
    (f32, TF32 off) and on the CPU, from the same seeded weights."""
    import torch.nn.functional as F

    import cm3d_tpu_torch.ops.maskpack as maskpack
    from cm3d_tpu_torch.config import MaskStageConfig
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
    from cm3d_tpu_torch.models.sam import SAM_TEST, Sam
    from cm3d_tpu_torch.pipelines.masks import _batched_model_fns, generate_frame_masks
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES as VOCAB

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(0)
    detic = init_weights(Detic(DETIC_TEST), gen)
    sam = init_weights(Sam(SAM_TEST), gen)
    rng = np.random.default_rng(0)
    clf = rng.standard_normal((DETIC_TEST.embed_dim, len(VOCAB))).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    images = [(rng.random((48, 64, 3)) * 255).astype(np.uint8) for _ in range(6)]

    def run(device):
        dets, logits = [], []
        real_make = maskpack.make_plane_postprocess

        def make(*args, **kw):
            post = real_make(*args, **kw)

            def wrapped(lg, n_boxes, **kw):
                logits.append(lg.float().cpu())
                return post(lg, n_boxes, **kw)
            return wrapped

        maskpack.make_plane_postprocess = make
        try:
            models = _batched_model_fns(copy.deepcopy(detic), clf, copy.deepcopy(sam), VOCAB,
                                        device=device)
        finally:
            maskpack.make_plane_postprocess = real_make
        raw = models.detic

        def spy(frame):
            out = raw(frame)
            dets.append([t.cpu() for t in out])
            return out

        models = dataclasses.replace(models, detic=spy)
        fm = generate_frame_masks(models, images, MaskStageConfig(dtype="float32"))
        return fm, dets[0], logits[0]

    fm_g, det_g, lg_g = run(device)
    fm_c, det_c, lg_c = run("cpu")
    (bg, _, cg, vg), (bc, _, cc, vc) = det_g, det_c
    check(torch.equal(vg, vc), "valid flags equal, card vs CPU")
    check(torch.equal(cg[vc], cc[vc]), "class ids equal, card vs CPU")
    box_err = float((bg[vc] - bc[vc]).abs().max()) if bool(vc.any()) else 0.0
    check(box_err <= BOX_ATOL, f"boxes within {BOX_ATOL} px, card vs CPU (worst {box_err:.3g})")
    check(fm_g.labels == fm_c.labels and fm_g.cam_nums == fm_c.cam_nums,
          "mask labels and cameras equal, card vs CPU")
    m = len(fm_c.labels)
    check(m > 0, "the random-weight keyframe yields masks to compare")
    # bits whose upsampled CPU logit lies within LOGIT_EPS of 0 may flip
    near = np.zeros(fm_c.masks.shape, bool)
    cams = np.asarray(fm_c.cam_nums)
    offset = 0
    for cam, im in enumerate(images):
        k = int((cams == cam).sum())
        if k:
            h, w = im.shape[:2]
            side = max(h, w)
            up = F.interpolate(lg_c[cam, :k, None], size=(side, side), mode="bilinear",
                               align_corners=False)[:, 0, :h, :w]
            near[offset:offset + k, :w, :h] = (up.abs() < LOGIT_EPS).numpy().transpose(0, 2, 1)
        offset += k
    diff = fm_g.masks != fm_c.masks
    check(not (diff & ~near).any(), f"planes bit-equal away from logits within {LOGIT_EPS} "
          f"of 0 ({int((diff & ~near).sum())} bits differ there)")
    n_dec = min(lg_g.shape[1], lg_c.shape[1])
    logit_err = float((lg_g[:, :n_dec] - lg_c[:, :n_dec]).abs().max())
    print(f"mask-path CPU check: {int(vc.sum())} detections, {m} masks, box err "
          f"{box_err:.3g} px, logit err {logit_err:.3g}, {int(diff.sum())} of "
          f"{diff.size} bits differ ({int(near.sum())} bits near 0), "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"detections": int(vc.sum()), "masks": m, "box_err": box_err,
            "logit_err": logit_err, "bits_differ": int(diff.sum())}


def capture_relpos_inputs(torch, models, frame, n_cameras: int = N_CAMERAS):
    """Run one SAM encode of the ring, recording the rel-pos wrapper's
    inputs at the first windowed block and how many blocks call it."""
    import cm3d_tpu_torch.models.sam as sam

    seen, calls = [], [0]
    real = sam.window_attn_relpos

    def spy(x, *params, **kw):
        calls[0] += 1
        if not seen:
            seen.append((x.clone(), tuple(p.detach().clone() for p in params), dict(kw)))
        return real(x, *params, **kw)

    sam.window_attn_relpos = spy
    try:
        models.sam_encode(frame)
    finally:
        sam.window_attn_relpos = real
    torch.cuda.synchronize()
    check(calls[0] == SAM_WINDOWED_BLOCKS * n_cameras,
          f"one ring encode runs {SAM_WINDOWED_BLOCKS} windowed blocks x {n_cameras} cameras "
          f"through the fused kernels, saw {calls[0]}")
    return seen[0]


def relpos_check(torch, x, params, kw, name: str):
    """The rel-pos kernels (heads, then the shared projection) at x's grid:
    bf16 against the f32 plain version on the same bf16-rounded inputs,
    weights and tables (<= 2^-5 of max|plain|), f32 against the f32 plain
    version (<= 1e-4 of it). Returns (the bf16 heads' output, {part:
    (abs err, rel err)}, the f32 abs err)."""
    from cm3d_tpu_torch.kernels.window_attn import window_attn_proj_plain
    from cm3d_tpu_torch.kernels.window_attn_relpos import (
        window_attn_relpos_heads,
        window_attn_relpos_heads_plain,
        window_attn_relpos_plain,
        window_attn_relpos_proj,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w = params
    heads, win = kw["heads"], kw["window"]
    geo = dict(heads=heads, window=win, eps=kw["eps"])
    shape = tuple(x.shape)
    wqkv_b, wproj_b = wqkv.to(bf16), wproj.to(bf16)
    r_qkv, r_proj = wqkv_b.float(), wproj_b.float()
    r_h, r_w = rel_h.to(bf16).float(), rel_w.to(bf16).float()
    o = window_attn_relpos_heads(x, g, b, wqkv_b, bqkv, rel_h, rel_w, dtype=bf16, **geo)
    got = window_attn_relpos_proj(o, wproj_b, bproj, out_shape=shape, heads=heads,
                                  window=win, dtype=bf16)
    o_ref = window_attn_relpos_heads_plain(x.float(), g, b, r_qkv, bqkv, r_h, r_w,
                                           dtype=f32, **geo)
    ref = window_attn_proj_plain(o.float(), r_proj, bproj, out_shape=shape, window=win,
                                 shift=0, dtype=f32)
    full_ref = window_attn_relpos_plain(x.float(), g, b, r_qkv, bqkv, r_proj, bproj, r_h,
                                        r_w, dtype=f32, **geo)
    torch.cuda.synchronize()
    errs = {}
    for part, gv, rv in (("heads", o, o_ref), ("proj", got, ref), ("branch", got, full_ref)):
        err = float((gv.float() - rv).abs().max())
        scale = float(rv.abs().max())
        errs[part] = (err, err / scale)
        check(err <= WA_BF16_TOL * scale, f"rel-pos window attention {name} {part}: bf16 "
              f"kernel vs f32 plain {err:.3g} > 2^-5 x {scale:.3g}")
    del o_ref, ref, full_ref
    xf = x.float()
    o32 = window_attn_relpos_heads(xf, g, b, wqkv.float(), bqkv, rel_h, rel_w, dtype=f32, **geo)
    got32 = window_attn_relpos_proj(o32, wproj.float(), bproj, out_shape=shape, heads=heads,
                                    window=win, dtype=f32)
    ref32 = window_attn_relpos_plain(xf, g, b, wqkv.float(), bqkv, wproj.float(), bproj,
                                     rel_h, rel_w, dtype=f32, **geo)
    torch.cuda.synchronize()
    err32 = float((got32 - ref32).abs().max())
    check(err32 <= WA_F32_TOL * float(ref32.abs().max()),
          f"rel-pos window attention {name}: f32 kernel vs plain {err32:.3g}")
    return o, errs, err32


def relpos_phase(torch, captured):
    """The rel-pos kernels against their plain version at the square grid
    the encode gave them and at its top 36 rows (the rect-encode grid)."""
    from cm3d_tpu_torch.kernels.window_attn_relpos import (
        window_attn_relpos_heads,
        window_attn_relpos_heads_plain,
        window_attn_relpos_proj,
    )
    from cm3d_tpu_torch.kernels.window_attn import window_attn_proj_plain, window_attn_qkv

    bf16 = torch.bfloat16
    x_sq, params, kw = captured
    g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w = params
    heads, win, eps = kw["heads"], kw["window"], kw["eps"]
    check(kw["dtype"] == bf16, "the ViT-H encode computes in bf16")
    check(tuple(x_sq.shape) == (1, 64, 64, 1280), f"square ViT-H grid, got {tuple(x_sq.shape)}")
    geo = dict(heads=heads, window=win, eps=eps)
    out = []
    for name, x in (("square", x_sq), ("rect", x_sq[:, :36].contiguous())):
        bsz, h, w, c = x.shape
        shape = tuple(x.shape)
        wqkv_b, wproj_b = wqkv.to(bf16), wproj.to(bf16)
        o, errs, err32 = relpos_check(torch, x, params, kw, name)
        # times (CUDA events) and bounds of the bf16 launches
        ms_h = time_ms(torch, lambda: window_attn_relpos_heads(
            x, g, b, wqkv_b, bqkv, rel_h, rel_w, dtype=bf16, **geo))
        ms_p = time_ms(torch, lambda: window_attn_relpos_proj(
            o, wproj_b, bproj, out_shape=shape, heads=heads, window=win, dtype=bf16))
        plain_h = time_ms(torch, lambda: window_attn_relpos_heads_plain(
            x, g, b, wqkv_b, bqkv, rel_h, rel_w, dtype=bf16, **geo), reps=5)
        plain_p = time_ms(torch, lambda: window_attn_proj_plain(
            o, wproj_b, bproj, out_shape=shape, window=win, shift=0, dtype=bf16), reps=5)
        split = launcher_split(torch, lambda: window_attn_relpos_heads(
            x, g, b, wqkv_b, bqkv, rel_h, rel_w, dtype=bf16, **geo))
        proj_split = launcher_split(torch, lambda: window_attn_relpos_proj(
            o, wproj_b, bproj, out_shape=shape, heads=heads, window=win, dtype=bf16))
        gemm = gemm_record(torch, x, g, b, wqkv_b, bqkv, o, wproj_b, bproj, window=win, shift=0,
                           eps=eps, heads_split=split, proj_split=proj_split)
        linear_ms = gemm["proj"]["linear_yardstick_ms"]
        # yardstick for the attention kernel (never called by the port): one
        # SDPA call on the same q / k / v with the decomposed rel-pos bias
        # materialised as its float mask
        qkv = window_attn_qkv(x, g, b, wqkv_b, bqkv, window=win, shift=0, dtype=bf16, eps=eps)
        sdpa_ms = relpos_sdpa_yardstick_ms(torch, qkv, rel_h, rel_w, heads, win)
        del qkv
        # the work the branch needs, counted on the real tokens (a padding
        # token's output is cropped and its k / v are the bare biases): qkv,
        # scores and p v over n keys, the two table products; then proj
        tokens, n, two = bsz * h * w, win * win, 2 * win - 1
        ops_h = tokens * (6 * c * c + 4 * n * c + 4 * two * c)
        bytes_h = (x.numel() * x.element_size() + 3 * c * c * 2 + 2 * two * (c // heads) * 2
                   + tokens * c * 2)
        ops_p = tokens * 2 * c * c
        bytes_p = tokens * c * 2 + c * c * 2 + tokens * c * 2
        rec = {"grid": name, "shape": list(shape), "x_dtype": str(x.dtype).replace("torch.", ""),
               "num_heads": heads, "window": win, "eps": eps,
               "max_abs_err": errs["branch"][0], "max_rel_err": errs["branch"][1],
               "f32_max_abs_err": err32, "gflop": (ops_h + ops_p) / 1e9}
        for part, ms, plain, ops, nbytes in (("heads", ms_h, plain_h, ops_h, bytes_h),
                                              ("proj", ms_p, plain_p, ops_p, bytes_p)):
            ops_ms = ops / PEAK_BF16_OPS_PER_S * 1e3
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            rec[part] = {"ms": ms, "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
                         "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                         "max_abs_err": errs[part][0], "max_rel_err": errs[part][1]}
        rec["heads"]["split_ms"] = split
        rec["heads"]["sdpa_yardstick_ms"] = sdpa_ms
        rec["heads"]["attn"] = attn_kernel_record(split.get("relpos_attn_kernel"), sdpa_ms,
                                                  tokens=tokens, rows=o.shape[0], c=c, n=n,
                                                  two=two)
        rec["proj"]["linear_yardstick_ms"] = linear_ms
        rec["gemm"] = gemm
        out.append(rec)
        print(f"rel-pos window attention {name} {list(shape)} h{heads} win {win}: bf16 rel err "
              f"{errs['branch'][1]:.3g} (heads {errs['heads'][1]:.3g}, proj "
              f"{errs['proj'][1]:.3g}), f32 abs err {err32:.3g}; heads {ms_h:.4f} ms + proj "
              f"{ms_p:.4f} ms, plain {plain_h:.4f} + {plain_p:.4f} ms, bound "
              f"{rec['heads']['bound_ms']:.4f} + {rec['proj']['bound_ms']:.4f} ms; heads split "
              f"{_split_text(split)}; yardsticks SDPA {sdpa_ms:.4f} ms, F.linear "
              f"{linear_ms:.4f} ms", flush=True)
        print(f"  {_attn_text(rec['heads']['attn'])}", flush=True)
        print(f"  bf16 GEMM: {_gemm_text(gemm)}", flush=True)
    return out


SAM_GLOBAL_ATTN_FLAG = "--sam-global-attn-phase"  # phase 7's global-block part alone
# the global blocks' shapes: (name, query rows, grid columns, heads, head dim,
# rows of the h table as the checkpoint stores it)
SAM_GLOBAL_SHAPES = (("vit_h_square", 64, 64, 16, 80, 127), ("vit_b_rect", 36, 64, 12, 64, 127))


def sam_global_attn_phase(torch, seed: int = 0):
    """The global blocks' flash kernel (kernels/sam_global_attn.py) at ViT-H's
    square and ViT-B's rect grid, one camera, bf16: its error against a
    float64 computation no larger than the plain chain's, one launch a call;
    CUDA-event times of the kernel, the plain chain and, as a yardstick the
    port never calls, one scaled_dot_product_attention call with the
    decomposed bias materialised as its float mask, beside the bound
    (operations at the bf16 peak or q, k, v, o bytes, the larger)."""
    from cm3d_tpu_torch.kernels.sam_global_attn import sam_global_attn
    from cm3d_tpu_torch.ops.relpos_attn import relpos_attention, resize_rel_pos

    bf16, dev = torch.bfloat16, torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    out = []
    for name, gh, gw, heads, hd, rows_h in SAM_GLOBAL_SHAPES:
        n, c = gh * gw, heads * hd
        qkv = (1.5 * torch.randn(1, n, 3, heads, hd, generator=g)).to(dev, bf16)
        q, k, v = qkv.unbind(2)
        rel_h = (0.5 * torch.randn(rows_h, hd, generator=g)).to(dev, bf16)
        rel_w = (0.5 * torch.randn(2 * gw - 1, hd, generator=g)).to(dev, bf16)
        kw = dict(q_hw=(gh, gw), k_hw=(gh, gw))
        th, tw = resize_rel_pos(rel_h, 2 * gh - 1), resize_rel_pos(rel_w, 2 * gw - 1)
        with torch.no_grad():
            before = sam_global_attn.launches
            got = sam_global_attn(q, k, v, rel_h, rel_w, **kw)
            torch.cuda.synchronize()
            check(sam_global_attn.launches == before + 1, "one sam_global_attn launch a call")
            chain = relpos_attention(q, k, v, th, tw, **kw)
            # float64: scores, the bias from the same tables, softmax, p v
            qd, kd, vd = q.double(), k.double(), v.double()
            s = torch.einsum("bqhc,bkhc->bhqk", qd, kd) * hd ** -0.5
            i = torch.arange(n, device=dev)
            ih = ((i // gw)[:, None] - (i // gw)[None] + gh - 1).expand(1, heads, n, n)
            iw = ((i % gw)[:, None] - (i % gw)[None] + gw - 1).expand(1, heads, n, n)
            bias = (torch.gather(torch.einsum("bqhc,uc->bhqu", qd, th.double()), -1, ih)
                    + torch.gather(torch.einsum("bqhc,uc->bhqu", qd, tw.double()), -1, iw))
            want = torch.einsum("bhqk,bkhc->bqhc", torch.softmax(s + bias, -1), vd).reshape(
                1, n, c)
            del s
            top = float(want.abs().max())
            err = float((got.double() - want).abs().max()) / top
            err_chain = float((chain.double() - want).abs().max()) / top
            check(err <= err_chain, f"{name}: the kernel's error {err:.3g} is no larger than "
                                    f"the plain chain's {err_chain:.3g}")
            mask = bias.to(bf16)
            del bias, want, chain, qd, kd, vd
            # on the resized tables, as the chain: the resize is the wrapper's, outside the op
            ms = time_ms(torch, lambda: sam_global_attn(q, k, v, th, tw, **kw))
            plain = time_ms(torch, lambda: relpos_attention(q, k, v, th, tw, **kw), reps=5)
            qh_, kh_, vh_ = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
            sdpa = time_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                qh_, kh_, vh_, attn_mask=mask, scale=hd ** -0.5), reps=5)
            del mask, qh_, kh_, vh_
        ops = 4 * n * n * c + 2 * n * c * (gh + gw)
        ops_ms = ops / PEAK_BF16_OPS_PER_S * 1e3
        bytes_ms = 4 * n * c * 2 / PEAK_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        rec = {"shape": name, "grid": [gh, gw], "heads": heads, "head_dim": hd, "ms": ms,
               "plain_ms": plain, "sdpa_yardstick_ms": sdpa, "bound_ms": bound,
               "ops_ms": ops_ms, "bytes_ms": bytes_ms, "roofline_pct": 100 * bound / ms,
               "rel_err": err, "chain_rel_err": err_chain}
        out.append(rec)
        print(f"SAM global attention {name} {gh}x{gw} h{heads} hd{hd}: kernel {ms:.4f} ms "
              f"(bound {bound:.4f}, {rec['roofline_pct']:.1f}%), plain chain {plain:.4f} ms, "
              f"SDPA + float mask {sdpa:.4f} ms; rel err {err:.3g} (chain {err_chain:.3g})",
              flush=True)
    return out


def encode_ab_phase(torch, unfused, fused, frame):
    """One 6-camera ViT-H encode, unfused and fused (the same weights), in
    turns: ms per camera and the difference of the embeddings."""
    emb_u = unfused.sam_encode(frame).float()
    emb_f = fused.sam_encode(frame).float()
    torch.cuda.synchronize()
    diff = (emb_f - emb_u).abs()
    scale = float(emb_u.abs().max())
    rec = {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
           "max_abs_unfused": scale, "tolerance": ENCODE_AB_TOL * scale}
    check(bool(torch.isfinite(emb_f).all()), "fused embeddings finite")
    check(rec["max_abs_diff"] <= rec["tolerance"], f"fused vs unfused ViT-H embeddings differ by "
          f"{rec['max_abs_diff']:.3g} > 2^-4 x {scale:.3g}")
    del emb_u, emb_f, diff
    times = {"unfused": [], "fused": []}
    for name, models in (("unfused", unfused), ("fused", fused), ("fused", fused),
                         ("unfused", unfused)):
        times[name].append(time_ms(torch, lambda: models.sam_encode(frame), reps=2) / N_CAMERAS)
    rec["unfused_ms_per_camera"] = times["unfused"]
    rec["fused_ms_per_camera"] = times["fused"]
    print(f"ViT-H encode (bf16, square 1024, per camera of a 6-camera ring): unfused "
          f"{times['unfused']} ms, fused {times['fused']} ms; embeddings differ by at most "
          f"{rec['max_abs_diff']:.4g} (mean {rec['mean_abs_diff']:.4g}) of max "
          f"{scale:.4g}, tolerance {rec['tolerance']:.4g}", flush=True)
    return rec


def e2e_phase(torch, models, fused: bool, n_frames: int = 12, batch_size: int = 4,
              label: str = "bf16", quant_int8: bool = False):
    """bench_e2e with every launch count set to 0 just before it and read
    just after; the counts must fit the keyframes, Detic forwards and lift
    steps the run made. `label` names the models in the printed line.
    `models` None: bench_e2e builds them (`quant_int8`), and the Detic
    forwards are read from B3's launches."""
    from cm3d_tpu_torch.benchmarks import bench_e2e
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.kernels.sam_global_attn import sam_global_attn
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.kernels.window_attn_relpos import (
        window_attn_relpos_heads,
        window_attn_relpos_proj,
    )

    wrappers = (compact_rows, medoid_distance_sums_rows, window_attn_heads, window_attn_proj,
                window_attn_relpos_heads, window_attn_relpos_proj, sam_global_attn)
    forwards = [0]
    built = models is None
    if not built:
        raw = models.detic

        def counted(frame):
            forwards[0] += 1
            return raw(frame)

        models = dataclasses.replace(models, detic=counted)
    for wr in wrappers:
        wr.launches = 0
    bench = bench_e2e("bfloat16", n_frames=n_frames, batch_size=batch_size, models=models,
                      device="cuda", quant_int8=quant_int8)
    launches = {wr.__name__: wr.launches for wr in wrappers}
    if built:
        check(bench["quant_int8"] is quant_int8, f"bench_e2e built quant_int8={quant_int8}")
        forwards[0] = launches["window_attn_heads"] // SWIN_BLOCKS_PER_FORWARD
    frames = batch_size + n_frames  # the warm-up run, then the timed one
    steps = 1 + -(-n_frames // batch_size)
    bench.update(fused_window_attn=fused, keyframes=frames, detic_forwards=forwards[0],
                 lift_steps=steps, launches=launches, models=label)
    print(json.dumps(bench), flush=True)
    check(forwards[0] == frames and bench["n_frames"] == n_frames,
          f"{frames} keyframes, one Detic forward each, saw {forwards[0]}")
    check(bench["boxes_kept"] > 0, "the fused path delivers boxes")
    relpos = SAM_WINDOWED_BLOCKS * N_CAMERAS * frames if fused else 0
    want = {"compact_rows": 3 * steps, "medoid_distance_sums_rows": steps,
            "window_attn_heads": SWIN_BLOCKS_PER_FORWARD * frames,
            "window_attn_proj": SWIN_BLOCKS_PER_FORWARD * frames,
            "window_attn_relpos_heads": relpos, "window_attn_relpos_proj": relpos,
            # ViT-H's global blocks, one camera a call, fused or not
            "sam_global_attn": SAM_GLOBAL_BLOCKS * N_CAMERAS * frames}
    for name, count in launches.items():
        check(count == want[name], f"bench_e2e ({'fused' if fused else 'unfused'}) {name}: "
              f"expected {want[name]} launches over {frames} keyframes and {steps} lift steps, "
              f"got {count}")
    return bench


def e2e_cpu_check(torch, n_frames: int = 4, batch_size: int = 2):
    """run_fused at DETIC_TEST / SAM_TEST with the fused blocks (f32, TF32
    off) over a few synthetic keyframes, on the card and on the CPU."""
    from cm3d_tpu_torch.config import CLASS_TO_ID, LiftStageConfig, MaskStageConfig
    from cm3d_tpu_torch.datasets.nuscenes.frontend import get_detection_name
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.kernels.window_attn_relpos import window_attn_relpos_heads
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.pipelines.e2e import run_fused
    from cm3d_tpu_torch.pipelines.masks import build_fake_models

    t0 = time.perf_counter()
    img_h, img_w = 48, 64
    lift_cfg = LiftStageConfig(max_points=16384, max_masks=32, max_points_per_mask=512,
                               max_points_per_camera=8192, max_points_in_masks=2048,
                               max_lane_points=1024)
    mask_cfg = MaskStageConfig(max_detections=16, max_masks_total=32, dtype="float32")
    rng = np.random.default_rng(0)
    syn = SyntheticConfig(image_w=img_w, image_h=img_h, points_per_frame=12000,
                          objects_per_frame=12, focal=50.0)
    bases = [make_keyframe(syn, lift_cfg, rng) for _ in range(n_frames)]
    rings = [[(rng.random((img_h, img_w, 3)) * 255).astype(np.uint8) for _ in range(N_CAMERAS)]
             for _ in range(n_frames)]

    def source():
        for i in range(n_frames):
            def assemble(handle, i=i):
                if handle["planes"] is None:
                    return None
                m = lift_cfg.max_masks
                cam, label = np.zeros(m, np.int32), np.zeros(m, np.int32)
                score, valid = np.zeros(m, np.float32), np.zeros(m, bool)
                for j, name in enumerate(handle["labels"][:m]):
                    name = get_detection_name(name)
                    if name in CLASS_TO_ID:
                        cam[j], label[j] = handle["cams"][j], CLASS_TO_ID[name]
                        score[j], valid[j] = handle["scores"][j], True
                return bases[i]._replace(mask_bits=handle["planes"], mask_cam=cam,
                                         mask_label=label, mask_score=score,
                                         mask_valid=valid), i
            yield rings[i], assemble

    def run(device):
        models = build_fake_models(device=device, fused_window_attn=True)
        real_step = make_keyframe_step_fn(lift_cfg, device=device)
        lifts, boxes = [], {}

        def step(batch):
            lift, bx = real_step(batch)
            lifts.append((lift.point_counts.cpu(), lift.has_points.cpu(), lift.centroids.cpu()))
            return lift, bx

        n = run_fused(models, step, source(), mask_cfg, lambda tok, b: boxes.update({tok: b}),
                      batch_size, device=device)
        counts, has, cent = (torch.cat(parts) for parts in zip(*lifts))
        return n, counts, has, cent, boxes

    before = window_attn_relpos_heads.launches
    n_g, counts_g, has_g, cent_g, boxes_g = run("cuda")
    check(window_attn_relpos_heads.launches > before,
          "the card run goes through the rel-pos kernel")
    n_c, counts_c, has_c, cent_c, boxes_c = run("cpu")
    check(n_g == n_c == n_frames, f"{n_frames} keyframes lifted on both, got {n_g} and {n_c}")
    check(torch.equal(counts_g, counts_c) and torch.equal(has_g, has_c),
          "per-mask point counts equal, card vs CPU")
    check(int(has_c.sum()) > 0, "masks lift to points")
    # a medoid may flip where its two smallest distance sums tie in f32
    close = torch.isclose(cent_g, cent_c, rtol=0.0, atol=1e-4).all(-1)
    n_diff = int((~close & has_c).sum())
    check(n_diff <= max(1, int(has_c.sum()) // 100),
          f"centroids within 1e-4 m of the CPU path but for medoid ties ({n_diff} differ)")
    n_keep = 0
    for tok in range(n_frames):
        bg, bc = boxes_g[tok], boxes_c[tok]
        check(np.array_equal(bg.keep, bc.keep), f"keep flags equal, keyframe {tok}")
        check(np.array_equal(bg.labels[bc.keep], bc.labels[bc.keep]),
              f"labels equal, keyframe {tok}")
        n_keep += int(bc.keep.sum())
    check(n_keep > 0, "boxes survive")
    print(f"fused-path CPU check: {n_frames} keyframes, {int(has_c.sum())} masks with points, "
          f"{n_keep} boxes kept, {n_diff} centroids differ, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"keyframes": n_frames, "masks_with_points": int(has_c.sum()), "boxes_kept": n_keep,
            "centroids_differ": n_diff}


def ring_extrinsics(batch_size: int) -> np.ndarray:
    """[B, 6, 4, 4] cam_to_ego of six cameras looking outward every 60
    degrees, 1.5 m up: camera z (forward) -> a horizontal ego direction,
    camera x (right) -> its right, camera y (down) -> ego -z."""
    exts = np.zeros((N_CAMERAS, 4, 4), np.float32)
    for i in range(N_CAMERAS):
        a = 2 * np.pi * i / N_CAMERAS
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([np.sin(a), -np.cos(a), 0.0])
        exts[i, :3, 0], exts[i, :3, 1], exts[i, :3, 2] = right, [0.0, 0.0, -1.0], fwd
        exts[i, :3, 3] = [0.5 * np.cos(a), 0.5 * np.sin(a), 1.5]
        exts[i, 3, 3] = 1.0
    return np.tile(exts, (batch_size, 1, 1, 1))


def capture_segment_inputs(torch):
    """One real batch-8 pillarize and the batch-8 lift-splat pooling of a
    full-width conv-camera BevFusionDetector forward (twice: the identity
    extrinsics of bench_fusion_train, then a ring of outward cameras),
    recording what each segment wrapper gets."""
    import cm3d_tpu_torch.train.bevfusion as bevfusion
    import cm3d_tpu_torch.train.voxelize as voxelize
    from cm3d_tpu_torch.benchmarks import fusion_bench_setup

    step, state, batch, cfg = fusion_bench_setup(TRAIN_BATCH, TRAIN_IMAGE_HW, device="cuda")
    pill, splats = [], []
    real_max, real_sum = voxelize.segment_sum_max, bevfusion.segment_sum

    def max_spy(cell, values, maxvals, n_cells):
        pill.append((cell.clone(), values.clone(), maxvals.clone(), n_cells))
        return real_max(cell, values, maxvals, n_cells)

    def sum_spy(cell, values, n_cells):
        splats.append((cell.clone(), values.detach().contiguous().clone(), n_cells))
        return real_sum(cell, values, n_cells)

    voxelize.segment_sum_max, bevfusion.segment_sum = max_spy, sum_spy
    try:
        with torch.no_grad():
            step.loss_fn(batch)
            ring = torch.from_numpy(ring_extrinsics(TRAIN_BATCH)).cuda()
            step.loss_fn(batch._replace(cam_to_ego=ring))
    finally:
        voxelize.segment_sum_max, bevfusion.segment_sum = real_max, real_sum
    torch.cuda.synchronize()
    check(len(pill) == 2 and len(splats) == 2,
          f"a fusion forward makes 1 pillarize and 1 splat reduction, saw {len(pill)} and "
          f"{len(splats)} over two")
    return pill[0], {"bench": splats[0], "ring": splats[1]}


def _run_stats(torch, cell, n_cells):
    real = cell < n_cells
    counts = torch.zeros((cell.shape[0], n_cells + 1), dtype=torch.int64, device=cell.device)
    counts.scatter_add_(1, cell.clamp(max=n_cells).long(), torch.ones_like(cell, dtype=torch.int64))
    counts = counts[:, :n_cells]
    return {"in_range": int(real.sum()), "cells_hit": int((counts > 0).sum()),
            "longest_run": int(counts.max())}


def segment_phase(torch, pill, splats):
    """The segment kernels against their plain versions on captured inputs."""
    from cm3d_tpu_torch.kernels.segment import (
        segment_sum,
        segment_sum_bwd,
        segment_sum_bwd_plain,
        segment_sum_max,
        segment_sum_max_plain,
        segment_sum_plain,
    )

    tol = dict(rtol=1e-5, atol=1e-5)
    ninf = float("-inf")
    out = {}

    # --- sum + max, the pillarize call ---
    cell, values, maxvals, n_cells = pill
    r, d, n = values.shape
    check(bool((cell[:, 1:] >= cell[:, :-1]).all()), "pillarize hands over sorted ids")
    sums, maxs = segment_sum_max(cell, values, maxvals, n_cells)
    again_s, again_m = segment_sum_max(cell, values, maxvals, n_cells)
    want_s, want_m = segment_sum_max_plain(cell, values, maxvals, n_cells)
    torch.cuda.synchronize()
    check(torch.equal(sums, again_s) and torch.equal(maxs, again_m),
          "segment_sum_max twice: bit-equal")
    check(torch.allclose(sums, want_s, **tol), "segment_sum_max sums within rtol 1e-5 / atol "
          f"1e-5 of plain (worst {float((sums - want_s).abs().max()):.3g})")
    check(torch.equal(maxs, want_m), "segment_sum_max maxima equal to plain")
    stats = _run_stats(torch, cell, n_cells)
    empty = want_m == ninf
    check(bool(empty.any()) and bool((maxs[empty] == ninf).all())
          and bool((sums.transpose(1, 2)[empty] == 0).all()), "empty cells give -inf and 0")
    idx = cell.clamp(max=n_cells).long()
    idx3 = idx[:, None, :].expand(r, d, n)

    def library_pair():
        s_ = torch.zeros((r, d, n_cells + 1), device=cell.device).scatter_add_(2, idx3, values)
        m_ = torch.full((r, n_cells + 1), ninf, device=cell.device).scatter_reduce_(
            1, idx, maxvals, "amax", include_self=True)
        return s_, m_

    # two bounds: every id and value read (the sink's included), and the
    # work the function has: the id, values and maximum of each element with
    # a real id (a sink's are never read), the outputs
    n_bytes = cell.numel() * 4 + values.numel() * 4 + maxvals.numel() * 4 \
        + sums.numel() * 4 + maxs.numel() * 4
    work_bytes = stats["in_range"] * (d + 2) * 4 + sums.numel() * 4 + maxs.numel() * 4
    rec = {"rows": r, "n": n, "channels": d, "n_cells": n_cells, **stats,
           "max_abs_err": float((sums - want_s).abs().max()),
           "ms": time_ms(torch, lambda: segment_sum_max(cell, values, maxvals, n_cells)),
           "plain_ms": time_ms(torch, lambda: segment_sum_max_plain(cell, values, maxvals,
                                                                    n_cells)),
           "library_ms": time_ms(torch, library_pair),
           "device_span_ms": device_span_ms(torch, lambda: segment_sum_max(cell, values,
                                                                          maxvals, n_cells)),
           "kernels_ms": kernels_ms(profiled_kernels(
               torch, lambda: segment_sum_max(cell, values, maxvals, n_cells))),
           "bound_ms": work_bytes / PEAK_BYTES_PER_S * 1e3, "bytes": work_bytes,
           "bound_all_values_ms": n_bytes / PEAK_BYTES_PER_S * 1e3, "all_values_bytes": n_bytes}
    out["segment_sum_max"] = rec
    print(f"segment_sum_max (pillarize): R={r} N={n} D={d} cells={n_cells} in range "
          f"{stats['in_range']} cells hit {stats['cells_hit']} longest run "
          f"{stats['longest_run']}; max abs err {rec['max_abs_err']:.3g}, maxima exact, replay "
          f"bit-equal; kernel {rec['ms']:.4f} ms, device span {rec['device_span_ms']:.4f} ms, "
          f"kernels {_ms_text(rec['kernels_ms'])}; plain "
          f"{rec['plain_ms']:.4f} ms scatter_add_ + scatter_reduce_ {rec['library_ms']:.4f} ms "
          f"bound {rec['bound_ms']:.4f} ms by the work, {rec['bound_all_values_ms']:.4f} ms "
          f"reading every value", flush=True)

    # --- sum only, forward and backward, the splat call ---
    for name, (cell, values, n_cells) in splats.items():
        r, d, n = values.shape
        check(bool((cell[:, 1:] >= cell[:, :-1]).all()), "the splat hands over sorted ids")
        stats = _run_stats(torch, cell, n_cells)
        got = segment_sum(cell, values, n_cells)
        again = segment_sum(cell, values, n_cells)
        want = segment_sum_plain(cell, values, n_cells)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"segment_sum ({name}) twice: bit-equal")
        check(stats["in_range"] < cell.numel(), f"segment_sum ({name}): the splat has sink ids")
        # every column is held to rtol 1e-5 / atol 1e-5 of the plain version,
        # and to the error an f32 sum of k terms can have in any order,
        # k 2^-24 sum|v|, of the sum taken in f64 (the sink id h*w is no
        # column: the caller passes n_cells = h*w)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **tol), f"segment_sum ({name}) "
              f"within rtol 1e-5 / atol 1e-5 of plain (worst {err:.3g})")
        exact = segment_sum_plain(cell, values.double(), n_cells)
        mass = segment_sum_plain(cell, values.abs().double(), n_cells)
        count = segment_sum_plain(cell, torch.ones_like(values[:, :1]).double(), n_cells)
        slack = 1e-6 + count * 2.0 ** -24 * mass
        check(bool(((got.double() - exact).abs() <= slack).all()), f"segment_sum ({name}): "
              f"every column within k 2^-24 sum|v| of the f64 sum (worst "
              f"{float(((got.double() - exact).abs() / slack).max()):.3g} of the allowance)")
        del exact, mass, count, slack
        hit = torch.zeros((r, n_cells + 1), dtype=torch.bool, device=cell.device)
        hit.scatter_(1, cell.clamp(max=n_cells).long(), True)
        check(bool((got.transpose(1, 2)[~hit[:, :n_cells]] == 0).all()),
              f"segment_sum ({name}): empty cells give exactly 0")
        # backward: a random cotangent through the Function against autograd
        # through the plain scatter version (a gather on both sides: exact)
        ct = torch.randn(got.shape, device=cell.device,
                         generator=torch.Generator("cuda").manual_seed(0))
        a = values.clone().requires_grad_()
        b = values.clone().requires_grad_()
        (segment_sum(cell, a, n_cells) * ct).sum().backward()
        (segment_sum_plain(cell, b, n_cells) * ct).sum().backward()
        torch.cuda.synchronize()
        check(torch.equal(a.grad, b.grad), f"segment_sum ({name}) backward equals autograd of "
              f"the plain version")
        check(bool((a.grad.transpose(1, 2)[cell >= n_cells] == 0).all()),
              f"segment_sum ({name}) backward: sink ids read 0")
        check(torch.equal(segment_sum_bwd(cell, ct), segment_sum_bwd_plain(cell, ct))
              and torch.equal(segment_sum_bwd(cell, ct), a.grad),
              f"segment_sum_bwd ({name}) equals its plain gather, twice")
        idx3 = cell.clamp(max=n_cells).long()[:, None, :].expand(r, d, n)
        gz = torch.cat([ct, ct.new_zeros((r, d, 1))], dim=2)
        n_bytes = cell.numel() * 4 + values.numel() * 4 + got.numel() * 4
        work_bytes = stats["in_range"] * (d + 1) * 4 + got.numel() * 4
        fwd = {"rows": r, "n": n, "channels": d, "n_cells": n_cells, **stats,
               "max_abs_err": err,
               "ms": time_ms(torch, lambda: segment_sum(cell, values, n_cells)),
               "plain_ms": time_ms(torch, lambda: segment_sum_plain(cell, values, n_cells)),
               "library_ms": time_ms(torch, lambda: torch.zeros(
                   (r, d, n_cells + 1), device=cell.device).scatter_add_(2, idx3, values)),
               "device_span_ms": device_span_ms(torch,
                                                lambda: segment_sum(cell, values, n_cells)),
               "kernels_ms": kernels_ms(profiled_kernels(
                   torch, lambda: segment_sum(cell, values, n_cells))),
               "bound_ms": work_bytes / PEAK_BYTES_PER_S * 1e3, "bytes": work_bytes,
               "bound_all_values_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
               "all_values_bytes": n_bytes}
        bwd = {"rows": r, "n": n, "channels": d, "n_cells": n_cells, "max_abs_err": 0.0,
               "ms": time_ms(torch, lambda: segment_sum_bwd(cell, ct)),
               "plain_ms": time_ms(torch, lambda: segment_sum_bwd_plain(cell, ct)),
               "library_ms": time_ms(torch, lambda: torch.gather(gz, 2, idx3)),
               "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3, "bytes": n_bytes}
        out[f"segment_sum/{name}"] = fwd
        out[f"segment_sum_bwd/{name}"] = bwd
        print(f"segment_sum (splat, {name} extrinsics): R={r} N={n} D={d} cells={n_cells} in "
              f"range {stats['in_range']} cells hit {stats['cells_hit']} longest run "
              f"{stats['longest_run']}; max abs err {err:.3g}, backward exact, replay "
              f"bit-equal; forward kernel {fwd['ms']:.4f} ms, device span "
              f"{fwd['device_span_ms']:.4f} ms, kernels {_ms_text(fwd['kernels_ms'])}; plain "
              f"{fwd['plain_ms']:.4f} ms scatter_add_ {fwd['library_ms']:.4f} ms, bound "
              f"{fwd['bound_ms']:.4f} ms by the work, {fwd['bound_all_values_ms']:.4f} ms "
              f"reading every value; backward kernel {bwd['ms']:.4f} ms plain "
              f"{bwd['plain_ms']:.4f} ms torch.gather {bwd['library_ms']:.4f} ms bound "
              f"{bwd['bound_ms']:.4f} ms", flush=True)
    return out


def kernel_times(torch) -> dict:
    """Timings alone, no checks, of the package beside this script: the three
    compactions of a batch-8 lift step (phase 2's inputs) and the segment
    forward of a batch-8 fusion forward (phase 10's: pillarize, the splat at
    identity and at ring extrinsics), each captured from the package's own
    callers. Per call: CUDA-event ms of back-to-back wrapper calls and the
    device span, all before torch.profiler first runs in the process (after
    it, every launch costs the host more), then the kernels' durations; for
    the compactions also the share of value sectors holding a kept source.
    Two trees compare on one card when this script is copied into the other
    tree's checkout and run there and here in turns, in one call."""
    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
    from cm3d_tpu_torch.kernels import build
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.segment import segment_sum, segment_sum_max
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn

    build.build_all()
    dev = torch.device("cuda")
    cfg = LiftStageConfig()
    rng = np.random.default_rng(0)
    host = stack_keyframes([make_keyframe(SyntheticConfig(), cfg, rng) for _ in range(8)])
    step = make_keyframe_step_fn(cfg, device=dev)
    compactions, _ = capture_kernel_inputs(torch, step, to_device(host.frames, dev))
    pill, splats = capture_segment_inputs(torch)
    calls = {f"compact_rows/{name}": (lambda a=args: compact_rows(*a))
             for name, args in zip(STAGES, compactions)}
    calls["segment_sum_max/pillarize"] = lambda: segment_sum_max(*pill)
    for name, args in splats.items():
        calls[f"segment_sum/{name}"] = lambda a=args: segment_sum(*a)
    out = {"cwd": os.getcwd(), "card": card_line()}
    for name, fn in calls.items():
        out[name] = {"ms": time_ms(torch, fn), "device_span_ms": device_span_ms(torch, fn)}
    for name, (sel, _, limit) in zip(STAGES, compactions):
        out[f"compact_rows/{name}"]["sectors_read"] = sectors_read(torch, sel, limit)
    for name, fn in calls.items():
        out[name]["kernels_ms"] = kernels_ms(profiled_kernels(torch, fn))
        print(name, out[name], flush=True)
    return out


def host_benches(torch) -> dict:
    """Timings alone, no checks, of the package beside this script: the
    host-bound end-to-end benchmarks as phases 3, 12 and 8 run them,
    bench_lift (batch 8, 10 steps) 5 times, bench_train (batch 8, 20 steps)
    3 times and the fused bench_e2e (12 keyframes in batches of 4) twice.
    Two trees compare on one card when this script is copied into the other
    tree's checkout and run there and here in turns, in one call."""
    from cm3d_tpu_torch.benchmarks import (
        _realistic_load,
        bench_e2e,
        bench_lift,
        bench_train,
        build_production_fake_models,
    )
    from cm3d_tpu_torch.kernels import build

    build.build_all()
    out = {"cwd": os.getcwd(), "card": card_line()}
    out["bench_lift"] = [bench_lift(8, 10, device="cuda")["value"] for _ in range(5)]
    out["bench_train"] = [bench_train(TRAIN_BATCH, 20, device="cuda")["value"]
                          for _ in range(3)]
    torch.cuda.empty_cache()
    models = _realistic_load(build_production_fake_models("bfloat16", device="cuda",
                                                          fused_window_attn=True))
    out["bench_e2e_fused"] = [bench_e2e("bfloat16", n_frames=12, batch_size=4, models=models,
                                        device="cuda")["value"] for _ in range(2)]
    return out


def capture_swin_t_inputs(torch):
    """A seed-0 Swin-T camera trunk at full width, a batch-8 ring of images,
    and the window-attention wrapper's inputs at the trunk's 7 shapes."""
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.train.bevfusion import BevFusionConfig, CameraTrunk

    gen = torch.Generator().manual_seed(0)
    trunk = init_weights(CameraTrunk(BevFusionConfig(camera_backbone="swin_t")), gen).cuda()
    ih, iw = TRAIN_IMAGE_HW
    images = torch.rand((TRAIN_BATCH * N_CAMERAS, ih, iw, 3), generator=gen).cuda()
    with torch.no_grad():
        captured = capture_window_attn_inputs(torch, lambda: trunk(images),
                                              n_blocks=SWIN_T_BLOCKS, n_shapes=7)
    return trunk, images, captured


def swin_t_phase(torch):
    """Window attention at the shapes of the BEVFusion Swin-T camera: the
    forward as phase 4 holds it, the times of a forward and of the recompute
    backward, then one backward through the whole trunk."""
    from cm3d_tpu_torch.kernels.window_attn import window_attn

    trunk, images, captured = capture_swin_t_inputs(torch)
    shapes = window_attn_phase(torch, captured, model_dtype=torch.float32, time_f32=True)
    for rec, ((c, shift), (x, params, kw), _) in zip(shapes, captured):
        def fwd_bwd(grad: bool):
            leaves = [t.clone().requires_grad_(grad) for t in (x,) + params]
            out = window_attn(*leaves, **kw)
            if grad:
                out.backward(torch.ones_like(out))

        both = time_ms(torch, lambda: fwd_bwd(True), reps=5)
        fwd = time_ms(torch, lambda: fwd_bwd(False), reps=5)
        rec["f32_forward_ms"], rec["f32_recompute_backward_ms"] = fwd, both - fwd
        if rec["window"] < 7:  # the shrunk window reads the table's centre only
            check(kw["window"] == 5, "stage 3 runs on a 5 x 8 map with window 5")
        print(f"window attention C={c} shift {shift} {list(x.shape)} window {kw['window']}: "
              f"f32 forward {fwd:.4f} ms, recompute backward {both - fwd:.4f} ms", flush=True)
    # the full table of a shrunk block gets its gradient in the centre only
    blk = trunk.swin.layers[3].blocks[0]
    feats, depth = trunk(images[:N_CAMERAS])
    (feats.sum() + (depth * depth).sum()).backward()
    tg = blk.attn.relative_position_bias_table.grad.reshape(13, 13, -1)
    outside = tg.clone()
    outside[2:11, 2:11] = 0
    check(float(tg[2:11, 2:11].abs().sum()) > 0 and float(outside.abs().sum()) == 0,
          "a window shrunk to 5 moves only the centre 9 x 9 of its 13 x 13 bias table")
    for name, p in trunk.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
              f"Swin-T camera: finite gradient for {name}")
    dead = [n for n, p in trunk.named_parameters() if float(p.grad.abs().sum()) == 0]
    check(not dead, f"Swin-T camera on the card: parameters without gradient: {dead[:6]}")
    print(f"Swin-T camera trunk on the card: all {len(list(trunk.parameters()))} parameters "
          f"get a non-zero gradient through the fused kernels", flush=True)
    return shapes


def swin_t_gradient_phase(torch):
    """Gradients through window_attn's autograd.Function at Swin-T's shapes
    against autograd through the plain branch, under deterministic
    algorithms: non-zero and equal bit for bit, f32 and bf16."""
    from cm3d_tpu_torch.kernels.window_attn import window_attn, window_attn_plain
    from cm3d_tpu_torch.pipelines.pretrain import deterministic_training

    _, _, captured = capture_swin_t_inputs(torch)
    names = ("x", "ln_weight", "ln_bias", "wqkv", "bqkv", "wproj", "bproj", "table")
    out = []
    with deterministic_training():
        for (c, shift), (x, params, kw), _ in captured:
            for dtype in (torch.float32, torch.bfloat16):
                kw = dict(kw, dtype=dtype)
                got_in = [t.clone().requires_grad_() for t in (x,) + params]
                ref_in = [t.clone().requires_grad_() for t in (x,) + params]
                got = window_attn(*got_in, **kw)
                ref = window_attn_plain(*ref_in, **kw)
                ct = torch.randn(got.shape, device="cuda",
                                 generator=torch.Generator("cuda").manual_seed(1)).to(got.dtype)
                got.backward(ct)
                ref.backward(ct)
                torch.cuda.synchronize()
                for name, g, r in zip(names, got_in, ref_in):
                    check(g.grad is not None and float(g.grad.abs().sum()) > 0,
                          f"window attention C={c} shift={shift} {dtype}: gradient of {name} "
                          f"is non-zero")
                    check(torch.equal(g.grad, r.grad), f"window attention C={c} shift={shift} "
                          f"{dtype}: gradient of {name} equals autograd through the plain "
                          f"branch (worst {float((g.grad - r.grad).abs().max()):.3g})")
            out.append({"channels": c, "shift": shift, "shape": list(x.shape),
                        "window": kw["window"], "gradients_equal_and_nonzero": len(names)})
            print(f"window attention gradients C={c} shift {shift} {list(x.shape)} window "
                  f"{kw['window']}: f32 and bf16 equal to the plain branch's, all 8 non-zero",
                  flush=True)
    return out


def train_phase(torch):
    """bench_train and bench_fusion_train at full width, counted."""
    from cm3d_tpu_torch.benchmarks import (
        bench_fusion_train,
        bench_train,
        fusion_bench_setup,
        train_bench_setup,
    )
    from cm3d_tpu_torch.kernels.segment import segment_sum, segment_sum_bwd, segment_sum_max
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj

    wrappers = (segment_sum_max, segment_sum, segment_sum_bwd, window_attn_heads,
                window_attn_proj)
    n_iters = 20
    steps = n_iters + 1
    runs = [
        ("bench_train", lambda: bench_train(TRAIN_BATCH, n_iters, device="cuda"), (1, 0, 0, 0)),
        ("bench_fusion_train conv", lambda: bench_fusion_train(
            TRAIN_BATCH, n_iters, TRAIN_IMAGE_HW, device="cuda"), (1, 1, 1, 0)),
        ("bench_fusion_train swin_t", lambda: bench_fusion_train(
            TRAIN_BATCH, n_iters, TRAIN_IMAGE_HW, device="cuda", camera_backbone="swin_t"),
         (1, 1, 1, SWIN_T_BLOCKS)),
        ("bench_fusion_train swin_t bf16", lambda: bench_fusion_train(
            TRAIN_BATCH, n_iters, TRAIN_IMAGE_HW, device="cuda", camera_backbone="swin_t",
            camera_bf16=True), (1, 1, 1, SWIN_T_BLOCKS)),
    ]
    out = {}
    for name, run, (n_max, n_sum, n_bwd, n_wa) in runs:
        for wr in wrappers:
            wr.launches = 0
        torch.cuda.reset_peak_memory_stats()
        bench = run()
        launches = {wr.__name__: wr.launches for wr in wrappers}
        bench["launches"] = launches
        bench["launches_per_step"] = {k: v / steps for k, v in launches.items()}
        bench["peak_memory_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
        print(f"{name}: " + json.dumps(bench), flush=True)
        want = {"segment_sum_max": n_max, "segment_sum": n_sum, "segment_sum_bwd": n_bwd,
                "window_attn_heads": n_wa, "window_attn_proj": n_wa}
        for key, per_step in want.items():
            check(launches[key] == per_step * steps, f"{name}: {per_step} {key} launches a "
                  f"step over {steps} steps, got {launches[key]}")
        check(np.isfinite(bench["first_loss"]) and np.isfinite(bench["last_loss"])
              and bench["last_loss"] < bench["first_loss"],
              f"{name}: the loss is finite and falls on the fixed batch "
              f"({bench['first_loss']:.4f} -> {bench['last_loss']:.4f})")
        out[name] = bench

    step, state, batch = train_bench_setup(TRAIN_BATCH, device="cuda")
    print("profile of bench_train's step:", flush=True)
    profile_phase(torch, lambda: step(state, batch), n_steps=2)
    del step, state, batch
    for backbone in ("conv", "swin_t"):
        step, state, batch, _ = fusion_bench_setup(TRAIN_BATCH, TRAIN_IMAGE_HW, backbone,
                                                   device="cuda")
        print(f"profile of bench_fusion_train's step ({backbone}):", flush=True)
        profile_phase(torch, lambda: step(state, batch), n_steps=2)
        del step, state, batch
    torch.cuda.empty_cache()
    return out


def _small_train_configs():
    from cm3d_tpu_torch.models.swin import SwinConfig
    from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig
    from cm3d_tpu_torch.train.bevfusion import BevFusionConfig

    lidar_pillar = PillarConfig(x_min=-25.6, x_max=25.6, y_min=-25.6, y_max=25.6,
                                resolution=0.8)
    lidar_model = CenterPointConfig(num_classes=3, trunk_channels=(32, 32))
    fusion_pillar = PillarConfig(x_min=-8.0, x_max=8.0, y_min=-8.0, y_max=8.0,
                                 resolution=1.0, z_min=-3.0, z_max=3.0)
    small_cp = CenterPointConfig(num_classes=3, trunk_channels=(8, 8))
    conv = BevFusionConfig(centerpoint=small_cp, cam_channels=4, cam_trunk=(4, 8),
                           depth_bins=4, d_min=1.0, d_max=7.0)
    swin = BevFusionConfig(
        centerpoint=small_cp, cam_channels=4, depth_bins=4, d_min=1.0, d_max=7.0,
        camera_backbone="swin_t",
        swin=SwinConfig(embed_dim=8, depths=(1, 1, 1), num_heads=(1, 2, 2), out_indices=(1, 2)))
    return lidar_pillar, lidar_model, fusion_pillar, conv, swin


def _small_batch(pillar_cfg, n_classes: int, bsz: int, n: int, m: int, image_hw=None, seed=0):
    """A small synthetic batch (numpy, from a seed); with `image_hw` a
    two-camera FusionBatch whose cameras look along +x and -y."""
    from cm3d_tpu_torch.train.bevfusion import FusionBatch
    from cm3d_tpu_torch.train.train import TrainBatch

    rng = np.random.default_rng(seed)
    lo, hi = pillar_cfg.x_min + 1, pillar_cfg.x_max - 1
    pts = rng.uniform([lo, lo, -2, 0], [hi, hi, 0.5, 1], (bsz, n, 4)).astype(np.float32)
    boxes = np.zeros((bsz, m, 8), np.float32)
    boxes[..., :2] = rng.uniform(lo + 1, hi - 1, (bsz, m, 2))
    boxes[..., 2] = 0.5
    boxes[..., 3:6] = [1.8, 4.2, 1.6]
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (bsz, m))
    boxes[..., 7] = rng.integers(0, n_classes, (bsz, m))
    base = dict(points=pts, point_valid=rng.random((bsz, n)) < 0.95, boxes=boxes,
                box_valid=np.ones((bsz, m), bool))
    if image_hw is None:
        return TrainBatch(**base)
    ih, iw = image_hw
    intr = np.array([[12.0, 0, iw / 2], [0, 12.0, ih / 2], [0, 0, 1]], np.float32)
    e0 = np.array([[0, 0, 1, 0.5], [-1, 0, 0, 0.0], [0, -1, 0, 0.2], [0, 0, 0, 1]], np.float32)
    e1 = np.array([[-1, 0, 0, 0.0], [0, 0, -1, -0.5], [0, -1, 0, 0.2], [0, 0, 0, 1]],
                  np.float32)
    return FusionBatch(
        **base, images=rng.random((bsz, 2, ih, iw, 3)).astype(np.float32),
        intrinsics=np.tile(intr, (bsz, 2, 1, 1)),
        cam_to_ego=np.tile(np.stack([e0, e1]), (bsz, 1, 1, 1)))


def train_cpu_check(torch):
    """Small configurations, 3 steps on the card and on the CPU from one
    state dict, then detect on both from the same weights."""
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.kernels.segment import segment_sum, segment_sum_max
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads
    from cm3d_tpu_torch.pipelines.detect import make_detect_fn
    from cm3d_tpu_torch.train.bevfusion import init_fusion_state, make_fusion_train_step
    from cm3d_tpu_torch.train.train import init_state, make_train_step

    t0 = time.perf_counter()
    lidar_pillar, lidar_model, fusion_pillar, conv, swin = _small_train_configs()
    cases = [
        ("centerpoint", lidar_pillar, None, _small_batch(lidar_pillar, 3, 2, 4096, 6)),
        ("fusion conv", fusion_pillar, conv,
         _small_batch(fusion_pillar, 3, 2, 256, 3, image_hw=(24, 32))),
        ("fusion swin", fusion_pillar, swin,
         _small_batch(fusion_pillar, 3, 2, 256, 3, image_hw=(48, 64))),
    ]
    out = {}
    for name, pillar_cfg, fusion_cfg, host_batch in cases:
        def build(device):
            if fusion_cfg is None:
                state, model, tx = init_state(0, pillar_cfg, lidar_model, learning_rate=3e-3,
                                              device=device)
                return state, model, make_train_step(model, tx, pillar_cfg)
            state, model, tx = init_fusion_state(0, pillar_cfg, fusion_cfg, (0, 0),
                                                 learning_rate=3e-3, device=device)
            return state, model, make_fusion_train_step(model, tx, pillar_cfg)

        state_c, model_c, step_c = build("cpu")
        state_g, model_g, step_g = build("cuda")
        model_g.load_state_dict(model_c.state_dict())  # one state dict for both
        batch_c, batch_g = to_device(host_batch, "cpu"), to_device(host_batch, "cuda")
        before = (segment_sum_max.launches, segment_sum.launches, window_attn_heads.launches)

        grads = []
        for model, step, batch in ((model_c, step_c, batch_c), (model_g, step_g, batch_g)):
            model.train()
            stats = {k: v.clone() for k, v in model.state_dict().items()}
            loss, _ = step.loss_fn(batch)
            names = [k for k, _ in model.named_parameters()]
            g = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
            grads.append({k: t.cpu() for k, t in zip(names, g)})
            model.load_state_dict(stats)  # undo the batch statistics' update
        worst = 0.0
        for k, gc in grads[0].items():
            scale = float(gc.abs().max())
            err = float((grads[1][k] - gc).abs().max())
            worst = max(worst, err / max(scale, 1e-12))
            check(err <= TRAIN_GRAD_TOL * scale + 1e-7, f"{name}: first-step gradient of {k} "
                  f"on the card within {TRAIN_GRAD_TOL} of its largest on the CPU "
                  f"({err:.3g} of {scale:.3g})")
            check(scale > 0, f"{name}: {k} has a gradient")
        losses = []
        for _ in range(3):
            state_c, mc = step_c(state_c, batch_c)
            state_g, mg = step_g(state_g, batch_g)
            lc, lg = float(mc["loss"]), float(mg["loss"])
            losses.append((lc, lg))
            check(abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc), f"{name}: loss on the card "
                  f"{lg:.6f} within {TRAIN_LOSS_RTOL} relative of the CPU's {lc:.6f}")
        check(segment_sum_max.launches > before[0], f"{name}: the card run launches "
              f"segment_sum_max")
        if fusion_cfg is not None:
            check(segment_sum.launches > before[1], f"{name}: the card run launches segment_sum")
        if fusion_cfg is swin:
            check(window_attn_heads.launches > before[2],
                  f"{name}: the card run launches the window-attention kernels")

        # detect on both from the same (CPU-trained) weights
        model_g.load_state_dict(model_c.state_dict())
        radius = np.full(3, 4.0, np.float32)
        kept = []
        for model, batch in ((model_c, batch_c), (model_g, batch_g)):
            detect = make_detect_fn(model, pillar_cfg, radius, top_k=32, score_thresh=0.0,
                                    fusion=fusion_cfg is not None)
            camera = () if fusion_cfg is None else (batch.images, batch.intrinsics,
                                                    batch.cam_to_ego)
            boxes, scores, classes, keep = (t.cpu().numpy() for t in detect(
                batch.points, batch.point_valid, *camera))
            kept.append([{(int(classes[b, i]), round(float(boxes[b, i, 0]), 2),
                           round(float(boxes[b, i, 1]), 2)) for i in np.flatnonzero(keep[b])}
                         for b in range(len(keep))])
        check(kept[0] == kept[1], f"{name}: detect keeps the same boxes on the card and the CPU")
        n_kept = sum(len(k) for k in kept[0])
        check(n_kept > 0, f"{name}: detect keeps boxes")
        out[name] = {"losses_cpu_card": losses, "worst_grad_rel_err": worst, "boxes_kept": n_kept}
        print(f"training card vs CPU, {name}: losses {losses}, worst gradient error "
              f"{worst:.3g} of its tensor's largest, {n_kept} boxes kept on both", flush=True)
    print(f"training card-against-CPU check: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def replay_phase(torch):
    """4 steps straight against 2 + save + load + 2 on the card."""
    import shutil
    import tempfile

    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.models.checkpoints import load_params, save_params
    from cm3d_tpu_torch.pipelines.pretrain import deterministic_training
    from cm3d_tpu_torch.train import AugmentConfig, CenterPointConfig, PillarConfig
    from cm3d_tpu_torch.train.bevfusion import init_fusion_state, make_fusion_train_step
    from cm3d_tpu_torch.train.train import init_state, make_optimizer, make_train_step

    t0 = time.perf_counter()
    _, _, fusion_pillar, _, swin = _small_train_configs()
    full_pillar, full_model = PillarConfig(), CenterPointConfig()
    cases = [
        ("centerpoint, full width, batch 4", full_pillar, None,
         lambda s: _small_batch(full_pillar, 10, 4, 32768, 64, seed=s)),
        ("fusion, tiny Swin camera", fusion_pillar, swin,
         lambda s: _small_batch(fusion_pillar, 3, 2, 256, 3, image_hw=(48, 64), seed=s)),
    ]
    recipe = dict(ema_decay=0.9, augment=AugmentConfig(), aug_seed=5)
    out = {}
    tmp = tempfile.mkdtemp(prefix="replay_")
    try:
        with deterministic_training():
            for name, pillar_cfg, fusion_cfg, make_batch in cases:
                def build():
                    tx = make_optimizer(3e-3, total_steps=4, schedule="cosine", warmup_steps=1,
                                        grad_clip=1.0)
                    if fusion_cfg is None:
                        state, model, tx = init_state(0, pillar_cfg, full_model, tx=tx,
                                                      ema=True, device="cuda")
                        return state, make_train_step(model, tx, pillar_cfg, **recipe)
                    state, model, tx = init_fusion_state(0, pillar_cfg, fusion_cfg, (0, 0),
                                                         tx=tx, ema=True, device="cuda")
                    return state, make_fusion_train_step(model, tx, pillar_cfg, **recipe)

                def run(state, step, first, last):
                    for s in range(first, last):
                        state, _ = step(state, to_device(make_batch(s), "cuda"))
                    return state

                straight, step = build()
                straight = run(straight, step, 0, 4)
                half, step = build()
                half = run(half, step, 0, 2)
                save_params(half.tree(), f"{tmp}/{len(out)}", overwrite=True)
                resumed, step = build()  # a fresh process would start here
                resumed.load_tree(load_params(f"{tmp}/{len(out)}"))
                check(resumed.step == 2 and resumed.opt_state["count"] == 2,
                      f"{name}: the loaded state is at step 2")
                resumed = run(resumed, step, 2, 4)
                n = 0
                for key in ("params", "batch_stats", "ema_params"):
                    for k, t in getattr(straight, key).items():
                        check(torch.equal(t, getattr(resumed, key)[k]),
                              f"replay ({name}): {key}.{k} bit-equal after resume")
                        n += 1
                for key in ("mu", "nu"):
                    for k, t in straight.opt_state[key].items():
                        check(torch.equal(t, resumed.opt_state[key][k]),
                              f"replay ({name}): opt_state.{key}.{k} bit-equal after resume")
                        n += 1
                moved = any(not torch.equal(t, half.params[k]) for k, t in
                            straight.params.items())
                check(moved and straight.step == resumed.step == 4,
                      f"replay ({name}): the last two steps moved the parameters")
                out[name] = {"tensors_bit_equal": n}
                print(f"replay ({name}): 4 steps straight == 2 + save + load + 2, {n} tensors "
                      f"bit-equal", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"replay check: {time.perf_counter() - t0:.2f} s", flush=True)
    return out


def deterministic_phases(torch) -> dict:
    """Phase 14, what runs in the child process: CUBLAS_WORKSPACE_CONFIG is
    in its environment from the start."""
    from cm3d_tpu_torch.benchmarks import bench_train
    from cm3d_tpu_torch.pipelines.pretrain import deterministic_training

    check(os.environ.get("CUBLAS_WORKSPACE_CONFIG") == DETERMINISTIC_WORKSPACE,
          "the child process has cuBLAS's workspace fixed")
    gradients = swin_t_gradient_phase(torch)
    plain = bench_train(TRAIN_BATCH, 20, device="cuda")
    with deterministic_training():
        det = bench_train(TRAIN_BATCH, 20, device="cuda")
    print(f"bench_train with CUBLAS_WORKSPACE_CONFIG set: {plain['value']:.3f} ms/step; under "
          f"deterministic algorithms as well: {det['value']:.3f}", flush=True)
    return {"swin_t_gradients": gradients, "bench_train_workspace_fixed": plain,
            "bench_train_deterministic": det, "replay": replay_phase(torch)}


def deterministic_phases_in_child() -> dict:
    """Run phase 14 in a child process and return its results. The child
    prints its progress lines, then one JSON line, which is parsed here."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), DETERMINISTIC_FLAG],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=DETERMINISTIC_WORKSPACE),
        stdout=subprocess.PIPE, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(proc.returncode == 0 and lines, f"the deterministic phases' process exited with "
          f"{proc.returncode}: {lines[-1] if lines else 'no output'}")
    return json.loads(lines[-1])


# --- 15. released-checkpoint loading ------------------------------------------

CLIP_CPU_TOL = 1e-4  # CLIP classifier on the card (f32, TF32 off) vs the CPU
WAYMO_RI_HW = (64, 2650)  # the TOP lidar's range image
# front, front-left, front-right (1920 x 1280); side-left, side-right (1920 x 886)
WAYMO_CAMERAS = ((0.0, 1920, 1280), (0.785, 1920, 1280), (-0.785, 1920, 1280),
                 (1.571, 1920, 886), (-1.571, 1920, 886))
WAYMO_MASKS = 128  # masks a keyframe (WAYMO_LIFT.max_masks)
WAYMO_FRAMES = 8  # one batch-8 lift step
POINTS_ATOL = 2e-3  # range-image points, card vs CPU, metres (global-frame f32)


def _word_merges(words):
    """A toy BPE table that spells each word of `words` as one token (no
    released merges file is in the repository)."""
    merges = []
    for word in words:
        for tok in re.findall(r"[a-z]+", word.lower()):
            parts = list(tok[:-1]) + [tok[-1] + "</w>"]
            while len(parts) > 1:
                pair = (parts[0], parts[1])
                if pair not in merges:
                    merges.append(pair)
                parts = [parts[0] + parts[1]] + parts[2:]
    return merges


def released_weights_phase(torch) -> dict:
    """Full-width Detic Swin-B, SAM ViT-H and CLIP B/32 from seeded random
    weights, written as released files (detectron2 names with fc1 in
    (c, y, x) order under "model", SAM's keys, CLIP's under Detic's
    `text_encoder.` prefix, a gzip BPE file), loaded by build_real_models
    on the card, against the same modules in memory through
    _batched_model_fns: Detic's outputs and SAM's planes bit-equal; the CLIP
    classifier against the CPU within CLIP_CPU_TOL; one keyframe of
    run_mask_stage on the loaded models, counted."""
    import gzip
    import tempfile

    from cm3d_tpu_torch.benchmarks import IMG_H, IMG_W
    from cm3d_tpu_torch.config import MaskStageConfig
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.models.clip_text import (
        CLIP_TEXT_B32, ClipTextEncoder, SimpleTokenizer, embed_vocabulary, init_clip_weights)
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.detic import DETIC_SWINB, Detic
    from cm3d_tpu_torch.models.sam import SAM_VIT_H, Sam
    from cm3d_tpu_torch.ops.bitmask import num_words
    from cm3d_tpu_torch.pipelines.masks import (
        _batched_model_fns, build_real_models, run_mask_stage)
    from cm3d_tpu_torch.utils.device import strict_f32_scope
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES as VOCAB

    dev = torch.device("cuda")
    detic_cfg = dataclasses.replace(DETIC_SWINB, dtype="bfloat16",
                                    swin=dataclasses.replace(DETIC_SWINB.swin, dtype="bfloat16"))
    with torch.device(dev):
        gen = torch.Generator(device=dev)
        detic = init_weights(Detic(detic_cfg), gen.manual_seed(20))
        sam = init_weights(Sam(dataclasses.replace(SAM_VIT_H, dtype="bfloat16")),
                           gen.manual_seed(21))
        clip = init_clip_weights(ClipTextEncoder(CLIP_TEXT_B32), gen.manual_seed(22))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        c, p = detic_cfg.fpn_dim, detic_cfg.pooler_size
        dsd = {k: v.detach().cpu() for k, v in detic.state_dict().items()}
        for k in range(detic_cfg.num_cascade_stages):
            key = f"roi_heads.box_head.{k}.fc1.weight"
            w = dsd[key]
            dsd[key] = w.reshape(w.shape[0], p, p, c).permute(0, 3, 1, 2).reshape(w.shape)
        # a buffer of the released Swin that nothing reads
        dsd["backbone.bottom_up.layers.0.blocks.0.attn.relative_position_index"] = \
            torch.zeros(49, 49, dtype=torch.int64)
        paths = {n: os.path.join(tmp, n) for n in ("detic.pth", "sam.pth", "clip.pt",
                                                   "bpe.txt.gz")}
        torch.save({"model": dsd, "iteration": 0}, paths["detic.pth"])
        torch.save({k: v.detach().cpu() for k, v in sam.state_dict().items()}, paths["sam.pth"])
        torch.save({f"text_encoder.{k}": v.detach().cpu() for k, v in clip.state_dict().items()},
                   paths["clip.pt"])
        with gzip.open(paths["bpe.txt.gz"], "wt", encoding="utf-8") as f:
            f.write("\n".join(["#version: toy"] + [f"{a} {b}" for a, b in _word_merges(VOCAB)]))
        del dsd
        out["write_s"] = time.perf_counter() - t0
        out["file_mb"] = {n: os.path.getsize(q) / 2**20 for n, q in paths.items()}

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = build_real_models(paths["detic.pth"], paths["sam.pth"], paths["clip.pt"],
                                   paths["bpe.txt.gz"], vocabulary=VOCAB, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        tok = SimpleTokenizer.from_file(paths["bpe.txt.gz"])
    with strict_f32_scope():
        clf = embed_vocabulary(clip, tok, list(VOCAB))
    clf_cpu = embed_vocabulary(copy.deepcopy(clip).cpu(), tok, list(VOCAB))
    out["clip_max_abs_err"] = float(np.abs(clf - clf_cpu).max())
    check(out["clip_max_abs_err"] <= CLIP_CPU_TOL,
          f"CLIP classifier card vs CPU within {CLIP_CPU_TOL} ({out['clip_max_abs_err']:.3g})")
    memory = _batched_model_fns(detic, clf, sam, VOCAB, device=dev)

    rng = np.random.default_rng(5)
    ring = [rng.integers(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8) for _ in range(N_CAMERAS)]
    got_det = loaded.detic(loaded.prepare(ring))
    want_det = memory.detic(memory.prepare(ring))
    for name, a, b in zip(("boxes", "scores", "classes", "valid"), got_det, want_det):
        check(torch.equal(a, b), f"released Detic {name} bit-equal to the in-memory modules")
    out["detections"] = int(got_det[3].sum())
    # SAM on fixed prompts: 25 boxes a camera
    prompts = np.zeros((N_CAMERAS, 32, 4), np.float32)
    xy = rng.uniform(0.0, 0.8, (N_CAMERAS, 25, 2)) * [IMG_W, IMG_H]
    wh = rng.uniform(0.02, 0.2, (N_CAMERAS, 25, 2)) * [IMG_W, IMG_H]
    prompts[:, :25] = np.concatenate([xy, xy + wh], -1)
    n_boxes = np.full(N_CAMERAS, 25, np.int32)
    cam_hw = [(IMG_H, IMG_W)] * N_CAMERAS
    planes = []
    for models in (loaded, memory):
        frame = models.prepare(ring)
        planes.append(models.sam_decode_planes(models.sam_encode(frame), prompts, n_boxes,
                                               cam_hw, (IMG_W, IMG_H), num_words(128), "xy"))
    check(torch.equal(planes[0], planes[1]), "released SAM planes bit-equal to the in-memory")
    out["plane_words_set"] = int((planes[0] != 0).sum())

    # one production-geometry keyframe of run_mask_stage on the loaded models
    window_attn_heads.launches = window_attn_proj.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        run_mask_stage(loaded, lambda s, f: ring, ["released"], lambda s: 1, tmp,
                       MaskStageConfig(), verbose=False)
        torch.cuda.synchronize()
        out["mask_stage_keyframe_s"] = time.perf_counter() - t0
    out["launches"] = {"window_attn_heads": window_attn_heads.launches,
                       "window_attn_proj": window_attn_proj.launches}
    check(out["launches"]["window_attn_heads"] == SWIN_BLOCKS_PER_FORWARD
          and out["launches"]["window_attn_proj"] == SWIN_BLOCKS_PER_FORWARD,
          f"one keyframe on loaded weights: 24 + 24 window-attention launches, "
          f"got {out['launches']}")
    print(f"released weights: write {out['write_s']:.2f} s ({out['file_mb']}), "
          f"build_real_models {out['load_s']:.2f} s; Detic ({out['detections']} detections) "
          f"and SAM planes bit-equal to the in-memory modules; CLIP classifier card vs CPU "
          f"max abs err {out['clip_max_abs_err']:.3g}; one run_mask_stage keyframe "
          f"{out['mask_stage_keyframe_s']:.2f} s, launches {out['launches']}; "
          f"{out['plane_words_set']} plane words set", flush=True)
    del loaded, memory, detic, sam, clip, planes
    torch.cuda.empty_cache()
    return out


# --- 16. the Waymo path ---------------------------------------------------------

def _rotz(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def fabricate_waymo(torch, frames_root, mask_dir, n_frames, seed=0):
    """Frame-lite frames at Waymo's real geometry, in `frames_root/<scene>`,
    and their mask artifacts in `mask_dir`: a 64 x 2650 range image cast on
    the card against a ground plane, a far wall and 128 boxes (sky pixels
    carry no return), with a rolling-shutter pose image (2 m of travel over
    the sweep, around (3000, -1200, 30) m global); 5 cameras at their real
    sizes and layout, each a JPEG; 128 masks a keyframe (each box's
    projection as an ellipse on the 1024 x 683 canvas). Returns the scene
    name."""
    import io

    from PIL import Image

    from cm3d_tpu_torch.config import SHAPE_PRIORS_CHATGPT
    from cm3d_tpu_torch.datasets.artifacts import FrameMasks, MaskArtifactStore
    from cm3d_tpu_torch.datasets.waymo.frontend import _AXES, WAYMO_IMAGE_RATIO, WAYMO_MASK_WH
    from cm3d_tpu_torch.ops.range_image import azimuth_grid

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    scene = "segment-smoke"
    os.makedirs(os.path.join(frames_root, scene), exist_ok=True)
    store = MaskArtifactStore(mask_dir)
    h_ri, w_ri = WAYMO_RI_HW
    incl = np.linspace(0.04, -0.30, h_ri).astype(np.float32)
    lidar_ext = np.eye(4, dtype=np.float32)
    lidar_ext[:3, 3] = [1.4, 0.0, 2.2]
    pose_yaw = 0.7
    pose = np.eye(4)
    pose[:3, :3] = _rotz(pose_yaw)
    pose[:3, 3] = [3000.0, -1200.0, 30.0]
    heading = np.array([np.cos(pose_yaw), np.sin(pose_yaw), 0.0])
    axes_swap = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float64)
    cam_ext, cam_intr, tms = [], [], []
    for yaw, w, h in WAYMO_CAMERAS:
        tm = np.eye(4)
        tm[:3, :3] = _rotz(yaw) @ axes_swap
        tm[:3, 3] = [1.5, 0.0, 2.0]
        tms.append(tm)
        cam_ext.append(tm @ _AXES)
        cam_intr.append([2000.0, 2000.0, w / 2, h / 2, 0, 0, 0, 0, 0])
    names = ("car", "truck", "pedestrian", "bicycle")
    mw, mh = WAYMO_MASK_WH
    az = azimuth_grid(w_ri, torch.as_tensor(lidar_ext, device=dev))
    ti = torch.as_tensor(incl, device=dev)
    dirs = torch.stack([torch.cos(ti)[:, None] * torch.cos(az)[None],
                        torch.cos(ti)[:, None] * torch.sin(az)[None],
                        torch.sin(ti)[:, None].expand(h_ri, w_ri)], -1).reshape(-1, 3)
    origin = torch.as_tensor(lidar_ext[:3, 3], device=dev, dtype=torch.float32)
    lanes = [pose[:3, 3] + d[None] * np.linspace(-60, 60, 121)[:, None]
             for d in (heading, _rotz(np.pi / 2) @ heading)]
    for f in range(n_frames):
        objects = []
        for j in range(WAYMO_MASKS):
            ci = j % len(WAYMO_CAMERAS)
            yaw = WAYMO_CAMERAS[ci][0] + rng.uniform(-0.35, 0.35)
            dist = rng.uniform(8.0, 45.0)
            name = names[j % len(names)]
            w, l, hgt = SHAPE_PRIORS_CHATGPT[name]
            objects.append((name, ci, np.array([dist * np.cos(yaw), dist * np.sin(yaw), hgt / 2]),
                            (w, l, hgt), rng.uniform(-np.pi, np.pi)))
        # ray cast on the card: background, then the nearest box (slabs)
        down = dirs[:, 2] < -1e-3
        rng_bg = torch.where(down, -origin[2] / dirs[:, 2].clamp(max=-1e-3),
                             torch.full_like(dirs[:, 0], 1e9)).clamp(max=75.0)
        rng_bg = torch.where(dirs[:, 2] > 0.02, torch.full_like(rng_bg, -1.0), rng_bg)
        best = torch.full_like(rng_bg, 1e9)
        for _, _, center, size, yaw in objects:
            rot = torch.as_tensor(_rotz(-yaw), device=dev, dtype=torch.float32)
            o = rot @ (origin - torch.as_tensor(center, device=dev, dtype=torch.float32))
            d = dirs @ rot.T
            half = torch.as_tensor([size[1] / 2, size[0] / 2, size[2] / 2], device=dev)
            inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
            t1, t2 = (-half - o) * inv, (half - o) * inv
            t_near = torch.minimum(t1, t2).amax(-1)
            t_far = torch.maximum(t1, t2).amin(-1)
            hit = (t_near <= t_far) & (t_near > 0)
            best = torch.where(hit, torch.minimum(best, t_near), best)
        ri = torch.where(best < 1e8, best, rng_bg).reshape(h_ri, w_ri).cpu().numpy()
        pose6 = np.zeros((h_ri, w_ri, 6), np.float32)
        travel = (np.arange(w_ri) / w_ri - 0.5) * 2.0
        pose6[..., 2] = pose_yaw
        pose6[..., 3:6] = (pose[:3, 3][None] + travel[:, None] * heading[None])[None]

        masks = np.zeros((WAYMO_MASKS, mw, mh), np.uint8)
        labels, scores, cams, boxes = [], [], [], []
        xs, ys = np.arange(mw)[:, None], np.arange(mh)[None, :]
        for mi, (name, ci, center, size, yaw) in enumerate(objects):
            corners = np.array([[sx * size[1] / 2, sy * size[0] / 2, sz * size[2] / 2]
                                for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
            pts = corners @ _rotz(yaw).T + center
            cam = (pts - tms[ci][:3, 3]) @ tms[ci][:3, :3]  # optical frame
            cam = cam[cam[:, 2] > 0.5]
            _, wid, hei = WAYMO_CAMERAS[ci]
            if len(cam):
                u = (2000.0 * cam[:, 0] / cam[:, 2] + wid / 2) * WAYMO_IMAGE_RATIO
                v = (2000.0 * cam[:, 1] / cam[:, 2] + hei / 2) * WAYMO_IMAGE_RATIO
                u0, u1 = np.clip([u.min(), u.max()], 0, wid * WAYMO_IMAGE_RATIO - 1)
                v0, v1 = np.clip([v.min(), v.max()], 0, hei * WAYMO_IMAGE_RATIO - 1)
                if u1 - u0 > 2 and v1 - v0 > 2:
                    cu, cv, ru, rv = (u0 + u1) / 2, (v0 + v1) / 2, (u1 - u0) / 2, (v1 - v0) / 2
                    masks[mi] = ((xs - cu) / ru) ** 2 + ((ys - cv) / rv) ** 2 <= 1.0
            labels.append(name)
            scores.append(float(rng.uniform(0.3, 1.0)))
            cams.append(ci)
            boxes.append([*center, size[0], size[1], size[2], yaw])
        store.write_frame(scene, f, FrameMasks(labels, scores, cams, masks))
        jpegs = []
        for _, wid, hei in WAYMO_CAMERAS:
            grad = (np.add.outer(np.arange(hei) * 0.1, np.arange(wid) * 0.05) % 200 + 30)
            im = np.repeat(grad[..., None], 3, -1).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(im).save(buf, format="JPEG", quality=70)
            jpegs.append(np.frombuffer(buf.getvalue(), np.uint8))
        obj_jpegs = np.empty(len(jpegs), object)
        obj_jpegs[:] = jpegs
        obj_lanes = np.empty(len(lanes), object)
        obj_lanes[:] = lanes
        np.savez(os.path.join(frames_root, scene, f"frame_{f:03d}.npz"),
                 context_name=f"ctx_{scene}", timestamp_micros=np.int64(100_000 * (f + 1)),
                 pose=pose, range_image=ri.astype(np.float32), range_image_pose=pose6,
                 inclinations=incl, lidar_extrinsic=lidar_ext,
                 cam_intrinsic=np.asarray(cam_intr), cam_extrinsic=np.asarray(cam_ext),
                 cam_images_jpeg=obj_jpegs, lane_polylines=obj_lanes,
                 labels_box=np.asarray(boxes), labels_type=np.ones(WAYMO_MASKS, np.int32),
                 labels_num_points=np.full(WAYMO_MASKS, 50, np.int32),
                 labels_id=np.array([f"o{j}" for j in range(WAYMO_MASKS)]))
    store.mark_scene_complete(scene, n_frames)
    return scene


def _near_tie_rows(torch, rows, valid):
    """Rows whose two smallest plain medoid sums lie within 1e-5 relative:
    where the kernel's summation order may pick the other point."""
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows_plain

    sums = torch.where(valid, medoid_distance_sums_rows_plain(rows, valid),
                       torch.tensor(float("inf"), device=rows.device))
    two = torch.topk(sums, 2, dim=1, largest=False).values
    return (valid.sum(1) > 1) & ((two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs())


def dataset_step_phase(torch, dataset: str, step, cpu_step, frames, cpu_frames,
                       camera_rows: int, keep_of) -> dict:
    """A dataset's batch-8 lift step on the card: B1 / B2 held to their
    plain versions on its inputs (compaction bit-exact at every stage, the
    camera stage at `camera_rows` rows; medoid sums within rtol 1e-5), the
    step counted (3 + 1 launches) and timed, and its first 2 keyframes
    (`cpu_frames`) through `cpu_step` against the card's (counts, flags and
    keep sets equal, medoids but for near ties). `keep_of(step output)` is
    its keep flags."""
    from cm3d_tpu_torch.kernels.compact import compact_rows, compact_rows_plain
    from cm3d_tpu_torch.kernels.medoid import (
        medoid_distance_sums_rows, medoid_distance_sums_rows_plain)

    out = {"compaction_shapes": []}
    n_frames = frames.points.shape[0]
    compactions, (rows, valid) = capture_kernel_inputs(torch, step, frames)
    for name, (sel, values, limit) in zip(STAGES, compactions):
        got, want = compact_rows(sel, values, limit), compact_rows_plain(sel, values, limit)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"{dataset} compaction {name} stage bit-exact vs plain")
        out["compaction_shapes"].append({
            "stage": name, "rows": values.shape[0], "sources": values.shape[2],
            "words": values.shape[1], "limit": limit,
            "kept": int(sel.sum(1).clamp(max=limit).sum())})
    check(out["compaction_shapes"][0]["rows"] == camera_rows,
          f"the {dataset} camera stage has {camera_rows} rows")
    sums = medoid_distance_sums_rows(rows, valid)
    plain = medoid_distance_sums_rows_plain(rows, valid)
    g, w = sums[valid], plain[valid]
    rel = float(((g - w).abs() / w.abs().clamp(min=1e-30)).max()) if g.numel() else 0.0
    out["medoid"] = {"rows": rows.shape[0], "k": rows.shape[2], "max_rel_err": rel,
                     "max_abs_err": float((g - w).abs().max()) if g.numel() else 0.0,
                     "rows_with_points": int(valid.any(1).sum())}
    check(rel <= 1e-5, f"{dataset} medoid sums within rtol 1e-5 of plain ({rel:.3g})")
    near_tie = _near_tie_rows(torch, rows, valid)
    del compactions, rows, valid

    # the step, counted and timed
    compact_rows.launches = medoid_distance_sums_rows.launches = 0
    n_iters = 10
    step(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        res = step(frames)
    torch.cuda.synchronize()
    out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / n_iters
    out["keyframes_per_s"] = n_frames * 1e3 / out["ms_per_step"]
    out["launches_per_step"] = {
        "compact_rows": compact_rows.launches / (n_iters + 1),
        "medoid_distance_sums_rows": medoid_distance_sums_rows.launches / (n_iters + 1)}
    check(out["launches_per_step"] == {"compact_rows": 3, "medoid_distance_sums_rows": 1},
          f"a {dataset} step launches 3 compactions and 1 medoid: {out['launches_per_step']}")
    lift, keep = res[0], keep_of(res)
    out["kept_boxes"] = int(keep.sum())
    out["cam_truncated"] = int(lift.cam_truncated.sum())
    out["mask_truncated"] = int(lift.truncated.sum())
    check(bool(torch.isfinite(lift.centroids).all()) and out["kept_boxes"] > 0,
          f"{dataset} step: finite centroids, boxes kept")

    # 2 keyframes against the CPU lift
    cpu_res = cpu_step(cpu_frames)
    cpu_lift = cpu_res[0]
    for name, a, b in (("point_counts", lift.point_counts, cpu_lift.point_counts),
                       ("has_points", lift.has_points, cpu_lift.has_points),
                       ("truncated", lift.truncated, cpu_lift.truncated),
                       ("cam_truncated", lift.cam_truncated, cpu_lift.cam_truncated),
                       ("keep", keep, keep_of(cpu_res))):
        check(torch.equal(a[:2].cpu(), b), f"{dataset} {name} equal to the CPU path")
    m = lift.centroids.shape[1]
    same = (lift.centroids[:2].cpu() == cpu_lift.centroids).all(-1)
    tie = near_tie.reshape(n_frames, m)[:2].cpu()
    check(bool((same | tie).all()), f"{dataset} medoids equal to the CPU's but for near ties")
    out["medoids_differing"] = int((~same).sum())
    out["near_tie_rows"] = int(tie.sum())
    return out


def waymo_phase(torch, batches: dict) -> dict:
    """The Waymo path on the card at real geometry (fabricate_waymo):
    the frontend (range image unprojected on the card) against its CPU run,
    B1 / B2 held to their plain versions on a batch-8 Waymo step's inputs,
    the step counted and timed, 2 keyframes against the CPU lift (bit-equal
    counts, medoid choices but for near ties, keep sets), run_lift_waymo end
    to end, counted, then run_e2e_waymo on the tiny random-weight models;
    B3 at full width on the mixed ring (a thumbnailed ring through the bf16
    Detic Swin-B, every shape against the plain version, window_attn_phase)
    and run_e2e_waymo at full width, counted and timed."""
    import tempfile

    from cm3d_tpu_torch.benchmarks import build_production_fake_models
    from cm3d_tpu_torch.config import WAYMO_LIFT
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes, to_device
    from cm3d_tpu_torch.datasets.waymo.frontend import WaymoFrontend, ring_images
    from cm3d_tpu_torch.datasets.waymo.proto import decode_objects
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.models.swin import SWIN_TEST
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.pipelines.e2e import run_e2e_waymo
    from cm3d_tpu_torch.pipelines.lift_waymo import run_lift_waymo
    from cm3d_tpu_torch.pipelines.masks import build_fake_models
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_WAYMO

    dev = torch.device("cuda")
    out = {"config": "WAYMO_LIFT, batch 8, 5 cameras (3 x 1920x1280, 2 x 1920x886), "
                     "64 x 2650 range image with pose image, 128 masks a keyframe"}
    with tempfile.TemporaryDirectory() as tmp:
        frames_root, mask_dir = os.path.join(tmp, "frames"), os.path.join(tmp, "masks")
        t0 = time.perf_counter()
        scene = fabricate_waymo(torch, frames_root, mask_dir, WAYMO_FRAMES)
        out["fabricate_s"] = time.perf_counter() - t0

        # frontend: card against CPU
        fe = WaymoFrontend(frames_root, MaskArtifactStore(mask_dir), WAYMO_LIFT, device=dev)
        fe_cpu = WaymoFrontend(frames_root, MaskArtifactStore(mask_dir), WAYMO_LIFT,
                               device="cpu")
        t0 = time.perf_counter()
        built = list(fe.iter_scene(scene))
        out["frontend_s_per_frame"] = (time.perf_counter() - t0) / len(built)
        check(len(built) == WAYMO_FRAMES, f"{WAYMO_FRAMES} Waymo keyframes built")
        err = 0.0
        for i, path in enumerate(fe_cpu.frame_files(scene)[:2]):
            kf_cpu, _ = fe_cpu.build_keyframe(scene, i, fe_cpu.load_frame(path))
            kf = built[i][0]
            for f in ("point_valid", "mask_bits", "mask_cam", "mask_label", "mask_valid",
                      "lane_points"):
                check(np.array_equal(getattr(kf, f), getattr(kf_cpu, f)),
                      f"Waymo keyframe {f}: card frontend equal to the CPU's")
            err = max(err, float(np.abs(kf.points - kf_cpu.points).max()))
        out["points_max_abs_err"] = err
        check(err <= POINTS_ATOL, f"Waymo points card vs CPU within {POINTS_ATOL} m ({err:.3g})")
        n_valid = [int(kf.point_valid.sum()) for kf, _ in built]
        out["points_per_keyframe"] = n_valid
        check(all(n == WAYMO_LIFT.max_points for n in n_valid),
              f"the 131072-point cap cuts each range image: {n_valid}")

        # B1 / B2 at Waymo's shapes, the step counted and timed, 2 keyframes
        # against the CPU lift
        host = stack_keyframes([kf for kf, _ in built])
        batches["waymo"] = host.frames  # phase 19's Waymo lift artifact
        frames = to_device(host.frames, dev)
        out.update(dataset_step_phase(
            torch, "Waymo", make_keyframe_step_fn(WAYMO_LIFT, device=dev),
            make_keyframe_step_fn(WAYMO_LIFT, device="cpu"),
            frames, to_device(map_fields(lambda x: x[:2], host.frames), "cpu"),
            WAYMO_FRAMES * len(WAYMO_CAMERAS), lambda res: res[1].keep))

        # run_lift_waymo end to end, counted
        compact_rows.launches = medoid_distance_sums_rows.launches = 0
        t0 = time.perf_counter()
        n_obj = run_lift_waymo(frames_root, mask_dir, [scene], os.path.join(tmp, "pred.bin"),
                               batch_size=WAYMO_FRAMES, verbose=False, device=dev)
        out["run_lift_waymo_s"] = time.perf_counter() - t0
        out["run_lift_waymo_launches"] = {
            "compact_rows": compact_rows.launches,
            "medoid_distance_sums_rows": medoid_distance_sums_rows.launches}
        objs = decode_objects(open(os.path.join(tmp, "pred.bin"), "rb").read())
        check(n_obj == len(objs) > 0 and out["run_lift_waymo_launches"] == {
            "compact_rows": 3, "medoid_distance_sums_rows": 1},
            f"run_lift_waymo: {n_obj} objects, launches {out['run_lift_waymo_launches']}")
        out["objects"] = n_obj

        # the fused path on the tiny random-weight models: B3 on the mixed ring
        models = build_fake_models(vocabulary=CUSTOM_VOCABULARY_WAYMO, device=dev)
        for fn in (compact_rows, medoid_distance_sums_rows, window_attn_heads, window_attn_proj):
            fn.launches = 0
        t0 = time.perf_counter()
        n = run_e2e_waymo(frames_root, [scene], os.path.join(tmp, "fused.bin"), models,
                          batch_size=4, verbose=False, device=dev)
        torch.cuda.synchronize()
        out["fused_s"] = time.perf_counter() - t0
        out["fused_keyframes_lifted"] = n
        out["fused_launches"] = {
            "compact_rows": compact_rows.launches,
            "medoid_distance_sums_rows": medoid_distance_sums_rows.launches,
            "window_attn_heads": window_attn_heads.launches,
            "window_attn_proj": window_attn_proj.launches}
        blocks = sum(SWIN_TEST.depths) * WAYMO_FRAMES
        steps = -(-n // 4)
        check(out["fused_launches"]["window_attn_heads"] == blocks
              and out["fused_launches"]["window_attn_proj"] == blocks
              and out["fused_launches"]["compact_rows"] == 3 * steps
              and out["fused_launches"]["medoid_distance_sums_rows"] == steps,
              f"fused Waymo: {blocks} + {blocks} window-attention launches on the mixed ring, "
              f"3 + 1 a lift step ({steps} steps): {out['fused_launches']}")
        del models

        # B3 at full width on the mixed ring: one thumbnailed Waymo ring
        # through the bf16 Detic Swin-B, every (stage, shift) shape held to
        # the plain version as phase 4 holds nuScenes'
        prod = build_production_fake_models("bfloat16", device=dev,
                                            vocabulary=CUSTOM_VOCABULARY_WAYMO)
        ring = ring_images(fe.load_frame_by_index(scene, 0))
        out["ring_hw"] = [list(im.shape[:2]) for im in ring]
        check(len({hw[0] for hw in out["ring_hw"]}) == 2,
              f"the Waymo ring mixes two image heights: {out['ring_hw']}")
        frame = prod.prepare(ring)
        captured = capture_window_attn_inputs(torch, lambda: prod.detic(frame))
        canvas_h = -(-max(h for h, _ in out["ring_hw"]) // 32) * 32
        stage0 = tuple(captured[0][1][0].shape)
        check(stage0 == (len(ring), canvas_h // 4, 1024 // 4, 128),
              f"Swin-B's first stage on the Waymo canvas ({canvas_h} x 1024): {stage0}")
        out["full_width_window_attn"] = [
            {"channels": r["channels"], "shift": r["shift"], "shape": r["shape"],
             "blocks_per_forward": r["blocks_per_forward"], "max_rel_err": r["max_rel_err"],
             "f32_max_abs_err": r["f32_max_abs_err"],
             **{f"{k}_{f}": r[k][f] for k in ("heads", "proj")
                for f in ("ms", "plain_ms", "bound_ms")}}
            for r in window_attn_phase(torch, captured)]
        del captured
        window_attn_heads.launches = window_attn_proj.launches = 0
        prod.detic(frame)
        torch.cuda.synchronize()
        out["full_width_detic_launches"] = {"window_attn_heads": window_attn_heads.launches,
                                            "window_attn_proj": window_attn_proj.launches}
        check(out["full_width_detic_launches"] == {"window_attn_heads": SWIN_BLOCKS_PER_FORWARD,
                                                   "window_attn_proj": SWIN_BLOCKS_PER_FORWARD},
              f"one full-width Detic forward on the Waymo ring: 24 + 24 launches, got "
              f"{out['full_width_detic_launches']}")
        del frame

        # the fused Waymo path at full width, counted and timed (first
        # calls of SAM's encode and decode at these shapes included)
        for fn in (compact_rows, medoid_distance_sums_rows, window_attn_heads, window_attn_proj):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_full = run_e2e_waymo(frames_root, [scene], os.path.join(tmp, "full.bin"), prod,
                               batch_size=4, verbose=False, device=dev)
        torch.cuda.synchronize()
        out["full_width_fused_s"] = time.perf_counter() - t0
        out["full_width_fused_s_per_keyframe"] = out["full_width_fused_s"] / max(n_full, 1)
        out["full_width_fused_launches"] = {
            "compact_rows": compact_rows.launches,
            "medoid_distance_sums_rows": medoid_distance_sums_rows.launches,
            "window_attn_heads": window_attn_heads.launches,
            "window_attn_proj": window_attn_proj.launches}
        full_objs = decode_objects(open(os.path.join(tmp, "full.bin"), "rb").read())
        out["full_width_objects"] = len(full_objs)
        blocks = SWIN_BLOCKS_PER_FORWARD * WAYMO_FRAMES
        steps = -(-n_full // 4)
        check(n_full == WAYMO_FRAMES
              and out["full_width_fused_launches"] == {
                  "compact_rows": 3 * steps, "medoid_distance_sums_rows": steps,
                  "window_attn_heads": blocks, "window_attn_proj": blocks},
              f"full-width fused Waymo: {n_full} keyframes lifted, {blocks} + {blocks} "
              f"window-attention launches, 3 + 1 a lift step: {out['full_width_fused_launches']}")
        check(all(np.isfinite([o.box.center_x, o.box.center_y, o.box.center_z, o.box.length,
                               o.box.width, o.box.height, o.box.heading, o.score]).all()
                  for o in full_objs), "full-width fused Waymo objects are finite")
        del prod
    print(f"waymo: fabricate {out['fabricate_s']:.2f} s, frontend "
          f"{out['frontend_s_per_frame']:.3f} s a frame, points card vs CPU max abs err "
          f"{out['points_max_abs_err']:.3g} m; B1 stages {out['compaction_shapes']} bit-exact; "
          f"B2 {out['medoid']}; step {out['ms_per_step']:.3f} ms "
          f"({out['keyframes_per_s']:.1f} keyframes/s), launches a step "
          f"{out['launches_per_step']}; CPU check: {out['medoids_differing']} medoids differ "
          f"({out['near_tie_rows']} near-tie rows allowed to); run_lift_waymo {out['run_lift_waymo_s']:.2f} s, {out['objects']} "
          f"objects; fused path {out['fused_s']:.2f} s, {n} keyframes lifted, launches "
          f"{out['fused_launches']}; full width on the ring {out['ring_hw']}: Detic "
          f"{out['full_width_detic_launches']}, fused path {out['full_width_fused_s']:.2f} s "
          f"({out['full_width_fused_s_per_keyframe']:.3f} s a keyframe), {n_full} keyframes, "
          f"{out['full_width_objects']} objects, launches {out['full_width_fused_launches']}",
          flush=True)
    torch.cuda.empty_cache()
    return out


# --- 17. the KITTI path ---------------------------------------------------------

KITTI_FRAMES = 8  # one batch-8 lift step
# image_2's native sizes in KITTI's drives, one a frame: their 1024 thumbnails
# are 309 or 310 rows high, so the frame size changes from frame to frame
KITTI_IMAGE_WH = ((1242, 375), (1224, 370), (1238, 374), (1241, 376), (1226, 370),
                  (1242, 375), (1224, 370), (1238, 374))
KITTI_BEAMS, KITTI_AZIMUTHS = 64, 1900  # an HDL-64E sweep: 121600 rays
KITTI_ELEVATION_DEG = (2.0, -24.8)  # its vertical field of view
KITTI_LIDAR_HEIGHT = 1.73  # metres above the road
KITTI_OBJECTS = 40  # planted boxes a frame, ahead of the car
# P2 of three KITTI drives (2011_09_26, 2011_09_28, 2011_10_03): focal length,
# principal point and the baseline column (the colour camera sits about 6 cm
# from the reference camera, so the camera translation is not zero)
KITTI_P2 = (
    ((721.5377, 0.0, 609.5593, 44.85728), (0.0, 721.5377, 172.854, 0.2163791),
     (0.0, 0.0, 1.0, 0.002745884)),
    ((707.0493, 0.0, 604.0814, 45.75831), (0.0, 707.0493, 180.5066, -0.3454157),
     (0.0, 0.0, 1.0, 0.004981016)),
    ((718.856, 0.0, 607.1928, 45.38225), (0.0, 718.856, 185.2157, -0.1130887),
     (0.0, 0.0, 1.0, 0.003779761)),
)
KITTI_PIXEL_ATOL = 1e-2  # the calibration chain on the card vs the f64 host chain, px


def _kitti_calib_txt(p2) -> str:
    """A calib file of KITTI's layout and magnitudes with exact rotations
    (R0_rect a rotation of about a degree; Tr_velo_to_cam the axes swap
    with a small rotation and KITTI's translation)."""
    from scipy.spatial.transform import Rotation

    r0 = Rotation.from_euler("xyz", [0.0079, -0.0098, 0.0107]).as_matrix()
    swap = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    v2c = np.concatenate([Rotation.from_euler("xyz", [0.0021, -0.0104, 0.0073]).as_matrix()
                          @ swap, np.array([[-0.0040698], [-0.0763162], [-0.2717806]])], 1)

    def fmt(m):
        return " ".join(repr(float(v)) for v in np.asarray(m).ravel())

    return "".join(f"P{i}: {fmt(p2)}\n" for i in range(4)) + (
        f"R0_rect: {fmt(r0)}\nTr_velo_to_cam: {fmt(v2c)}\n"
        f"Tr_imu_to_velo: {fmt(np.eye(3, 4))}\n")


def fabricate_kitti(torch, root, mask_dir, n_frames, seed=0):
    """A KITTI root at real geometry in `root/training` and the mask
    artifacts of its objects in `mask_dir` (scene "kitti"): a 64 x 1900
    velodyne sweep cast on the card against the road, a ring of walls 70 m
    out and KITTI_OBJECTS boxes ahead (every ray returns: about 120k points,
    under KITTI_LIFT's 131072), calib txts of three drives, image_2 PNGs at
    KITTI's mixed native sizes, label_2 with the boxes (their 2D boxes
    projected and clipped to the frame), and a mask a box on the 1024 x 320
    canvas (the ellipse of its projection)."""
    from PIL import Image

    from cm3d_tpu_torch.config import KITTI_LIFT, SHAPE_PRIORS_CHATGPT
    from cm3d_tpu_torch.datasets.artifacts import FrameMasks, MaskArtifactStore
    from cm3d_tpu_torch.datasets.kitti.calib import (
        Calibration, Object3d, compute_box_3d, write_label)
    from cm3d_tpu_torch.datasets.kitti.frontend import (
        _project_clipped_box2d, velo_yaw_to_kitti_ry)
    from cm3d_tpu_torch.vocab import NUSC_TO_KITTI

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    split = os.path.join(root, "training")
    for sub in ("calib", "velodyne", "image_2", "label_2"):
        os.makedirs(os.path.join(split, sub), exist_ok=True)
    store = MaskArtifactStore(mask_dir)
    elev = np.deg2rad(np.linspace(*KITTI_ELEVATION_DEG, KITTI_BEAMS))
    az = np.linspace(-np.pi, np.pi, KITTI_AZIMUTHS, endpoint=False)
    te, ta = torch.as_tensor(elev, device=dev), torch.as_tensor(az, device=dev)
    dirs = torch.stack([torch.cos(te)[:, None] * torch.cos(ta)[None],
                        torch.cos(te)[:, None] * torch.sin(ta)[None],
                        torch.sin(te)[:, None].expand(-1, len(az))], -1).reshape(-1, 3).float()
    # background: the road below the sensor, walls on a 70 m circle
    horiz = dirs[:, :2].norm(dim=1).clamp(min=1e-6)
    bg = torch.minimum(torch.where(dirs[:, 2] < -1e-3, KITTI_LIDAR_HEIGHT / -dirs[:, 2],
                                   torch.full_like(horiz, 1e9)), 70.0 / horiz)
    names = ("car", "pedestrian", "car", "bicycle", "truck")
    mw, mh = 1024, 320  # the KITTI frontend's mask canvas
    xs, ys = np.arange(mw)[:, None], np.arange(mh)[None, :]
    for f in range(n_frames):
        p2 = KITTI_P2[f % len(KITTI_P2)]
        calib_path = os.path.join(split, "calib", f"{f:06d}.txt")
        with open(calib_path, "w") as fh:
            fh.write(_kitti_calib_txt(p2))
        cal = Calibration(calib_path)
        img_w, img_h = KITTI_IMAGE_WH[f % len(KITTI_IMAGE_WH)]
        objects = []
        for j in range(KITTI_OBJECTS):
            name = names[j % len(names)]
            w, l, h = SHAPE_PRIORS_CHATGPT[name]
            yaw_dir, dist = rng.uniform(-0.7, 0.7), rng.uniform(5.0, 55.0)
            center = np.array([dist * np.cos(yaw_dir), dist * np.sin(yaw_dir),
                               h / 2 - KITTI_LIDAR_HEIGHT])
            objects.append((name, center, (w, l, h), rng.uniform(-np.pi, np.pi)))
        best = bg.clone()
        for _, center, (w, l, h), yaw in objects:
            rot = torch.as_tensor(_rotz(-yaw), device=dev, dtype=torch.float32)
            o = rot @ -torch.as_tensor(center, device=dev, dtype=torch.float32)
            d = dirs @ rot.T
            half = torch.as_tensor([l / 2, w / 2, h / 2], device=dev)
            inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
            t1, t2 = (-half - o) * inv, (half - o) * inv
            t_near, t_far = torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)
            hit = (t_near <= t_far) & (t_near > 0)
            best = torch.where(hit, torch.minimum(best, t_near), best)
        pts = (dirs * best[:, None]).cpu().numpy()
        raw = np.concatenate([pts, rng.random((len(pts), 1))], 1).astype(np.float32)
        raw.tofile(os.path.join(split, "velodyne", f"{f:06d}.bin"))

        a, b, k = cal.rect_chain()
        ksc = k * KITTI_LIFT.image_ratio
        ksc[2, 2] = 1.0
        labels, scores, masks, gts = [], [], [], []
        for name, center, (w, l, h), yaw in objects:
            rect = cal.project_velo_to_rect(center[None])[0]
            ry = velo_yaw_to_kitti_ry(yaw)
            alpha = (ry - np.arctan2(rect[0], rect[2]) + np.pi) % (2 * np.pi) - np.pi
            gt = Object3d(NUSC_TO_KITTI[name], 0.0, 0, float(alpha), np.zeros(4), h, w, l,
                          (float(rect[0]), float(rect[1] + h / 2), float(rect[2])), ry)
            corners = compute_box_3d(gt)
            gt.box2d = _project_clipped_box2d(cal, corners, (img_w, img_h))
            if gt.box2d[3] <= gt.box2d[1]:
                continue  # not in the frame
            gts.append(gt)
            # the mask: the ellipse of the box's projection on the canvas
            velo = cal.project_rect_to_velo(corners)
            cam = velo @ a.T + b
            uvw = cam @ ksc.T
            u, v = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
            u0, u1 = np.clip([u.min(), u.max()], 0, mw - 1)
            v0, v1 = np.clip([v.min(), v.max()], 0, mh - 1)
            if u1 - u0 < 3 or v1 - v0 < 3:
                continue
            cu, cv, ru, rv = (u0 + u1) / 2, (v0 + v1) / 2, (u1 - u0) / 2, (v1 - v0) / 2
            masks.append((((xs - cu) / ru) ** 2 + ((ys - cv) / rv) ** 2 <= 1.0).astype(np.uint8))
            labels.append(name)
            scores.append(float(rng.uniform(0.3, 1.0)))
        write_label(os.path.join(split, "label_2", f"{f:06d}.txt"), gts)
        store.write_frame("kitti", f, FrameMasks(labels, scores, [0] * len(labels),
                                                 np.stack(masks)))
        grad = np.add.outer(np.arange(img_h) * 0.3, np.arange(img_w) * 0.1) % 200 + 30
        Image.fromarray(np.repeat(grad[..., None], 3, -1).astype(np.uint8)).save(
            os.path.join(split, "image_2", f"{f:06d}.png"), compress_level=1)
    store.mark_scene_complete("kitti", n_frames)


def kitti_phase(torch, batches: dict) -> dict:
    """The KITTI path on the card at real geometry (fabricate_kitti): the
    calibration chain (the frontend's keyframes projected on the card)
    against the CPU and the f64 host chain; B1 / B2 held to their plain
    versions on a batch-8 KITTI step's inputs (camera stage R = 8); the step
    counted and timed; 2 keyframes against the CPU lift; run_lift_kitti
    counted and its pred/ scored by eval/kitti.py against label_2;
    run_e2e_kitti on the tiny models over the mixed frame sizes; B3 at full
    width at the KITTI frame's 8 shapes (window_attn_phase) and
    run_e2e_kitti at full width, counted and timed; one KITTI frame encoded
    with SAM's windowed blocks fused against unfused (28 + 28 launches) and
    B4 held to its plain version at that grid."""
    import tempfile

    from PIL import Image

    from cm3d_tpu_torch.benchmarks import build_production_fake_models
    from cm3d_tpu_torch.config import KITTI_LIFT
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.kitti.calib import read_label
    from cm3d_tpu_torch.datasets.kitti.frontend import KittiFrontend
    from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes, to_device
    from cm3d_tpu_torch.eval.kitti import evaluate_kitti, format_results, load_frames
    from cm3d_tpu_torch.geometry.pointcloud import project_to_camera
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.kernels.window_attn_relpos import (
        window_attn_relpos_heads, window_attn_relpos_proj)
    from cm3d_tpu_torch.models.swin import SWIN_TEST
    from cm3d_tpu_torch.pipelines.e2e import kitti_canvas_wh, run_e2e_kitti
    from cm3d_tpu_torch.pipelines.lift_kitti import make_kitti_step_fn, run_lift_kitti
    from cm3d_tpu_torch.pipelines.masks import build_fake_models

    dev = torch.device("cuda")
    lift_kernels = (compact_rows, medoid_distance_sums_rows)
    swin_kernels = (window_attn_heads, window_attn_proj)
    relpos_kernels = (window_attn_relpos_heads, window_attn_relpos_proj)

    def counts(fns):
        return {fn.__name__: fn.launches for fn in fns}

    def reset(fns):
        for fn in fns:
            fn.launches = 0

    out = {"config": "KITTI_LIFT, batch 8, one camera, 64 x 1900 velodyne sweep, image_2 at "
                     f"{sorted(set(KITTI_IMAGE_WH))}, mask canvas 1024 x 320"}
    with tempfile.TemporaryDirectory() as tmp:
        root, mask_dir = os.path.join(tmp, "kitti"), os.path.join(tmp, "masks")
        t0 = time.perf_counter()
        fabricate_kitti(torch, root, mask_dir, KITTI_FRAMES)
        out["fabricate_s"] = time.perf_counter() - t0
        indices = list(range(KITTI_FRAMES))

        # the frontend, and its calibration chain on the card against the
        # CPU and against the f64 host chain (P2 R0 Tr_velo_to_cam x ratio)
        fe = KittiFrontend(root, MaskArtifactStore(mask_dir), KITTI_LIFT)
        t0 = time.perf_counter()
        built = list(fe.iter_frames(indices))
        out["frontend_s_per_frame"] = (time.perf_counter() - t0) / len(built)
        check(len(built) == KITTI_FRAMES, f"{KITTI_FRAMES} KITTI keyframes built")
        out["points_per_keyframe"] = [int(kf.point_valid.sum()) for kf, _ in built]
        check(all(100_000 < n < KITTI_LIFT.max_points for n in out["points_per_keyframe"]),
              f"about 120k points a sweep, under the cap: {out['points_per_keyframe']}")
        host = stack_keyframes([kf for kf, _ in built])
        batches["kitti"] = host.frames  # phase 19's KITTI lift artifact
        frames = to_device(host.frames, dev)
        cpu_frames = to_device(host.frames, "cpu")
        pix = {}
        for name, fr in (("card", frames), ("cpu", cpu_frames)):
            cams = fr.cameras
            uv, depth = project_to_camera(fr.points[..., :3][:, None], cams.ego_translation,
                                          cams.ego_rotation, cams.cam_translation,
                                          cams.cam_rotation, cams.intrinsics)
            pix[name] = (uv[:, 0, :, :2].cpu().double(), depth[:, 0].cpu().double())
        err_cpu, err_f64 = 0.0, 0.0
        for i, (kf, idx) in enumerate(built):
            uv64 = fe.dataset.get_calibration(idx).project_velo_to_image(
                kf.points[:, :3].astype(np.float64)) * KITTI_LIFT.image_ratio
            front = (pix["card"][1][i] > KITTI_LIFT.min_dist).numpy()
            inside = front & (uv64[:, 0] > 0) & (uv64[:, 0] < 1024) & (uv64[:, 1] > 0) & (
                uv64[:, 1] < 320)
            err_cpu = max(err_cpu, float((pix["card"][0][i] - pix["cpu"][0][i])[inside].abs()
                                         .max()))
            err_f64 = max(err_f64, float(np.abs(pix["card"][0][i].numpy()[inside]
                                                - uv64[inside]).max()))
        out["pixels_card_vs_cpu_max_abs_err"] = err_cpu
        out["pixels_card_vs_f64_max_abs_err"] = err_f64
        check(err_f64 <= KITTI_PIXEL_ATOL and err_cpu <= KITTI_PIXEL_ATOL,
              f"KITTI projection on the card within {KITTI_PIXEL_ATOL} px of the CPU's "
              f"({err_cpu:.3g}) and of the f64 calibration chain ({err_f64:.3g})")
        del pix

        # B1 / B2 at KITTI's shapes (one camera: the camera stage has R = 8
        # rows), the step counted and timed, 2 keyframes against the CPU lift
        out.update(dataset_step_phase(
            torch, "KITTI", make_kitti_step_fn(KITTI_LIFT, device=dev),
            make_kitti_step_fn(KITTI_LIFT, device="cpu"),
            frames, map_fields(lambda x: x[:2], cpu_frames), KITTI_FRAMES,
            lambda res: res[1]))
        del cpu_frames

        # run_lift_kitti end to end, counted, then its pred/ scored
        reset(lift_kernels)
        pred_dir = os.path.join(tmp, "lift")
        t0 = time.perf_counter()
        n_boxes = run_lift_kitti(root, mask_dir, indices, pred_dir, batch_size=KITTI_FRAMES,
                                 verbose=False, device=dev)
        out["run_lift_kitti_s"] = time.perf_counter() - t0
        out["run_lift_kitti_launches"] = counts(lift_kernels)
        check(n_boxes > 0 and out["run_lift_kitti_launches"] == {
            "compact_rows": 3, "medoid_distance_sums_rows": 1},
            f"run_lift_kitti: {n_boxes} boxes, launches {out['run_lift_kitti_launches']}")
        out["boxes"] = n_boxes
        gt_frames, det_frames, ids = load_frames(os.path.join(root, "training", "label_2"),
                                                 os.path.join(pred_dir, "pred"))
        ap = evaluate_kitti(gt_frames, det_frames)
        print(format_results(ap), flush=True)
        values = [v for cls in ap.values() for met in cls.values() if isinstance(met, dict)
                  for v in met.values()]
        check(len(ids) == KITTI_FRAMES and values and all(np.isfinite(values))
              and all(0.0 <= v <= 1.0 for v in values),
              f"KITTI AP table finite and in [0, 1] over {len(ids)} frames")
        out["ap"] = ap
        out["gt_objects"] = sum(len(f) for f in gt_frames)

        # the fused path on the tiny models over the mixed frame sizes
        thumbs = []
        for idx in indices:
            im = Image.open(fe.dataset.get_image_path(idx)).convert("RGB")
            im.thumbnail((1024, 1024))
            thumbs.append(im.size)
        out["thumbnails_wh"] = thumbs
        check(len({h for _, h in thumbs}) == 2 and kitti_canvas_wh(1024) == (1024, 320),
              f"KITTI's thumbnails change height from frame to frame ({thumbs}), "
              f"the canvas is pinned at 1024 x 320")
        models = build_fake_models(device=dev)
        reset(lift_kernels + swin_kernels)
        t0 = time.perf_counter()
        n = run_e2e_kitti(root, indices, os.path.join(tmp, "fused"), models, batch_size=4,
                          verbose=False, device=dev)
        torch.cuda.synchronize()
        out["fused_s"] = time.perf_counter() - t0
        out["fused_frames_lifted"] = n
        out["fused_launches"] = counts(lift_kernels + swin_kernels)
        blocks, steps = sum(SWIN_TEST.depths) * KITTI_FRAMES, -(-n // 4)
        check(out["fused_launches"] == {"compact_rows": 3 * steps,
                                        "medoid_distance_sums_rows": steps,
                                        "window_attn_heads": blocks, "window_attn_proj": blocks},
              f"fused KITTI: {blocks} + {blocks} window-attention launches over the mixed "
              f"sizes, 3 + 1 a lift step ({steps} steps): {out['fused_launches']}")
        del models

        # B3 at full width at the KITTI frame's 8 (stage, shift) shapes
        prod = build_production_fake_models("bfloat16", device=dev)
        im = Image.open(fe.dataset.get_image_path(0)).convert("RGB")
        im.thumbnail((1024, 1024))
        frame = prod.prepare([np.asarray(im)])
        captured = capture_window_attn_inputs(torch, lambda: prod.detic(frame))
        stage0 = tuple(captured[0][1][0].shape)
        check(stage0 == (1, 80, 256, 128),
              f"Swin-B's first stage on a KITTI frame (320 x 1024 padded): {stage0}")
        out["full_width_window_attn"] = [
            {"channels": r["channels"], "shift": r["shift"], "shape": r["shape"],
             "blocks_per_forward": r["blocks_per_forward"], "max_rel_err": r["max_rel_err"],
             "f32_max_abs_err": r["f32_max_abs_err"],
             **{f"{k}_{f}": r[k][f] for k in ("heads", "proj")
                for f in ("ms", "plain_ms", "bound_ms")}}
            for r in window_attn_phase(torch, captured)]
        del captured

        # the fused KITTI path at full width (Swin-B + ViT-H, unfused SAM),
        # counted and timed (first calls at these shapes included)
        reset(lift_kernels + swin_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_full = run_e2e_kitti(root, indices, os.path.join(tmp, "full"), prod, batch_size=4,
                               verbose=False, device=dev)
        torch.cuda.synchronize()
        out["full_width_fused_s"] = time.perf_counter() - t0
        out["full_width_fused_s_per_keyframe"] = out["full_width_fused_s"] / KITTI_FRAMES
        out["full_width_fused_launches"] = counts(lift_kernels + swin_kernels)
        out["full_width_frames_lifted"] = n_full
        blocks, steps = SWIN_BLOCKS_PER_FORWARD * KITTI_FRAMES, -(-n_full // 4)
        check(n_full > 0 and out["full_width_fused_launches"] == {
            "compact_rows": 3 * steps, "medoid_distance_sums_rows": steps,
            "window_attn_heads": blocks, "window_attn_proj": blocks},
            f"full-width fused KITTI: {n_full} frames lifted, {blocks} + {blocks} "
            f"window-attention launches, 3 + 1 a lift step: {out['full_width_fused_launches']}")
        objs = [o for idx in indices
                for o in read_label(os.path.join(tmp, "full", "pred", f"{idx:06d}.txt"))]
        out["full_width_boxes"] = len(objs)
        check(all(np.isfinite([*o.t, o.h, o.w, o.l, o.ry, o.alpha, *o.box2d, o.score]).all()
                  for o in objs), "full-width fused KITTI boxes are finite")

        # one KITTI frame through ViT-H with SAM's windowed blocks fused
        # (the same weights) against unfused, and B4 at that grid
        emb_u = prod.sam_encode(frame).float()
        del prod
        torch.cuda.empty_cache()
        fused = build_production_fake_models("bfloat16", device=dev, fused_window_attn=True)
        reset(relpos_kernels)
        emb_f = fused.sam_encode(frame).float()
        torch.cuda.synchronize()
        out["fused_encode_launches"] = counts(relpos_kernels)
        check(out["fused_encode_launches"] == {"window_attn_relpos_heads": SAM_WINDOWED_BLOCKS,
                                               "window_attn_relpos_proj": SAM_WINDOWED_BLOCKS},
              f"one fused ViT-H encode of a KITTI frame: 28 + 28 rel-pos launches, got "
              f"{out['fused_encode_launches']}")
        diff, scale = float((emb_f - emb_u).abs().max()), float(emb_u.abs().max())
        out["encode_ab"] = {"max_abs_diff": diff, "max_abs_unfused": scale,
                            "tolerance": ENCODE_AB_TOL * scale}
        check(bool(torch.isfinite(emb_f).all()) and diff <= ENCODE_AB_TOL * scale,
              f"fused vs unfused ViT-H embeddings of a KITTI frame differ by {diff:.3g} > "
              f"2^-4 x {scale:.3g}")
        del emb_u, emb_f
        x, params, kw = capture_relpos_inputs(torch, fused, frame, n_cameras=1)
        check(tuple(x.shape) == (1, 64, 64, 1280), f"SAM's square grid, got {tuple(x.shape)}")
        _, errs, err32 = relpos_check(torch, x, params, kw, "KITTI square")
        out["relpos"] = {"shape": list(x.shape), "max_rel_err": errs["branch"][1],
                         "max_abs_err": errs["branch"][0], "f32_max_abs_err": err32}
        del fused, frame, x, params
    out["card"] = card_line()
    print(f"kitti ({out['card']}): fabricate {out['fabricate_s']:.2f} s, frontend "
          f"{out['frontend_s_per_frame']:.3f} s a frame, points {out['points_per_keyframe']}; "
          f"projection card vs CPU {out['pixels_card_vs_cpu_max_abs_err']:.3g} px, vs the f64 "
          f"chain {out['pixels_card_vs_f64_max_abs_err']:.3g} px; B1 stages "
          f"{out['compaction_shapes']} bit-exact; B2 {out['medoid']}; step "
          f"{out['ms_per_step']:.3f} ms ({out['keyframes_per_s']:.1f} keyframes/s), launches a "
          f"step {out['launches_per_step']}, cam_truncated {out['cam_truncated']}, masks "
          f"truncated {out['mask_truncated']}; CPU check: {out['medoids_differing']} medoids "
          f"differ ({out['near_tie_rows']} near-tie rows allowed to); run_lift_kitti "
          f"{out['run_lift_kitti_s']:.2f} s, {out['boxes']} boxes ({out['gt_objects']} GT "
          f"objects); thumbnails {out['thumbnails_wh']}; fused path (tiny) "
          f"{out['fused_s']:.2f} s, {out['fused_frames_lifted']} frames lifted, launches "
          f"{out['fused_launches']}; full width {out['full_width_fused_s']:.2f} s "
          f"({out['full_width_fused_s_per_keyframe']:.3f} s a keyframe), "
          f"{out['full_width_frames_lifted']} frames lifted, {out['full_width_boxes']} boxes, "
          f"launches {out['full_width_fused_launches']}; fused encode "
          f"{out['fused_encode_launches']}, embeddings differ by {out['encode_ab']['max_abs_diff']:.4g} "
          f"(tolerance {out['encode_ab']['tolerance']:.4g}); B4 at the KITTI grid "
          f"{out['relpos']}", flush=True)
    torch.cuda.empty_cache()
    return out


# --- 18. data parallelism at world size 1 --------------------------------------

DATA_PARALLEL_FLAG = "--data-parallel-phase"  # the child process of phase 18
DP_TRAIN_SAMPLES = 8  # one batch-8 step a sample set
DP_TRAIN_STEPS = 3
DP_SWEEP_POINTS = 40000  # a LIDAR_TOP sweep; the 32768-point training cap binds
DP_TRAIN_BOXES = 64  # pseudo-labels a sample (run_pretrain's box cap)
# the first training step through the group against the plain step, from the
# same weights: the loss, relative
DP_TRAIN_RTOL = 1e-5
# ... and the gradient vector, in norm, relative: the global BatchNorm's
# two-pass statistics against cuDNN's (PyTorch runs cuDNN's persistent mode on
# channels-last maps in training, which reduces in scaled integers); a
# BatchNorm bias's gradient is a small difference of large terms and carries
# the two roundings at those terms' scale. The card-against-CPU tolerance of
# phase 13 (TRAIN_GRAD_TOL)
DP_GRAD_RTOL = TRAIN_GRAD_TOL
# run_pretrain's losses after DP_TRAIN_STEPS steps, relative: AdamW divides each
# element's step by its own gradient's RMS, and a BatchNorm bias's gradient is
# a small difference of large terms, so the formulas' rounding (1e-7 of those
# terms) moves such elements by a fraction of a step, and the loss with them
DP_TRAJECTORY_RTOL = 1e-3
DP_TURNS, DP_STEPS_A_TURN = 3, 5  # step timing: plain and data-parallel in turns
DP_VERSION = "v1.0-dp"


def fabricate_nuscenes_lidar(root, n_samples, n_points, n_boxes, seed=0) -> str:
    """A nuScenes dataroot of one scene with LIDAR_TOP keyframes only (the
    tables run_pretrain and run_detect read), each sweep `n_points` points
    spread as bench_train's over the pillar grid, and a pseudo-label
    submission of `n_boxes` boxes a sample; returns the labels' path."""
    from cm3d_tpu_torch.config import NUSCENES_CLASSES

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, DP_VERSION), exist_ok=True)
    os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)
    tok = [f"{seed:04d}{i:028x}" for i in range(4 * n_samples + 8)]
    samples = [tok[i] for i in range(n_samples)]
    sds = [tok[n_samples + i] for i in range(n_samples)]
    poses = [tok[2 * n_samples + i] for i in range(n_samples)]
    cs, log, scene = tok[-1], tok[-2], tok[-3]
    nxt = lambda ts, i: ts[i + 1] if i + 1 < n_samples else ""  # noqa: E731
    prv = lambda ts, i: ts[i - 1] if i > 0 else ""  # noqa: E731
    tables = {
        "attribute": [],
        "calibrated_sensor": [{"token": cs, "sensor_token": tok[-4], "translation": [0, 0, 0],
                               "rotation": [1, 0, 0, 0], "camera_intrinsic": []}],
        "log": [{"token": log, "location": "singapore-onenorth"}],
        "scene": [{"token": scene, "name": "scene-0001", "log_token": log,
                   "first_sample_token": samples[0], "last_sample_token": samples[-1],
                   "nbr_samples": n_samples}],
        "ego_pose": [], "sample": [], "sample_data": []}
    results = {}
    for i in range(n_samples):
        ts = 1_000_000 * (i + 1)
        ego = [10.0 * i, -3.0 * i, 0.0]
        pts = np.empty((n_points, 5), np.float32)
        pts[:, 0] = rng.uniform(-51.2, 51.2, n_points)
        pts[:, 1] = rng.uniform(-51.2, 51.2, n_points)
        pts[:, 2] = rng.uniform(-2.0, 1.0, n_points)
        pts[:, 3] = rng.uniform(0.0, 1.0, n_points)
        pts[:, 4] = 0.0
        pts.tofile(os.path.join(root, "sweeps", f"lidar_{i}.bin"))
        tables["ego_pose"].append({"token": poses[i], "timestamp": ts, "translation": ego,
                                   "rotation": [1, 0, 0, 0]})
        tables["sample"].append({"token": samples[i], "timestamp": ts, "scene_token": scene,
                                 "next": nxt(samples, i), "prev": prv(samples, i),
                                 "data": {"LIDAR_TOP": sds[i]}})
        tables["sample_data"].append({
            "token": sds[i], "sample_token": samples[i], "ego_pose_token": poses[i],
            "calibrated_sensor_token": cs, "timestamp": ts, "fileformat": "bin",
            "is_key_frame": True, "filename": f"sweeps/lidar_{i}.bin", "channel": "LIDAR_TOP",
            "next": nxt(sds, i), "prev": prv(sds, i)})
        boxes = []
        for _ in range(n_boxes):
            yaw = rng.uniform(-np.pi, np.pi)
            boxes.append({
                "sample_token": samples[i],
                "translation": [ego[0] + rng.uniform(-45, 45), ego[1] + rng.uniform(-45, 45),
                                rng.uniform(-1.0, 0.5)],
                "size": [float(v) for v in rng.uniform(0.5, 4.5, 3)],
                "rotation": [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))],
                "velocity": [0.0, 0.0],
                "detection_name": NUSCENES_CLASSES[int(rng.integers(len(NUSCENES_CLASSES)))],
                "detection_score": float(rng.uniform(0.3, 1.0)), "attribute_name": ""})
        results[samples[i]] = boxes
    for name, rows in tables.items():
        with open(os.path.join(root, DP_VERSION, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    labels = os.path.join(root, "labels.json")
    with open(labels, "w") as f:
        json.dump({"meta": {}, "results": results}, f)
    return labels


def _tensors_equal(torch, a, b) -> bool:
    from cm3d_tpu_torch.parallel.mesh import _flatten

    _, la = _flatten(a)
    _, lb = _flatten(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _in_turns(torch, device, runs: dict) -> dict:
    """ms a call of each of `runs` (name -> zero-argument call), timed in
    DP_TURNS turns of DP_STEPS_A_TURN calls, one after another in each
    turn: the spread of each is the spread over its turns."""
    times = {name: [] for name in runs}
    for _ in range(DP_TURNS):
        for name, fn in runs.items():
            fn()
            _sync(torch, device)
            t0 = time.perf_counter()
            for _ in range(DP_STEPS_A_TURN):
                fn()
            _sync(torch, device)
            times[name].append((time.perf_counter() - t0) * 1e3 / DP_STEPS_A_TURN)
    return {f"{name}_ms": ts for name, ts in times.items()}


def _dp_lift_step(torch, name: str, step, frames, batch: int) -> dict:
    """One batch-major lift step with and without the world-size-1 group:
    equal outputs, 3 + 1 launches through the group, ms a step in turns."""
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.parallel import dp_step

    device = step.device
    want = step(frames)
    with dp_step(step, batch, 1) as dp:
        compact_rows.launches = medoid_distance_sums_rows.launches = 0
        got = dp(frames)
        _sync(torch, device)
        launches = {"compact_rows": compact_rows.launches,
                    "medoid_distance_sums_rows": medoid_distance_sums_rows.launches}
        check(_tensors_equal(torch, got, want),
              f"{name}: the data-parallel step's outputs equal the plain step's")
        if device.type == "cuda":
            check(launches == {"compact_rows": 3, "medoid_distance_sums_rows": 1},
                  f"{name}: 3 + 1 launches a data-parallel step, got {launches}")
        out = {"launches": launches,
               **_in_turns(torch, device, {"plain": lambda: step(frames),
                                           "data_parallel": lambda: dp(frames)})}
    print(f"{name} step at batch {batch}: plain {out['plain_ms']} ms, data-parallel "
          f"(world size 1) {out['data_parallel_ms']} ms", flush=True)
    return out


def _first_gradients(torch, step, state, batch, data_parallel: bool):
    """(loss, {name: gradient}) of a train step's loss at `state`, without
    applying them; inside the global batch for the data-parallel step."""
    import contextlib

    from cm3d_tpu_torch.parallel.mesh import global_batch

    with global_batch() if data_parallel else contextlib.nullcontext():
        loss, _ = step.loss_fn(batch)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names])
    return float(loss.detach()), dict(zip(names, grads))


def _max_abs(torch, a: dict, b: dict) -> float:
    """Largest |a - b| over the tensors of two nested dicts."""
    worst = 0.0
    for k, v in a.items():
        if isinstance(v, dict):
            worst = max(worst, _max_abs(torch, v, b[k]))
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            worst = max(worst, float((v - b[k]).abs().max()))
    return worst


def _max_rel(torch, a: dict, b: dict) -> float:
    """Largest max|a - b| / max|b| over the tensors of two nested dicts."""
    worst = 0.0
    for k, v in a.items():
        if isinstance(v, dict):
            worst = max(worst, _max_rel(torch, v, b[k]))
        elif isinstance(v, torch.Tensor) and v.is_floating_point():
            scale = float(b[k].abs().max())
            worst = max(worst, float((v - b[k]).abs().max()) / max(scale, 1e-30))
    return worst


def data_parallel_phase(torch, device="cuda", lift_cfg=None, syn_cfg=None, pillar_cfg=None,
                        model_cfg=None, batch: int = 8, datasets=("Waymo", "KITTI")) -> dict:
    """Phase 18: every data-parallel path at world size 1 (NCCL on the card,
    gloo on the CPU): the scatter, the gather and every collective of a
    step run, and each result must equal the plain run's."""
    import tempfile

    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
    from cm3d_tpu_torch.kernels.segment import segment_sum_max
    from cm3d_tpu_torch.models.checkpoints import load_params
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.parallel.mesh import Program, dp_mesh
    from cm3d_tpu_torch.pipelines import pretrain
    from cm3d_tpu_torch.pipelines.detect import run_detect
    from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig

    device = torch.device(device)
    lift_cfg = lift_cfg or LiftStageConfig()
    pillar_cfg = pillar_cfg or PillarConfig()
    model_cfg = model_cfg or CenterPointConfig()
    out = {"card": card_line() if device.type == "cuda" else "cpu"}

    # the nuScenes lift step at production geometry (bench_lift's keyframes)
    rng = np.random.default_rng(0)
    host = stack_keyframes([make_keyframe(syn_cfg or SyntheticConfig(), lift_cfg, rng)
                            for _ in range(batch)])
    out["nuscenes_step"] = _dp_lift_step(
        torch, "nuScenes", make_keyframe_step_fn(lift_cfg, device=device),
        to_device(host.frames, device), batch)
    del host

    with tempfile.TemporaryDirectory() as tmp:
        if "Waymo" in datasets:
            out["waymo"] = _dp_waymo(torch, device, tmp)
        if "KITTI" in datasets:
            out["kitti"] = _dp_kitti(torch, device, tmp)

        # training at bench_train's width: run_pretrain and run_detect with
        # and without data_parallel=1
        root = os.path.join(tmp, "nusc")
        labels = fabricate_nuscenes_lidar(root, DP_TRAIN_SAMPLES, DP_SWEEP_POINTS,
                                          DP_TRAIN_BOXES)
        kw = dict(steps=DP_TRAIN_STEPS, batch_size=batch, verbose=False,
                  pillar_cfg=pillar_cfg, model_cfg=model_cfg, device=device)
        metrics = {}
        for tag, n in (("plain", 0), ("data_parallel", 1)):
            segment_sum_max.launches = 0
            t0 = time.perf_counter()
            metrics[tag] = pretrain.run_pretrain(root, DP_VERSION, labels,
                                                 os.path.join(tmp, tag), data_parallel=n, **kw)
            out[f"run_pretrain_{tag}_s"] = time.perf_counter() - t0
            out[f"run_pretrain_{tag}_segment_sum_max_launches"] = segment_sum_max.launches
        loss_rel = max(abs(metrics["data_parallel"][k] - v) / max(abs(v), 1e-30)
                       for k, v in metrics["plain"].items())
        params = {tag: load_params(os.path.join(tmp, tag, "centerpoint")) for tag in metrics}
        out.update(train_metrics=metrics, loss_max_rel_err=loss_rel,
                   params_max_rel_err=_max_rel(torch, params["data_parallel"], params["plain"]),
                   params_max_abs_err=_max_abs(torch, params["data_parallel"],
                                               params["plain"]))
        check(all(np.isfinite(v) for m in metrics.values() for v in m.values())
              and loss_rel <= DP_TRAJECTORY_RTOL,
              f"run_pretrain data-parallel vs plain after {DP_TRAIN_STEPS} steps: losses "
              f"{loss_rel:.3g} relative (<= {DP_TRAJECTORY_RTOL}); parameters "
              f"{out['params_max_abs_err']:.3g} apart at most")
        if device.type == "cuda":
            got = out["run_pretrain_data_parallel_segment_sum_max_launches"]
            check(got == DP_TRAIN_STEPS,
                  f"1 segment_sum_max launch a data-parallel training step, got {got}")
        subs = {tag: run_detect(root, DP_VERSION, os.path.join(tmp, "plain", "centerpoint"),
                                os.path.join(tmp, f"det_{tag}.json"), batch_size=batch,
                                score_thresh=0.0, pillar_cfg=pillar_cfg, model_cfg=model_cfg,
                                verbose=False,
                                data_parallel=n, device=device)
                for tag, n in (("plain", 0), ("data_parallel", 1))}
        n_boxes = sum(len(v) for v in subs["plain"]["results"].values())
        check(subs["data_parallel"]["results"] == subs["plain"]["results"] and n_boxes > 0,
              f"run_detect data-parallel keeps the plain run's {n_boxes} boxes")
        out["detect_boxes"] = n_boxes

        # a training step with and without the group, in turns, on bench_train's batch
        from cm3d_tpu_torch.benchmarks import train_bench_setup

        step, state, tbatch = train_bench_setup(batch, device=device, pillar_cfg=pillar_cfg,
                                                model_cfg=model_cfg)
        setup = pretrain.TrainSetup(
            seed=0, pillar_cfg=pillar_cfg, model_cfg=model_cfg, fusion_cfg=None,
            image_hw=(0, 0), n_cams=0, learning_rate=1e-3, steps=0, lr_schedule="const",
            warmup_steps=0, grad_clip=None, ema_decay=0.0, augment=False, data_parallel=True)
        dp_state, dp_step_fn, _ = pretrain.build_training(setup, device)
        with dp_mesh(1, batch, device, Program("cm3d_tpu_torch.pipelines.pretrain:"
                                               "data_parallel_train_program", (setup,))) as g:
            pretrain.broadcast_state(dp_state)
            # the first step's loss and gradients, from the same weights
            want_loss, want = _first_gradients(torch, step, state, tbatch, False)
            got_loss, got = g.run(lambda rows: _first_gradients(torch, dp_step_fn, dp_state,
                                                                rows, True), (tbatch,),
                                  gather=False)
            diff = torch.sqrt(sum(((got[k] - v) ** 2).sum() for k, v in want.items()))
            grad_rel = float(diff / torch.sqrt(sum((v ** 2).sum() for v in want.values())))
            worst = sorted(((float((got[k] - v).abs().max() / v.abs().max()), k)
                            for k, v in want.items()), reverse=True)[:3]
            out.update(first_step_loss_rel_err=abs(got_loss - want_loss) / abs(want_loss),
                       first_step_grad_rel_err=grad_rel, first_step_worst_tensors=worst)
            check(out["first_step_loss_rel_err"] <= DP_TRAIN_RTOL and grad_rel <= DP_GRAD_RTOL,
                  f"the first data-parallel training step: loss {got_loss} against {want_loss} "
                  f"(<= {DP_TRAIN_RTOL} relative), gradients {grad_rel:.3g} apart in norm "
                  f"(<= {DP_GRAD_RTOL}); worst tensors {worst}")
            segment_sum_max.launches = 0
            g.run(lambda rows: dp_step_fn(dp_state, rows), (tbatch,), gather=False)
            _sync(torch, device)
            out["train_step_launches"] = {"segment_sum_max": segment_sum_max.launches}
            out["train_step"] = _in_turns(torch, device, {
                "plain": lambda: step(state, tbatch),
                "data_parallel": lambda: g.run(lambda rows: dp_step_fn(dp_state, rows),
                                               (tbatch,), gather=False)})
        print(f"training step at batch {batch}: plain {out['train_step']['plain_ms']} ms, "
              f"data-parallel (world size 1) {out['train_step']['data_parallel_ms']} ms "
              f"[{out['card']}]", flush=True)
    return out


def _dp_waymo(torch, device, tmp) -> dict:
    from cm3d_tpu_torch.config import WAYMO_LIFT
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
    from cm3d_tpu_torch.datasets.waymo.frontend import WaymoFrontend
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.pipelines.lift_waymo import run_lift_waymo

    frames_root, mask_dir = os.path.join(tmp, "wframes"), os.path.join(tmp, "wmasks")
    scene = fabricate_waymo(torch, frames_root, mask_dir, WAYMO_FRAMES)
    fe = WaymoFrontend(frames_root, MaskArtifactStore(mask_dir), WAYMO_LIFT, device=device)
    host = stack_keyframes([kf for kf, _ in fe.iter_scene(scene)])
    out = {"step": _dp_lift_step(torch, "Waymo", make_keyframe_step_fn(WAYMO_LIFT, device=device),
                                 to_device(host.frames, device), WAYMO_FRAMES)}
    bins = {}
    for tag, n in (("plain", 0), ("data_parallel", 1)):
        compact_rows.launches = medoid_distance_sums_rows.launches = 0
        path = os.path.join(tmp, f"{tag}.bin")
        run_lift_waymo(frames_root, mask_dir, [scene], path, batch_size=WAYMO_FRAMES,
                       verbose=False, data_parallel=n, device=device)
        out[f"run_lift_waymo_{tag}_launches"] = {
            "compact_rows": compact_rows.launches,
            "medoid_distance_sums_rows": medoid_distance_sums_rows.launches}
        bins[tag] = open(path, "rb").read()
    check(bins["data_parallel"] == bins["plain"] and len(bins["plain"]) > 0,
          "run_lift_waymo data-parallel writes the plain run's .bin byte for byte")
    check(out["run_lift_waymo_data_parallel_launches"] == {"compact_rows": 3,
                                                           "medoid_distance_sums_rows": 1},
          f"run_lift_waymo data-parallel launches {out['run_lift_waymo_data_parallel_launches']}")
    out["bin_bytes"] = len(bins["plain"])
    return out


def _dp_kitti(torch, device, tmp) -> dict:
    from cm3d_tpu_torch.config import KITTI_LIFT
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.kitti.frontend import KittiFrontend
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.pipelines.lift_kitti import make_kitti_step_fn, run_lift_kitti

    root, mask_dir = os.path.join(tmp, "kitti"), os.path.join(tmp, "kmasks")
    fabricate_kitti(torch, root, mask_dir, KITTI_FRAMES)
    indices = list(range(KITTI_FRAMES))
    fe = KittiFrontend(root, MaskArtifactStore(mask_dir), KITTI_LIFT)
    host = stack_keyframes([kf for kf, _ in fe.iter_frames(indices)])
    out = {"step": _dp_lift_step(torch, "KITTI", make_kitti_step_fn(KITTI_LIFT, device=device),
                                 to_device(host.frames, device), KITTI_FRAMES)}
    labels = {}
    for tag, n in (("plain", 0), ("data_parallel", 1)):
        compact_rows.launches = medoid_distance_sums_rows.launches = 0
        pred = os.path.join(tmp, f"kitti_{tag}")
        run_lift_kitti(root, mask_dir, indices, pred, batch_size=KITTI_FRAMES, verbose=False,
                       data_parallel=n, device=device)
        out[f"run_lift_kitti_{tag}_launches"] = {
            "compact_rows": compact_rows.launches,
            "medoid_distance_sums_rows": medoid_distance_sums_rows.launches}
        labels[tag] = {f"{kind}/{name}": open(os.path.join(pred, kind, name), "rb").read()
                       for kind in ("pred", "pseudo")
                       for name in sorted(os.listdir(os.path.join(pred, kind)))}
    check(labels["data_parallel"] == labels["plain"] and len(labels["plain"]) == 2 * KITTI_FRAMES,
          "run_lift_kitti data-parallel writes the plain run's label txts byte for byte")
    check(out["run_lift_kitti_data_parallel_launches"] == {"compact_rows": 3,
                                                           "medoid_distance_sums_rows": 1},
          f"run_lift_kitti data-parallel launches {out['run_lift_kitti_data_parallel_launches']}")
    return out


def data_parallel_phase_in_child() -> dict:
    """Run phase 18 in a child process (run_pretrain's deterministic
    algorithms want cuBLAS's workspace fixed before the process's first
    matrix product; the child also starts and ends its own NCCL groups) and
    return its results: the child prints its progress lines, then one JSON
    line, which is parsed here."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), DATA_PARALLEL_FLAG],
        env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=DETERMINISTIC_WORKSPACE),
        stdout=subprocess.PIPE, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(proc.returncode == 0 and lines, f"the data-parallel phase's process exited with "
          f"{proc.returncode}: {lines[-1] if lines else 'no output'}")
    return json.loads(lines[-1])


# --- 19. deploy and serve ------------------------------------------------------

SERVE_REQUESTS = 16  # requests a route, sent SERVE_CONCURRENCY at a time
SERVE_CONCURRENCY = 8
SERVE_CLOUD_POINTS = 20000  # points a served detect cloud (capacity 32768)
DISPATCH_CALLS = 200  # back-to-back calls a side when timing the ops' dispatch


def _launch_counts() -> dict:
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.kernels.segment import segment_sum, segment_sum_bwd, segment_sum_max
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj

    return {f.__name__: f.launches for f in (
        compact_rows, medoid_distance_sums_rows, segment_sum_max, segment_sum, segment_sum_bwd,
        window_attn_heads, window_attn_proj)}


def _launched(before: dict) -> dict:
    """The launches since `before`, by kernel, those above 0."""
    return {k: v - before[k] for k, v in _launch_counts().items() if v != before[k]}


def _save_and_load(torch, program, path) -> tuple:
    from cm3d_tpu_torch import deploy

    deploy.save_artifact(program, path)
    t0 = time.perf_counter()
    loaded = deploy.load_artifact(path)
    return loaded, {"bytes": os.path.getsize(path), "load_s": time.perf_counter() - t0}


def lift_artifact_phase(torch, name: str, cfg, host, tmp, card: str, frame=None):
    """The lift step of `cfg` exported at `host`'s batch on the card
    (`frame` fixes the per-frame shapes; None: the synthetic frame, as the
    JAX package does), saved and loaded: tracing launches nothing, a call
    of the loaded program launches 3 compactions and 1 medoid and is bit-equal
    to the in-process step on `host`, ms a step of both in turns."""
    from cm3d_tpu_torch import deploy
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn

    dev = torch.device("cuda")
    frames = to_device(host, dev)
    batch = frames.points.shape[0]
    before = _launch_counts()
    t0 = time.perf_counter()
    program = deploy.export_lift_step(cfg, batch_size=batch, device=dev, frame=frame)
    out = {"export_s": time.perf_counter() - t0}
    check(not _launched(before), f"{name}: tracing the lift step launches no kernel")
    loaded, sizes = _save_and_load(torch, program, os.path.join(tmp, f"lift_{name}.pt2"))
    out.update(sizes)
    step = make_keyframe_step_fn(cfg, device=dev)
    want = step(frames)
    before = _launch_counts()
    got = loaded.call(frames)
    _sync(torch, dev)
    out["launches_per_call"] = _launched(before)
    check(out["launches_per_call"] == {"compact_rows": 3, "medoid_distance_sums_rows": 1},
          f"{name}: the loaded lift program launches 3 + 1, got {out['launches_per_call']}")
    check(type(got[0]).__name__ == "LiftOutputs" and type(got[1]).__name__ == "BoxOutputs"
          and _tensors_equal(torch, got, want),
          f"{name}: the loaded lift program's LiftOutputs / BoxOutputs bit-equal to the "
          "in-process step's")
    out["kept_boxes"] = int(got[1].keep.sum())
    check(out["kept_boxes"] > 0, f"{name}: the artifact keeps boxes")
    out.update(_in_turns(torch, dev, {"in_process": lambda: step(frames),
                                      "artifact": lambda: loaded.call(frames)}))
    print(f"[{card}] {name} lift artifact, batch {batch}: {out['bytes']} bytes, export "
          f"{out['export_s']:.2f} s, load {out['load_s']:.2f} s, bit-equal, launches "
          f"{out['launches_per_call']} a call; ms a step in-process {out['in_process_ms']}, "
          f"artifact {out['artifact_ms']}", flush=True)
    return out, loaded, step


def _detect_inputs(torch, batch: int, n_points: int, image_hw, use_camera: bool, seed=0):
    """A batch of clouds over the pillar grid (the first `n_points` of
    each valid) and, with a camera, images with the ring's extrinsics, on
    the card."""
    from cm3d_tpu_torch.train import PillarConfig

    pc = PillarConfig()
    rng = np.random.default_rng(seed)
    pts = np.zeros((batch, 32768, 4), np.float32)
    pts[..., 0] = rng.uniform(pc.x_min, pc.x_max, (batch, 32768))
    pts[..., 1] = rng.uniform(pc.y_min, pc.y_max, (batch, 32768))
    pts[..., 2] = rng.uniform(-2.0, 1.0, (batch, 32768))
    pts[..., 3] = rng.uniform(0.0, 1.0, (batch, 32768))
    valid = np.zeros((batch, 32768), bool)
    valid[:, :n_points] = True
    dev = torch.device("cuda")
    out = [torch.from_numpy(pts).to(dev), torch.from_numpy(valid).to(dev)]
    if use_camera:
        ih, iw = image_hw
        k = np.array([[100.0, 0.0, iw / 2], [0.0, 100.0, ih / 2], [0.0, 0.0, 1.0]], np.float32)
        out += [torch.from_numpy(rng.uniform(0, 255, (batch, N_CAMERAS, ih, iw, 3))
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(np.tile(k, (batch, N_CAMERAS, 1, 1))).to(dev),
                torch.from_numpy(ring_extrinsics(batch)).to(dev)]
    return out


def detect_artifact_phase(torch, name: str, use_camera: bool, backbone: str, tmp, card: str):
    """The detect step exported at the defaults (batch 4, 32768 points,
    top_k 128, 6 x 144 x 256 images) with seeded weights as inputs, saved
    and loaded: a call equal to make_detect_fn's on the same batch, its
    launches (1 segment_sum_max; + 1 segment_sum with a camera; + 12 + 12
    window attention with Swin-T), ms a call of both in turns."""
    from cm3d_tpu_torch import deploy
    from cm3d_tpu_torch.config import class_arrays
    from cm3d_tpu_torch.pipelines.detect import make_detect_fn
    from cm3d_tpu_torch.train import PillarConfig
    from cm3d_tpu_torch.train.train import model_tensors

    dev = torch.device("cuda")
    torch.manual_seed(0)
    model = deploy.detect_model(use_camera, backbone).to(dev)
    with torch.no_grad():  # a heatmap prior of 0.5, not 0.01: the 0.1 threshold keeps boxes
        (model.centerpoint if use_camera else model).heatmap_out.bias.zero_()
    params, stats = model_tensors(model)
    params = {k: v.detach() for k, v in params.items()}
    before = _launch_counts()
    t0 = time.perf_counter()
    program = deploy.export_detect_step(use_camera=use_camera, camera_backbone=backbone,
                                        device=dev)
    out = {"export_s": time.perf_counter() - t0}
    check(not _launched(before), f"{name}: tracing the detect step launches no kernel")
    check(dict(program.state_dict) == {}, f"{name}: the program holds no parameter")
    path = os.path.join(tmp, f"detect_{name}.pt2")
    loaded, sizes = _save_and_load(torch, program, path)
    out.update(sizes)
    out["parameter_bytes"] = sum(v.numel() * v.element_size()
                                 for v in [*params.values(), *stats.values()])
    inputs = _detect_inputs(torch, 4, 30000, TRAIN_IMAGE_HW, use_camera)
    _, _, radii = class_arrays()
    detect = make_detect_fn(model, PillarConfig(), radii[:10], fusion=use_camera)
    want = detect(*inputs)
    before = _launch_counts()
    got = loaded.call(params, stats, *inputs)
    _sync(torch, dev)
    out["launches_per_call"] = _launched(before)
    expect = {"segment_sum_max": 1}
    if use_camera:
        expect["segment_sum"] = 1
    if backbone == "swin_t" and use_camera:
        expect.update(window_attn_heads=SWIN_T_BLOCKS, window_attn_proj=SWIN_T_BLOCKS)
    check(out["launches_per_call"] == expect,
          f"{name}: the loaded detect program launches {expect}, got {out['launches_per_call']}")
    out["max_abs_err"] = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name}: the loaded detect program equal to make_detect_fn ({out['max_abs_err']:.3g})")
    out["kept"] = int(got[3].sum())
    check(out["kept"] > 0, f"{name}: the detect artifact keeps boxes")
    out.update(_in_turns(torch, dev, {"in_process": lambda: detect(*inputs),
                                      "artifact": lambda: loaded.call(params, stats, *inputs)}))
    print(f"[{card}] {name} detect artifact, batch 4: {out['bytes']} bytes (parameters "
          f"{out['parameter_bytes']} bytes, passed in), export {out['export_s']:.2f} s, load "
          f"{out['load_s']:.2f} s, equal, launches {out['launches_per_call']} a call; ms a call "
          f"in-process {out['in_process_ms']}, artifact {out['artifact_ms']}", flush=True)
    return out, path, params, stats, detect


def _serve(torch, server, route: str, bodies, expected, per_call: dict, card: str) -> dict:
    """Post `bodies` to `route` SERVE_CONCURRENCY at a time; every response
    must equal its `expected` answer, and each device call must launch
    `per_call`. Keyframes (or clouds) a second and request latency
    percentiles."""
    import concurrent.futures
    import threading
    import urllib.request

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d%s" % (server.server_address[1], route)

    def post(body):
        t0 = time.perf_counter()
        req = urllib.request.Request(url, data=body,
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=300) as r:
            resp = json.loads(r.read())
        return resp, time.perf_counter() - t0

    try:
        post(bodies[0])  # warm the route
        batches0 = server.backend.stats["batches"]
        before = _launch_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(SERVE_CONCURRENCY) as pool:
            results = list(pool.map(post, bodies))
        wall = time.perf_counter() - t0
        batches = server.backend.stats["batches"] - batches0
        launches = _launched(before)
    finally:
        server.shutdown()
        server.backend.close()
        server.server_close()
    for i, ((resp, _), want) in enumerate(zip(results, expected)):
        check(resp == want, f"{route}: response {i} equal to its in-process slot")
    check(sum(want["n_kept"] for want in expected) > 0, f"{route}: the answers hold boxes")
    check(launches == {k: v * batches for k, v in per_call.items()},
          f"{route}: {per_call} launches in each of {batches} device calls, got {launches}")
    lat = np.array([t for _, t in results]) * 1e3
    out = {"requests": len(bodies), "concurrency": SERVE_CONCURRENCY, "device_calls": batches,
           "launches": launches,
           "per_s": len(bodies) / wall, "latency_ms_p50": float(np.percentile(lat, 50)),
           "latency_ms_p99": float(np.percentile(lat, 99)),
           "body_bytes": int(np.mean([len(b) for b in bodies]))}
    print(f"[{card}] {route}: {out['requests']} requests at concurrency {SERVE_CONCURRENCY} in "
          f"{batches} device calls, {out['per_s']:.2f} a second, latency p50 "
          f"{out['latency_ms_p50']:.1f} ms, p99 {out['latency_ms_p99']:.1f} ms, "
          f"{out['body_bytes']} bytes a body; every response equal to its slot; launches "
          f"{launches}", flush=True)
    return out


def _lift_answer(lift, boxes, j) -> dict:
    """The /v1/lift response for slot j of an in-process step."""
    k = boxes.keep[j].cpu().numpy()
    rows = np.concatenate([boxes.centers[j].cpu().numpy()[k], boxes.sizes[j].cpu().numpy()[k],
                           boxes.yaws[j].cpu().numpy()[k][:, None]], axis=1)
    return {"boxes": rows.tolist(), "scores": boxes.scores[j].cpu().numpy()[k].tolist(),
            "classes": boxes.labels[j].cpu().numpy()[k].tolist(), "n_kept": int(k.sum()),
            "n_masks_with_points": int(lift.has_points[j].sum()),
            "n_truncated": int(lift.truncated[j].sum())}


def serve_lift_phase(torch, cfg, host, b8_path, tmp, card: str) -> dict:
    """/v1/lift over localhost with batch buckets 1 and 8: SERVE_REQUESTS
    keyframes (`host`'s 8 and 8 more synthetic ones) as .npz bodies, every
    response equal to the in-process step's slot."""
    import io

    from cm3d_tpu_torch import deploy
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes, to_device
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.serve import _keyframe_fields, make_lift_server

    dev = torch.device("cuda")
    frame = map_fields(lambda x: x[0], host)
    b1_path = os.path.join(tmp, "lift_b1.pt2")
    deploy.save_artifact(deploy.export_lift_step(cfg, batch_size=1, device=dev, frame=frame),
                         b1_path)
    rng = np.random.default_rng(1)
    more = stack_keyframes([make_keyframe(SyntheticConfig(), cfg, rng)
                            for _ in range(8)]).frames
    step = make_keyframe_step_fn(cfg, device=dev)
    bodies, expected = [], []
    for batch in (host, more):
        lift, boxes = step(to_device(batch, dev))
        for j in range(batch.points.shape[0]):
            buf = io.BytesIO()
            np.savez(buf, **_keyframe_fields(map_fields(lambda x: x[j], batch)))
            bodies.append(buf.getvalue())
            expected.append(_lift_answer(lift, boxes, j))
    server = make_lift_server([b1_path, b8_path], port=0, verbose=False)
    check(server.backend.bucket_sizes == [1, 8], "lift buckets 1 and 8")
    return _serve(torch, server, "/v1/lift", bodies, expected,
                  {"compact_rows": 3, "medoid_distance_sums_rows": 1}, card)


def serve_detect_phase(torch, path, params, stats, detect, card: str) -> dict:
    """/v1/detect over localhost: SERVE_REQUESTS clouds of
    SERVE_CLOUD_POINTS points as .npy bodies, every response equal to the
    in-process detect with the cloud alone in slot 0."""
    import io

    from cm3d_tpu_torch.serve import make_server

    dev = torch.device("cuda")
    points, _ = _detect_inputs(torch, SERVE_REQUESTS, SERVE_CLOUD_POINTS, None, False, seed=2)
    clouds = points[:, :SERVE_CLOUD_POINTS].cpu().numpy()
    bodies, expected = [], []
    for cloud in clouds:
        buf = io.BytesIO()
        np.save(buf, cloud)
        bodies.append(buf.getvalue())
        pts = torch.zeros((4, 32768, 4), device=dev)
        val = torch.zeros((4, 32768), dtype=torch.bool, device=dev)
        pts[0, :len(cloud)] = torch.from_numpy(cloud).to(dev)
        val[0, :len(cloud)] = True
        boxes, scores, classes, keep = (x[0].cpu().numpy() for x in detect(pts, val))
        expected.append({"boxes": boxes[keep].tolist(), "scores": scores[keep].tolist(),
                         "classes": classes[keep].tolist(), "n_kept": int(keep.sum())})
    server = make_server(path, params, stats, port=0, verbose=False)
    return _serve(torch, server, "/v1/detect", bodies, expected, {"segment_sum_max": 1}, card)


def conform_phase(torch, tmp, card: str) -> dict:
    """cm3d_tpu_torch.conform with --fake_weights --skip_eval on the port's
    nuScenes fixture (tests/torch_nusc_fixture.py make_fake_nuscenes): exit
    0, its report written, the e2e phase's 2 samples on the card (its lift
    launches the compaction and the medoid)."""
    from pathlib import Path

    from cm3d_tpu_torch import conform

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_nusc_fixture import VERSION, make_fake_nuscenes

    root, out = os.path.join(tmp, "nusc"), os.path.join(tmp, "conform")
    make_fake_nuscenes(Path(root), Path(tmp) / "planted", n_frames=2, n_objects=6)
    before = _launch_counts()
    t0 = time.perf_counter()
    rc = conform.main(["--fake_weights", "--skip_eval", "--dataroot", root, "--version", VERSION,
                       "--scenes", "scene-0001", "--out", out, "--device", "cuda"])
    res = {"rc": rc, "s": time.perf_counter() - t0, "launches": _launched(before)}
    report = json.load(open(os.path.join(out, "conform_report.json")))
    res.update(n_samples=report["e2e"].get("n_samples"), n_boxes=report["e2e"].get("n_boxes"))
    check(rc == 0 and report["ok"] and res["n_samples"] == 2
          and report["e2e"]["argv"][-2:] == ["--device", "cuda"]
          and res["launches"].get("compact_rows", 0) > 0
          and res["launches"].get("medoid_distance_sums_rows", 0) > 0,
          f"conform --fake_weights --skip_eval exits 0 with its report, the e2e phase on the "
          f"card: {res}")
    print(f"[{card}] conform --fake_weights --skip_eval on the fixture dataroot: exit {rc}, "
          f"{res['n_samples']} samples, {res['n_boxes']} boxes, launches {res['launches']}, "
          f"{res['s']:.2f} s", flush=True)
    return res


def dispatch_cost_phase(torch, card: str) -> dict:
    """The dispatcher op's host cost a call: DISPATCH_CALLS back-to-back
    compaction calls at a small shape (host-bound) through the wrapper and
    its op, and through the op's CUDA implementation called directly, in
    turns; microseconds a call."""
    from cm3d_tpu_torch.kernels import compact

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sel = torch.rand((8, 4096), generator=gen, device=dev) < 0.3
    values = torch.rand((8, 5, 4096), generator=gen, device=dev)
    check(torch.equal(compact.compact_rows(sel, values, 1024),
                      compact._compact_rows_cuda(sel, values, 1024)),
          "the op and its CUDA implementation agree")
    runs = {"op": lambda: compact.compact_rows(sel, values, 1024),
            "direct": lambda: compact._compact_rows_cuda(sel, values, 1024)}
    times = {k: [] for k in runs}
    for _ in range(3):
        for k, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e6 / DISPATCH_CALLS)
    out = {"op_us": times["op"], "direct_us": times["direct"],
           "dispatch_us": [a - b for a, b in zip(times["op"], times["direct"])],
           "shape": "sel [8, 4096], values [8, 5, 4096], limit 1024"}
    print(f"[{card}] op dispatch a compaction call: through the op {out['op_us']} us, the "
          f"CUDA implementation called directly {out['direct_us']} us", flush=True)
    return out


def deploy_serve_phase(torch, host, card: str, batches: dict) -> dict:
    """Phase 19: the lift and detect steps as artifacts, served over HTTP,
    and the conformance runbook, on the card. `host`: bench_lift's batch-8
    host keyframes; `batches`: phase 16 / 17's Waymo and KITTI batch-8 host
    keyframes."""
    import tempfile

    from cm3d_tpu_torch.config import KITTI_LIFT, WAYMO_LIFT, LiftStageConfig
    from cm3d_tpu_torch.datasets.types import map_fields

    t_phase = time.perf_counter()
    cfg = LiftStageConfig()
    out = {"dispatch": dispatch_cost_phase(torch, card)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, preset, batch in (("nuscenes", cfg, host),
                                    ("waymo", WAYMO_LIFT, batches["waymo"]),
                                    ("kitti", KITTI_LIFT, batches["kitti"])):
            out[f"lift_{name}"], _, _ = lift_artifact_phase(
                torch, name, preset, batch, tmp, card, frame=map_fields(lambda x: x[0], batch))
        out["serve_lift"] = serve_lift_phase(torch, cfg, host,
                                             os.path.join(tmp, "lift_nuscenes.pt2"), tmp, card)
        served = None
        for name, camera, backbone in (("centerpoint", False, "conv"),
                                       ("bevfusion_conv", True, "conv"),
                                       ("bevfusion_swin_t", True, "swin_t")):
            res = detect_artifact_phase(torch, name, camera, backbone, tmp, card)
            out[f"detect_{name}"] = res[0]
            if name == "centerpoint":
                served = res[1:]
            del res
        out["serve_detect"] = serve_detect_phase(torch, *served, card)
        out["conform"] = conform_phase(torch, tmp, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] deploy and serve: {out['phase_s']:.1f} s", flush=True)
    return out


# --- phase 20: the int8 speed modes (A12) and ZoeDepth (A13b) ---

QUANT_ZOE_FLAG = "--quant-zoe-phase"  # phase 20 alone (after the kernel build)
PEAK_INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor cores
# ViT-H's quantized layers as (K, N) of [tokens, K] x [K, N]
VIT_H_LINEARS = {"qkv": (1280, 3840), "proj": (1280, 1280), "lin1": (1280, 5120),
                 "lin2": (5120, 1280)}
INT8_TOKENS = 4096  # one square 1024 ViT-H encode: 64 x 64 tokens
INT8_CPU_ROWS = 256  # rows held card vs CPU: each row's quantization is its own
# int8 against bf16, the JAX package's envelopes (tests/test_quant.py:134-150
# dynamic, :574-600 static)
QUANT_DYN_REL, QUANT_DYN_CORR = 0.1, 0.995
QUANT_STATIC_REL, QUANT_STATIC_CORR = 0.15, 0.99
# ZoeDepth card vs CPU (f32, TF32 off): rtol at 99.9% of the pixels, and at
# all of them. On the x10 synthetic weights the head's last layer reaches
# about 2.4e3 at the image border and p = pt0 / (pt0 + pt1) lies within 1e-3
# of 1, so log(1 - p) carries pt1's absolute rounding: the card's and the
# CPU's f32 model outputs differ by about 1% at one cell, and after the
# resize and the flip average one pixel of 345,600 read 1.81e-3
# (zoe_worst_cell prints the cell's head outputs, 1 - p, temperature and
# top bin logits on both)
ZOE_RTOL, ZOE_RTOL_ALL = 1e-4, 5e-3
ZOE_SMALL_WH = (320, 180)  # camera size of the ZOE_TEST card-vs-CPU run
ZOE_FRAMES = 2  # full-width use_zoedepth frames (each payload about 300 MB)


def _rel_corr(torch, got, ref):
    g, r = got.float().flatten(), ref.float().flatten()
    rel = float((g - r).norm() / r.norm())
    corr = float(torch.corrcoef(torch.stack([g, r]))[0, 1])
    return rel, corr


def int8_op_phase(torch, card: str) -> dict:
    """dynamic_int8_matmul / static_int8_matmul at ViT-H's four layer shapes,
    4096 tokens, bf16: the card's rows bit-equal to the port's CPU path on
    the same inputs; ms of torch._int_mm alone, of each whole op, and of
    F.linear in bf16 on the same shapes; the kernels one op queues."""
    import torch.nn.functional as F

    from cm3d_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, (k, n) in VIT_H_LINEARS.items():
        x = torch.randn(INT8_TOKENS, k, generator=gen).to(torch.bfloat16)
        w = torch.randn(n, k, generator=gen) * k ** -0.5
        b = torch.randn(n, generator=gen) * 0.1
        w_q, w_s = quant.quantize_weight(w)
        s = x.float().abs().max() / 127 * 0.8  # static: the top fifth of |x| clips
        xd, wqd, wsd, bd, sd = (t.cuda() for t in (x, w_q, w_s, b, s))
        dyn = quant.dynamic_int8_matmul(xd, wqd, wsd, bd)
        sta = quant.static_int8_matmul(xd, wqd, wsd, sd, bd)
        rows = slice(0, INT8_CPU_ROWS)
        check(torch.equal(dyn[rows].cpu(), quant.dynamic_int8_matmul(x[rows], w_q, w_s, b)),
              f"int8 {name}: dynamic op card == CPU, bit for bit")
        check(torch.equal(sta[rows].cpu(), quant.static_int8_matmul(x[rows], w_q, w_s, s, b)),
              f"int8 {name}: static op card == CPU, bit for bit")
        x_q = torch.round(xd.float() / (xd.float().abs().amax(-1, keepdim=True) / 127)).to(
            torch.int8)
        wb, bb = w.to(torch.bfloat16).cuda(), bd.to(torch.bfloat16)
        prof = profiled_kernels(torch, lambda: quant.dynamic_int8_matmul(xd, wqd, wsd, bd), reps=5)
        ops = 2 * INT8_TOKENS * k * n
        rec = {
            "shape": [INT8_TOKENS, k, n],
            "int_mm_ms": time_ms(torch, lambda: quant.int_mm(x_q, wqd)),
            "dynamic_ms": time_ms(torch, lambda: quant.dynamic_int8_matmul(xd, wqd, wsd, bd)),
            "static_ms": time_ms(torch, lambda: quant.static_int8_matmul(xd, wqd, wsd, sd, bd)),
            "linear_bf16_ms": time_ms(torch, lambda: F.linear(xd, wb, bb)),
            # int8 product alone: x_q and w_q read once, the int32 sums written once
            "int_mm_bound_ms": 1e3 * max(ops / PEAK_INT8_OPS_PER_S,
                                         (INT8_TOKENS * k + k * n + 4 * INT8_TOKENS * n)
                                         / PEAK_BYTES_PER_S),
            "linear_bf16_bound_ms": 1e3 * max(ops / PEAK_BF16_OPS_PER_S,
                                              2 * (INT8_TOKENS * k + k * n + INT8_TOKENS * n)
                                              / PEAK_BYTES_PER_S),
            "kernels_per_dynamic_op": sum(c for _, c in prof.values()) / 5,
            "dynamic_kernels_ms": sum(ms for ms, _ in prof.values()) / 5 if prof else None,
        }
        out[name] = rec
        print(f"[{card}] int8 {name} [{INT8_TOKENS}, {k}] x [{k}, {n}] bf16: _int_mm "
              f"{rec['int_mm_ms']:.4f} ms (bound {rec['int_mm_bound_ms']:.4f}), dynamic op "
              f"{rec['dynamic_ms']:.4f} ms ({rec['kernels_per_dynamic_op']:.0f} kernels, "
              f"{_ms_text(rec['dynamic_kernels_ms'])} of them), static op "
              f"{rec['static_ms']:.4f} ms, F.linear bf16 {rec['linear_bf16_ms']:.4f} ms "
              f"(bound {rec['linear_bf16_bound_ms']:.4f}); card rows == CPU rows", flush=True)
        del x, xd, x_q, dyn, sta
    # a shape cuBLASLt's int8 path refuses: few rows are padded, an odd K raises
    xs = torch.randn(5, 64, device="cuda")
    wq, ws = quant.quantize_weight(torch.randn(24, 64, device="cuda"))
    check(torch.equal(quant.dynamic_int8_matmul(xs, wq, ws).cpu(),
                      quant.dynamic_int8_matmul(xs.cpu(), wq.cpu(), ws.cpu())),
          "int8 at 5 rows (padded to 17 on the card) == CPU")
    try:
        quant.int_mm(torch.zeros(32, 12, dtype=torch.int8, device="cuda"),
                     torch.zeros(8, 12, dtype=torch.int8, device="cuda"))
        check(False, "int_mm raises on K = 12")
    except ValueError:
        pass
    return out


def sam_quant_phase(torch, ring, sam, qsam, ssam, card: str) -> dict:
    """A full-width ViT-H encode of one camera in bf16 (`sam`), int8 dynamic
    (`qsam`) and int8 static (`ssam`, calibrated here in place on another
    camera of the ring): ms a camera in turns, the int8 embeddings against
    bf16 held to the JAX package's envelopes, kernels an encode queues and
    the top ones."""
    from cm3d_tpu_torch.models.common import calibrate_act_scales_
    from cm3d_tpu_torch.models.sam import preprocess_image

    x = torch.from_numpy(preprocess_image(ring[0], sam.cfg.img_size))[None].cuda()
    x_cal = torch.from_numpy(preprocess_image(ring[1], sam.cfg.img_size))[None].cuda()
    t0 = time.perf_counter()
    calibrate_act_scales_(ssam, lambda: ssam.encode_image(x_cal))
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    models = {"bf16": sam, "int8": qsam, "int8_static": ssam}
    with torch.inference_mode():
        emb = {k: m.encode_image(x) for k, m in models.items()}
        times = {k: [] for k in models}
        for k in ("bf16", "int8", "int8_static", "int8_static", "int8", "bf16"):
            times[k].append(time_ms(torch, lambda: models[k].encode_image(x), reps=3))
        kernels = {}
        for k in ("bf16", "int8"):
            prof = profiled_kernels(torch, lambda: models[k].encode_image(x), reps=1)
            top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:10]
            kernels[k] = {"count": sum(c for _, c in prof.values()),
                          "kernels_ms": sum(ms for ms, _ in prof.values()) if prof else None,
                          "top": [[key[:80], ms, c] for key, (ms, c) in top]}
    rec = {"ms_per_camera": times, "calibration_s": cal_s, "kernels": kernels}
    for k, (rel_tol, corr_tol) in (("int8", (QUANT_DYN_REL, QUANT_DYN_CORR)),
                                   ("int8_static", (QUANT_STATIC_REL, QUANT_STATIC_CORR))):
        check(bool(torch.isfinite(emb[k]).all()), f"ViT-H {k} embeddings finite")
        rel, corr = _rel_corr(torch, emb[k], emb["bf16"])
        rec[f"{k}_rel"], rec[f"{k}_corr"] = rel, corr
        check(rel < rel_tol and corr > corr_tol,
              f"ViT-H {k} vs bf16: rel {rel:.4g} < {rel_tol}, corr {corr:.5f} > {corr_tol}")
    print(f"[{card}] ViT-H encode (1024 square, one camera): ms {times}; int8 vs bf16 rel "
          f"{rec['int8_rel']:.4g} corr {rec['int8_corr']:.5f}; static rel "
          f"{rec['int8_static_rel']:.4g} corr {rec['int8_static_corr']:.5f}; one-camera "
          f"calibration {cal_s:.3f} s; kernels an encode: "
          f"{ {k: v['count'] for k, v in kernels.items()} }", flush=True)
    for k, v in kernels.items():
        for key, ms, c in v["top"][:6]:
            print(f"  {k}: {ms:8.3f} ms x{c:<4d} {key}", flush=True)
    return rec


def detic_quant_phase(torch, ring, prod, prod_q, card: str) -> dict:
    """A full-width Detic Swin-B forward on the 6-camera ring in bf16 and with
    int8 MLPs (the same weights): B3 counted from 0 on the int8 forward (24
    launches of each kernel), the detections held to tests/test_quant.py:
    232-272's envelope, ms a forward in turns."""
    from cm3d_tpu_torch.benchmarks import IMG_H, IMG_W
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj

    frame = prod.prepare(ring)
    ref = [t.float().cpu() for t in prod.detic(frame)]
    window_attn_heads.launches = 0
    window_attn_proj.launches = 0
    got = [t.float().cpu() for t in prod_q.detic(frame)]
    launches = {"window_attn_heads": window_attn_heads.launches,
                "window_attn_proj": window_attn_proj.launches}
    for name, count in launches.items():
        check(count == SWIN_BLOCKS_PER_FORWARD, f"int8 Detic forward: {SWIN_BLOCKS_PER_FORWARD} "
              f"{name} launches, got {count}")
    s_ref, s_q = ref[1], got[1]
    v_ref, v_q = ref[3] > 0, got[3] > 0
    worst = 0.0
    for cam in range(v_ref.shape[0]):
        check(int(v_ref[cam].sum()) == int(v_q[cam].sum()),
              f"int8 Detic camera {cam}: {int(v_q[cam].sum())} detections, bf16 "
              f"{int(v_ref[cam].sum())}")
        both = v_ref[cam] & v_q[cam]
        if both.any():
            sr, sq = s_ref[cam][both], s_q[cam][both]
            spread = max(1e-6, float(sr.max() - sr.min()), 0.05)
            err = float((sr - sq).abs().max())
            worst = max(worst, err / (0.05 + 0.1 * spread))
            check(err < 0.05 + 0.1 * spread, f"int8 Detic camera {cam}: score drift {err:.4g}")
    times = {"bf16": [], "int8": []}
    for k, m in (("bf16", prod), ("int8", prod_q), ("int8", prod_q), ("bf16", prod)):
        times[k].append(time_ms(torch, lambda: m.detic(frame), reps=3))
    rec = {"launches": launches, "ms_per_forward": times, "detections": int(v_ref.sum()),
           "score_drift_over_envelope": worst}
    print(f"[{card}] Detic Swin-B forward (6 x {IMG_W}x{IMG_H}): ms {times}; int8 MLPs "
          f"launch B3 {launches}; {int(v_q.sum())} detections (bf16 {int(v_ref.sum())}), "
          f"worst score drift {worst:.3f} of its envelope", flush=True)
    return rec


def quant_stage_phase(torch, real_bf16, card: str) -> dict:
    """bench_mask_stage (no IO stand-in) bf16 / int8 / int8 static and
    bench_e2e bf16 / int8, in turns. The bf16 runs take `real_bf16`; each
    int8 run builds its models in the bench (`quant_int8` / `quant_static`),
    so a static run calibrates on its warm-up ring once (its seconds read
    back). The launch counts of each e2e run are checked."""
    from cm3d_tpu_torch.benchmarks import IMG_H, IMG_W, bench_mask_stage

    modes = {"bf16": {}, "int8": {"quant_int8": True},
             "int8_static": {"quant_int8": True, "quant_static": True}}
    mask = {k: [] for k in modes}
    cal = []
    for k in ("bf16", "int8", "int8_static", "int8_static", "int8", "bf16"):
        b = bench_mask_stage("bfloat16", n_frames=4, models=real_bf16 if k == "bf16" else None,
                             io_sleep=0.0, device="cuda", **modes[k])
        b["models"] = k
        print(json.dumps(b), flush=True)
        mask[k].append(b["value"])
        if k == "int8_static":
            check(b["quant_static"] and b["calibration_s"] > 0,
                  "bench_mask_stage built static int8 models that calibrated once")
            cal.append(b["calibration_s"])
        elif k == "int8":
            check(b["quant_int8"] and b["calibration_s"] is None,
                  "bench_mask_stage built dynamic int8 models")
    e2e = {"bf16": [], "int8": []}
    e2e_launches = {}
    for k in ("bf16", "int8", "int8", "bf16"):
        b = e2e_phase(torch, real_bf16 if k == "bf16" else None, fused=False, n_frames=4,
                      batch_size=4, label=k, quant_int8=k == "int8")
        e2e[k].append(b["value"])
        e2e_launches[k] = b["launches"]
    rec = {"mask_stage_kf_per_s": mask, "e2e_kf_per_s": e2e, "e2e_launches": e2e_launches,
           "calibration_s": cal}
    print(f"[{card}] mask stage keyframes/s (io 0, 6 x {IMG_W}x{IMG_H}): {mask}; fused e2e "
          f"keyframes/s: {e2e}; first-ring calibration {cal} s", flush=True)
    return rec


def zoe_worst_cell(torch, sd_t, images) -> dict:
    """Where ZOE_TEST's own depth outputs (flip pass included) differ most
    between the card and the CPU: that cell's head outputs (the four
    pre-softplus values of conditional_log_binomial), 1 - p, the
    temperature t and the two top bin logits (the softmax input, log_binom
    / t) on each device."""
    import math

    from cm3d_tpu_torch.models.zoedepth import ZOE_TEST, ZoeDepth, preprocess_zoe

    n = ZOE_TEST.n_bins
    k = np.arange(n, dtype=np.float64)
    log_coef = np.array([math.lgamma(n) - math.lgamma(i + 1) - math.lgamma(n - i) for i in k])
    depth, head = {}, {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            model = ZoeDepth(ZOE_TEST)
        model.load_state_dict(sd_t)
        model.eval()
        outs = []
        hook = model.conditional_log_binomial.register_forward_hook(
            lambda m, i, o: outs.append(o.double().cpu().numpy()))
        maps = []
        with torch.inference_mode():
            for im in images:
                x = torch.as_tensor(preprocess_zoe(im, ZOE_TEST.img_hw), device=dev)[None]
                for xx in (x, x.flip(2)):
                    maps.append(model(xx)[0].double().cpu().numpy())
        hook.remove()
        depth[dev], head[dev] = np.concatenate(maps), np.concatenate(outs)
    rel = np.abs(depth["cuda"] - depth["cpu"]) / depth["cpu"]
    at = np.unravel_index(int(np.argmax(rel)), rel.shape)
    rec = {"cell": [int(a) for a in at], "max_rel": float(rel[at])}
    for dev in ("cuda", "cpu"):
        pt = np.logaddexp(0.0, head[dev][at]) + 1e-4  # softplus, as the head
        p, t = pt[0] / (pt[0] + pt[1]), pt[2] / (pt[2] + pt[3])
        p = np.clip(p, 1e-8, 1 - 1e-8)
        logits = (log_coef + k * np.log(p) + (n - 1 - k) * np.log(1 - p)) / t
        top = np.argsort(-logits)[:2]
        rec[dev] = {"depth": float(depth[dev][at]), "head": [float(v) for v in head[dev][at]],
                    "one_minus_p": float(1 - p), "t": float(t),
                    "top_bins": [int(b) for b in top],
                    "top_logits": [float(logits[b]) for b in top]}
    return rec


def zoe_phase(torch, ring, prod, card: str) -> dict:
    """ZoeDepth: ZOE_N (synthetic weights) attached to the full-width bf16
    models: ms a 1024x576 camera with flip averaging; run_mask_stage with
    use_zoedepth on the six 1024x576 cameras (ZOE_FRAMES frames, realistic
    load), keyframes/s, the depth payload read back ([M, 576, 1024] f32,
    finite) and its bytes a frame, one frame's time split (dispatch, device,
    masked_depth_images, one payload's write); ZOE_TEST (x10 synthetic weights) card vs
    CPU on depth maps and through run_mask_stage at 320x180 with the tiny
    models, and the cell where the two differ most (zoe_worst_cell)."""
    import pathlib
    import tempfile

    from PIL import Image

    from cm3d_tpu_torch.benchmarks import IMG_H, IMG_W, _realistic_load
    from cm3d_tpu_torch.config import MaskStageConfig
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.models.zoedepth import (
        ZOE_N, ZOE_TEST, synth_zoedepth_state_dict, zoedepth_state_dict_from_released)
    from cm3d_tpu_torch.pipelines.masks import (
        attach_zoedepth, build_fake_models, masked_depth_images, run_mask_stage,
        start_frame_masks)

    def released(cfg, scale, seed):
        sd = synth_zoedepth_state_dict(cfg, np.random.default_rng(seed))
        return zoedepth_state_dict_from_released(
            {k: torch.from_numpy(v * scale) for k, v in sd.items()}, cfg)

    t0 = time.perf_counter()
    sd_n = released(ZOE_N, 1.0, 0)
    models = attach_zoedepth(prod, device="cuda", state_dict=sd_n)
    del sd_n
    build_s = time.perf_counter() - t0
    dispatch = models.predict_depth.dispatch
    depths = [dispatch(im) for im in ring]
    torch.cuda.synchronize()
    for d in depths:
        check(tuple(d.shape) == (IMG_H, IMG_W) and bool(torch.isfinite(d).all())
              and bool((d > 0).all()), "ZOE_N depth: [576, 1024], finite, positive")
    ms = time_ms(torch, lambda: [dispatch(im) for im in ring], reps=2) / len(ring)
    prof = profiled_kernels(torch, lambda: dispatch(ring[0]), reps=1)
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:6]
    zoe_kernels = {"count": sum(c for _, c in prof.values()),
                   "kernels_ms": sum(t for t, _ in prof.values()) if prof else None,
                   "top": [[key[:80], t, c] for key, (t, c) in top]}
    cfg = MaskStageConfig(use_zoedepth=True)
    out = {"zoe_n_ms_per_camera": ms, "build_s": build_s, "zoe_n_kernels": zoe_kernels}
    rings = [ring, ring[::-1]]
    with tempfile.TemporaryDirectory() as tmp:
        # the production path: full-width Detic / SAM, 12 ZOE_N forwards a
        # keyframe, the [M, 576, 1024] payload built and pickled on the finisher
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real = _realistic_load(models)
        run_mask_stage(real, lambda s, f: rings[f % 2], ["z"],
                       lambda s: ZOE_FRAMES, f"{tmp}/n", cfg, verbose=False)
        torch.cuda.synchronize()
        kf_s = ZOE_FRAMES / (time.perf_counter() - t0)
        store = MaskArtifactStore(f"{tmp}/n")
        n_masks, payload_bytes = 0, []
        for f in range(ZOE_FRAMES):
            data, dep = store.read_frame_depths("z", f)
            check(isinstance(dep, np.ndarray) and dep.dtype == np.float32
                  and dep.shape == (len(data["labels"]), IMG_H, IMG_W) and np.isfinite(dep).all()
                  and (dep >= 0).all() and (dep > 0).any(),
                  f"ZOE_N depth payload of frame {f}: [M, {IMG_H}, {IMG_W}] f32, finite")
            n_masks += dep.shape[0]
            payload_bytes.append(
                next(pathlib.Path(tmp, "n").rglob(f"{f}_masks.pkl")).stat().st_size)
            if f == 0:  # the finisher's last step alone: pickle + write
                t0 = time.perf_counter()
                MaskArtifactStore(f"{tmp}/w").write_frame_depths(
                    "z", f, data["labels"], data["detection_scores"], data["cam_nums"], dep)
                write_s = time.perf_counter() - t0
            del dep
        check(n_masks > 0, "the depth payload holds masks")
        # one frame's split: the main thread's dispatch (ZOE_N's host
        # preprocessing included), the device's remainder, then the
        # finisher's masked_depth_images alone
        prepared = real.prepare(ring)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = start_frame_masks(real, None, cfg, prepared=prepared)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        masked = masked_depth_images(handle)
        split = {"dispatch_s": t1 - t0, "device_tail_s": t2 - t1,
                 "masked_depth_images_s": time.perf_counter() - t2, "write_s": write_s}
        check(masked.shape == (len(handle["labels"]), IMG_H, IMG_W), "one frame's payload shape")
        del masked, handle, prepared
        out.update(use_zoedepth_kf_per_s=kf_s, payload_masks=n_masks,
                   payload_bytes_per_frame=payload_bytes, frame_split=split)
        # ZOE_TEST, x10 weights and the tiny models, on the card and the CPU
        small = [np.asarray(Image.fromarray(im).resize(ZOE_SMALL_WH, Image.BILINEAR))
                 for im in ring]
        frames = [small, small[::-1]]
        sd_t = released(ZOE_TEST, 10.0, 1)
        maps, payload = {}, {}
        for dev in ("cuda", "cpu"):
            m = attach_zoedepth(build_fake_models(seed=0, device=dev), test=True, device=dev,
                                state_dict=sd_t)
            maps[dev] = [m.predict_depth(im) for im in small]
            run_mask_stage(m, lambda s, f: frames[f], ["z"], lambda s: 2, f"{tmp}/{dev}", cfg,
                           verbose=False)
            payload[dev] = [MaskArtifactStore(f"{tmp}/{dev}").read_frame_depths("z", f)
                            for f in range(2)]
        worst = zoe_worst_cell(torch, sd_t, small)
        print(f"[{card}] ZOE_TEST cell of the largest card-vs-CPU model output difference: "
              f"{json.dumps(worst)}", flush=True)
        err = np.concatenate([np.abs(a - b).ravel() / b.ravel()
                              for a, b in zip(maps["cuda"], maps["cpu"])])
        check(np.mean(err <= ZOE_RTOL) >= 0.999 and err.max() <= ZOE_RTOL_ALL,
              f"ZOE_TEST depth card vs CPU: rtol {ZOE_RTOL} at 99.9% (got "
              f"{np.mean(err <= ZOE_RTOL):.5f}), {ZOE_RTOL_ALL} at all (max {err.max():.3g})")
        support = 0
        for (dc, pc), (dg, pg) in zip(payload["cuda"], payload["cpu"]):
            check(dc["labels"] == dg["labels"] and pc.shape == pg.shape,
                  "ZOE_TEST depth payload: the card's labels and shape are the CPU's")
            both = (pc > 0) & (pg > 0)
            support += int(((pc > 0) != (pg > 0)).sum())
            check(np.all(np.abs(pc[both] - pg[both]) <= ZOE_RTOL_ALL * pg[both]),
                  "ZOE_TEST depth payload card vs CPU on the common mask support")
        out.update(zoe_test_max_rel_err=float(err.max()), payload_support_diff_px=support,
                   zoe_test_worst_cell=worst)
    print(f"[{card}] ZoeDepth ZOE_N (f32, flip averaging) {ms:.2f} ms a 1024x576 camera "
          f"(built in {build_s:.1f} s); use_zoedepth mask stage at full width: {kf_s:.3f} "
          f"keyframes/s over {ZOE_FRAMES} frames (pipeline fill included), {n_masks} masks, "
          f"payload bytes a frame {payload_bytes}, finite; one frame's split (s): "
          f"{json.dumps(split)}; ZOE_TEST card vs CPU: depth max "
          f"rel err {err.max():.3g}, payload masks differ in {support} px; a camera's "
          f"kernels: {zoe_kernels['count']} launches, {_ms_text(zoe_kernels['kernels_ms'])}",
          flush=True)
    for key, t, c in zoe_kernels["top"]:
        print(f"  ZOE_N: {t:8.3f} ms x{c:<4d} {key}", flush=True)
    return out


def quant_zoe_phase(torch, card: str) -> dict:
    """Phase 20: the int8 speed modes (A12) and ZoeDepth (A13b) on the card.
    The full-width float Detic and SAM are built once; their int8 twins
    come from the same weights (quantized_models)."""
    from cm3d_tpu_torch.benchmarks import IMG_H, IMG_W, _realistic_load, production_fake_modules
    from cm3d_tpu_torch.pipelines.masks import _batched_model_fns, quantized_models
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES as VOCAB

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20)
    ring = [rng.integers(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8) for _ in range(N_CAMERAS)]
    out = {"ops": int8_op_phase(torch, card)}
    t0 = time.perf_counter()
    detic, clf, sam = production_fake_modules("bfloat16", device="cuda")
    qdetic, qsam = quantized_models(detic, sam, True)
    ssam = quantized_models(detic, sam, True, quant_static=True)[1]
    prod = _batched_model_fns(detic, clf, sam, VOCAB, device="cuda")
    prod_q = _batched_model_fns(qdetic, clf, qsam, VOCAB, device="cuda")
    torch.cuda.synchronize()
    print(f"[{card}] full-width Detic + SAM bf16, their int8 twins and a static SAM: "
          f"{time.perf_counter() - t0:.1f} s to build", flush=True)
    out["sam"] = sam_quant_phase(torch, ring, sam, qsam, ssam, card)
    out["detic"] = detic_quant_phase(torch, ring, prod, prod_q, card)
    del prod_q, qdetic, qsam, ssam
    torch.cuda.empty_cache()
    out["stages"] = quant_stage_phase(torch, _realistic_load(prod), card)
    out["zoe"] = zoe_phase(torch, ring, prod, card)
    del prod, detic, sam
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] int8 and ZoeDepth: {out['phase_s']:.1f} s", flush=True)
    return out


GDINO_FLAG = "--gdino-phase"  # phase 21 alone (after the kernel build)
GDINO_SWIN_BLOCKS = 12  # Swin-T depths (2, 2, 6, 2): one chunk's forward
GDINO_CHUNK = 3  # make_gdino_detector's max_batch
GDINO_BENCH_FRAMES = 2  # run_mask_stage keyframes a bench run
# GDINO_SWINT card vs CPU, f32 with TF32 off, one 800 x 1216 image: logits
# within GDINO_CPU_RTOL of their largest |value| and boxes within
# GDINO_CPU_BOX_ATOL (normalized) on the query slots that selected the same
# memory token on both (near-tied selection scores may order two tokens
# either way, and a slot's decoder embedding is its own); at most
# GDINO_CPU_SWAPS slots elsewhere
GDINO_CPU_RTOL = 2e-3  # seen: 7.4e-4 (logits reach about 30 on synthetic weights)
GDINO_CPU_BOX_ATOL = 1e-3
GDINO_CPU_SWAPS = 45  # 5% of 900
GDINO_CPU_LAYERS = 6  # encoder / decoder depth of the card-vs-CPU check


def fabricate_bert_vocab(path, words) -> None:
    """A 30,522-line bert-base-uncased-shaped vocab.txt: [PAD] at 0,
    [unused*] fillers, [UNK] / [CLS] / [SEP] at 100-102, '.', the `words`,
    then filler tokens."""
    lines = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + ["[UNK]", "[CLS]", "[SEP]", "."]
    lines += sorted(set(words) - set(lines))
    lines += [f"tok{i}" for i in range(30522 - len(lines))]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def module_device_ms(torch, model, kinds, fn) -> dict:
    """Device ms of every call of each module class in `kinds` during one
    fn() (CUDA events around each call, summed by class), beside fn's own."""
    spans, handles = [], []
    for mod in model.modules():
        if isinstance(mod, kinds):
            def pre(m, args):
                m._ev0 = torch.cuda.Event(enable_timing=True)
                m._ev0.record()

            def post(m, args, out):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                spans.append((type(m).__name__, m._ev0, ev))

            handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    try:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    out = {"total": start.elapsed_time(end)}
    for name, a, b in spans:
        out[name] = out.get(name, 0.0) + a.elapsed_time(b)
    return out


def gdino_cpu_check(torch, sd, image, tok, vocab) -> dict:
    """GDINO_SWINT (GDINO_CPU_LAYERS encoder / decoder layers) on one
    letterboxed image, f32 with TF32 off, on the card and on the CPU."""
    from cm3d_tpu_torch.models.gdino import (
        GDINO_SWINT, GroundingDino, preprocess_gdino, text_inputs, vocabulary_caption)
    from cm3d_tpu_torch.models.convert import load_released_state_dict
    from cm3d_tpu_torch.utils.device import strict_f32_scope

    cfg = dataclasses.replace(GDINO_SWINT, enc_layers=GDINO_CPU_LAYERS,
                              dec_layers=GDINO_CPU_LAYERS)
    enc, _ = vocabulary_caption(tok, vocab, cfg.max_text_len)
    x = preprocess_gdino(image, cfg.img_hw)[None]
    outs, secs = {}, {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            model = GroundingDino(cfg)
        load_released_state_dict(model, sd, "GroundingDINO", verbose=False)
        t0 = time.perf_counter()
        with torch.inference_mode(), strict_f32_scope():
            logits, boxes = model.eval()(torch.as_tensor(x, device=dev),
                                         *text_inputs(enc, 1, dev))
            outs[dev] = (logits[0].cpu(), boxes[0].cpu())
        secs[dev] = time.perf_counter() - t0
        del model
    (lc, bc), (lp, bp) = outs["cuda"], outs["cpu"]
    # each card slot matched to the CPU slot with the nearest box
    match = (bc[:, None] - bp[None]).abs().amax(-1).argmin(1)
    same = match == torch.arange(len(match))
    fin = torch.isfinite(lp[same])
    check(torch.equal(torch.isfinite(lc[same]), fin), "GroundingDINO card vs CPU: -inf pattern")
    scale = float(lp[same][fin].abs().max())
    logit_err = float((lc[same][fin] - lp[same][fin]).abs().max())
    box_err = float((bc[same] - bp[same]).abs().max())
    swaps = int((~same).sum())
    check(logit_err <= GDINO_CPU_RTOL * scale and box_err <= GDINO_CPU_BOX_ATOL
          and swaps <= GDINO_CPU_SWAPS,
          f"GroundingDINO card vs CPU: logits {logit_err:.3g} (<= {GDINO_CPU_RTOL} x "
          f"{scale:.3g}), boxes {box_err:.3g} (<= {GDINO_CPU_BOX_ATOL}), {swaps} slots "
          f"swapped (<= {GDINO_CPU_SWAPS})")
    return {"layers": GDINO_CPU_LAYERS, "logit_max_abs_err": logit_err, "logit_scale": scale,
            "box_max_abs_err": box_err, "swapped_slots": swaps, "seconds": secs}


def gdino_phase(torch, card: str) -> dict:
    """Phase 21: GroundingDINO (A13c) on the card. A full-size GDINO_SWINT
    released-layout file (synth_gdino_state_dict, seeded) and a 30,522-line
    vocab.txt are written and loaded through attach_gdino beside the
    full-width bf16 Detic / SAM; B3 against its plain version at the 8
    (stage, shift) shapes of a chunk's Swin-T forward (f32 capture; bf16 and
    f32 launches); 24 + 24 B3 launches a six-camera keyframe; one image card
    vs CPU (f32, TF32 off); ms a chunk forward and a keyframe, f32 and bf16;
    the profiler's top kernels and MSDeformAttn's / BiAttention's device
    share; run_mask_stage keyframes/s with GroundingDINO and with Detic in
    turns; one int8 forward."""
    import tempfile

    from cm3d_tpu_torch.benchmarks import (
        IMG_H, IMG_W, _realistic_load, bench_mask_stage, production_fake_modules)
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.models.gdino import (
        GDINO_SWINT, BiAttention, MSDeformAttn, WordPieceTokenizer,
        gdino_state_dict_from_released, preprocess_gdino, synth_gdino_state_dict,
        text_inputs, vocabulary_caption)
    from cm3d_tpu_torch.pipelines.masks import _batched_model_fns, attach_gdino
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES as VOCAB

    t_phase = time.perf_counter()
    rng = np.random.default_rng(21)
    ring = [rng.integers(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8) for _ in range(N_CAMERAS)]
    detic, clf, sam = production_fake_modules("bfloat16", device="cuda")
    prod = _batched_model_fns(detic, clf, sam, VOCAB, device="cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sd = synth_gdino_state_dict(GDINO_SWINT, np.random.default_rng(0))
        torch.save({"model": {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}},
                   f"{tmp}/groundingdino_swint_ogc.pth")
        words = {w for c in VOCAB for w in WordPieceTokenizer._basic(c)}
        fabricate_bert_vocab(f"{tmp}/vocab.txt", words)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g32 = attach_gdino(prod, f"{tmp}/groundingdino_swint_ogc.pth", f"{tmp}/vocab.txt",
                           device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        tok = WordPieceTokenizer.from_file(f"{tmp}/vocab.txt")
        sd_t = gdino_state_dict_from_released({k: torch.from_numpy(v) for k, v in sd.items()},
                                              GDINO_SWINT)
        del sd
        g16, gq = (attach_gdino(prod, vocab_path=f"{tmp}/vocab.txt", device="cuda",
                                state_dict=sd_t, **kw)
                   for kw in ({"dtype": "bfloat16"}, {"quant_int8": True}))
    out.update(file_write_s=write_s, load_s=load_s)
    print(f"[{card}] GroundingDINO Swin-T released-layout file (synthetic, seeded) and a "
          f"30522-line vocab.txt: written in {write_s:.1f} s, loaded through attach_gdino in "
          f"{load_s:.1f} s", flush=True)

    # the models behind the detectors, and one chunk's inputs
    model32 = g32.detic.model
    model16 = g16.detic.model
    enc, _ = vocabulary_caption(tok, VOCAB, GDINO_SWINT.max_text_len)
    text = text_inputs(enc, GDINO_CHUNK, torch.device("cuda"))
    t0 = time.perf_counter()
    host = np.stack([preprocess_gdino(im, GDINO_SWINT.img_hw) for im in ring])
    prep_s = time.perf_counter() - t0
    chunk = torch.as_tensor(host[:GDINO_CHUNK], device="cuda")

    # --- B3 at GroundingDINO's Swin-T shapes (a chunk of 3 at 800 x 1216) ---
    with torch.inference_mode():
        captured = capture_window_attn_inputs(
            torch, lambda: model32(chunk, *text), n_blocks=GDINO_SWIN_BLOCKS, n_shapes=8)
        wa = window_attn_phase(torch, captured, model_dtype=torch.float32, time_f32=True)
    del captured
    out["window_attn_shapes"] = wa

    # --- launches a six-camera keyframe, f32 and bf16 ---
    frame = prod.prepare(ring)
    launches = {}
    for name, g in (("f32", g32), ("bf16", g16), ("int8", gq)):
        window_attn_heads.launches = 0
        window_attn_proj.launches = 0
        det = g.detic(frame)
        torch.cuda.synchronize()
        launches[name] = {"window_attn_heads": window_attn_heads.launches,
                          "window_attn_proj": window_attn_proj.launches}
        for k, n in launches[name].items():
            check(n == 2 * GDINO_SWIN_BLOCKS, f"GroundingDINO {name} keyframe: "
                  f"{2 * GDINO_SWIN_BLOCKS} {k} launches, got {n}")
        check(tuple(det[0].shape) == (N_CAMERAS, 128, 4) and bool(torch.isfinite(det[0]).all())
              and det[0].device.type == "cuda", f"GroundingDINO {name} boxes [6, 128, 4]")
        out[f"detections_{name}"] = [t.float().cpu() for t in det]
    out["launches_per_keyframe"] = launches

    # --- int8 against f32: the quantized part, the Swin-T maps, in
    # tests/test_quant.py:228-229's envelope (rel < 0.1 a map); the
    # detections only by count: on the synthetic weights the logits reach
    # about 30, so most scores are 1.0 in f32 and the top 128 are ties ---
    vf, vq = out.pop("detections_f32")[3], out.pop("detections_int8")[3]
    out.pop("detections_bf16")
    with torch.inference_mode():
        maps = [m.backbone[0](chunk) for m in (model32, gq.detic.model)]
    rel = {k: float((maps[1][k] - maps[0][k]).norm() / maps[0][k].norm()) for k in maps[0]}
    check(all(r < QUANT_DYN_REL for r in rel.values()) and int(vf.sum()) == int(vq.sum()),
          f"GroundingDINO int8 Swin-T maps within rel {QUANT_DYN_REL} of f32 ({rel}) and as "
          f"many detections ({int(vq.sum())} against {int(vf.sum())})")
    out["int8"] = {"valid_f32": int(vf.sum()), "valid_int8": int(vq.sum()), "swin_rel": rel}
    print(f"[{card}] GroundingDINO keyframe launches {json.dumps(launches)}; int8 Swin MLPs: "
          f"{json.dumps(out['int8'])}", flush=True)

    # --- times: a chunk forward (events), a keyframe (host clock), f32 / bf16 ---
    times = {}
    for name, model, g in (("f32", model32, g32), ("bf16", model16, g16), ("f32", model32, g32),
                           ("bf16", model16, g16)):
        with torch.inference_mode():
            chunk_ms = time_ms(torch, lambda: model(chunk, *text), reps=3)
        g.detic(frame)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            g.detic(frame)
        torch.cuda.synchronize()
        kf_ms = (time.perf_counter() - t0) * 1e3 / 2
        times.setdefault(name, {"chunk_forward_ms": [], "keyframe_ms": []})
        times[name]["chunk_forward_ms"].append(chunk_ms)
        times[name]["keyframe_ms"].append(kf_ms)
    out["times"] = times
    out["host_letterbox_ms_per_keyframe"] = prep_s * 1e3
    out["host_upload_mb_per_keyframe"] = host.nbytes / 1e6

    # --- where a chunk's forward goes: modules by events, kernels by profiler ---
    with torch.inference_mode():
        shares = {name: module_device_ms(torch, model, (MSDeformAttn, BiAttention),
                                         lambda: model(chunk, *text))
                  for name, model in (("f32", model32), ("bf16", model16))}
        prof = profiled_kernels(torch, lambda: model32(chunk, *text), reps=1)
    top = sorted(prof.items(), key=lambda kv: -kv[1][0])[:10]
    out["module_ms"] = shares
    out["top_kernels_f32"] = [[key[:90], ms, n] for key, (ms, n) in top]
    out["kernels_ms_f32"] = sum(ms for ms, _ in prof.values()) if prof else None

    # --- one image card vs CPU ---
    out["cpu_check"] = gdino_cpu_check(torch, sd_t, ring[0], tok, VOCAB)
    del sd_t

    # --- the mask stage with GroundingDINO and with Detic, in turns ---
    bench = {"detic": [], "gdino": []}
    bench_launches = []
    for name in ("detic", "gdino", "gdino", "detic"):
        raw, calls = (prod if name == "detic" else g32), [0]

        def counted(frame, raw=raw, calls=calls):
            calls[0] += 1
            return raw.detic(frame)

        models = _realistic_load(dataclasses.replace(raw, detic=counted))
        window_attn_heads.launches = 0
        window_attn_proj.launches = 0
        b = bench_mask_stage("bfloat16", n_frames=GDINO_BENCH_FRAMES, models=models,
                             io_sleep=0.0, device="cuda")
        b["detector"] = name
        print(json.dumps(b), flush=True)
        bench[name].append(b["value"])
        got = (window_attn_heads.launches, window_attn_proj.launches)
        # 24 + 24 a keyframe for both: Detic's Swin-B runs the ring at once,
        # GroundingDINO's Swin-T in two chunks of 3
        check(got == (SWIN_BLOCKS_PER_FORWARD * calls[0],) * 2,
              f"{name} mask stage: {SWIN_BLOCKS_PER_FORWARD} launches of each window-attention "
              f"kernel a keyframe over {calls[0]} keyframes, got {got}")
        if name == "gdino":
            bench_launches.append({"window_attn_heads": got[0], "window_attn_proj": got[1],
                                   "keyframes": calls[0]})
    out["mask_stage_kf_per_s"] = bench
    out["mask_stage_launches"] = bench_launches
    del g32, g16, gq, model32, model16, prod, detic, sam
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    f32_chunk = min(times["f32"]["chunk_forward_ms"])
    print(f"[{card}] GroundingDINO GDINO_SWINT: a chunk of {GDINO_CHUNK} at 800x1216 "
          f"{json.dumps(times)}; host letterbox {prep_s * 1e3:.1f} ms a keyframe, upload "
          f"{host.nbytes / 1e6:.1f} MB; module ms a chunk {json.dumps(shares)} (f32 chunk "
          f"{f32_chunk:.1f} ms); card vs CPU {json.dumps(out['cpu_check'])}; mask stage "
          f"keyframes/s (6 x {IMG_W}x{IMG_H}, SAM ViT-H bf16, io 0) {json.dumps(bench)}; "
          f"phase {out['phase_s']:.1f} s", flush=True)
    for key, ms, n in out["top_kernels_f32"]:
        print(f"  GDINO f32 chunk: {ms:8.3f} ms x{n:<4d} {key}", flush=True)
    return out


# --- 22. model parallelism at world size 1 ---------------------------------------

MODEL_PARALLEL_FLAG = "--model-parallel-phase"  # the child process of phase 22
MP_BENCH_FRAMES = 4  # bench_mask_stage frames a side, in turns
MP_BOXES_PER_CAM = 25  # prompts a camera in the decode held bit for bit
GPIPE_MICRO, GPIPE_BATCH = 4, 8  # GPipe: microbatches of CLIP sequences
ENCODE_MP_TOL = 2.0 ** -8  # bf16's step, of the largest value: a reduction order


def model_parallel_phase(torch) -> dict:
    """Phase 22: the model-parallel paths at world size 1 over NCCL (one
    card: NCCL refuses two ranks on one device): every command, broadcast,
    gather and collective of each path runs, and each result is held to the
    plain run's."""
    import functools
    import tempfile

    from cm3d_tpu_torch.benchmarks import (
        IMG_H, IMG_W, _realistic_load, bench_mask_stage, build_production_fake_models,
        production_fake_modules)
    from cm3d_tpu_torch.config import MaskStageConfig
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.ops.bitmask import num_words
    from cm3d_tpu_torch.parallel.mesh import (
        DataParallelGroup, Program, launch_counts, make_mesh)
    from cm3d_tpu_torch.pipelines.masks import camera_parallel_models, generate_frame_masks

    card = card_line()
    out = {"card": card}
    t_phase = time.perf_counter()
    cards = [torch.device("cuda", 0)]

    def counted(fn):
        before = launch_counts()
        res = fn()
        torch.cuda.synchronize()
        return res, {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}

    # the camera-parallel mask stage at full width (Detic Swin-B + SAM ViT-H bf16)
    rng = np.random.default_rng(0)
    ring = [rng.integers(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8) for _ in range(N_CAMERAS)]
    plain = build_production_fake_models("bfloat16", device="cuda")
    with DataParallelGroup(make_mesh(n_data=1, devices=cards), "cuda") as group:
        cam = camera_parallel_models(group, "cm3d_tpu_torch.benchmarks:"
                                     "build_production_fake_models", dtype="bfloat16", seed=0)
        fm_plain, fm_cam = (generate_frame_masks(m, ring) for m in (plain, cam))
        check(fm_cam.labels == fm_plain.labels and fm_cam.cam_nums == fm_plain.cam_nums
              and np.array_equal(fm_cam.masks, fm_plain.masks)
              and np.allclose(fm_cam.detection_scores, fm_plain.detection_scores, rtol=1e-5),
              "the camera-parallel keyframe equals the plain one")
        # the decode held bit for bit on MP_BOXES_PER_CAM prompts a camera
        frame_p, frame_c = plain.prepare(ring), cam.prepare(ring)
        boxes = rng.uniform(0, 500, (N_CAMERAS, 128, 4)).astype(np.float32)
        boxes[..., 2:] += boxes[..., :2] + 30
        n_boxes = np.full(N_CAMERAS, MP_BOXES_PER_CAM, np.int64)
        cam_hw = [(IMG_H, IMG_W)] * N_CAMERAS
        nw = num_words(MaskStageConfig().max_masks_total)
        planes_p = plain.sam_decode_planes(plain.sam_encode(frame_p), boxes, n_boxes, cam_hw,
                                           (IMG_W, IMG_H), nw, "yx")
        planes_c = cam.sam_decode_planes(cam.sam_encode(frame_c), boxes, n_boxes, cam_hw,
                                         (IMG_W, IMG_H), nw, "yx")
        check(torch.equal(planes_p, planes_c) and bool(planes_p.any()),
              f"camera-parallel planes bit-equal to the plain decode's "
              f"({N_CAMERAS} x {MP_BOXES_PER_CAM} prompts)")
        _, launches = counted(lambda: cam.detic(frame_c))
        out["camera_mesh_detic_launches"] = launches
        check(launches.get("window_attn_heads") == 24 and launches.get("window_attn_proj") == 24,
              f"a camera-parallel Detic forward launches B3 24 + 24 times: {launches}")
        rates = {"plain": [], "camera_mesh": []}
        for name, models in (("plain", plain), ("camera_mesh", cam), ("camera_mesh", cam),
                             ("plain", plain)):
            window_attn_heads.launches = window_attn_proj.launches = 0
            bench = bench_mask_stage("bfloat16", n_frames=MP_BENCH_FRAMES, io_sleep=0.0,
                                     models=_realistic_load(models), device="cuda")
            rates[name].append(bench["value"])
            out.setdefault(f"{name}_mask_stage_b3_launches", []).append(
                window_attn_heads.launches)
        out["mask_stage_keyframes_per_s"] = rates
        del cam, frame_c
    del plain, frame_p
    torch.cuda.empty_cache()
    print(f"[{card}] camera-parallel mask stage at world size 1 (NCCL): planes bit-equal, "
          f"B3 {launches} a Detic forward; keyframes/s plain {rates['plain']}, "
          f"camera_mesh=1 {rates['camera_mesh']} (in turns, io 0, {MP_BENCH_FRAMES} frames)",
          flush=True)

    # run_e2e --camera_mesh 1 on the port's nuScenes fixture, against the plain CLI
    from pathlib import Path

    from cm3d_tpu_torch.pipelines import e2e

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_nusc_fixture import VERSION, make_fake_nuscenes

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "nusc")
        make_fake_nuscenes(Path(root), Path(tmp) / "planted", n_frames=2, n_objects=6)
        subs, cli_launches = {}, {}
        for tag, extra in (("plain", []), ("camera_mesh", ["--camera_mesh", "1"])):
            path = os.path.join(tmp, f"{tag}.json")
            _, cli_launches[tag] = counted(lambda: e2e.main(
                ["--dataroot", root, "--version", VERSION, "--scenes", "scene-0001", "--out",
                 path, "--fake_weights", "--device", "cuda"] + extra))
            subs[tag] = json.load(open(path))["results"]
    got = cli_launches["camera_mesh"]
    steps = got.get("medoid_distance_sums_rows", 0)
    out["e2e_cli_launches"] = cli_launches
    check(subs["camera_mesh"] == subs["plain"] and steps > 0
          and got.get("compact_rows") == 3 * steps and got == cli_launches["plain"],
          f"e2e --camera_mesh 1 writes the plain CLI's submission, 3 + 1 lift launches a step: "
          f"{cli_launches}")
    print(f"[{card}] e2e --camera_mesh 1 on the fixture: the plain submission, launches "
          f"{got}", flush=True)

    # ViT-H bf16, its int8 twin and the fused variant through shard_model_params
    # on a model group of one; the sequence-sharded encode over one rank
    from cm3d_tpu_torch.models.sam import Sam, quantize_sam_state_dict
    from cm3d_tpu_torch.parallel.sharding import (
        make_sequence_sharded_encode, shard_model_params)

    _, _, sam = production_fake_modules("bfloat16", device="cuda")
    sam = sam.eval().requires_grad_(False)
    with torch.device("cuda"):
        fused = Sam(dataclasses.replace(sam.cfg, fused_window_attn=True))
    fused.load_state_dict(sam.state_dict())
    fused = fused.eval().requires_grad_(False)
    with torch.device("cuda"):
        qsam = Sam(dataclasses.replace(sam.cfg, quant_int8=True))
    qsam.load_state_dict(quantize_sam_state_dict(sam.state_dict()))
    qsam = qsam.eval().requires_grad_(False)
    size = sam.cfg.img_size
    image = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (size, size, 3)).astype(np.float32)).cuda()
    mesh = make_mesh(n_data=1, n_model=1, devices=cards)
    enc = {}
    with DataParallelGroup(mesh, "cuda"), torch.inference_mode():
        for name, module in (("bf16", sam), ("int8", qsam), ("fused", fused)):
            sharded = shard_model_params(copy.deepcopy(module), mesh)
            want, _ = counted(lambda: module.encode_image(image[None])[0])
            got, launches = counted(lambda: sharded.encode_image(image[None])[0])
            seq = make_sequence_sharded_encode(mesh, module)
            got_seq, seq_launches = counted(lambda: seq(image))
            scale = float(want.float().abs().max())
            rec = {"max_abs_err": float((got.float() - want.float()).abs().max()),
                   "bit_equal": bool(torch.equal(got, want)),
                   "seq_max_abs_err": float((got_seq.float() - want.float()).abs().max()),
                   "max_abs": scale, "launches": launches, "seq_launches": seq_launches}
            check(rec["max_abs_err"] <= ENCODE_MP_TOL * scale
                  and rec["seq_max_abs_err"] <= ENCODE_MP_TOL * scale
                  and bool(torch.isfinite(got).all()),
                  f"ViT-H {name} through shard_model_params / the sequence-sharded encode "
                  f"on one rank against the plain encode: {rec}")
            if name == "fused":
                for ln in (launches, seq_launches):
                    check(ln.get("window_attn_relpos_heads") == 28
                          and ln.get("window_attn_relpos_proj") == 28,
                          f"a sharded fused ViT-H encode launches B4 28 + 28 times: {ln}")
            times = {"plain": [], "sharded": []}
            for tag, fn in (("plain", module), ("sharded", sharded), ("sharded", sharded),
                            ("plain", module)):
                times[tag].append(time_ms(torch, lambda: fn.encode_image(image[None]), reps=3))
            rec["encode_ms"] = times
            enc[name] = rec
            del sharded, seq, want, got, got_seq
            print(f"[{card}] ViT-H {name} sharded on a model group of one: max abs err "
                  f"{rec['max_abs_err']:.3g} (bit-equal {rec['bit_equal']}), sequence-sharded "
                  f"{rec['seq_max_abs_err']:.3g}, of max {scale:.3g}; launches {launches}; ms "
                  f"an encode {times}", flush=True)
    out["vit_h"] = enc
    # what one all-reduce over a one-rank NCCL group costs (a row-parallel
    # layer's, [4096, 1280] bf16), by events over back-to-back calls
    import torch.distributed as dist

    with DataParallelGroup(mesh, "cuda"):
        buf = torch.zeros(4096, 1280, dtype=torch.bfloat16, device="cuda")
        out["all_reduce_ms"] = time_ms(torch, lambda: dist.all_reduce(buf), reps=200)
    print(f"[{card}] one all-reduce of [4096, 1280] bf16 over a one-rank NCCL group: "
          f"{out['all_reduce_ms']:.4f} ms", flush=True)
    del sam, fused, qsam
    torch.cuda.empty_cache()

    # GPipe over CLIP B/32's text tower (12 blocks) at S = 1, M = GPIPE_MICRO
    from torch.func import functional_call

    from cm3d_tpu_torch.models.clip_text import (
        CLIP_TEXT_B32, ClipTextEncoder, ResidualAttentionBlock, init_clip_weights)
    from cm3d_tpu_torch.parallel.gpipe import make_pipeline_fn, stack_layer_params, stage_mesh
    from torch_parallel_programs import clip_block_stage

    cfg = CLIP_TEXT_B32
    clip = init_clip_weights(ClipTextEncoder(cfg), torch.Generator().manual_seed(0)).cuda()
    layers = [{k: v.detach() for k, v in blk.state_dict().items()}
              for blk in clip.transformer.resblocks]
    stacked = {k: v[None].clone().requires_grad_(True)
               for k, v in stack_layer_params(layers).items()}
    x = torch.randn(GPIPE_MICRO, GPIPE_BATCH, cfg.context_length, cfg.width, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    mask = torch.full((cfg.context_length,) * 2, -torch.inf, device="cuda").triu(1)
    with torch.device("meta"):
        block = ResidualAttentionBlock(cfg.width, cfg.heads)
    leaves = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in layers]

    def sequential():
        ys = []
        for xi in x:
            for p in leaves:
                xi = functional_call(block, p, (xi, mask))
            ys.append(xi)
        return torch.stack(ys)

    y_seq = sequential()
    (y_seq ** 2).sum().backward()
    with DataParallelGroup(stage_mesh(1, devices=cards), "cuda") as group:
        run = make_pipeline_fn(group, functools.partial(clip_block_stage, cfg.width, cfg.heads,
                                                        cfg.context_length))
        y = run(stacked, x)
        (y ** 2).sum().backward()
        fwd_err = float((y - y_seq).abs().max()) / float(y_seq.abs().max())
        grad_err = max(float((stacked[k].grad[0, i] - leaves[i][k].grad).abs().max())
                       / max(float(leaves[i][k].grad.abs().max()), 1e-30)
                       for k in stacked for i in range(cfg.layers))
        check(fwd_err <= 1e-5 and grad_err <= 1e-4,
              f"GPipe over CLIP B/32's 12 blocks (S = 1, M = {GPIPE_MICRO}) against the "
              f"sequential apply: forward {fwd_err:.3g}, gradients {grad_err:.3g} relative")

        def step(fn):
            return lambda: (fn() ** 2).sum().backward()

        times = {"sequential": [], "gpipe": []}
        for tag, fn in (("sequential", sequential), ("gpipe", lambda: run(stacked, x)),
                        ("gpipe", lambda: run(stacked, x)), ("sequential", sequential)):
            times[tag].append(time_ms(torch, step(fn), reps=3))
    out["gpipe"] = {"forward_max_rel_err": fwd_err, "grad_max_rel_err": grad_err,
                    "step_ms": times, "micro": GPIPE_MICRO, "batch": GPIPE_BATCH}
    print(f"[{card}] GPipe, CLIP B/32 text tower, S = 1, M = {GPIPE_MICRO} x {GPIPE_BATCH} "
          f"sequences: forward {fwd_err:.3g}, gradients {grad_err:.3g} relative to the "
          f"sequential apply; ms a forward + backward {times}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 22 (model parallel at world size 1): {out['phase_s']:.1f} s",
          flush=True)
    return out


def model_parallel_phase_in_child() -> dict:
    """Run phase 22 in a child process (it starts and ends its own NCCL
    groups; its inference numbers want no CUBLAS_WORKSPACE_CONFIG) and
    return its results: the child prints its progress lines, then one JSON
    line, which is parsed here."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), MODEL_PARALLEL_FLAG],
                          env=env, stdout=subprocess.PIPE, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(proc.returncode == 0 and lines, f"the model-parallel phase's process exited with "
          f"{proc.returncode}: {lines[-1] if lines else 'no output'}")
    return json.loads(lines[-1])


# --- 23. the benchmark entry (python -m cm3d_tpu_torch.bench) ----------------

BENCH_ENTRY_FLAG = "--bench-entry-phase"  # the child process of phase 23
ENTRY_RUNS = (  # (argv, the metric its line must name), each in a process of its own
    (("--stage", "lift"), "lift_keyframes_per_sec_per_chip"),
    (("--stage", "masks"), "mask_stage_keyframes_per_sec_per_chip"),
    (("--stage", "e2e"), "e2e_keyframes_per_sec_per_chip"),
    (("--stage", "masks", "--rect_encode", "--sam_size", "vit_l"),
     "mask_stage_keyframes_per_sec_per_chip"),
    (("--stage", "train"), "train_step_ms_batch8"),
    (("--stage", "fusion_train"), "fusion_train_step_ms_batch8"),
    (("--stage", "fusion_train", "--swin_camera", "--camera_bf16"), "fusion_train_step_ms_batch8"),
)
ENTRY_REFUSALS = (  # (argv, the JAX entry's message)
    (("--stage", "lfit"), "unknown --stage 'lfit'"),
    (("--stage", "lift", "--rect_encode"),
     "--rect_encode/--quant_int8/--sam_size only apply to --stage masks|e2e"),
)
FAST_PROFILE_ARGV = ("--stage", "e2e", "--profile", "fast")
ENTRY_TIMEOUT_S = 300  # one entry run
A16_RTOL = 1e-6  # A16 card vs CPU, x the tensor's largest |value|
MEDOID_INDEX_ROWS = 64  # rows of a lift step held through medoid_index


def entry_line(argv) -> dict:
    """`cm3d_tpu_torch.bench.main(argv)` in this process, so that the launch
    counts read around it are the run's own: its standard output must be
    exactly one JSON line, which is returned."""
    import contextlib
    import io

    from cm3d_tpu_torch import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(list(argv))
    lines = buf.getvalue().splitlines()
    cmd = " ".join(("python -m cm3d_tpu_torch.bench",) + tuple(argv))
    check(len(lines) == 1, f"{cmd}: one stdout line, got {lines}")
    print(lines[0], flush=True)
    return json.loads(lines[0])


def entry_run(argv) -> dict:
    """`python -m cm3d_tpu_torch.bench *argv` from the checkout's root, in a
    process of its own: exit code, stdout lines, stderr, seconds."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "cm3d_tpu_torch.bench", *argv],
                          cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
                          capture_output=True, text=True, timeout=ENTRY_TIMEOUT_S)
    return {"rc": proc.returncode, "lines": proc.stdout.splitlines(), "stderr": proc.stderr,
            "s": time.perf_counter() - t0}


def entry_runs_phase(card: str) -> dict:
    """Every stage through the entry, each in its own process: exit 0 and
    exactly one stdout line, JSON, naming the stage's metric with a finite
    positive value; then two refusals: non-zero, the JAX entry's message,
    no stdout."""
    out = {"runs": [], "refusals": []}
    for argv, metric in ENTRY_RUNS:
        run = entry_run(argv)
        cmd = " ".join(("python -m cm3d_tpu_torch.bench",) + argv)
        for ln in run["lines"]:
            print(ln, flush=True)
        tail = "\n".join(run["stderr"].splitlines()[-20:])
        check(run["rc"] == 0, f"{cmd} exited with {run['rc']}:\n{tail}")
        check(len(run["lines"]) == 1, f"{cmd}: one stdout line, got {len(run['lines'])}")
        line = json.loads(run["lines"][0])
        check(line["metric"] == metric and np.isfinite(line["value"]) and line["value"] > 0,
              f"{cmd}: {metric} with a finite positive value, got {line}")
        print(f"[{card}] {cmd}: exit 0, one line, {run['s']:.1f} s", flush=True)
        out["runs"].append({"argv": list(argv), "line": line, "s": run["s"]})
    for argv, message in ENTRY_REFUSALS:
        run = entry_run(argv)
        cmd = " ".join(("python -m cm3d_tpu_torch.bench",) + argv)
        said = run["stderr"].strip().splitlines()
        check(run["rc"] != 0 and not run["lines"] and said and said[-1] == message,
              f"{cmd}: refused with {message!r} and no stdout, got exit {run['rc']}, "
              f"stdout {run['lines']}, stderr {said[-1:]}")
        print(f"[{card}] {cmd}: refused (exit {run['rc']}): {said[-1]}", flush=True)
        out["refusals"].append({"argv": list(argv), "rc": run["rc"], "message": said[-1]})
    return out


def fast_profile_launch_phase(torch, card: str) -> dict:
    """`--stage e2e --profile fast` through the entry in this process, at
    the entry's own shapes (12 timed keyframes a point in batches of 4):
    every launch count set to 0 just before each point and read just after
    (3 B1 + 1 B2 a lift step, 24 + 24 B3 a Detic forward, no B4), and the
    entry's one line held to four points with the same boxes kept."""
    import cm3d_tpu_torch.benchmarks as benchmarks
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.kernels.window_attn_relpos import (
        window_attn_relpos_heads,
        window_attn_relpos_proj,
    )

    wrappers = (compact_rows, medoid_distance_sums_rows, window_attn_heads, window_attn_proj,
                window_attn_relpos_heads, window_attn_relpos_proj)
    real, points = benchmarks.bench_e2e, []

    def counted(**kw):
        for wr in wrappers:
            wr.launches = 0
        r = real(**kw)
        launches = {wr.__name__: wr.launches for wr in wrappers}
        frames = kw["batch_size"] + kw["n_frames"]  # the warm-up run, then the timed one
        steps = 1 + -(-kw["n_frames"] // kw["batch_size"])
        want = {"compact_rows": 3 * steps, "medoid_distance_sums_rows": steps,
                "window_attn_heads": SWIN_BLOCKS_PER_FORWARD * frames,
                "window_attn_proj": SWIN_BLOCKS_PER_FORWARD * frames,
                "window_attn_relpos_heads": 0, "window_attn_relpos_proj": 0}
        mode = {k: kw.get(k, False) for k in ("sam_size", "rect_encode", "quant_int8")}
        check(launches == want, f"fast profile point {mode}: launches {launches}, expected "
              f"{want} over {frames} keyframes and {steps} lift steps")
        points.append({**mode, "launches": launches, "keyframes": frames, "lift_steps": steps,
                       "batch_size": kw["batch_size"],
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        return r

    t0 = time.perf_counter()
    benchmarks.bench_e2e = counted
    try:
        prof = entry_line(FAST_PROFILE_ARGV)
    finally:
        benchmarks.bench_e2e = real
    s = time.perf_counter() - t0
    check(prof["metric"] == "e2e_fast_profile_keyframes_per_sec_per_chip"
          and np.isfinite(prof["value"]) and prof["value"] > 0,
          f"the fast profile's line: its metric with a finite positive value: {prof}")
    check(len(prof["points"]) == 4 == len(points) and prof["boxes_invariant_across_modes"] is True,
          f"the fast profile: four points, counted, with the same boxes kept: {prof}")
    for p, q in zip(prof["points"], points):
        print(f"  {p['profile']}: peak device memory {q['peak_gib']:.2f} GiB", flush=True)
    print(f"[{card}] {' '.join(('python -m cm3d_tpu_torch.bench',) + FAST_PROFILE_ARGV)} in this "
          f"process: one line, {s:.1f} s; launches a point (counted in that run) "
          f"{[p['launches'] for p in points]}", flush=True)
    return {"profile": prof, "points": points, "s": s}


def _a16_cases(torch, rng):
    """The A16 functions on seeded inputs at 1e3 m (name -> (fn, args))."""
    from cm3d_tpu_torch import geometry as g

    def quats(*shape):
        q = rng.normal(size=shape + (4,))
        return torch.tensor(q / np.linalg.norm(q, axis=-1, keepdims=True), dtype=torch.float32)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32)

    batch = (8, 16)
    rot = g.quat_to_rotmat(quats(*batch))
    trans = f32(rng.uniform(-1e3, 1e3, batch + (3,)))
    tm = g.transform_matrix(trans, quats(*batch))
    pts = f32(rng.uniform(-1e3, 1e3, batch + (256, 5)))
    yaw = f32(rng.uniform(-np.pi, np.pi, batch))
    pivots = f32(np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                           np.diag([-1.0, -1, 1]), [[0, 0, 1], [1, 0, 0], [0, 1, 0]],
                           [[0, 1, 0], [1, 0, 0], [0, 0, -1]]]))
    return {
        "rotmat_to_quat": (g.rotmat_to_quat, (torch.cat([rot.reshape(-1, 3, 3), pivots]),)),
        "yaw_to_quat": (g.yaw_to_quat, (yaw,)),
        "quat_to_yaw": (g.quat_to_yaw, (quats(*batch),)),
        "yaw_rotmat": (g.yaw_rotmat, (yaw,)),
        "quat_multiply": (g.quat_multiply, (quats(*batch), quats(*batch))),
        "quat_inverse": (g.quat_inverse, (quats(*batch),)),
        "transform_matrix": (g.transform_matrix, (trans, quats(*batch))),
        "transform_matrix_inverse": (lambda t, q: g.transform_matrix(t, q, inverse=True),
                                     (trans, quats(*batch))),
        "invert_se3": (g.invert_se3, (tm,)),
        "compose": (g.compose, (tm, g.invert_se3(tm), tm)),
        "apply_se3": (g.apply_se3, (tm, pts[..., :3])),
        "remove_close_mask": (g.remove_close_mask, (pts * 1e-3, 0.5)),
        "rotate_points": (g.rotate_points, (pts, rot)),
        "translate_points": (g.translate_points, (pts, trans)),
        "transform_points": (g.transform_points, (pts, tm)),
    }


def a16_phase(torch, card: str) -> dict:
    """The A16 geometry helpers on the card against the same functions on
    the CPU (within A16_RTOL of each tensor's largest value; booleans
    equal), then medoid_index on compacted rows of a lift step of
    bench_lift's keyframes against the plain version's index (equal
    wherever the two smallest sums differ by more than 1e-5 relative), one
    B2 launch a call."""
    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
    from cm3d_tpu_torch.kernels.medoid import (
        medoid_distance_sums_rows,
        medoid_distance_sums_rows_plain,
    )
    from cm3d_tpu_torch.ops.medoid import medoid_index
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn

    errs = {}
    for name, (fn, args) in _a16_cases(torch, np.random.default_rng(23)).items():
        want = fn(*args)
        got = fn(*[a.cuda() if torch.is_tensor(a) else a for a in args]).cpu()
        check(got.shape == want.shape and got.dtype == want.dtype, f"A16 {name}: shape, dtype")
        if want.dtype == torch.bool:
            check(torch.equal(got, want), f"A16 {name}: card equal to the CPU")
            errs[name] = 0.0
            continue
        errs[name] = float((got - want).abs().max() / want.abs().max())
        check(errs[name] <= A16_RTOL, f"A16 {name}: card vs CPU {errs[name]:.3g} of the "
              f"largest value, above {A16_RTOL}")

    # medoid_index on compacted rows of a step of bench_lift's first 2 keyframes
    cfg, rng = LiftStageConfig(), np.random.default_rng(0)
    host = stack_keyframes([make_keyframe(SyntheticConfig(), cfg, rng) for _ in range(2)])
    step = make_keyframe_step_fn(cfg, device="cuda")
    _, (rows, valid) = capture_kernel_inputs(torch, step, to_device(host.frames, "cuda"))
    counts = valid.sum(1)
    order = torch.argsort(counts, descending=True)[:MEDOID_INDEX_ROWS]
    order = order[counts[order] > 1]
    medoid_distance_sums_rows.launches = 0
    got = [int(medoid_index(rows[r].T.contiguous(), valid[r])) for r in order.tolist()]
    launches = medoid_distance_sums_rows.launches
    plain = torch.where(valid[order], medoid_distance_sums_rows_plain(rows[order], valid[order]),
                        torch.tensor(float("inf"), device="cuda"))
    two = torch.topk(plain, 2, dim=1, largest=False).values
    near_tie = ((two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0].abs()).tolist()
    want = torch.argmin(plain, 1).tolist()
    differ = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    check(all(near_tie[i] for i in differ), f"medoid_index equal to the plain index wherever "
          f"the two smallest sums differ by > 1e-5 relative: rows {differ}")
    check(launches == len(got), f"one B2 launch a medoid_index call: {launches} for {len(got)}")
    out = {"max_rel_err": errs, "medoid_index_rows": len(got),
           "medoid_index_points": [int(counts[order[0]]), int(counts[order[-1]])],
           "medoid_index_differ_at_near_ties": len(differ), "medoid_index_launches": launches}
    print(f"[{card}] A16 card vs CPU, x the largest value: {json.dumps(errs)}; medoid_index on "
          f"{len(got)} compacted rows of a lift step ({out['medoid_index_points']} points at "
          f"most / least): {len(differ)} differ, all at near ties; {launches} B2 launches",
          flush=True)
    return out


def sam_encode_phase(torch, card: str) -> dict:
    """SAM ViT-H / L / B bf16 (random weights, seed 1 as the benches' SAM)
    on a blobby 1024x576 image: the rect encode's image-region embedding
    against the square encode's (relative error, the envelope of the fast
    profile's rect points) and ms an encode square / rect in turns."""
    from cm3d_tpu_torch.benchmarks import IMG_H, IMG_W
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.sam import Sam, sam_config_for

    rng = np.random.default_rng(0)
    img = rng.normal(0, 0.3, (IMG_H, IMG_W, 3)).astype(np.float32)
    yy, xx = np.arange(IMG_H)[:, None], np.arange(IMG_W)[None, :]
    for _ in range(30):  # blobs: pure noise has no spatial structure at all
        cy, cx = rng.integers(0, IMG_H), rng.integers(0, IMG_W)
        ry, rx = rng.integers(20, 90), rng.integers(20, 120)
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] += rng.normal(0, 1.5, 3)
    rect = torch.tensor(img[None], device="cuda")
    out = {}
    for size in ("vit_h", "vit_l", "vit_b"):
        with torch.device("cuda"):
            gen = torch.Generator(device="cuda")
            sam = init_weights(Sam(dataclasses.replace(sam_config_for(size), dtype="bfloat16")),
                               gen.manual_seed(1))
        # SamPredictor's square: the image zero-padded at the bottom
        square = torch.nn.functional.pad(rect, (0, 0, 0, 0, 0, sam.cfg.img_size - IMG_H))
        with torch.inference_mode():
            e_sq = sam.encode_image(square).float()
            e_rc = sam.encode_image(rect).float()
            gh = IMG_H // sam.cfg.patch_size
            check(tuple(e_rc.shape[1:3]) == (gh, IMG_W // sam.cfg.patch_size),
                  f"{size}: the rect embedding covers the image region")
            ref = e_sq[:, :gh]
            rel = float(torch.linalg.vector_norm(e_rc - ref) / torch.linalg.vector_norm(ref))
            times = {"square": [], "rect": []}
            for kind in ("square", "rect", "rect", "square"):
                x = square if kind == "square" else rect
                times[kind].append(time_ms(torch, lambda: sam.encode_image(x), reps=5))
        out[size] = {"rect_emb_rel_err": rel, "encode_ms": times}
        del sam, square, e_sq, e_rc, ref
        torch.cuda.empty_cache()
    print(f"[{card}] SAM bf16 encode of one 1024x576 image, ms square / rect in turns, and the "
          f"rect image-region embedding's rel err against the square's: {json.dumps(out)}",
          flush=True)
    return out


def bench_entry_phase(torch) -> dict:
    """Phase 23: the benchmark entry, each stage in its own process; the
    fast profile through the entry in this one, its launches counted; the
    A16 functions on the card; SAM's rect encode against the square one."""
    from cm3d_tpu_torch.kernels import build

    card = card_line()
    print(card, flush=True)
    t_phase = time.perf_counter()
    build.build_all()  # the entry's processes find the libraries built
    out = {"card": card, "entry": entry_runs_phase(card)}
    out["fast_profile"] = fast_profile_launch_phase(torch, card)
    out["a16"] = a16_phase(torch, card)
    out["sam_encode"] = sam_encode_phase(torch, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[{card}] phase 23 (the benchmark entry): {out['phase_s']:.1f} s", flush=True)
    return out


def bench_entry_phase_in_child() -> dict:
    """Run phase 23 in a child process (its inference numbers want no
    CUBLAS_WORKSPACE_CONFIG) and return its results: the child prints its
    progress lines, then one JSON line, which is parsed here."""
    env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), BENCH_ENTRY_FLAG],
                          env=env, stdout=subprocess.PIPE, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(proc.returncode == 0 and lines, f"the benchmark entry phase's process exited with "
          f"{proc.returncode}: {lines[-1] if lines else 'no output'}")
    return json.loads(lines[-1])


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import cm3d_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the cm3d_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    if argv == [DETERMINISTIC_FLAG]:
        print(json.dumps(deterministic_phases(torch)), flush=True)
        return 0
    if argv == [KERNEL_TIMES_FLAG]:
        print(json.dumps(kernel_times(torch)), flush=True)
        return 0
    if argv == [HOST_BENCHES_FLAG]:
        print(json.dumps(host_benches(torch)), flush=True)
        return 0
    if argv == [DATA_PARALLEL_FLAG]:
        print(json.dumps(data_parallel_phase(torch)), flush=True)
        return 0
    if argv == [MODEL_PARALLEL_FLAG]:
        print(json.dumps(model_parallel_phase(torch)), flush=True)
        return 0
    if argv == [BENCH_ENTRY_FLAG]:
        print(json.dumps(bench_entry_phase(torch)), flush=True)
        return 0
    if argv == [SAM_GLOBAL_ATTN_FLAG]:
        print(card_line(), flush=True)
        print(json.dumps(sam_global_attn_phase(torch)), flush=True)
        return 0
    if argv in ([QUANT_ZOE_FLAG], [GDINO_FLAG]):
        from cm3d_tpu_torch.kernels import build

        card = card_line()
        print(card, flush=True)
        build.build_all()
        phase = quant_zoe_phase if argv == [QUANT_ZOE_FLAG] else gdino_phase
        print(json.dumps(phase(torch, card)), flush=True)
        return 0
    from cm3d_tpu_torch.benchmarks import (
        IMG_H,
        IMG_W,
        _realistic_load,
        build_production_fake_models,
    )
    from cm3d_tpu_torch.config import LiftStageConfig, MaskStageConfig
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes, to_device
    from cm3d_tpu_torch.kernels import build
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.pipelines.masks import generate_frame_masks

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # --- 1. build ---
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build.build_logs.items():
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: {' | '.join(usage)}", flush=True)
        for ln in log.splitlines():
            if "warning" in ln.lower():
                print(f"  {name}: {ln.strip()}", flush=True)
    # the bf16 GEMM kernels run on wgmma with TMA loads, and no mma.sync
    sass = sass_facts()
    for key, counts in sass.items():
        print(f"  SASS {key}: {counts}", flush=True)
    for kind in ("qkv_gemm_kernel", "proj_gemm_kernel"):
        bf = [v for k, v in sass.items() if f":{kind}:bf16" in k]
        check(bf and all(v["HGMMA"] > 0 and v["UTMALDG"] > 0 and v["HMMA"] == 0 for v in bf),
              f"the bf16 {kind} runs wgmma (HGMMA) on TMA loads (UTMALDG), no mma.sync: {bf}")

    # --- 2. kernels on a real batch-8 step's inputs ---
    cfg = LiftStageConfig()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    host = stack_keyframes([make_keyframe(SyntheticConfig(), cfg, rng) for _ in range(8)])
    frames = to_device(host.frames, dev)
    print(f"8 synthetic keyframes: {time.perf_counter() - t0:.2f} s", flush=True)
    step = make_keyframe_step_fn(cfg, device=dev)
    compactions, (med_rows, med_valid) = capture_kernel_inputs(torch, step, frames)
    stages = compaction_phase(torch, compactions)
    med = medoid_phase(torch, med_rows, med_valid)
    del compactions, med_rows, med_valid

    # --- 3. the main path, counted ---
    compact_rows.launches = 0
    medoid_distance_sums_rows.launches = 0
    n_iters = 10  # the entry's default run: bench_lift(batch_size=8, n_iters=10) on CUDA
    bench = entry_line([])
    check(bench["metric"] == "lift_keyframes_per_sec_per_chip" and "note" in bench,
          f"the entry's default run prints the lift line with its note: {bench}")
    launches = {"compact_rows": compact_rows.launches,
                "medoid_distance_sums_rows": medoid_distance_sums_rows.launches}
    print(f"main-path launches over {n_iters + 1} steps: {launches}", flush=True)
    check(launches["compact_rows"] == 3 * (n_iters + 1),
          f"3 compaction launches per step, got {launches['compact_rows']}")
    check(launches["medoid_distance_sums_rows"] == n_iters + 1,
          f"1 medoid launch per step, got {launches['medoid_distance_sums_rows']}")

    compact_rows.launches = 0
    medoid_distance_sums_rows.launches = 0
    lift, boxes = step(frames)
    torch.cuda.synchronize()
    check(compact_rows.launches == 3 and medoid_distance_sums_rows.launches == 1,
          "one checked step launches 3 compactions and 1 medoid")
    b, m = host.frames.mask_valid.shape
    check(tuple(lift.centroids.shape) == (b, m, 3) and tuple(boxes.centers.shape) == (b, m, 3),
          "output shapes")
    check(bool(torch.isfinite(lift.centroids).all()) and bool(torch.isfinite(boxes.centers).all()),
          "finite centroids and centers")
    n_has, n_keep = int(lift.has_points.sum()), int(boxes.keep.sum())
    print(f"step: {n_has} masks with points, {n_keep} boxes kept of "
          f"{int(host.frames.mask_valid.sum())} valid masks", flush=True)
    check(n_has > 0 and n_keep > 0, "masks lift to points and boxes survive")
    profile_phase(torch, lambda: step(frames))

    # the same 2 keyframes through the plain PyTorch path on the CPU
    t0 = time.perf_counter()
    cpu_step = make_keyframe_step_fn(cfg, device="cpu")
    two = map_fields(lambda x: x[:2], host.frames)
    cpu_lift, cpu_boxes = cpu_step(to_device(two, "cpu"))
    for name, got, want in (
        ("point_counts", lift.point_counts, cpu_lift.point_counts),
        ("has_points", lift.has_points, cpu_lift.has_points),
        ("truncated", lift.truncated, cpu_lift.truncated),
        ("cam_truncated", lift.cam_truncated, cpu_lift.cam_truncated),
        ("keep", boxes.keep, cpu_boxes.keep),
    ):
        check(torch.equal(got[:2].cpu(), want), f"{name} equal to the CPU path")
    # a medoid may flip only where its two smallest sums are within 1e-5
    near_tie = med["near_tie"].reshape(b, m)[:2].cpu()
    close = torch.isclose(lift.centroids[:2].cpu(), cpu_lift.centroids,
                          rtol=0.0, atol=1e-4).all(-1)
    check(bool((close | near_tie).all()), "centroids allclose to the CPU path")
    print(f"CPU check on 2 keyframes: {time.perf_counter() - t0:.2f} s, "
          f"{int((~close).sum())} centroids differ (all at near-tie medoids)", flush=True)

    # --- 4. window attention at the 8 shapes of a full-width Detic forward ---
    t0 = time.perf_counter()
    prod = build_production_fake_models("bfloat16", device=dev)
    torch.cuda.synchronize()
    print(f"full-width Detic Swin-B + SAM ViT-H, bf16, random weights: "
          f"{time.perf_counter() - t0:.2f} s to build", flush=True)
    ring = [rng.integers(0, 255, (IMG_H, IMG_W, 3)).astype(np.uint8) for _ in range(N_CAMERAS)]
    wa = window_attn_phase(torch, capture_window_attn_inputs(
        torch, lambda: prod.detic(prod.prepare(ring))))

    # --- 5. the mask stage, counted, then one keyframe profiled ---
    realistic = _realistic_load(prod)
    benches = mask_stage_phase(torch, realistic)
    profile_phase(torch, lambda: generate_frame_masks(realistic, ring, MaskStageConfig()),
                  n_steps=2)

    # --- 7. SAM's rel-pos window attention, and the encode with and without it ---
    t0 = time.perf_counter()
    prod_fused = build_production_fake_models("bfloat16", device=dev, fused_window_attn=True)
    torch.cuda.synchronize()
    print(f"the same models with SAM's windowed blocks fused: "
          f"{time.perf_counter() - t0:.2f} s to build", flush=True)
    frame = prod.prepare(ring)
    rp = relpos_phase(torch, capture_relpos_inputs(torch, prod_fused, frame))
    sga = sam_global_attn_phase(torch)
    encode_ab = encode_ab_phase(torch, prod, prod_fused, frame)

    # --- 8. the fused images -> boxes path, counted: fused blocks, then unfused ---
    e2e_fused = e2e_phase(torch, _realistic_load(prod_fused), fused=True)
    e2e_unfused = e2e_phase(torch, realistic, fused=False)
    del prod, realistic, prod_fused, frame
    torch.cuda.empty_cache()

    # --- 6. the mask path, 9. the fused path, on the card against the CPU ---
    cpu_check = mask_cpu_check(torch)
    e2e_check = e2e_cpu_check(torch)

    # --- 15. released checkpoints, 16. the Waymo path, 17. the KITTI path ---
    released = released_weights_phase(torch)
    batches = {}  # phase 16 / 17's host keyframes, for phase 19
    waymo = waymo_phase(torch, batches)
    kitti = kitti_phase(torch, batches)

    # --- 10.-14. the training path ---
    seg = segment_phase(torch, *capture_segment_inputs(torch))
    swin_t = swin_t_phase(torch)
    train = train_phase(torch)
    train_check = train_cpu_check(torch)
    torch.cuda.empty_cache()
    deterministic = deterministic_phases_in_child()

    # --- 18. every data-parallel path at world size 1, over NCCL ---
    data_parallel = data_parallel_phase_in_child()

    # --- 19. the lift and detect steps as artifacts, served over HTTP; conform ---
    deploy_serve = deploy_serve_phase(torch, host.frames, card, batches)
    lift_artifact_launches = {
        name: deploy_serve[f"lift_{name}"]["launches_per_call"]
        for name in ("nuscenes", "waymo", "kitti")}
    detect_artifact_launches = {
        name: deploy_serve[f"detect_{name}"]["launches_per_call"]
        for name in ("centerpoint", "bevfusion_conv", "bevfusion_swin_t")}

    # --- 20. the int8 speed modes and ZoeDepth ---
    quant_zoe = quant_zoe_phase(torch, card)
    quant_e2e_launches = quant_zoe["stages"]["e2e_launches"]["int8"]

    # --- 21. GroundingDINO ---
    gdino = gdino_phase(torch, card)

    # --- 22. model parallelism at world size 1, over NCCL ---
    model_parallel = model_parallel_phase_in_child()

    # --- 23. the benchmark entry ---
    bench_entry = bench_entry_phase_in_child()
    fast_launches = {p["sam_size"] + ("_rect" if p["rect_encode"] else "")
                     + ("_int8" if p["quant_int8"] else ""): p["launches"]
                     for p in bench_entry["fast_profile"]["points"]}

    def fast_profile_launches(kernel):
        """Phase 23: a kernel's launches at each point of the in-process fast
        profile."""
        return {point: n[kernel] for point, n in fast_launches.items()}

    def artifact_launches(kernel, table):
        """A kernel's launches a call of each artifact that runs it."""
        return {name: n[kernel] for name, n in table.items() if kernel in n}

    # --- 24. summary ---
    def per_forward(name, key):
        """Sum over the 24 blocks of one Detic forward (6 cameras)."""
        return sum(r[name][key] * r["blocks_per_forward"] for r in wa)

    def window_attn_entry(name):
        ops = per_forward(name, "ops_ms")
        return {
            "name": f"window_attn_{name}",
            "route": "cuda",
            "source": "cm3d_tpu_torch/csrc/window_attn.cu",
            "replaces": "cm3d_tpu/kernels/window_attn_pallas.py:303",
            "launches": benches[0]["launches"][f"window_attn_{name}"],
            "max_abs_err": max(r[name]["max_abs_err"] for r in wa),
            "ms": per_forward(name, "ms"),
            "plain_ms": per_forward(name, "plain_ms"),
            "bound_ms": per_forward(name, "bound_ms"),
            "bound_by": "operations" if ops >= per_forward(name, "bytes_ms") else "bytes",
            "library_ms": None,
            "per": "one Detic forward: 24 launches, 6 cameras at 1024x576, bf16",
            # the same kernels on loaded weights (one keyframe) and on the
            # Waymo ring (8 keyframes: tiny Detic, then Swin-B)
            "released_launches": released["launches"][f"window_attn_{name}"],
            "waymo_fused_launches": waymo["fused_launches"][f"window_attn_{name}"],
            "waymo_full_width_launches":
                waymo["full_width_fused_launches"][f"window_attn_{name}"],
            "waymo_full_width_max_rel_err": max(
                r["max_rel_err"] for r in waymo["full_width_window_attn"]),
            # KITTI (8 frames of changing size): tiny Detic, then Swin-B
            "kitti_fused_launches": kitti["fused_launches"][f"window_attn_{name}"],
            "kitti_full_width_launches":
                kitti["full_width_fused_launches"][f"window_attn_{name}"],
            "kitti_full_width_max_rel_err": max(
                r["max_rel_err"] for r in kitti["full_width_window_attn"]),
            # Detic with int8 MLPs: one forward, and the int8 fused e2e run
            "int8_detic_launches": quant_zoe["detic"]["launches"][f"window_attn_{name}"],
            "int8_e2e_launches": quant_e2e_launches[f"window_attn_{name}"],
            # phase 22: a camera-parallel Detic forward at world size 1
            "camera_mesh_launches":
                model_parallel["camera_mesh_detic_launches"][f"window_attn_{name}"],
            # phase 23: each point of the fast profile, 24 + 24 a keyframe
            "fast_profile_launches": fast_profile_launches(f"window_attn_{name}"),
            **_per_forward_extras(wa, name, "blocks_per_forward"),
            **gdino_extras(name),
        }

    def gdino_extras(name):
        """GroundingDINO's Swin-T (phase 21): launches a six-camera keyframe
        (two chunks of 3) in f32 / bf16 / int8 and over the mask-stage
        bench, and one chunk forward's 12 launches at 3 x 800x1216 (f32 and
        bf16 launches on the f32 capture): ms, plain ms, bound."""
        recs = gdino["window_attn_shapes"]
        extra = {f"gdino_{mode}_launches": gdino["launches_per_keyframe"][mode][
            f"window_attn_{name}"] for mode in ("f32", "bf16", "int8")}
        extra["gdino_mask_stage_launches"] = [b[f"window_attn_{name}"]
                                              for b in gdino["mask_stage_launches"]]
        extra["gdino_max_rel_err"] = max(r["max_rel_err"] for r in recs)
        extra["gdino_f32_max_abs_err"] = max(r["f32_max_abs_err"] for r in recs)
        for part, label in ((name, "bf16"), (f"{name}_f32", "f32")):
            for k in ("ms", "plain_ms", "bound_ms"):
                extra[f"gdino_chunk_{label}_{k}"] = sum(r[part][k] * r["blocks_per_forward"]
                                                        for r in recs)
        return extra

    def _per_forward_extras(recs, name, mult_key):
        """The heads launcher's split by kernel and the yardstick calls,
        summed like the times."""
        out = {}
        if name == "heads":
            split = {}
            for r in recs:
                for k, v in r[name]["split_ms"].items():
                    split[k] = split.get(k, 0.0) + v * (r[mult_key] if mult_key else 1)
            out["split_ms"] = split
            # the attention kernel alone beside its own bound
            for k in ("ms", "bound_ms"):
                if all(r[name]["attn"][k] for r in recs):
                    out[f"attn_kernel_{k}"] = sum(r[name]["attn"][k] * (r[mult_key] if mult_key
                                                                        else 1) for r in recs)
        key = "sdpa_yardstick_ms" if name == "heads" else "linear_yardstick_ms"
        if all(key in r[name] for r in recs):
            out[key] = sum(r[name][key] * (r[mult_key] if mult_key else 1) for r in recs)
        # the bf16 GEMM that the launcher runs, and F.linear on its operands
        part = "qkv" if name == "heads" else "proj"
        if all(r["gemm"][part]["kernel_ms"] for r in recs):
            for k in ("kernel_ms", "linear_yardstick_ms"):
                out[f"{part}_gemm_{k}"] = sum(r["gemm"][part][k] * (r[mult_key] if mult_key else 1)
                                              for r in recs)
        return out

    def relpos_entry(name, source):
        """One square ViT-H encode: 28 launches at [1, 64, 64, 1280]."""
        sq = rp[0][name]
        return {
            "name": f"window_attn_relpos_{name}",
            "route": "cuda",
            "source": source,
            "replaces": "cm3d_tpu/kernels/window_attn_pallas.py:520",
            "launches": e2e_fused["launches"][f"window_attn_relpos_{name}"],
            "max_abs_err": max(r[name]["max_abs_err"] for r in rp),
            "ms": sq["ms"] * SAM_WINDOWED_BLOCKS,
            "plain_ms": sq["plain_ms"] * SAM_WINDOWED_BLOCKS,
            "bound_ms": sq["bound_ms"] * SAM_WINDOWED_BLOCKS,
            "bound_by": "operations" if sq["ops_ms"] >= sq["bytes_ms"] else "bytes",
            "library_ms": None,
            "per": "one ViT-H encode of one camera: 28 launches at [1, 64, 64, 1280], bf16",
            # one fused encode of a KITTI frame, and the kernels at its grid
            "kitti_launches": kitti["fused_encode_launches"][f"window_attn_relpos_{name}"],
            "kitti_max_rel_err": kitti["relpos"]["max_rel_err"],
            # phase 22: a fused encode through shard_model_params and the
            # sequence-sharded encode on a model group of one
            "sharded_launches":
                model_parallel["vit_h"]["fused"]["launches"][f"window_attn_relpos_{name}"],
            "sequence_sharded_launches":
                model_parallel["vit_h"]["fused"]["seq_launches"][f"window_attn_relpos_{name}"],
            **{k: v * SAM_WINDOWED_BLOCKS if isinstance(v, float) else
               {kk: vv * SAM_WINDOWED_BLOCKS for kk, vv in v.items()}
               for k, v in _per_forward_extras(rp[:1], name, None).items()},
        }

    def segment_entry(name, key, replaces, launches):
        rec = seg[key]
        extra = {"artifact_launches": artifact_launches(name, detect_artifact_launches)}
        if name == "segment_sum_max":
            extra["served_launches"] = deploy_serve["serve_detect"]["launches"][name]
        return {
            **extra,
            "name": name,
            "route": "cuda",
            "source": "cm3d_tpu_torch/csrc/segment.cu",
            "replaces": replaces,
            "launches": launches,
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
            **{k: rec[k] for k in ("bound_all_values_ms", "device_span_ms", "kernels_ms")
               if k in rec},
            "bound_by": "bytes",
            "per": f"one batch-{TRAIN_BATCH} training step: R={rec['rows']} N={rec['n']} "
                   f"D={rec['channels']} cells={rec['n_cells']}, f32",
        }

    def swin_t_entry(name):
        """One Swin-T camera forward of a batch-8 ring: 12 f32 launches."""
        part = f"{name}_f32"
        total = {k: sum(r[part][k] * r["blocks_per_forward"] for r in swin_t)
                 for k in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms")}
        return {
            "name": f"window_attn_{name}_swin_t",
            "route": "cuda",
            "source": "cm3d_tpu_torch/csrc/window_attn.cu",
            "replaces": "cm3d_tpu/kernels/window_attn_pallas.py:303",
            "launches": train["bench_fusion_train swin_t"]["launches"][f"window_attn_{name}"],
            "artifact_launches": artifact_launches(f"window_attn_{name}",
                                                   detect_artifact_launches),
            "max_abs_err": max(r["f32_max_abs_err"] for r in swin_t),
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": "operations" if total["ops_ms"] >= total["bytes_ms"] else "bytes",
            "library_ms": None,
            **({"split_ms": {k: sum(r[part]["split_ms"].get(k, 0.0) * r["blocks_per_forward"]
                                    for r in swin_t)
                             for k in swin_t[0][part]["split_ms"]}}
               if name == "heads" else {}),
            "per": "one Swin-T camera forward: 12 launches, 48 images at 144x256, f32",
        }

    kernels = [
        {
            "name": "compact_rows",
            "route": "cuda",
            "source": "cm3d_tpu_torch/csrc/compact.cu",
            "replaces": "cm3d_tpu/kernels/compact_pallas.py:204",
            "launches": launches["compact_rows"],
            "max_abs_err": max(s["max_abs_err"] for s in stages),
            "ms": sum(s["ms"] for s in stages),
            "plain_ms": sum(s["plain_ms"] for s in stages),
            "bound_ms": sum(s["bound_ms"] for s in stages),
            "bound_by": "bytes",
            "library_ms": None,
            # the kernels' time on the device alone, beside the events' time
            # of back-to-back wrapper calls, which holds the host
            "device_span_ms": sum(s["device_span_ms"] for s in stages),
            "kernels_ms": None if any(s["kernels_ms"] is None for s in stages)
            else sum(s["kernels_ms"] for s in stages),
            "stages": stages,
            # the Waymo lift: run_lift_waymo's launches, a step's shapes
            "waymo_launches": waymo["run_lift_waymo_launches"]["compact_rows"],
            "waymo_stages": waymo["compaction_shapes"],
            # the KITTI lift: run_lift_kitti's launches, a step's shapes
            "kitti_launches": kitti["run_lift_kitti_launches"]["compact_rows"],
            "kitti_stages": kitti["compaction_shapes"],
            # a call of each exported lift program, and the served lift
            "artifact_launches": artifact_launches("compact_rows", lift_artifact_launches),
            "served_launches": deploy_serve["serve_lift"]["launches"]["compact_rows"],
            "int8_e2e_launches": quant_e2e_launches["compact_rows"],
            # phase 22: e2e --camera_mesh 1 on the fixture dataroot
            "camera_mesh_e2e_launches":
                model_parallel["e2e_cli_launches"]["camera_mesh"]["compact_rows"],
            # phase 23: each point of the fast profile, 3 a lift step
            "fast_profile_launches": fast_profile_launches("compact_rows"),
        },
        {
            "name": "medoid_distance_sums_rows",
            "route": "cuda",
            "source": "cm3d_tpu_torch/csrc/medoid.cu",
            "replaces": "cm3d_tpu/kernels/medoid_pallas.py:129",
            "launches": launches["medoid_distance_sums_rows"],
            **{key: med[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "pairs": med["pairs"],
            "unordered_pairs": med["unordered_pairs"],
            "near_tie_rows": med["near_tie_rows"],
            "waymo_launches": waymo["run_lift_waymo_launches"]["medoid_distance_sums_rows"],
            "waymo_max_rel_err": waymo["medoid"]["max_rel_err"],
            "kitti_launches": kitti["run_lift_kitti_launches"]["medoid_distance_sums_rows"],
            "kitti_max_rel_err": kitti["medoid"]["max_rel_err"],
            "artifact_launches": artifact_launches("medoid_distance_sums_rows",
                                                   lift_artifact_launches),
            "served_launches":
                deploy_serve["serve_lift"]["launches"]["medoid_distance_sums_rows"],
            "int8_e2e_launches": quant_e2e_launches["medoid_distance_sums_rows"],
            # phase 22: e2e --camera_mesh 1 on the fixture dataroot
            "camera_mesh_e2e_launches":
                model_parallel["e2e_cli_launches"]["camera_mesh"]["medoid_distance_sums_rows"],
            # phase 23: each point of the fast profile (1 a lift step), and
            # medoid_index on the compacted rows of a lift step (1 a call)
            "fast_profile_launches": fast_profile_launches("medoid_distance_sums_rows"),
            "medoid_index_launches": bench_entry["a16"]["medoid_index_launches"],
        },
        window_attn_entry("heads"),
        window_attn_entry("proj"),
        relpos_entry("heads", "cm3d_tpu_torch/csrc/window_attn_relpos.cu"),
        relpos_entry("proj", "cm3d_tpu_torch/csrc/window_attn.cu"),
        {
            "name": "sam_global_attn",
            "route": "cuda",
            "source": "cm3d_tpu_torch/csrc/sam_global_attn.cu",
            # the JAX package leaves the global blocks to XLA
            "replaces": None,
            "launches": e2e_fused["launches"]["sam_global_attn"],
            "max_rel_err": max(r["rel_err"] for r in sga),
            "chain_max_rel_err": max(r["chain_rel_err"] for r in sga),
            **{k: sga[0][k] * SAM_GLOBAL_BLOCKS for k in ("ms", "plain_ms", "bound_ms")},
            "bound_by": "operations" if sga[0]["ops_ms"] >= sga[0]["bytes_ms"] else "bytes",
            "library_ms": None,
            "sdpa_yardstick_ms": sga[0]["sdpa_yardstick_ms"] * SAM_GLOBAL_BLOCKS,
            "per": "one ViT-H encode of one camera: 4 launches at 64 x 64, 16 heads, hd 80, bf16",
            "unfused_launches": e2e_unfused["launches"]["sam_global_attn"],
            "int8_e2e_launches": quant_e2e_launches["sam_global_attn"],
            "shapes": sga,
        },
        segment_entry("segment_sum_max", "segment_sum_max",
                      "cm3d_tpu/kernels/segment_pallas.py:141",
                      train["bench_train"]["launches"]["segment_sum_max"]),
        segment_entry("segment_sum", "segment_sum/bench",
                      "cm3d_tpu/kernels/segment_pallas.py:161",
                      train["bench_fusion_train conv"]["launches"]["segment_sum"]),
        segment_entry("segment_sum_bwd", "segment_sum_bwd/bench",
                      "cm3d_tpu/kernels/segment_pallas.py:183",
                      train["bench_fusion_train conv"]["launches"]["segment_sum_bwd"]),
        swin_t_entry("heads"),
        swin_t_entry("proj"),
    ]
    print("kernels launched on the main path: " + ", ".join(
        f"{k['name']} x{k['launches']}" for k in kernels), flush=True)
    print(json.dumps({"medoid_kn3_entry": {"ms": med["kn3_ms"], "plain_ms": med["kn3_plain_ms"]},
                      "gemm_sass": sass,
                      "window_attn_shapes": wa, "mask_stage": benches,
                      "mask_cpu_check": cpu_check, "relpos_shapes": rp, "sam_global_attn": sga,
                      "vit_h_encode_ab": encode_ab, "e2e_fused": e2e_fused,
                      "e2e_unfused": e2e_unfused, "e2e_cpu_check": e2e_check,
                      "segment_shapes": seg, "swin_t_shapes": swin_t, "train": train,
                      "train_cpu_check": train_check, "deterministic": deterministic,
                      "released_weights": released, "waymo": waymo, "kitti": kitti,
                      "data_parallel": data_parallel, "deploy_serve": deploy_serve,
                      "quant_zoe": quant_zoe, "gdino": gdino, "bench_entry": bench_entry}),
          flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

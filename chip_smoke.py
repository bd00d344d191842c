#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cm3d_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on a failed check (exit code != 0):

1. Card and build: print the card's name and power limit, build every CUDA
   kernel from csrc/ (one nvcc per source, all at once).
2. Kernels: capture each kernel's inputs from a real batch-8 lift step at
   production geometry, then hold the kernel against its plain PyTorch
   version on those inputs — compaction bit-exact at all three stages,
   medoid sums to rtol=1e-5 with equal argmins wherever the two smallest
   sums differ by more than 1e-5 relative — and time kernel, plain version
   and (medoid) torch.cdist with CUDA events.
3. Main path: bench_lift at batch 8 with every launch count reset just
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
   bound.
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
   times beside the bound. Then one 6-camera ViT-H encode with the fused
   blocks and without, same weights: ms per camera and the difference of
   the embeddings.
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
10. One JSON line per kernel summary, then the card's name and power limit,
   then the last line {"ok": true, "device": {...}}.

Imports nothing of JAX or of the cm3d_tpu package. Without a CUDA device,
or without the cm3d_tpu_torch package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
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
# fused vs unfused ViT-H embeddings in bf16, x max|unfused|: each of the 28
# fused branches rounds at other places than the unfused block (about 2^-8
# relative a value), and the differences add up through the 32 blocks
ENCODE_AB_TOL = 2.0 ** -4
BOX_ATOL = 1e-3  # mask-path CPU check: box corners, image px
LOGIT_EPS = 1e-3  # mask-path CPU check: bits this close to 0 may flip
# f32 operations per (i, j) pair of the medoid sums: 3 sub, 3 mul, 2 add,
# sqrt, the valid multiply, the accumulate
MEDOID_OPS_PER_PAIR = 11
STAGES = ("camera", "union", "mask")
N_CAMERAS = 6  # nuScenes ring
REPS = 20


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
        want = compact_rows_plain(sel, values, limit)
        torch.cuda.synchronize()
        exact = torch.equal(got.view(torch.int32), want.view(torch.int32))
        diff = (got.view(torch.int32).to(torch.int64) - want.view(torch.int32).to(torch.int64))
        max_err = float(diff.abs().max()) if diff.numel() else 0.0
        check(exact, f"compaction {name} stage bit-exact vs plain")
        kept = int(sel.sum(1).clamp(max=limit).sum())
        # bytes the function must move: the selection mask, the kept
        # sources' D words, and the [R, D, L] output
        n_bytes = r * s + kept * d * 4 + r * d * limit * 4
        ms = time_ms(torch, lambda: compact_rows(sel, values, limit))
        plain_ms = time_ms(torch, lambda: compact_rows_plain(sel, values, limit))
        stages.append({
            "stage": name, "rows": r, "sources": s, "words": d, "limit": limit,
            "selected": int(sel.sum()), "kept": kept, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": n_bytes / PEAK_BYTES_PER_S * 1e3,
        })
        print(f"compaction {name}: R={r} S={s} D={d} L={limit} bit-exact "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"bound {stages[-1]['bound_ms']:.4f} ms", flush=True)
    return stages


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
    torch.cuda.synchronize()
    check(torch.equal(got_kn3, got), "[R, K, 3] layout wrapper equals the D-major kernel")
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
    ops_ms = pairs * MEDOID_OPS_PER_PAIR / PEAK_F32_OPS_PER_S * 1e3
    bytes_ms = (r * k * (3 * 4 + 1 + 4)) / PEAK_BYTES_PER_S * 1e3
    out = {
        "rows": r, "k": k, "pairs": pairs, "near_tie_rows": int(near_tie.sum()),
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


def capture_window_attn_inputs(torch, models, images, n_blocks=SWIN_BLOCKS_PER_FORWARD,
                               n_shapes=8):
    """Run one Detic forward on the ring, recording the window-attention
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
        models.detic(models.prepare(images))
    finally:
        swin.window_attn = real
    torch.cuda.synchronize()
    check(sum(mult.values()) == n_blocks,
          f"one Swin forward runs {n_blocks} blocks, saw {sum(mult.values())}")
    check(len(shapes) == n_shapes, f"{n_shapes} distinct (stage, shift) shapes, saw "
          f"{sorted(shapes)}")
    return [(key, shapes[key], mult[key]) for key in sorted(shapes)]


def window_attn_phase(torch, captured):
    from cm3d_tpu_torch.kernels.window_attn import (
        window_attn_heads,
        window_attn_heads_plain,
        window_attn_plain,
        window_attn_proj,
        window_attn_proj_plain,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    out = []
    for (c, shift), (x, (g, b, wqkv, bqkv, wproj, bproj, table), kw), mult in captured:
        heads, win = kw["heads"], kw["window"]
        check(kw["dtype"] == bf16, "the Detic forward computes in bf16")
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
        }
        for name, ms, plain, ops, nbytes in (("heads", ms_h, plain_h, ops_h, bytes_h),
                                              ("proj", ms_p, plain_p, ops_p, bytes_p)):
            ops_ms = ops / PEAK_BF16_OPS_PER_S * 1e3
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            rec[name] = {"ms": ms, "plain_ms": plain, "bound_ms": max(ops_ms, bytes_ms),
                         "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                         "max_abs_err": errs[name][0], "max_rel_err": errs[name][1]}
        out.append(rec)
        print(f"window attention C={c} shift {shift} {list(x.shape)} h{heads}: "
              f"bf16 rel err {errs['branch'][1]:.3g} (heads {errs['heads'][1]:.3g}, proj "
              f"{errs['proj'][1]:.3g}), f32 abs err {err32:.3g}; heads {ms_h:.4f} ms + proj "
              f"{ms_p:.4f} ms, plain {plain_h:.4f} + {plain_p:.4f} ms, bound "
              f"{rec['heads']['bound_ms']:.4f} + {rec['proj']['bound_ms']:.4f} ms", flush=True)
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

            def wrapped(lg, n_boxes):
                logits.append(lg.float().cpu())
                return post(lg, n_boxes)
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


def capture_relpos_inputs(torch, models, frame):
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
    check(calls[0] == SAM_WINDOWED_BLOCKS * N_CAMERAS,
          f"one ring encode runs {SAM_WINDOWED_BLOCKS} windowed blocks x {N_CAMERAS} cameras "
          f"through the fused kernels, saw {calls[0]}")
    return seen[0]


def relpos_phase(torch, captured):
    """The rel-pos kernels against their plain version at the square grid
    the encode gave them and at its top 36 rows (the rect-encode grid)."""
    from cm3d_tpu_torch.kernels.window_attn_relpos import (
        window_attn_relpos_heads,
        window_attn_relpos_heads_plain,
        window_attn_relpos_plain,
        window_attn_relpos_proj,
    )
    from cm3d_tpu_torch.kernels.window_attn import window_attn_proj_plain

    bf16, f32 = torch.bfloat16, torch.float32
    x_sq, (g, b, wqkv, bqkv, wproj, bproj, rel_h, rel_w), kw = captured
    heads, win, eps = kw["heads"], kw["window"], kw["eps"]
    check(kw["dtype"] == bf16, "the ViT-H encode computes in bf16")
    check(tuple(x_sq.shape) == (1, 64, 64, 1280), f"square ViT-H grid, got {tuple(x_sq.shape)}")
    geo = dict(heads=heads, window=win, eps=eps)
    out = []
    for name, x in (("square", x_sq), ("rect", x_sq[:, :36].contiguous())):
        bsz, h, w, c = x.shape
        shape = tuple(x.shape)
        wqkv_b, wproj_b = wqkv.to(bf16), wproj.to(bf16)
        # bf16 kernels against the f32 plain version on the same bf16-rounded
        # inputs, weights and tables
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
        # f32 kernels against the f32 plain version
        xf = x.float()
        o32 = window_attn_relpos_heads(xf, g, b, wqkv.float(), bqkv, rel_h, rel_w, dtype=f32,
                                       **geo)
        got32 = window_attn_relpos_proj(o32, wproj.float(), bproj, out_shape=shape, heads=heads,
                                        window=win, dtype=f32)
        ref32 = window_attn_relpos_plain(xf, g, b, wqkv.float(), bqkv, wproj.float(), bproj,
                                         rel_h, rel_w, dtype=f32, **geo)
        torch.cuda.synchronize()
        err32 = float((got32 - ref32).abs().max())
        check(err32 <= WA_F32_TOL * float(ref32.abs().max()),
              f"rel-pos window attention {name}: f32 kernel vs plain {err32:.3g}")
        del o32, got32, ref32, xf, o_ref, ref, full_ref
        # times (CUDA events) and bounds of the bf16 launches
        ms_h = time_ms(torch, lambda: window_attn_relpos_heads(
            x, g, b, wqkv_b, bqkv, rel_h, rel_w, dtype=bf16, **geo))
        ms_p = time_ms(torch, lambda: window_attn_relpos_proj(
            o, wproj_b, bproj, out_shape=shape, heads=heads, window=win, dtype=bf16))
        plain_h = time_ms(torch, lambda: window_attn_relpos_heads_plain(
            x, g, b, wqkv_b, bqkv, rel_h, rel_w, dtype=bf16, **geo), reps=5)
        plain_p = time_ms(torch, lambda: window_attn_proj_plain(
            o, wproj_b, bproj, out_shape=shape, window=win, shift=0, dtype=bf16), reps=5)
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
        out.append(rec)
        print(f"rel-pos window attention {name} {list(shape)} h{heads} win {win}: bf16 rel err "
              f"{errs['branch'][1]:.3g} (heads {errs['heads'][1]:.3g}, proj "
              f"{errs['proj'][1]:.3g}), f32 abs err {err32:.3g}; heads {ms_h:.4f} ms + proj "
              f"{ms_p:.4f} ms, plain {plain_h:.4f} + {plain_p:.4f} ms, bound "
              f"{rec['heads']['bound_ms']:.4f} + {rec['proj']['bound_ms']:.4f} ms", flush=True)
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


def e2e_phase(torch, models, fused: bool, n_frames: int = 12, batch_size: int = 4):
    """bench_e2e with every launch count set to 0 just before it and read
    just after; the counts must fit the keyframes, Detic forwards and lift
    steps the run made."""
    from cm3d_tpu_torch.benchmarks import bench_e2e
    from cm3d_tpu_torch.kernels.compact import compact_rows
    from cm3d_tpu_torch.kernels.medoid import medoid_distance_sums_rows
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.kernels.window_attn_relpos import (
        window_attn_relpos_heads,
        window_attn_relpos_proj,
    )

    wrappers = (compact_rows, medoid_distance_sums_rows, window_attn_heads, window_attn_proj,
                window_attn_relpos_heads, window_attn_relpos_proj)
    forwards = [0]
    raw = models.detic

    def counted(frame):
        forwards[0] += 1
        return raw(frame)

    models = dataclasses.replace(models, detic=counted)
    for wr in wrappers:
        wr.launches = 0
    bench = bench_e2e("bfloat16", n_frames=n_frames, batch_size=batch_size, models=models,
                      device="cuda")
    launches = {wr.__name__: wr.launches for wr in wrappers}
    frames = batch_size + n_frames  # the warm-up run, then the timed one
    steps = 1 + -(-n_frames // batch_size)
    bench.update(fused_window_attn=fused, keyframes=frames, detic_forwards=forwards[0],
                 lift_steps=steps, launches=launches)
    print(json.dumps(bench), flush=True)
    check(forwards[0] == frames and bench["n_frames"] == n_frames,
          f"{frames} keyframes, one Detic forward each, saw {forwards[0]}")
    check(bench["boxes_kept"] > 0, "the fused path delivers boxes")
    relpos = SAM_WINDOWED_BLOCKS * N_CAMERAS * frames if fused else 0
    want = {"compact_rows": 3 * steps, "medoid_distance_sums_rows": steps,
            "window_attn_heads": SWIN_BLOCKS_PER_FORWARD * frames,
            "window_attn_proj": SWIN_BLOCKS_PER_FORWARD * frames,
            "window_attn_relpos_heads": relpos, "window_attn_relpos_proj": relpos}
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import cm3d_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the cm3d_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    from cm3d_tpu_torch.benchmarks import (
        IMG_H,
        IMG_W,
        _realistic_load,
        bench_lift,
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
    n_iters = 10
    bench = bench_lift(batch_size=8, n_iters=n_iters, device=dev)
    launches = {"compact_rows": compact_rows.launches,
                "medoid_distance_sums_rows": medoid_distance_sums_rows.launches}
    print(json.dumps(bench), flush=True)
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
    wa = window_attn_phase(torch, capture_window_attn_inputs(torch, prod, ring))

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
    encode_ab = encode_ab_phase(torch, prod, prod_fused, frame)

    # --- 8. the fused images -> boxes path, counted: fused blocks, then unfused ---
    e2e_fused = e2e_phase(torch, _realistic_load(prod_fused), fused=True)
    e2e_unfused = e2e_phase(torch, realistic, fused=False)
    del prod, realistic, prod_fused, frame
    torch.cuda.empty_cache()

    # --- 6. the mask path, 9. the fused path, on the card against the CPU ---
    cpu_check = mask_cpu_check(torch)
    e2e_check = e2e_cpu_check(torch)

    # --- 10. summary ---
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
        }

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
            "stages": stages,
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
            "near_tie_rows": med["near_tie_rows"],
        },
        window_attn_entry("heads"),
        window_attn_entry("proj"),
        relpos_entry("heads", "cm3d_tpu_torch/csrc/window_attn_relpos.cu"),
        relpos_entry("proj", "cm3d_tpu_torch/csrc/window_attn.cu"),
    ]
    print("kernels launched on the main path: " + ", ".join(
        f"{k['name']} x{k['launches']}" for k in kernels), flush=True)
    print(json.dumps({"medoid_kn3_entry": {"ms": med["kn3_ms"], "plain_ms": med["kn3_plain_ms"]},
                      "window_attn_shapes": wa, "mask_stage": benches,
                      "mask_cpu_check": cpu_check, "relpos_shapes": rp,
                      "vit_h_encode_ab": encode_ab, "e2e_fused": e2e_fused,
                      "e2e_unfused": e2e_unfused, "e2e_cpu_check": e2e_check}), flush=True)
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
    sys.exit(main())

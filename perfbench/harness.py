"""The benchmark's run: one cell, one seed, one window.

    python3 -m perfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration file, the configuration's detector (detectors/<name>.py, by
its `detector` key; absent: detic), its traffic file (traffic/<mix>.json,
whose `loop` picks the e2e or the lift loop), its limits (limits/<cell>.json)
and each per-layer metric's reader (metrics/<name>.py). The last line of
standard output is the result; the numbers compared for `correct`, each
beside its limit, close standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent  # the checkout
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cm3d_tpu")  # top-level module names


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's own CUDA build (cm3d_tpu_torch/kernels/_build) is there
    already; Triton's and torch's extension caches go under perfbench/.cache."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(HERE / ".cache" / sub)
    os.environ["USE_FLAX"] = "0"


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(bench: dict, name: str) -> dict:
    """The cell's entry, configuration, traffic and limits, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {"cell": cell,
            "config": json.loads((ROOT / conf["file"]).read_text()),
            "traffic": json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
            "limits": json.loads((HERE / "limits" / f"{name}.json").read_text())}


def metrics_of(bench: dict, name: str) -> tuple:
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return e2e, layer


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(t0: float, argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the controls of `correct` (PERF.md), never in the benchmark's own runs:
    # `reference`, the reference one precision step below the
    # configuration's in the program's place; `program_int8`, the program
    # with its own int8 path switched on where the configuration serves
    # bfloat16
    p.add_argument("--control", choices=("reference", "program_int8"), default=None,
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    cache_dirs()
    try:
        import cm3d_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"perfbench: the program is not here ({e}); run from a checkout", file=sys.stderr)
        return 2
    import torch

    bench = spec()
    files = cell_files(bench, args.workload)
    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(files, args, t0, torch.device("cuda", 0), bench)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; the port must not", file=sys.stderr)
        return 3
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(files: dict, args, t0: float, device, bench: dict) -> tuple:
    """One run of a cell; (result line, checks)."""
    import torch

    from perfbench import frontend, program

    cfg, traffic, cell = files["config"], files["traffic"], files["cell"]
    seed = args.seed
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e2e_loop = traffic["loop"] == "e2e"
    control = getattr(args, "control", None)
    if control == "program_int8" and (not e2e_loop or cfg["modes"]["quant_int8"]):
        raise SystemExit("perfbench: the program's int8 path is the control of a bfloat16 "
                         "e2e cell only")
    quant = cfg["modes"]["quant_int8"] or control == "program_int8"

    def stamp(what):
        print(f"perfbench: set-up {what} by {time.perf_counter() - t0:.2f} s", file=sys.stderr)

    stamp("imports")
    pool = [frontend.make_keyframe(traffic, cfg["lift"], rng, device)
            for _ in range(traffic["pool_frames"])]
    step = program.make_step(cfg, device)
    stamp("keyframe pool")
    bsz = traffic["batch_size"]
    # once the window has closed: in a traced run its two traced parts, one
    # after the other (device activity alone, then with the host's ranges);
    # then the sample, drawn from the next two batches (e2e) or six steps
    # (lift)
    n_check = traffic["check_frames"] if e2e_loop else traffic["check_steps"]
    trace_len = traffic["trace_batches"] * bsz if e2e_loop else traffic["trace_steps"]
    after = 2 * trace_len if args.trace else 0
    offsets = tuple(sorted(int(x) for x in rng.choice(
        np.arange(after, after + (2 * bsz if e2e_loop else 6)), n_check, replace=False)))
    seconds = traffic["control_seconds"] if control else args.seconds
    probe = program.Probe(batch_size=bsz, seconds=seconds, trace=bool(args.trace),
                          capture_offsets=offsets, trace_frames=trace_len)
    hooks = []
    if e2e_loop:
        from perfbench import checks, detectors, weights

        det = detectors.of(cfg)
        state = weights.make_state(checks.skeleton(det, cfg), seed, device)
        text = det.text_inputs(cfg, seed, device)
        models, det_mod, sam_mod = det.port_models(
            cfg, state, lambda: program.port_sam(cfg, state, device), text, device, quant)
        del state  # made again for the reference, once the window has closed
        stamp("weights and models")
        n_words = -(-cfg["lift"]["max_masks"] // 32)
        planes = {i: frontend.blob_planes(traffic, n_words, gen, device) for i in range(len(pool))}
        dets = frontend.pool_detections(traffic, len(pool), cfg["mask_stage"], rng)
        frames = [program.Frame(frontend.images(traffic, gen, device), i, dets[i])
                  for i in range(len(pool))]
        warm = [program.Frame(frames[i % len(frames)], i % len(frames),
                              frontend.detections(traffic, np.array(c),
                                                  cfg["mask_stage"]["max_detections"], rng))
                for i, c in enumerate(traffic["warmup_detections"] * (
                    traffic["warmup_frames"] // len(traffic["warmup_detections"])))]
        mask_cfg = program.mask_config(cfg)
        swapped = program.swap_content(models, det.captures(det_mod), probe, planes, device)
        if args.trace and quant:
            hooks = program.int8_ranges(det_mod) + program.int8_ranges(sam_mod)
        stamp("images, detections, planes")
        program.run_e2e(swapped, step, mask_cfg, warm, pool, bsz, None, device)
        program.sync(device)
        stamp("warm-up")
        program.run_e2e(swapped, step, mask_cfg, frames, pool, bsz, probe, device)
    else:
        batches = program.lift_batches(pool, bsz, device)
        stamp("pinned batches")
        program.run_lift(step, batches, None, traffic["warmup_steps"], device)
        program.sync(device)
        stamp("warm-up")
        program.run_lift(step, batches, probe, 0, device)
    program.sync(device)
    peak = program.peak_bytes(device)
    for h in hooks:
        h.remove()
    times = probe.batch_times
    setup_s = times[0] - t0
    rate = (len(times) - 1) * bsz / (times[-1] - times[0])
    attempted = (len(times) - 1) * bsz

    ctx = {"cfg": cfg, "traffic": traffic, "probe": probe, "rate": rate}
    breakdown = None
    if args.trace:
        print(f"perfbench: card {card_note(device)}", file=sys.stderr)
        ctx["light"], ctx["trace"] = probe.light["trace"], probe.traced["trace"]
        breakdown = ctx["trace"].breakdown()
        print(f"perfbench: untraced window {rate:.4f} keyframes/s", file=sys.stderr)
        for part, seg in (("device activity alone", probe.light),
                          ("with the host's ranges", probe.traced)):
            k = seg.get("frames", 0)
            print(f"perfbench: traced part, {part}: {k} keyframes in {seg['window_s']:.4f} s "
                  f"({k / seg['window_s']:.4f} keyframes/s), device busy "
                  f"{seg['trace'].busy_s():.4f} s", file=sys.stderr)
    # the program's state goes before the reference is built
    if e2e_loop:
        del models, swapped, det_mod, sam_mod
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    from perfbench import checks

    t_ref = time.perf_counter()
    if e2e_loop:
        state = weights.make_state(checks.skeleton(det, cfg), seed, device)
        numbers = check_e2e(det, cfg, state, text, probe, frames, planes, pool, device,
                            control == "reference")
        del state
    else:
        numbers = check_lift(cfg, probe, pool, device, control == "reference", ctx)
    correct, table = checks.judge(numbers, files["limits"])
    for k, v in sorted(numbers.items()):
        if k not in table:
            print(f"perfbench: read beside the checks, compared with nothing: {k} {v}",
                  file=sys.stderr)
    print(f"perfbench: window {times[-1] - times[0]:.2f} s, {len(times)} deliveries; "
          f"reference {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)

    e2e_metrics, layer_metrics = metrics_of(bench, cell["name"])
    out = {}
    if args.trace:
        for m in layer_metrics:
            value = importlib.import_module(f"perfbench.metrics.{m['name']}").read(ctx)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"keyframes_per_s": rate, "setup_s": setup_s}
        out = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e_metrics}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
           "memory_peak_bytes": peak}
    if args.trace:
        dev["busy_s"] = ctx["light"].busy_s()
        dev["window_s"] = ctx["light"].window_s
    result = {"correct": correct, "attempted": attempted, "failed": 0, "metrics": out,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = table
    return result, table


def card_note(device) -> str:
    """The card's name and power limit, which every roofline and mfu share
    is read against (nvidia-smi, queried once)."""
    import subprocess

    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"power limit not read ({e})"
    return out.stdout.strip() or out.stderr.strip()


def check_e2e(det, cfg, state, text, probe, frames, planes, pool, device, control):
    """Every sampled keyframe through the reference (the detector's, of
    its module `det`, and SAM's); the numbers compared."""
    import torch

    from perfbench import checks
    from perfbench.frontend import unpack_planes

    ref_det, sam = checks.build_reference(det, cfg, state, device)
    rows = []
    for _, cap in sorted(probe.captures.items()):
        i = cap["idx"]
        images = np.asarray(frames[i])
        if control:
            # the control: the reference one precision step below, in the
            # program's place
            checks.set_precision(det, ref_det, sam, cfg, True)
            prog = checks.model_side(det, ref_det, sam, text, images, cfg)
        else:
            prog = checks.program_side(det, cap)
        checks.set_precision(det, ref_det, sam, cfg, False)
        ref = checks.model_side(det, ref_det, sam, text, images, cfg, prog)
        row = checks.compare_models(det, prog, ref)
        boxes, n_boxes, labels, scores, cams = checks.prompts(frames[i].dets, cfg["mask_stage"])
        row["prompt_mismatch"] = float(
            (cap["n_boxes"] != n_boxes).sum()
            + (cap["prompts"].shape != boxes.shape or (cap["prompts"] != boxes).sum()))
        h, w = images.shape[1:3]
        with torch.no_grad():
            ref_masks = checks.decode_masks(sam, ref["embedding"], boxes, n_boxes, (h, w),
                                            cfg["sam"]["img_size"])
            if control:
                checks.set_precision(det, ref_det, sam, cfg, True)
                prog_masks = checks.decode_masks(sam, prog["embedding"], boxes, n_boxes, (h, w),
                                                 cfg["sam"]["img_size"])
                checks.set_precision(det, ref_det, sam, cfg, False)
            else:
                prog_masks = unpack_planes(cap["planes"], ref_masks.shape[0])
        flips = (prog_masks ^ ref_masks).flatten(1).sum(1)
        union = (prog_masks | ref_masks).flatten(1).sum(1)
        row["mask_flip_counts"] = (int(flips.sum()), int(union.sum()))
        worst_masks = [(int(flips[j]), int(union[j])) for j in flips.argsort(descending=True)[:4]]
        print(f"perfbench: keyframe {i}: {flips.numel()} masks, {int(flips.sum())} pixels "
              f"flipped of {int(union.sum())}; most flipped (flipped, in either) {worst_masks}",
              file=sys.stderr)
        f = checks.lift_inputs([pool[i]], [planes[i]], [(labels, scores, cams)], device)
        ref_boxes, _ = checks.lift_boxes(f, cfg["lift"])
        prog_boxes = _boxes_fields(cap["boxes"], batched=False)
        if control:
            prog_boxes = _ref_as_prog(checks.lift_boxes(f, cfg["lift"], torch.bfloat16)[0])
        row["box_mismatch_counts"] = checks.box_mismatch(prog_boxes, ref_boxes, f["mask_valid"])
        rows.append(row)
    return checks.worst(rows)


def check_lift(cfg, probe, pool, device, control, ctx):
    import torch

    from perfbench import checks

    rows = []
    for _, cap in sorted(probe.captures.items()):
        kfs = [pool[j] for j in cap["idx"]]
        f = checks.lift_inputs(kfs, [kf["mask_bits"] for kf in kfs], [None] * len(kfs), device)
        ref_boxes, _ = checks.lift_boxes(f, cfg["lift"])
        prog = _boxes_fields(cap["boxes"], batched=True)
        if control:
            prog = _ref_as_prog(checks.lift_boxes(f, cfg["lift"], torch.bfloat16)[0])
        rows.append({"box_mismatch_counts": checks.box_mismatch(prog, ref_boxes,
                                                                f["mask_valid"])})
    if "trace" in ctx:
        # what each pool keyframe's compactions and medoid move (the rooflines)
        work = []
        for j in range(0, len(pool), 8):
            kfs = pool[j:j + 8]
            f = checks.lift_inputs(kfs, [kf["mask_bits"] for kf in kfs], [None] * len(kfs),
                                   device)
            work.append(checks.lift_boxes(f, cfg["lift"])[1])
        ctx["work"] = {k: torch.cat([getattr(w, k) for w in work]).cpu().numpy()
                       for k in work[0]._fields}
    return checks.worst(rows)


def _boxes_fields(boxes, batched: bool) -> dict:
    """The program's delivered BoxOutputs (numpy) as a dict with a batch axis."""
    return {k: (np.asarray(getattr(boxes, k)) if batched else np.asarray(getattr(boxes, k))[None])
            for k in ("centers", "sizes", "yaws", "labels", "keep")}


def _ref_as_prog(ref) -> dict:
    return {k: getattr(ref, k).cpu().numpy() for k in ("centers", "sizes", "yaws", "labels",
                                                        "keep")}


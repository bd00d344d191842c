"""2D->3D lifting pipeline driver: mask artifacts -> submission JSON.

The counterpart of the reference's src/nuscenes/2d_to_3d.py __main__:
iterate scenes, batch keyframes, run the batched device step, write the
nuScenes submission. Differences by design:

- The reference's two passes + scene barrier (all-centroid lane assignment,
  2d_to_3d.py:699-706) are fused into the per-keyframe device step.
- Resume: samples already in the output keep their boxes; corrupt frames
  skip-and-log instead of crashing.
- Stage timers keep the reference's taxonomy (io / device / write / total,
  reference :368-378), as the totals of the lift's spans, and report
  keyframes/sec.
- Scale-out as in JAX: `--data_parallel N` splits each keyframe batch over
  N cards (parallel/mesh.py), `--host_shard` keeps this process's stride
  of the scenes (parallel/multihost.py).

Usage:
  python -m cm3d_tpu_torch.pipelines.lift --dataroot D --version v1.0-mini \
      --mask_dir MASKS --scenes scene-0061,scene-0103 --out preds.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

from cm3d_tpu_torch.config import LiftStageConfig
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes, to_device
from cm3d_tpu_torch.parallel import dp_step, make_keyframe_step_fn, shard_for_host

_END = object()  # the end of the frame source


def run_lift(
    dataroot: str,
    version: str,
    mask_dir: str,
    scenes: List[str],
    out_path: str,
    lift_cfg: LiftStageConfig = LiftStageConfig(),
    batch_size: int = 8,
    num_workers: int = 8,
    profile_dir: str | None = None,
    verbose: bool = True,
    resume: bool = False,
    data_parallel: int = 0,
    device=None,
) -> dict:
    """Lift every keyframe of `scenes` and write the submission JSON to
    `out_path`. Runs on CUDA unless `device` says otherwise. data_parallel
    N > 0 splits each batch over N ranks (parallel.dp_step): the same
    submission as the single-device run."""
    from cm3d_tpu_torch.datasets.nuscenes import NuScenesFrontend, SubmissionWriter
    from cm3d_tpu_torch.utils.fetch import device_fetch
    from cm3d_tpu_torch.utils.device import resolve_device
    from cm3d_tpu_torch.utils.observability import LiftCounters, lift_timers, span, trace

    device = resolve_device(device)
    totals: dict = {}  # span name -> seconds: the io / device / write timers
    counters = LiftCounters()
    t_total = time.perf_counter()

    store = MaskArtifactStore(mask_dir)
    frontend = NuScenesFrontend(dataroot, version, store, lift_cfg)
    writer = SubmissionWriter()

    # Resume: samples already in the output file keep their boxes and are
    # not re-lifted; the rewrite is a superset merge, so a kill-and-restart
    # mid-run converges to the same submission.
    done_tokens: set = set()
    if resume and os.path.exists(out_path):
        with open(out_path) as f:
            existing = json.load(f)
        writer.results.update(existing.get("results", {}))
        done_tokens = set(writer.results)

    n_frames = 0
    pending: list = []

    def flush(step):
        nonlocal pending
        if not pending:
            return
        n_real = len(pending)
        with span("cm3d.lift.flush", totals=totals):
            # pad the tail batch to the static batch size
            frames = [kf for kf, _ in pending]
            frames += [frames[-1]] * (batch_size - n_real)
            batch = stack_keyframes(frames)
            lift, boxes = step(to_device(batch.frames, device))
            boxes_np, lift_np = device_fetch((boxes, lift))  # one device->host copy
            counters.update_from_outputs(
                batch.frames.mask_valid[:n_real],
                map_fields(lambda x: x[:n_real], lift_np),
                boxes_np.keep[:n_real],
            )
        with span("cm3d.lift.write", totals=totals):
            for i, (_, meta) in enumerate(pending[:n_real]):
                writer.add_device_outputs(
                    meta.sample_token, map_fields(lambda x: x[i], boxes_np)
                )
        pending = []

    # Host keyframe building overlaps device execution: a worker pool
    # prefetches upcoming frames (the reference is strictly sequential).
    def scene_frames(scene_name):
        scene = frontend.nusc.scene_by_name(scene_name)
        nmap = frontend._map_for_scene(scene)
        lane_points = nmap.all_lane_points(0.5)
        drivable = (
            frontend.drivable_for_scene(scene)
            if lift_cfg.drivable_filter
            else None
        )
        return [
            (scene_name, fn, sample, lane_points, drivable)
            for fn, sample in enumerate(frontend.nusc.iter_samples(scene))
            if sample["token"] not in done_tokens
        ]

    work = []
    for scene_name in scenes:
        work.extend(scene_frames(scene_name))
    with (dp_step(make_keyframe_step_fn(lift_cfg, device=device), batch_size,
                  data_parallel) as step,
          trace("lift", profile_dir), ThreadPoolExecutor(max_workers=num_workers) as pool):
        built_frames = pool.map(lambda a: frontend.build_keyframe(*a), work, chunksize=1)
        while True:
            with span("cm3d.lift.io.wait", totals=totals):
                built = next(built_frames, _END)
            if built is _END:
                break
            if built is None:
                continue
            pending.append(built)
            n_frames += 1
            if len(pending) >= batch_size:
                flush(step)
        flush(step)

    with span("cm3d.lift.write", totals=totals):
        submission = writer.write(out_path)
    timers = lift_timers(totals, time.perf_counter() - t_total)

    if verbose:
        n_boxes = sum(len(v) for v in submission["results"].values())
        print(f"wrote {len(submission['results'])} samples, {n_boxes} boxes.")
        for op, v in timers.items():
            print(f"{op} :\t\t {v:.3f}")
        if timers["total"] > 0:
            print(f"keyframes/sec: {n_frames / timers['total']:.2f}")
        print(json.dumps({"timers_sec": {k: round(v, 4) for k, v in timers.items()}}))
        print(counters.report())
    return submission


def main(argv=None):
    p = argparse.ArgumentParser(description="CM3D 2D->3D lifting stage (PyTorch/CUDA)")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--mask_dir", required=True)
    p.add_argument("--scenes", default="",
                   help="comma-separated scene names; '' = all with artifacts")
    p.add_argument("--out", default="pseudolabels.json")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split the keyframe batch over N cards, one process a card "
                   "(N must divide --batch_size; 0 = single device)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run the step on ('cpu' runs the plain "
                   "PyTorch versions of the kernels)")
    p.add_argument("--resume", action="store_true",
                   help="keep samples already in --out; lift only the rest")
    p.add_argument("--host_shard", action="store_true",
                   help="multi-host: keep only this process's scene stride (RANK / "
                   "WORLD_SIZE, or torch.distributed's group)")
    p.add_argument("--profile", default="",
                   help="write a torch.profiler (chrome trace) file to this dir")
    p.add_argument("--drivable_filter", action="store_true",
                   help="drop off-road car/truck/bus boxes (ref :774-779)")
    p.add_argument("--lane_dist_filter", action="store_true",
                   help="drop boxes far from lanes (ref :756-758,782-785)")
    p.add_argument("--dataset_priors", action="store_true",
                   help="dataset-mean shape priors instead of the chatgpt table")
    p.add_argument("--priors_file", default="",
                   help="get_priors JSON overriding the built-in prior tables")
    args = p.parse_args(argv)

    store = MaskArtifactStore(args.mask_dir)
    if args.scenes:
        scenes = args.scenes.split(",")
    else:
        scenes = sorted(store.completed_scenes())
    if args.host_shard:
        scenes = shard_for_host(scenes)
    if not scenes:
        raise SystemExit("no scenes to process (no --scenes and empty manifest)")

    lift_cfg = dataclasses.replace(
        LiftStageConfig(),
        drivable_filter=args.drivable_filter,
        lane_dist_filter=args.lane_dist_filter,
        use_chatgpt_priors=not args.dataset_priors,
        priors_file=args.priors_file or None,
    )
    run_lift(args.dataroot, args.version, args.mask_dir, scenes, args.out,
             lift_cfg=lift_cfg, batch_size=args.batch_size,
             profile_dir=args.profile or None, resume=args.resume,
             data_parallel=args.data_parallel, device=args.device)


if __name__ == "__main__":
    main()

"""Waymo 2D->3D lifting CLI: frame-lite + mask artifacts -> pred .bin.
Mirrors `cm3d_tpu/pipelines/lift_waymo.py`.

Counterpart of src/waymo/2d_to_3d.py __main__ (:394-1305): same batched
device step as nuScenes (`make_keyframe_step_fn`, so the compaction and
medoid kernels run at Waymo's shapes: 5 cameras, one return), Waymo
frontend semantics (single return, vehicle-frame output boxes,
NUSC_TO_WAYMO class mapping), serialized metrics_pb2.Objects.

Usage:
  python -m cm3d_tpu_torch.pipelines.lift_waymo --frames_root F --mask_dir M \\
      --out pred.bin [--scenes segment-...] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List

from cm3d_tpu_torch.config import WAYMO_LIFT, LiftStageConfig
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device
from cm3d_tpu_torch.parallel import dp_step, make_keyframe_step_fn


def run_lift_waymo(
    frames_root: str,
    mask_dir: str,
    scenes: List[str],
    out_path: str,
    lift_cfg: LiftStageConfig = None,
    batch_size: int = 8,
    verbose: bool = True,
    data_parallel: int = 0,
    device=None,
) -> int:
    """Lift every frame of `scenes` and write the Objects .bin to
    `out_path`; returns the number of objects written. Runs on CUDA unless
    `device` says otherwise (the range image is unprojected there too).
    data_parallel N > 0 splits each batch over N ranks (parallel.dp_step):
    the same .bin as the single-device run."""
    from cm3d_tpu_torch.datasets.waymo.frontend import WaymoFrontend, boxes_to_waymo_objects
    from cm3d_tpu_torch.datasets.waymo.proto import encode_objects
    from cm3d_tpu_torch.utils.device import resolve_device
    from cm3d_tpu_torch.utils.fetch import device_fetch
    from cm3d_tpu_torch.utils.observability import lift_timers, span

    if lift_cfg is None:
        lift_cfg = WAYMO_LIFT
    device = resolve_device(device)
    totals: dict = {}  # span name -> seconds: the io / device / write timers
    t_total = time.perf_counter()

    frontend = WaymoFrontend(frames_root, MaskArtifactStore(mask_dir), lift_cfg,
                             device=device)
    all_objects = []
    pending: list = []
    n_frames = 0

    def flush(step):
        nonlocal pending
        if not pending:
            return
        n_real = len(pending)
        with span("cm3d.lift.flush", totals=totals):
            frames = [kf for kf, _ in pending]
            frames += [frames[-1]] * (batch_size - n_real)
            batch = stack_keyframes(frames)
            _, boxes = step(to_device(batch.frames, device))
            boxes_np = device_fetch(boxes)  # one batched transfer
        with span("cm3d.lift.write", totals=totals):
            for i, (_, meta) in enumerate(pending[:n_real]):
                all_objects.extend(boxes_to_waymo_objects(
                    meta, boxes_np.centers[i], boxes_np.sizes[i], boxes_np.yaws[i],
                    boxes_np.scores[i], boxes_np.labels[i], boxes_np.keep[i]))
        pending = []

    with dp_step(make_keyframe_step_fn(lift_cfg, device=device), batch_size,
                 data_parallel) as step:
        for scene in scenes:
            scene_frames = frontend.iter_scene(scene)
            while True:
                with span("cm3d.lift.io.wait", totals=totals):
                    item = next(scene_frames, None)
                if item is None:
                    break
                pending.append(item)
                n_frames += 1
                if len(pending) >= batch_size:
                    flush(step)
        flush(step)

    with span("cm3d.lift.write", totals=totals):
        with open(out_path, "wb") as f:
            f.write(encode_objects(all_objects))
    timers = lift_timers(totals, time.perf_counter() - t_total)

    if verbose:
        print(f"wrote {len(all_objects)} objects from {n_frames} frames.")
        for op, v in timers.items():
            print(f"{op} :\t\t {v:.3f}")
    return len(all_objects)


def main(argv=None):
    p = argparse.ArgumentParser(description="CM3D Waymo lifting stage (PyTorch/CUDA)")
    p.add_argument("--frames_root", required=True)
    p.add_argument("--mask_dir", required=True)
    p.add_argument("--scenes", default="", help="comma-separated; '' = all")
    p.add_argument("--out", default="pred.bin")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split the keyframe batch over N cards, one process a card "
                   "(N must divide --batch_size; 0 = single device)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cpu' runs the plain PyTorch "
                   "versions of the kernels)")
    args = p.parse_args(argv)

    from cm3d_tpu_torch.datasets.waymo.frontend import WaymoFrontend

    fe = WaymoFrontend(args.frames_root, MaskArtifactStore(args.mask_dir))
    scenes = args.scenes.split(",") if args.scenes else fe.scene_names()
    run_lift_waymo(args.frames_root, args.mask_dir, scenes, args.out,
                   batch_size=args.batch_size, data_parallel=args.data_parallel,
                   device=args.device)


if __name__ == "__main__":
    main()

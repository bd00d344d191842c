"""KITTI 2D->3D lifting driver: velodyne + mask artifacts -> label txts.
Mirrors `cm3d_tpu/pipelines/lift_kitti.py`.

The working version of the reference's src/kitti/2d_to_3d.py (its main loop
dead-ends at a debug exit, :1528): lift masks to centroids with the shared
device step (so the compaction and medoid kernels run at KITTI's shapes:
one camera), BEV-PCA yaw, per-frame circle NMS, KITTI-format pred txt (with
scores) and pseudo-label txt (without, reference save_pred :879-885).

Usage:
  python -m cm3d_tpu_torch.pipelines.lift_kitti --root KITTI --mask_dir M \\
      --out_dir preds [--indices 0,1,2] [--split training] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List

import numpy as np
import torch

from cm3d_tpu_torch.config import KITTI_LIFT, LiftStageConfig, class_arrays
from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
from cm3d_tpu_torch.datasets.kitti.calib import write_label
from cm3d_tpu_torch.datasets.kitti.frontend import (
    KittiFrontend,
    boxes_to_kitti_objects,
    kitti_image_wh,
)
from cm3d_tpu_torch.datasets.types import Keyframe, stack_keyframes, to_device
from cm3d_tpu_torch.ops.lift import LiftParams, lift_keyframe
from cm3d_tpu_torch.ops.nms import circle_nms_keep
from cm3d_tpu_torch.parallel import dp_step
from cm3d_tpu_torch.parallel.mesh import Program
from cm3d_tpu_torch.utils.device import resolve_device


def make_kitti_step_fn(cfg: LiftStageConfig = KITTI_LIFT, device=None):
    """Lift + circle NMS over a device Keyframe batch, no lane / pushback
    stage (KITTI has no map): frames -> (LiftOutputs, keep [B, M]). Runs on
    CUDA unless `device` says otherwise; raises when CUDA is asked for and
    absent."""
    device = resolve_device(device)
    # full f32 for the geometry, as parallel/pipeline.py make_keyframe_step_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, radii_np = class_arrays()
    radii = torch.from_numpy(radii_np).to(device)
    params = LiftParams(
        min_dist=cfg.min_dist,
        max_points_per_mask=cfg.max_points_per_mask,
        max_points_per_camera=cfg.max_points_per_camera,
        max_points_in_masks=cfg.max_points_in_masks,
        erode=cfg.erode_masks,
    )

    @torch.inference_mode()
    def step(frames: Keyframe):
        if frames.points.device != device:
            raise ValueError(
                f"keyframe batch is on {frames.points.device}, the step on {device}"
            )
        cams = frames.cameras
        lift = lift_keyframe(
            frames.points, frames.point_valid,
            cams.ego_translation, cams.ego_rotation,
            cams.cam_translation, cams.cam_rotation, cams.intrinsics,
            frames.mask_bits, frames.mask_cam, frames.mask_valid, params,
        )
        keep = circle_nms_keep(lift.centroids[..., :2], frames.mask_score,
                               frames.mask_label, lift.has_points, radii)
        return lift, keep & lift.has_points

    # how a data-parallel worker rebuilds this step (parallel.dp_step)
    step.program = Program(f"{__name__}:make_kitti_step_fn", (cfg,))
    step.device = device
    return step


def write_kitti_labels(out_dir: str, idx: int, objs) -> None:
    """`pred/{idx}.txt` with the scores and `pseudo/{idx}.txt` without
    (reference save_pred, kitti/2d_to_3d.py:879-885)."""
    write_label(f"{out_dir}/pred/{idx:06d}.txt", objs)
    pseudo = [type(o)(**{**o.__dict__, "score": float("nan")}) for o in objs]
    write_label(f"{out_dir}/pseudo/{idx:06d}.txt", pseudo)


def run_lift_kitti(
    root: str,
    mask_dir: str,
    indices: List[int],
    out_dir: str,
    lift_cfg: LiftStageConfig = None,
    batch_size: int = 8,
    verbose: bool = True,
    data_parallel: int = 0,
    split: str = "training",
    device=None,
) -> int:
    """Lift the frames `indices` of `split` and write their label txts
    under `out_dir/pred` and `out_dir/pseudo`; returns the number of boxes
    written. Runs on CUDA unless `device` says otherwise. data_parallel
    N > 0 splits each batch over N ranks (parallel.dp_step): the same
    label txts as the single-device run."""
    from cm3d_tpu_torch.utils.fetch import device_fetch

    if lift_cfg is None:
        lift_cfg = KITTI_LIFT
    device = resolve_device(device)
    frontend = KittiFrontend(root, MaskArtifactStore(mask_dir), lift_cfg, split=split)
    os.makedirs(f"{out_dir}/pred", exist_ok=True)
    os.makedirs(f"{out_dir}/pseudo", exist_ok=True)

    pending = []
    n_boxes = 0
    t0 = time.perf_counter()

    def flush(step):
        nonlocal pending, n_boxes
        if not pending:
            return
        n_real = len(pending)
        # the last batch is padded with its last frame, as in JAX
        frames = [kf for kf, _ in pending] + [pending[-1][0]] * (batch_size - n_real)
        batch = stack_keyframes(frames)
        lift, keep = step(to_device(batch.frames, device))
        lift_np, keep_np = device_fetch((lift, keep))  # one transfer
        for i, (_, idx) in enumerate(pending):
            objs = boxes_to_kitti_objects(
                frontend.dataset.get_calibration(idx),
                lift_np.centroids[i],
                lift_np.pca_yaws[i],
                np.asarray(batch.frames.mask_score)[i],
                np.asarray(batch.frames.mask_label)[i],
                keep_np[i],
                image_wh=kitti_image_wh(frontend.dataset, idx),
            )
            n_boxes += len(objs)
            write_kitti_labels(out_dir, idx, objs)
        pending = []

    with dp_step(make_kitti_step_fn(lift_cfg, device=device), batch_size,
                 data_parallel) as step:
        for kf, idx in frontend.iter_frames(indices):
            pending.append((kf, idx))
            if len(pending) >= batch_size:
                flush(step)
        flush(step)
    if verbose:
        dt = time.perf_counter() - t0
        print(f"wrote {n_boxes} boxes for {len(indices)} frames in {dt:.1f}s")
    return n_boxes


def main(argv=None):
    """CLI: the KITTI lift on the port (CUDA unless --device says otherwise)."""
    p = argparse.ArgumentParser(description="CM3D KITTI lifting stage (PyTorch/CUDA)")
    p.add_argument("--root", required=True)
    p.add_argument("--mask_dir", required=True)
    p.add_argument("--split", default="training")
    p.add_argument("--indices", default="", help="comma-separated; '' = all")
    p.add_argument("--out_dir", default="kitti_preds")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split the keyframe batch over N cards, one process a card "
                   "(N must divide --batch_size; 0 = single device)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cpu' runs the plain PyTorch "
                   "versions of the kernels)")
    args = p.parse_args(argv)

    store = MaskArtifactStore(args.mask_dir)
    if args.indices:
        indices = [int(i) for i in args.indices.split(",")]
    else:
        indices = store.frame_numbers("kitti")
    if not indices:
        raise SystemExit("no frames to process")
    run_lift_kitti(args.root, args.mask_dir, indices, args.out_dir,
                   batch_size=args.batch_size, data_parallel=args.data_parallel,
                   split=args.split, device=args.device)


if __name__ == "__main__":
    main()

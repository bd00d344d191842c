"""The batched keyframe step.

`keyframe_step` = lift + lane yaw + pushback + circle NMS for a batch of
keyframes — the fusion of the reference's pass 1 (src/nuscenes/2d_to_3d.py:
415-695), lane assignment (:699-706) and pass 2 (:733-825) plus per-sample
NMS (:844-907). Each centroid's nearest-lane lookup is independent, so the
reference's scene-level barrier dissolves and the whole step is
per-keyframe; the batch dimension is written out and folds into the
kernels' row dimension.
"""

from __future__ import annotations

import contextlib

import torch

from cm3d_tpu_torch.config import LiftStageConfig, class_arrays, drivable_class_array
from cm3d_tpu_torch.datasets.types import Keyframe
from cm3d_tpu_torch.ops.lift import (
    BoxOutputs,
    BoxParams,
    LiftOutputs,
    LiftParams,
    build_boxes,
    lift_keyframe,
)
from cm3d_tpu_torch.parallel.mesh import DataParallelGroup, Program, dp_mesh
from cm3d_tpu_torch.utils.device import resolve_device
from cm3d_tpu_torch.utils.observability import span


def keyframe_step(
    frames: Keyframe,
    priors: torch.Tensor,
    is_vehicle: torch.Tensor,
    nms_radius_sq: torch.Tensor,
    lift_params: LiftParams,
    drivable_class: torch.Tensor | None = None,
    box_params: BoxParams = BoxParams(),
) -> tuple[LiftOutputs, BoxOutputs]:
    """Process a batch of keyframes (every field with a leading B dim) end
    to end on their device."""
    lift = lift_keyframe(
        frames.points,
        frames.point_valid,
        frames.cameras.ego_translation,
        frames.cameras.ego_rotation,
        frames.cameras.cam_translation,
        frames.cameras.cam_rotation,
        frames.cameras.intrinsics,
        frames.mask_bits,
        frames.mask_cam,
        frames.mask_valid,
        lift_params,
    )
    boxes = build_boxes(
        lift.centroids,
        lift.has_points,
        frames.mask_label,
        frames.mask_score,
        frames.lane_points,
        frames.lane_valid,
        frames.ego_translation,
        priors,
        is_vehicle,
        nms_radius_sq,
        drivable_class=drivable_class,
        drivable_grid=frames.drivable_grid,
        drivable_origin=frames.drivable_origin,
        params=box_params,
    )
    return lift, boxes


def make_keyframe_step_fn(cfg: LiftStageConfig = LiftStageConfig(), device=None):
    """Build the batched step: a device Keyframe batch (datasets.types.
    to_device) -> (LiftOutputs, BoxOutputs). Runs on CUDA unless `device`
    says otherwise; raises when CUDA is asked for and absent."""
    device = resolve_device(device)
    # Keep every f32 product in full f32 (TF32 off for matmuls and cuDNN):
    # the geometry works on global-frame coordinates (~1e3 m), where TF32's
    # 10-bit mantissa would cost centimetres. The K=3 products are written
    # out elementwise as well (geometry/pointcloud.py).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    priors_np, is_vehicle_np, radii_np = class_arrays(
        use_chatgpt_priors=cfg.use_chatgpt_priors, priors_file=cfg.priors_file
    )
    priors = torch.from_numpy(priors_np).to(device)
    is_vehicle = torch.from_numpy(is_vehicle_np).to(device)
    radii = torch.from_numpy(radii_np).to(device)
    drivable = torch.from_numpy(drivable_class_array()).to(device)
    lift_params = LiftParams(
        min_dist=cfg.min_dist,
        max_points_per_mask=cfg.max_points_per_mask,
        max_points_per_camera=cfg.max_points_per_camera,
        max_points_in_masks=cfg.max_points_in_masks,
        erode=cfg.erode_masks,
    )
    box_params = BoxParams(
        lane_dist_filter=cfg.lane_dist_filter,
        object_lane_thresh=cfg.object_lane_thresh,
        vehicle_lane_thresh=cfg.vehicle_lane_thresh,
        drivable_filter=cfg.drivable_filter,
        drivable_resolution=cfg.drivable_resolution,
    )

    @torch.inference_mode()
    def step(frames: Keyframe):
        if frames.points.device != device:
            raise ValueError(
                f"keyframe batch is on {frames.points.device}, the step on {device}"
            )
        with span("cm3d.lift.step"):
            return keyframe_step(
                frames, priors, is_vehicle, radii, lift_params, drivable, box_params
            )

    # how a data-parallel worker rebuilds this step (dp_step)
    step.program = Program(f"{__name__}:make_keyframe_step_fn", (cfg,))
    step.device = device
    return step


def sharded_batch_step(group: DataParallelGroup, step):
    """Run a batch-major step over a started data-parallel group: the rows
    of every input tensor (a [B, ...] tree) are scattered over the ranks,
    each rank steps on its rows, and the outputs come back concatenated in
    rank order: the single-device step's tensors, row for row (the
    nuScenes / Waymo keyframe step and the KITTI step take no parameters
    but their batch)."""

    def run(*args):
        return group.run(step, args)

    return run


def sharded_keyframe_step(group: DataParallelGroup, cfg: LiftStageConfig = LiftStageConfig()):
    """The batched lift step over a started group (see sharded_batch_step);
    the group's workers must have been started with this step's program."""
    return sharded_batch_step(group, make_keyframe_step_fn(cfg, device=group.device))


@contextlib.contextmanager
def dp_step(step, batch_size: int, data_parallel: int):
    """The lift CLIs' --data_parallel contract, as a context: `step` itself
    when data_parallel is 0, else `step` over a fresh N-rank group
    (validation in mesh.dp_mesh), torn down on the way out. `step` must
    carry its `program` (how a worker rebuilds it: the factory by
    importable name and its picklable arguments)."""
    if not data_parallel:
        yield step
        return
    program = getattr(step, "program", None)
    if program is None:
        raise TypeError("a data-parallel step needs its `program`: the factory that "
                        "rebuilds it on a worker, by importable name, and its arguments")
    device = _step_device(step)
    with dp_mesh(data_parallel, batch_size, device, program) as group:
        yield sharded_batch_step(group, step)


def _step_device(step) -> torch.device:
    device = getattr(step, "device", None)
    if device is None:
        raise TypeError("a data-parallel step needs its `device`")
    return torch.device(device)

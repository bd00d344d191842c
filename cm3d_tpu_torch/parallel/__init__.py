"""Parallel execution: the device mesh, the batched keyframe step and its
data-parallel and multi-host versions over torch.distributed, and pipeline
parallelism (gpipe)."""

from cm3d_tpu_torch.parallel.gpipe import make_pipeline_fn, stack_layer_params, stage_mesh
from cm3d_tpu_torch.parallel.mesh import dp_mesh, make_mesh, shard_batch
from cm3d_tpu_torch.parallel.multihost import shard_for_host
from cm3d_tpu_torch.parallel.pipeline import (
    dp_step,
    keyframe_step,
    make_keyframe_step_fn,
    sharded_batch_step,
    sharded_keyframe_step,
)

__all__ = [
    "dp_mesh",
    "make_mesh",
    "shard_batch",
    "shard_for_host",
    "dp_step",
    "keyframe_step",
    "make_keyframe_step_fn",
    "sharded_batch_step",
    "sharded_keyframe_step",
    "make_pipeline_fn",
    "stack_layer_params",
    "stage_mesh",
]

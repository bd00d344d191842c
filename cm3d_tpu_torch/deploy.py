"""Deployment artifacts via `torch.export` (a serialized `.pt2` program).
Mirrors `cm3d_tpu/deploy.py`, whose artifacts are StableHLO.

`python -m cm3d_tpu_torch.deploy` exports one of the port's two programs,
the batched pseudo-label lift step (parallel/pipeline.py
make_keyframe_step_fn) or the trained detector's inference step
(pipelines/detect.py make_detect_fn), as a `torch.export` program saved
with `torch.export.save`. A serving host loads it with `load_artifact` and
calls it without building a model or tracing anything. The
`cm3d_tpu_torch` package must still be importable there: loading imports
the NamedTuple definitions (registered for pytree serialization) and the
kernel modules, whose dispatcher ops (kernels/ops.py) the program calls.

Notes:

- The hand-written CUDA kernels ride in the program as the `cm3d_torch::`
  ops: a loaded program launches the same kernels as the in-process step,
  and their `.launches` counters count its launches. Tracing runs the ops'
  fake implementations and counts nothing.
- Checkpointed parameters stay runtime INPUTS of the detect program
  (`params`, `batch_stats`: dicts keyed by the port's `state_dict` names),
  so one artifact serves every checkpoint of its shape; the program's own
  state dict holds no parameter.
- Shapes are static: one artifact per (config, batch) deployment point.
  A program is traced for one device type (`--platform`): CUDA by default,
  or the CPU, where the kernels' plain versions run.
- The program is the traced graph of eager ops, not an AOTInductor package
  and not `torch.compile`d: Inductor would fuse the plain ops and change
  their rounding, and a round trip must be bit-exact against the
  in-process step. The artifact holds no example inputs.
- `load_artifact` sets the TF32 switches the in-process step factories
  set (the program records nothing about them).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Any, NamedTuple

import numpy as np
import torch

_SERIALIZED = False


def _register_serializations() -> None:
    """Idempotently register the framework NamedTuples for pytree
    serialization (so artifact inputs and outputs keep their structure
    across hosts) and the kernels' dispatcher ops (so a program that calls
    them loads)."""
    global _SERIALIZED
    if _SERIALIZED:
        return
    import torch.utils._pytree as pytree

    # importing the kernel modules registers their cm3d_torch:: ops
    from cm3d_tpu_torch.kernels import (  # noqa: F401
        compact,
        medoid,
        segment,
        window_attn,
        window_attn_relpos,
    )
    from cm3d_tpu_torch.datasets.types import CameraParams, Keyframe
    from cm3d_tpu_torch.ops.lift import BoxOutputs, LiftOutputs

    for t in (CameraParams, Keyframe, LiftOutputs, BoxOutputs):
        try:
            pytree._register_namedtuple(t, serialized_type_name=f"cm3d_tpu_torch.{t.__name__}")
        except ValueError:
            pass  # already registered in this process
    _SERIALIZED = True


@dataclasses.dataclass(frozen=True)
class Aval:
    """An input's shape and dtype (JAX's `in_avals` entry); not a tuple, so
    that a tree of them keeps the structure of the inputs."""

    shape: tuple
    dtype: torch.dtype


class Artifact(NamedTuple):
    """A loaded program: `call(*args)` runs it; `in_avals` / `in_tree`
    describe its flat inputs and their (args, kwargs) structure;
    `platforms` its device type."""

    program: Any  # torch.export.ExportedProgram
    call: Any  # the program as a module
    in_avals: list
    in_tree: Any  # torch.utils._pytree.TreeSpec
    platforms: list


class _Program(torch.nn.Module):
    """A step function as the module `torch.export` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


class _DetectProgram(torch.nn.Module):
    """The detect step with the model's parameters and batch statistics as
    inputs: the model runs with them swapped in, and its own tensors are
    never read (the model is not a submodule, so none becomes state)."""

    def __init__(self, model, detect):
        super().__init__()
        object.__setattr__(self, "_model", model)
        self.detect = detect

    def forward(self, params, batch_stats, points, valid, *camera):
        from torch.nn.utils.stateless import _reparametrize_module

        with _reparametrize_module(self._model, {**params, **batch_stats}):
            return self.detect(points, valid, *camera)


def _export(module, args):
    with torch.no_grad():
        program = torch.export.export(module, args)
    # the artifact ships no batch: JAX exports from shapes alone
    program._example_inputs = None
    return program


def in_avals(program) -> list:
    """The shape and dtype of each flat user input of an ExportedProgram."""
    from torch.export.graph_signature import InputKind

    vals = {n.name: n.meta["val"] for n in program.graph.nodes if n.op == "placeholder"}
    return [Aval(tuple(vals[s.arg.name].shape), vals[s.arg.name].dtype)
            for s in program.graph_signature.input_specs if s.kind == InputKind.USER_INPUT]


def _platforms(program) -> list:
    devices = {n.meta["val"].device.type for n in program.graph.nodes
               if n.op == "placeholder" and isinstance(n.meta.get("val"), torch.Tensor)}
    return sorted(devices)


def export_lift_step(lift_cfg=None, batch_size: int = 8, device=None, frame=None):
    """Export the batched keyframe lift step (a Keyframe batch ->
    (LiftOutputs, BoxOutputs)) as a `torch.export.ExportedProgram` on
    `device` (CUDA unless the caller asks for another). `frame`, one
    (unbatched) numpy Keyframe, fixes the per-frame shapes; by default one
    synthetic frame does, as in the JAX package."""
    from cm3d_tpu_torch.config import LiftStageConfig
    from cm3d_tpu_torch.datasets.synthetic import SyntheticConfig, make_keyframe
    from cm3d_tpu_torch.datasets.types import _host_tensor, map_fields
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.utils.device import resolve_device

    _register_serializations()
    device = resolve_device(device)
    lift_cfg = lift_cfg or LiftStageConfig()
    if frame is None:
        frame = make_keyframe(SyntheticConfig(), lift_cfg, np.random.default_rng(0))

    def zeros(x):
        t = _host_tensor(x)  # the device dtype (uint32 mask words -> int32)
        return torch.zeros((batch_size,) + tuple(t.shape), dtype=t.dtype, device=device)

    example = map_fields(zeros, frame)
    return _export(_Program(make_keyframe_step_fn(lift_cfg, device=device)), (example,))


def detect_model(use_camera: bool = False, camera_backbone: str = "conv", pillar_cfg=None):
    """The detector `export_detect_step` traces: CenterPoint, or
    BEVFusion-lite with `use_camera`, at the package's default widths."""
    from cm3d_tpu_torch.pipelines.detect import build_detector
    from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig
    from cm3d_tpu_torch.train.bevfusion import BevFusionConfig

    fusion_cfg = BevFusionConfig(centerpoint=CenterPointConfig(),
                                 camera_backbone=camera_backbone) if use_camera else None
    return build_detector(pillar_cfg or PillarConfig(), CenterPointConfig(), fusion_cfg)


def export_detect_step(
    batch_size: int = 4,
    top_k: int = 128,
    score_thresh: float = 0.1,
    max_points: int = 32768,
    use_camera: bool = False,
    image_hw=(144, 256),
    camera_backbone: str = "conv",
    device=None,
    model=None,
    pillar_cfg=None,
):
    """Export the trained-detector inference step
    (params, batch_stats, points, valid[, images, intrinsics, cam_to_ego])
    -> (boxes, scores, classes, keep). Params are artifact INPUTS: the
    serving host loads any same-shape checkpoint and passes it in. `model`
    and `pillar_cfg` trace another detector than the default widths
    (`detect_model`); its state-dict names key the inputs
    (`train.train.model_tensors`)."""
    from cm3d_tpu_torch.config import class_arrays
    from cm3d_tpu_torch.pipelines.detect import make_detect_fn
    from cm3d_tpu_torch.train import PillarConfig
    from cm3d_tpu_torch.train.train import model_tensors
    from cm3d_tpu_torch.utils.device import resolve_device

    _register_serializations()
    device = resolve_device(device)
    pillar_cfg = pillar_cfg or PillarConfig()
    if model is None:
        model = detect_model(use_camera, camera_backbone, pillar_cfg)
    model = model.to(device)
    model_cfg = model.cfg.centerpoint if use_camera else model.cfg
    _, _, radii = class_arrays()
    detect = make_detect_fn(model, pillar_cfg, radii[: model_cfg.num_classes], top_k=top_k,
                            score_thresh=score_thresh, fusion=use_camera)
    params, stats = model_tensors(model)
    camera = ()
    if use_camera:
        ih, iw = image_hw
        camera = (torch.zeros((batch_size, 6, ih, iw, 3), device=device),
                  torch.eye(3, device=device).expand(batch_size, 6, 3, 3).contiguous(),
                  torch.eye(4, device=device).expand(batch_size, 6, 4, 4).contiguous())
    args = ({k: torch.zeros_like(v) for k, v in params.items()},
            {k: torch.zeros_like(v) for k, v in stats.items()},
            torch.zeros((batch_size, max_points, 4), device=device),
            torch.zeros((batch_size, max_points), dtype=torch.bool, device=device),
            *camera)
    return _export(_DetectProgram(model, detect), args)


def save_artifact(program, path: str | Path) -> Path:
    path = Path(path)
    torch.export.save(program, str(path))
    return path


def load_artifact(path: str | Path) -> Artifact:
    """Load a saved artifact; run it via ``.call(*args)`` (under inference
    mode). Sets TF32 off for matmuls and cuDNN, as the in-process step
    factories do."""
    from cm3d_tpu_torch.utils.device import strict_f32

    _register_serializations()
    strict_f32()
    program = torch.export.load(str(path))
    module = program.module()

    def call(*args):
        # as the in-process lift step: no autograd bookkeeping on any op
        with torch.inference_mode():
            return module(*args)

    return Artifact(program, call, in_avals(program), program.call_spec.in_spec,
                    _platforms(program))


def _device_for(p, platform: str):
    """--platform -> the device to trace on: '' is CUDA (resolve_device),
    'cpu' the CPU; a program is traced for one device type."""
    platforms = [s for s in platform.split(",") if s]
    if len(platforms) > 1:
        p.error(f"--platform {platform}: a torch.export program is traced for one device "
                "type; pass one of cuda, cpu")
    name = platforms[0] if platforms else ""
    if name in ("", "cuda", "gpu"):
        return None if not name else "cuda"
    if name == "cpu":
        return "cpu"
    p.error(f"--platform {name}: the port exports for cuda or cpu (no {name} backend)")


def main(argv=None):
    from cm3d_tpu_torch.config import DATASET_LIFT_PRESETS

    p = argparse.ArgumentParser(
        description="Export a cm3d_tpu_torch program as a torch.export artifact (.pt2)")
    p.add_argument("--what", choices=("lift", "detect"), default="lift")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--platform", default="",
                   help="cuda or cpu; default = CUDA (a program is traced for one device type)")
    p.add_argument("--dataset", default="nuscenes",
                   choices=tuple(sorted(DATASET_LIFT_PRESETS)),
                   help="lift: which dataset's LiftStageConfig preset to trace")
    p.add_argument("--use_camera", action="store_true",
                   help="detect: export the BEVFusion-lite variant")
    p.add_argument("--camera_backbone", default="conv", choices=("conv", "swin_t"))
    p.add_argument("--top_k", type=int, default=128)
    p.add_argument("--max_points", type=int, default=32768)
    args = p.parse_args(argv)

    device = _device_for(p, args.platform)
    if args.what == "lift":
        # Fail loud on flags the lift artifact would silently ignore.
        ignored = [
            name for name, on in (
                ("--use_camera", args.use_camera),
                ("--camera_backbone", args.camera_backbone != "conv"),
                ("--top_k", args.top_k != 128),
                ("--max_points", args.max_points != 32768),
            ) if on
        ]
        if ignored:
            p.error(f"{', '.join(ignored)} only apply to --what detect")
        program = export_lift_step(lift_cfg=DATASET_LIFT_PRESETS[args.dataset],
                                   batch_size=args.batch, device=device)
    else:
        if args.dataset != "nuscenes":
            p.error("--dataset only applies to --what lift")
        program = export_detect_step(
            batch_size=args.batch, top_k=args.top_k, max_points=args.max_points,
            use_camera=args.use_camera, camera_backbone=args.camera_backbone, device=device)
    out = save_artifact(program, args.out)
    print(f"wrote {out} ({out.stat().st_size} bytes) platforms={_platforms(program)} "
          f"in_avals={len(in_avals(program))}")
    return out


if __name__ == "__main__":
    main()

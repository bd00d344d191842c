"""Canonical keyframe structures — the contract between dataset frontends
and the device step.

Every frontend (nuScenes / synthetic) produces the same fixed-shape
`Keyframe` of numpy host arrays, padded to the static sizes in
`LiftStageConfig` with validity masks. `to_device` moves a stacked batch to
the device as torch tensors; the step consumes that.

Mask words: the host keeps `mask_bits` as uint32 bit-planes (the artifact
and JAX layout). On the device they ride as int32 BIT PATTERNS — torch's CPU
build implements no shifts on uint32 — so `to_device` reinterprets them with
`.view(np.int32)` at the host boundary; no bit changes.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from cm3d_tpu_torch.utils.observability import span

# Placeholder drivable raster for frontends/configs with drivable_filter off:
# a single non-drivable cell (build_boxes skips the lookup).
_NO_DRIVABLE_GRID = np.zeros((1, 1), bool)
_NO_DRIVABLE_GRID.setflags(write=False)
_ZERO2 = np.zeros(2, np.float32)
_ZERO2.setflags(write=False)


class CameraParams(NamedTuple):
    """Per-camera calibration at the keyframe. Leading dim C = num cameras."""

    ego_translation: Any  # [C, 3] ego pose at camera timestamp
    ego_rotation: Any  # [C, 4] quaternion (w, x, y, z)
    cam_translation: Any  # [C, 3] sensor->ego extrinsic
    cam_rotation: Any  # [C, 4]
    intrinsics: Any  # [C, 3, 3] ALREADY ratio-scaled, [2,2] = 1


class Keyframe(NamedTuple):
    """One keyframe's inputs (single sample; batch via stacking)."""

    points: Any  # [N, 4] aggregated sweeps, GLOBAL frame
    point_valid: Any  # [N] bool
    cameras: CameraParams
    mask_bits: Any  # [W, H, ceil(M/32)] bit-packed masks, [x, y]
    mask_cam: Any  # [M] int32
    mask_label: Any  # [M] int32 canonical class id
    mask_score: Any  # [M] float32
    mask_valid: Any  # [M] bool
    lane_points: Any  # [L, 3] (x, y, yaw), scene map prior
    lane_valid: Any  # [L] bool
    ego_translation: Any  # [3] LIDAR_TOP ego position at the keyframe
    # Rasterized drivable area around ego (used only when
    # LiftStageConfig.drivable_filter; placeholders otherwise). Grid is
    # indexed [ix, iy] with world xy = origin + (i + 0.5) * resolution.
    drivable_grid: Any = _NO_DRIVABLE_GRID  # [G, G] bool
    drivable_origin: Any = _ZERO2  # [2] world xy of cell (0, 0) corner


class KeyframeBatch(NamedTuple):
    """A stacked batch of keyframes: every leaf gains a leading B dim."""

    frames: Keyframe

    @property
    def batch_size(self) -> int:
        return self.frames.points.shape[0]


def map_fields(fn: Callable, *trees):
    """Apply `fn` leaf-wise over parallel trees of tuples and NamedTuples
    (the port's stand-in for jax.tree.map over Keyframe / LiftOutputs /
    BoxOutputs)."""
    first = trees[0]
    if isinstance(first, tuple):
        mapped = (map_fields(fn, *xs) for xs in zip(*trees))
        return type(first)(*mapped) if hasattr(first, "_fields") else tuple(mapped)
    return fn(*trees)


def _stack(*xs):
    # device leaves (the fused path's mask planes) stack on the device:
    # np.stack would take ~9 MB a frame through the host and back
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack(xs, axis=0)


def stack_keyframes(frames: list[Keyframe]) -> KeyframeBatch:
    """Stack keyframes into a batch: numpy leaves with numpy (no device
    transfer), tensor leaves where they are."""
    return KeyframeBatch(frames=map_fields(_stack, *frames))


def _host_tensor(x) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    if not (x.flags.writeable and x.flags.c_contiguous):
        x = np.array(x, order="C")
    return torch.from_numpy(x)


def to_device(frames: Keyframe, device) -> Keyframe:
    """Move a (stacked) numpy Keyframe to `device` as torch tensors.

    CUDA copies go through pinned host memory and are issued non-blocking
    on the current stream, so the step queued after them needs no sync. A
    leaf that is a tensor already (the fused path's mask planes, straight
    from the SAM decode) is not copied through the host."""
    device = torch.device(device)
    pinned = device.type == "cuda"

    def move(x):
        if isinstance(x, torch.Tensor):
            if pinned and x.device.type == "cpu":
                with span("cm3d.h2d.wait"):  # a blocking copy: the host waits for it
                    return x.to(device)
            return x.to(device)
        t = _host_tensor(x)
        if pinned:
            t = t.pin_memory()
        return t.to(device, non_blocking=pinned)

    with span("cm3d.h2d"):
        return map_fields(move, frames)


def keyframe_from_numpy(frames, device) -> Keyframe:
    """The port's device batch from any object with the Keyframe fields —
    in particular the JAX package's `Keyframe` / `KeyframeBatch` holding
    numpy arrays (uint32 mask words become their int32 view)."""
    frames = getattr(frames, "frames", frames)
    cams = CameraParams(*(np.asarray(getattr(frames.cameras, f))
                          for f in CameraParams._fields))
    kf = Keyframe(**{f: (cams if f == "cameras" else np.asarray(getattr(frames, f)))
                     for f in Keyframe._fields})
    return to_device(kf, device)

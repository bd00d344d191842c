"""Mask artifact store: the checkpoint between the 2D and lifting stages.

The reference's only checkpoint/resume mechanism is this file contract
(SURVEY.md §5): per scene directory, `{frame}_data.json` holding labels /
detection_scores / cam_nums and `{frame}_masks.pkl` holding a pickled list
of COCO-RLE dicts (gen_2d_masks_detic.py:497-506; consumed at
2d_to_3d.py:422-428). We keep the exact layout — it is load-bearing for
parity testing against reference-generated artifacts — and add what the
reference lacks: an explicit completion manifest so resume is a set
difference instead of "rerun and hope" (SURVEY.md §5 failure-detection row).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from cm3d_tpu_torch.ops import rle

MANIFEST_NAME = "_manifest.json"


def paste_mask_canvas(dst: np.ndarray, i: int, mk: np.ndarray,
                      w: int, h: int) -> None:
    """Paste one stored dense mask into row i of the x-major canvas
    dst [M, w, h] (shared by the store's dense fallback and the Waymo
    frontend — ONE definition of the canvas contract).

    Two RLE dialects reach this point: this repo's writers store x-major
    [W', H'] masks (always at their writer's full canvas), while
    reference/pycocotools artifacts store y-major [H', W'] masks at the
    thumbnailed IMAGE size, which may be smaller than the canvas (Waymo's
    shorter side cameras, KITTI's per-frame image sizes — padded in at
    the SAME pixel scale; scale mismatches are not detectable from shape,
    so read with the mask_wh the artifacts were written at). Orientation
    is decided by which way the mask fits the canvas; when both fit, an
    array with first dim < second dim is taken as y-major — camera
    canvases are landscape, and only the y-major dialect produces
    sub-canvas masks. A mask fitting NEITHER way
    would be silently CROPPED (artifacts written at one thumbnail/mask_wh
    read at a smaller one, misaligning masks with the camera projection)
    — it fails loudly instead."""
    a, b = mk.shape
    fits_x = a <= w and b <= h
    fits_y = b <= w and a <= h
    if fits_x and (not fits_y or a >= b):
        pass  # x-major [W', H'] (this repo's writers)
    elif fits_y:
        mk = mk.T  # y-major [H', W'] (reference/pycocotools layout)
    else:
        raise ValueError(
            f"stored mask {mk.shape} exceeds the {w}x{h} canvas in both "
            "orientations — the artifacts were written at a different "
            "thumbnail/mask_wh (cropping would silently misalign masks "
            "with the camera projection); re-run the mask stage or pass "
            "the matching geometry"
        )
    dst[i, : mk.shape[0], : mk.shape[1]] = mk.astype(bool)


@dataclasses.dataclass
class FrameMasks:
    """One frame's 2D-stage output."""

    labels: List[str]
    detection_scores: List[float]
    cam_nums: List[int]
    masks: np.ndarray  # [M, W, H] uint8 (mask arrays are [x, y]-indexed)

    def __post_init__(self):
        n = len(self.labels)
        assert len(self.detection_scores) == n
        assert len(self.cam_nums) == n
        assert self.masks.shape[0] == n


class MaskArtifactStore:
    """Reference-layout artifact store with manifest-based resume."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def _scene_dir(self, scene_name: str) -> Path:
        return self.root / scene_name

    # -- write ------------------------------------------------------------

    def write_frame(self, scene_name: str, frame_num: int, fm: FrameMasks) -> None:
        self.write_frame_rles(
            scene_name, frame_num, fm.labels, fm.detection_scores,
            fm.cam_nums, rle.encode_many(fm.masks),
        )

    def _write_frame_payload(self, scene_name: str, frame_num: int, labels: List[str],
                             detection_scores: List[float], cam_nums: List[int],
                             payload) -> None:
        """The atomic {frame}_data.json + {frame}_masks.pkl protocol of the
        reference (gen_2d_masks_detic.py:497-506); `payload` is what goes
        into the pickle (RLE list or depth-image array)."""
        d = self._scene_dir(scene_name)
        d.mkdir(parents=True, exist_ok=True)
        data = {
            "labels": list(labels),
            "detection_scores": [float(s) for s in detection_scores],
            "cam_nums": [int(c) for c in cam_nums],
        }
        tmp = d / f".{frame_num}_data.json.tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, d / f"{frame_num}_data.json")
        tmp = d / f".{frame_num}_masks.pkl.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, d / f"{frame_num}_masks.pkl")

    def write_frame_rles(
        self,
        scene_name: str,
        frame_num: int,
        labels: List[str],
        detection_scores: List[float],
        cam_nums: List[int],
        rles: List[dict],
    ) -> None:
        """Write a frame from already-encoded COCO RLE dicts."""
        assert len(labels) == len(detection_scores) == len(cam_nums) == len(rles)
        self._write_frame_payload(scene_name, frame_num, labels, detection_scores, cam_nums,
                                  rles)

    def write_frame_depths(
        self,
        scene_name: str,
        frame_num: int,
        labels: List[str],
        detection_scores: List[float],
        cam_nums: List[int],
        depth_images,  # [M, H, W] f32 per-mask masked metric depth
    ) -> None:
        """use_zoedepth variant: the reference's zoe branch pickles the
        masked depth images INTO {frame}_masks.pkl in place of the mask
        payload (gen_2d_masks_detic.py:484-486,505), with the same data.json
        sidecar; f32, as the JAX package writes them."""
        depth_images = np.asarray(depth_images, np.float32)
        assert len(labels) == len(detection_scores) == len(cam_nums)
        assert depth_images.shape[0] == len(labels)
        self._write_frame_payload(scene_name, frame_num, labels, detection_scores, cam_nums,
                                  depth_images)

    def read_frame_depths(self, scene_name: str, frame_num: int):
        """Read back a use_zoedepth frame: (data dict, [M, H, W] f32), or
        None if the frame is missing or unreadable."""
        d = self._scene_dir(scene_name)
        try:
            with open(d / f"{frame_num}_data.json") as f:
                data = json.load(f)
            with open(d / f"{frame_num}_masks.pkl", "rb") as f:
                depths = pickle.load(f)
        except (OSError, json.JSONDecodeError, pickle.UnpicklingError, EOFError):
            return None
        return data, depths

    def mark_scene_complete(self, scene_name: str, num_frames: int) -> None:
        # the read-modify-write is guarded by an flock: several processes
        # may share one artifact root, and two
        # concurrent completions would otherwise lose one entry (the
        # resume logic then reschedules a fully-finished scene). os.replace
        # keeps single-writer crash-atomicity; the lock adds multi-writer
        # mutual exclusion.
        import fcntl

        lock = self.root / (MANIFEST_NAME + ".lock")
        with open(lock, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            manifest = self.load_manifest()
            manifest[scene_name] = num_frames
            # fixed tmp name: the flock already serializes writers, and a
            # crash between dump and replace leaves at most ONE stale file
            # that the next successful write consumes via os.replace
            # (pid-suffixed names orphaned a new file per killed writer)
            tmp = self.root / (MANIFEST_NAME + ".tmp")
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, self.root / MANIFEST_NAME)

    # -- read -------------------------------------------------------------

    def load_manifest(self) -> Dict[str, int]:
        p = self.root / MANIFEST_NAME
        if p.exists():
            with open(p) as f:
                return json.load(f)
        return {}

    def completed_scenes(self) -> set:
        return set(self.load_manifest().keys())

    def remaining_scenes(self, all_scenes: Sequence[str]) -> List[str]:
        """Resume = set difference on the manifest (idempotent work units)."""
        done = self.completed_scenes()
        return [s for s in all_scenes if s not in done]

    def has_frame(self, scene_name: str, frame_num: int) -> bool:
        d = self._scene_dir(scene_name)
        return (d / f"{frame_num}_data.json").exists() and (
            d / f"{frame_num}_masks.pkl"
        ).exists()

    def read_frame(self, scene_name: str, frame_num: int) -> Optional[FrameMasks]:
        """Returns None (and does not raise) on missing/corrupt artifacts —
        skip-and-log semantics replacing the reference's bare KeyError crash."""
        d = self._scene_dir(scene_name)
        try:
            with open(d / f"{frame_num}_data.json") as f:
                data = json.load(f)
            with open(d / f"{frame_num}_masks.pkl", "rb") as f:
                rles = pickle.load(f)
        except (OSError, json.JSONDecodeError, pickle.UnpicklingError, EOFError):
            return None
        masks = rle.decode_many(rles)
        return FrameMasks(
            labels=data["labels"],
            detection_scores=data["detection_scores"],
            cam_nums=data["cam_nums"],
            masks=masks,
        )

    def read_frame_packed(
        self, scene_name: str, frame_num: int, num_words: int,
        mask_wh: tuple,
    ):
        """Fast path: (labels, scores, cam_nums, words [W, H, num_words])
        with RLE decoded straight into packed bit-planes (C, no dense
        intermediate). Returns None on missing/corrupt artifacts; falls back
        to the dense path when sizes mismatch or the C codec is absent."""
        d = self._scene_dir(scene_name)
        try:
            with open(d / f"{frame_num}_data.json") as f:
                data = json.load(f)
            with open(d / f"{frame_num}_masks.pkl", "rb") as f:
                rles = pickle.load(f)
        except (OSError, json.JSONDecodeError, pickle.UnpicklingError, EOFError):
            return None
        w, h = mask_wh
        words = None
        if rles and list(rles[0]["size"]) == [w, h]:
            words = rle.decode_many_packed(rles, num_words)
        if words is None:
            from cm3d_tpu_torch.ops.bitmask import pack_masks_np

            masks = rle.decode_many(rles)
            m_cap = num_words * 32
            padded = np.zeros((m_cap, w, h), bool)
            for i in range(min(len(masks), m_cap)):
                paste_mask_canvas(padded, i, masks[i], w, h)
            words = pack_masks_np(padded)
        return data["labels"], data["detection_scores"], data["cam_nums"], words

    def frame_numbers(self, scene_name: str) -> List[int]:
        d = self._scene_dir(scene_name)
        if not d.is_dir():
            return []
        out = []
        for p in d.glob("*_data.json"):
            stem = p.name[: -len("_data.json")]
            if stem.isdigit():
                out.append(int(stem))
        return sorted(out)

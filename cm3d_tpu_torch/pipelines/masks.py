"""2D mask-generation stage: Detic -> class-wise NMS -> SAM -> artifacts.
Mirrors `cm3d_tpu/pipelines/masks.py`.

The counterpart of the reference's src/nuscenes/gen_2d_masks_detic.py
__main__ (:242-513): per camera image, run the open-vocabulary detector
with the custom vocabulary, map detector labels to canonical classes
(map_class), class-wise 2D NMS at IoU 0.75, box-prompt SAM for instance
masks, store masks transposed [W, H] as COCO RLE with labels / scores /
cam_nums JSON.

Model forwards are injected callables (`MaskModels`), so the pipeline runs
identically with full-size or tiny random-weight models. The camera ring is
batched: one Detic forward for the ring, the SAM encoder over the cameras
in chunks, one decode + bit-pack for the ring. Device->host copies start on
the main thread as soon as their producer is queued (pinned memory, a CUDA
event), so a waiting thread blocks only on that producer, not on the work
queued after it.

With `--quant_int8` the SAM encoder and Detic's Swin MLPs run int8 w8a8
(`ops/quant.py`; `--quant_static` calibrates SAM's activation scales on the
first camera ring); with `--use_zoedepth` each mask's payload is the masked
ZoeDepth metric depth instead of its RLE (`models/zoedepth.py`); with
`--detector gdino` GroundingDINO's grounded boxes replace Detic's
(`models/gdino.py`, `attach_gdino`).

    python -m cm3d_tpu_torch.pipelines.masks --dataroot ROOT --out_dir OUT \\
        [--dataset waymo|kitti] (--fake_weights | --detic_ckpt D --sam_ckpt S \\
        --clip_ckpt C --bpe_path B [--sam_size vit_h]) [--quant_int8 \\
        [--quant_static]] [--use_zoedepth [--zoe_ckpt Z]] [--detector gdino \\
        [--gdino_ckpt G --gdino_vocab V] [--gdino_bf16]] [--camera_mesh N] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cm3d_tpu_torch.config import MaskStageConfig
from cm3d_tpu_torch.datasets.artifacts import FrameMasks, MaskArtifactStore
from cm3d_tpu_torch.ops.bitmask import num_words, unpack_masks_np
from cm3d_tpu_torch.pipelines.cli_flags import (
    add_model_flags, add_quant_flags, add_run_flags, camera_mesh, run_nms)
from cm3d_tpu_torch.utils.fetch import HostCopy
from cm3d_tpu_torch.utils.observability import COUNTERS, span
from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES, map_class


@dataclasses.dataclass
class MaskModels:
    """Injected model callables, batched over the camera ring.

    prepare(images: list of per-camera RGB uint8) -> frame inputs: ONE
        uint8 canvas upload shared by detector and segmenter
        (normalization happens on the device).
    detic(frame) -> (boxes [C,D,4] xyxy image px, scores [C,D], class_ids
        [C,D], valid [C,D]) device tensors.
    sam_encode(frame) -> per-camera embeddings [C, h, w, d] (device).
    sam_decode_planes(emb, boxes_img [C,P,4], n_boxes [C], cam_hw, mask_wh,
        num_words, layout="xy"|"yx") -> [W, H, num_words] (xy) or
        [H, W, num_words] (yx) int32 bit-planes (device).
    vocabulary: detector vocabulary strings (class_ids index this)
    predict_depth: optional ZoeDepth metric depth, image_u8 [H, W, 3] ->
        depth [H, W] f32 meters (reference predict_depth,
        gen_2d_masks_detic.py:121-124), with a `dispatch` attribute that
        returns the device tensor; used when MaskStageConfig.use_zoedepth
        is on (`attach_zoedepth`).
    """

    prepare: Callable
    detic: Callable
    sam_encode: Callable
    sam_decode_planes: Callable
    vocabulary: Tuple[str, ...] = CUSTOM_VOCABULARY_NUSCENES
    predict_depth: Optional[Callable] = None


def planes_numpy(handle: dict) -> np.ndarray:
    """The handle's planes as host uint32 words: waits for the copy that
    `start_frame_masks` started, or starts it now if it was asked not to."""
    if handle["planes_host"] is None:
        handle["planes_host"] = HostCopy([handle["planes"]])
    return handle["planes_host"].get()[0].view(np.uint32)


def classwise_nms_np(boxes, scores, labels, iou_thresh=0.75):
    """Host-side greedy class-wise NMS (reference :348-372 semantics).
    Returns indices kept, in descending score order per class iteration."""
    keep = []
    boxes = np.asarray(boxes, np.float64)
    for cls in sorted(set(labels)):
        idx = [i for i, lab in enumerate(labels) if lab == cls]
        idx = sorted(idx, key=lambda i: -scores[i])
        alive = set(idx)
        for a, i in enumerate(idx):
            if i not in alive:
                continue
            keep.append(i)
            x1, y1, x2, y2 = boxes[i]
            ai = max(x2 - x1, 0) * max(y2 - y1, 0)
            for j in idx[a + 1:]:
                if j not in alive:
                    continue
                xx1, yy1 = max(x1, boxes[j][0]), max(y1, boxes[j][1])
                xx2, yy2 = min(x2, boxes[j][2]), min(y2, boxes[j][3])
                inter = max(xx2 - xx1, 0) * max(yy2 - yy1, 0)
                aj = max(boxes[j][2] - boxes[j][0], 0) * max(boxes[j][3] - boxes[j][1], 0)
                if union := ai + aj - inter:
                    if inter / union > iou_thresh:
                        alive.discard(j)
    return keep


def start_frame_masks(
    models: MaskModels,
    images: Optional[List[np.ndarray]],  # per-camera RGB uint8 (thumbnailed)
    cfg: MaskStageConfig = MaskStageConfig(),
    mask_wh: Optional[Tuple[int, int]] = None,
    plane_layout: str = "yx",
    prepared: Optional[dict] = None,
    copy_planes: bool = True,
) -> dict:
    """Queue a keyframe up to its last device work (Detic, SAM encode, host
    NMS, the decode + bit-pack). The handle carries the planes as a device
    tensor ("planes", int32 words; None without detections). With
    `copy_planes` their copy to pinned host memory starts here, right after
    the decode is queued, and `finish_frame_masks` / `write_frame_artifacts`
    wait for it; a caller that feeds the planes to the lift step on the
    device passes False, and the copy starts only if artifacts are written.
    Frame N's decode is queued before frame N+1's encoder, while frame N's
    RLE writes and frame N+1's image IO run on the host under the device
    work."""
    frame_inputs = prepared if prepared is not None else models.prepare(images)
    if images is None:
        images = frame_inputs["images"]
    cam_hw = tuple((im.shape[0], im.shape[1]) for im in images)
    plane_wh = mask_wh or (max(w for _, w in cam_hw), max(h for h, _ in cam_hw))
    # Detic first, its results' copy started before the encode is queued:
    # the host waits for the boxes only, and runs NMS under the encode
    with span("cm3d.masks.detic"):
        det = HostCopy(list(models.detic(frame_inputs)))
    with span("cm3d.masks.sam_encode"):
        emb = models.sam_encode(frame_inputs)
    depths = None
    if cfg.use_zoedepth and models.predict_depth is not None:
        # reference zoe branch (:412-414): one depth map per camera image,
        # queued on the device here; their copy to the host starts at once
        # and the finisher waits for it (masked_depth_images)
        depth_fn = getattr(models.predict_depth, "dispatch", models.predict_depth)
        depths = HostCopy([torch.as_tensor(depth_fn(im)) for im in images])
    with span("cm3d.masks.detic.wait"):
        boxes_b, scores_b, cids_b, valid_b = det.get()
    n_cams = len(cam_hw)

    p = cfg.max_detections
    cap = cfg.max_masks_total
    nw = num_words(cap)
    prompts = np.zeros((n_cams, p, 4), np.float32)
    n_boxes = np.zeros(n_cams, np.int32)
    all_labels: List[str] = []
    all_scores: List[float] = []
    all_cams: List[int] = []
    total = 0
    counts = {
        "detections": 0, "nms_suppressed": 0,
        "dropped_max_detections": 0, "dropped_masks_total": 0,
        "masks_written": 0,
    }
    with span("cm3d.masks.prompts"):
        for cam_idx in range(n_cams):
            v = valid_b[cam_idx]
            boxes = boxes_b[cam_idx][v]
            scores = scores_b[cam_idx][v]
            class_ids = cids_b[cam_idx][v]
            counts["detections"] += len(boxes)
            if len(boxes) == 0:
                continue
            labels = [map_class(models.vocabulary[c].lower()) for c in class_ids]
            if cfg.run_nms:
                kept = classwise_nms_np(boxes, scores, labels, cfg.nms_iou)
                counts["nms_suppressed"] += len(boxes) - len(kept)
                boxes = boxes[kept]
                scores = scores[kept]
                labels = [labels[i] for i in kept]
            # detections past either static cap are dropped, and counted
            k_cam = min(len(boxes), p)
            counts["dropped_max_detections"] += len(boxes) - k_cam
            k = min(k_cam, max(cap - total, 0))
            counts["dropped_masks_total"] += k_cam - k
            if k <= 0:
                continue
            if k < len(boxes):
                # a cap binds: drop the LOWEST scores, survivors keep their order
                top = np.sort(np.argsort(-scores, kind="stable")[:k])
                boxes = boxes[top]
                scores = scores[top]
                labels = [labels[i] for i in top]
            prompts[cam_idx, :k] = boxes[:k]
            n_boxes[cam_idx] = k
            all_labels.extend(labels[:k])
            all_scores.extend(float(s) for s in scores[:k])
            all_cams.extend([cam_idx] * k)
            total += k
    counts["masks_written"] = total

    planes = None
    if total:
        # smallest prompt bucket that fits the busiest camera
        pmax = int(n_boxes.max())
        bucket = next((b for b in sorted(cfg.prompt_buckets) if b >= pmax), p)
        with span("cm3d.masks.sam_decode"):
            planes = models.sam_decode_planes(
                emb, prompts[:, :bucket], n_boxes, cam_hw, plane_wh, nw, plane_layout)
        # every camera decodes every slot of the bucket
        COUNTERS["masks.prompts"] += total
        COUNTERS["masks.prompt_slots"] += n_cams * bucket
    return {
        "planes": planes, "total": total, "plane_wh": plane_wh,
        "planes_host": HostCopy([planes]) if total and copy_planes else None,
        "layout": plane_layout,
        "labels": all_labels, "scores": all_scores, "cams": all_cams,
        "counts": counts, "depths": depths,
    }


def masked_depth_images(handle: dict) -> np.ndarray:
    """use_zoedepth payload: per-mask masked metric depth [M, H, W] f32
    (reference :445-451: `depth_image_arr * mask_alpha`). Depth maps are
    zero-padded to the plane size; each mask crops its camera's map.
    `handle["depths"]`: the HostCopy start_frame_masks made, or a list of
    per-camera [h, w] arrays."""
    plane_w, plane_h = handle["plane_wh"]
    depths = handle["depths"]
    if handle["planes"] is None or not handle["labels"]:
        return np.zeros((0, plane_h, plane_w), np.float32)
    planes = planes_numpy(handle)
    if handle["layout"] == "yx":
        planes = np.ascontiguousarray(np.swapaxes(planes, 0, 1))
    dense = unpack_masks_np(planes, handle["total"])  # [M, W, H] bool
    depths = depths.get() if isinstance(depths, HostCopy) else depths
    pad = np.zeros((len(depths), plane_h, plane_w), np.float32)
    for c, dm in enumerate(depths):
        dm = np.asarray(dm, np.float32)
        pad[c, :dm.shape[0], :dm.shape[1]] = dm
    cams = np.asarray(handle["cams"], np.int32)
    return np.swapaxes(dense, 1, 2).astype(np.float32) * pad[cams]


def finish_frame_masks(models: MaskModels, handle: dict,
                       cfg: MaskStageConfig = MaskStageConfig()) -> FrameMasks:
    """Download + unpack the planes of a frame started by start_frame_masks."""
    plane_wh = handle["plane_wh"]
    if handle["planes"] is None:
        return FrameMasks([], [], [], np.zeros((0, plane_wh[0], plane_wh[1]), np.uint8))
    planes = planes_numpy(handle)
    if handle["layout"] == "yx":
        planes = np.ascontiguousarray(np.swapaxes(planes, 0, 1))
    dense = unpack_masks_np(planes, handle["total"]).astype(np.uint8)
    return FrameMasks(handle["labels"], handle["scores"], handle["cams"], dense)


def write_frame_artifacts(store, scene: str, frame_num: int, handle: dict) -> None:
    """Write one frame's mask artifacts straight from a start_frame_masks
    handle via the packed-plane RLE encoder (no dense [M, W, H]
    intermediate). With use_zoedepth the masked depth images replace the
    mask payload (reference :484-486), checked first, so that a frame without
    detections still writes the depth payload's type ([0, H, W] f32)."""
    if handle.get("depths") is not None:
        store.write_frame_depths(scene, frame_num, handle["labels"], handle["scores"],
                                 handle["cams"], masked_depth_images(handle))
        return
    if handle["planes"] is None:
        store.write_frame_rles(scene, frame_num, handle["labels"], handle["scores"],
                               handle["cams"], [])
        return
    from cm3d_tpu_torch.ops import rle as rle_codec

    rles = rle_codec.encode_packed_many(planes_numpy(handle), handle["total"],
                                        layout=handle["layout"])
    store.write_frame_rles(scene, frame_num, handle["labels"], handle["scores"],
                           handle["cams"], rles)


def generate_frame_masks(models: MaskModels, images: List[np.ndarray],
                         cfg: MaskStageConfig = MaskStageConfig(),
                         mask_wh: Optional[Tuple[int, int]] = None) -> FrameMasks:
    """One keyframe end to end, with "xy" planes (dense [M, W, H] masks in
    the lift-side layout)."""
    return finish_frame_masks(
        models, start_frame_masks(models, images, cfg, mask_wh, plane_layout="xy"), cfg)


def run_mask_stage(
    models: MaskModels,
    image_provider: Callable[[str, int], List[np.ndarray]],
    scenes: List[str],
    frames_per_scene: Callable[[str], int],
    out_dir: str,
    cfg: MaskStageConfig = MaskStageConfig(),
    resume: bool = True,
    verbose: bool = True,
    counters=None,
) -> None:
    """Drive the mask stage over scenes; writes reference-layout artifacts.

    image_provider(scene, frame) -> list of per-camera RGB uint8 arrays.
    counters: optional utils.observability.MaskCounters to accumulate into
    (one is created, and reported when verbose, otherwise)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from cm3d_tpu_torch.utils.observability import MaskCounters

    if counters is None:
        counters = MaskCounters()
    store = MaskArtifactStore(out_dir)
    todo = store.remaining_scenes(scenes) if resume else list(scenes)
    t0 = time.time()
    n_frames = 0

    frames_per = {scene: frames_per_scene(scene) for scene in todo}
    work = [(scene, f) for scene in todo for f in range(frames_per[scene])
            if not (resume and store.has_frame(scene, f))]
    remaining = {scene: 0 for scene in todo}
    for scene, _ in work:
        remaining[scene] += 1

    def _maybe_complete(scene):
        if remaining[scene] == 0:
            store.mark_scene_complete(scene, frames_per[scene])
            if verbose:
                print(f"{scene}: {frames_per[scene]} frames done")

    for scene in todo:  # scenes fully present but never marked (mid-run kill)
        _maybe_complete(scene)

    # three-way overlap: a 2-deep image-IO prefetch thread, the device on
    # frame N, and a finisher thread writing frame N-1's artifacts
    pending = None  # (scene, f, handle)

    def _finish(entry):
        nonlocal n_frames
        scene, f, handle = entry
        write_frame_artifacts(store, scene, f, handle)
        counters.update(handle["counts"])
        remaining[scene] -= 1
        _maybe_complete(scene)
        n_frames += 1

    with ThreadPoolExecutor(max_workers=1) as io_pool, \
            ThreadPoolExecutor(max_workers=1) as finish_pool:
        futs = deque()
        idx = 0
        finish_fut = None

        def _fetch_and_prepare(sf):
            # canvas assembly + the u8 upload on the IO thread: the upload is
            # queued a frame early and rides under the device work
            return models.prepare(image_provider(*sf))

        def _prefetch():
            nonlocal idx
            while idx < len(work) and len(futs) < 2:
                sf = work[idx]
                futs.append((sf, io_pool.submit(_fetch_and_prepare, sf)))
                idx += 1

        _prefetch()
        while futs:
            (scene, f), fut = futs.popleft()
            prepared = fut.result()
            _prefetch()
            handle = start_frame_masks(models, None, cfg, prepared=prepared)
            if pending is not None:
                if finish_fut is not None:
                    finish_fut.result()
                finish_fut = finish_pool.submit(_finish, pending)
            pending = (scene, f, handle)
        if finish_fut is not None:
            finish_fut.result()
        if pending is not None:
            _finish(pending)

    if verbose and n_frames:
        dt = time.time() - t0
        print(f"Took {dt:.1f} seconds for {n_frames} frames "
              f"({n_frames / dt:.2f} frames/sec).")
        print(counters.report())


# ---------------------------------------------------------------------------
# Model construction
# ---------------------------------------------------------------------------

def _batched_model_fns(detic_model, classifier, sam_model, vocabulary, device=None,
                       encode_chunk: int = 1) -> MaskModels:
    """Batched callables around the port's Detic + SAM modules, shared by
    every model-building function so the pipeline runs the same code at
    every size.

    encode_chunk: cameras per SAM-encode step (the JAX package's single-chip
    encode batching; 1 caps the encoder's working set at one camera —
    ViT-H's global blocks hold [16, 4096, 4096] f32 scores, 1 GB, per
    camera)."""
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.models.common import cast_compute_weights_
    from cm3d_tpu_torch.models.detic import DETIC_PIXEL_MEAN, DETIC_PIXEL_STD
    from cm3d_tpu_torch.models.sam import SAM_PIXEL_MEAN, SAM_PIXEL_STD, preprocess_image
    from cm3d_tpu_torch.ops.maskpack import make_plane_postprocess
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32

    device = resolve_device(device)
    detic_model = cast_compute_weights_(detic_model.to(device).eval().requires_grad_(False))
    sam_model = cast_compute_weights_(sam_model.to(device).eval().requires_grad_(False))
    if device.type == "cuda" and "float32" in (detic_model.cfg.dtype, sam_model.cfg.dtype):
        strict_f32()
    classifier = torch.as_tensor(np.asarray(classifier, np.float32), device=device)
    img_size = sam_model.cfg.img_size
    chunk = max(1, int(encode_chunk))

    def prepare(images):
        """One uint8 canvas upload for the whole camera ring."""
        hs = [im.shape[0] for im in images]
        ws = [im.shape[1] for im in images]
        hmax, wmax = max(hs), max(ws)
        if len(images) % chunk:
            raise ValueError(f"ring size {len(images)} must divide over the encode "
                             f"chunk ({chunk})")
        canvas = np.zeros((len(images), hmax, wmax, 3), np.uint8)
        for i, im in enumerate(images):
            canvas[i, :hs[i], :ws[i]] = im
        hw = np.stack([hs, ws], axis=1).astype(np.int64)
        # fast SAM path: the provider already thumbnailed the longest side
        # to the SAM input size, so its resize is the identity
        scale1 = (all(max(h, w) == img_size for h, w in zip(hs, ws))
                  and hmax <= img_size and wmax <= img_size)
        return {"dev": to_device(canvas, device), "hw": to_device(hw, device),
                "images": images, "scale1": scale1}

    detic_stats = tuple(torch.as_tensor(a, device=device)
                        for a in (DETIC_PIXEL_MEAN, DETIC_PIXEL_STD))
    sam_stats = tuple(torch.as_tensor(a, device=device) for a in (SAM_PIXEL_MEAN, SAM_PIXEL_STD))

    def _norm_and_mask(x_u8, hw, stats):
        """u8 [B, H, W, 3] -> f32 normalized with the padding restored to
        exact 0 (both reference preprocessors pad AFTER normalization)."""
        h, w = x_u8.shape[1], x_u8.shape[2]
        x = (x_u8.float() - stats[0]) / stats[1]
        row = torch.arange(h, device=device)[None, :] < hw[:, 0:1]
        col = torch.arange(w, device=device)[None, :] < hw[:, 1:2]
        return x * (row[:, :, None] & col[:, None, :])[..., None].float()

    @torch.inference_mode()
    def detic(frame):
        x_u8, hw = frame["dev"], frame["hw"]
        h, w = x_u8.shape[1], x_u8.shape[2]
        x = _norm_and_mask(x_u8, hw, detic_stats)
        x = torch.nn.functional.pad(x, (0, 0, 0, -(-w // 32) * 32 - w, 0, -(-h // 32) * 32 - h))
        det = detic_model(x, classifier, hw)
        return det.boxes, det.scores, det.classes, det.valid

    # quant_static: the static encoder's act_scale buffers depend on the
    # deploy data, so the FIRST ring calibrates: one encode of its cameras
    # through the dynamic product records each layer's input absmax (the max
    # over the cameras), bake_act_scales writes the buffers, and every later
    # ring runs the static path (the scales are the max over the whole
    # ring); a camera-parallel rank sets "reduce" to take the max over the
    # whole ring's ranks before the bake
    calibration = {"pending": bool(sam_model.cfg.quant_static), "seconds": None,
                   "reduce": None}

    def _calibrate_first_ring(xs):
        from cm3d_tpu_torch.models.common import calibrate_act_scales_

        t0 = time.perf_counter()
        calibrate_act_scales_(sam_model, lambda: [sam_model.encode_image(xs[i:i + 1])
                                                  for i in range(xs.shape[0])],
                              reduce=calibration["reduce"])
        calibration.update(pending=False, seconds=time.perf_counter() - t0,
                           act_scales={k: v.clone() for k, v in sam_model.state_dict().items()
                                       if k.endswith(".act_scale")})

    def resized(frame):
        """The ring resized to the SAM input square on the host (PIL
        bilinear), or the frame's "xs" where the caller made them."""
        if "xs" in frame:
            return frame["xs"]
        return to_device(np.stack([preprocess_image(im, img_size) for im in frame["images"]]),
                         device)

    @torch.inference_mode()
    def sam_encode(frame):
        if calibration["pending"]:
            _calibrate_first_ring(resized(frame))
        if frame["scale1"]:
            xs = _norm_and_mask(frame["dev"], frame["hw"], sam_stats)
            h, w = xs.shape[1], xs.shape[2]
            if not sam_model.cfg.rect_encode:
                # SamPredictor semantics: encode the zero-padded square
                xs = torch.nn.functional.pad(xs, (0, 0, 0, img_size - w, 0, img_size - h))
        else:
            xs = resized(frame)
        return torch.cat([sam_model.encode_image(xs[i:i + chunk])
                          for i in range(0, xs.shape[0], chunk)])

    @functools.lru_cache(maxsize=8)
    def _postprocess(cam_hw, mask_wh, nw, rect, layout):
        return make_plane_postprocess(mask_wh, cam_hw, nw, rect=rect, layout=layout)

    @torch.inference_mode()
    def sam_decode_planes(emb, boxes, n_boxes, cam_hw, mask_wh, nw, layout="xy", offset=0):
        """`offset`: the bit of the first camera's first mask (a camera-
        parallel rank's block of the ring)."""
        # image px -> SAM-input px resize factor per camera
        scales = np.array([img_size / max(h, w) for h, w in cam_hw], np.float32)
        sb = to_device(np.asarray(boxes, np.float32) * scales[:, None, None], device)
        # one camera at a time: caps the decoder + upscale intermediates
        logits = torch.stack([sam_model.decode_boxes(emb[c], sb[c])[0]
                              for c in range(emb.shape[0])])
        hw_grid = sam_model.cfg.embed_hw
        rect = tuple(emb.shape[1:3]) != (hw_grid, hw_grid)
        post = _postprocess(tuple(map(tuple, cam_hw)), tuple(mask_wh), int(nw), rect, layout)
        return post(logits, [int(n) for n in n_boxes], offset=int(offset))

    sam_encode.calibration = calibration  # the first ring's calibration seconds
    sam_encode.resized = resized
    return MaskModels(prepare, detic, sam_encode, sam_decode_planes, tuple(vocabulary))


class RingEmbedding(NamedTuple):
    """The camera-parallel SAM encode's handle: each rank keeps its block
    of the ring's embeddings under `key`; `local` is rank 0's block."""

    key: int
    local: torch.Tensor


class _CameraRank:
    """One rank of the camera-parallel mask stage: a contiguous block of
    the ring's cameras through its own copy of the models (`local`, the
    single-device MaskModels on this rank's device)."""

    KEEP = 2  # encodes whose embeddings a rank keeps for their decode

    def __init__(self, local: MaskModels, device):
        self.local, self.device = local, torch.device(device)
        self.embs: dict = {}
        calibration = getattr(local.sam_encode, "calibration", None)
        if calibration is not None:
            # quant_static: the first ring's absmax is the max over every rank's cameras
            calibration["reduce"] = _max_over_data

    def _block(self, *tensors):
        from cm3d_tpu_torch.parallel.mesh import axis_group

        ax = axis_group("data")
        c = tensors[0].shape[0] // ax.size
        return [None if t is None else t[ax.index * c:(ax.index + 1) * c] for t in tensors]

    def __call__(self, op: str, *args):
        return getattr(self, op)(*args)

    def detic(self, canvas, hw):
        from cm3d_tpu_torch.parallel.mesh import gather_to_first

        canvas, hw = self._block(canvas, hw)
        parts = gather_to_first(list(self.local.detic({"dev": canvas, "hw": hw})), "data")
        return None if parts is None else tuple(torch.cat(p) for p in zip(*parts))

    def encode(self, key: int, canvas, hw, scale1: bool, xs):
        canvas, hw, xs = self._block(canvas, hw, xs)
        frame = {"dev": canvas, "hw": hw, "scale1": scale1}
        if xs is not None:
            frame["xs"] = xs
        self.embs[key] = self.local.sam_encode(frame)
        for old in [k for k in self.embs if k <= key - self.KEEP]:
            del self.embs[old]
        return RingEmbedding(key, self.embs[key])

    def decode(self, key: int, boxes, n_boxes, offsets, cam_hw, mask_wh, nw: int, layout: str):
        from cm3d_tpu_torch.parallel.mesh import gather_to_first

        boxes, n_boxes, offsets, cam_hw = (t.cpu() for t in self._block(boxes, n_boxes,
                                                                          offsets, cam_hw))
        planes = self.local.sam_decode_planes(
            self.embs[key], boxes.numpy(), n_boxes.tolist(),
            [tuple(r) for r in cam_hw.tolist()], mask_wh, nw, layout, offset=int(offsets[0]))
        parts = gather_to_first([planes], "data")
        if parts is None:
            return None
        out = parts[0][0].clone()
        for (p,) in parts[1:]:
            out |= p  # each rank's masks hold distinct bits
        return out


def _max_over_data(record: dict) -> None:
    """A calibration record's absmax, each the max over the data axis."""
    import torch.distributed as dist

    from cm3d_tpu_torch.parallel.mesh import axis_group

    ax = axis_group("data")
    for v in record.values():
        dist.all_reduce(v, op=dist.ReduceOp.MAX, group=ax.group)


def _camera_rank(builder: str, kwargs: dict, device) -> _CameraRank:
    import torch.distributed as dist

    from cm3d_tpu_torch.parallel.mesh import _resolve

    if "verbose" in kwargs:  # one load report, rank 0's
        kwargs = {**kwargs, "verbose": kwargs["verbose"] and dist.get_rank() == 0}
    return _CameraRank(_resolve(builder)(**kwargs, device=device), device)


def camera_parallel_models(mesh, builder: str, **kwargs) -> MaskModels:
    """The camera-parallel 2D stage over a started mesh group (`mesh`, a
    `parallel.mesh.DataParallelGroup` whose Mesh is (data,) or (data, 1)):
    the JAX package's `_batched_model_fns(mesh=)`. Every rank builds the
    same models with `builder(**kwargs, device=its device)` ("module:
    function", a single-device MaskModels builder: the same seed for
    random weights, the same files for released ones).

    The ring's cameras split over the data axis in contiguous blocks; Detic
    and the SAM encoder run on the rank that holds the camera, and the
    embeddings stay there; each rank decodes its cameras with the boxes of
    rank 0's host NMS and packs their masks at their bits of the ring; the
    detections and the planes come back to rank 0 in camera order. A ring
    that the axis does not divide raises naming the ring size. The encode
    runs one camera at a time (`encode_chunk` does not apply under a
    mesh). With quant_static the first ring's activation absmax is the max
    over every rank's cameras, so every rank bakes the single-device
    scales. Only the main thread may call detic / sam_encode /
    sam_decode_planes (they drive the group); prepare is local."""
    from cm3d_tpu_torch.parallel.mesh import Program

    shape = mesh.mesh.shape
    if "data" not in shape or any(n != 1 for a, n in shape.items() if a != "data"):
        raise ValueError(f"the camera-parallel mask stage runs on a (data,) mesh, not {shape}")
    n = shape["data"]
    inst = _camera_rank(builder, kwargs, mesh.device)
    call = mesh.spmd(Program(f"{__name__}:_camera_rank", (builder, kwargs)), local=inst)
    local, keys = inst.local, itertools.count()
    calibration = getattr(local.sam_encode, "calibration", {})

    def prepare(images):
        if len(images) % n:
            raise ValueError(f"camera-parallel mask stage: ring size {len(images)} must "
                             f"divide over the mesh data axis ({n})")
        return local.prepare(images)

    def detic(frame):
        return call("detic", frame["dev"], frame["hw"])

    def sam_encode(frame):
        # the host resize of every camera, where a rank's encode or its
        # calibration reads it
        xs = (local.sam_encode.resized(frame)
              if not frame["scale1"] or calibration.get("pending") else None)
        return call("encode", next(keys), frame["dev"], frame["hw"], frame["scale1"], xs)

    def sam_decode_planes(emb, boxes, n_boxes, cam_hw, mask_wh, nw, layout="xy"):
        n_boxes = np.asarray(n_boxes, np.int64)
        offsets = np.concatenate([[0], np.cumsum(n_boxes)[:-1]]).astype(np.int64)
        return call("decode", emb.key, torch.as_tensor(np.asarray(boxes, np.float32)),
                    torch.as_tensor(n_boxes), torch.as_tensor(offsets),
                    torch.as_tensor(np.asarray(cam_hw, np.int64)), tuple(mask_wh), int(nw),
                    layout)

    sam_encode.calibration = calibration
    return MaskModels(prepare, detic, sam_encode, sam_decode_planes, local.vocabulary)


def quantized_models(detic, sam, quant_int8: bool, quant_static: bool = False):
    """The int8 twins of float Detic and SAM modules (`quant_int8`): the
    same weights through `quantize_detic_state_dict` /
    `quantize_sam_state_dict`, loaded into modules built with the int8
    configs on the same device. Without `quant_int8`, the modules as they
    are."""
    from cm3d_tpu_torch.models.detic import Detic, quantize_detic_state_dict
    from cm3d_tpu_torch.models.sam import Sam, quantize_sam_state_dict
    from cm3d_tpu_torch.ops.quant import with_act_scale_placeholders

    if not quant_int8:
        return detic, sam
    dev = next(sam.parameters()).device
    with torch.device(dev):
        qdetic = Detic(dataclasses.replace(
            detic.cfg, swin=dataclasses.replace(detic.cfg.swin, quant_int8=True)))
        qsam = Sam(dataclasses.replace(sam.cfg, quant_int8=True, quant_static=quant_static))
    qdetic.load_state_dict(quantize_detic_state_dict(detic.state_dict()))
    qsd = quantize_sam_state_dict(sam.state_dict())
    # quant_static: placeholders, the first ring calibrates them
    qsam.load_state_dict(with_act_scale_placeholders(qsd) if quant_static else qsd)
    return qdetic, qsam


def build_fake_models(seed: int = 0, vocabulary=CUSTOM_VOCABULARY_NUSCENES,
                      rect_encode: bool = False, encode_chunk: int = 1,
                      device=None, fused_window_attn: bool = False,
                      quant_int8: bool = False, quant_static: bool = False,
                      mesh=None) -> MaskModels:
    """Tiny random-weight models (DETIC_TEST, SAM_TEST; weights drawn on the
    CPU from a torch.Generator seeded with `seed`, so every device gets the
    same models) behind the same batched wrappers as the full-size ones.
    `fused_window_attn` runs SAM's windowed blocks through the fused
    kernels (same weights); `quant_int8` / `quant_static` run the int8
    twins of the same weights (`quantized_models`). `mesh`: a started
    group, the camera-parallel stage (`camera_parallel_models`; its ranks
    on their own devices, `device` unused)."""
    if mesh is not None:
        return camera_parallel_models(
            mesh, f"{__name__}:build_fake_models", seed=seed, vocabulary=tuple(vocabulary),
            rect_encode=rect_encode, fused_window_attn=fused_window_attn,
            quant_int8=quant_int8, quant_static=quant_static)
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
    from cm3d_tpu_torch.models.sam import SAM_TEST, Sam

    rng = np.random.default_rng(seed)
    clf = rng.standard_normal((DETIC_TEST.embed_dim, len(vocabulary))).astype(np.float32)
    clf /= np.linalg.norm(clf, axis=0, keepdims=True)
    gen = torch.Generator()
    detic = init_weights(Detic(DETIC_TEST), gen.manual_seed(seed))
    sam = init_weights(Sam(dataclasses.replace(SAM_TEST, rect_encode=rect_encode,
                                               fused_window_attn=fused_window_attn)),
                       gen.manual_seed(seed + 1))
    detic, sam = quantized_models(detic, sam, quant_int8, quant_static)
    return _batched_model_fns(detic, clf, sam, vocabulary, device=device,
                              encode_chunk=encode_chunk)


def build_real_models(detic_ckpt: str, sam_ckpt: str, clip_ckpt: str, bpe_path: str,
                      vocabulary=CUSTOM_VOCABULARY_NUSCENES, dtype: str = "bfloat16",
                      rect_encode: bool = False, encode_chunk: int = 1,
                      sam_size: str = "vit_h", quant_int8: bool = False,
                      quant_static: bool = False, detic_used: bool = True,
                      device=None, verbose: bool = True, mesh=None) -> MaskModels:
    """Full-size Detic Swin-B and SAM (`sam_size`) from the released
    checkpoints, the classifier from CLIP's text encoder over `vocabulary`,
    behind the same batched wrappers as `build_fake_models`.

    Each checkpoint is a released torch file (converted on the fly,
    `models/convert.py`) or a directory of an already-converted state dict
    (`models/checkpoints.py load_released_checkpoint`). The modules are
    built on `device` (CUDA unless told otherwise) and loaded strictly:
    a missing key or a shape mismatch raises, keys nothing reads are
    reported. The vocabulary is embedded once, in f32 with TF32 off.
    sam_size picks the SAM encoder scale (vit_h = the reference's
    sam_vit_h_4b8939.pth; vit_l / vit_b are the released smaller
    checkpoints, a documented speed/quality deviation). detic_used=False
    (`--detector gdino`, `attach_gdino` swaps the detector next) loads the
    Detic file in whichever form it is, float or int8. `mesh`: a started
    group, the camera-parallel stage (`camera_parallel_models`: every rank
    loads the same files on its own device)."""
    if mesh is not None:
        return camera_parallel_models(
            mesh, f"{__name__}:build_real_models", detic_ckpt=detic_ckpt, sam_ckpt=sam_ckpt,
            clip_ckpt=clip_ckpt, bpe_path=bpe_path, vocabulary=tuple(vocabulary), dtype=dtype,
            rect_encode=rect_encode, sam_size=sam_size, quant_int8=quant_int8,
            quant_static=quant_static, detic_used=detic_used, verbose=verbose)
    from cm3d_tpu_torch.models.checkpoints import load_released_checkpoint
    from cm3d_tpu_torch.models.clip_text import (
        CLIP_TEXT_B32, ClipTextEncoder, SimpleTokenizer, embed_vocabulary)
    from cm3d_tpu_torch.models.convert import (
        clip_state_dict_from_released, detic_state_dict_from_released,
        load_released_state_dict, load_torch_state_dict)
    from cm3d_tpu_torch.models.detic import DETIC_SWINB, Detic, quantize_detic_state_dict
    from cm3d_tpu_torch.models.sam import Sam, quantize_sam_state_dict, sam_config_for
    from cm3d_tpu_torch.ops.quant import (
        is_quantized_state_dict, reconcile_quantization, with_act_scale_placeholders)
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32_scope

    if quant_static and not quant_int8:
        raise ValueError("quant_static requires quant_int8")
    device = resolve_device(device)
    detic_cfg = dataclasses.replace(
        DETIC_SWINB, dtype=dtype, swin=dataclasses.replace(DETIC_SWINB.swin, dtype=dtype))
    detic_quant = [quant_int8]

    def detic_sd(sd):
        if not detic_used:
            # --detector gdino: attach_gdino replaces this Detic before any
            # frame runs, so it is not quantized, and a checkpoint of either
            # form loads (an int8-only deployment directory stays usable),
            # as in JAX
            detic_quant[0] = is_quantized_state_dict(sd)
        return reconcile_quantization(sd, quantize_detic_state_dict, detic_quant[0], "Detic")

    def make_detic():
        return Detic(dataclasses.replace(detic_cfg, swin=dataclasses.replace(
            detic_cfg.swin, quant_int8=detic_quant[0])))

    sam_cfg = dataclasses.replace(sam_config_for(sam_size), dtype=dtype,
                                  rect_encode=rect_encode, quant_int8=quant_int8,
                                  quant_static=quant_static)
    # a quantized checkpoint (conform --quant_int8's *_int8 directories)
    # passes through, a float one is quantized at load, and a quantized one
    # without --quant_int8 raises
    quant = {
        "Detic": detic_sd,
        "SAM": lambda sd: reconcile_quantization(sd, quantize_sam_state_dict, quant_int8, "SAM"),
        "CLIP": lambda sd: sd,
    }
    loads = (
        ("Detic", detic_ckpt, make_detic,
         lambda p: detic_state_dict_from_released(load_torch_state_dict(p), detic_cfg)),
        ("SAM", sam_ckpt, lambda: Sam(sam_cfg), load_torch_state_dict),
        ("CLIP", clip_ckpt, lambda: ClipTextEncoder(CLIP_TEXT_B32),
         lambda p: clip_state_dict_from_released(load_torch_state_dict(p))),
    )
    modules = []
    for name, path, make, convert in loads:
        sd = quant[name](load_released_checkpoint(path, convert))
        if name == "SAM" and quant_static:  # the first ring calibrates these
            sd = with_act_scale_placeholders(sd)
        with torch.device(device):
            module = make()
        load_released_state_dict(module, sd, f"{name} {path}", verbose=verbose)
        modules.append(module)
        del sd
    detic, sam, clip = modules
    with strict_f32_scope():
        classifier = embed_vocabulary(clip, SimpleTokenizer.from_file(bpe_path),
                                      list(vocabulary))
    return _batched_model_fns(detic, classifier, sam, vocabulary, device=device,
                              encode_chunk=encode_chunk)


def build_models(p, args, vocabulary, device, mesh=None) -> MaskModels:
    """The MaskModels the CLI flags (`cli_flags.add_model_flags`) ask for:
    the tiny random-weight models with `--fake_weights`, else the released
    checkpoints (all four paths, or argparse's error through `p`, as in
    JAX); camera-parallel over `mesh` (`--camera_mesh`'s started group)."""
    if args.fake_weights:
        return build_fake_models(vocabulary=vocabulary, rect_encode=args.rect_encode,
                                 encode_chunk=args.encode_chunk, device=device,
                                 quant_int8=args.quant_int8, quant_static=args.quant_static,
                                 mesh=mesh)
    missing = [f"--{f}" for f in ("detic_ckpt", "sam_ckpt", "clip_ckpt", "bpe_path")
               if not getattr(args, f)]
    if missing:
        p.error(f"pass --fake_weights, or all of --detic_ckpt --sam_ckpt --clip_ckpt "
                f"--bpe_path (missing: {' '.join(missing)})")
    return build_real_models(args.detic_ckpt, args.sam_ckpt, args.clip_ckpt, args.bpe_path,
                             vocabulary=vocabulary, rect_encode=args.rect_encode,
                             encode_chunk=args.encode_chunk, sam_size=args.sam_size,
                             quant_int8=args.quant_int8, quant_static=args.quant_static,
                             detic_used=args.detector == "detic", device=device, mesh=mesh)


def attach_models(models: MaskModels, args, device) -> MaskModels:
    """The alternates the CLI flags ask for, on `models`: ZoeDepth
    (`--use_zoedepth`, masks CLI only) and GroundingDINO (`--detector
    gdino`), each random and tiny with `--fake_weights`."""
    if getattr(args, "use_zoedepth", False):
        models = attach_zoedepth(models, args.zoe_ckpt, test=args.fake_weights, device=device)
    if args.detector == "gdino":
        models = attach_gdino(models, args.gdino_ckpt, args.gdino_vocab,
                              test=args.fake_weights, quant_int8=args.quant_int8,
                              dtype="bfloat16" if args.gdino_bf16 else "float32",
                              device=device)
    return models


def attach_zoedepth(models: MaskModels, ckpt_path: str = "", test: bool = False,
                    flip_aug: bool = True, seed: int = 0, device=None,
                    state_dict=None) -> MaskModels:
    """Set a ZoeDepth `predict_depth` on `models` (the reference's
    commented-out `torch.hub.load("isl-org/ZoeDepth", ...)`,
    gen_2d_masks_detic.py:117). test=True builds the tiny ZOE_TEST with
    random weights (`init_weights`, drawn on the CPU from a torch.Generator
    seeded with `seed`, so every device gets the same model), else ZOE_N
    from `ckpt_path`: the released ZoeD_N file or a directory saved with
    `save_params`. `state_dict` gives the weights instead (tests, the
    card's smoke run). f32 with TF32 off on the card, as the JAX default."""
    from cm3d_tpu_torch.models.checkpoints import load_released_checkpoint
    from cm3d_tpu_torch.models.common import init_weights
    from cm3d_tpu_torch.models.convert import load_released_state_dict, load_torch_state_dict
    from cm3d_tpu_torch.models.zoedepth import (
        ZOE_N, ZOE_TEST, ZoeDepth, make_predict_depth, zoedepth_state_dict_from_released)
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32

    device = resolve_device(device)
    cfg = ZOE_TEST if test else ZOE_N
    if state_dict is None and test:
        model = init_weights(ZoeDepth(cfg), torch.Generator().manual_seed(seed)).to(device)
    else:
        with torch.device(device):
            model = ZoeDepth(cfg)
        if state_dict is None:
            state_dict = load_released_checkpoint(
                ckpt_path,
                lambda p: zoedepth_state_dict_from_released(load_torch_state_dict(p), cfg))
        load_released_state_dict(model, state_dict, f"ZoeDepth {ckpt_path}", verbose=False)
    if device.type == "cuda":
        strict_f32()
    return dataclasses.replace(
        models, predict_depth=make_predict_depth(model.eval().requires_grad_(False), flip_aug))


def attach_gdino(models: MaskModels, ckpt_path: str = "", vocab_path: str = "",
                 test: bool = False, box_threshold: float = 0.15, seed: int = 0,
                 quant_int8: bool = False, fake_scale: str = "test", dtype: str = "float32",
                 device=None, state_dict=None) -> MaskModels:
    """Swap the detector for GroundingDINO (the reference's commented-out
    alternative, kitti/gen_2d_masks_detic.py:115-117,633,697-704): boxes
    come from grounding the class-list caption, then flow into the same SAM
    prompt path.

    test=True builds a random-weight model over a synthetic WordPiece
    vocabulary of the class words; `fake_scale` picks its size, "test" (the
    tiny GDINO_TEST) or "swint" (GDINO_SWINT's widths); the weights come
    from `init_gdino_weights` (drawn on the CPU from a torch.Generator
    seeded with `seed`, so every device gets the same model) unless
    `state_dict` gives them. Otherwise GDINO_SWINT from `ckpt_path` (the
    released groundingdino_swint_ogc.pth or a directory saved with
    `save_params`) and bert-base-uncased's `vocab_path`.

    quant_int8: the Swin backbone's MLPs int8 w8a8 (BERT, the enhancer and
    the decoder stay float), as Detic's boundary; a float checkpoint is
    quantized at load, an int8 one passes, an int8 one without the flag
    raises. dtype "float32" (TF32 off on the card) or "bfloat16"
    (`--gdino_bf16`); the Swin attention runs the fused kernels in both
    (the JAX package's unfused bf16 Swin is a TPU compile workaround)."""
    from cm3d_tpu_torch.models.checkpoints import load_released_checkpoint
    from cm3d_tpu_torch.models.common import cast_compute_weights_
    from cm3d_tpu_torch.models.convert import load_released_state_dict, load_torch_state_dict
    from cm3d_tpu_torch.models.gdino import (
        GDINO_SWINT, GDINO_TEST, BertConfig, GroundingDino, WordPieceTokenizer, gdino_config,
        gdino_state_dict_from_released, init_gdino_weights, make_gdino_detector,
        quantize_gdino_state_dict)
    from cm3d_tpu_torch.ops.quant import reconcile_quantization
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32

    device = resolve_device(device)
    vocabulary = models.vocabulary
    if test:
        if fake_scale not in ("test", "swint"):
            raise ValueError(f"fake_scale must be test|swint: {fake_scale}")
        words = sorted({w for cls in vocabulary for w in cls.lower().split()})
        vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, ".": 4}
        for w in words:
            vocab[w] = len(vocab)
        cfg = gdino_config(GDINO_TEST if fake_scale == "test" else GDINO_SWINT, dtype,
                           quant_int8, vocab_size=max(64, len(vocab) + 8), pad_id=0,
                           unk_id=1, cls_id=2, sep_id=3)
        tok = WordPieceTokenizer(vocab, cfg.bert)
        if state_dict is None:
            float_cfg = dataclasses.replace(cfg, swin=dataclasses.replace(cfg.swin,
                                                                          quant_int8=False))
            state_dict = init_gdino_weights(GroundingDino(float_cfg),
                                            torch.Generator().manual_seed(seed)).state_dict()
    else:
        cfg = gdino_config(GDINO_SWINT, dtype, quant_int8)
        tok = WordPieceTokenizer.from_file(vocab_path, BertConfig())
        if state_dict is None:
            state_dict = load_released_checkpoint(
                ckpt_path,
                lambda p: gdino_state_dict_from_released(load_torch_state_dict(p), cfg))
    state_dict = reconcile_quantization(state_dict, quantize_gdino_state_dict, quant_int8,
                                        "GroundingDINO")
    with torch.device(device):
        model = GroundingDino(cfg)
    load_released_state_dict(model, state_dict, f"GroundingDINO {ckpt_path}", verbose=False)
    if device.type == "cuda" and dtype == "float32":
        strict_f32()
    model = cast_compute_weights_(model.eval().requires_grad_(False))
    detect = make_gdino_detector(model, tok, vocabulary, box_threshold=box_threshold)
    return dataclasses.replace(models, detic=detect)


def _nuscenes_provider(args):
    from PIL import Image

    from cm3d_tpu_torch.datasets.nuscenes.tables import CAM_LIST, NuScenesTables

    nusc = NuScenesTables(args.dataroot, args.version)
    scene_names = (args.scenes.split(",") if args.scenes
                   else [s["name"] for s in nusc.table("scene")])
    samples = {n: list(nusc.iter_samples(nusc.scene_by_name(n))) for n in scene_names}

    def provider(scene, frame):
        images = []
        for cam in CAM_LIST:
            sd = nusc.get("sample_data", samples[scene][frame]["data"][cam])
            im = Image.open(f"{args.dataroot}/{sd['filename']}").convert("RGB")
            im.thumbnail((args.thumbnail, args.thumbnail))
            images.append(np.asarray(im))
        return images

    return provider, scene_names, lambda s: len(samples[s])


def _kitti_provider(args):
    """Single-camera image_2 variant (reference kitti/gen_2d_masks_detic.py;
    note its run_nms=False "wo_2d_nms" default). `--scenes` holds frame
    indices; every frame goes to the one scene "kitti"."""
    from PIL import Image

    from cm3d_tpu_torch.datasets.kitti.frontend import KittiDataset

    ds = KittiDataset(args.dataroot)
    if args.scenes:
        indices = [int(i) for i in args.scenes.split(",")]
    else:
        indices = list(range(ds.num_samples))

    def provider(scene, frame):
        im = Image.open(ds.get_image_path(indices[frame])).convert("RGB")
        im.thumbnail((args.thumbnail, args.thumbnail))
        return [np.asarray(im)]

    return provider, ["kitti"], lambda s: len(indices)


def _waymo_provider(args):
    """Per-camera JPEGs from frame-lite npz OR raw .tfrecord segments
    (reference waymo/gen_2d_masks_detic.py decodes them from the Frame
    proto; raw ingestion here is TF-free via datasets.waymo.frame_proto).
    The ring is mixed: front cameras 1920x1280, side cameras 1920x886."""
    from cm3d_tpu_torch.datasets.waymo.frontend import WaymoFrontend, ring_images

    fe = WaymoFrontend(args.dataroot, MaskArtifactStore(args.out_dir))
    scene_names = args.scenes.split(",") if args.scenes else fe.scene_names()

    def provider(scene, frame):
        return ring_images(fe.load_frame_by_index(scene, frame, want_pose=False),
                           args.thumbnail)

    return provider, scene_names, fe.num_frames


def main(argv=None):
    """CLI: the nuScenes / KITTI / Waymo 2D mask stage on the port (CUDA
    unless --device says otherwise)."""
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_WAYMO

    p = argparse.ArgumentParser(description="CM3D 2D mask generation stage (PyTorch port)")
    p.add_argument("--dataroot", required=True,
                   help="nuScenes root / KITTI root / waymo frame-lite root")
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--scenes", default="",
                   help="comma-separated scenes (KITTI: frame indices)")
    p.add_argument("--thumbnail", type=int, default=1024)  # reference :293
    p.add_argument("--run_nms", type=int, default=-1,
                   help="-1 = dataset default (nuscenes / waymo on, kitti off)")
    add_model_flags(p)
    add_quant_flags(p)
    p.add_argument("--use_zoedepth", action="store_true",
                   help="store per-mask masked metric depth instead of RLE masks "
                   "(reference gen_2d_masks_detic.py:408-451)")
    p.add_argument("--zoe_ckpt", default="",
                   help="ZoeD_N torch checkpoint (or a save_params directory) for "
                   "--use_zoedepth; with --fake_weights the tiny random ZoeDepth")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--rect_encode", action="store_true",
                   help="SAM encodes without square padding (small documented "
                   "deviation from SamPredictor)")
    p.add_argument("--encode_chunk", type=int, default=1,
                   help="cameras per SAM-encode step (must divide the ring size)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    add_run_flags(p)
    args = p.parse_args(argv)

    provider, scene_names, frames_fn = {
        "nuscenes": _nuscenes_provider,
        "kitti": _kitti_provider,
        "waymo": _waymo_provider,
    }[args.dataset](args)
    if args.host_shard:
        from cm3d_tpu_torch.parallel.multihost import shard_for_host

        scene_names = shard_for_host(scene_names)
    vocab = CUSTOM_VOCABULARY_WAYMO if args.dataset == "waymo" else CUSTOM_VOCABULARY_NUSCENES
    cfg = MaskStageConfig(run_nms=run_nms(args), thumbnail=args.thumbnail,
                          use_zoedepth=args.use_zoedepth)
    with camera_mesh(args) as mesh:
        models = attach_models(build_models(p, args, vocab, args.device, mesh), args,
                               args.device)
        run_mask_stage(models, provider, scene_names, frames_fn, args.out_dir, cfg,
                       resume=not args.no_resume)


if __name__ == "__main__":
    main()

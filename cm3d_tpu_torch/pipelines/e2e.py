"""Fused pseudo-label pipeline: images -> masks -> 3D boxes in ONE process.
Mirrors `cm3d_tpu/pipelines/e2e.py` for nuScenes, Waymo and KITTI.

The reference is two CLIs glued by an on-disk artifact store
(gen_2d_masks_detic.py writes {frame}_data.json + {frame}_masks.pkl,
2d_to_3d.py reads them back). That contract still exists here
(pipelines.masks + pipelines.lift), but because the mask stage's device
postprocess already emits the lift's bit-plane format (ops.maskpack), the
two stages also fuse directly: the SAM decode's [W, H, Mw] planes drop into
the Keyframe as the device tensor they are — no RLE encode, no copy to the
host and back. One process, one device, pseudo-labels out.

Optionally still writes the reference-layout artifacts (--mask_dir) so the
two-stage contract (resume, parity testing) is preserved.

Usage:
  python -m cm3d_tpu_torch.pipelines.e2e --dataroot D --version v1.0-mini \\
      --scenes scene-0061 --out preds.json --fake_weights [--device cpu]
  python -m cm3d_tpu_torch.pipelines.e2e --dataset waymo --dataroot F \\
      --scenes segment-... --out pred.bin --detic_ckpt D --sam_ckpt S \\
      --clip_ckpt C --bpe_path B
  python -m cm3d_tpu_torch.pipelines.e2e --dataset kitti --dataroot KITTI \\
      --scenes 0,1,2 --out preds_dir --fake_weights
  ... --detector gdino [--gdino_ckpt G --gdino_vocab V] [--gdino_bf16]
  ... --camera_mesh N   (the 2D stage camera-parallel over N ranks; the
                         lift runs on rank 0)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from cm3d_tpu_torch.config import LiftStageConfig, MaskStageConfig
from cm3d_tpu_torch.datasets.types import map_fields, stack_keyframes, to_device
from cm3d_tpu_torch.parallel import make_keyframe_step_fn
from cm3d_tpu_torch.pipelines.cli_flags import (
    add_model_flags, add_quant_flags, add_run_flags, camera_mesh, run_nms)
from cm3d_tpu_torch.pipelines.masks import (
    MaskModels, attach_models, build_models, start_frame_masks, write_frame_artifacts)
from cm3d_tpu_torch.utils.device import resolve_device
from cm3d_tpu_torch.utils.fetch import TreeFetch
from cm3d_tpu_torch.utils.observability import MaskCounters, span


def _scale_ratio_for_thumbnail(lift_cfg: LiftStageConfig, thumbnail: int) -> LiftStageConfig:
    """The reference's intrinsics ratios are calibrated for 1024-wide
    thumbnails (0.64 = 1024/1600 nuScenes, 0.8366 about 1024/1224 KITTI).
    The fused mask canvas tracks the actual thumbnail size, so any other
    --thumbnail must rescale the ratio with it or projected points land off
    the masks (silent misprojection)."""
    if thumbnail == 1024:
        return lift_cfg
    return dataclasses.replace(
        lift_cfg, image_ratio=lift_cfg.image_ratio * (thumbnail / 1024.0)
    )


def run_fused(
    models: MaskModels,
    step,
    frames,
    mask_cfg: MaskStageConfig,
    on_boxes,
    batch_size: int = 4,
    counters=None,
    mask_wh: Optional[tuple] = None,
    device=None,
) -> int:
    """The fused images->masks->boxes core loop (shared by the nuScenes CLI
    path below and cm3d_tpu_torch.benchmarks.bench_e2e, so the benchmark
    measures the real code path).

    Three-way overlap, mirroring run_mask_stage: a 2-deep IO thread pulls
    the frame source and runs prepare() (canvas assembly + the u8 upload
    rides under the previous frame's device work), the main thread keeps the
    device queue fed (start_frame_masks per frame, lift step per batch), and
    a finisher thread hands each batch's boxes to on_boxes. The lift step is
    queued on the stream the decode ran on, so their order is implicit; the
    boxes' one copy back is queued right behind the step and the finisher
    waits on the event recorded after it, never on the device as a whole:
    the next frames' dispatch goes on meanwhile.

    frames: iterable of (images, assemble) where assemble(handle) returns
        (Keyframe, token) — or None to skip the frame. handle is the
        start_frame_masks result (its "planes" a device tensor); assemble is
        called for EVERY frame, in source order, on the main thread —
        including frames whose "planes" is None (zero detections) — so
        artifact writes and scene-completion bookkeeping can live inside it
        without racing the IO prefetch. The iterable is consumed from the IO
        thread (it is the sole consumer, so a generator is fine).
    on_boxes(token, boxes_slice): consume one keyframe's lift outputs (numpy
        tree, already sliced to this frame). Called from the finisher
        thread, one batch at a time, in order.
    mask_wh: fixed bit-plane canvas (w, h); None derives it from each
        frame's images, which is fine when the camera set is fixed.
    device: where the step runs (CUDA unless told otherwise); the models
        must have been built on it.
    Returns the number of keyframes that went through the lift step.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    device = resolve_device(device)
    if counters is None:  # count regardless; callers pass one to report it
        counters = MaskCounters()
    pending: list = []
    n_frames = 0
    it = iter(frames)

    def _deliver(entries, fetch):
        boxes_np = fetch.get()  # waits for this batch's copy only
        for i, (_, token) in enumerate(entries):
            on_boxes(token, map_fields(lambda x, i=i: x[i], boxes_np))

    def _pull():
        # runs on the single IO worker — the only consumer of `it`
        try:
            images, assemble = next(it)
        except StopIteration:
            return None
        return models.prepare(images), assemble

    with ThreadPoolExecutor(max_workers=1) as io_pool, \
            ThreadPoolExecutor(max_workers=1) as finish_pool:
        deliver_fut = None

        def flush():
            nonlocal pending, deliver_fut, n_frames
            if not pending:
                return
            entries, pending = pending, []
            with span("cm3d.e2e.flush"):
                kfs = [kf for kf, _ in entries]
                kfs += [kfs[-1]] * (batch_size - len(entries))  # pad the tail batch
                # planes stack on the device; the host leaves go up in one
                # pinned, non-blocking pass
                batch = to_device(stack_keyframes(kfs).frames, device)
                _, boxes = step(batch)
                fetch = TreeFetch(boxes)  # one copy back, queued behind the step
                n_frames += len(entries)
                # at most one delivery outstanding: ordering + bounded memory
                if deliver_fut is not None:
                    with span("cm3d.e2e.deliver.wait"):
                        deliver_fut.result()
                deliver_fut = finish_pool.submit(_deliver, entries, fetch)

        futs = deque()
        exhausted = False

        def _prefetch():
            while not exhausted and len(futs) < 2:
                futs.append(io_pool.submit(_pull))

        _prefetch()
        while futs:
            with span("cm3d.e2e.io.wait"):
                res = futs.popleft().result()
            if res is None:
                exhausted = True
                continue
            _prefetch()
            prepared, assemble = res
            with span("cm3d.e2e.keyframe"):
                # 2D stage: planes stay on the device, in the lift's layout
                handle = start_frame_masks(
                    models, None, mask_cfg, mask_wh=mask_wh,
                    plane_layout="xy", prepared=prepared, copy_planes=False,
                )
                # same truncation accounting as run_mask_stage — the fused
                # path must not silently drop what the two-stage path counts
                counters.update(handle["counts"])
                with span("cm3d.e2e.assemble"):
                    out = assemble(handle)
                if out is not None:
                    pending.append(out)
                    if len(pending) >= batch_size:
                        flush()
        flush()
        if deliver_fut is not None:
            with span("cm3d.e2e.deliver.wait"):
                deliver_fut.result()
    return n_frames


def run_e2e(
    dataroot: str,
    version: str,
    scenes: List[str],
    out_path: str,
    models: MaskModels,
    lift_cfg: LiftStageConfig = LiftStageConfig(),
    mask_cfg: MaskStageConfig = MaskStageConfig(),
    thumbnail: int = 1024,
    mask_dir: Optional[str] = None,
    batch_size: int = 4,
    verbose: bool = True,
    mask_wh: Optional[tuple] = None,
    device=None,
) -> dict:
    """nuScenes images -> submission JSON at `out_path`, in one process.
    Runs on CUDA unless `device` says otherwise (the models must have been
    built on the same device)."""
    from PIL import Image

    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.nuscenes import NuScenesFrontend, SubmissionWriter
    from cm3d_tpu_torch.datasets.nuscenes.tables import CAM_LIST

    if mask_cfg.max_masks_total != lift_cfg.max_masks:
        raise ValueError(
            f"the fused path needs the mask stage's bit-plane capacity "
            f"(MaskStageConfig.max_masks_total = {mask_cfg.max_masks_total}) to equal the "
            f"lift's padded mask count (LiftStageConfig.max_masks = {lift_cfg.max_masks})")
    device = resolve_device(device)
    lift_cfg = _scale_ratio_for_thumbnail(lift_cfg, thumbnail)
    store = MaskArtifactStore(mask_dir) if mask_dir else None
    # ONE fixed plane canvas for the frontend AND the fused mask stage
    # (run_fused mask_wh): per-frame canvases would change the keyframe
    # shape whenever image geometry varies
    plane_wh = mask_wh or (thumbnail, thumbnail * 9 // 16)
    frontend = NuScenesFrontend(dataroot, version, store, lift_cfg, mask_wh=plane_wh)
    step = make_keyframe_step_fn(lift_cfg, device=device)
    writer = SubmissionWriter()
    t0 = time.perf_counter()

    def frame_source():
        for scene_name in scenes:
            scene = frontend.nusc.scene_by_name(scene_name)
            nmap = frontend._map_for_scene(scene)
            lane_points = nmap.all_lane_points(0.5)
            drivable = (
                frontend.drivable_for_scene(scene)
                if lift_cfg.drivable_filter else None
            )
            samples = list(frontend.nusc.iter_samples(scene))
            for frame_num, sample in enumerate(samples):
                images = []
                for cam in CAM_LIST:
                    sd = frontend.nusc.get("sample_data", sample["data"][cam])
                    im = Image.open(f"{dataroot}/{sd['filename']}").convert("RGB")
                    im.thumbnail((thumbnail, thumbnail))
                    images.append(np.asarray(im))
                # sweep aggregation (file reads + host transforms) runs
                # HERE — the generator body executes on run_fused's IO
                # worker — so the main thread's device-feed loop never
                # stalls on point IO (it only assembles)
                points = frontend.aggregate_sweeps(sample)

                def assemble(handle, scene_name=scene_name, frame_num=frame_num,
                             sample=sample, points=points, lane_points=lane_points,
                             drivable=drivable, n_total=len(samples)):
                    # assemble runs on the MAIN thread in frame order, so
                    # the write below for frame n_total-1 is the scene's
                    # last artifact write — marking completion here (not in
                    # the IO-prefetch generator, which runs frames ahead)
                    # keeps the resume manifest truthful under a mid-scene
                    # crash. Zero-detection frames still write (empty)
                    # artifacts, matching run_mask_stage. Only this write
                    # copies the planes to the host, and it waits here for
                    # this frame's decode: with a mask_dir the next frame's
                    # dispatch starts after it, not under it.
                    if store is not None:  # optional reference artifacts
                        write_frame_artifacts(store, scene_name, frame_num, handle)
                        if frame_num == n_total - 1:
                            store.mark_scene_complete(scene_name, n_total)
                    if handle["planes"] is None:
                        return None
                    # planes stay a DEVICE tensor: the keyframe batch is
                    # stacked device-side in run_fused
                    packed = (handle["labels"], handle["scores"], handle["cams"],
                              handle["planes"])
                    kf, meta = frontend.assemble_keyframe(
                        scene_name, frame_num, sample, lane_points, packed, drivable,
                        points=points,
                    )
                    return kf, meta.sample_token

                yield images, assemble

    counters = MaskCounters()
    n_frames = run_fused(
        models, step, frame_source(), mask_cfg, writer.add_device_outputs, batch_size,
        counters=counters, mask_wh=plane_wh, device=device,
    )

    submission = writer.write(out_path)
    if verbose:
        dt = time.perf_counter() - t0
        n_boxes = sum(len(v) for v in submission["results"].values())
        print(f"e2e: {n_frames} keyframes -> {n_boxes} boxes in {dt:.1f}s "
              f"({n_frames / max(dt, 1e-9):.2f} kf/s)")
        print(counters.report())
    return submission


def run_e2e_waymo(
    frames_root: str,
    scenes: List[str],
    out_path: str,
    models: MaskModels,
    lift_cfg: Optional[LiftStageConfig] = None,
    mask_cfg: MaskStageConfig = MaskStageConfig(),
    thumbnail: int = 1024,
    mask_dir: Optional[str] = None,
    batch_size: int = 4,
    verbose: bool = True,
    mask_wh: Optional[tuple] = None,
    device=None,
) -> int:
    """Fused Waymo pipeline: raw .tfrecord segments (or frame-lite npz) ->
    images -> masks -> boxes -> metrics_pb2 Objects .bin, one process.
    Returns the number of keyframes lifted.

    The reference runs waymo/gen_2d_masks_detic.py then waymo/2d_to_3d.py
    glued by the artifact store; here the mask stage's device bit-planes
    drop straight into the Keyframe (same fusion as the nuScenes run_e2e).
    With mask_wh=None the plane canvas comes from the thumbnailed images
    (the max over the ring: Waymo's front cameras are taller than its side
    cameras, but the camera set is fixed, so the canvas is the same every
    frame); the lift reads the canvas off the planes.
    """
    from cm3d_tpu_torch.config import WAYMO_LIFT
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.waymo.frontend import (
        WaymoFrontend, boxes_to_waymo_objects, ring_images)
    from cm3d_tpu_torch.datasets.waymo.proto import encode_objects

    if lift_cfg is None:
        lift_cfg = WAYMO_LIFT
    if mask_cfg.max_masks_total != lift_cfg.max_masks:
        raise ValueError(
            f"the fused path needs the mask stage's bit-plane capacity "
            f"(MaskStageConfig.max_masks_total = {mask_cfg.max_masks_total}) to equal the "
            f"lift's padded mask count (LiftStageConfig.max_masks = {lift_cfg.max_masks})")
    device = resolve_device(device)
    lift_cfg = _scale_ratio_for_thumbnail(lift_cfg, thumbnail)
    store = MaskArtifactStore(mask_dir) if mask_dir else None
    # every keyframe gets its masks from the decode (`packed`), so the
    # frontend never reads a store; it needs one all the same
    frontend = WaymoFrontend(frames_root, store or MaskArtifactStore(frames_root), lift_cfg,
                             device=device, **({"mask_wh": mask_wh} if mask_wh else {}))
    step = make_keyframe_step_fn(lift_cfg, device=device)
    all_objects: list = []
    t0 = time.perf_counter()

    def frame_source():
        for scene in scenes:
            n = frontend.num_frames(scene)
            for i in range(n):
                fr = frontend.load_frame_by_index(scene, i)
                images = ring_images(fr, thumbnail)

                def assemble(handle, scene=scene, i=i, fr=fr, n=n):
                    # artifact write + completion marking on the main thread
                    # in frame order (see run_e2e)
                    if store is not None:
                        write_frame_artifacts(store, scene, i, handle)
                        if i == n - 1:
                            store.mark_scene_complete(scene, n)
                    if handle["planes"] is None:
                        return None
                    packed = (handle["labels"], handle["scores"], handle["cams"],
                              handle["planes"])
                    return frontend.build_keyframe(scene, i, fr, packed)

                yield images, assemble

    def on_boxes(meta, boxes):
        all_objects.extend(boxes_to_waymo_objects(
            meta, boxes.centers, boxes.sizes, boxes.yaws, boxes.scores, boxes.labels,
            boxes.keep))

    counters = MaskCounters()
    n_frames = run_fused(models, step, frame_source(), mask_cfg, on_boxes, batch_size,
                         counters=counters, mask_wh=mask_wh, device=device)
    with open(out_path, "wb") as f:
        f.write(encode_objects(all_objects))
    if verbose:
        dt = time.perf_counter() - t0
        print(f"e2e waymo: {n_frames} keyframes -> {len(all_objects)} objects in "
              f"{dt:.1f}s ({n_frames / max(dt, 1e-9):.2f} kf/s)")
        print(counters.report())
    return n_frames


def kitti_canvas_wh(thumbnail: int) -> tuple:
    """The fused KITTI path's pinned bit-plane canvas: (1024, 320), the
    two-stage frontend's default, scaled for other thumbnails."""
    return thumbnail, -(-320 * thumbnail // 1024)


def run_e2e_kitti(
    root: str,
    indices: List[int],
    out_dir: str,
    models: MaskModels,
    lift_cfg: Optional[LiftStageConfig] = None,
    mask_cfg: MaskStageConfig = MaskStageConfig(),
    thumbnail: int = 1024,
    mask_dir: Optional[str] = None,
    batch_size: int = 4,
    verbose: bool = True,
    device=None,
) -> int:
    """Fused KITTI pipeline: image_2 -> masks -> boxes -> label txts under
    `out_dir/pred` and `out_dir/pseudo`, one process (the working version of
    the reference's two-script KITTI flow; its lifter dead-ends at
    kitti/2d_to_3d.py:1528). Returns the number of frames lifted.

    KITTI's native image sizes vary from frame to frame (1242x375,
    1224x370, 1238x374, ...; their 1024 thumbnails are 309 or 310 rows), so
    the bit-plane canvas is pinned (`kitti_canvas_wh`): a canvas per frame
    would make the keyframes' mask_bits differ in shape and the batch stack
    fail. With `mask_dir` the artifacts are written frame by frame, with no
    scene-completion mark: `indices` may be any subset of the split."""
    from PIL import Image

    from cm3d_tpu_torch.config import KITTI_LIFT
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.kitti.frontend import (
        KittiFrontend, boxes_to_kitti_objects, kitti_image_wh)
    from cm3d_tpu_torch.pipelines.lift_kitti import make_kitti_step_fn, write_kitti_labels

    if lift_cfg is None:
        lift_cfg = KITTI_LIFT
    if mask_cfg.max_masks_total != lift_cfg.max_masks:
        raise ValueError(
            f"the fused path needs the mask stage's bit-plane capacity "
            f"(MaskStageConfig.max_masks_total = {mask_cfg.max_masks_total}) to equal the "
            f"lift's padded mask count (LiftStageConfig.max_masks = {lift_cfg.max_masks})")
    device = resolve_device(device)
    lift_cfg = _scale_ratio_for_thumbnail(lift_cfg, thumbnail)
    store = MaskArtifactStore(mask_dir) if mask_dir else None
    canvas_wh = kitti_canvas_wh(thumbnail)
    # every keyframe gets its masks from the decode (`packed`), so the
    # frontend never reads a store; it needs one all the same
    frontend = KittiFrontend(root, store or MaskArtifactStore(root), lift_cfg,
                             mask_wh=canvas_wh)
    kitti_step = make_kitti_step_fn(lift_cfg, device=device)

    # run_fused hands the second element of the step's output to the
    # writer, sliced per frame: the KITTI writer needs the masks' scores and
    # labels beside the lift
    def step(batch):
        lift, keep = kitti_step(batch)
        return None, (lift, keep, batch.mask_score, batch.mask_label)

    os.makedirs(f"{out_dir}/pred", exist_ok=True)
    os.makedirs(f"{out_dir}/pseudo", exist_ok=True)
    n_boxes = 0
    t0 = time.perf_counter()

    def frame_source():
        for idx in indices:
            im = Image.open(frontend.dataset.get_image_path(idx)).convert("RGB")
            im.thumbnail((thumbnail, thumbnail))
            images = [np.asarray(im)]

            def assemble(handle, idx=idx):
                if store is not None:
                    write_frame_artifacts(store, frontend.scene_name, idx, handle)
                if handle["planes"] is None:
                    return None
                packed = (handle["labels"], handle["scores"], handle["cams"],
                          handle["planes"])
                return frontend.build_keyframe(idx, packed)  # (kf, idx)

            yield images, assemble

    def on_boxes(idx, payload):
        nonlocal n_boxes
        lift, keep, scores, labels = payload
        objs = boxes_to_kitti_objects(
            frontend.dataset.get_calibration(idx), lift.centroids, lift.pca_yaws, scores,
            labels, keep, image_wh=kitti_image_wh(frontend.dataset, idx))
        n_boxes += len(objs)
        write_kitti_labels(out_dir, idx, objs)

    counters = MaskCounters()
    n_frames = run_fused(models, step, frame_source(), mask_cfg, on_boxes, batch_size,
                         counters=counters, mask_wh=canvas_wh, device=device)
    if verbose:
        dt = time.perf_counter() - t0
        print(f"e2e kitti: {n_frames} frames -> {n_boxes} boxes in {dt:.1f}s "
              f"({n_frames / max(dt, 1e-9):.2f} f/s)")
        print(counters.report())
    return n_frames


def merge_submissions(paths: List[str], out_path: str) -> dict:
    """Merge submission JSONs over disjoint sample sets (runs split by
    scene) into one. Duplicate sample tokens concatenate."""
    merged: dict = {"meta": None, "results": {}}
    for path in paths:
        with open(path) as f:
            sub = json.load(f)
        if merged["meta"] is None:
            merged["meta"] = sub.get("meta", {})
        for token, objs in sub["results"].items():
            merged["results"].setdefault(token, []).extend(objs)
    with open(out_path, "w") as f:
        json.dump(merged, f)
    return merged


def merge_host_outputs(paths: List[str], out: str, dataset: str = "nuscenes") -> None:
    """Merge per-host --host_shard outputs into one, for any dataset.

    nuscenes: submission JSONs merge per sample token (merge_submissions).
    waymo: proto .bin shards concatenate byte-wise: Objects is a message
        with a single repeated field, and protobuf defines concatenation of
        serialized messages as message merging, so `cat` is exact (the
        metrics binary reads the result as one bin).
    kitti: per-host OUTPUT DIRECTORIES hold disjoint {frame:06d}.txt label
        files, either flat (the two-stage lift layout) or under pred/ and
        pseudo/ (run_e2e_kitti's layout); merging mirrors the layout and
        copies files (a duplicate frame raises: host shards are disjoint).
    """
    if dataset == "nuscenes":
        merge_submissions(paths, out)
    elif dataset == "waymo":
        with open(out, "wb") as f:
            for path in paths:
                with open(path, "rb") as g:
                    f.write(g.read())
    elif dataset == "kitti":
        import shutil

        def merge_dir(srcs, dst_dir):
            os.makedirs(dst_dir, exist_ok=True)
            for src in srcs:
                for name in sorted(os.listdir(src)):
                    s = os.path.join(src, name)
                    d = os.path.join(dst_dir, name)
                    if os.path.isdir(s):
                        merge_dir([s], d)  # run_e2e_kitti's pred/ and pseudo/
                        continue
                    if os.path.exists(d):
                        raise FileExistsError(f"{d}: frame written by two host shards")
                    shutil.copyfile(s, d)

        merge_dir(paths, out)
    else:
        raise ValueError(f"unknown dataset {dataset!r}")


def main(argv=None):
    """CLI: the fused nuScenes / Waymo / KITTI pipeline on the port (CUDA
    unless --device says otherwise)."""
    from cm3d_tpu_torch.vocab import CUSTOM_VOCABULARY_NUSCENES, CUSTOM_VOCABULARY_WAYMO

    p = argparse.ArgumentParser(
        description="CM3D fused images->masks->boxes pipeline (PyTorch port)")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--scenes", required=True,
                   help="comma-separated names (KITTI: frame indices)")
    p.add_argument("--out", default="pseudolabels.json")
    p.add_argument("--mask_dir", default="",
                   help="also write reference-layout mask artifacts here")
    p.add_argument("--thumbnail", type=int, default=1024)
    p.add_argument("--run_nms", type=int, default=-1,
                   help="class-wise 2D NMS before SAM prompting: 1 on / 0 off / "
                   "-1 dataset default (off for kitti, the reference's 'wo_2d_nms'; "
                   "on otherwise; as the masks CLI)")
    add_model_flags(p)
    add_quant_flags(p)
    p.add_argument("--rect_encode", action="store_true",
                   help="SAM rectangle encode (faster; small deviation)")
    p.add_argument("--encode_chunk", type=int, default=1,
                   help="cameras per SAM-encode step (must divide the ring size)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    add_run_flags(p)
    args = p.parse_args(argv)

    # the reference's Waymo vocabulary drops cone/barrier
    # (waymo/gen_2d_masks_detic.py:66-87), as in the masks CLI
    waymo = args.dataset == "waymo"
    common = dict(mask_cfg=MaskStageConfig(run_nms=run_nms(args)), thumbnail=args.thumbnail,
                  mask_dir=args.mask_dir or None, device=args.device)
    scenes = args.scenes.split(",")
    out = args.out
    if args.host_shard:
        # each host lifts its stride and writes {out}.host{i}; merge with
        # merge_host_outputs(paths, out, dataset)
        from cm3d_tpu_torch.parallel.multihost import process_index_and_count, shard_for_host

        scenes = shard_for_host(scenes)
        index, count = process_index_and_count()
        if count > 1:
            out = f"{args.out}.host{index}"
    with camera_mesh(args) as mesh:
        models = attach_models(build_models(p, args, CUSTOM_VOCABULARY_WAYMO if waymo
                                            else CUSTOM_VOCABULARY_NUSCENES, args.device, mesh),
                               args, args.device)
        if waymo:
            run_e2e_waymo(args.dataroot, scenes, out, models, **common)
        elif args.dataset == "kitti":
            run_e2e_kitti(args.dataroot, [int(i) for i in scenes], out, models, **common)
        else:
            run_e2e(args.dataroot, args.version, scenes, out, models, **common)

if __name__ == "__main__":
    main()

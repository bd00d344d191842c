"""Trained-detector inference: CenterPoint checkpoint -> submission JSON.
Mirrors `cm3d_tpu/pipelines/detect.py`.

Closes the semi-supervised loop: pseudo-labels (pipelines/lift.py or
e2e.py) -> pipelines/pretrain.py -> this module -> `python -m
cm3d_tpu_torch.eval` scores the result like any other submission.

Device path: pillarize -> detector forward (eval mode) -> CenterPoint top-k
decode -> circle NMS, batched over samples; the host only aggregates sweeps
and formats JSON. Runs on the CUDA device unless `--device` says otherwise.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from cm3d_tpu_torch.config import NUSCENES_CLASSES, class_arrays


def make_detect_fn(model, pillar_cfg, radius_sq: np.ndarray, top_k: int = 128,
                   score_thresh: float = 0.1, fusion: bool = False):
    """(points [B,N,4], valid [B,N][, images, intrinsics, cam_to_ego]) ->
    (boxes [B,K,7], scores [B,K], classes [B,K], keep [B,K]) on the model's
    device. fusion=True expects a BevFusionDetector and the three camera
    operands (same layout as train.FusionBatch). The model runs in eval mode
    (running batch statistics), without grad."""
    import torch

    from cm3d_tpu_torch.ops.nms import circle_nms_keep
    from cm3d_tpu_torch.train import decode_detections, pillarize

    device = next(model.parameters()).device
    radius_sq = torch.as_tensor(np.asarray(radius_sq), dtype=torch.float32, device=device)
    out_stride = (model.cfg.centerpoint if fusion else model.cfg).out_stride

    @torch.no_grad()
    def detect(points, valid, *camera):
        model.eval()
        pillars = pillarize(points, valid, pillar_cfg)
        if device.type == "cpu":
            # one sample at a time: oneDNN's CPU convolutions block over the
            # batch, so a sample's numbers would depend on the batch it rides
            # in (a data-parallel rank's rows against the whole batch)
            outs = [model(pillars[i:i + 1], *(c[i:i + 1] for c in camera))
                    for i in range(pillars.shape[0])]
            out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        else:
            out = model(pillars, *camera)
        boxes, scores, classes = decode_detections(out, pillar_cfg, out_stride, top_k=top_k)
        good = scores >= score_thresh
        keep = circle_nms_keep(boxes[..., :2], scores, classes, good, radius_sq) & good
        return boxes, scores, classes, keep

    return detect


def build_detector(pillar_cfg, model_cfg, fusion_cfg=None):
    """The CenterPoint detector of `model_cfg`, or BEVFusion-lite when
    `fusion_cfg` is given, on the CPU with the port's initialisation."""
    if fusion_cfg is not None:
        from cm3d_tpu_torch.train.bevfusion import BevFusionDetector

        return BevFusionDetector(fusion_cfg, pillar_cfg)
    from cm3d_tpu_torch.train.centerpoint import CenterPointDetector

    return CenterPointDetector(model_cfg, in_channels=pillar_cfg.num_features)


def load_detect_fn(ckpt_dir: str, pillar_cfg, model_cfg, fusion_cfg, classes,
                   top_k: int, score_thresh: float, device):
    """make_detect_fn over the checkpoint `ckpt_dir` on `device`: the
    CenterPoint detector, or BEVFusion-lite when `fusion_cfg` is given
    (whose configuration must match the checkpoint's). Every argument is
    picklable, so a data-parallel worker loads the same detector
    (parallel.dp_step)."""
    from cm3d_tpu_torch.models.checkpoints import load_params
    from cm3d_tpu_torch.parallel.mesh import Program
    from cm3d_tpu_torch.train.train import model_tensors

    model = build_detector(pillar_cfg, model_cfg, fusion_cfg)
    if fusion_cfg is not None:
        model_cfg = fusion_cfg.centerpoint
    params, stats = model_tensors(model)
    restored = load_params(ckpt_dir, like={"params": params, "batch_stats": stats})
    model.load_state_dict({**restored["params"], **restored["batch_stats"]}, strict=True)
    model.to(device).eval()

    # CIRCLE_NMS_THRESH values are the squared thresholds the reference
    # compares squared distances against (ops/nms.circle_nms_keep doc)
    _, _, radii = class_arrays(classes)
    detect = make_detect_fn(model, pillar_cfg, radii[: model_cfg.num_classes],
                            top_k=top_k, score_thresh=score_thresh,
                            fusion=fusion_cfg is not None)
    detect.program = Program(f"{__name__}:load_detect_fn",
                             (ckpt_dir, pillar_cfg, model_cfg, fusion_cfg, tuple(classes),
                              top_k, score_thresh))
    detect.device = device
    return detect


def run_detect(
    dataroot: str,
    version: str,
    ckpt_dir: str,
    out_json: str,
    scenes: Optional[List[str]] = None,
    batch_size: int = 4,
    top_k: int = 128,
    score_thresh: float = 0.1,
    max_points: int = 32768,
    pillar_cfg=None,
    model_cfg=None,
    classes=NUSCENES_CLASSES,
    verbose: bool = True,
    use_camera: bool = False,
    image_hw=(144, 256),
    fusion_cfg=None,
    camera_backbone: str = "conv",
    data_parallel: int = 0,
    device=None,
) -> dict:
    """Run the trained detector over keyframes; write + return the
    submission. `ckpt_dir` is pretrain's `{out}/centerpoint`
    (params + batch statistics), or `{out}/bevfusion` with use_camera=True,
    which must match the training-time image_hw / fusion_cfg.
    data_parallel N > 0 splits each batch over N ranks (parallel.dp_step):
    the same submission as the single-device run."""
    from cm3d_tpu_torch.datasets.nuscenes.writer import SubmissionWriter, boxes_to_dicts
    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.parallel import dp_step
    from cm3d_tpu_torch.parallel.mesh import validate_data_parallel
    from cm3d_tpu_torch.pipelines.pretrain import load_ego_points, make_points_frontend
    from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32

    device = resolve_device(device)
    if data_parallel:
        validate_data_parallel(data_parallel, batch_size, device)
    strict_f32()

    pillar_cfg = pillar_cfg or PillarConfig()
    if use_camera:
        from cm3d_tpu_torch.train.bevfusion import BevFusionConfig

        fusion_cfg = fusion_cfg or BevFusionConfig(
            centerpoint=model_cfg or CenterPointConfig(),
            camera_backbone=camera_backbone,
        )
    else:
        fusion_cfg = None
        model_cfg = model_cfg or CenterPointConfig()
    detect = load_detect_fn(ckpt_dir, pillar_cfg, model_cfg, fusion_cfg, classes, top_k,
                            score_thresh, device)

    fe = make_points_frontend(dataroot, version, max_points)
    nusc = fe.nusc
    if scenes:
        samples = []
        for name in scenes:
            samples += list(nusc.iter_samples(nusc.scene_by_name(name)))
    else:
        samples = list(nusc.table("sample"))

    writer = SubmissionWriter()
    t0 = time.perf_counter()
    with dp_step(detect, batch_size, data_parallel) as detect:
        for i0 in range(0, len(samples), batch_size):
            chunk = samples[i0: i0 + batch_size]
            pts = np.zeros((batch_size, max_points, 4), np.float32)
            val = np.zeros((batch_size, max_points), bool)
            egos = []
            camera = ()
            if use_camera:
                from cm3d_tpu_torch.pipelines.pretrain import load_ring_cameras

                ih, iw = image_hw
                imgs = np.zeros((batch_size, 6, ih, iw, 3), np.float32)
                intr = np.tile(np.eye(3, dtype=np.float32), (batch_size, 6, 1, 1))
                exts = np.tile(np.eye(4, dtype=np.float32), (batch_size, 6, 1, 1))
            for j, sample in enumerate(chunk):
                # shared helper = the training frame, verbatim
                pts[j], val[j], ego_t = load_ego_points(fe, sample, max_points)
                egos.append(ego_t)
                if use_camera:
                    im_u8, k, e = load_ring_cameras(fe, sample, image_hw, ego_t)
                    imgs[j], intr[j], exts[j] = im_u8 / 255.0, k, e
            if use_camera:
                camera = (imgs, intr, exts)
            moved = to_device((pts, val) + camera, device)
            boxes, scores, cls, keep = (t.cpu().numpy() for t in detect(*moved))
            for j, sample in enumerate(chunk):
                centers = boxes[j, :, :3] + egos[j][None]  # back to global
                writer.add_sample(
                    sample["token"],
                    boxes_to_dicts(
                        sample["token"], centers, boxes[j, :, 3:6],
                        boxes[j, :, 6], scores[j], cls[j], keep[j],
                        classes=classes,
                    ),
                )
    submission = writer.write(out_json)
    if verbose:
        dt = time.perf_counter() - t0
        n_boxes = sum(len(v) for v in submission["results"].values())
        print(f"detect: {len(samples)} keyframes, {n_boxes} boxes in "
              f"{dt:.1f}s -> {out_json}")
    return submission


def main(argv=None):
    p = argparse.ArgumentParser(
        description="trained-detector inference -> submission JSON"
    )
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--ckpt", required=True,
                   help="pretrain checkpoint dir ({out}/centerpoint)")
    p.add_argument("--out", default="detections.json")
    p.add_argument("--scenes", default="",
                   help="comma-separated scene names (default: all samples)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each batch over N cards, one process a card "
                   "(N must divide --batch_size; 0 = single device)")
    p.add_argument("--top_k", type=int, default=128)
    p.add_argument("--score_thresh", type=float, default=0.1)
    p.add_argument("--use_camera", action="store_true",
                   help="BEVFusion-lite checkpoint ({out}/bevfusion from "
                   "pretrain --use_camera); loads the ring images too")
    p.add_argument("--camera_backbone", default="conv", choices=("conv", "swin_t"),
                   help="--use_camera image backbone; must match the "
                   "checkpoint's training-time choice")
    p.add_argument("--image_hw", default="144x256",
                   help="camera input size HxW (must match training)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain PyTorch path)")
    args = p.parse_args(argv)
    if args.camera_backbone != "conv" and not args.use_camera:
        raise SystemExit("--camera_backbone requires --use_camera")
    ih, iw = (int(x) for x in args.image_hw.split("x"))
    run_detect(
        args.dataroot, args.version, args.ckpt, args.out,
        scenes=args.scenes.split(",") if args.scenes else None,
        batch_size=args.batch_size, top_k=args.top_k,
        score_thresh=args.score_thresh, use_camera=args.use_camera,
        image_hw=(ih, iw), camera_backbone=args.camera_backbone,
        data_parallel=args.data_parallel, device=args.device,
    )


if __name__ == "__main__":
    main()

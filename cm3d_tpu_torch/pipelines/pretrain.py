"""Pseudo-label pretraining: submission JSON + nuScenes points ->
trained CenterPoint-style detector. Mirrors `cm3d_tpu/pipelines/pretrain.py`.

Boxes come from a CM3D submission (or any nuScenes-format results JSON);
points come from the dataroot's keyframe sweeps, shifted into the ego frame
(training is ego-centric). Runs on the CUDA device unless `--device` says
otherwise.

Usage:
  python -m cm3d_tpu_torch.pipelines.pretrain --dataroot D --version V \\
      --labels preds.json --steps 200 --out ckpt_dir
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from cm3d_tpu_torch.config import CLASS_TO_ID, LiftStageConfig
from cm3d_tpu_torch.parallel.mesh import validate_data_parallel

# ONE padded-points shape shared by the resident dataset (unpadded rows,
# see build_train_batches) and batch assembly (run_pretrain.assemble):
# the two sites must agree or assembly breaks/mis-pads.
MAX_POINTS = 32768

def make_points_frontend(dataroot: str, version: str, max_points: int, tables=None):
    """NuScenes frontend used only for sweep aggregation + tables (no mask
    store; shared by pretrain and detect so training and inference read
    points identically). tables: an already-parsed NuScenesTables to
    reuse (avoids re-parsing the eagerly-loaded table set)."""
    from cm3d_tpu_torch.datasets.artifacts import MaskArtifactStore
    from cm3d_tpu_torch.datasets.nuscenes import NuScenesFrontend

    return NuScenesFrontend(
        dataroot, version, MaskArtifactStore("/nonexistent"),
        LiftStageConfig(max_points=max_points), tables=tables,
    )


def load_ego_points(fe, sample: dict, max_points: int):
    """Sweep-aggregated points in the EGO-CENTRIC frame, fixed-size padded.

    This IS the train/inference frame contract: translation-only shift by
    the keyframe's lidar ego pose (no rotation). pipelines/detect.py must
    invert exactly this transform on its way back to global boxes, so both
    sides call this one helper.

    Returns (points [max_points,4], valid [max_points], ego_t [3])."""
    pose = fe.nusc.sample_lidar_ego_pose(sample)
    ego_t = np.asarray(pose["translation"])
    pts = fe.aggregate_sweeps(sample)
    pts[:, :3] -= ego_t
    points = np.zeros((max_points, 4), np.float32)
    valid = np.zeros(max_points, bool)
    n = min(len(pts), max_points)
    points[:n] = pts[:n]
    valid[:n] = True
    return points, valid, ego_t


def load_ring_cameras(fe, sample: dict, image_hw, ego_t_lidar):
    """Ring images + calibration for camera+LiDAR fusion.

    Returns (images [C,h,w,3] uint8, intrinsics [C,3,3] scaled to
    image_hw, cam_to_train [C,4,4]). The "train" frame is
    load_ego_points' frame (GLOBAL axes shifted by the keyframe lidar
    ego translation, translation-only), so each camera extrinsic
    composes its full ego-pose rotation: R = R_egopose @ R_calibsensor,
    t = R_egopose @ t_calibsensor + (t_egopose - ego_t_lidar)."""
    from PIL import Image

    from cm3d_tpu_torch.datasets.nuscenes.frontend import _quat_to_mat
    from cm3d_tpu_torch.datasets.nuscenes.tables import CAM_LIST

    h, w = image_hw
    nusc = fe.nusc
    imgs, intr, exts = [], [], []
    for cam in CAM_LIST:
        sd = nusc.get("sample_data", sample["data"][cam])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
        im = Image.open(fe.dataroot / sd["filename"]).convert("RGB")
        sx, sy = w / im.width, h / im.height
        imgs.append(np.asarray(im.resize((w, h)), np.uint8))
        k = np.asarray(cs["camera_intrinsic"], np.float32).copy()
        k[0] *= sx
        k[1] *= sy
        r_ego = _quat_to_mat(pose["rotation"])
        e = np.eye(4, dtype=np.float32)
        e[:3, :3] = r_ego @ _quat_to_mat(cs["rotation"])
        e[:3, 3] = (r_ego @ np.asarray(cs["translation"])
                    + np.asarray(pose["translation"]) - ego_t_lidar)
        intr.append(k)
        exts.append(e)
    return np.stack(imgs), np.stack(intr), np.stack(exts)


def build_gt_labels(dataroot: str, version: str, tables=None) -> Dict[str, list]:
    """GT annotations as a submission-style results dict: the label source
    for GT-fraction fine-tuning (`--labels_gt`, usually with `--split`)."""
    from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables
    from cm3d_tpu_torch.eval.config import CATEGORY_TO_DETECTION_NAME

    nusc = tables if tables is not None else NuScenesTables(dataroot, version)
    results: Dict[str, list] = {}
    for scene in nusc.table("scene"):
        for sample in nusc.iter_samples(scene):
            objs = []
            for ann_token in sample["anns"]:
                ann = nusc.get("sample_annotation", ann_token)
                name = CATEGORY_TO_DETECTION_NAME.get(ann["category_name"])
                if name is None:
                    continue
                objs.append({
                    "translation": ann["translation"],
                    "rotation": ann["rotation"],
                    "size": ann["size"],
                    "detection_name": name,
                    "detection_score": 1.0,
                })
            results[sample["token"]] = objs
    return results


def split_sample_tokens(nusc, split: str, splits_json=None) -> set:
    """Sample tokens of the scenes in `split` (resolve_eval_set semantics:
    a split name like train_detect50/val25, 'all', or comma-separated
    explicit scene names)."""
    from cm3d_tpu_torch.datasets.nuscenes.splits import resolve_eval_set

    scene_names = [s["name"] for s in nusc.table("scene")]
    keep = set(resolve_eval_set(split, scene_names, splits_json))
    tokens = set()
    for scene in nusc.table("scene"):
        if scene["name"] in keep:
            for sample in nusc.iter_samples(scene):
                tokens.add(sample["token"])
    return tokens


def build_train_batches(
    dataroot: str,
    version: str,
    labels_json: str = None,
    max_points: int = MAX_POINTS,
    max_boxes: int = 64,
    image_hw=None,
    results: Dict[str, list] = None,
    sample_tokens=None,
    tables=None,
):
    """Yield (sample_token, points [n,4] ego UNPADDED, n_points int,
    boxes [M,8], box_valid[, camera triple]). Points stay trimmed to their
    real count in the resident dataset; the fixed [max_points, 4] pad is
    applied at batch-assembly time, the same reason the ring images are held
    re-encoded as JPEGs. image_hw != None additionally loads the ring images
    + calibration (uint8; normalized at batch-assembly time). Labels come
    from `results` (in-memory dict) or `labels_json`; `sample_tokens`
    restricts to a scene split's samples (GT-fraction fine-tuning)."""
    from cm3d_tpu_torch.eval.algo import quaternion_yaw

    if results is None:
        with open(labels_json) as f:
            results = json.load(f)["results"]

    fe = make_points_frontend(dataroot, version, max_points, tables=tables)
    nusc = fe.nusc
    token_to_sample = {s["token"]: s for s in nusc.table("sample")}

    for token, objs in results.items():
        if sample_tokens is not None and token not in sample_tokens:
            continue
        sample = token_to_sample.get(token)
        if sample is None:
            continue
        points, pvalid, ego_t = load_ego_points(fe, sample, max_points)
        n_pts = int(pvalid.sum())  # valid rows are a contiguous prefix
        points = np.ascontiguousarray(points[:n_pts])

        # filter unmapped names BEFORE the cap (a [:max_boxes] slice of the
        # raw list would let skipped entries consume box slots), and when
        # the cap still binds keep the HIGHEST-scoring labels (pseudo-labels
        # carry detection_score; GT from the tables does not: keep order)
        mapped = [o for o in objs if o["detection_name"] in CLASS_TO_ID]
        if len(mapped) > max_boxes:
            mapped.sort(key=lambda o: -float(o.get("detection_score", 0.0)))
            mapped = mapped[:max_boxes]
        boxes = np.zeros((max_boxes, 8), np.float32)
        bvalid = np.zeros(max_boxes, bool)
        for i, o in enumerate(mapped):
            t = np.asarray(o["translation"]) - ego_t
            yaw = quaternion_yaw(tuple(o["rotation"]))
            w, l, h = o["size"]
            boxes[i] = [t[0], t[1], t[2], w, l, h, yaw, CLASS_TO_ID[o["detection_name"]]]
            bvalid[i] = True
        if image_hw is not None:
            import io

            from PIL import Image

            imgs_u8, intr, exts = load_ring_cameras(fe, sample, image_hw, ego_t)
            # hold the resident dataset as SMALL re-encoded JPEGs;
            # assemble() decodes the picked batch's ring per step
            bufs = []
            for im in imgs_u8:
                b = io.BytesIO()
                Image.fromarray(im).save(b, format="JPEG", quality=90)
                bufs.append(b.getvalue())
            yield token, points, n_pts, boxes, bvalid, (bufs, intr, exts)
        else:
            yield token, points, n_pts, boxes, bvalid


def latest_state_dir(out_dir: str):
    """Highest-step `state_*` checkpoint under out_dir, or None."""
    import re

    if not os.path.isdir(out_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(out_dir):
        m = re.fullmatch(r"state_(\d+)", name)
        if m and int(m.group(1)) > best_step:
            best, best_step = os.path.join(out_dir, name), int(m.group(1))
    return best


@contextlib.contextmanager
def deterministic_training():
    """Exact replay on the card: cuDNN's convolution backward and the
    index_add behind a gather's backward pick an order of additions at run
    time unless told not to. Inside this context PyTorch uses its
    deterministic algorithms (and raises on an operation that has none), so
    a killed-and-resumed run equals an uninterrupted one bit for bit. cuBLAS
    needs its workspace fixed for that: CUBLAS_WORKSPACE_CONFIG is set here
    when the environment has none, which is in time only if no matrix
    product has run on the card in this process yet (PyTorch raises
    otherwise, naming the variable). While the variable is set, the host
    side of every matrix product of the process is slower (PyTorch 2.11: the
    mask stage loses a fifth of its throughput on an H100, PERF.md), so the
    variable and the previous setting are restored on the way out."""
    import torch

    had_workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    before = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before, warn_only=warn_only)
        if had_workspace is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]


@dataclasses.dataclass(frozen=True)
class TrainSetup:
    """Everything that builds the model, the optimizer and the step of a
    run: picklable, so that a data-parallel worker builds the same ones."""

    seed: int
    pillar_cfg: Any
    model_cfg: Any  # CenterPointConfig, or None with a camera
    fusion_cfg: Any  # BevFusionConfig with a camera, else None
    image_hw: Tuple[int, int]
    n_cams: int
    learning_rate: float
    steps: int
    lr_schedule: str
    warmup_steps: int
    grad_clip: Optional[float]
    ema_decay: float
    augment: bool
    data_parallel: bool = False


def build_training(setup: TrainSetup, device):
    """(state, step_fn, checkpoint name) of a run, on `device`: the
    CenterPoint detector, or BEVFusion-lite when the setup has a fusion
    config; weights from the setup's seed."""
    from cm3d_tpu_torch.train import AugmentConfig, make_optimizer, make_train_step
    from cm3d_tpu_torch.train.train import init_state

    opt = make_optimizer(setup.learning_rate, total_steps=setup.steps,
                         schedule=setup.lr_schedule, warmup_steps=setup.warmup_steps,
                         grad_clip=setup.grad_clip)
    step_kw = dict(ema_decay=setup.ema_decay,
                   augment=AugmentConfig() if setup.augment else None,
                   aug_seed=setup.seed, data_parallel=setup.data_parallel)
    if setup.fusion_cfg is not None:
        from cm3d_tpu_torch.train.bevfusion import init_fusion_state, make_fusion_train_step

        state, model, tx = init_fusion_state(
            setup.seed, setup.pillar_cfg, setup.fusion_cfg, setup.image_hw,
            n_cams=setup.n_cams, tx=opt, ema=setup.ema_decay > 0, device=device,
        )
        return state, make_fusion_train_step(model, tx, setup.pillar_cfg, **step_kw), "bevfusion"
    state, model, tx = init_state(setup.seed, setup.pillar_cfg, setup.model_cfg, tx=opt,
                                  ema=setup.ema_decay > 0, device=device)
    return state, make_train_step(model, tx, setup.pillar_cfg, **step_kw), "centerpoint"


def state_tensors(state) -> list:
    """Every tensor of a train state, in one fixed order."""
    out = list(state.params.values()) + list(state.batch_stats.values())
    out += list(state.opt_state["mu"].values()) + list(state.opt_state["nu"].values())
    if state.ema_params is not None:
        out += list(state.ema_params.values())
    return out


def broadcast_state(state) -> None:
    """Make every rank's state rank 0's: tensors, step and update count."""
    import torch.distributed as dist

    from cm3d_tpu_torch.parallel.mesh import broadcast_tensors

    broadcast_tensors(state_tensors(state))
    counts = [state.step, state.opt_state["count"]]
    dist.broadcast_object_list(counts, src=0)
    state.step, state.opt_state["count"] = counts


def data_parallel_train_program(setup: TrainSetup, device):
    """A data-parallel worker's side of run_pretrain: its replica of the
    model and optimizer, started from rank 0's state (`sync`), stepping on
    its rows of each global batch under the same deterministic algorithms
    as rank 0. Rank 0 alone writes checkpoints."""
    state, step_fn, _ = build_training(setup, device)
    scope = deterministic_training()
    scope.__enter__()  # for the worker's lifetime

    def program(batch):
        return step_fn(state, batch)[1]

    program.sync = lambda: broadcast_state(state)
    program.scope = scope  # held: collected, the context would restore the settings
    return program


def run_pretrain(
    dataroot: str,
    version: str,
    labels_json: str,
    out_dir: str,
    steps: int = 100,
    batch_size: int = 4,
    learning_rate: float = 1e-3,
    verbose: bool = True,
    save_every: int = 0,
    resume: bool = False,
    seed: int = 0,
    pillar_cfg=None,
    model_cfg=None,
    use_camera: bool = False,
    image_hw=(144, 256),
    fusion_cfg=None,
    camera_backbone: str = "conv",
    camera_bf16: bool = False,
    camera_remat: bool = False,
    labels_gt: bool = False,
    split: str = None,
    splits_json: str = None,
    init_from: str = None,
    lr_schedule: str = "const",
    warmup_steps: int = 0,
    grad_clip: float = None,
    ema_decay: float = 0.0,
    augment: bool = False,
    data_parallel: int = 0,
    device=None,
) -> Dict[str, float]:
    """Train for `steps` GLOBAL steps, optionally checkpointing the full
    train state (params + batch statistics + optimizer state + step + EMA)
    every `save_every` steps to `{out_dir}/state_{step:06d}` and resuming
    from the latest such checkpoint. The per-step batch sampling is keyed by
    (seed, global_step), so a killed-and-resumed run replays the exact
    sample sequence of an uninterrupted one, and with the deterministic
    algorithms this function turns on, the exact parameters.

    use_camera=True trains the BEVFusion-lite camera+LiDAR detector
    (train/bevfusion.py) instead: ring images at `image_hw` feed the
    lift-splat BEV branch; the checkpoint saves to `{out_dir}/bevfusion`
    (pipelines/detect.py --use_camera consumes it).

    GT-fraction fine-tuning: labels_gt=True sources labels from the GT
    tables instead of a submission JSON, split= restricts samples to a scene
    split, and init_from= warm-starts params + batch statistics from a saved
    checkpoint (fresh optimizer, step 0; unlike resume, which restores the
    FULL train state).

    data_parallel N > 0 splits each global batch over N ranks (parallel/
    mesh.py): the resident dataset stays here, on rank 0, which assembles
    each global batch as the single-device run does and scatters its rows;
    the workers' replicas start from rank 0's state (after --resume and
    --init_from too); BatchNorm and the losses see the global batch and the
    gradients are summed, so the run follows the single-device one."""
    import torch

    from cm3d_tpu_torch.datasets.types import to_device
    from cm3d_tpu_torch.models.checkpoints import load_params, save_params
    from cm3d_tpu_torch.parallel.mesh import Program, dp_mesh
    from cm3d_tpu_torch.train import CenterPointConfig, PillarConfig
    from cm3d_tpu_torch.train.train import TrainBatch
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32

    if resume and init_from:
        raise SystemExit("--resume restores the full train state; it is "
                         "mutually exclusive with --init_from")
    if (labels_json is None) == (not labels_gt):
        raise SystemExit("pass exactly one label source: --labels <json> "
                         "or --labels_gt")
    device = resolve_device(device)
    if data_parallel:
        validate_data_parallel(data_parallel, batch_size, device)
    strict_f32()

    tables = None
    results = None
    sample_tokens = None
    if labels_gt or split:
        from cm3d_tpu_torch.datasets.nuscenes.tables import NuScenesTables

        tables = NuScenesTables(dataroot, version)
    if labels_gt:
        results = build_gt_labels(dataroot, version, tables=tables)
    if split:
        sample_tokens = split_sample_tokens(tables, split, splits_json)

    data = list(build_train_batches(
        dataroot, version, labels_json,
        image_hw=image_hw if use_camera else None,
        results=results, sample_tokens=sample_tokens, tables=tables,
    ))
    if not data:
        raise SystemExit("no training samples (empty labels or token mismatch)")

    pillar_cfg = pillar_cfg or PillarConfig()
    if use_camera:
        from cm3d_tpu_torch.train.bevfusion import BevFusionConfig, FusionBatch

        fusion_cfg = fusion_cfg or BevFusionConfig(
            centerpoint=model_cfg or CenterPointConfig(),
            camera_backbone=camera_backbone,
            camera_bf16=camera_bf16, camera_remat=camera_remat,
        )
        model_cfg = None
    else:
        fusion_cfg = None
        model_cfg = model_cfg or CenterPointConfig()
    setup = TrainSetup(
        seed=seed, pillar_cfg=pillar_cfg, model_cfg=model_cfg, fusion_cfg=fusion_cfg,
        image_hw=tuple(image_hw), n_cams=len(data[0][5][0]) if use_camera else 0,
        learning_rate=learning_rate, steps=steps, lr_schedule=lr_schedule,
        warmup_steps=warmup_steps, grad_clip=grad_clip, ema_decay=ema_decay,
        augment=augment, data_parallel=bool(data_parallel),
    )
    state, step_fn, ckpt_name = build_training(setup, device)
    start = 0
    if init_from:
        like = {"params": state.params, "batch_stats": state.batch_stats}
        loaded = load_params(init_from, like=like)
        with torch.no_grad():
            for key in ("params", "batch_stats"):
                for name, t in getattr(state, key).items():
                    t.copy_(loaded[key][name])
            if ema_decay > 0:
                for name, t in state.ema_params.items():
                    t.copy_(loaded["params"][name])
        if verbose:
            print(f"warm-started params from {init_from}")
    if resume:
        ckpt = latest_state_dir(out_dir)
        if ckpt is None:
            raise SystemExit(f"--resume: no state_* checkpoint under {out_dir}")
        state.load_tree(load_params(ckpt))
        start = state.step
        if verbose:
            print(f"resumed from {ckpt} at step {start}")

    def assemble(pick):
        # pad the trimmed resident points to the fixed shape here
        # (build_train_batches holds them unpadded, see its docstring);
        # MAX_POINTS is the shared module constant both sites use
        pts = np.zeros((len(pick), MAX_POINTS, 4), np.float32)
        pvalid = np.zeros((len(pick), MAX_POINTS), bool)
        for row, i in enumerate(pick):
            n = data[i][2]
            pts[row, :n] = data[i][1]
            pvalid[row, :n] = True
        base = dict(
            points=pts,
            point_valid=pvalid,
            boxes=np.stack([data[i][3] for i in pick]),
            box_valid=np.stack([data[i][4] for i in pick]),
        )
        if not use_camera:
            return TrainBatch(**base)
        import io

        from PIL import Image

        imgs = np.stack([
            np.stack([np.asarray(Image.open(io.BytesIO(buf))) for buf in data[i][5][0]])
            for i in pick
        ])
        return FusionBatch(
            **base,
            images=imgs.astype(np.float32) / 255.0,
            intrinsics=np.stack([data[i][5][1] for i in pick]),
            cam_to_ego=np.stack([data[i][5][2] for i in pick]),
        )

    t0 = time.perf_counter()
    last = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(deterministic_training())
        if data_parallel:
            group = stack.enter_context(dp_mesh(
                data_parallel, batch_size, device,
                Program(f"{__name__}:data_parallel_train_program", (setup,))))
            broadcast_state(state)
            local_step = step_fn

            def step_fn(state, batch):
                return group.run(lambda rows: local_step(state, rows), (batch,), gather=False)
        for s in range(start, steps):
            pick = np.random.default_rng((seed, s)).integers(0, len(data), batch_size)
            # the batch goes up through pinned memory, non-blocking
            state, metrics = step_fn(state, to_device(assemble(pick), device))
            # metrics stay DEVICE scalars between prints: a per-step copy to
            # the host would wait for the step and serialize the next
            # batch's host-side assemble against the device
            last = metrics
            if verbose and (s % max(1, steps // 10) == 0 or s == steps - 1):
                host = {k: round(float(v), 4) for k, v in metrics.items()}
                print(f"step {s}: " + json.dumps(host))
            if save_every and (s + 1) % save_every == 0:
                save_params(state.tree(), f"{out_dir}/state_{s + 1:06d}", overwrite=True)
                if verbose:
                    print(f"saved train state at step {s + 1}")
    if verbose:
        print(f"trained {steps - start} steps in {time.perf_counter() - t0:.1f}s")
    deploy_params = state.ema_params if ema_decay > 0 else state.params
    save_params(
        {"params": deploy_params, "batch_stats": state.batch_stats},
        f"{out_dir}/{ckpt_name}", overwrite=True,
    )
    if verbose:
        print(f"saved checkpoint to {out_dir}/{ckpt_name}")
    return {k: float(v) for k, v in last.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description="pseudo-label detector pretraining")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--labels", help="submission JSON (pseudo-labels); "
                   "exactly one of --labels / --labels_gt")
    p.add_argument("--labels_gt", action="store_true",
                   help="train on GT annotations from the tables (the "
                   "semi-sup fine-tune label source)")
    p.add_argument("--split", help="restrict samples to a scene split "
                   "(split name, 'all', or comma-separated scene names)")
    p.add_argument("--splits_json",
                   help="custom splits JSON for --split (train_detect50/25)")
    p.add_argument("--init_from",
                   help="warm-start params+batch_stats from a saved "
                   "checkpoint dir (fine-tune: fresh optimizer, step 0)")
    p.add_argument("--lr_schedule", choices=("const", "cosine"),
                   default="const", help="LR schedule over --steps")
    p.add_argument("--warmup_steps", type=int, default=0)
    p.add_argument("--grad_clip", type=float, help="global-norm gradient clip")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="params EMA decay (e.g. 0.999); the deploy "
                   "checkpoint saves the EMA")
    p.add_argument("--augment", action="store_true",
                   help="global flip/rotate/scale/shift augmentation "
                   "inside the train step (train/augment.py)")
    p.add_argument("--out", default="pretrain_ckpt")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--save_every", type=int, default=0,
                   help="checkpoint the full train state every N steps")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest state_* under --out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=0,
                   help="split each global batch over N cards, one process a card "
                   "(N must divide --batch_size; 0 = single device)")
    p.add_argument("--use_camera", action="store_true",
                   help="train the BEVFusion-lite camera+LiDAR detector "
                   "(ring images + lift-splat BEV branch); checkpoint "
                   "saves to {out}/bevfusion")
    p.add_argument("--image_hw", default="144x256",
                   help="camera input size HxW for --use_camera")
    p.add_argument("--camera_backbone", default="conv", choices=("conv", "swin_t"),
                   help="--use_camera image backbone: the lite conv trunk "
                   "or full Swin-T (multi-scale outputs FPN-fused at stride 8)")
    p.add_argument("--camera_bf16", action="store_true",
                   help="bf16 compute in the camera backbone (params/losses stay f32)")
    p.add_argument("--camera_remat", action="store_true",
                   help="recompute Swin blocks on backward (memory for "
                   "FLOPs; swin_t backbone only)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain PyTorch path)")
    args = p.parse_args(argv)
    if not args.use_camera and (
        args.camera_backbone != "conv" or args.camera_bf16 or args.camera_remat
    ):
        # silently training a LiDAR-only model for hours after asking for a
        # camera knob is worse than an immediate error
        raise SystemExit(
            "--camera_backbone/--camera_bf16/--camera_remat require --use_camera"
        )
    ih, iw = (int(x) for x in args.image_hw.split("x"))
    run_pretrain(args.dataroot, args.version, args.labels, args.out,
                 args.steps, args.batch_size, args.lr,
                 save_every=args.save_every, resume=args.resume,
                 seed=args.seed, use_camera=args.use_camera,
                 image_hw=(ih, iw), camera_backbone=args.camera_backbone,
                 camera_bf16=args.camera_bf16, camera_remat=args.camera_remat,
                 labels_gt=args.labels_gt,
                 split=args.split, splits_json=args.splits_json,
                 init_from=args.init_from, lr_schedule=args.lr_schedule,
                 warmup_steps=args.warmup_steps, grad_clip=args.grad_clip,
                 ema_decay=args.ema_decay, augment=args.augment,
                 data_parallel=args.data_parallel, device=args.device)


if __name__ == "__main__":
    main()

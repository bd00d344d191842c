"""Flags the masks and e2e CLIs share: the model flags (`--fake_weights`
or the four released checkpoints; `pipelines/masks.py build_models` reads
them), the int8 flags, the GroundingDINO flags (`--detector gdino`;
`pipelines/masks.py attach_models` reads them), `--run_nms`'s dataset
default, `--dataset`, `--host_shard` and `--camera_mesh`, as the JAX CLIs
spell them.
"""

from __future__ import annotations

import contextlib


def add_model_flags(p) -> None:
    """`--fake_weights`, or the released checkpoints and the CLIP BPE file
    with `--sam_size`; `--detector` and the GroundingDINO files; as the JAX
    CLIs spell them."""
    p.add_argument("--fake_weights", action="store_true",
                   help="tiny random-weight models (hermetic smoke run)")
    p.add_argument("--detic_ckpt", default="",
                   help="Detic Swin-B checkpoint (.pth), or a directory saved by save_params")
    p.add_argument("--sam_ckpt", default="", help="SAM checkpoint matching --sam_size")
    p.add_argument("--clip_ckpt", default="", help="CLIP (text tower) checkpoint")
    p.add_argument("--bpe_path", default="", help="CLIP's bpe_simple_vocab_16e6.txt.gz")
    p.add_argument("--sam_size", default="vit_h", choices=["vit_h", "vit_l", "vit_b"],
                   help="SAM encoder scale matching --sam_ckpt (vit_h is the reference's)")
    p.add_argument("--detector", default="detic", choices=("detic", "gdino"),
                   help="gdino: GroundingDINO Swin-T replaces Detic (the reference's "
                   "commented-out alternative)")
    p.add_argument("--gdino_ckpt", default="",
                   help="groundingdino_swint_ogc.pth, or a directory saved by save_params")
    p.add_argument("--gdino_vocab", default="", help="bert-base-uncased vocab.txt")
    p.add_argument("--gdino_bf16", action="store_true",
                   help="GroundingDINO in bf16 (default f32)")


def add_quant_flags(p) -> None:
    """`--quant_int8` (int8 w8a8 SAM encoder and Detic Swin MLPs) and
    `--quant_static` (SAM's activation scales calibrated on the first ring),
    as the JAX CLIs spell them."""
    p.add_argument("--quant_int8", action="store_true",
                   help="int8 w8a8 layers in the SAM encoder and Detic's Swin MLPs "
                   "(a documented deviation; ops/quant.py)")
    p.add_argument("--quant_static", action="store_true",
                   help="with --quant_int8: calibrated static SAM activation scales; the "
                   "first keyframe ring calibrates (one dynamic encode)")


def add_run_flags(p) -> None:
    """`--dataset`, `--host_shard` and `--camera_mesh`."""
    p.add_argument("--dataset", default="nuscenes", choices=["nuscenes", "waymo", "kitti"])
    p.add_argument("--host_shard", action="store_true",
                   help="multi-host: keep only this process's scene stride (RANK / "
                   "WORLD_SIZE, or torch.distributed's group; parallel/multihost.py)")
    p.add_argument("--camera_mesh", type=int, default=0,
                   help="camera-parallel 2D stage: the camera ring split over N ranks, one a "
                   "card (a core with --device cpu); N must divide the ring size")


def camera_mesh(args):
    """`--camera_mesh N`: the started N-rank (data,) mesh group the mask
    models run over (`pipelines/masks.py camera_parallel_models`), as a
    context; without the flag a null context (None)."""
    if not args.camera_mesh:
        return contextlib.nullcontext()
    import torch

    from cm3d_tpu_torch.parallel.mesh import DataParallelGroup, available_devices, make_mesh

    device = torch.device(args.device)
    return DataParallelGroup(make_mesh(n_data=args.camera_mesh,
                                       devices=[device] * available_devices(device)), device)


def run_nms(args) -> bool:
    """Class-wise 2D NMS before SAM prompting: `--run_nms` 1 / 0, or with
    -1 the dataset's default, off for KITTI (the reference's KITTI flow runs
    without it, "wo_2d_nms", kitti/gen_2d_masks_detic.py:781-811) and on
    for nuScenes and Waymo."""
    return args.dataset != "kitti" if args.run_nms < 0 else bool(args.run_nms)

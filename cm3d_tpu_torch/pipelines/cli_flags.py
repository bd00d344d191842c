"""The JAX CLIs' flags whose feature the port has not ported yet.

The masks and e2e CLIs accept them, so that a JAX command line fails with a
NotImplementedError naming its ROADMAP item instead of argparse's usage
error (exit 2).
"""

from __future__ import annotations

# flag -> the ROADMAP item that ports its feature
UNPORTED_FLAGS = {
    "detic_ckpt": "A6 (checkpoint loading)",
    "sam_ckpt": "A6 (checkpoint loading)",
    "clip_ckpt": "A6 (CLIP text encoder + checkpoint loading)",
    "bpe_path": "A6 (CLIP text encoder + checkpoint loading)",
    "quant_int8": "A12 (int8 w8a8)",
    "quant_static": "A12 (int8 w8a8)",
    "use_zoedepth": "A13 (ZoeDepth)",
    "zoe_ckpt": "A13 (ZoeDepth)",
    "gdino_ckpt": "A13 (GroundingDINO)",
    "gdino_vocab": "A13 (GroundingDINO)",
    "gdino_bf16": "A13 (GroundingDINO)",
    "camera_mesh": "A14 (multi-chip)",
    "host_shard": "A14 (multi-chip)",
}
_SWITCHES = ("quant_int8", "quant_static", "use_zoedepth", "gdino_bf16", "host_shard")


def add_unported_flags(p) -> None:
    """Accept the UNPORTED_FLAGS, `--sam_size`, `--detector` and every
    `--dataset` of the JAX CLIs, as the JAX CLIs spell them."""
    p.add_argument("--dataset", default="nuscenes", choices=["nuscenes", "waymo", "kitti"])
    p.add_argument("--sam_size", default="vit_h", choices=["vit_h", "vit_l", "vit_b"])
    p.add_argument("--detector", default="detic", choices=("detic", "gdino"))
    for flag in UNPORTED_FLAGS:
        if flag in _SWITCHES:
            p.add_argument(f"--{flag}", action="store_true")
        elif flag == "camera_mesh":
            p.add_argument(f"--{flag}", type=int, default=0)
        else:
            p.add_argument(f"--{flag}", default="")


def refuse_unported(args) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for the first
    unported feature that `args` asks for."""
    for flag, item in UNPORTED_FLAGS.items():
        if getattr(args, flag, None):
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP {item})")
    if args.detector != "detic":
        raise NotImplementedError("--detector gdino is not ported yet (ROADMAP A13)")
    if args.sam_size != "vit_h":
        raise NotImplementedError(
            "--sam_size selects a released checkpoint's encoder; checkpoint loading is "
            "not ported yet (ROADMAP A6) and --fake_weights builds one fixed tiny model")
    if args.dataset != "nuscenes":
        raise NotImplementedError(
            f"--dataset {args.dataset} is not ported yet "
            f"(ROADMAP {'A8' if args.dataset == 'waymo' else 'A9'})")

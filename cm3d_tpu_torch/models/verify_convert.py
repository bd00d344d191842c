"""Checkpoint verification harness. Mirrors
`cm3d_tpu/models/verify_convert.py`.

One command that, pointed at REAL torch checkpoints (the contracts the
reference loads: SAM `sam_vit_h_4b8939.pth`, the Detic
LCOCOI21k_CLIP_SwinB model and CLIP's text tower,
gen_2d_masks_detic.py:30-41,112, ZoeD_N for its depth branch :117, and
GroundingDINO's groundingdino_swint_ogc.pth for its alternative detector,
kitti/gen_2d_masks_detic.py:115-117),
reports BEFORE any pipeline run exactly
where a load would go wrong:

1. **Key coverage**: how many checkpoint keys the port's module reads, and
   which it ignores (an ignored weight is a silent accuracy bug).
2. **Tree conformance**: the converted state dict against the port
   module's own `state_dict()`: missing keys, keys the converter made that
   the module does not have, shape mismatches.
3. **Activation stats** (--probe): per-module output mean/std/absmax on a
   fixed seed-0 probe input, through forward hooks. Run the same probe
   through the reference torch model and diff the two files; the first
   real-checkpoint run becomes a comparison, not a hunt for the fault.

Usage:
  python -m cm3d_tpu_torch.models.verify_convert --sam sam_vit_h_4b8939.pth \\
      [--sam_size vit_h] [--detic Detic_...pth] [--clip clip_text.pth] \\
      [--zoe ZoeD_M12_N.pt] [--gdino groundingdino_swint_ogc.pth] [--probe] \\
      [--out rpt.json] [--device cpu]

Exit code 1 if any tree-conformance problem exists (ignored checkpoint keys
are reported but not fatal: torch checkpoints carry optimizer/EMA extras).
"""

from __future__ import annotations

import json
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

def key_coverage(sd: Dict[str, torch.Tensor], module: nn.Module) -> dict:
    """{consumed: number of `sd` keys the module reads, ignored: the rest}."""
    want = module.state_dict()
    return {"consumed": sum(k in want for k in sd),
            "ignored": sorted(k for k in sd if k not in want)}


def tree_conformance(converted: Dict[str, torch.Tensor], sd: Dict[str, torch.Tensor],
                     module: nn.Module) -> dict:
    """The converted state dict against the module's `state_dict()`:
    missing keys, keys the CONVERTER added that the module does not read
    ("extra"; keys of the checkpoint itself are coverage's "ignored"), and
    shape mismatches."""
    from cm3d_tpu_torch.models.convert import released_report

    rep = released_report(module, converted)
    rep["extra"] = [k for k in rep["extra"] if k not in sd]
    return rep


def activation_stats(module: nn.Module, run: Callable[[], object]) -> Dict[str, dict]:
    """Per-submodule output stats (the first tensor of each output) of one
    `run()`, through forward hooks."""
    out: Dict[str, dict] = {}

    def hook(name):
        def fn(_mod, _inp, output):
            leaves = output if isinstance(output, (tuple, list)) else (output,)
            leaves = [x for x in leaves if isinstance(x, torch.Tensor) and x.numel()]
            if leaves and name not in out:
                x = leaves[0].detach().float().cpu().numpy()
                out[name] = {"shape": list(x.shape), "mean": float(x.mean()),
                             "std": float(x.std()), "absmax": float(np.abs(x).max())}
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in module.named_modules() if n]
    try:
        with torch.inference_mode():
            run()
    finally:
        for h in handles:
            h.remove()
    return out


def _report(module: nn.Module, sd: Dict[str, torch.Tensor],
            converted: Dict[str, torch.Tensor]) -> dict:
    return {"coverage": key_coverage(sd, module),
            "tree": tree_conformance(converted, sd, module)}


def _load(module: nn.Module, converted: Dict[str, torch.Tensor]) -> None:
    from cm3d_tpu_torch.models.convert import load_released_state_dict

    load_released_state_dict(module, converted, verbose=False)


# ---------------------------------------------------------------------------
# Per-model checks
# ---------------------------------------------------------------------------

def verify_sam(sd: Dict[str, torch.Tensor], probe: bool = False, cfg=None,
               device=None) -> dict:
    from cm3d_tpu_torch.models.sam import SAM_VIT_H, Sam
    from cm3d_tpu_torch.utils.device import resolve_device

    cfg = cfg or SAM_VIT_H
    device = resolve_device(device)
    with torch.device(device):
        model = Sam(cfg).eval()
    report = _report(model, sd, sd)
    if probe and not has_problems(report):
        _load(model, sd)
        rng = np.random.default_rng(0)
        img = torch.as_tensor(rng.standard_normal((1, cfg.img_size, cfg.img_size, 3))
                              .astype(np.float32), device=device)
        bx = torch.tensor([[10.0, 20.0, 200.0, 300.0]], device=device)
        report["activations"] = activation_stats(
            model, lambda: model.decode_boxes(model.encode_image(img)[0], bx))
    return report


def verify_detic(sd: Dict[str, torch.Tensor], probe: bool = False, cfg=None,
                 device=None) -> dict:
    from cm3d_tpu_torch.models.convert import detic_state_dict_from_released
    from cm3d_tpu_torch.models.detic import DETIC_SWINB, Detic
    from cm3d_tpu_torch.utils.device import resolve_device

    cfg = cfg or DETIC_SWINB
    device = resolve_device(device)
    with torch.device(device):
        model = Detic(cfg).eval()
    converted = detic_state_dict_from_released(sd, cfg)
    report = _report(model, sd, converted)
    if probe and not has_problems(report):
        _load(model, converted)
        rng = np.random.default_rng(0)
        img = torch.as_tensor(rng.standard_normal((1, 256, 256, 3)).astype(np.float32),
                              device=device)
        clf = rng.standard_normal((cfg.embed_dim, 4)).astype(np.float32)
        clf = torch.as_tensor(clf / np.linalg.norm(clf, axis=0, keepdims=True), device=device)
        report["activations"] = activation_stats(model, lambda: model(img, clf))
    return report


def verify_clip(sd: Dict[str, torch.Tensor], probe: bool = False, cfg=None,
                device=None) -> dict:
    from cm3d_tpu_torch.models.clip_text import CLIP_TEXT_B32, ClipTextEncoder
    from cm3d_tpu_torch.models.convert import clip_state_dict_from_released
    from cm3d_tpu_torch.utils.device import resolve_device

    cfg = cfg or CLIP_TEXT_B32
    device = resolve_device(device)
    with torch.device(device):
        model = ClipTextEncoder(cfg).eval()
    converted = clip_state_dict_from_released(sd)
    report = _report(model, converted, converted)
    if probe and not has_problems(report):
        _load(model, converted)
        rng = np.random.default_rng(0)
        toks = torch.as_tensor(rng.integers(0, min(1000, cfg.vocab_size),
                                            (1, cfg.context_length)), device=device)
        report["activations"] = activation_stats(model, lambda: model(toks))
    return report


def verify_zoe(sd: Dict[str, torch.Tensor], probe: bool = False, cfg=None,
               device=None) -> dict:
    from cm3d_tpu_torch.models.zoedepth import ZOE_N, ZoeDepth, zoedepth_state_dict_from_released
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32_scope

    cfg = cfg or ZOE_N
    device = resolve_device(device)
    with torch.device(device):
        model = ZoeDepth(cfg).eval()
    converted = zoedepth_state_dict_from_released(sd, cfg)
    report = _report(model, sd, converted)
    if probe and not has_problems(report):
        _load(model, converted)
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal((1, *cfg.img_hw, 3)).astype(np.float32),
                            device=device)
        with strict_f32_scope():
            report["activations"] = activation_stats(model, lambda: model(x))
    return report


def verify_gdino(sd: Dict[str, torch.Tensor], probe: bool = False, cfg=None,
                 device=None) -> dict:
    from cm3d_tpu_torch.models.gdino import (
        GDINO_SWINT, GroundingDino, gdino_state_dict_from_released)
    from cm3d_tpu_torch.utils.device import resolve_device, strict_f32_scope

    cfg = cfg or GDINO_SWINT
    device = resolve_device(device)
    with torch.device(device):
        model = GroundingDino(cfg).eval()
    # coverage against the released keys, `module.` stripped
    bare = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    converted = gdino_state_dict_from_released(bare, cfg)
    report = _report(model, bare, converted)
    if probe and not has_problems(report):
        _load(model, converted)
        rng = np.random.default_rng(0)
        h, w = cfg.img_hw
        n = cfg.max_text_len
        x = torch.as_tensor(rng.standard_normal((1, h, w, 3)).astype(np.float32), device=device)
        ids = torch.as_tensor(rng.integers(1, cfg.bert.vocab_size, (1, n)), device=device)
        pos = torch.arange(n, device=device)[None]
        mask = torch.ones((1, n, n), dtype=torch.bool, device=device)
        with strict_f32_scope():
            report["activations"] = activation_stats(
                model, lambda: model(x, ids, pos, mask, mask[:, 0]))
    return report


def has_problems(report: dict) -> bool:
    t = report["tree"]
    return bool(t["missing"] or t["extra"] or t["mismatched"])


def main(argv=None) -> int:
    import argparse
    import functools

    from cm3d_tpu_torch.models.convert import load_torch_state_dict
    from cm3d_tpu_torch.models.sam import sam_config_for

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sam", default="")
    p.add_argument("--sam_size", default="vit_h", choices=["vit_h", "vit_l", "vit_b"],
                   help="SAM encoder scale matching --sam")
    p.add_argument("--detic", default="")
    p.add_argument("--clip", default="")
    p.add_argument("--zoe", default="", help="ZoeD_N checkpoint")
    p.add_argument("--gdino", default="", help="GroundingDINO groundingdino_swint_ogc.pth")
    p.add_argument("--probe", action="store_true",
                   help="also dump per-module activation stats")
    p.add_argument("--out", default="", help="write the full report JSON here")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cpu)")
    args = p.parse_args(argv)

    full = {}
    rc = 0
    for name, path, fn in [
        ("sam", args.sam, functools.partial(verify_sam, cfg=sam_config_for(args.sam_size))),
        ("detic", args.detic, verify_detic),
        ("clip", args.clip, verify_clip),
        ("zoe", args.zoe, verify_zoe),
        ("gdino", args.gdino, verify_gdino),
    ]:
        if not path:
            continue
        rep = fn(load_torch_state_dict(path), probe=args.probe, device=args.device)
        full[name] = rep
        t = rep["tree"]
        print(f"[{name}] consumed={rep['coverage']['consumed']} "
              f"ignored={len(rep['coverage']['ignored'])} "
              f"missing={len(t['missing'])} extra={len(t['extra'])} "
              f"mismatched={len(t['mismatched'])}")
        for kind in ("missing", "extra", "mismatched"):
            for item in t[kind][:20]:
                print(f"  {kind}: {item}")
        for item in rep["coverage"]["ignored"][:20]:
            print(f"  ignored ckpt key: {item}")
        if has_problems(rep):
            rc = 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(full, f, indent=1)
        print(f"report -> {args.out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""One-command conformance runbook: day-one with real weights. Mirrors
`cm3d_tpu/conform.py` on the port's modules.

The reference pipeline assumes the released Detic/SAM/CLIP checkpoints
(src/nuscenes/gen_2d_masks_detic.py:30-41,112). The repository holds none,
so every accuracy envelope is pinned at fixture scale; the day real
checkpoints and a dataroot arrive, THIS is the command that turns them into
a parity report:

    python -m cm3d_tpu_torch.conform --sam sam_vit_h_4b8939.pth \\
        --detic Detic_LCOCO....pth --clip clip_text.pth \\
        --bpe bpe_simple_vocab_16e6.txt.gz \\
        --dataroot /data/nuScenes --version v1.0-mini \\
        --scenes scene-0061 --out conform/

Phases (each recorded in ``{out}/conform_report.json``):

1. **verify**: every torch checkpoint through the port's
   models/verify_convert.py harness (key coverage, tree conformance,
   optional --probe activation stats); full per-model reports land in
   ``{out}/verify_{name}.json``. Already-converted directories skip this.
2. **convert**: the converted state dicts (models/convert.py: detectron2's
   fc1 order for Detic, CLIP's text tower keys; a SAM file loads as it is;
   ZoeDepth's relative-position tables at the config's grid) saved with
   `models/checkpoints.py save_params` under ``{out}/converted/``, the
   directories the model CLIs load; with --quant_int8 also the int8 SAM and
   Detic state dicts under ``*_int8`` beside them, which the e2e phase then
   loads.
3. **e2e**: the fused images->masks->boxes pipeline (pipelines/e2e.py)
   over ``--scenes`` of the given dataroot, LOADING THE CONVERTED TREES,
   writing ``{out}/pseudolabels.json``.
4. **eval**: the submission through the devkit-parity evaluator
   (eval/__main__.py) against the dataroot's GT; the metrics dict
   (mAP/NDS/per-class APs) goes into the report. Compare against the
   reference's published 23.0 mAP / 22.1 NDS (BASELINE.md) to close the
   accuracy-parity question.

Exit code: 1 if any verify phase found tree problems or a phase raised;
0 otherwise. ``--skip_pipeline`` / ``--skip_eval`` run the earlier
phases only (e.g. checkpoints present but no dataroot yet). A
GroundingDINO checkpoint (``--gdino``, with ``--gdino_vocab``) is verified,
converted and saved as ``gdino_swint`` (and ``gdino_swint_int8``), and the
e2e phase runs with ``--detector gdino``. ``--device`` (CUDA unless it says
otherwise) is where verify and e2e run.

Tested in tests/test_torch_conform.py with fixture-scale checkpoints and
stubbed pipeline phases.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import traceback
from pathlib import Path

def model_specs(sam_size: str = "vit_h", cfg_overrides: dict | None = None, device=None):
    """Per-family (load, verify, convert, save-name) wiring. cfg_overrides
    maps family name -> model config, used by tests to run the real
    verify/convert phases at fixture scale."""
    from cm3d_tpu_torch.models.convert import (
        clip_state_dict_from_released,
        detic_state_dict_from_released,
        load_torch_state_dict,
    )
    from cm3d_tpu_torch.models.detic import DETIC_SWINB, quantize_detic_state_dict
    from cm3d_tpu_torch.models.gdino import (
        GDINO_SWINT, gdino_state_dict_from_released, quantize_gdino_state_dict)
    from cm3d_tpu_torch.models.sam import quantize_sam_state_dict, sam_config_for
    from cm3d_tpu_torch.models.verify_convert import (
        verify_clip,
        verify_detic,
        verify_gdino,
        verify_sam,
        verify_zoe,
    )
    from cm3d_tpu_torch.models.zoedepth import ZOE_N, zoedepth_state_dict_from_released

    ov = cfg_overrides or {}

    def verify(fn, name, default=None):
        return functools.partial(fn, cfg=ov.get(name, default), device=device)

    return {
        "sam": dict(
            load=load_torch_state_dict,
            verify=verify(verify_sam, "sam", sam_config_for(sam_size)),
            convert=lambda sd: sd,  # a released SAM file loads as it is
            quantize=quantize_sam_state_dict,
            save=f"sam_{sam_size}",
        ),
        "detic": dict(
            load=load_torch_state_dict,
            verify=verify(verify_detic, "detic"),
            convert=functools.partial(detic_state_dict_from_released,
                                      cfg=ov.get("detic", DETIC_SWINB)),
            quantize=quantize_detic_state_dict,
            save="detic_swinb",
        ),
        "clip": dict(
            load=load_torch_state_dict,
            verify=verify(verify_clip, "clip"),
            convert=clip_state_dict_from_released,
            quantize=None,
            save="clip_text",
        ),
        "zoe": dict(
            load=load_torch_state_dict,
            verify=verify(verify_zoe, "zoe", ZOE_N),
            convert=functools.partial(zoedepth_state_dict_from_released,
                                      cfg=ov.get("zoe", ZOE_N)),
            quantize=None,
            save="zoedepth_n",
        ),
        "gdino": dict(
            load=load_torch_state_dict,
            verify=verify(verify_gdino, "gdino"),
            convert=functools.partial(gdino_state_dict_from_released,
                                      cfg=ov.get("gdino", GDINO_SWINT)),
            quantize=quantize_gdino_state_dict,
            save="gdino_swint",
        ),
    }


def _verify_and_convert(name: str, path: str, spec: dict, out: Path,
                        probe: bool, quant_int8: bool = False) -> dict:
    """Phases 1+2 for one checkpoint. Returns the report entry; raises
    nothing (failures are captured as entry['error'])."""
    from cm3d_tpu_torch.models.checkpoints import save_params
    from cm3d_tpu_torch.models.verify_convert import has_problems

    entry: dict = {"path": path}
    if os.path.isdir(path):
        # an already-converted directory (save_params): nothing to verify
        # or convert; the e2e phase loads it as it is
        entry.update(kind="converted", verify="skipped", converted=path,
                     ok=True)
        return entry
    entry["kind"] = "torch"
    try:
        sd = spec["load"](path)
        rep = spec["verify"](sd, probe=probe)
        verify_path = out / f"verify_{name}.json"
        with open(verify_path, "w") as f:
            json.dump(rep, f, indent=1)
        t = rep["tree"]
        entry["verify"] = {
            "consumed": rep["coverage"]["consumed"],
            "ignored": len(rep["coverage"]["ignored"]),
            "missing": len(t["missing"]),
            "extra": len(t["extra"]),
            "mismatched": len(t["mismatched"]),
            "report": str(verify_path),
        }
        entry["ok"] = not has_problems(rep)

        params = spec["convert"](sd)
        conv_dir = out / "converted" / spec["save"]
        save_params(params, str(conv_dir), overwrite=True)
        entry["converted"] = str(conv_dir)
        if quant_int8 and spec["quantize"] is not None:
            qdir = out / "converted" / f"{spec['save']}_int8"
            save_params(spec["quantize"](params), str(qdir), overwrite=True)
            entry["converted_int8"] = str(qdir)
    except Exception as e:  # a broken checkpoint must not kill the report
        entry["ok"] = False
        entry["error"] = f"{type(e).__name__}: {e}"
        entry["traceback"] = traceback.format_exc(limit=8)
    return entry


# phase seams (tests stub these; production resolves the real CLIs)
def _e2e_main(argv):
    from cm3d_tpu_torch.pipelines.e2e import main

    return main(argv)


def _eval_main(argv):
    from cm3d_tpu_torch.eval.__main__ import main

    return main(argv)


def run_conform(args, cfg_overrides: dict | None = None) -> tuple[dict, int]:
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report: dict = {"out": str(out), "models": {}, "phases": []}
    rc = 0

    device = args.device
    specs = model_specs(args.sam_size, cfg_overrides, device)
    given = [(n, p) for n, p in [
        ("sam", args.sam), ("detic", args.detic), ("clip", args.clip),
        ("zoe", args.zoe), ("gdino", args.gdino),
    ] if p]
    for name, path in given:
        entry = _verify_and_convert(name, path, specs[name], out, args.probe,
                                    args.quant_int8)
        report["models"][name] = entry
        if not entry.get("ok", False):
            rc = 1
        report["phases"].append(f"verify+convert:{name}")

    def converted(name):
        e = report["models"].get(name, {})
        if args.quant_int8 and "converted_int8" in e:
            return e["converted_int8"]
        return e.get("converted", "")

    sub_path = str(out / "pseudolabels.json")
    if args.skip_pipeline or not args.dataroot:
        report["e2e"] = {"skipped": True}
    else:
        e2e_argv = [
            "--dataset", args.dataset, "--dataroot", args.dataroot,
            "--version", args.version, "--scenes", args.scenes,
            "--out", sub_path, "--sam_size", args.sam_size,
        ]
        if args.fake_weights:
            e2e_argv += ["--fake_weights"]
        else:
            e2e_argv += [
                "--detic_ckpt", converted("detic"),
                "--sam_ckpt", converted("sam"),
                "--clip_ckpt", converted("clip"),
            ]
            if args.bpe:
                e2e_argv += ["--bpe_path", args.bpe]
        if args.quant_int8:
            e2e_argv += ["--quant_int8"]
        if device:
            e2e_argv += ["--device", device]
        if args.gdino:
            e2e_argv += ["--detector", "gdino",
                         "--gdino_ckpt", converted("gdino")]
            if args.gdino_vocab:
                e2e_argv += ["--gdino_vocab", args.gdino_vocab]
        try:
            _e2e_main(e2e_argv)
            report["e2e"] = {"out": sub_path, "argv": e2e_argv}
            if args.dataset == "nuscenes":
                # only nuScenes e2e writes a submission JSON; Waymo writes
                # a metrics_pb2.Objects .bin, KITTI a label dir — summarize
                # those by artifact size instead of mis-parsing them
                with open(sub_path) as f:
                    sub = json.load(f)
                report["e2e"].update(
                    n_samples=len(sub.get("results", {})),
                    n_boxes=sum(len(v)
                                for v in sub.get("results", {}).values()),
                )
            elif os.path.isfile(sub_path):
                report["e2e"]["artifact_bytes"] = os.path.getsize(sub_path)
            elif os.path.isdir(sub_path):
                # KITTI e2e writes a label DIR; size = sum of its files
                report["e2e"]["artifact_bytes"] = sum(
                    f.stat().st_size for f in Path(sub_path).rglob("*")
                    if f.is_file()
                )
            else:
                # the phase "succeeded" but produced nothing — that is a
                # failure, not a null (a conformance gate must not pass
                # with no artifact)
                raise FileNotFoundError(
                    f"e2e wrote no artifact at {sub_path}"
                )
        except Exception as e:
            rc = 1
            report["e2e"] = {"error": f"{type(e).__name__}: {e}",
                             "argv": e2e_argv,
                             "traceback": traceback.format_exc(limit=8)}
        report["phases"].append("e2e")

    if args.skip_eval or not args.dataroot or "error" in report.get(
            "e2e", {}) or report["e2e"].get("skipped"):
        report["eval"] = {"skipped": True}
    elif args.dataset != "nuscenes":
        # the eval phase runs the nuScenes evaluator; Waymo bins go
        # through the metrics CLI (eval/waymo_metrics.py) with a GT bin
        # the runbook does not have, and KITTI's label dir through
        # eval/kitti.py with the split's label_2
        report["eval"] = {
            "skipped": True,
            "reason": f"no {args.dataset} eval phase in the runbook; "
            "score the artifact with eval/waymo_metrics.py + a GT bin "
            "(create_gt_bin) for waymo",
        }
    else:
        eval_argv = [
            sub_path, "--output_dir", str(out / "metrics"),
            "--eval_set", args.scenes, "--dataroot", args.dataroot,
            "--version", args.version, "--verbose", "0",
        ]
        try:
            metrics = _eval_main(eval_argv)
            report["eval"] = {
                "mAP": metrics.get("mean_ap"),
                "NDS": metrics.get("nd_score"),
                "output_dir": str(out / "metrics"),
                "reference_headline": {
                    "mAP": 23.0, "NDS": 22.1,
                    "source": "BASELINE.md (reference index.html:199-218)",
                },
            }
        except Exception as e:
            rc = 1
            report["eval"] = {"error": f"{type(e).__name__}: {e}",
                              "traceback": traceback.format_exc(limit=8)}
        report["phases"].append("eval")

    report["ok"] = rc == 0
    with open(out / "conform_report.json", "w") as f:
        json.dump(report, f, indent=1)
    return report, rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sam", default="")
    p.add_argument("--sam_size", default="vit_h",
                   choices=["vit_h", "vit_l", "vit_b"])
    p.add_argument("--detic", default="")
    p.add_argument("--clip", default="")
    p.add_argument("--bpe", default="",
                   help="CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz)")
    p.add_argument("--zoe", default="")
    p.add_argument("--gdino", default="")
    p.add_argument("--gdino_vocab", default="",
                   help="bert-base-uncased vocab.txt")
    p.add_argument("--probe", action="store_true",
                   help="verify with per-module activation stats")
    p.add_argument("--quant_int8", action="store_true",
                   help="also save int8 SAM / Detic state dicts (*_int8) and run the "
                   "e2e phase on them with --quant_int8")
    p.add_argument("--dataset", default="nuscenes",
                   choices=["nuscenes", "waymo", "kitti"])
    p.add_argument("--dataroot", default="",
                   help="dataset root; omit to stop after verify+convert")
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--scenes", default="",
                   help="comma-separated scene names for the mini e2e run")
    p.add_argument("--out", required=True)
    p.add_argument("--fake_weights", action="store_true",
                   help="run the pipeline phases with the test-scale "
                   "fake models (hermetic dry run of the runbook itself)")
    p.add_argument("--skip_pipeline", action="store_true")
    p.add_argument("--skip_eval", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the verify and e2e phases (cuda, cpu)")
    args = p.parse_args(argv)

    if args.dataroot and not args.scenes and not args.skip_pipeline:
        p.error("--scenes is required when --dataroot is given")

    report, rc = run_conform(args)
    for name, e in report["models"].items():
        v = e.get("verify")
        status = "ok" if e.get("ok") else f"PROBLEMS ({e.get('error', v)})"
        print(f"[{name}] {status} -> {e.get('converted', '-')}")
    if not report["e2e"].get("skipped"):
        e = report["e2e"]
        print("[e2e]", e.get("error") or
              f"{e['n_samples']} samples, {e['n_boxes']} boxes -> "
              f"{e['out']}")
    if not report["eval"].get("skipped"):
        e = report["eval"]
        print("[eval]", e.get("error") or
              f"mAP={e['mAP']} NDS={e['NDS']} (reference 23.0/22.1)")
    print(f"report -> {Path(args.out) / 'conform_report.json'}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

"""Shape-prior extractor: mean GT box sizes per category -> shape_priors.json.
Mirrors `cm3d_tpu/pipelines/get_priors.py` (host only).

Rebuild of src/nuscenes/get_priors.py (:20-74). Reference quirks kept:
- the FIRST occurrence of each category is dropped (the reference appends
  only on the `else` branch of the dict-initialization check, :53-58);
- the sample chain stops BEFORE the last sample of each scene
  (`while sample["next"] != ""`, :38).

The JSON maps full category names to [w, l, h]; `config.load_priors_file`
reads it (`LiftStageConfig.priors_file`).

Usage:
  python -m cm3d_tpu_torch.pipelines.get_priors --dataroot D --version V \\
      [--out shape_priors.json]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np


def compute_priors(dataroot: str, version: str) -> Dict[str, list]:
    from cm3d_tpu_torch.datasets.nuscenes import NuScenesTables

    nusc = NuScenesTables(dataroot, version)
    # the port's tables treat sample_annotation as optional (v1.0-test has
    # none); priors need it, and an empty table would silently give {}
    if not (nusc.dataroot / version / "sample_annotation.json").exists():
        raise FileNotFoundError(
            f"{nusc.dataroot / version} has no sample_annotation table: shape priors "
            f"are mean GT box sizes, so they need an annotated split (not v1.0-test)")
    size_dict: Dict[str, List[list]] = {}
    for scene in nusc.table("scene"):
        sample = nusc.get("sample", scene["first_sample_token"])
        while sample["next"] != "":  # reference quirk: last sample skipped
            for token in sample["anns"]:
                ann = nusc.get("sample_annotation", token)
                cat = ann["category_name"]
                if cat not in size_dict:
                    size_dict[cat] = []  # reference quirk: first one dropped
                else:
                    size_dict[cat].append(ann["size"])
            sample = nusc.get("sample", sample["next"])

    avg = {}
    for key, sizes in size_dict.items():
        if sizes:
            mean = np.mean(sizes, axis=0)
            print("{:<10} {:<10}".format(key, str(mean)))
            avg[key] = [float(v) for v in mean]
    return avg


def main(argv=None):
    p = argparse.ArgumentParser(description="mean GT box sizes per category")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--out", default="shape_priors.json")
    args = p.parse_args(argv)
    avg = compute_priors(args.dataroot, args.version)
    with open(args.out, "w") as f:
        json.dump(avg, f)
    print(f"wrote {len(avg)} categories to {args.out}")


if __name__ == "__main__":
    main()

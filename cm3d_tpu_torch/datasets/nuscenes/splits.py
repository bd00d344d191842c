"""nuScenes data splits, including the reference's custom eval splits.

Rebuild of the reference's create_splits_scenes (eval_custom.py:266-294),
which extends the devkit's standard splits with slice-based custom splits:
train_detect50 = train_detect[:50], train_detect25 = train_detect[175:200],
val25 = val[:25], train25 = train[:10].

Split data provenance (zero-egress build — no devkit wheel available):

- VAL / MINI_TRAIN / MINI_VAL are the official public lists, embedded. They
  are validated at use time against the dataroot's scene table
  (`validate_against_tables`): every name must exist, and for v1.0-trainval
  the complement must have exactly 700 scenes. A mismatch raises with
  directions instead of silently mis-evaluating.
- TRAIN and TEST are derived, not embedded: the devkit's lists are in
  ascending scene order, so train == sorted(trainval_scenes - VAL) and
  test == sorted(test_scenes) reproduce them exactly given a dataroot.
- train_detect / train_track (the randomized halves of train) are NOT
  reconstructible offline; supply them via a splits JSON file
  ({"train_detect": [...], "train_track": [...]}) — e.g. dumped from the
  devkit's nuscenes.utils.splits — through --splits_json or
  $NUSCENES_SPLITS_JSON. A splits JSON may also override any other split.

Note the known official quirk: mini_train overlaps val (scene-0553 and
scene-0796 are in both) — mini_train is NOT a subset of train.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

# Official nuScenes val split (150 scenes, ascending).
VAL: tuple[str, ...] = tuple(
    f"scene-{n:04d}"
    for n in (
        list(range(3, 4))
        + list(range(12, 19))
        + [35, 36, 38, 39]
        + list(range(92, 111))
        + [221]
        + list(range(268, 279))
        + list(range(329, 333))
        + list(range(344, 347))
        + list(range(519, 525))
        + list(range(552, 566))
        + [625, 626, 627, 629, 630]
        + list(range(632, 639))
        + [770, 771, 775, 777, 778]
        + list(range(780, 785))
        + list(range(794, 801))
        + [802]
        + list(range(904, 918))
        + list(range(919, 932))
        + [962, 963, 966, 967, 968, 969, 971, 972]
        + list(range(1059, 1074))
    )
)

MINI_TRAIN: tuple[str, ...] = (
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
)
MINI_VAL: tuple[str, ...] = ("scene-0103", "scene-0916")

assert len(VAL) == 150 and len(set(VAL)) == 150 and list(VAL) == sorted(VAL)
assert set(MINI_VAL) <= set(VAL)

# Split names whose data requires a dataroot (derived) or a splits JSON.
_DERIVED = ("train", "test", "train_detect", "train_track")


def _load_splits_json(splits_json: Optional[str]) -> Dict[str, List[str]]:
    path = splits_json or os.environ.get("NUSCENES_SPLITS_JSON", "")
    if not path:
        return {}
    with open(os.path.expanduser(path)) as f:
        out = {k: list(v) for k, v in json.load(f).items()}
    empty = sorted(k for k, v in out.items() if not v)
    if empty:
        # an empty override list is always a malformed file, and an empty
        # 'val' in particular would make the full-val-present check
        # vacuously true and silently derive train as ALL scenes —
        # including the real val scenes (the exact leak the derivation
        # guard exists to prevent)
        raise ValueError(
            f"{path}: split override(s) {empty} are empty lists — remove "
            "the key(s) or supply the scene names"
        )
    return out


def create_splits_scenes(
    scene_names: Optional[Sequence[str]] = None,
    splits_json: Optional[str] = None,
) -> Dict[str, List[str]]:
    """Split name -> scene names (reference eval_custom.py:266-294).

    Args:
      scene_names: all scene names present in the loaded version's tables
        (enables the derived train/test splits and validates VAL).
      splits_json: optional JSON overriding/providing any split (required
        for train_detect* since those halves are randomized upstream).
    """
    override = _load_splits_json(splits_json)
    out: Dict[str, List[str]] = {
        "val": list(VAL),
        "mini_train": list(MINI_TRAIN),
        "mini_val": list(MINI_VAL),
    }
    # an overriding 'val' must replace the embedded list BEFORE train is
    # derived as its complement — deriving first and updating after let a
    # corrected val silently leak scenes into train/train25
    if "val" in override:
        out["val"] = list(override["val"])
    if scene_names is not None:
        names = sorted(set(scene_names))
        val_set = set(out["val"])
        n_val = sum(1 for s in names if s in val_set)
        # val_set non-empty is guaranteed by _load_splits_json's empty-list
        # rejection; keep the guard so a future caller can't derive
        # train = ALL scenes from a vacuously-satisfied check
        if val_set and n_val == len(val_set):  # full val present -> derive
            train = [s for s in names if s not in val_set]
            if "val" not in override and len(train) != 700:
                # the documented contract: with the EMBEDDED v1.0-trainval
                # val list, the complement is exactly the 700 train scenes;
                # anything else is a partial/mixed dataroot and deriving a
                # silent partial train split corrupts training downstream
                raise ValueError(
                    f"trainval tables contain all {len(val_set)} val scenes "
                    f"but a {len(train)}-scene train complement (expected "
                    "700) — partial dataroot? Supply explicit lists via "
                    "--splits_json / $NUSCENES_SPLITS_JSON to proceed"
                )
            out["train"] = train
        elif n_val == 0 and len(names) == 150:  # test tables
            out["test"] = names
    out.update(override)

    # Custom slice splits (reference :283-286). train25 is 10 scenes —
    # the reference's own slice bound, reproduced as-is.
    if "val" in out:
        out["val25"] = out["val"][:25]
    if "train" in out:
        out["train25"] = out["train"][:10]
    if "train_detect" in out:
        out["train_detect50"] = out["train_detect"][:50]
        out["train_detect25"] = out["train_detect"][175:200]
    return out


def validate_against_tables(
    split: str, scenes: List[str], scene_names: Sequence[str]
) -> None:
    """Hard-validate a split against the loaded tables; raise, don't guess."""
    available = set(scene_names)
    missing = [s for s in scenes if s not in available]
    if missing:
        raise ValueError(
            f"split '{split}': {len(missing)} scene(s) not in the loaded "
            f"tables (first: {missing[:3]}). If the embedded split data "
            "disagrees with your dataset release, supply the official lists "
            "via --splits_json / $NUSCENES_SPLITS_JSON "
            "(json.dump(nuscenes.utils.splits.create_splits_scenes(), f))."
        )


def resolve_eval_set(
    eval_set: str,
    scene_names: Optional[Sequence[str]] = None,
    splits_json: Optional[str] = None,
) -> List[str]:
    """Resolve an --eval_set value to scene names.

    Accepts a split name (val, val25, mini_val, train, train25,
    train_detect50, ...), "all" (every scene in the tables), or a
    comma-separated list of explicit scene names.
    """
    if eval_set == "all":
        if scene_names is None:
            raise ValueError("--eval_set all requires a dataroot")
        return sorted(set(scene_names))
    splits = create_splits_scenes(scene_names, splits_json)
    if eval_set in splits:
        scenes = splits[eval_set]
        if scene_names is not None:
            validate_against_tables(eval_set, scenes, scene_names)
        return scenes
    if eval_set in _DERIVED or eval_set in ("train_detect50", "train_detect25",
                                            "train25"):
        raise ValueError(
            f"split '{eval_set}' needs "
            + ("a dataroot (derived from the scene tables)"
               if eval_set in ("train", "test", "train25")
               else "a splits JSON with the official train_detect list "
                    "(--splits_json / $NUSCENES_SPLITS_JSON)")
        )
    # explicit comma-separated scene names: tolerate whitespace and
    # validate against the tables when they are available — a typo'd or
    # space-padded name otherwise matches zero scenes and the eval
    # silently runs over nothing
    scenes = [s.strip() for s in eval_set.split(",") if s.strip()]
    if not scenes:
        raise ValueError(f"--eval_set {eval_set!r} names no scenes")
    if scene_names is not None:
        validate_against_tables(eval_set, scenes, scene_names)
    return scenes

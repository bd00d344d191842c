"""The comparison that decides `correct`: what the timed path produced,
against the plain reference run on the same inputs and weights.

Imports nothing of the program: it reads the program's outputs (captured
tensors and delivered boxes) only to judge them. Every number compared has
its limit in limits/<cell>.json, set from the readings that PERF.md gives.

e2e cells, for each sampled keyframe:
- the detector's numbers (its module's `compare`: detectors/<name>.py).
- sam_embed_rel: SAM's image embeddings, relative L2 gap.
- prompt_mismatch: prompt boxes and counts the host NMS and caps handed to
  the decode against the reference's own, values that differ (exact).
- mask_flip_share: the decoded masks before the content swap, pixels that
  differ over pixels in either.
- box_mismatch_share: the lift's boxes from the swapped planes: masks whose
  keep, label, size, yaw (1e-4 rad) or centre (1 mm) differ, over valid masks.
The lift cell compares box_mismatch_share over its sampled steps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import lift as ref_lift
from perfbench.reference import models as ref_models
from perfbench.reference.tables import (CLASS_TO_ID, PIXEL_MEAN, PIXEL_STD, VOCABULARY,
                                        WORD_TO_CLASS, class_arrays)

CENTER_TOL_M = 1e-3
YAW_TOL = 1e-4


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def skeleton(det, cfg: dict) -> dict:
    """{prefix: plain reference module} on `meta`: the detector's (its
    module `det`'s), then SAM's, the order in which weights.make_state
    draws them."""
    with torch.device("meta"):
        return {**det.skeleton(cfg), "sam": ref_models.Sam(cfg["sam"])}


def build_reference(det, cfg: dict, state: dict, device):
    """({prefix: module} of the reference detector, SAM) in float32,
    holding the run's weights."""
    ref = {}
    for prefix, module in skeleton(det, cfg).items():
        module = module.to_empty(device=device)
        module.load_state_dict({k: v.float() for k, v in state[prefix].items()})
        ref[prefix] = module.eval()
    sam = ref.pop("sam")
    return ref, sam


def set_precision(det, ref, sam, cfg: dict, control: bool):
    """The reference at the configuration's precisions (float32 for its
    bfloat16 layers, w8a8 for its int8 ones), or the control one step
    below each (float8, w4a4)."""
    det.set_precision(ref, cfg, control)
    quant = ref_models.sam_int8_layers(sam) if cfg["modes"]["quant_int8"] else set()
    ref_models.set_precision_(sam, ref_models.SAM_F32_LAYERS, quant, 4 if control else 8,
                              control)


def normalised(images: np.ndarray, device) -> torch.Tensor:
    x = torch.from_numpy(images).to(device).float()
    return (x - torch.from_numpy(PIXEL_MEAN).to(device)) / torch.from_numpy(PIXEL_STD).to(device)


def classwise_nms(boxes, scores, labels, iou_thresh):
    """Greedy class-wise NMS on the host (gen_2d_masks_detic.py:348-372)."""
    keep = []
    boxes = np.asarray(boxes, np.float64)
    for cls in sorted(set(labels)):
        idx = sorted([i for i, lab in enumerate(labels) if lab == cls], key=lambda i: -scores[i])
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
                inter = max(min(x2, boxes[j][2]) - max(x1, boxes[j][0]), 0) \
                    * max(min(y2, boxes[j][3]) - max(y1, boxes[j][1]), 0)
                aj = max(boxes[j][2] - boxes[j][0], 0) * max(boxes[j][3] - boxes[j][1], 0)
                union = ai + aj - inter
                if union and inter / union > iou_thresh:
                    alive.discard(j)
    return keep


def prompts(dets: dict, mask_cfg: dict):
    """The decode's prompts from a frame's detections: class-wise NMS, the
    per-camera and per-frame caps (lowest scores dropped), then the
    smallest prompt bucket that holds the busiest camera. Returns
    (prompts [C, bucket, 4], n_boxes [C], labels, scores, cams)."""
    c, p = dets["boxes"].shape[0], mask_cfg["max_detections"]
    cap, total = mask_cfg["max_masks_total"], 0
    out = np.zeros((c, p, 4), np.float32)
    n_boxes = np.zeros(c, np.int64)
    labels, scores, cams = [], [], []
    for ci in range(c):
        v = dets["valid"][ci]
        boxes, sc = dets["boxes"][ci][v], dets["scores"][ci][v]
        names = [WORD_TO_CLASS[VOCABULARY[i]] for i in dets["class_ids"][ci][v]]
        if not len(boxes):
            continue
        kept = classwise_nms(boxes, sc, names, mask_cfg["nms_iou"])
        boxes, sc, names = boxes[kept], sc[kept], [names[i] for i in kept]
        k = min(min(len(boxes), p), max(cap - total, 0))
        if k <= 0:
            continue
        if k < len(boxes):
            top = np.sort(np.argsort(-sc, kind="stable")[:k])
            boxes, sc, names = boxes[top], sc[top], [names[i] for i in top]
        out[ci, :k] = boxes[:k]
        n_boxes[ci] = k
        labels += names[:k]
        scores += [float(s) for s in sc[:k]]
        cams += [ci] * k
        total += k
    bucket = next((b for b in sorted(mask_cfg["prompt_buckets"]) if b >= n_boxes.max()), p)
    return out[:, :bucket], n_boxes, labels, scores, cams


def decode_masks(sam, emb, prompt_boxes, n_boxes, cam_hw, img_size: int) -> torch.Tensor:
    """Box-prompted masks of every camera, camera-major: [M, W, H] bool
    (logits upsampled bilinearly to the image, thresholded at 0)."""
    out = []
    for c in range(emb.shape[0]):
        n = int(n_boxes[c])
        if not n:
            continue
        h, w = cam_hw
        scale = img_size / max(h, w)
        boxes = torch.from_numpy(prompt_boxes[c, :n] * scale).to(emb.device)
        logits = sam.decode_boxes(emb[c], boxes)
        hm, wm = logits.shape[-2:]
        rect = emb.shape[1] != emb.shape[2]
        up_hw = (4 * hm, 4 * wm) if rect else (max(h, w),) * 2
        up = F.interpolate(logits[:, None], size=up_hw, mode="bilinear", align_corners=False)
        out.append((up[:, 0, :h, :w] > 0).transpose(1, 2))
    return torch.cat(out)


def lift_inputs(kfs: list, planes: list, meta: list, device) -> dict:
    """A batch of the lift's inputs as device tensors: the frames' arrays,
    with the given planes and (label, score, cam) metadata where given."""
    out = {}
    for key in kfs[0]:
        if key == "mask_bits":
            out[key] = torch.stack([torch.as_tensor(np.asarray(p).view(np.int32)
                                                    if isinstance(p, np.ndarray) else p)
                                    .to(device) for p in planes])
        else:
            out[key] = torch.from_numpy(np.stack([kf[key] for kf in kfs])).to(device)
    for b, mm in enumerate(meta):
        if mm is None:
            continue
        labels, scores, cams = mm
        m = out["mask_cam"].shape[1]
        n = min(len(labels), m)
        for key in ("mask_cam", "mask_label", "mask_score", "mask_valid"):
            out[key][b] = 0
        out["mask_cam"][b, :n] = torch.tensor(cams[:n], dtype=out["mask_cam"].dtype)
        out["mask_label"][b, :n] = torch.tensor([CLASS_TO_ID[x] for x in labels[:n]],
                                                dtype=out["mask_label"].dtype)
        out["mask_score"][b, :n] = torch.tensor(scores[:n], dtype=out["mask_score"].dtype)
        out["mask_valid"][b, :n] = True
    return out


def lift_boxes(f: dict, lift: dict, coord_dtype=torch.float32):
    dev = f["points"].device
    priors, is_vehicle, radius_sq = (torch.from_numpy(a).to(dev) for a in class_arrays())
    return ref_lift.lift_and_box(f, lift, priors, is_vehicle, radius_sq, coord_dtype)


def box_mismatch(prog: dict, ref: ref_lift.RefBoxes, valid: torch.Tensor) -> tuple:
    """(mismatched masks, valid masks) between the program's boxes (numpy
    BoxOutputs fields, [B, M, ...]) and the reference's."""
    dev = ref.keep.device
    p = {k: torch.as_tensor(np.asarray(prog[k])).to(dev)
         for k in ("centers", "sizes", "yaws", "labels", "keep")}
    keep_diff = p["keep"].bool() != ref.keep
    both = p["keep"].bool() & ref.keep
    geo = ((p["centers"].double() - ref.centers.double()).norm(dim=-1) > CENTER_TOL_M) \
        | ((p["sizes"].double() - ref.sizes.double()).abs().amax(-1) > 1e-6) \
        | ((p["yaws"].double() - ref.yaws.double()).abs() > YAW_TOL) \
        | (p["labels"].long() != ref.labels.long())
    bad = (keep_diff | (both & geo)) & valid
    return int(bad.sum()), int(valid.sum())


def model_side(det, ref, sam, text, images, cfg, prog=None):
    """What the reference models give for one keyframe's images: the
    detector's outputs (its module's `reference_side`, from `prog`'s where
    it takes the program's), and SAM's embedding."""
    x = normalised(images, next(sam.parameters()).device)
    out = det.reference_side(ref, text, images, x, cfg, prog)
    with torch.no_grad():
        s = cfg["sam"]
        xs = x
        if not s["rect_encode"]:
            xs = F.pad(x, (0, 0, 0, s["img_size"] - x.shape[2], 0, s["img_size"] - x.shape[1]))
        out["embedding"] = torch.cat([sam.image_encoder(xs[i:i + 1]) for i in range(xs.shape[0])])
    return out


def program_side(det, cap: dict) -> dict:
    """The captured outputs of the timed path, in model_side's layout."""
    return {**det.program_side(cap), "embedding": cap["embedding"]}


def compare_models(det, prog: dict, ref: dict) -> dict:
    return {**det.compare(prog, ref), "sam_embed_rel": rel(prog["embedding"], ref["embedding"])}


def worst(rows: list) -> dict:
    """Each number's worst reading over the sample (shares are pooled)."""
    out = {}
    for r in rows:
        for k, v in r.items():
            if k.endswith("_counts"):
                continue
            out[k] = max(out.get(k, -np.inf), v)
    for key in ("mask_flip", "box_mismatch"):
        pairs = [r[f"{key}_counts"] for r in rows if f"{key}_counts" in r]
        if pairs:
            out[f"{key}_share"] = sum(a for a, _ in pairs) / max(sum(b for _, b in pairs), 1)
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number the
    cell's limits name was read and none exceeds its limit."""
    table = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(v["value"] is not None and np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table

"""Detic Swin-B (Detic_LCOCOI21k_CLIP_SwinB_896b32_4x_ft4x_max-size): the
detector of a configuration whose `detector` is `detic` or absent; its
sizes are the configuration's `detic` group (perfbench/detectors/__init__.py
names what a detector's module gives).

Numbers compared for `correct`, for each sampled keyframe:
- detic_fpn_rel: FPN levels p3-p7, largest relative L2 gap of a level.
- detic_dense_rel: the proposal head's heat maps and box regressions, the
  same.
- detic_cascade_rel: the three cascade stages' class scores and box deltas
  before detection selection: for each camera, stage and kind (scores,
  deltas), the relative L2 gap over all its proposals; the worst of them,
  so a fault in one camera's pooling shows. The proposals' top-k and NMS
  tie on random weights (proposal_tie_share: the share of a camera's
  proposals that the reference's own maps would not select, read beside
  the numbers and compared with nothing), so the reference takes the
  program's heat maps and regressions through its own copy of that
  selection and runs the cascade from those proposals: a fault in the
  program's selection shows here, and the maps themselves are compared by
  detic_dense_rel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench import weights
from perfbench.checks import rel
from perfbench.flops import _add, block_window, swin_stages
from perfbench.program import tuples
from perfbench.reference import models as ref_models
from perfbench.reference.tables import VOCABULARY


def skeleton(cfg: dict) -> dict:
    return {"detic": ref_models.Detic(cfg["detic"])}


def text_inputs(cfg: dict, seed: int, device) -> torch.Tensor:
    """The unit classifier (weights.classifier): CLIP's text features of the
    vocabulary in the open-vocabulary head's place."""
    return weights.classifier(cfg["detic"]["embed_dim"], len(VOCABULARY), seed, device)


# --- the port's side ---------------------------------------------------------

def port_config(cfg: dict):
    """The port's DeticConfig, from a configuration file's sizes."""
    from cm3d_tpu_torch.models.detic import DeticConfig
    from cm3d_tpu_torch.models.swin import SwinConfig

    dt = cfg["precision"]
    det = {k: tuples(v) for k, v in cfg["detic"].items() if k != "swin"}
    swin = SwinConfig(**{k: tuples(v) for k, v in cfg["detic"]["swin"].items()}, dtype=dt)
    return DeticConfig(**det, swin=swin, dtype=dt)


def port_models(cfg: dict, state: dict, make_sam, text: torch.Tensor, device, quant_int8: bool):
    """(MaskModels, Detic, Sam) of the port: its Detic holding the state's
    weights, then SAM (`make_sam()`), their int8 twins (`quantized_models`)
    where the configuration serves int8, then the MaskModels around them.
    In that order, with the float modules let go before the MaskModels are
    made: the caching allocator's blocks, and so what peak_mem_gib reads,
    follow the order of allocations and frees."""
    from cm3d_tpu_torch.models.detic import Detic
    from cm3d_tpu_torch.pipelines.masks import _batched_model_fns, quantized_models

    with torch.device("meta"):
        detic = Detic(port_config(cfg))
    detic = detic.to_empty(device=device)
    detic.load_state_dict(state["detic"])
    detic, sam = quantized_models(detic, make_sam(), quant_int8)
    models = _batched_model_fns(detic, text.cpu().numpy(), sam, VOCABULARY, device=device)
    return models, detic, sam


def captures(detic) -> list:
    heads = detic.roi_heads.box_predictor
    mods = [("levels", detic.backbone), ("dense", detic.proposal_generator.centernet_head)]
    mods += [(f"scores{i}", p.cls_score) for i, p in enumerate(heads)]
    mods += [(f"deltas{i}", p.bbox_pred) for i, p in enumerate(heads)]
    return mods


def program_side(cap: dict) -> dict:
    n = len([k for k in cap if k.startswith("scores")])
    return {"levels": cap["levels"][0], "dense": cap["dense"][0],
            "stages": [(cap[f"scores{i}"][0], cap[f"deltas{i}"][0]) for i in range(n)]}


# --- the reference's side ----------------------------------------------------

def set_precision(ref: dict, cfg: dict, control: bool) -> None:
    """Swin's MLPs at w8a8 where the configuration serves int8 (w4a4 in the
    control); the layers the port computes in bfloat16 in float32, or in
    float8 in the control."""
    detic = ref["detic"]
    quant = ref_models.detic_int8_layers(detic) if cfg["modes"]["quant_int8"] else set()
    ref_models.set_precision_(detic, ref_models.DETIC_F32_LAYERS, quant, 4 if control else 8,
                              control)


def reference_side(ref: dict, classifier, images, x, cfg: dict, prog=None) -> dict:
    """FPN levels, dense maps and cascade stages of one keyframe, the
    cascade from the proposals of `prog`'s dense maps (or its own)."""
    detic = ref["detic"]
    dev = classifier.device
    h, w = x.shape[1:3]
    with torch.no_grad():
        # Detic's input zero-padded to multiples of 32 after normalisation
        levels, hms, regs = detic.dense(F.pad(x, (0, 0, 0, -w % 32, 0, -h % 32)))
        src = prog["dense"] if prog is not None else (hms, regs)
        strides = dict(zip(sorted(levels), cfg["detic"]["strides"]))

        def select(maps):
            return ref_models.decode_proposals({k: v.float() for k, v in maps[0].items()},
                                               {k: v.float() for k, v in maps[1].items()},
                                               strides, cfg["detic"])[0]

        props = select(src)
        own = select((hms, regs)) if prog is not None else props
        hw = torch.tensor([images.shape[1:3]] * images.shape[0], device=dev)
        stages = detic.cascade(levels, props, classifier, hw)
    return {"levels": levels, "dense": (hms, regs), "stages": stages,
            "proposal_tie_share": tie_share(props, own)}


def tie_share(props: torch.Tensor, own: torch.Tensor) -> float:
    """The share of `own`'s proposals [B, R, 4] that `props` lacks (no box
    within 0.5 px in every coordinate, in the same camera)."""
    gap = (own[:, :, None, :] - props[:, None, :, :]).abs().amax(-1)
    return float((gap.amin(-1) > 0.5).float().mean())


def compare(prog: dict, ref: dict) -> dict:
    out = {"detic_fpn_rel": max(rel(prog["levels"][k], ref["levels"][k]) for k in ref["levels"])}
    out["detic_dense_rel"] = max(
        max(rel(prog["dense"][i][k], ref["dense"][i][k]) for k in ref["dense"][i])
        for i in range(2))
    cams = ref["stages"][0][0].shape[0]
    out["detic_cascade_rel"] = max(
        rel(p.reshape(cams, -1)[c], r.reshape(cams, -1)[c])
        for (ps, pd), (rs, rd) in zip(prog["stages"], ref["stages"])
        for p, r in ((ps, rs), (pd, rd)) for c in range(cams))
    out["proposal_tie_share"] = ref["proposal_tie_share"]
    return out


# --- the work counts ---------------------------------------------------------

def work(cfg: dict, traffic: dict, quant: bool) -> dict:
    """Operations of a keyframe's Detic forward, its cameras at the
    traffic's image size."""
    h, w = traffic["image_hw"]
    return detic_work(cfg, traffic["cameras"], h, w, quant)


def detic_work(cfg: dict, images: int, h: int, w: int, quant: bool) -> dict:
    """Operations of a Detic forward over `images` h x w images."""
    d, sw = cfg["detic"], cfg["detic"]["swin"]
    work: dict = {}
    stages = swin_stages(sw, h, w)
    _, gh0, gw0, c0 = stages[0]
    _add(work, "bf16", 2 * images * gh0 * gw0 * 3 * sw["patch_size"] ** 2 * c0)
    grids = {}
    for i, gh, gw, c in stages:
        t = images * gh * gw
        win, _ = block_window(gh, gw, sw["window_size"], 0)
        hidden = int(c * sw["mlp_ratio"])
        for _ in range(sw["depths"][i]):
            _add(work, "bf16", t * (2 * 3 * c * c + 4 * win * win * c + 2 * c * c))
            _add(work, "int8" if quant else "bf16", t * 2 * 2 * c * hidden)
        if i < len(stages) - 1:  # patch merging
            _add(work, "bf16", 2 * images * (-(-gh // 2)) * (-(-gw // 2)) * 4 * c * 2 * c)
        grids[i] = (gh, gw, c)
    f = d["fpn_dim"]
    levels = []
    for si in sorted(sw["out_indices"]):
        gh, gw, c = grids[si]
        _add(work, "bf16", 2 * images * gh * gw * (c * f + 9 * f * f))
        levels.append((gh, gw))
    for _ in range(len(d["strides"]) - len(sw["out_indices"])):
        gh, gw = levels[-1]
        gh, gw = -(-gh // 2), -(-gw // 2)
        _add(work, "bf16", 2 * images * gh * gw * 9 * f * f)
        levels.append((gh, gw))
    pos = images * sum(gh * gw for gh, gw in levels)
    _add(work, "bf16", 2 * pos * 9 * f * f * 2 * d["num_head_convs"])
    _add(work, "f32", 2 * pos * 9 * f * 5)  # heat map and box regression
    r, fc, e = images * d["post_nms_topk"], d["fc_dim"], d["embed_dim"]
    p2 = d["pooler_size"] ** 2
    for _ in range(d["num_cascade_stages"]):
        _add(work, "f32", 2 * r * p2 * 4 * 4 * f)  # ROIAlign: 4 samples a bin, 4 taps
        _add(work, "bf16", 2 * r * (p2 * f * fc + fc * fc))
        _add(work, "f32", 2 * r * (fc * e + e * len(VOCABULARY) + fc * fc + fc * 4))
    return work


def window_attn_input(cfg: dict, traffic: dict) -> tuple:
    """Swin-B's sizes, on the traffic's cameras at its image size."""
    return (cfg["detic"]["swin"], traffic["cameras"], *traffic["image_hw"])

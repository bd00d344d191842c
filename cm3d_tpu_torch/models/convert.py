"""Parameter conversion into the port's modules, from two sources.

1. JAX-package Flax parameter trees -> the port's state dicts
   (`*_state_dict_from_flax`). The port's modules carry the released torch
   checkpoints' parameter names, exactly the keys
   `cm3d_tpu/models/convert_detic.py` and `cm3d_tpu/models/convert_sam.py`
   read, so each function here is the inverse of that converter and a
   Flax tree (nested dicts of numpy arrays) loads with `load_state_dict`.
   Layouts: Dense kernel [in, out] -> Linear weight [out, in] (a QuantDense
   subtree's int8 kernel_q likewise -> weight_q, with its scales); Conv kernel
   HWIO -> OIHW; Up2x2 kernel [2, 2, O, I] -> ConvTranspose2d weight
   [I, O, 2, 2]; scalar leaves (`scale{li}`, `cls_bias`) -> shape [1], as
   in the released checkpoints.

2. Released torch checkpoints (Detic, SAM, CLIP) -> the same state dicts
   (`load_torch_state_dict`, `detic_state_dict_from_released`,
   `clip_state_dict_from_released`, `load_released_state_dict`). The keys
   already match (a SAM file loads as it is), so a released file needs
   three things only:
   - Detic's box-head `fc1.weight` has its input axis permuted from
     detectron2's (c, y, x) flatten of the pooled ROI features to the
     port's (y, x, c) (`fc1_from_detectron2`). DELIBERATE DIVERGENCE: the
     JAX converter (`cm3d_tpu/models/convert_detic.py:110`) only transposes
     this weight, so a released checkpoint loaded the JAX way feeds fc1
     features in the wrong order; the port does not copy that omission.
   - scalars take the port's shape (`centernet_head.scales.{li}.scale`,
     `cls_score.cls_bias`, which is 0 when absent, as the JAX converter
     sets it);
   - CLIP's `text_encoder.` prefix (Detic's wrapper) is stripped.
   Loading is strict in what the port reads: a missing key or a shape
   mismatch raises; keys nothing reads (Swin's `relative_position_index` /
   `attn_mask` buffers, the vision tower of a full CLIP file, optimizer and
   EMA extras) are reported and ignored.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch
from torch import nn

from cm3d_tpu_torch.models.detic import DETIC_SWINB, DeticConfig
from cm3d_tpu_torch.models.sam import SAM_VIT_H, SamConfig


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _dense(out: dict, prefix: str, p: dict) -> None:
    """A Dense subtree, or a QuantDense one (kernel_q int8 [in, out] ->
    weight_q [out, in], kernel_scale -> weight_scale, act_scale as it is)."""
    if "kernel_q" in p:
        out[f"{prefix}.weight_q"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["kernel_q"], np.int8).T))
        out[f"{prefix}.weight_scale"] = _t(p["kernel_scale"])
        if "act_scale" in p:
            out[f"{prefix}.act_scale"] = _t(p["act_scale"]).reshape(())
    else:
        out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _conv(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _ln(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _full_table(table, window: int) -> torch.Tensor:
    """A block's [(2 window - 1)^2, heads] bias table. On a map smaller than
    the window the JAX package creates the table of the shrunk window; the
    port's block always holds the full table and reads its centre
    (`models.swin.shrunk_table`), so a shrunk table lands in the centre of a
    zero one."""
    table = np.asarray(table, np.float32)
    side = 2 * window - 1
    small = int(round(table.shape[0] ** 0.5))
    if small == side:
        return _t(table)
    lo = (side - small) // 2
    full = np.zeros((side, side, table.shape[1]), np.float32)
    full[lo:lo + small, lo:lo + small] = table.reshape(small, small, -1)
    return _t(full.reshape(side * side, -1))


def swin_state_dict_from_flax(params: dict, cfg, prefix: str = "backbone.bottom_up.") -> dict:
    """`cm3d_tpu.models.swin.SwinTransformer` params -> state dict."""
    out: Dict[str, torch.Tensor] = {}
    p = prefix
    _conv(out, f"{p}patch_embed.proj", params["patch_embed"])
    _ln(out, f"{p}patch_embed.norm", params["patch_norm"])
    for i, depth in enumerate(cfg.depths):
        for j in range(depth):
            b, blk = f"{p}layers.{i}.blocks.{j}", params[f"stage{i}_block{j}"]
            _ln(out, f"{b}.norm1", blk["norm1"])
            _ln(out, f"{b}.norm2", blk["norm2"])
            _dense(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
            _dense(out, f"{b}.attn.proj", blk["attn"]["proj"])
            out[f"{b}.attn.relative_position_bias_table"] = _full_table(
                blk["attn"]["rel_pos_bias_table"], cfg.window_size)
            _dense(out, f"{b}.mlp.fc1", blk["fc1"])
            _dense(out, f"{b}.mlp.fc2", blk["fc2"])
        if i < len(cfg.depths) - 1:
            _ln(out, f"{p}layers.{i}.downsample.norm", params[f"merge{i}"]["norm"])
            _dense(out, f"{p}layers.{i}.downsample.reduction", params[f"merge{i}"]["reduction"])
        if i in cfg.out_indices:
            _ln(out, f"{p}norm{i}", params[f"out_norm{i}"])
    return out


def detic_state_dict_from_flax(params: dict, cfg: DeticConfig = DETIC_SWINB) -> dict:
    """`cm3d_tpu.models.detic.Detic` params -> the port's Detic state dict
    (the inverse of `convert_detic_params`)."""
    out = swin_state_dict_from_flax(params["backbone"], cfg.swin)
    n_in = len(cfg.swin.out_indices)
    fpn = params["fpn"]
    for i in range(n_in):
        _conv(out, f"backbone.fpn_lateral{3 + i}", fpn[f"lateral{i}"])
        _conv(out, f"backbone.fpn_output{3 + i}", fpn[f"output{i}"])
    for j in range(len(cfg.strides) - n_in):
        _conv(out, f"backbone.top_block.p{6 + j}", fpn[f"top_block{j}"])
    hp, head = "proposal_generator.centernet_head", params["proposal_head"]
    _conv(out, f"{hp}.agn_hm", head["agn_hm"])
    _conv(out, f"{hp}.bbox_pred", head["bbox_reg"])
    for i in range(cfg.num_head_convs):
        for tower in ("share", "bbox"):
            _conv(out, f"{hp}.{tower}_tower.{3 * i}", head[f"{tower}_conv{i}"])
            _ln(out, f"{hp}.{tower}_tower.{3 * i + 1}", head[f"{tower}_gn{i}"])
    for li in range(len(cfg.strides)):
        out[f"{hp}.scales.{li}.scale"] = _t(head[f"scale{li}"]).reshape(1)
    for k in range(cfg.num_cascade_stages):
        c = params[f"cascade{k}"]
        _dense(out, f"roi_heads.box_head.{k}.fc1", c["fc1"])
        _dense(out, f"roi_heads.box_head.{k}.fc2", c["fc2"])
        bp = f"roi_heads.box_predictor.{k}"
        _dense(out, f"{bp}.cls_score.linear", c["cls_proj"])
        out[f"{bp}.cls_score.cls_bias"] = _t(c["cls_bias"]).reshape(1)
        _dense(out, f"{bp}.bbox_pred.0", c["bbox_fc"])
        _dense(out, f"{bp}.bbox_pred.2", c["bbox_pred"])
    return out


def _decoder_attn(out: dict, prefix: str, p: dict) -> None:
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _dense(out, f"{prefix}.{name}", p[name])


def _mlp_layers(out: dict, prefix: str, p: dict, depth: int = 3) -> None:
    for i in range(depth):
        _dense(out, f"{prefix}.layers.{i}", p[f"layer{i}"])


def sam_state_dict_from_flax(params: dict, cfg: SamConfig = SAM_VIT_H) -> dict:
    """`cm3d_tpu.models.sam.Sam` params -> the port's Sam state dict (the
    inverse of `convert_sam_params`)."""
    out: Dict[str, torch.Tensor] = {}
    enc = params["image_encoder"]
    _conv(out, "image_encoder.patch_embed.proj", enc["patch_embed"])
    out["image_encoder.pos_embed"] = _t(enc["pos_embed"])
    _conv(out, "image_encoder.neck.0", enc["neck_conv1"])
    out["image_encoder.neck.1.weight"] = _t(enc["neck_ln1"]["weight"])
    out["image_encoder.neck.1.bias"] = _t(enc["neck_ln1"]["bias"])
    _conv(out, "image_encoder.neck.2", enc["neck_conv2"])
    out["image_encoder.neck.3.weight"] = _t(enc["neck_ln2"]["weight"])
    out["image_encoder.neck.3.bias"] = _t(enc["neck_ln2"]["bias"])
    for i in range(cfg.encoder_depth):
        p, blk = f"image_encoder.blocks.{i}", enc[f"block{i}"]
        _ln(out, f"{p}.norm1", blk["norm1"])
        _ln(out, f"{p}.norm2", blk["norm2"])
        _dense(out, f"{p}.attn.qkv", blk["attn"]["qkv"])
        _dense(out, f"{p}.attn.proj", blk["attn"]["proj"])
        out[f"{p}.attn.rel_pos_h"] = _t(blk["attn"]["rel_pos_h"])
        out[f"{p}.attn.rel_pos_w"] = _t(blk["attn"]["rel_pos_w"])
        _dense(out, f"{p}.mlp.lin1", blk["mlp"]["lin1"])
        _dense(out, f"{p}.mlp.lin2", blk["mlp"]["lin2"])

    prompt = params["prompt_encoder"]
    out["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _t(
        prompt["pe_gaussian"])
    point = np.asarray(prompt["point_embed"])
    for i in range(4):
        out[f"prompt_encoder.point_embeddings.{i}.weight"] = _t(point[i:i + 1])
    out["prompt_encoder.no_mask_embed.weight"] = _t(prompt["no_mask_embed"])

    dec = params["mask_decoder"]
    out["mask_decoder.iou_token.weight"] = _t(dec["iou_token"])
    out["mask_decoder.mask_tokens.weight"] = _t(dec["mask_tokens"])
    tr = dec["transformer"]
    for i in range(cfg.decoder_depth):
        p, layer = f"mask_decoder.transformer.layers.{i}", tr[f"layer{i}"]
        for name in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            _decoder_attn(out, f"{p}.{name}", layer[name])
        _dense(out, f"{p}.mlp.lin1", layer["mlp"]["lin1"])
        _dense(out, f"{p}.mlp.lin2", layer["mlp"]["lin2"])
        for n in range(1, 5):
            _ln(out, f"{p}.norm{n}", layer[f"norm{n}"])
    _decoder_attn(out, "mask_decoder.transformer.final_attn_token_to_image", tr["final_attn"])
    _ln(out, "mask_decoder.transformer.norm_final_attn", tr["norm_final"])
    for name, idx in (("upscale1", 0), ("upscale2", 3)):
        out[f"mask_decoder.output_upscaling.{idx}.weight"] = _t(
            np.transpose(np.asarray(dec[name]["kernel"]), (3, 2, 0, 1)))
        out[f"mask_decoder.output_upscaling.{idx}.bias"] = _t(dec[name]["bias"])
    out["mask_decoder.output_upscaling.1.weight"] = _t(dec["upscale_ln"]["weight"])
    out["mask_decoder.output_upscaling.1.bias"] = _t(dec["upscale_ln"]["bias"])
    _mlp_layers(out, "mask_decoder.iou_prediction_head", dec["iou_head"])
    for i in range(cfg.num_multimask_outputs + 1):
        _mlp_layers(out, f"mask_decoder.output_hypernetworks_mlps.{i}", dec[f"hyper{i}"])
    return out


def _bn(out: dict, prefix: str, p: dict, stats: dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])
    out[f"{prefix}.running_mean"] = _t(stats["mean"])
    out[f"{prefix}.running_var"] = _t(stats["var"])


def centerpoint_state_dict_from_flax(params: dict, batch_stats: dict, cfg,
                                     prefix: str = "") -> dict:
    """`cm3d_tpu.train.centerpoint.CenterPointDetector` params and
    batch_stats -> the port's CenterPointDetector state dict."""
    from cm3d_tpu_torch.train.centerpoint import HEADS

    out: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.trunk_channels)):
        for half in ("a", "b"):
            name = f"trunk{i}_{half}"
            _conv(out, f"{prefix}{name}.conv", params[name]["Conv_0"])
            _bn(out, f"{prefix}{name}.bn", params[name]["BatchNorm_0"],
                batch_stats[name]["BatchNorm_0"])
    for head, _ in HEADS:
        _conv(out, f"{prefix}{head}_conv", params[f"{head}_conv"])
        _conv(out, f"{prefix}{head}_out", params[f"{head}_out"])
    return out


def bevfusion_state_dict_from_flax(params: dict, batch_stats: dict, cfg) -> dict:
    """`cm3d_tpu.train.bevfusion.BevFusionDetector` params and batch_stats
    -> the port's BevFusionDetector state dict (the camera's Swin through
    `swin_state_dict_from_flax`)."""
    out = centerpoint_state_dict_from_flax(
        params["centerpoint"], batch_stats["centerpoint"], cfg.centerpoint, "centerpoint.")
    cam = params["camera"]
    if cfg.camera_backbone == "swin_t":
        out.update(swin_state_dict_from_flax(cam["swin"], cfg.swin, prefix="camera.swin."))
    else:
        for i in range(len(cfg.cam_trunk)):
            _conv(out, f"camera.cam{i}", cam[f"cam{i}"])
            _bn(out, f"camera.cam{i}_bn", cam[f"cam{i}_bn"], batch_stats["camera"][f"cam{i}_bn"])
    _conv(out, "camera.cam_feat", cam["cam_feat"])
    _conv(out, "camera.cam_depth", cam["cam_depth"])
    return out


# ---------------------------------------------------------------------------
# Released torch checkpoints
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A released checkpoint's tensors (CPU), from a plain state dict or a
    trainer file holding one under "model" (detectron2's, beside
    "iteration"). The file is read with `weights_only=True`, so no pickled
    code runs; a file that needs more raises, naming it. Entries that are
    not tensors (trainer state) are dropped."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, AttributeError, TypeError) as e:
        raise ValueError(
            f"{path}: not loadable with torch.load(weights_only=True); the port "
            f"loads tensors only and never unpickles code ({type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''})") from e
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(obj).__name__}")
    if isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def fc1_from_detectron2(weight: torch.Tensor, channels: int, pooler: int) -> torch.Tensor:
    """detectron2's box-head fc1 weight [out, C*P*P], input in (c, y, x)
    order, -> the port's [out, P*P*C] in (y, x, c) order (its box head
    flattens pooled [P, P, C] features)."""
    out = weight.shape[0]
    return (weight.reshape(out, channels, pooler, pooler).permute(0, 2, 3, 1)
            .reshape(out, pooler * pooler * channels).contiguous())


def detic_state_dict_from_released(sd: Dict[str, torch.Tensor],
                                   cfg: DeticConfig = DETIC_SWINB) -> Dict[str, torch.Tensor]:
    """A released Detic (detectron2) state dict -> the port's Detic keys:
    fc1's input axis permuted, an absent `cls_bias` set to 0."""
    out = dict(sd)
    for k in range(cfg.num_cascade_stages):
        key = f"roi_heads.box_head.{k}.fc1.weight"
        if key in out and out[key].shape[-1] == cfg.fpn_dim * cfg.pooler_size ** 2:
            out[key] = fc1_from_detectron2(out[key], cfg.fpn_dim, cfg.pooler_size)
        out.setdefault(f"roi_heads.box_predictor.{k}.cls_score.cls_bias", torch.zeros(1))
    return out


def clip_state_dict_from_released(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A CLIP state dict (full model or text tower, bare keys or under
    Detic's `text_encoder.` prefix) -> the port's ClipTextEncoder keys."""
    pref = "text_encoder."
    out = {k: v for k, v in sd.items() if not k.startswith(pref)}
    out.update({k[len(pref):]: v for k, v in sd.items() if k.startswith(pref)})
    return out


def _fit(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A one-element tensor takes the port's shape ([] and [1] are one
    scalar in the released files); anything else is left as it is."""
    if value.numel() == 1 and like.numel() == 1:
        return value.reshape(like.shape)
    return value


def released_report(module: nn.Module, sd: Dict[str, torch.Tensor]) -> dict:
    """What loading `sd` into `module` would do: the keys it reads that `sd`
    lacks ("missing"), the keys of `sd` nothing reads ("extra"), and shape
    mismatches ("mismatched")."""
    want = module.state_dict()
    common = sorted(set(want) & set(sd))
    return {
        "missing": sorted(set(want) - set(sd)),
        "extra": sorted(set(sd) - set(want)),
        "mismatched": [
            f"{k}: got {tuple(sd[k].shape)}, want {tuple(want[k].shape)}"
            for k in common if _fit(sd[k], want[k]).shape != want[k].shape],
    }


def load_released_state_dict(module: nn.Module, sd: Dict[str, torch.Tensor],
                             name: str = "checkpoint", verbose: bool = True) -> dict:
    """Load `sd` into `module` under the JAX package's rule: missing keys
    and shape mismatches raise (naming `name`), keys nothing reads are
    reported and ignored. Returns the report (`released_report`)."""
    rep = released_report(module, sd)
    if rep["missing"] or rep["mismatched"]:
        raise ValueError(
            f"{name}: {len(rep['missing'])} missing keys {rep['missing'][:8]}, "
            f"{len(rep['mismatched'])} shape mismatches {rep['mismatched'][:8]}")
    if rep["extra"] and verbose:
        print(f"{name}: ignored {len(rep['extra'])} keys nothing reads, e.g. "
              f"{rep['extra'][:5]}")
    want = module.state_dict()
    module.load_state_dict({k: _fit(sd[k], want[k]) for k in want})
    return rep

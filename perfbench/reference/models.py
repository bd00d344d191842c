"""Plain reference of the mask models: Detic Swin-B and SAM, in float32.

A frozen copy of the plain paths of cm3d_tpu_torch/models/{common,swin,
detic,sam}.py, ops/roi_align.py, ops/nms.py and the plain version of
kernels/window_attn.py, with every product in float32 (the caller turns
TF32 off). The modules hold the same state-dict keys as the port's float
modules, so one set of weights loads into both.

Published architectures: Detic_LCOCOI21k_CLIP_SwinB_896b32_4x_ft4x_max-size
(facebookresearch/Detic: Swin-B, FPN p3-p7, CenterNet2 proposals, a 3-stage
cascade classifying against CLIP text embeddings) and SAM (facebookresearch/
segment-anything: ViT encoder with windowed and global blocks and decomposed
relative positions, box prompt encoder, two-way transformer mask decoder).

A layer's `bits` (8 or 4) makes it compute as w{b}a{b}: symmetric
per-output-channel weights and per-token dynamic activations, rounded to
nearest, the integer products exact in float64 (the configuration's int8
layers: Swin's MLPs, SAM's encoder qkv / proj / MLP). A layer's `fp8`
rounds its input and weight to float8 e4m3 with a per-tensor scale first
(the control of the layers a configuration serves in bfloat16).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


# --- building blocks (models/common.py) -------------------------------------

def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    s = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Linear(nn.Linear):
    """nn.Linear in f32; with `bits` the w{bits}a{bits} dynamic product."""

    bits = 0
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return F.linear(fp8(x.float()), fp8(self.weight.float()), self.bias)
        if not self.bits:
            return F.linear(x.float(), self.weight.float(), self.bias)
        qmax = float(2 ** (self.bits - 1) - 1)
        w = self.weight.float()
        w_scale = torch.clamp(w.abs().amax(1), min=1e-12) / qmax
        w_q = torch.round(w / w_scale[:, None])
        xf = x.float()
        x_scale = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-12) / qmax
        x_q = torch.round(xf / x_scale)
        acc = (x_q.double() @ w_q.double().t()).float()
        y = acc * x_scale * w_scale
        return y if self.bias is None else y + self.bias.float()


def _same_pads(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """Conv over [B, H, W, C] maps; "same" is flax's SAME padding."""

    fp8 = False

    def __init__(self, cin, cout, kernel, stride=1, padding="same", bias=True):
        super().__init__(cin, cout, kernel, stride=stride,
                         padding=0 if padding == "same" else padding, bias=bias)
        self.same = padding == "same"

    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2)
        if self.same:
            k, s = self.kernel_size[0], self.stride[0]
            t, bo = _same_pads(x.shape[2], k, s)
            le, r = _same_pads(x.shape[3], k, s)
            if t or bo or le or r:
                x = F.pad(x, (le, r, t, bo))
        w = self.weight
        if self.fp8:
            x, w = fp8(x), fp8(w)
        return F.conv2d(x, w, self.bias, self.stride, self.padding).permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups, self.weight, self.bias,
                         self.eps)
        return y.permute(0, 2, 3, 1)


class LayerNorm2d(nn.Module):
    def __init__(self, c, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias


class MLPBlock(nn.Module):
    def __init__(self, dim, mlp_dim, out_dim, act="gelu"):
        super().__init__()
        self.lin1 = Linear(dim, mlp_dim)
        self.lin2 = Linear(mlp_dim, out_dim)
        self.act = act

    def forward(self, x):
        x = self.lin1(x)
        return self.lin2(F.gelu(x) if self.act == "gelu" else F.relu(x))


# --- Swin-B (models/swin.py, kernels/window_attn.py plain) ------------------

def rel_pos_index(window: int) -> torch.Tensor:
    r = torch.arange(window)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def shift_mask(hp: int, wp: int, window: int, shift: int) -> torch.Tensor:
    img = torch.zeros((hp, wp), dtype=torch.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window).permute(0, 2, 1, 3)
    win = win.reshape(-1, window * window)
    return (win[:, :, None] != win[:, None, :]).float() * -100.0


def block_window(h, w, window, shift):
    win = min(window, max(h, w))
    sh = shift if win < min(h, w) else 0
    if min(h, w) <= window:
        win, sh = min(h, w), 0
    return win, sh


def shrunk_table(table, window, win):
    if win == window:
        return table
    side, lo = 2 * window - 1, window - win
    return table.reshape(side, side, -1)[lo:lo + 2 * win - 1, lo:lo + 2 * win - 1].reshape(
        -1, table.shape[-1])


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                                     heads))


class SwinMlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, mlp_ratio):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = SwinMlp(dim, int(dim * mlp_ratio))

    def branch(self, x, win, shift):
        """pad, roll, per-window LN -> qkv -> biased softmax attention ->
        proj, roll back, crop."""
        b, h, w, c = x.shape
        heads, hd, n = self.heads, c // self.heads, win * win
        hp, wp = -(-h // win) * win, -(-w // win) * win
        ln = self.norm1(x)
        ln = F.pad(ln, (0, 0, 0, wp - w, 0, hp - h))
        if shift:
            ln = torch.roll(ln, (-shift, -shift), (1, 2))
        ln = ln.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
        qkv = self.attn.qkv(ln.reshape(-1, n, c)).reshape(-1, n, 3, heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        table = shrunk_table(self.attn.relative_position_bias_table, self.window, win)
        bias = table[rel_pos_index(win).to(x.device).reshape(-1)].reshape(n, n, heads)
        s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + bias.permute(2, 0, 1)
        if shift:
            mask = shift_mask(hp, wp, win, shift).to(x.device)
            s = (s.reshape(b, -1, heads, n, n) + mask[None, :, None]).reshape(-1, heads, n, n)
        o = (torch.softmax(s, -1) @ v).permute(0, 2, 1, 3).reshape(-1, n, c)
        out = self.attn.proj(o).reshape(b, hp // win, wp // win, win, win, c)
        out = out.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            out = torch.roll(out, (shift, shift), (1, 2))
        return out[:, :h, :w]

    def forward(self, x):
        win, shift = block_window(x.shape[1], x.shape[2], self.window, self.shift)
        x = x + self.branch(x, win, shift)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x))


class SwinPatchEmbed(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.proj = Conv(3, cfg["embed_dim"], cfg["patch_size"], stride=cfg["patch_size"])
        self.norm = LayerNorm(cfg["embed_dim"], eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


class SwinLayer(nn.Module):
    def __init__(self, cfg, i):
        super().__init__()
        dim = cfg["embed_dim"] * 2 ** i
        win = cfg["window_size"]
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg["num_heads"][i], win, 0 if j % 2 == 0 else win // 2,
                      cfg["mlp_ratio"]) for j in range(cfg["depths"][i]))
        self.downsample = PatchMerging(dim) if i < len(cfg["depths"]) - 1 else None


class SwinTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.out_indices = tuple(cfg["out_indices"])
        self.patch_embed = SwinPatchEmbed(cfg)
        self.layers = nn.ModuleList(SwinLayer(cfg, i) for i in range(len(cfg["depths"])))
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(cfg["embed_dim"] * 2 ** i, eps=1e-5))

    def forward(self, x):
        x = self.patch_embed(x)
        outs = {}
        for i, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x)
            if i in self.out_indices:
                outs[i] = getattr(self, f"norm{i}")(x)
            if layer.downsample is not None:
                x = layer.downsample(x)
        return outs


# --- Detic (models/detic.py, ops/roi_align.py, ops/nms.py) ------------------

def top_k(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nms_2d_classwise(boxes, scores, labels, valid, iou_threshold):
    from perfbench.reference.lift import greedy_keep

    neg = torch.where(valid, scores, -torch.inf)
    order = torch.sort(-neg, dim=-1, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    lab = torch.gather(labels, -1, order)
    val = torch.gather(valid, -1, order)
    x1, y1, x2, y2 = b.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[..., :, None] + area[..., None, :] - inter
    iou = torch.where(union > 0, inter / torch.clamp(union, min=1e-12), 0.0)
    overlap = (lab[..., :, None] == lab[..., None, :]) & (iou > iou_threshold)
    return torch.zeros_like(valid).scatter(-1, order, greedy_keep(overlap, val))


def _interp_matrix(coords, size, oo, s):
    c0 = torch.floor(coords)
    frac = coords - c0
    c0i = c0.to(torch.int64).clamp(0, size - 1)
    c1i = (c0i + 1).clamp(0, size - 1)
    w1 = torch.where(coords <= 0, 0.0, torch.where(coords >= size - 1, 0.0, frac))
    valid = ((coords >= -1.0) & (coords <= size)).to(coords.dtype)
    rng = torch.arange(size, device=coords.device)
    m = (rng == c0i[..., None]) * ((1.0 - w1) * valid)[..., None] \
        + (rng == c1i[..., None]) * (w1 * valid)[..., None]
    return m.reshape(*coords.shape[:-1], oo, s, size).mean(dim=-2)


def roi_align(features, boxes, output_size=7, sampling_ratio=2):
    """ROIAlign (aligned), a fixed 2x2 grid: features [B, H, W, C], boxes
    [B, R, 4] in grid coordinates -> [B, R, o, o, C]."""
    _, h, w, _ = features.shape
    oo, s = output_size, sampling_ratio
    x1, y1, x2, y2 = boxes.unbind(-1)
    bin_w = torch.clamp(x2 - x1, min=1e-6) / oo
    bin_h = torch.clamp(y2 - y1, min=1e-6) / oo
    grid = (torch.arange(oo, device=boxes.device)[:, None]
            + (torch.arange(s, device=boxes.device)[None, :] + 0.5) / s).reshape(-1)
    ys = y1[..., None] + grid * bin_h[..., None] - 0.5
    xs = x1[..., None] + grid * bin_w[..., None] - 0.5
    my = _interp_matrix(ys.float(), h, oo, s)
    mx = _interp_matrix(xs.float(), w, oo, s)
    rows = torch.einsum("nrah,nhwc->nrawc", my, features.float())
    return torch.einsum("nrawc,nrbw->nrabc", rows, mx)


def multilevel_roi_align(features, boxes, strides, output_size, min_level, max_level):
    area = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) \
        * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)
    levels = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-8))
    levels = levels.clamp(min_level, max_level).to(torch.int64)
    out = None
    for lvl in range(min_level, max_level + 1):
        pooled = roi_align(features[lvl], boxes / strides[lvl], output_size)
        sel = (levels == lvl)[..., None, None, None].to(pooled.dtype)
        out = pooled * sel if out is None else out + pooled * sel
    return out


class TopBlock(nn.Module):
    def __init__(self, n_extra, d):
        super().__init__()
        for j in range(n_extra):
            self.add_module(f"p{6 + j}", Conv(d, d, 3, stride=2, padding=1))
        self.n_extra = n_extra


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        sw = cfg["swin"]
        self.bottom_up = SwinTransformer(sw)
        d = cfg["fpn_dim"]
        self.n_levels = len(sw["out_indices"])
        for i, si in enumerate(sorted(sw["out_indices"])):
            self.add_module(f"fpn_lateral{3 + i}", Conv(sw["embed_dim"] * 2 ** si, d, 1))
            self.add_module(f"fpn_output{3 + i}", Conv(d, d, 3, padding=1))
        self.top_block = TopBlock(len(cfg["strides"]) - self.n_levels, d)

    def forward(self, images) -> Dict[int, torch.Tensor]:
        feats = self.bottom_up(images)
        lat = [getattr(self, f"fpn_lateral{3 + i}")(feats[n]) for i, n in enumerate(sorted(feats))]
        for i in range(len(lat) - 2, -1, -1):
            th, tw = lat[i].shape[1], lat[i].shape[2]
            up = lat[i + 1].repeat_interleave(2, 1).repeat_interleave(2, 2)
            lat[i] = lat[i] + up[:, :th, :tw]
        levels = {3 + i: getattr(self, f"fpn_output{3 + i}")(x) for i, x in enumerate(lat)}
        x = levels[3 + len(lat) - 1]
        for j in range(self.top_block.n_extra):
            x = getattr(self.top_block, f"p{6 + j}")(F.relu(x) if j > 0 else x)
            levels[3 + len(lat) + j] = x
        return levels


class Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))


class CenterNetHead(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["fpn_dim"]

        def tower():
            mods = []
            for _ in range(cfg["num_head_convs"]):
                mods += [Conv(d, d, 3, padding=1), GroupNorm(cfg["head_gn_groups"], d, eps=1e-5),
                         nn.ReLU()]
            return nn.Sequential(*mods)

        self.share_tower = tower()
        self.bbox_tower = tower()
        self.agn_hm = Conv(d, 1, 3, padding=1)
        self.bbox_pred = Conv(d, 4, 3, padding=1)
        self.scales = nn.ModuleList(Scale() for _ in cfg["strides"])

    def forward(self, feats):
        hms, regs = {}, {}
        for li, (lvl, x) in enumerate(sorted(feats.items())):
            y = self.share_tower(x)
            hms[lvl] = self.agn_hm(y)[..., 0]
            regs[lvl] = F.relu(self.bbox_pred(self.bbox_tower(y)) * self.scales[li].scale)
        return hms, regs


def decode_proposals(hms, regs, strides, cfg):
    all_boxes, all_scores = [], []
    for lvl in sorted(hms):
        hm = torch.sigmoid(hms[lvl])
        b, h, w = hm.shape
        s = strides[lvl]
        k = min(cfg["pre_nms_topk"], h * w)
        score, idx = top_k(hm.reshape(b, -1), k)
        ys = (idx // w).float() * s + s / 2
        xs = (idx % w).float() * s + s / 2
        r = torch.gather(regs[lvl].reshape(b, -1, 4), 1, idx[..., None].expand(b, k, 4)) * s
        all_boxes.append(torch.stack([xs - r[..., 0], ys - r[..., 1], xs + r[..., 2],
                                      ys + r[..., 3]], -1))
        all_scores.append(score)
    boxes, scores = torch.cat(all_boxes, 1), torch.cat(all_scores, 1)
    keep = nms_2d_classwise(boxes, scores, torch.zeros_like(scores, dtype=torch.int64),
                            scores > 0, cfg["proposal_nms_thresh"])
    top_s, top_i = top_k(torch.where(keep, scores, 0.0), cfg["post_nms_topk"])
    return torch.gather(boxes, 1, top_i[..., None].expand(*top_i.shape, 4)), top_s


class BoxHead(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.fc1 = Linear(cfg["pooler_size"] ** 2 * cfg["fpn_dim"], cfg["fc_dim"])
        self.fc2 = Linear(cfg["fc_dim"], cfg["fc_dim"])

    def forward(self, pooled):
        return F.relu(self.fc2(F.relu(self.fc1(pooled.reshape(*pooled.shape[:-3], -1)))))


class ZeroShotClassifier(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.linear = Linear(cfg["fc_dim"], cfg["embed_dim"])
        self.cls_bias = nn.Parameter(torch.zeros(1))
        self.temperature = cfg["norm_temperature"]

    def forward(self, x, classifier):
        emb = self.linear(x)
        emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)
        return torch.sigmoid(self.temperature * (emb @ classifier) + self.cls_bias)


class BoxPredictor(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cls_score = ZeroShotClassifier(cfg)
        self.bbox_pred = nn.Sequential(Linear(cfg["fc_dim"], cfg["fc_dim"]), nn.ReLU(),
                                       Linear(cfg["fc_dim"], 4))


class RoiHeads(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        n = cfg["num_cascade_stages"]
        self.box_head = nn.ModuleList(BoxHead(cfg) for _ in range(n))
        self.box_predictor = nn.ModuleList(BoxPredictor(cfg) for _ in range(n))


class ProposalGenerator(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.centernet_head = CenterNetHead(cfg)


def apply_deltas(boxes, deltas, weights):
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * widths
    cy = boxes[..., 1] + 0.5 * heights
    dw = torch.clamp(deltas[..., 2] / ww, max=4.135)
    dh = torch.clamp(deltas[..., 3] / wh, max=4.135)
    pcx = deltas[..., 0] / wx * widths + cx
    pcy = deltas[..., 1] / wy * heights + cy
    pw, ph = torch.exp(dw) * widths, torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], -1)


class Detic(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        self.proposal_generator = ProposalGenerator(cfg)
        self.roi_heads = RoiHeads(cfg)

    def dense(self, images):
        """images [B, H, W, 3] normalised -> (FPN levels, heat maps, box
        regressions): everything before the proposals' selection."""
        levels = self.backbone(images)
        hms, regs = self.proposal_generator.centernet_head(levels)
        return levels, hms, regs

    def cascade(self, levels, proposals, classifier, true_hw):
        """The cascade from given proposals [B, R, 4] -> per stage (class
        scores [B, R, K], box deltas [B, R, 4])."""
        cfg = self.cfg
        strides = dict(zip(sorted(levels), cfg["strides"]))
        h_img, w_img = true_hw[:, 0].float()[:, None], true_hw[:, 1].float()[:, None]
        boxes, out = proposals, []
        for i in range(cfg["num_cascade_stages"]):
            pooled = multilevel_roi_align(levels, boxes, strides, cfg["pooler_size"],
                                          min(strides), max(strides))
            x = self.roi_heads.box_head[i](pooled)
            pred = self.roi_heads.box_predictor[i]
            scores, deltas = pred.cls_score(x, classifier), pred.bbox_pred(x)
            out.append((scores, deltas))
            boxes = apply_deltas(boxes, deltas, cfg["cascade_deltas"][i])
            zero = torch.zeros((), device=boxes.device)
            boxes = torch.stack([torch.minimum(torch.maximum(boxes[..., 0], zero), w_img),
                                 torch.minimum(torch.maximum(boxes[..., 1], zero), h_img),
                                 torch.minimum(torch.maximum(boxes[..., 2], zero), w_img),
                                 torch.minimum(torch.maximum(boxes[..., 3], zero), h_img)], -1)
        return out


# --- SAM (models/sam.py) ----------------------------------------------------

def window_partition(x, window):
    b, h, w, c = x.shape
    ph, pw = (window - h % window) % window, (window - w % window) % window
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows, window, pad_hw, hw):
    hp, wp = pad_hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :hw[0], :hw[1]]


def get_rel_pos(q_size, k_size, rel_pos):
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        orig = rel_pos.shape[0]
        pos = (torch.arange(max_rel_dist, device=rel_pos.device, dtype=torch.float32) + 0.5) \
            * (orig / max_rel_dist) - 0.5
        pos = pos.clamp(0, orig - 1)
        lo = torch.floor(pos).to(torch.int64)
        hi = (lo + 1).clamp(max=orig - 1)
        frac = (pos - lo)[:, None]
        rel_pos = rel_pos[lo] * (1 - frac) + rel_pos[hi] * frac
    q = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int64).to(rel_pos.device)]


class SamAttention(nn.Module):
    def __init__(self, dim, heads, input_hw):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_hw[0] - 1, self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_hw[1] - 1, self.head_dim))

    def forward(self, x):
        b, h, w, dim = x.shape
        hd = self.head_dim
        qkv = self.qkv(x.reshape(b, h * w, dim)).reshape(b, h * w, 3, self.heads, hd)
        q, k, v = qkv.unbind(2)
        attn = torch.einsum("bqhc,bkhc->bhqk", q * hd ** -0.5, k)
        rh, rw = get_rel_pos(h, h, self.rel_pos_h), get_rel_pos(w, w, self.rel_pos_w)
        r_q = q.reshape(b, h, w, self.heads, hd)
        rel_h = torch.einsum("bhwnc,hkc->bnhwk", r_q, rh).reshape(b, self.heads, h * w, h, 1)
        rel_w = torch.einsum("bhwnc,wkc->bnhwk", r_q, rw).reshape(b, self.heads, h * w, 1, w)
        attn = (attn.reshape(b, self.heads, h * w, h, w) + rel_h + rel_w).reshape(
            b, self.heads, h * w, h * w)
        x = torch.einsum("bhqk,bkhc->bqhc", torch.softmax(attn, -1), v)
        return self.proj(x.reshape(b, h, w, dim))


class SamBlock(nn.Module):
    def __init__(self, dim, heads, window, grid_hw):
        super().__init__()
        self.window = window
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = SamAttention(dim, heads, (window, window) if window else grid_hw)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim, dim)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window:
            hw = (x.shape[1], x.shape[2])
            x, pad_hw = window_partition(x, self.window)
        x = self.attn(x)
        if self.window:
            x = window_unpartition(x, self.window, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class SamPatchEmbed(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.proj = Conv(3, cfg["encoder_dim"], cfg["patch_size"], stride=cfg["patch_size"])

    def forward(self, x):
        return self.proj(x)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        hw = cfg["img_size"] // cfg["patch_size"]
        d = cfg["encoder_dim"]
        self.patch_embed = SamPatchEmbed(cfg)
        self.pos_embed = nn.Parameter(torch.zeros(1, hw, hw, d))
        self.blocks = nn.ModuleList(
            SamBlock(d, cfg["encoder_heads"],
                     0 if i in cfg["encoder_global_attn"] else cfg["window_size"], (hw, hw))
            for i in range(cfg["encoder_depth"]))
        o = cfg["out_dim"]
        self.neck = nn.Sequential(Conv(d, o, 1, bias=False), LayerNorm2d(o),
                                  Conv(o, o, 3, padding=1, bias=False), LayerNorm2d(o))

    def forward(self, x):
        x = self.patch_embed(x)
        gh, gw = x.shape[1], x.shape[2]
        x = x + self.pos_embed[:, :gh, :gw]
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x)


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.zeros(2, d // 2))

    def forward(self, coords01):
        c = 2 * math.pi * ((2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(c), torch.cos(c)], -1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["out_dim"]
        self.img_size, self.grid, self.d = cfg["img_size"], cfg["img_size"] // cfg["patch_size"], d
        self.pe_layer = PositionEmbeddingRandom(d)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.no_mask_embed = nn.Embedding(1, d)

    def dense_pe(self):
        r = torch.arange(self.grid, device=self.no_mask_embed.weight.device,
                         dtype=torch.float32)
        grid = (torch.stack(torch.meshgrid(r, r, indexing="ij"), -1) + 0.5) / self.grid
        return self.pe_layer(grid.flip(-1))

    def forward(self, boxes, grid_hw):
        emb = self.pe_layer((boxes.reshape(-1, 2, 2) + 0.5) / self.img_size)
        emb = torch.stack([emb[:, 0] + self.point_embeddings[2].weight[0],
                           emb[:, 1] + self.point_embeddings[3].weight[0]], 1)
        dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            boxes.shape[0], grid_hw[0], grid_hw[1], self.d)
        return emb, dense


class DecoderAttention(nn.Module):
    def __init__(self, dim, heads, downsample=1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj, self.k_proj = Linear(dim, inner), Linear(dim, inner)
        self.v_proj, self.out_proj = Linear(dim, inner), Linear(inner, dim)

    def forward(self, q, k, v):
        def split(x):
            b, n, c = x.shape
            return x.reshape(b, n, self.heads, c // self.heads).transpose(1, 2)

        qh, kh, vh = split(self.q_proj(q)), split(self.k_proj(k)), split(self.v_proj(v))
        attn = torch.softmax((qh / math.sqrt(qh.shape[-1])) @ kh.transpose(-2, -1), -1)
        out = attn @ vh
        b, h, n, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * d))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim, heads, mlp_dim, skip_first_layer_pe):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, heads)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.cross_attn_token_to_image = DecoderAttention(dim, heads, 2)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = MLPBlock(dim, mlp_dim, dim, act="relu")
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.norm4 = LayerNorm(dim, eps=1e-5)
        self.cross_attn_image_to_token = DecoderAttention(dim, heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["out_dim"]
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(d, cfg["decoder_heads"], cfg["decoder_mlp_dim"], i == 0)
            for i in range(cfg["decoder_depth"]))
        self.final_attn_token_to_image = DecoderAttention(d, cfg["decoder_heads"], 2)
        self.norm_final_attn = LayerNorm(d, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(1, h * w, c).expand(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class Up2x2(nn.ConvTranspose2d):
    fp8 = False

    def __init__(self, cin, cout):
        super().__init__(cin, cout, 2, stride=2)

    def forward(self, x):
        x, w = x.permute(0, 3, 1, 2), self.weight
        if self.fp8:
            x, w = fp8(x), fp8(w)
        return F.conv_transpose2d(x, w, self.bias, stride=2).permute(0, 2, 3, 1)


class HyperMLP(nn.Module):
    def __init__(self, din, hidden, dout, depth=3):
        super().__init__()
        dims = [din] + [hidden] * (depth - 1) + [dout]
        self.layers = nn.ModuleList(Linear(a, b) for a, b in zip(dims, dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["out_dim"]
        self.n_mask_tokens = cfg["num_multimask_outputs"] + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.n_mask_tokens, d)
        self.transformer = TwoWayTransformer(cfg)
        self.output_upscaling = nn.Sequential(Up2x2(d, d // 4), LayerNorm2d(d // 4), nn.GELU(),
                                              Up2x2(d // 4, d // 8), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            HyperMLP(d, d, d // 8) for _ in range(self.n_mask_tokens))
        self.iou_prediction_head = HyperMLP(d, d, self.n_mask_tokens)

    def forward(self, image_embedding, image_pe, sparse, dense):
        """Mask logits of token 0 (multimask_output=False): [B, 4h, 4w]."""
        b = sparse.shape[0]
        tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([tokens[None].expand(b, -1, -1), sparse], 1)
        src = image_embedding + dense
        hs, keys = self.transformer(src, image_pe, tokens)
        h, w = src.shape[1], src.shape[2]
        up = F.gelu(self.output_upscaling[1](self.output_upscaling[0](keys.reshape(b, h, w, -1))))
        up = F.gelu(self.output_upscaling[3](up))
        hyper = self.output_hypernetworks_mlps[0](hs[:, 1])
        return torch.einsum("bc,bhwc->bhw", hyper, up)


class Sam(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    def decode_boxes(self, embedding, boxes):
        """embedding [h, w, d] of one image, boxes [P, 4] in input pixels ->
        mask logits [P, 4h, 4w]."""
        gh, gw = embedding.shape[0], embedding.shape[1]
        sparse, dense = self.prompt_encoder(boxes, (gh, gw))
        pe = self.prompt_encoder.dense_pe()[:gh, :gw]
        return self.mask_decoder(embedding[None].expand(boxes.shape[0], *embedding.shape), pe,
                                 sparse, dense)


# layers the port computes in float32 whatever the configuration's dtype
DETIC_F32_LAYERS = ("proposal_generator.centernet_head.agn_hm",
                    "proposal_generator.centernet_head.bbox_pred", "roi_heads.box_predictor.")
SAM_F32_LAYERS = ("mask_decoder.iou_prediction_head.",)


def detic_int8_layers(detic: Detic) -> set:
    """The layers of the configurations that serve int8: Swin's MLPs."""
    return {fc for layer in detic.backbone.bottom_up.layers for blk in layer.blocks
            for fc in (blk.mlp.fc1, blk.mlp.fc2)}


def sam_int8_layers(sam: Sam) -> set:
    """The layers of the configurations that serve int8: SAM's encoder qkv,
    proj and MLP."""
    return {lin for blk in sam.image_encoder.blocks
            for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.lin1, blk.mlp.lin2)}


def set_precision_(root: nn.Module, f32_layers: tuple, quant: set, int_bits: int, low: bool):
    """Each layer's precision: the layers in `quant` at `int_bits` (0:
    float); with `low`, every other layer the port computes in bfloat16
    (all but those under `f32_layers`) in float8 (the control)."""
    for name, m in root.named_modules():
        if not isinstance(m, (Linear, Conv, Up2x2)):
            continue
        f32 = any(name.startswith(p) for p in f32_layers)
        if isinstance(m, Linear):
            m.bits = int_bits if m in quant else 0
        m.fp8 = low and not f32 and m not in quant

"""The yardstick's arithmetic: published peaks, the operations a
configuration's models need, and the bounds of the step and its kernels.

Peaks: NVIDIA H100 SXM data sheet, dense, without sparsity (copied from
chip_smoke.py:295-297 and :3853). The models' operations are counted from
the configuration's shapes as the published architectures define them (2
operations a multiply-add), not from what the port launches: real tokens,
real detections. The kernels' bounds copy chip_smoke.py's arithmetic: the
window-attention branch (:868-875, PERF.md section 6 row 6), the
compaction (:428-438, row 1) and the medoid (:311, :495-520, row 2).
"""

from __future__ import annotations

from perfbench import detectors

PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
MEDOID_OPS_PER_PAIR = 11  # 3 sub, 3 mul, 2 add, sqrt, an add into each of two sums


def _add(into: dict, cls: str, ops: float) -> None:
    into[cls] = into.get(cls, 0.0) + ops


def least_time(work: dict) -> float:
    """Seconds the work takes at the peaks of its classes."""
    return sum(ops / PEAK_OPS_PER_S[cls] for cls, ops in work.items())


def block_window(h: int, w: int, window: int, shift: int):
    win = min(window, max(h, w))
    sh = shift if win < min(h, w) else 0
    if min(h, w) <= window:
        win, sh = min(h, w), 0
    return win, sh


def swin_stages(sw: dict, h: int, w: int):
    """(stage, grid h, grid w, channels) of the Swin trunk on an h x w input."""
    gh, gw = -(-h // sw["patch_size"]), -(-w // sw["patch_size"])
    out = []
    for i, _ in enumerate(sw["depths"]):
        out.append((i, gh, gw, sw["embed_dim"] * 2 ** i))
        gh, gw = -(-gh // 2), -(-gw // 2)
    return out


def sam_grid(cfg: dict, h: int, w: int):
    s = cfg["sam"]
    if s["rect_encode"]:
        scale = s["img_size"] / max(h, w)
        return (-(-round(h * scale) // s["patch_size"]), -(-round(w * scale) // s["patch_size"]))
    g = s["img_size"] // s["patch_size"]
    return g, g


def sam_encoder_work(cfg: dict, images: int, gh: int, gw: int, quant: bool) -> dict:
    s = cfg["sam"]
    d, win, o = s["encoder_dim"], s["window_size"], s["out_dim"]
    t = gh * gw
    tp = -(-gh // win) * win * (-(-gw // win) * win)
    lin = "int8" if quant else "bf16"
    work: dict = {}
    _add(work, "bf16", 2 * t * 3 * s["patch_size"] ** 2 * d)
    for i in range(s["encoder_depth"]):
        if i in s["encoder_global_attn"]:
            _add(work, lin, t * 2 * 4 * d * d)
            _add(work, "bf16", 4 * t * t * d + 2 * t * d * (gh + gw))
        else:
            _add(work, lin, tp * 2 * 4 * d * d)
            _add(work, "bf16", 4 * tp * win * win * d + 2 * tp * d * 2 * win)
        _add(work, lin, t * 2 * 8 * d * d)
    _add(work, "bf16", 2 * t * (d * o + 9 * o * o))
    return {k: v * images for k, v in work.items()}


def sam_decoder_work(cfg: dict, gh: int, gw: int) -> dict:
    """Operations of one box's decode (the image side repeated a box, as
    the published predictor does)."""
    s = cfg["sam"]
    c, t, n = s["out_dim"], gh * gw, 1 + s["num_multimask_outputs"] + 1 + 2
    inner, mlp = c // 2, s["decoder_mlp_dim"]
    work: dict = {}

    def t2i():  # tokens attend to the image
        _add(work, "bf16", 2 * n * c * inner * 2 + 2 * t * c * inner * 2 + 4 * n * t * inner)

    for _ in range(s["decoder_depth"]):
        _add(work, "bf16", 2 * n * c * c * 4 + 4 * n * n * c)
        t2i()
        _add(work, "bf16", 2 * n * c * mlp * 2)
        _add(work, "bf16", 2 * t * c * inner * 2 + 2 * n * c * inner * 2 + 4 * t * n * inner)
    t2i()
    _add(work, "bf16", 2 * 4 * t * (c // 4) * c + 2 * 16 * t * (c // 8) * (c // 4))
    k = s["num_multimask_outputs"] + 1
    _add(work, "bf16", k * 2 * (2 * c * c + c * (c // 8)))
    _add(work, "f32", 2 * k * 16 * t * (c // 8) + 2 * (2 * c * c + c * k))
    return work


def keyframe_work(cfg: dict, traffic: dict):
    """(operations of a keyframe's detector and SAM encode, operations of
    one box's decode) at the traffic's image size."""
    h, w = traffic["image_hw"]
    cams = traffic["cameras"]
    quant = cfg["modes"]["quant_int8"]
    fixed = detectors.of(cfg).work(cfg, traffic, quant)
    gh, gw = sam_grid(cfg, h, w)
    for k, v in sam_encoder_work(cfg, cams, gh, gw, quant).items():
        _add(fixed, k, v)
    return fixed, sam_decoder_work(cfg, gh, gw)


def window_attn_bound_s(cfg: dict, traffic: dict) -> float:
    """Least seconds of a keyframe's window-attention branches in the
    detector's Swin (the heads launch and the projection, bf16, x read in
    f32), counted on the real tokens."""
    sw, images, h, w = detectors.of(cfg).window_attn_input(cfg, traffic)
    total = 0.0
    for i, gh, gw, c in swin_stages(sw, h, w):
        tokens = images * gh * gw
        for j in range(sw["depths"][i]):
            win, _ = block_window(gh, gw, sw["window_size"], 0 if j % 2 == 0 else 1)
            n = win * win
            ops_h = tokens * (2 * 3 * c * c + 4 * n * c)
            bytes_h = tokens * c * 4 + 3 * c * c * 2 + tokens * c * 2
            ops_p = tokens * 2 * c * c
            bytes_p = tokens * c * 2 + c * c * 2 + tokens * c * 2
            total += max(ops_h / PEAK_OPS_PER_S["bf16"], bytes_h / PEAK_BYTES_PER_S)
            total += max(ops_p / PEAK_OPS_PER_S["bf16"], bytes_p / PEAK_BYTES_PER_S)
    return total


def compact_bound_s(rows: int, sources: int, words: int, limit: int, kept: int) -> float:
    """One compaction: the selection read, the kept sources' words read,
    the [rows, words, limit] output written."""
    return (rows * sources + kept * words * 4 + rows * words * limit * 4) / PEAK_BYTES_PER_S


def lift_sizes(cfg: dict, traffic: dict, batch: int) -> dict:
    lift = cfg["lift"]
    n, m, c = lift["max_points"], lift["max_masks"], traffic["cameras"]
    nc = min(lift["max_points_per_camera"], n)
    nu = min(lift["max_points_in_masks"], nc)
    return {"b": batch, "n": n, "m": m, "c": c, "nc": nc, "nu": nu,
            "k": min(lift["max_points_per_mask"], nc, nu), "mw": -(-m // 32),
            "l": lift["max_lane_points"], "h": traffic["image_hw"][0],
            "w": traffic["image_hw"][1]}


def step_compact_bound_s(z: dict, in_image: int, in_union: int, kept_mask: int) -> float:
    """The three compactions of a lift step (camera, union, mask rows),
    with the counts of selected sources that these inputs have."""
    b, c, m = z["b"], z["c"], z["m"]
    return (compact_bound_s(b * c, z["n"], 5, z["nc"], min(in_image, b * c * z["nc"]))
            + compact_bound_s(b * c, z["nc"], 4 + z["mw"], z["nu"], in_union)
            + compact_bound_s(b * m, z["nu"], 4, z["k"], kept_mask))


def medoid_ops(kept_per_mask) -> float:
    """Operations of the medoid sums: every unordered pair of a mask's kept
    points once."""
    pairs = sum(int(k) * int(k) for k in kept_per_mask)
    return (pairs - sum(int(k) for k in kept_per_mask)) // 2 * MEDOID_OPS_PER_PAIR


def medoid_bound_s(z: dict, kept_per_mask) -> float:
    rows = z["b"] * z["m"]
    return max(medoid_ops(kept_per_mask) / PEAK_OPS_PER_S["f32"],
               rows * z["k"] * (3 * 4 + 1 + 4) / PEAK_BYTES_PER_S)


def step_io_bytes(z: dict) -> int:
    """A lift step's inputs read once and outputs written once."""
    b, n, m, c, l_ = z["b"], z["n"], z["m"], z["c"], z["l"]
    inputs = (n * 16 + n + c * 23 * 4 + z["w"] * z["h"] * z["mw"] * 4 + m * 13
              + l_ * 13 + 12 + 1 + 8)
    outputs = m * (12 + 1 + 4 + 1 + 4) + c + m * (12 + 12 + 4 * 4 + 1)
    return b * (inputs + outputs)


def step_bound_s(z: dict, kept_per_mask) -> float:
    return max(step_io_bytes(z) / PEAK_BYTES_PER_S,
               medoid_ops(kept_per_mask) / PEAK_OPS_PER_S["f32"])


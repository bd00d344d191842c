"""The plain reference against the port's plain paths, at a tiny size on
the CPU, on the benchmark's own seeded weights and inputs; the yardstick's
arithmetic against hand-worked shapes; the same seed giving the same inputs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import checks, flops, frontend, program, weights
from perfbench.detectors import detic
from perfbench.reference import models as ref_models
from perfbench.tests import tiny

DEV = torch.device("cpu")


def _models(cfg, seed=5):
    with torch.device("meta"):
        skel = {**detic.skeleton(cfg), "sam": ref_models.Sam(cfg["sam"])}
    state = weights.make_state(skel, seed, DEV, dtype=torch.float32)
    return state, detic.text_inputs(cfg, seed, DEV)


def test_same_seed_same_inputs_other_seed_other_inputs():
    cfg, traffic = tiny.load("tiny"), tiny.load("tiny_lift")

    def inputs(seed):
        rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed)
        kf = frontend.make_keyframe(traffic, cfg["lift"], rng, DEV)
        dets = frontend.pool_detections(tiny.load("tiny_e2e"), 4, cfg["mask_stage"], rng)[0]
        return kf, dets, frontend.blob_planes(tiny.load("tiny_e2e"), 1, gen, DEV), \
            _models(cfg, seed)[0]

    a, b, c = inputs(2**31 + 7), inputs(2**31 + 7), inputs(12)
    for key in a[0]:
        assert np.array_equal(a[0][key], b[0][key])
    assert not np.array_equal(a[0]["points"], c[0]["points"])
    assert all(np.array_equal(a[1][k], b[1][k]) for k in a[1])
    assert not np.array_equal(a[1]["boxes"], c[1]["boxes"])
    assert torch.equal(a[2], b[2]) and not torch.equal(a[2], c[2])
    assert all(torch.equal(a[3]["sam"][k], b[3]["sam"][k]) for k in a[3]["sam"])
    assert not torch.equal(a[3]["sam"]["image_encoder.pos_embed"],
                           c[3]["sam"]["image_encoder.pos_embed"])
    # every seed decodes the same mix of prompt buckets, at other places
    traffic_e2e, mask_cfg = tiny.load("tiny_e2e"), cfg["mask_stage"]
    for seed in (1, 2, 2**31 + 7):
        pool = frontend.pool_detections(traffic_e2e, 4, mask_cfg, np.random.default_rng(seed))
        assert sum(frontend.small_bucket(d, mask_cfg) for d in pool) == \
            traffic_e2e["small_bucket_frames"]
        lo, hi = traffic_e2e["detections_per_camera"]
        counts = np.stack([d["valid"].sum(1) for d in pool])
        assert counts.min() >= lo and counts.max() <= hi


@pytest.mark.parametrize("conf", ["tiny", "tiny-rect-int8"])
def test_reference_models_match_the_ports_float32_modules(conf):
    from cm3d_tpu_torch.models.detic import Detic
    from cm3d_tpu_torch.models.sam import Sam

    cfg = dict(tiny.load(conf), precision="float32")
    state, clf = _models(cfg)
    dcfg, scfg = detic.port_config(cfg), program.sam_config(cfg)
    import dataclasses
    dcfg = dataclasses.replace(dcfg, swin=dataclasses.replace(dcfg.swin, fused_attn=False))
    pdet, psam = Detic(dcfg).eval(), Sam(scfg).eval()
    pdet.load_state_dict(state["detic"])
    psam.load_state_dict(state["sam"])
    rdet, rsam = checks.build_reference(detic, cfg, state, DEV)
    images = np.random.default_rng(0).integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    x = checks.normalised(images, DEV)
    cap = {}
    hooks = [m.register_forward_hook(lambda m_, i_, o, k=k: cap.setdefault(k, []).append(o))
             for k, m in detic.captures(pdet)]
    with torch.no_grad():
        pdet(x, clf)
        cap["embedding"] = psam.encode_image(x if cfg["sam"]["rect_encode"] else x)
    prog = checks.program_side(detic, cap)
    ref = checks.model_side(detic, rdet, rsam, clf, images, cfg, prog)
    got = checks.compare_models(detic, prog, ref)
    got.pop("proposal_tie_share")  # read beside the numbers, compared with nothing
    assert max(got.values()) < 1e-4, got
    with torch.no_grad():
        boxes = torch.tensor([[4.0, 5.0, 30.0, 40.0], [10.0, 2.0, 60.0, 20.0]])
        lp, _ = psam.decode_boxes(cap["embedding"][0], boxes)
        lr = rsam.decode_boxes(ref["embedding"][0], boxes)
    assert checks.rel(lp, lr) < 1e-4


def test_reference_w8a8_matches_the_ports_int8_product():
    from cm3d_tpu_torch.ops.quant import dynamic_int8_matmul, quantize_weight

    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(40, 64, generator=g), torch.randn(24, 64, generator=g)
    lin = ref_models.Linear(64, 24)
    lin.weight.data, lin.bias.data = w, torch.zeros(24)
    lin.bits = 8
    w_q, s = quantize_weight(w)
    assert checks.rel(lin(x), dynamic_int8_matmul(x, w_q, s, torch.zeros(24))) < 1e-6


def test_reference_lift_matches_the_ports_step():
    from cm3d_tpu_torch.datasets.types import stack_keyframes, to_device

    cfg, traffic = tiny.load("tiny"), tiny.load("tiny_lift")
    rng = np.random.default_rng(9)
    kfs = [frontend.make_keyframe(traffic, cfg["lift"], rng, DEV) for _ in range(3)]
    step = program.make_step(cfg, DEV)
    _, boxes = step(to_device(stack_keyframes([program.port_keyframe(k) for k in kfs]).frames,
                              DEV))
    f = checks.lift_inputs(kfs, [k["mask_bits"] for k in kfs], [None] * 3, DEV)
    ref, work = checks.lift_boxes(f, cfg["lift"])
    prog = {k: getattr(boxes, k).numpy() for k in ("centers", "sizes", "yaws", "labels", "keep")}
    bad, n = checks.box_mismatch(prog, ref, f["mask_valid"])
    assert n > 10 and bad == 0 and int(ref.keep.sum()) > 5
    assert int(work.in_image.sum()) > 0 and int(work.kept_mask.sum()) > 0


def test_arithmetic_against_hand_worked_shapes():
    cfg, e2e = tiny.load("tiny"), tiny.load("tiny_e2e")
    full = __import__("json").loads((tiny.DATA.parents[1] / "configs" /
                                     "detic-swinb_sam-vith_nusc.json").read_text())
    full_traffic = __import__("json").loads((tiny.DATA.parents[1] / "traffic" /
                                             "e2e_dense.json").read_text())
    # PERF.md section 6 row 6: proj 0.2711 ms by bytes, heads 0.6188 by operations
    # (chip_smoke.py's arithmetic), a Detic forward of six 1024x576 cameras
    assert flops.window_attn_bound_s(full, full_traffic) * 1e3 == pytest.approx(0.8899, abs=2e-4)
    # one compaction: 2 x 10 selection bytes, 3 kept x 4 words x 4 bytes, 2 x 4 x 5 x 4 out
    assert flops.compact_bound_s(2, 10, 4, 5, 3) == pytest.approx((20 + 48 + 160) / 3.35e12)
    # masks of 3 and 4 kept points: 3 + 6 unordered pairs, 11 operations each
    assert flops.medoid_ops([3, 4]) == 9 * 11
    assert flops.least_time({"bf16": 989e12, "int8": 1979e12, "f32": 67e12}) == \
        pytest.approx(3.0)
    # a global ViT block on a 2 x 3 grid, dim 4: linears 2*6*12*16, attention 4*36*4 +
    # rel-pos 2*6*4*5, MLP on top: 2*6*8*16
    one = dict(cfg, sam=dict(cfg["sam"], encoder_depth=1, encoder_global_attn=[0],
                             encoder_dim=4, patch_size=1, out_dim=1))
    w = flops.sam_encoder_work(one, 1, 2, 3, False)
    assert w["bf16"] == 2 * 6 * 3 * 4 + 2 * 6 * 4 * 16 + 4 * 36 * 4 + 2 * 6 * 4 * 5 \
        + 2 * 6 * 8 * 16 + 2 * 6 * (4 + 9)
    assert flops.sam_grid(cfg, *e2e["image_hw"]) == (4, 4)

"""The port's benchmark entry (`python -m cm3d_tpu_torch.bench`) against the
JAX package's `bench.py`, and the benches it drives.

Every argv goes to both entries with the bench functions stubbed: each
gives the same refusal text, or calls the same bench function with the
same keyword arguments; an accepted port run prints exactly one JSON line
on stdout. `bench_e2e_fast_profile` is held to JAX's on one stubbed
`bench_e2e`, and `bench_mask_stage` / `bench_e2e` build the rect encode
and the other SAM sizes (tiny models at a 64x48 camera).
"""

import dataclasses
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import cm3d_tpu.benchmarks as jax_benchmarks
import cm3d_tpu.utils.jax_setup as jax_setup

import cm3d_tpu_torch.benchmarks as bench
import cm3d_tpu_torch.config as config
from cm3d_tpu_torch import bench as entry
from cm3d_tpu_torch.config import LiftStageConfig
from cm3d_tpu_torch.models import detic as detic_mod
from cm3d_tpu_torch.models import sam as sam_mod
from cm3d_tpu_torch.models.common import init_weights
from cm3d_tpu_torch.models.detic import DETIC_TEST, Detic
from cm3d_tpu_torch.models.sam import SAM_TEST, SAM_VIT_L, Sam
from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

BENCHES = ("bench_lift", "bench_mask_stage", "bench_e2e", "bench_e2e_fast_profile",
           "bench_train", "bench_fusion_train")


def _jax_entry():
    path = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("jax_bench_entry", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stub(monkeypatch, module, calls):
    for name in BENCHES:
        def stub(_name=name, **kw):
            calls.append((_name, kw))
            return {"metric": _name, "value": 1.5}
        monkeypatch.setattr(module, name, stub)


def _run(fn):
    """(the SystemExit text, or None; the bench calls)."""
    try:
        fn()
    except SystemExit as e:
        return str(e.code)
    return None


REFUSED = [
    ["--stage"],
    ["--stage", "lfit"],
    ["--stage", "--rect_encode"],
    ["--stage", "e2e", "--quant_static"],
    ["--stage", "masks", "--sam_size"],
    ["--stage", "masks", "--sam_size", "vit_x"],
    ["--stage", "e2e", "--profile"],
    ["--stage", "e2e", "--profile", "slow"],
    ["--stage", "lift", "--rect_encode"],
    ["--quant_int8"],
    ["--stage", "train", "--sam_size", "vit_l"],
    ["--stage", "fusion_train", "--quant_int8"],
    ["--profile", "fast"],
    ["--stage", "masks", "--profile", "fast"],
    ["--stage", "e2e", "--profile", "fast", "--quant_int8"],
    ["--stage", "e2e", "--profile", "fast", "--rect_encode"],
    ["--stage", "e2e", "--profile", "fast", "--sam_size", "vit_b"],
    ["--stage", "masks", "--swin_camera"],
    ["--camera_bf16"],
    ["--stage", "e2e", "--no_camera_fused"],
    ["--stage", "fusion_train", "--no_camera_fused"],
    ["--stage", "fusion_train", "--camera_bf16", "--no_camera_fused"],
]
ACCEPTED = [
    [],
    ["--stage", "lift"],
    ["--stage", "masks"],
    ["--stage", "masks", "--rect_encode", "--sam_size", "vit_l"],
    ["--stage", "masks", "--quant_int8", "--quant_static"],
    ["--stage", "e2e"],
    ["--stage", "e2e", "--quant_int8", "--sam_size", "vit_b"],
    ["--stage", "e2e", "--sam_size", "vit_h", "--rect_encode"],
    ["--stage", "e2e", "--profile", "fast"],
    ["--stage", "e2e", "--profile", "fast", "--sam_size", "vit_h"],
    ["--stage", "train"],
    ["--stage", "fusion_train"],
    ["--stage", "fusion_train", "--swin_camera", "--camera_bf16"],
    ["--stage", "fusion_train", "--swin_camera", "--no_camera_fused"],
]


@pytest.mark.parametrize("argv", REFUSED + ACCEPTED, ids=lambda a: " ".join(a) or "default")
def test_entry_parses_as_jax(argv, monkeypatch, capsys):
    monkeypatch.setattr(jax_setup, "enable_compilation_cache", lambda *a, **k: None)
    jax_calls, port_calls = [], []
    _stub(monkeypatch, jax_benchmarks, jax_calls)
    _stub(monkeypatch, bench, port_calls)
    jax_bench = _jax_entry()
    monkeypatch.setattr("sys.argv", ["bench.py"] + argv)
    want = _run(jax_bench.main)
    jax_out = capsys.readouterr().out
    got = _run(lambda: entry.main(argv))
    out = capsys.readouterr().out
    assert got == want
    assert port_calls == jax_calls
    if argv in REFUSED:
        assert want is not None and not port_calls and out == ""
        return
    assert want is None and len(port_calls) == 1
    lines = out.splitlines()
    assert len(lines) == 1 and out.endswith("\n")
    line, jax_line = json.loads(lines[0]), json.loads(jax_out.splitlines()[-1])
    assert line["metric"] == port_calls[0][0] and line["value"] == 1.5
    assert set(line) == set(jax_line)
    if not argv:  # the default: the lift line, with the port's own note
        assert "--stage e2e" in line["note"] and "MASK_BENCH" not in line["note"]


def test_entry_sends_everything_else_to_stderr(monkeypatch, capfd):
    """What the run prints, from Python or on file descriptor 1 (a child
    process, native code), reaches stderr; stdout holds the result alone."""
    def noisy_lift():
        print("a kernel build says something")
        os.write(1, b"so does native code\n")
        return {"metric": "lift_keyframes_per_sec_per_chip", "value": 2.0}

    monkeypatch.setattr(bench, "bench_lift", noisy_lift)
    entry.main(["--stage", "lift"])
    out, err = capfd.readouterr()
    assert out.splitlines() == [json.dumps({"metric": "lift_keyframes_per_sec_per_chip",
                                            "value": 2.0})]
    assert "a kernel build says something" in err and "so does native code" in err


def test_entry_refuses_without_a_card():
    """The entry runs on CUDA and does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["--stage", "lift"])


# --- bench_e2e_fast_profile (tests/test_benchmarks_profile.py on the port) ---

def _fake_bench_e2e(calls):
    def fake(dtype="bfloat16", n_frames=12, batch_size=4, rect_encode=False, quant_int8=False,
             sam_size="vit_h", device=None):
        calls.append((sam_size, rect_encode, quant_int8, dtype, n_frames, batch_size))
        speed = {"vit_h": 700.0, "vit_l": 300.0, "vit_b": 150.0}[sam_size]
        if rect_encode:
            speed *= 0.8
        return {
            "metric": "e2e_keyframes_per_sec_per_chip",
            "value": round(1000.0 / speed, 3),
            "ms_per_keyframe": speed,
            "boxes_kept": 1351,
            "rect_encode": rect_encode,
            "quant_int8": quant_int8,
            "sam_size": sam_size,
        }
    return fake


def test_fast_profile_aggregation(monkeypatch):
    calls = []
    monkeypatch.setattr(bench, "bench_e2e", _fake_bench_e2e(calls))
    out = bench.bench_e2e_fast_profile(device="cpu")

    # the grid covers the exact baseline and all three composed modes
    grid = [c[:3] for c in calls]
    assert grid == [("vit_h", False, False), ("vit_h", True, True), ("vit_l", True, True),
                    ("vit_b", True, True)]
    assert out["metric"] == "e2e_fast_profile_keyframes_per_sec_per_chip"
    assert out["fastest_profile"] == "vit_b_rect_int8"
    np.testing.assert_allclose(out["value"], round(1000.0 / 120.0, 3), rtol=1e-9)
    assert out["boxes_invariant_across_modes"] is True

    by_name = {p["profile"]: p for p in out["points"]}
    assert by_name["exact_vit_h"]["accuracy_envelope"] == ["exact baseline"]
    # composed points carry every applicable envelope, each naming where
    # its figure was measured on the port, and no TPU figure
    env = by_name["vit_b_rect_int8"]["accuracy_envelope"]
    assert len(env) == 3
    assert "square encode" in env[0] and "rel err" in env[0]
    assert "int8" not in env[0] and "bf16" in env[1] and "vit_h" in env[2]
    for text in bench._SPEED_MODE_ACCURACY.values():
        assert "chip_smoke.py" in text or "not measured" in text
        assert "TPU" not in text and "on-chip" not in text and "scripts/" not in text
    for text in env[:2]:  # the measured ones name the card
        assert "NVIDIA H100" in text and " W)" in text


def test_fast_profile_flags_boxes_divergence(monkeypatch):
    def fake_bench_e2e(**kw):
        return {
            "value": 1.0, "ms_per_keyframe": 100.0,
            "boxes_kept": 10 if kw.get("sam_size") == "vit_b" else 20,
            "rect_encode": kw.get("rect_encode", False),
            "quant_int8": kw.get("quant_int8", False),
            "sam_size": kw.get("sam_size", "vit_h"),
        }

    monkeypatch.setattr(bench, "bench_e2e", fake_bench_e2e)
    out = bench.bench_e2e_fast_profile(device="cpu")
    assert out["boxes_invariant_across_modes"] is False


def test_fast_profile_equals_jax_on_one_stub(monkeypatch):
    """One stub under both packages: the same calls and the same dict, apart
    from the envelopes' texts (the port quotes its own measurements) and
    the note."""
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_benchmarks, "bench_e2e", _fake_bench_e2e(jax_calls))
    monkeypatch.setattr(bench, "bench_e2e", _fake_bench_e2e(port_calls))
    want = jax_benchmarks.bench_e2e_fast_profile(n_frames=6, batch_size=2)
    got = bench.bench_e2e_fast_profile(n_frames=6, batch_size=2, device="cpu")
    assert port_calls == jax_calls

    def texts_out(d):
        d = dict(d, note=None)
        d["points"] = [dict(p, accuracy_envelope=len(p["accuracy_envelope"])
                            if p["accuracy_envelope"] != ["exact baseline"] else "exact")
                       for p in d["points"]]
        return d

    assert texts_out(got) == texts_out(want)
    assert got["note"] != want["note"] and "MASK_BENCH" not in got["note"]


# --- the benches' rect encode and SAM sizes, at a tiny geometry ---

def test_production_fake_modules_builds_the_sam_size(monkeypatch):
    """production_fake_modules(sam_size, rect_encode) builds SAM from
    sam_config_for(sam_size) with the rect encode set, and Detic from
    `seed` before SAM at every size (the constructors stubbed: no
    full-width module is built here)."""
    built, seeds = [], []
    monkeypatch.setattr(sam_mod, "Sam", lambda cfg: built.append(cfg) or torch.nn.Linear(1, 1))
    monkeypatch.setattr(detic_mod, "Detic", lambda cfg: built.append(cfg) or torch.nn.Linear(1, 1))
    monkeypatch.setattr("cm3d_tpu_torch.models.common.init_weights",
                        lambda m, gen: seeds.append(gen.initial_seed()) or m)
    for size, rect in (("vit_l", True), ("vit_b", False), ("vit_h", True)):
        built.clear()
        bench.production_fake_modules("bfloat16", "cpu", seed=3, sam_size=size, rect_encode=rect)
        detic_cfg, sam_cfg = built
        assert sam_cfg == dataclasses.replace(sam_mod.sam_config_for(size), dtype="bfloat16",
                                              rect_encode=rect)
        assert detic_cfg.dtype == "bfloat16" and detic_cfg.swin.dtype == "bfloat16"
    assert built[1].encoder_dim == 1280 and SAM_VIT_L.encoder_dim == 1024
    assert seeds == [3, 4] * 3


def test_benches_build_rect_and_sam_size_at_a_tiny_geometry(monkeypatch, one_torch_thread):
    """bench_mask_stage / bench_e2e with rect_encode and another sam_size
    hand both to the model build (here the tiny modules, the rect encode
    set on SAM_TEST), name both modes in their results, and keep the
    content swap: the rect encode's e2e keeps the boxes the square one
    keeps (the decode still asks for the camera-sized planes)."""
    built = []

    def tiny_modules(dtype, device, seed, fused_window_attn, vocabulary, sam_size="vit_h",
                     rect_encode=False):
        gen = torch.Generator()
        clf = np.random.default_rng(seed).standard_normal(
            (DETIC_TEST.embed_dim, len(vocabulary))).astype(np.float32)
        sam = Sam(dataclasses.replace(SAM_TEST, rect_encode=rect_encode))
        built.append((sam_size, sam.cfg))
        return (init_weights(Detic(DETIC_TEST), gen.manual_seed(seed)), clf,
                init_weights(sam, gen.manual_seed(seed + 1)))

    monkeypatch.setattr(bench, "production_fake_modules", tiny_modules)
    monkeypatch.setattr(bench, "IMG_H", 48)
    monkeypatch.setattr(bench, "IMG_W", 64)
    small = LiftStageConfig(max_points=8192, max_points_per_mask=256, max_points_per_camera=4096,
                            max_points_in_masks=1024, max_lane_points=512)
    monkeypatch.setattr(config, "LiftStageConfig", lambda: small)
    out = bench.bench_mask_stage("float32", n_frames=2, io_sleep=0.0, device="cpu",
                                 rect_encode=True, sam_size="vit_l")
    assert (out["rect_encode"], out["sam_size"], out["quant_int8"]) == (True, "vit_l", False)
    assert np.isfinite(out["value"]) and out["warmup_masks"] > 0
    rect = bench.bench_e2e("float32", n_frames=2, batch_size=2, device="cpu",
                           rect_encode=True, sam_size="vit_b")
    assert (rect["rect_encode"], rect["sam_size"]) == (True, "vit_b")
    square = bench.bench_e2e("float32", n_frames=2, batch_size=2, device="cpu")
    assert (square["rect_encode"], square["sam_size"]) == (False, "vit_h")
    assert rect["boxes_kept"] == square["boxes_kept"] > 0
    assert [(s, c.rect_encode) for s, c in built] == [("vit_l", True), ("vit_b", True),
                                                      ("vit_h", False)]

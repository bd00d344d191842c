"""The harness's run at a tiny size on the CPU: sound runs come out
correct; the control (the nearest lower precision) and the program broken
underneath come out not correct; the run loads no JAX and the reference
nothing of the program; the entry refuses without a card or a program.
The full-size runs are on the card (`cuda`)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_sound_runs_are_correct(cell):
    r = tiny.run(cell, seed=2**31 + 11)
    assert r["correct"], r["checks"]
    assert r["metrics"]["keyframes_per_s"]["value"] > 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks" and r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell,control", [(c, "reference") for c in tiny.CELLS]
                         + [("tiny.e2e", "program_int8")])
def test_the_control_is_not_correct(cell, control):
    assert not tiny.run(cell, control=control)["correct"]


def test_a_wrong_camera_in_the_cascade_is_not_correct(monkeypatch):
    """The second camera's proposals pooled from the first camera's
    features (a wrong batch index in the ROI pooling): only the cascade's
    outputs change, and the content swap hides them from what follows."""
    from cm3d_tpu_torch.models import detic

    pool = detic.multilevel_roi_align

    def wrong(levels, boxes, *a, **k):
        return pool({n: torch.cat([v[:1], v[:1], v[2:]]) for n, v in levels.items()}, boxes,
                    *a, **k)

    monkeypatch.setattr(detic, "multilevel_roi_align", wrong)
    r = tiny.run("tiny.e2e")
    assert not r["correct"]
    assert r["checks"]["detic_cascade_rel"]["value"] > r["checks"]["detic_cascade_rel"]["limit"]


@pytest.mark.parametrize("cell", ["tiny.e2e", "tiny.lift"])
def test_a_traced_run_reports_its_per_layer_metrics(cell):
    r = tiny.run(cell, trace=1)
    assert r["correct"], r["checks"]
    assert r["device"]["window_s"] > 0 and "device_idle_pct" in r["metrics"]
    assert "keyframes_per_s" not in r["metrics"] and "breakdown" in r


def _half_batch(step):
    """The keyframe step with the second half of the batch left out: its
    boxes are the first half's."""
    def run(frames, *a, **k):
        lift, boxes = step(frames, *a, **k)
        h = boxes.keep.shape[0] // 2
        return lift, type(boxes)(*[torch.cat([x[:h], x[:boxes.keep.shape[0] - h]])
                                   for x in boxes])
    return run


def _altered(step):
    """Boxes altered where they are produced: centres moved by 5 cm."""
    def run(frames, *a, **k):
        lift, boxes = step(frames, *a, **k)
        return lift, boxes._replace(centers=boxes.centers + 0.05)
    return run


def _stale(step):
    """A step that hands back its first answer again and again."""
    first = []

    def run(frames, *a, **k):
        if not first:
            first.append(step(frames, *a, **k))
        return first[0]
    return run


@pytest.mark.parametrize("cell", ["tiny.e2e", "tiny.lift"])
@pytest.mark.parametrize("fault", [_half_batch, _altered, _stale])
def test_a_broken_lift_step_is_not_correct(cell, fault, monkeypatch):
    from cm3d_tpu_torch.parallel import pipeline

    monkeypatch.setattr(pipeline, "keyframe_step", fault(pipeline.keyframe_step))
    assert not tiny.run(cell)["correct"]


@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_a_broken_encode_is_not_correct(fault, monkeypatch):
    from cm3d_tpu_torch.models.sam import Sam

    encode, first = Sam.encode_image, []

    def broken(self, x):
        out = encode(self, x)
        if fault == "altered":
            return out * 1.05
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(Sam, "encode_image", broken)
    assert not tiny.run("tiny.e2e")["correct"]


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program():
    code = ("import sys, json; from perfbench.tests import tiny; from perfbench import harness; "
            "tiny.run('tiny.e2e'); print(json.dumps(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    code = ("import sys, json; import perfbench.checks, perfbench.reference.models, "
            "perfbench.reference.lift, perfbench.flops, perfbench.frontend, perfbench.weights, "
            "perfbench.detectors.detic; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'cm3d_tpu_torch', 'cm3d_tpu', 'jax', 'jaxlib'})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert json.loads(out.stdout.strip()) == []


def test_the_entry_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "perfbench", "--workload", "vith.lift",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_the_entry_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", ".out"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "perfbench", "--workload", "vith.lift",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vith.lift", "vith.e2e.dense", "vitb-rect-int8.e2e.dense"])
def test_a_cell_runs_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "perfbench", "--workload", cell, "--seed",
                          str(2**31 + 5), "--seconds", "5", "--trace", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

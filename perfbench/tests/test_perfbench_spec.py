"""BENCHMARK.json against the benchmark's contract, and the harness as data:
a cell, a configuration, a traffic mix and a metric are added by adding
files and entries, with no file edited."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from perfbench import detectors, harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_names_and_units():
    b = _spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(b["command"]) <= 32 and b["paths"] == ["perfbench"]
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[key]]
    for n in names + [w["traffic"] for w in b["workloads"]] + [w["config"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for text in [c["source"] for c in b["configs"]] + [w["why"] for w in b["workloads"]] + \
            [m["layer"] for m in b["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    b = _spec()
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for w in b["workloads"]:
        files = harness.cell_files(b, w["name"])
        assert files["config"]["name"] == w["config"] and files["config"]["reduced"] == []
        assert files["traffic"]["loop"] in ("e2e", "lift")
        if files["traffic"]["loop"] == "e2e":
            det = detectors.of(files["config"])
            assert all(callable(getattr(det, f)) for f in detectors.FUNCTIONS), det
        e2e, layer = harness.metrics_of(b, w["name"])
        reported = {m["name"] for m in e2e}
        assert "setup_s" in reported and len(reported) >= 2 and layer
        for m in layer:
            assert m["moves"] in reported
            assert callable(__import__(f"perfbench.metrics.{m['name']}",
                                       fromlist=["read"]).read)
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_config_traffic_and_metric_are_added_as_files(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", ".out"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs/detic-swinb_sam-vith_nusc.json").read_text())
    (pb / "configs/dummy-config.json").write_text(json.dumps(dict(cfg, name="dummy-config")))
    traffic = json.loads((pb / "traffic/e2e_dense.json").read_text())
    mix = dict(traffic, detections_per_camera=[2, 8])
    (pb / "traffic/dummy_mix.json").write_text(json.dumps(mix))
    (pb / "limits/dummy.cell.json").write_text(json.dumps({"box_mismatch_share": 0.5}))
    (pb / "metrics/dummy_metric.py").write_text("def read(ctx):\n    return 42.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="dummy-config",
                                file="perfbench/configs/dummy-config.json"))
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy-config",
                              "traffic": "dummy_mix", "chips": 1, "why": "a dummy"})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "keyframes_per_s", "workloads": ["dummy.cell"]})
    spec["end_to_end"] = [dict(m, workloads=m.get("workloads", []) + ["dummy.cell"])
                          if "workloads" in m else m for m in spec["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=m["workloads"] + ["dummy.cell"])
                         if m["name"] == "device_idle_pct" else m for m in spec["per_layer"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    assert all(after[k] == v for k, v in before.items() if k != "BENCHMARK.json")
    code = ("import json; from perfbench import harness; b = harness.spec(); "
            "f = harness.cell_files(b, 'dummy.cell'); e, l = harness.metrics_of(b, 'dummy.cell'); "
            "import importlib; m = importlib.import_module('perfbench.metrics.dummy_metric'); "
            "print(json.dumps([f['config']['name'], f['traffic']['detections_per_camera'], "
            "f['limits'], [x['name'] for x in l], m.read({})]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got[0] == "dummy-config" and got[1] == [2, 8]
    assert got[2] == {"box_mismatch_share": 0.5}
    assert "dummy_metric" in got[3] and "device_idle_pct" in got[3] and got[4] == 42.0


STAND_IN = '''"""A stand-in detector: Detic's module under another name."""

from perfbench.detectors import detic
from perfbench.detectors.detic import *  # noqa: F401,F403


def text_inputs(cfg, seed, device):
    print("stand-in text inputs")
    return detic.text_inputs(cfg, seed, device)
'''


def test_a_detector_is_added_as_files(tmp_path):
    """A second detector's module, a configuration that names it, its
    traffic, limits and cell, added with no file edited but BENCHMARK.json;
    its tiny cell runs through the harness's own run_cell to `correct`."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", ".out"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path)
    pb, data = tmp_path / "perfbench", ROOT / "perfbench/tests/data"
    (pb / "detectors/stand_in.py").write_text(STAND_IN)
    cfg = json.loads((data / "tiny.json").read_text())
    (pb / "configs/stand-in-tiny.json").write_text(
        json.dumps(dict(cfg, name="stand-in-tiny", detector="stand_in")))
    shutil.copy(data / "tiny_e2e.json", pb / "traffic/stand_in_e2e.json")
    limits = json.loads((data / "limits.json").read_text())["tiny.e2e"]
    (pb / "limits/stand-in.e2e.json").write_text(json.dumps(limits))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="stand-in-tiny",
                                file="perfbench/configs/stand-in-tiny.json"))
    spec["workloads"].append({"name": "stand-in.e2e", "config": "stand-in-tiny",
                              "traffic": "stand_in_e2e", "chips": 1, "why": "a stand-in"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    assert all(after[k] == v for k, v in before.items() if k != "BENCHMARK.json")
    code = ("import argparse, json, time, torch; from perfbench import harness; "
            "b = harness.spec(); f = harness.cell_files(b, 'stand-in.e2e'); "
            "a = argparse.Namespace(workload='stand-in.e2e', seed=2**31 + 3, seconds=0.5, "
            "trace=0, control=None); "
            "r, _ = harness.run_cell(f, a, time.perf_counter(), torch.device('cpu'), b); "
            "print(json.dumps([r['correct'], sorted(r['checks']), sorted(r['metrics'])]))")
    env = dict(os.environ, PYTHONPATH=str(ROOT))  # the program, beside the copy's perfbench
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "stand-in text inputs" in out.stdout
    correct, checks, metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and checks == sorted(limits), out.stderr[-4000:]
    assert metrics == ["keyframes_per_s", "setup_s"]

"""Tiny cells for the benchmark's tests on the CPU: the harness's run
without its look for a card, at sizes a test run holds (data/)."""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from perfbench import harness

DATA = Path(__file__).resolve().parent / "data"
CELLS = {  # name: (configuration, traffic)
    "tiny.e2e": ("tiny", "tiny_e2e"),
    "tiny-rect-int8.e2e": ("tiny-rect-int8", "tiny_e2e"),
    "tiny.lift": ("tiny", "tiny_lift"),
}


def load(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def files(cell: str, limits: dict | None = None) -> dict:
    conf, traffic = CELLS[cell]
    return {"cell": {"name": cell, "config": conf, "traffic": traffic, "chips": 1},
            "config": load(conf), "traffic": load(traffic),
            "limits": limits if limits is not None else load("limits")[cell]}


EVERY_CELL = ("device_idle_pct", "peak_mem_gib")  # per-layer metrics the tiny cells report


def bench() -> dict:
    spec = harness.spec()
    spec["end_to_end"] = [dict(m, workloads=list(CELLS)) for m in spec["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=list(CELLS)) if m["name"] in EVERY_CELL else m
                         for m in spec["per_layer"]]
    return spec


def run(cell: str, seed: int = 3, trace: int = 0, control: str | None = None, seconds: float = 0.5,
        limits: dict | None = None) -> dict:
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace,
                              control=control)
    result, _ = harness.run_cell(files(cell, limits), args, time.perf_counter(),
                                 torch.device("cpu"), bench())
    return result

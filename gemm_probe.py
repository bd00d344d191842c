#!/usr/bin/env python3
"""Device times of the window-attention GEMM kernels at the main path's
bf16 shapes, and the host cost of a wrapper call, on one CUDA card.

    python3 gemm_probe.py [--tile 128|256]

Measures the cm3d_tpu_torch package of the current directory, so that two
trees compare on one card: run the script from each checkout in turns.
Shapes: Swin-B's four stages (a Detic forward over 6 cameras at 1024x576,
shift 3) and ViT-H's square and rect grids (window 14), random bf16 inputs
from seed 0. For each: the device ms a launch of qkv_gemm_kernel (inside
the heads launcher) and of proj_gemm_kernel (torch.profiler), then the host
microseconds a call of the heads and of the projection wrapper costs
(enqueue only, 5 rounds of 50 calls). `--tile 128` builds the sources with
the GEMM's tile width fixed at 128 columns, `--tile 256` at 256 wherever N
splits into 256-wide tiles (into cm3d_tpu_torch/kernels/_build/fixed_tile/),
instead of the width the launcher picks by shape. One JSON line per shape.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import time

import numpy as np

SHAPES = (  # b, h, w, c, heads, window, shift
    (6, 144, 256, 128, 4, 7, 3), (6, 72, 128, 256, 8, 7, 3), (6, 36, 64, 512, 16, 7, 3),
    (6, 18, 32, 1024, 32, 7, 3), (1, 64, 64, 1280, 16, 14, 0), (1, 36, 64, 1280, 16, 14, 0))


def fix_tile_width(build, width: int) -> None:
    """Point the build at a copy of csrc/ whose tile_width returns `width`
    (256 only where N % 256 == 0)."""
    root = build._BUILD_DIR / "fixed_tile"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build._CSRC, root / "csrc")
    hdr = root / "csrc" / "window_attn_common.cuh"
    body = "return 128;" if width == 128 else "return N % 256 == 0 ? 256 : 128;"
    text, n = re.subn(r"(inline int tile_width\([^)]*\) \{).*?\n\}", r"\1\n  " + body + "\n}",
                      hdr.read_text(), count=1, flags=re.S)
    if n != 1:
        raise SystemExit("gemm_probe: no tile_width in csrc/window_attn_common.cuh")
    hdr.write_text(text)
    build._CSRC, build._BUILD_DIR = root / "csrc", root / "_build"


def device_ms(torch, fn, name: str, reps: int = 10):
    """Device ms a launch of the kernel whose name holds `name`, over `reps`
    calls of fn (None when the profiler recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and name in e.key and e.count:
            return e.device_time_total / 1e3 / e.count
    return None


def host_us(torch, fn, rounds: int = 5, calls: int = 50) -> list:
    """Host microseconds a call of fn, enqueue only, per round."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return out


def main(argv) -> int:
    sys.path.insert(0, os.getcwd())  # the package of the tree it runs from
    import torch

    if not torch.cuda.is_available():
        print("gemm_probe: no CUDA device", file=sys.stderr)
        return 2
    from cm3d_tpu_torch.kernels import build
    from cm3d_tpu_torch.kernels.window_attn import window_attn_heads, window_attn_proj
    from cm3d_tpu_torch.kernels.window_attn_relpos import window_attn_relpos_heads

    tile = int(argv[argv.index("--tile") + 1]) if "--tile" in argv else None
    if tile not in (None, 128, 256):
        raise SystemExit("gemm_probe: --tile takes 128 or 256")
    if tile:
        fix_tile_width(build, tile)
    build.build_all(("window_attn", "window_attn_relpos"))
    bf16, dev = torch.bfloat16, torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)

    for b, h, w, c, heads, win, shift in SHAPES:
        hp, wp = -(-h // win) * win, -(-w // win) * win
        x = t(rng.standard_normal((b, h, w, c)), bf16)
        ln_w, ln_b = t(1 + 0.1 * rng.standard_normal(c)), t(0.1 * rng.standard_normal(c))
        wqkv = t(rng.standard_normal((3 * c, c)) / np.sqrt(c), bf16)
        bqkv = t(0.1 * rng.standard_normal(3 * c))
        wproj = t(rng.standard_normal((c, c)) / np.sqrt(c), bf16)
        bproj = t(0.1 * rng.standard_normal(c))
        o = t(rng.standard_normal((b * hp * wp, c)), bf16)
        if win > 8:  # SAM's windowed blocks
            rel = [t(rng.standard_normal((2 * win - 1, c // heads)), bf16) for _ in range(2)]
            heads_fn = lambda: window_attn_relpos_heads(  # noqa: E731
                x, ln_w, ln_b, wqkv, bqkv, *rel, heads=heads, window=win, dtype=bf16, eps=1e-6)
        else:
            table = t(rng.standard_normal(((2 * win - 1) ** 2, heads)))
            heads_fn = lambda: window_attn_heads(  # noqa: E731
                x, ln_w, ln_b, wqkv, bqkv, table, heads=heads, window=win, shift=shift,
                dtype=bf16)
        proj_fn = lambda: window_attn_proj(  # noqa: E731
            o, wproj, bproj, out_shape=(b, h, w, c), heads=heads, window=win, shift=shift,
            dtype=bf16)
        print(json.dumps({
            "shape": [b, h, w, c], "window": win, "shift": shift,
            "tile": tile or "by shape",
            "qkv_gemm_kernel_ms": device_ms(torch, heads_fn, "qkv_gemm_kernel"),
            "proj_gemm_kernel_ms": device_ms(torch, proj_fn, "proj_gemm_kernel"),
            "heads_host_us": host_us(torch, heads_fn), "proj_host_us": host_us(torch, proj_fn),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

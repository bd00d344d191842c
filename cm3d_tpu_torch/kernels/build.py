"""Build the CUDA sources in ../csrc into shared libraries and load them.

Each `csrc/<name>.cu` exposes a plain C launcher and compiles with nvcc
alone (no PyTorch headers, so a build takes seconds) into
`kernels/_build/lib<name>-<hash>.so`, keyed by a hash of the source, the
shared headers (`csrc/*.cuh`) and the flags, at first use. The wrappers bind
the launchers with ctypes. A failed build raises: there is no fallback for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# extra nvcc flags per source; medoid must not contract a*b+c into FMAs, so
# each pairwise distance rounds exactly like the plain PyTorch version
EXTRA_FLAGS = {"compact": [], "medoid": ["-fmad=false"], "window_attn": [],
               "window_attn_relpos": [], "segment": [], "sam_global_attn": []}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, shared memory, spills) of each build
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def _lib_path(name: str) -> tuple[Path, list[str]]:
    src = _CSRC / f"{name}.cu"
    flags = _ARCH + _BASE_FLAGS + EXTRA_FLAGS[name]
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):  # shared by several sources
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so", flags


def _start(name: str):
    """Start nvcc for one source; None if the library is already built."""
    path, flags = _lib_path(name)
    if path.exists():
        return None
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc()] + flags + ["-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, path = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, path)


def build_all(names=tuple(EXTRA_FLAGS)) -> None:
    """Build every named source at once (one nvcc process each, started
    together) so a cold start pays for the slowest build, not the sum."""
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        errors = []
        for n, s in started.items():  # wait for every build before raising
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(str(_lib_path(name)[0]))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")

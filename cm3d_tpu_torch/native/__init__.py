"""Native (C / C++) host components, built lazily with the system compiler.

Each module's sources compile once into a shared library or an executable
cached under ``cm3d_tpu_torch/native/_build`` keyed by a source hash;
bindings go through ctypes. Every native entry point has a pure-numpy
fallback, so the host side still runs where no compiler (or no writable
build directory) exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

_BUILD_DIR = Path(__file__).parent / "_build"


def _tagged_path(source_names: list[str], stem: str, suffix: str,
                 extra_flags: Optional[list[str]] = None) -> Optional[Path]:
    """Build path `_build/<stem>-<hash of sources and flags><suffix>`; None
    when the build directory cannot be created."""
    h = hashlib.sha256()
    for s in source_names:
        h.update((Path(__file__).parent / s).read_bytes())
    for f in extra_flags or []:
        h.update(f.encode())
    try:
        _BUILD_DIR.mkdir(exist_ok=True)
    except OSError:
        return None
    return _BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}{suffix}"


def _compile(sources: list[str], out: Path, flags: list[str]) -> bool:
    """Compile into a private name, then rename: concurrent builds never
    run or load a half-written file. C++ sources go through $CXX (g++)."""
    paths = [str(Path(__file__).parent / s) for s in sources]
    is_cxx = any(s.endswith((".cc", ".cpp")) for s in sources)
    cc = os.environ.get("CXX", "g++") if is_cxx else os.environ.get("CC", "cc")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cc] + (["-std=c++17"] if is_cxx else []) + flags + ["-o", str(tmp)] + paths
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, OSError):
        return False
    return True


def build_shared_lib(source_names: list[str], lib_stem: str) -> Optional[ctypes.CDLL]:
    """Compile sources from this directory into a cached .so; None on failure."""
    lib_path = _tagged_path(source_names, lib_stem, ".so")
    if lib_path is None:
        return None
    if not lib_path.exists() and not _compile(source_names, lib_path,
                                              ["-O3", "-shared", "-fPIC"]):
        return None
    try:
        return ctypes.CDLL(str(lib_path))
    except OSError:
        return None


def build_binary(source_names: list[str], bin_stem: str,
                 extra_flags: Optional[list[str]] = None) -> Optional[Path]:
    """Compile sources from this directory into a cached executable; None on
    failure."""
    bin_path = _tagged_path(source_names, bin_stem, "", extra_flags)
    if bin_path is None:
        return None
    if not bin_path.exists() and not _compile(source_names, bin_path,
                                              ["-O2"] + list(extra_flags or [])):
        return None
    return bin_path

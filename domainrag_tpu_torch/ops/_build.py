"""Build the package's CUDA source with ``nvcc`` and load it by ctypes.

``csrc/<name>.cu`` has a plain C interface and becomes
``build/lib<name>-<hash>.so`` at the repository root, keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so a
changed source or header rebuilds and an unchanged one loads at once. The compiler's ``-Xptxas -v`` report (registers,
shared memory, spills per kernel) is kept beside the library as
``lib<name>-<hash>.log``.

Only the repository's own sources are compiled; nothing here is imported
until a kernel is launched, so the package imports where no ``nvcc``
exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):    # the shared helpers
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str = "mmdit_attention") -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path. Raises with the compiler's output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(".tmp")
    proc = subprocess.run(
        [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built on first use, then cached)."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib

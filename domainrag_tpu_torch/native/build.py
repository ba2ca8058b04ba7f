"""Build the host C++ components with ``g++`` at first use and bind them
by ctypes (own copy of ``domainrag_tpu/native/build.py``'s API).

``topk.cpp`` (exact inner-product top-k, multithreaded) and
``imageproc.cpp`` (Pillow's 8-bit bicubic / bilinear resample, byte-equal
to PIL, threaded over a batch) become ``build/libdrtpu_native-<hash>.so``
at the repository root, keyed by a hash of the sources and the flags, as
``ops/_build.py`` keys the CUDA libraries. Nothing is built or loaded
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD = _DIR.parents[1] / "build"
SOURCES = ("topk.cpp", "imageproc.cpp")
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update((_DIR / src).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"libdrtpu_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the native sources:\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)


def native_available() -> bool:
    """True when the library is expected to load: a ``g++`` to build it,
    or the built library already in ``build/``, and no failed build."""
    if _build_failed:
        return False
    return shutil.which("g++") is not None or library_path().exists()


def load_native() -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and load the library; None only when
    it neither exists nor can be built (a failed build is remembered)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        out = library_path()
        try:
            if not out.exists():
                if shutil.which("g++") is None:
                    return None
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (RuntimeError, OSError):
            _build_failed = True
            return None
        lib.drtpu_topk_ip.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.drtpu_topk_ip.restype = None
        lib.drtpu_resize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32,
        ]
        lib.drtpu_resize.restype = None
        lib.drtpu_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.drtpu_resize_batch.restype = None
        _lib = lib
        return _lib


def _require() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++ or the "
                           "build failed)")
    return lib


def topk_ip_native(queries: np.ndarray, bank: np.ndarray, k: int,
                   n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Exact inner-product top-k on the host: (scores, indices), each
    (Q, min(k, N)), in (score descending, index ascending) order."""
    lib = _require()
    queries = np.ascontiguousarray(queries, dtype=np.float32)
    bank = np.ascontiguousarray(bank, dtype=np.float32)
    if queries.ndim != 2 or bank.ndim != 2 or k < 1:
        raise ValueError(f"expected (Q, D) queries, an (N, D) bank and "
                         f"k >= 1: {queries.shape}, {bank.shape}, {k}")
    nq, dim = queries.shape
    nb, dim_b = bank.shape
    if dim != dim_b:
        raise ValueError(f"query width {dim} != bank width {dim_b}")
    k_eff = min(k, nb)
    out_scores = np.empty((nq, k_eff), dtype=np.float32)
    out_idx = np.empty((nq, k_eff), dtype=np.int32)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.drtpu_topk_ip(
        queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        bank.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nq, nb, dim, k_eff, n_threads)
    return out_scores, out_idx


FILTER_BICUBIC = 0
FILTER_BILINEAR = 1


def resize_native(image: np.ndarray, out_h: int, out_w: int,
                  filter_id: int = FILTER_BICUBIC) -> np.ndarray:
    """PIL-byte-equal resample of one (H, W, 3) uint8 image."""
    lib = _require()
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image: {image.shape}")
    in_h, in_w = image.shape[:2]
    out = np.empty((out_h, out_w, 3), np.uint8)
    lib.drtpu_resize(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        in_h, in_w, out_h, out_w, filter_id)
    return out


def resize_batch_native(images: np.ndarray, out_h: int, out_w: int,
                        filter_id: int = FILTER_BICUBIC,
                        n_threads: int = 0) -> np.ndarray:
    """Threaded batch resample: (N, H, W, 3) uint8 -> (N, out_h, out_w, 3)."""
    lib = _require()
    images = np.ascontiguousarray(images, dtype=np.uint8)
    if images.ndim != 4 or images.shape[3] != 3:
        raise ValueError(f"expected (N, H, W, 3) images: {images.shape}")
    n, in_h, in_w = images.shape[:3]
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.drtpu_resize_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, in_h, in_w, out_h, out_w, filter_id, n_threads)
    return out

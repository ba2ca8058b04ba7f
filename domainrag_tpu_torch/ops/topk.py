"""Exact inner-product top-k over an embedding bank — the FAISS
``IndexFlatIP`` replacement of stage 2 (port of
``domainrag_tpu/ops/topk.py``).

- :func:`topk_ip` — the stage default, counterpart of the JAX ``topk_ip``
  (:54-67), which leaves the product to XLA: one f32 ``torch.matmul`` (no
  TF32), then an ordered top-k. ``k`` is clipped to the bank size.
- :func:`topk_ip_fused` — the fused kernel, B8: counterpart of
  ``topk_ip_pallas`` (:259), whose ``_topk_kernel`` (:183) fuses the GEMM
  with a streaming top-k so the (Q, N) scores never reach device memory.
  On a CUDA tensor it launches the hand-written Hopper kernel of
  ``csrc/topk.cu`` and counts ``topk_ip_fused.launches``; on a CPU tensor
  it runs :func:`reference_topk_ip_fused`. Like the Pallas kernel it
  returns (Q, k) even when k exceeds the bank: the tail is
  ``(NEG_INF, 2**31 - 1)`` fillers. Any k >= 1, as the Pallas kernel
  (which pads k to a multiple of 128): up to 1024 the kernel keeps each
  row's running list and candidate buffer in shared memory, above it the
  list in the scratch.

Exactness contract (identical top-100 indices to FAISS f32 IP): scores
are true f32 sums of products, and the order is (score desc, index asc),
a total order, so ties break toward the lower bank index. ``torch.topk``
does not promise that tie order; a stable descending sort does.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Tuple

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)
INT_MAX = 2 ** 31 - 1
_MARGIN = 64             # extra candidates taken by torch.topk in topk_ip


def topk_ip_numpy(queries: np.ndarray, bank: np.ndarray, k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Reference oracle: exact IP scores, (score desc, index asc) order."""
    queries = np.asarray(queries, dtype=np.float32)
    bank = np.asarray(bank, dtype=np.float32)
    scores = queries @ bank.T
    k = min(k, bank.shape[0])
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, axis=1), order.astype(np.int32)


@contextlib.contextmanager
def _full_f32():
    """float32 matmuls without TF32 for the block (the JAX package's
    ``precision=HIGHEST``); the previous setting comes back after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _scores(queries: torch.Tensor, bank: torch.Tensor) -> torch.Tensor:
    with _full_f32():
        return torch.matmul(queries.float(), bank.float().T)


def _stable_topk(scores: torch.Tensor, k: int):
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _ordered_topk(scores: torch.Tensor, k: int):
    """Top-k of each row in (score desc, index asc) order. ``torch.topk``
    takes k + a margin; when every row's last taken score is below its
    k-th, all scores tied with the k-th were taken, and a stable sort of
    the taken ones by index, then by score, orders them exactly. Else the
    whole row is sorted stably."""
    n = scores.shape[1]
    kk = k + _MARGIN
    if 0 < k and kk < n:
        vals, idx = torch.topk(scores, kk, dim=1)
        if bool((vals[:, kk - 1] < vals[:, k - 1]).all()):
            idx, perm = torch.sort(idx, dim=1)
            vals = torch.gather(vals, 1, perm)
            vals, perm = torch.sort(vals, dim=1, descending=True, stable=True)
            return vals[:, :k], torch.gather(idx, 1, perm[:, :k])
    return _stable_topk(scores, k)


def topk_ip(queries: torch.Tensor, bank: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense f32 GEMM + ordered top-k; k clipped to the bank size.
    Returns (scores (Q, k) f32, indices (Q, k) int32)."""
    k = min(k, bank.shape[0])
    vals, idx = _ordered_topk(_scores(queries, bank), k)
    return vals, idx.to(torch.int32)


def reference_topk_ip_fused(queries: torch.Tensor, bank: torch.Tensor,
                            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B8: what ``topk_ip_pallas`` returns. A score enters
    only when it is above NEG_INF (the Pallas kernel's masked and filler
    value); the (Q, k) result is padded with (NEG_INF, 2**31 - 1)."""
    scores = _scores(queries, bank)
    q, n = scores.shape
    idx = torch.arange(n, device=scores.device, dtype=torch.int32).expand(q, n)
    real = scores > NEG_INF
    scores = torch.where(real, scores, NEG_INF)
    idx = torch.where(real, idx, INT_MAX)
    if k > n:
        scores = torch.cat([scores, scores.new_full((q, k - n), NEG_INF)], 1)
        idx = torch.cat([idx, idx.new_full((q, k - n), INT_MAX)], 1)
    vals, order = _stable_topk(scores, k)
    return vals, torch.gather(idx, 1, order)


# ---------------------------------------------------------------------------
# B8 on the card
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("topk")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_ip_fused_slots.argtypes = [i, i, i, i]
        lib.topk_ip_fused_slots.restype = ctypes.c_int
        lib.topk_ip_fused.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.topk_ip_fused.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _tma_rows(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel's TMA unit reads it: contiguous rows whose width is
    a multiple of 4 (zero lanes added, which add exact zeros to every
    score) from a 16-byte aligned start."""
    pad = -x.shape[1] % 4
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(queries: torch.Tensor, bank: torch.Tensor, k: int):
    if queries.dim() != 2 or bank.dim() != 2 or \
            queries.shape[1] != bank.shape[1]:
        raise ValueError(f"queries (Q, d) and bank (N, d) expected, got "
                         f"{tuple(queries.shape)} and {tuple(bank.shape)}")
    if queries.dtype != torch.float32 or bank.dtype != torch.float32:
        raise ValueError("B8 takes float32 queries and bank")
    if queries.device != bank.device:
        raise ValueError("queries and bank on different devices")
    q, d = queries.shape
    n = bank.shape[0]
    if q == 0 or n == 0 or d == 0:
        raise ValueError("B8 needs at least one query, bank row and dim")
    lib = _lib()
    dev = queries.device
    queries, bank = _tma_rows(queries), _tma_rows(bank)
    # the kernel plans its bank splits; the scratch holds each split's list
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slots = lib.topk_ip_fused_slots(q, n, k, sms)
    part_s = torch.empty((q, slots), dtype=torch.float32, device=dev)
    part_i = torch.empty((q, slots), dtype=torch.int32, device=dev)
    out_s = torch.empty((q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k), dtype=torch.int32, device=dev)
    rc = lib.topk_ip_fused(
        queries.data_ptr(), bank.data_ptr(), part_s.data_ptr(),
        part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), q, n,
        queries.shape[1], k, sms, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"topk_ip_fused kernel launch failed (Q={q} N={n} "
                           f"d={d} k={k}): CUDA error {rc}")
    return out_s, out_i


def topk_ip_fused(queries: torch.Tensor, bank: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused GEMM + streaming top-k (B8), counterpart of the JAX
    ``topk_ip_pallas``: (scores (Q, k) f32, indices (Q, k) int32) in
    (score desc, index asc) order, with (NEG_INF, 2**31 - 1) fillers
    past the bank's end. Raises ``ValueError`` for k < 1."""
    if k < 1:
        raise ValueError(f"topk_ip_fused takes k >= 1, got {k}")
    if queries.device.type == "cpu":
        return reference_topk_ip_fused(queries, bank, k)
    out = _launch(queries, bank, k)
    topk_ip_fused.launches += 1
    return out


topk_ip_fused.launches = 0

"""W8A8 int8 GEMM (port of ``domainrag_tpu/ops/int8_gemm.py``).

Weights are per-output-channel symmetric int8, ``w ~ w_q * diag(w_s)``
(:mod:`models.quant`); activations are quantized per token on the fly,
``x ~ x_q * diag(x_s)`` with ``x_s = rowmax|x| / 127``. The product
``x_q @ w_q`` is exact in integers and the epilogue applies the rank-1
rescale in f32, ``acc * x_s * w_s`` in that order, casts to the output
dtype and then adds the bias in it: the arithmetic of the JAX ``_kernel``
(ops/int8_gemm.py:117) and of its XLA W8A8 branch in ``common.linear``,
so this module is bitwise equal to both.

:func:`quantize_rowwise` stays torch ops outside the kernel, as it stays
XLA outside Pallas in the JAX package. :func:`w8a8_linear` runs the plain
version :func:`w8a8_reference` on a CPU tensor and the hand-written
Hopper kernel of ``csrc/int8_gemm.cu`` (B4) on a CUDA tensor, for every
shape: the M = 1 modulation and embedder linears, K = 64 (``img_in``)
and N = 64 (``final_proj``) included. The weights are K-major, ``w_q``
(N, K) with K contiguous (:mod:`models.quant`): the transpose of the JAX
package's (K, N), because ``wgmma`` reads 8-bit operands only K-major.
:func:`instance` picks the kernel's instance from the shape:
``wgmma`` (M >= 64), ``gemv`` (M < 64) or, for K % 16 != 0 or rows off a
16-byte boundary (which TMA and the vector loads cannot describe),
``mma``. The JAX gate ``w8a8_eligible``
(M >= 512, K and N tileable) exists because the TPU kernel takes whole
tiles only, with its XLA formulation, bitwise identical, covering the
rest; on the card no plain version carries any part of the path, so the
kernel masks ragged edges instead. The gate is kept for parity (and
``chip_smoke.py`` reports which shapes it would have sent to XLA). Launches are counted in ``w8a8_linear.launches``, and
per (M, K, N) in ``w8a8_linear.launches_by_shape`` and per instance in
``w8a8_linear.launches_by_instance``. The JAX toggles
(:func:`set_w8a8_pallas`, :func:`disable_pallas_w8a8`) are kept for
parity: a CPU tensor takes the plain version either way, and on the card
B4 is the only route, so a call there with a toggle off raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional

import torch


def div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 correctly rounded on every device. On a CUDA tensor torch
    turns the division by a Python number into a multiplication by its
    reciprocal, which is 1 ulp off the JAX package's ``x / 127.0`` for some
    x; a tensor divisor keeps the true division."""
    return x / torch.full((), 127.0, dtype=x.dtype, device=x.device)


def _quantize(xf: torch.Tensor, amax: torch.Tensor):
    s = div127(amax).clamp_min(1e-12)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_rowwise(x: torch.Tensor):
    """Per-token symmetric int8: (M, K) float -> int8 (M, K), f32 (M, 1)
    (f32 amax / 127 floored at 1e-12, round half to even, clip)."""
    xf = x.float()
    return _quantize(xf, xf.abs().amax(dim=-1, keepdim=True))


# The JAX package turns its Pallas GEMM off (the XLA formulation runs) by
# a process-wide flag and, under a TP-sharded bundle, by a thread-local
# context, because pallas_call has no GSPMD partitioning rule (its
# pipeline.py:254-264). The port keeps the same toggles, but no reason to
# leave the kernel exists here: its tensor parallelism runs B4 on each
# rank's own shard (``models.common.linear_row_sharded``). So off, a CPU
# tensor takes the plain version as it always does, and a card tensor
# raises instead of giving way to it.
_PALLAS_ENABLED = True
_TLS = threading.local()


@contextlib.contextmanager
def disable_pallas_w8a8():
    prev = getattr(_TLS, "disable", False)
    _TLS.disable = True
    try:
        yield
    finally:
        _TLS.disable = prev


def set_w8a8_pallas(enabled: bool) -> None:
    global _PALLAS_ENABLED
    _PALLAS_ENABLED = bool(enabled)


def w8a8_pallas_enabled() -> bool:
    return _PALLAS_ENABLED


def w8a8_reference(xq: torch.Tensor, w_q: torch.Tensor, xs: torch.Tensor,
                   w_s: torch.Tensor, bias: Optional[torch.Tensor],
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of B4 on K-major weights (``w_q`` (N, K)): the integer
    dot in float64, which is exact on either device (|acc| <= K * 127^2 <
    2^53; torch has no general int32 matmul on the card), then
    ``acc.float() * xs * w_s``, cast, ``+ b``."""
    acc = torch.matmul(xq.double(), w_q.double().t())
    y = (acc.float() * xs.float() * w_s.float()).to(out_dtype)
    if bias is not None:
        y = y + bias.to(out_dtype)
    return y


def _pick(dim: int, candidates) -> Optional[int]:
    for c in candidates:
        if dim % c == 0:
            return c
    return None


def w8a8_eligible(m: int, k: int, n: int) -> bool:
    """The JAX package's Pallas gate (ops/int8_gemm.py:181-187): shapes
    its TPU kernel takes. The port's kernel takes every shape."""
    return (m >= 512
            and _pick(k, (1536, 2048, 1024, 512, 256, 128)) is not None
            and _pick(n, (1024, 512, 256, 128)) is not None)


INSTANCES = ("wgmma", "gemv", "mma")     # the C entry's instance codes
GEMV_MAX_M = 63                          # M up to this takes the gemv


def instance(m: int, k: int, n: int, aligned: bool = True) -> str:
    """The B4 instance of an (M, K, N) launch: ``mma`` where TMA and the
    vector loads cannot describe the rows (K % 16 != 0, or ``aligned``
    false: a base off a 16-byte boundary), else ``gemv`` for M <=
    ``GEMV_MAX_M`` and ``wgmma`` above."""
    if k % 16 or not aligned:
        return "mma"
    return "gemv" if m <= GEMV_MAX_M else "wgmma"


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("int8_gemm")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w8a8_gemm.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.w8a8_gemm.restype = ctypes.c_int
        _LIB = lib
    return _LIB


_OUT_KINDS = {torch.bfloat16: 0, torch.float32: 1}


def _launch(xq, w_q, xs, w_s, bias, out_dtype):
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"B4 writes bf16 or f32, not {out_dtype}")
    m, k = xq.shape
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[1] != k:
        raise ValueError(f"w_q must be (N, {k}) int8 (K-major), got "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    n = w_q.shape[0]
    dev = xq.device
    xq, w_q = xq.contiguous(), w_q.contiguous()
    inst = instance(m, k, n, xq.data_ptr() % 16 == 0
                    and w_q.data_ptr() % 16 == 0)
    xs = xs.reshape(m).float().contiguous()
    w_s = w_s.reshape(n).to(device=dev, dtype=torch.float32).contiguous()
    b = None if bias is None else bias.reshape(n).to(
        device=dev, dtype=out_dtype).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    rc = _lib().w8a8_gemm(
        xq.data_ptr(), w_q.data_ptr(), xs.data_ptr(), w_s.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), m, n, k,
        _OUT_KINDS[out_dtype], INSTANCES.index(inst),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"w8a8_gemm kernel launch failed (M={m} K={k} "
                           f"N={n}, {inst}): CUDA error {rc}")
    return out, inst


def w8a8_linear(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, row_max=None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """W8A8 linear: per-token activation quant (torch ops), then the exact
    int8 product with the rescale and bias epilogue. ``x``: (..., K)
    float; ``w_q``: (N, K) int8, K-major; ``w_s``: (N,) f32. Returns
    (..., N) in ``out_dtype`` (default x's). ``row_max`` maps each row's
    local amax (M, 1) to the one to quantize with (a row-sharded layer's
    all-reduce of the max over the whole row)."""
    n, k = w_q.shape
    lead = x.shape[:-1]
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(-1, k)
    if row_max is None:
        xq, xs = quantize_rowwise(x2)
    else:
        xf = x2.float()
        xq, xs = _quantize(xf, row_max(xf.abs().amax(dim=-1, keepdim=True)))
    if x.device.type == "cpu":
        y = w8a8_reference(xq, w_q, xs, w_s, bias, out_dtype)
    elif not _PALLAS_ENABLED or getattr(_TLS, "disable", False):
        raise RuntimeError(
            "the W8A8 kernel is turned off (set_w8a8_pallas(False) or "
            "disable_pallas_w8a8()), but on the card B4 is the only route "
            "of w8a8_linear")
    else:
        y, inst = _launch(xq, w_q, xs, w_s, bias, out_dtype)
        w8a8_linear.launches += 1
        shape = (xq.shape[0], k, n)
        for counts, key in ((w8a8_linear.launches_by_shape, shape),
                            (w8a8_linear.launches_by_instance, inst)):
            counts[key] = counts.get(key, 0) + 1
    return y.reshape(*lead, n)


w8a8_linear.launches = 0
w8a8_linear.launches_by_shape = {}     # (M, K, N) -> launches
w8a8_linear.launches_by_instance = {}  # "wgmma" / "gemv" / "mma" -> launches

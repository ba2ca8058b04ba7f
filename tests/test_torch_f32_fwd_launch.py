"""The f32 flash forward's launch contract (B5 f32, bf16 terms on the
tensor cores), on the CPU with the kernel library stubbed (no card, no
nvcc): ``ops.attention._kernel_forward`` calls ``flash_fwd`` exactly as the
card would, and a stand-in library checks and answers the call.

- f32: one ``flash_fwd`` call with dtype 1, 64-bit pointers to the padded
  rows (q prescaled by log2(e)/sqrt(D)), out and lse, the shape, kv_valid,
  causal, a bf16 scratch of ``F32_TERM_PLANES`` planes of q, k and v for the
  split pass, and the caller's stream; out and lse are what the kernel
  wrote, unpadded; one count in ``flash_attention.launches``; a non-zero
  return code raises and counts nothing.
- bf16: the same entry with dtype 0 and no scratch.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from domainrag_tpu_torch.ops import _build
from domainrag_tpu_torch.ops import attention as attn

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

STREAM = 0x7F00DEADBEEF       # a stream handle above 2^32


class _Fn:
    """A library function: ctypes sets ``argtypes``/``restype`` on it."""

    def __init__(self, body):
        self.body, self.calls = body, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.body(*args)


@pytest.fixture
def stub(monkeypatch):
    """Installs a stand-in library with ``body`` as ``flash_fwd``, and
    records every tensor ``torch.empty`` allocates while it is installed."""
    allocated = []
    real_empty = torch.empty

    def empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        allocated.append(t)
        return t

    def install(body):
        lib = type("Lib", (), {})()
        lib.flash_fwd = _Fn(body)
        lib.flash_bwd_bf16 = lib.flash_bwd_f32 = _Fn(lambda *a: 0)
        monkeypatch.setattr(attn, "_LIB", None)
        monkeypatch.setattr(_build, "load", lambda name: lib)
        monkeypatch.setattr(attn, "_stream", lambda x: STREAM)
        monkeypatch.setattr(torch, "empty", empty)
        return lib, allocated
    return install


def _floats(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


def _inputs(dtype, b=1, h=2, s_q=70, s_kv=90, d=64):
    g = torch.Generator().manual_seed(5)
    return tuple(torch.randn(sh, generator=g).to(dtype)
                 for sh in ((b, h, s_q, d), (b, h, s_kv, d), (b, h, s_kv, d)))


def test_f32_forward_reaches_flash_fwd_once(stub):
    b, h, s_q, s_kv, d = 1, 2, 70, 90, 64
    q, k, v = _inputs(torch.float32, b, h, s_q, s_kv, d)
    seen = {}

    def kernel(dtype, qp, kp, vp, out, lse, bh, sq, skv, kv_valid, causal,
               terms, stream):
        n = bh * sq * attn.HEAD_DIM
        rows = _floats(qp, n).reshape(bh, sq, attn.HEAD_DIM)
        seen["q"] = rows.copy()
        seen["k"] = _floats(kp, bh * skv * attn.HEAD_DIM).copy()
        seen["args"] = (dtype, bh, sq, skv, kv_valid, causal, stream)
        seen["terms"] = terms
        _floats(out, n)[:] = 2.0              # the "kernel" writes out
        _floats(lse, bh * sq)[:] = -1.0       # and lse
        return 0

    lib, allocated = stub(kernel)
    before = attn.flash_attention.launches
    out, lse = attn._kernel_forward(q, k, v, True, 80)
    assert len(lib.flash_fwd.calls) == 1
    p, i = ctypes.c_void_p, ctypes.c_int
    assert lib.flash_fwd.argtypes == [i] + [p] * 5 + [i] * 5 + [p, p]
    assert seen["args"] == (1, b * h, s_q, s_kv, 80, 1, STREAM)
    # q prescaled by log2(e)/sqrt(D) in f32, padded to 128 lanes with zeros
    want_q = (q * (attn.LOG2_E / math.sqrt(d))).reshape(b * h, s_q, d)
    np.testing.assert_array_equal(seen["q"][..., :d], want_q.numpy())
    assert not seen["q"][..., d:].any()
    np.testing.assert_array_equal(
        seen["k"].reshape(b * h, s_kv, attn.HEAD_DIM)[..., :d],
        k.reshape(b * h, s_kv, d).numpy())
    scratch = [t for t in allocated if t.data_ptr() == seen["terms"]]
    assert len(scratch) == 1 and scratch[0].dtype == torch.bfloat16
    assert scratch[0].numel() == (attn.F32_TERM_PLANES * b * h
                                  * attn.HEAD_DIM * (s_q + 2 * s_kv))
    assert out.shape == (b, h, s_q, d) and out.dtype == torch.float32
    assert torch.equal(out, torch.full_like(out, 2.0))
    assert lse.shape == (b, h, s_q) and torch.equal(
        lse, torch.full_like(lse, -1.0))
    assert attn.flash_attention.launches == before + 1


def test_bf16_forward_passes_no_scratch(stub):
    lib, _ = stub(lambda *a: 0)
    attn._kernel_forward(*_inputs(torch.bfloat16), False, None)
    (args,) = lib.flash_fwd.calls
    assert args[0] == 0 and args[11] is None and args[12] == STREAM


def test_f32_forward_raises_on_error(stub):
    lib, _ = stub(lambda *a: 700)
    before = attn.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        attn._kernel_forward(*_inputs(torch.float32), False, None)
    assert len(lib.flash_fwd.calls) == 1
    assert attn.flash_attention.launches == before

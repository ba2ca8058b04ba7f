"""The B6 wrapper's launch contract, on the CPU with the kernel library
stubbed (no card, no nvcc): ``ops.attention._kernel_backward`` calls the
library exactly as the card would, and a stand-in library checks and
answers the call.

- bf16: one call of ``flash_bwd_bf16`` per backward with 64-bit pointers
  (ctypes ``c_void_p``) to the padded rows, the lse and delta rows padded
  to a multiple of 64, an f32 ``dq_accum`` of (B*H, Sq, 128) that is all
  zeros when the kernel starts, the int32 ``dq_turns`` (one per (B*H,
  64-row q tile), all zeros when the kernel starts: they order dq's adds
  over the kv blocks) and the caller's stream; ``dq`` is then
  bf16(dq_accum / sqrt(D)); one count in ``flash_attention.bwd_launches``;
  a non-zero return code raises and counts nothing.
- f32: one call of ``flash_bwd_f32`` with the same arguments, ``dq``
  itself (f32, zeros when the kernel starts) in the accumulator's place,
  so that ``dq`` is what the kernel wrote, and one zeroed turn per (B*H,
  32-row q tile); one count in
  ``flash_attention.bwd_f32_launches``; a non-zero return code raises and
  counts nothing.
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


class _Lib:
    def __init__(self, bf16_body, f32_body=lambda *a: 0):
        self.flash_fwd = _Fn(lambda *a: 0)
        self.flash_bwd_bf16 = _Fn(bf16_body)
        self.flash_bwd_f32 = _Fn(f32_body)


def _floats(ptr, n):
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr))


def _turns_zeroed(buf, turns, bh, sq, rows):
    """``turns`` is ``buf.dq_turns``: int32, one per (bh, q tile of
    ``rows``), all zeros."""
    n = bh * -(-sq // rows)
    assert turns == buf.dq_turns.data_ptr()
    assert buf.dq_turns.dtype == torch.int32 and buf.dq_turns.numel() == n
    got = np.ctypeslib.as_array((ctypes.c_int32 * n).from_address(turns))
    return bool((got == 0).all())


@pytest.fixture
def stub(monkeypatch):
    """Installs a stand-in library; returns a function taking the bodies."""
    def install(*bodies):
        lib = _Lib(*bodies)
        monkeypatch.setattr(attn, "_LIB", None)
        monkeypatch.setattr(_build, "load", lambda name: lib)
        monkeypatch.setattr(attn, "_stream", lambda x: STREAM)
        return lib
    return install


def _inputs(dtype, b=1, h=2, s_q=70, s_kv=90, d=64):
    g = torch.Generator().manual_seed(3)
    q, k, v, dout = (torch.randn(sh, generator=g).to(dtype)
                     for sh in ((b, h, s_q, d), (b, h, s_kv, d),
                                (b, h, s_kv, d), (b, h, s_q, d)))
    out, lse = attn.flash_forward_reference(q, k, v)
    return q, k, v, out, lse, dout


def test_bf16_backward_launch_contract(stub, monkeypatch):
    b, h, s_q, s_kv, d = 1, 2, 70, 90, 64
    bufs = []
    real = attn.backward_buffers
    monkeypatch.setattr(attn, "backward_buffers",
                        lambda *a: bufs.append(real(*a)) or bufs[-1])
    seen = {}

    def kernel(q, k, v, dout, lse, delta, dq_accum, dk, dv, bh, sq, skv,
               kv_valid, causal, scale, turns, stream):
        buf = bufs[-1]
        seen["turns"] = _turns_zeroed(buf, turns, bh, sq, 64)
        assert (q, k, v, dout) == tuple(
            t.data_ptr() for t in (buf.q, buf.k, buf.v, buf.dout))
        assert (lse, delta, dq_accum, dk, dv) == tuple(
            t.data_ptr() for t in (buf.lse, buf.delta, buf.dq_accum,
                                   buf.dk, buf.dv))
        n = bh * sq * attn.HEAD_DIM
        assert buf.dq_accum.shape == (bh, sq, attn.HEAD_DIM)
        assert buf.dq_accum.dtype == torch.float32
        seen["zeros"] = bool((_floats(dq_accum, n) == 0).all())
        _floats(dq_accum, n)[:] = 1.0        # the "kernel" writes dq
        seen["args"] = (bh, sq, skv, kv_valid, causal, scale, stream)
        return 0

    lib = stub(kernel)
    x = _inputs(torch.bfloat16, b, h, s_q, s_kv, d)
    before = attn.flash_attention.bwd_launches, \
        attn.flash_attention.bwd_f32_launches
    dq, dk, dv = attn._kernel_backward(*x, True, 80)
    assert len(lib.flash_bwd_bf16.calls) == 1
    assert lib.flash_bwd_f32.calls == []
    p = ctypes.c_void_p
    assert lib.flash_bwd_bf16.argtypes[:9] == [p] * 9
    assert lib.flash_bwd_bf16.argtypes[-2:] == [p, p]
    assert lib.flash_bwd_bf16.argtypes[-3] is ctypes.c_float
    assert seen["zeros"] and seen["turns"]
    bh, sq, skv, kv_valid, causal, scale, stream = seen["args"]
    assert (bh, sq, skv, kv_valid, causal, stream) == (b * h, s_q, s_kv, 80,
                                                       1, STREAM)
    assert scale == pytest.approx(1 / math.sqrt(d))
    buf = bufs[-1]
    assert buf.lse.shape == buf.delta.shape == (b * h, 128)
    assert torch.equal(buf.lse[:, s_q:], torch.zeros(b * h, 128 - s_q))
    assert dq.dtype == torch.bfloat16 and dq.shape == (b, h, s_q, d)
    assert torch.equal(dq, torch.full_like(dq, 1 / math.sqrt(d)))
    assert dk.shape == dv.shape == (b, h, s_kv, d)
    assert (attn.flash_attention.bwd_launches,
            attn.flash_attention.bwd_f32_launches) == (before[0] + 1,
                                                       before[1])


def test_bf16_backward_raises_on_error(stub):
    lib = stub(lambda *a: 700)
    x = _inputs(torch.bfloat16)
    before = attn.flash_attention.bwd_launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        attn._kernel_backward(*x, False, None)
    assert len(lib.flash_bwd_bf16.calls) == 1
    assert attn.flash_attention.bwd_launches == before


def test_bf16_backward_is_one_kernel(stub):
    """``launch_backward`` takes no kernel selector: one bf16 call runs the
    one kernel once and the f32 entry never."""
    lib = stub(lambda *a: 0)
    buf = attn.backward_buffers(*_inputs(torch.bfloat16), False)
    with pytest.raises(TypeError):
        attn.launch_backward(buf, 0)
    assert lib.flash_bwd_bf16.calls == []
    attn.launch_backward(buf)
    assert len(lib.flash_bwd_bf16.calls) == 1
    assert lib.flash_bwd_f32.calls == []


def test_f32_backward_launches_dq_then_dkv(stub, monkeypatch):
    """dq, dk and dv come from one f32 launch: the kernel's dq argument is
    ``dq`` itself, zeroed, and what the kernel adds into it is the
    result (scaled in the kernel, nothing after it)."""
    b, h, s_q, s_kv, d = 1, 2, 70, 90, 64
    bufs = []
    real = attn.backward_buffers
    monkeypatch.setattr(attn, "backward_buffers",
                        lambda *a: bufs.append(real(*a)) or bufs[-1])
    seen = {}

    def kernel(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, skv, kv_valid,
               causal, scale, turns, stream):
        buf = bufs[-1]
        seen["turns"] = _turns_zeroed(buf, turns, bh, sq, 32)
        assert (q, k, v, dout, lse, delta, dq, dk, dv) == tuple(
            t.data_ptr() for t in (buf.q, buf.k, buf.v, buf.dout, buf.lse,
                                   buf.delta, buf.dq, buf.dk, buf.dv))
        n = bh * sq * attn.HEAD_DIM
        assert buf.dq.shape == (bh, sq, attn.HEAD_DIM)
        assert buf.dq.dtype == torch.float32
        seen["zeros"] = bool((_floats(dq, n) == 0).all())
        _floats(dq, n)[:] = 0.5               # the "kernel" adds dq
        seen["args"] = (bh, sq, skv, kv_valid, causal, scale, stream)
        return 0

    lib = stub(lambda *a: 0, kernel)
    x = _inputs(torch.float32, b, h, s_q, s_kv, d)
    before = attn.flash_attention.bwd_launches, \
        attn.flash_attention.bwd_f32_launches
    dq, dk, dv = attn._kernel_backward(*x, False, None)
    assert len(lib.flash_bwd_f32.calls) == 1
    assert lib.flash_bwd_bf16.calls == []
    p = ctypes.c_void_p
    assert lib.flash_bwd_f32.argtypes[:9] == [p] * 9
    assert lib.flash_bwd_f32.argtypes[-3:] == [ctypes.c_float, p, p]
    assert seen["zeros"] and seen["turns"]
    bh, sq, skv, kv_valid, causal, scale, stream = seen["args"]
    assert (bh, sq, skv, kv_valid, causal, stream) == (b * h, s_q, s_kv,
                                                       s_kv, 0, STREAM)
    assert scale == pytest.approx(1 / math.sqrt(d))
    buf = bufs[-1]
    assert buf.lse.shape == buf.delta.shape == (b * h, 128)
    assert torch.equal(buf.delta[:, s_q:], torch.zeros(b * h, 128 - s_q))
    assert dq.dtype == torch.float32 and dq.shape == (b, h, s_q, d)
    assert torch.equal(dq, torch.full_like(dq, 0.5))
    assert dk.shape == dv.shape == (b, h, s_kv, d)
    assert (attn.flash_attention.bwd_launches,
            attn.flash_attention.bwd_f32_launches) == (before[0],
                                                       before[1] + 1)

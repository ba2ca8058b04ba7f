"""The fused MMDiT wrapper's launch contract (B1-B3), on the CPU with the
kernel library stubbed (no card, no nvcc): ``ops.mmdit_attention._launch``
calls the library exactly as the card would, and a stand-in library checks
and answers the call.

- one call of the regime's entry (``mmdit_attention`` one pass,
  ``mmdit_attention_mp`` multi-pass) with 64-bit pointers (ctypes
  ``c_void_p``) and 64-bit strides (``c_longlong``), and the caller's
  stream;
- q/k scratch of (B, H, n_pad, 128) bf16 in the padded row space of
  ``_i8_plan(s_a, s_b, False, False)``: stream b from b0, the first
  multiple of 128 at or after s_a, and n_pad a multiple of 128;
- each stream's rows read in place: its base, batch and row strides (a
  row window of a larger tensor keeps them; row pitch 3*H*128 for the
  double block, 7*H*128 for the single block) and its V lanes at 2*H*128;
- the outputs the kernel writes are the tensors returned, one per stream;
- a non-zero return code raises and counts no launch.
"""

import ctypes
import types

import pytest
import torch

from domainrag_tpu_torch.ops import _build
from domainrag_tpu_torch.ops import mmdit_attention as mma

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

STREAM = 0x7F00DEADBEEF       # a stream handle above 2^32
HEADS, HD = 2, 128
BF16_ONE = 0x3F80             # bf16 bits of 1.0


class _Fn:
    """A library function: ctypes sets ``argtypes``/``restype`` on it."""

    def __init__(self, body):
        self.body, self.calls = body, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.body(*args)


NAMES = ("a", "a_batch", "a_row", "s_a", "b", "b_batch", "b_row", "s_b",
         "va", "vb", "wq_a", "wk_a", "wq_b", "wk_b", "cos", "sin", "qs",
         "ks", "out_a", "out_b", "batch", "heads", "b0", "n_pad", "scale",
         "stream")


def _write_ones(ptr, n):
    """The stand-in kernel's output: n bf16 ones from ptr."""
    (ctypes.c_uint16 * n).from_address(ptr)[:] = [BF16_ONE] * n


@pytest.fixture
def stub(monkeypatch):
    """Installs a stand-in library whose entries record their arguments by
    name and write ones into the outputs; returns (lib, allocations)."""
    allocs = []
    real_empty, real_like = torch.empty, torch.empty_like

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocs.append(t)
        return t

    def empty_like(*a, **k):
        t = real_like(*a, **k)
        allocs.append(t)
        return t

    def run(*args):
        got = dict(zip(NAMES, args))
        for out, n in (("out_a", got["s_a"]), ("out_b", got["s_b"])):
            _write_ones(got[out], got["batch"] * n * got["heads"] * HD)
        return 0

    def install():
        lib = types.SimpleNamespace(mmdit_attention=_Fn(run),
                                    mmdit_attention_mp=_Fn(run))
        monkeypatch.setattr(mma, "_LIB", None)
        monkeypatch.setattr(_build, "load", lambda name: lib)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda dev=None: types.SimpleNamespace(
                                cuda_stream=STREAM))
        monkeypatch.setattr(torch, "empty", empty)
        monkeypatch.setattr(torch, "empty_like", empty_like)
        return lib
    return install, allocs


def _streams(batch, lens, width, window=False):
    g = torch.Generator().manual_seed(sum(lens))
    out = []
    for n in lens:
        if window:      # rows 3.. of a longer tensor: strides kept
            big = torch.randn((batch, n + 5, width), generator=g)
            out.append(big.to(torch.bfloat16)[:, 3:3 + n])
        else:
            out.append(torch.randn((batch, n, width), generator=g)
                       .to(torch.bfloat16))
    return out


def _tables(n):
    ang = torch.linspace(-3, 3, n * HD // 2).reshape(n, HD // 2)
    return torch.cos(ang), torch.sin(ang)


NORM = (torch.ones(HD), torch.ones(HD))


@pytest.mark.parametrize("multipass", [False, True], ids=["onepass", "mp"])
@pytest.mark.parametrize("batch,lens,width,window", [
    (2, (89, 200), 3 * HEADS * HD, False),            # ragged txt stream
    (1, (127, 129), 3 * HEADS * HD, True),
    (2, (128, 64), 3 * HEADS * HD, False),
    (1, (129,), 7 * HEADS * HD, True),                 # single block + MLP
    (2, (256,), 7 * HEADS * HD, False),
], ids=["txt89", "txt127_window", "txt128", "single129_window",
        "single256"])
def test_launch_contract(stub, batch, lens, width, window, multipass):
    install, allocs = stub
    lib = install()
    streams = _streams(batch, lens, width, window)
    cos, sin = _tables(sum(lens))
    outs = mma._launch(streams, [NORM] * len(streams), cos, sin, HEADS, HD,
                       multipass)
    used = lib.mmdit_attention_mp if multipass else lib.mmdit_attention
    other = lib.mmdit_attention if multipass else lib.mmdit_attention_mp
    assert len(used.calls) == 1 and other.calls == []
    got = dict(zip(NAMES, used.calls[0]))
    assert len(used.calls[0]) == len(NAMES)

    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    types_ = dict(zip(NAMES, used.argtypes))
    for name in ("a", "b", "va", "vb", "qs", "ks", "out_a", "out_b", "cos",
                 "sin", "stream") + ("wq_a", "wk_a", "wq_b", "wk_b"):
        assert types_[name] is p, name
    for name in ("a_batch", "a_row", "b_batch", "b_row"):
        assert types_[name] is ll, name
    for name in ("s_a", "s_b", "batch", "heads", "b0", "n_pad"):
        assert types_[name] is i, name
    assert types_["scale"] is ctypes.c_float
    assert got["stream"] == STREAM

    # rows in place, V at lane 2*H*128 (bytes: 2 per bf16 lane)
    a, b = streams[0], streams[-1]
    s_b = lens[1] if len(lens) == 2 else 0
    assert (got["a"], got["a_batch"], got["a_row"], got["s_a"]) == (
        a.data_ptr(), a.stride(0), a.stride(1), lens[0])
    assert (got["b"], got["b_batch"], got["b_row"], got["s_b"]) == (
        b.data_ptr(), b.stride(0), b.stride(1), s_b)
    assert got["a_row"] == width
    assert got["va"] == a.data_ptr() + 2 * HEADS * HD * 2
    assert got["vb"] == b.data_ptr() + 2 * HEADS * HD * 2

    # the padded row space
    b0, n_pad = got["b0"], got["n_pad"]
    assert b0 % 128 == 0 and lens[0] <= b0 < lens[0] + 128
    assert n_pad % 128 == 0 and b0 + s_b <= n_pad < b0 + s_b + 128
    assert (b0, n_pad) == tuple(mma._i8_plan(lens[0], s_b, False, False))
    scratch = {t.data_ptr(): t for t in allocs}
    for name in ("qs", "ks"):
        t = scratch[got[name]]
        assert t.shape == (batch, HEADS, n_pad, HD), name
        assert t.dtype == torch.bfloat16 and t.is_contiguous()
    assert got["qs"] != got["ks"]
    assert (got["batch"], got["heads"]) == (batch, HEADS)

    # outputs: the tensors the kernel wrote, one per stream
    assert len(outs) == len(streams)
    assert got["out_a"] == outs[0].data_ptr()
    assert got["out_b"] == outs[-1].data_ptr()
    for o, n in zip(outs, lens):
        assert o.shape == (batch, n, HEADS * HD) and o.dtype == torch.bfloat16
        assert torch.equal(o, torch.ones_like(o))


@pytest.mark.parametrize("multipass", [False, True], ids=["onepass", "mp"])
def test_launch_error_raises_and_counts_nothing(stub, monkeypatch,
                                                multipass):
    install, _ = stub
    lib = install()
    lib.mmdit_attention = _Fn(lambda *a: 700)
    lib.mmdit_attention_mp = _Fn(lambda *a: 700)
    if multipass:
        monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    # meta tensors: the wrappers' CUDA route, with no memory behind them
    meta = dict(device="meta", dtype=torch.bfloat16)
    txt = torch.empty(1, 40, 3 * HEADS * HD, **meta)
    img = torch.empty(1, 88, 3 * HEADS * HD, **meta)
    cos = sin = torch.zeros(128, HD // 2)
    norm = {"q": {"scale": torch.ones(HD)}, "k": {"scale": torch.ones(HD)}}
    counts = lambda: tuple((w.launches, w.mp_launches)  # noqa: E731
                           for w in (mma.mmdit_double_attention,
                                     mma.mmdit_single_attention))
    before = counts()
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        mma.mmdit_double_attention(txt, img, norm, norm, cos, sin, HEADS, HD)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        mma.mmdit_single_attention(torch.cat([txt, img], 1), norm, cos, sin,
                                   HEADS, HD)
    used = lib.mmdit_attention_mp if multipass else lib.mmdit_attention
    assert len(used.calls) == 2
    assert counts() == before

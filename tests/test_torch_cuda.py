"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; elsewhere they skip.
On the card they run without the JAX package (which the machine with the
card does not have), so this file imports no JAX and the conftest, which
does, is left out::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the kernels round P to bf16 against a running max (and, in
the one-pass regime, fold the log2(e)/sqrt(128) prescale into q before
its bf16 round), so they agree with the dense plain version of their
regime to |err| <= 4e-3 + 2e-2*|ref| per element and 1e-2 in relative
Frobenius norm, in bf16 (as ``chip_smoke.py``). The int8 serving kernels
(end of the file) are held to the same bar, and the W8A8 GEMM bitwise. The one-pass plain
version is the unfused composition under ``dense_attention()``. The multi-pass kernel is
held to the multi-pass plain version (``reference_mp_*``), never to the
one-pass one; the one-pass ceiling is lowered so that small shapes reach
it.
"""

import pytest
import torch

from domainrag_tpu_torch.ops import attention as attn
from domainrag_tpu_torch.ops import mmdit_attention as mma

pytestmark = pytest.mark.cuda

ATOL, RTOL, REL_NORM = 4e-3, 2e-2, 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, seed, shapes, s_total, heads):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    xs = [torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
          for s in shapes]
    ang = torch.rand((s_total, 64), generator=g, device=dev) * 6.283 - 3.1416
    norms = [{"q": {"scale": 0.5 + torch.rand(128, generator=g, device=dev)},
              "k": {"scale": 0.5 + torch.rand(128, generator=g, device=dev)}}
             for _ in range(2)]
    return xs, torch.cos(ang), torch.sin(ang), norms


def _check(got, want):
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    bound = ATOL + RTOL * want.float().abs()
    assert bool((err <= bound).all()), f"max abs err {err.max().item()}"
    rel_norm = (err.norm() / want.float().norm()).item()
    assert rel_norm < REL_NORM, f"relative norm err {rel_norm}"


# the padded row space (stream b from the first 128-row boundary after the
# text stream): text streams of 127, 128 and 129 rows and the 1241-row one,
# batch 2, image streams ragged and exact
DOUBLE_EDGES = [(2, 127, 200, 2), (1, 128, 128, 3), (2, 129, 77, 2),
                (2, 1241, 384, 2)]


@pytest.mark.parametrize("batch,s_txt,s_img,heads", [
    (1, 64, 192, 2), (2, 40, 88, 3), (1, 1241, 4096, 24)] + DOUBLE_EDGES)
def test_double_kernel_matches_plain(dev, batch, s_txt, s_img, heads):
    w = 3 * heads * 128
    (txt, img), cos, sin, (tn, inorm) = _inputs(
        dev, 0, [(batch, s_txt, w), (batch, s_img, w)], s_txt + s_img, heads)
    n = mma.mmdit_double_attention.launches
    got_t, got_i = mma.mmdit_double_attention(txt, img, tn, inorm, cos, sin,
                                              heads, 128)
    torch.cuda.synchronize()
    assert mma.mmdit_double_attention.launches == n + 1
    with attn.dense_attention():
        want_t, want_i = mma.reference_double(
            txt, img, tn["q"]["scale"], tn["k"]["scale"], inorm["q"]["scale"],
            inorm["k"]["scale"], cos, sin, heads, 128)
    _check(got_t, want_t)
    _check(got_i, want_i)


# ragged tails and exact tiles of one stream (the one-row stream, last,
# stays under the lowered multi-pass gate)
SINGLE_EDGES = [(1, 127, 2), (2, 129, 2), (1, 256, 3), (2, 1, 2)]


@pytest.mark.parametrize("batch,s,heads", [
    (1, 96, 2), (2, 130, 3), (1, 5337, 24)] + SINGLE_EDGES)
def test_single_kernel_matches_plain(dev, batch, s, heads):
    w = 7 * heads * 128                       # q/k/v + MLP lanes
    (proj,), cos, sin, (qn, _) = _inputs(dev, 1, [(batch, s, w)], s, heads)
    n = mma.mmdit_single_attention.launches
    got = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    torch.cuda.synchronize()
    assert mma.mmdit_single_attention.launches == n + 1
    with attn.dense_attention():
        want = mma.reference_single(proj, qn["q"]["scale"], qn["k"]["scale"],
                                    cos, sin, heads, 128)
    _check(got, want)


def test_kernel_reads_strided_rows_in_place(dev):
    """A row window of a larger tensor: batch stride > rows * width and a
    row offset, read in place (no contiguous copy)."""
    heads, w = 2, 7 * 2 * 128
    (big,), cos, sin, (qn, _) = _inputs(dev, 2, [(2, 100, w)], 77, heads)
    proj = big[:, 10:87]
    got = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    with attn.dense_attention():
        want = mma.reference_single(proj, qn["q"]["scale"], qn["k"]["scale"],
                                    cos, sin, heads, 128)
    _check(got, want)
    same = mma.mmdit_single_attention(proj.contiguous(), qn, cos, sin,
                                      heads, 128)
    assert torch.equal(got, same)


@pytest.fixture
def low_gate(monkeypatch):
    """Joint lengths above 64 tokens take the multi-pass kernel."""
    monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)


@pytest.mark.parametrize("batch,s_txt,s_img,heads", [
    (2, 40, 88, 3), (2, 64, 192, 2), (1, 77, 300, 24)] + DOUBLE_EDGES)
def test_mp_double_kernel_matches_plain(dev, low_gate, batch, s_txt, s_img,
                                        heads):
    w = 3 * heads * 128
    (txt, img), cos, sin, (tn, inorm) = _inputs(
        dev, 3, [(batch, s_txt, w), (batch, s_img, w)], s_txt + s_img, heads)
    n = (mma.mmdit_double_attention.launches,
         mma.mmdit_double_attention.mp_launches)
    got_t, got_i = mma.mmdit_double_attention(txt, img, tn, inorm, cos, sin,
                                              heads, 128)
    torch.cuda.synchronize()
    assert (mma.mmdit_double_attention.launches,
            mma.mmdit_double_attention.mp_launches) == (n[0], n[1] + 1)
    want_t, want_i = mma.reference_mp_double(
        txt, img, tn["q"]["scale"], tn["k"]["scale"], inorm["q"]["scale"],
        inorm["k"]["scale"], cos, sin, heads, 128)
    _check(got_t, want_t)
    _check(got_i, want_i)


@pytest.mark.parametrize("batch,s,heads", [
    (2, 130, 3), (2, 333, 2), (1, 1000, 24)] + SINGLE_EDGES[:3])
def test_mp_single_kernel_matches_plain(dev, low_gate, batch, s, heads):
    w = 7 * heads * 128                       # q/k/v + MLP lanes
    (proj,), cos, sin, (qn, _) = _inputs(dev, 4, [(batch, s, w)], s, heads)
    n = (mma.mmdit_single_attention.launches,
         mma.mmdit_single_attention.mp_launches)
    got = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    torch.cuda.synchronize()
    assert (mma.mmdit_single_attention.launches,
            mma.mmdit_single_attention.mp_launches) == (n[0], n[1] + 1)
    want = mma.reference_mp_single(proj, qn["q"]["scale"], qn["k"]["scale"],
                                   cos, sin, heads, 128)
    _check(got, want)


@pytest.mark.parametrize("onepass", [True, False], ids=["onepass", "mp"])
def test_kernel_reads_rows_in_place_at_pitch_21504(dev, monkeypatch,
                                                   onepass):
    """The single block at FLUX width: 24 heads, rows of 7*24*128 = 21504
    lanes (q/k/v + MLP), a row window of a larger batch-2 tensor (batch
    stride > rows * pitch), V read in place at lane 6144; and the double
    block's 9216-lane rows as windows too."""
    if not onepass:
        monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    heads = 24
    (big, big_t, big_i), cos, sin, (qn, inorm) = _inputs(
        dev, 16, [(2, 300, 7 * heads * 128), (2, 160, 3 * heads * 128),
                  (2, 200, 3 * heads * 128)], 257, heads)
    proj = big[:, 21:278]
    got = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    txt, img = big_t[:, 3:132], big_i[:, 50:178]
    got_d = mma.mmdit_double_attention(txt, img, qn, inorm, cos, sin, heads,
                                       128)
    torch.cuda.synchronize()
    assert proj.stride(1) == 21504 and txt.stride(1) == 9216
    w = (qn["q"]["scale"], qn["k"]["scale"])
    wi = (inorm["q"]["scale"], inorm["k"]["scale"])
    if onepass:
        with attn.dense_attention():
            want = mma.reference_single(proj, *w, cos, sin, heads, 128)
            want_d = mma.reference_double(txt, img, *w, *wi, cos, sin, heads,
                                          128)
    else:
        want = mma.reference_mp_single(proj, *w, cos, sin, heads, 128)
        want_d = mma.reference_mp_double(txt, img, *w, *wi, cos, sin, heads,
                                         128)
    _check(got, want)
    for g_, w_ in zip(got_d, want_d):
        _check(g_, w_)


def test_mp_kernel_reads_strided_rows_in_place(dev, low_gate):
    """Both streams as row windows of larger tensors, read in place."""
    heads, w = 2, 3 * 2 * 128
    (big_t, big_i), cos, sin, (tn, inorm) = _inputs(
        dev, 5, [(2, 60, w), (2, 150, w)], 37 + 101, heads)
    txt, img = big_t[:, 5:42], big_i[:, 20:121]
    got = mma.mmdit_double_attention(txt, img, tn, inorm, cos, sin, heads,
                                     128)
    want = mma.reference_mp_double(
        txt, img, tn["q"]["scale"], tn["k"]["scale"], inorm["q"]["scale"],
        inorm["k"]["scale"], cos, sin, heads, 128)
    for g, w_ in zip(got, want):
        _check(g, w_)
    same = mma.mmdit_double_attention(txt.contiguous(), img.contiguous(), tn,
                                      inorm, cos, sin, heads, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, same))


def test_mp_kernel_rounds_like_the_multipass_plain(dev, monkeypatch):
    """The multi-pass kernel rounds q unscaled and scales the f32 scores:
    it is nearer the multi-pass plain version than the one-pass kernel
    (q prescaled before its bf16 round) is on the same input. A
    multi-pass entry that kept the one-pass fold would equal the one-pass
    kernel and fail here, though it stays inside the tolerance."""
    heads, s = 4, 600
    (proj,), cos, sin, (qn, _) = _inputs(dev, 6, [(2, s, 7 * heads * 128)],
                                         s, heads)
    onepass = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    multipass = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    want = mma.reference_mp_single(proj, qn["q"]["scale"], qn["k"]["scale"],
                                   cos, sin, heads, 128).float()

    def rel(x):
        return ((x.float() - want).norm() / want.norm()).item()

    assert rel(multipass) < 0.8 * rel(onepass), (rel(multipass),
                                                  rel(onepass))


# ---------------------------------------------------------------------------
# generic flash attention: B5 forward, B6 backward (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------
# Tolerances against the plain versions (ops.attention), as chip_smoke.py:
# - bf16 output: the one-pass bar above (P rounded against a running max);
# - bf16 gradients: 1e-2 in relative Frobenius norm and every element within
#   2e-2 * max|ref| (P and dS are rounded to bf16 for the tensor-core
#   products, where the plain version keeps every product in f32);
# - f32: the forward as three bf16 terms (six products), the backward in
#   3xTF32, whose products keep about f32's precision, so summation order
#   and exp2f/expf differ (measured 7.1e-7 forward, ~3e-6 backward in
#   relative norm on the H100): F32_REL in relative norm and per element
#   F32_REL * max|ref|;
# - lse (f32 in both instances): LSE_ATOL absolute.
GRAD_REL, GRAD_ELEM = 1e-2, 2e-2
F32_REL = 1e-5
LSE_ATOL = 1e-3

FLASH_CASES = [            # (b, h, s_q, s_kv, d, causal, kv_valid)
    (1, 2, 128, 128, 128, False, None),     # aligned
    (2, 3, 200, 200, 64, False, None),      # ragged, D = 64 padded
    (1, 2, 300, 300, 128, True, None),      # causal, ragged
    (2, 2, 150, 333, 128, False, 77),       # kv_valid, s_q != s_kv
    (1, 2, 1000, 1000, 128, True, 613),     # causal + kv_valid, ragged
    # the bf16 backward's 128-row kv tiles: kv_valid at a tile edge and one
    # past it; kv tiles wholly masked (256 .. 639 beyond kv_valid 130);
    # causal with s_q < s_kv (kv rows no q reaches) and s_q > s_kv; b*h >=
    # 132 (a block on every SM); s_kv 4608, dq summed over 36 kv tiles
    (1, 2, 300, 400, 128, False, 256),
    (1, 2, 300, 400, 128, False, 257),
    (1, 2, 200, 700, 128, False, 130),
    (1, 2, 200, 520, 128, True, None),
    (1, 2, 520, 200, 128, True, None),
    (2, 70, 130, 130, 128, False, None),
    (1, 2, 192, 4608, 128, False, None),
]
FLASH_IDS = ["aligned", "ragged_d64", "causal", "kv_valid", "causal_kv",
             "kv_valid_256", "kv_valid_257", "masked_kv_tiles",
             "causal_sq_lt_skv", "causal_sq_gt_skv", "bh_140", "skv_4608"]


def _qkv(dev, dtype, b, h, s_q, s_kv, d, seed=7):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    return (rnd(b, h, s_q, d), rnd(b, h, s_kv, d), rnd(b, h, s_kv, d),
            rnd(b, h, s_q, d))


def _rel(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def _check_grad(got, want, dtype):
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    rel, elem = (GRAD_REL, GRAD_ELEM) if dtype == torch.bfloat16 \
        else (F32_REL, F32_REL)
    assert err.max().item() <= elem * top, (err.max().item(), top)
    assert _rel(got, want) < rel, _rel(got, want)


def _check_out(got, want, dtype):
    if dtype == torch.bfloat16:
        _check(got, want)
    else:
        _check_grad(got, want, dtype)


# forward only, the bf16 forward's 128-row q blocks and 128-key tiles:
# lengths under one tile (s_q 1 and 50, s_kv 37), causal with s_q > s_kv
# inside one tile, kv_valid at a tile edge (whole tiles past it are never
# visited), causal blocks of s_q != s_kv stopping at their last tile
FWD_CASES = [
    (1, 2, 50, 50, 128, False, None),
    (1, 2, 100, 37, 128, True, None),
    (2, 3, 1, 300, 64, False, None),
    (1, 2, 300, 700, 128, False, 128),
    (1, 2, 260, 1000, 128, True, 129),
    (2, 2, 700, 300, 128, True, None),
]
FWD_IDS = ["s50", "causal_s100_skv37", "sq1", "kv_valid_128",
           "causal_kv_valid_129", "causal_sq700_skv300"]


# the f32 forward's 128-row q blocks and 64-key tiles: causal at a ragged
# length, kv_valid at a tile edge and one past it, causal + kv_valid, causal
# with s_q < s_kv, the trainer's length with D = 64 padded
F32_FWD_CASES = [
    (1, 2, 129, 129, 128, True, None),
    (1, 2, 200, 300, 128, False, 64),
    (1, 2, 200, 300, 128, False, 65),
    (2, 3, 190, 190, 128, True, 100),
    (1, 2, 70, 1000, 128, True, None),
    (1, 2, 4608, 4608, 64, False, None),
]
F32_FWD_IDS = ["causal_s129", "kv_valid_64", "kv_valid_65",
               "causal_kv_valid_100", "causal_sq70_skv1000", "s4608_d64"]


@pytest.mark.parametrize("b,h,s_q,s_kv,d,causal,kv_valid", F32_FWD_CASES,
                         ids=F32_FWD_IDS)
def test_flash_f32_forward_tiles(dev, b, h, s_q, s_kv, d, causal, kv_valid):
    """B5 f32 (bf16 terms on wgmma) at its own tile edges, under F32_REL."""
    q, k, v, _ = _qkv(dev, torch.float32, b, h, s_q, s_kv, d, seed=3)
    _poison(q)
    out, lse = attn._kernel_forward(q, k, v, causal, kv_valid)
    torch.cuda.synchronize()
    want, want_lse = attn.flash_forward_reference(q, k, v, causal, kv_valid)
    _check_grad(out, want, torch.float32)
    assert (lse - want_lse).abs().max().item() < LSE_ATOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,s_q,s_kv,d,causal,kv_valid",
                         FLASH_CASES + FWD_CASES, ids=FLASH_IDS + FWD_IDS)
def test_flash_forward_matches_plain(dev, dtype, b, h, s_q, s_kv, d, causal,
                                     kv_valid):
    q, k, v, _ = _qkv(dev, dtype, b, h, s_q, s_kv, d)
    n = attn.flash_attention.launches
    out, lse = attn._kernel_forward(q, k, v, causal, kv_valid)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == n + 1
    want, want_lse = attn.flash_forward_reference(q, k, v, causal, kv_valid)
    _check_out(out, want, dtype)
    assert (lse - want_lse).abs().max().item() < LSE_ATOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,s_q,s_kv,d,causal,kv_valid", FLASH_CASES,
                         ids=FLASH_IDS)
def test_flash_backward_matches_plain(dev, dtype, b, h, s_q, s_kv, d, causal,
                                      kv_valid):
    q, k, v, dout = _qkv(dev, dtype, b, h, s_q, s_kv, d)
    out, lse = attn.flash_forward_reference(q, k, v, causal, kv_valid)
    n = _bwd_counts()
    got = attn._kernel_backward(q, k, v, out, lse, dout, causal, kv_valid)
    torch.cuda.synchronize()
    # one backward kernel in each dtype
    want = (1, 0) if dtype == torch.bfloat16 else (0, 1)
    assert tuple(a - b for a, b in zip(_bwd_counts(), n)) == want
    want = attn.flash_backward_reference(q, k, v, out, lse, dout, causal,
                                         kv_valid)
    for g_, w_ in zip(got, want):
        _check_grad(g_, w_, dtype)


def _bwd_counts():
    f = attn.flash_attention
    return f.bwd_launches, f.bwd_f32_launches


def _poison(like, n=8):
    """Leave n freed blocks of ``like``'s size filled with NaN in the
    caching allocator, so that an output the kernel fails to write does
    not happen to hold zeros."""
    junk = [torch.full_like(like, float("nan")) for _ in range(n)]
    del junk


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("s_q,s_kv,causal,kv_valid,zero_from", [
    (200, 700, False, 130, 130),       # kv rows past kv_valid
    (200, 520, True, None, 200),       # kv rows past the last q row
], ids=["kv_valid", "causal"])
def test_flash_backward_unreached_kv_rows_are_zero(dev, dtype, s_q, s_kv,
                                                   causal, kv_valid,
                                                   zero_from):
    """dk and dv rows that no unmasked q reaches, whole 128-row kv tiles
    among them, are written as exact zeros."""
    q, k, v, dout = _qkv(dev, dtype, 1, 2, s_q, s_kv, 128, seed=12)
    out, lse = attn.flash_forward_reference(q, k, v, causal, kv_valid)
    _poison(k)
    _, dk, dv = attn._kernel_backward(q, k, v, out, lse, dout, causal,
                                      kv_valid)
    torch.cuda.synchronize()
    for g_ in (dk, dv):
        tail = g_[:, :, zero_from:]
        assert torch.equal(tail, torch.zeros_like(tail))
        assert bool(torch.isfinite(g_).all())


# B6 adds dq over the kv blocks in ascending order (the turns of
# csrc/flash_attention.cu), so a backward repeats itself bit for bit:
# (b, h, s_q, s_kv, causal, kv_valid, dlse). 36 kv blocks add into every
# dq row at 4608 keys; causal blocks start at different q tiles; a ragged
# kv_valid leaves a part block (1044 of 1152 keys, the ring's ragged
# block) and whole blocks past it; the LSE's gradient enters as delta -
# dlse (the ring's backward); the trainer's shape fills the card.
REPEAT_CASES = [
    (2, 4, 640, 640, False, None, False),
    (1, 2, 256, 4608, False, None, False),
    (1, 2, 1000, 1000, True, None, False),
    (1, 2, 1152, 1408, False, 1044, False),
    (2, 4, 1152, 1152, False, 1044, True),
    (2, 24, 4608, 4608, False, None, False),
]
REPEAT_IDS = ["s640", "skv4608", "causal_s1000", "kv_valid_1044",
              "dlse_kv_valid_1044", "trainer_2x24x4608"]
REPEAT_RUNS = 5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("b,h,s_q,s_kv,causal,kv_valid,dlse", REPEAT_CASES,
                         ids=REPEAT_IDS)
def test_flash_backward_repeatable(dev, dtype, b, h, s_q, s_kv, causal,
                                   kv_valid, dlse):
    """The same backward run REPEAT_RUNS times: dq, dk and dv of every run
    torch.equal to the first run's."""
    q, k, v, dout = _qkv(dev, dtype, b, h, s_q, s_kv, 128, seed=13)
    out, lse = attn.flash_forward_reference(q, k, v, causal, kv_valid)
    g = torch.Generator(device=dev)
    g.manual_seed(14)
    dl = torch.randn(lse.shape, generator=g, device=dev) if dlse else None
    runs = [attn._kernel_backward(q, k, v, out, lse, dout, causal, kv_valid,
                                  dl) for _ in range(REPEAT_RUNS)]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(runs[0][0]).all())
    for i, run in enumerate(runs[1:], 1):
        for name, got, first in zip(("dq", "dk", "dv"), run, runs[0]):
            assert torch.equal(got, first), (i, name, _rel(got, first))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_autograd_card_vs_cpu(dev, dtype):
    """flash_attention's autograd on the card (B5 + B6) against the same
    Function on the CPU (the plain versions)."""
    # the B5 forward's out and lse are what B6 consumes: one launch of each
    # per call, at head width 64 and 128, s_q == s_kv and s_q != s_kv
    bwd = (1, 0) if dtype == torch.bfloat16 else (0, 1)
    for b, h, s_q, s_kv, d, causal in ((2, 2, 190, 190, 64, True),
                                       (1, 3, 300, 130, 128, True),
                                       (2, 2, 129, 257, 128, False)):
        q, k, v, dout = _qkv(dev, dtype, b, h, s_q, s_kv, d, seed=8)
        grads = []
        for x in (q, k, v, dout), tuple(t.cpu() for t in (q, k, v, dout)):
            leaves = [t.clone().requires_grad_() for t in x[:3]]
            n = attn.flash_attention.launches, _bwd_counts()
            out = attn.flash_attention(*leaves, causal=causal)
            out.backward(x[3])
            if x[0].is_cuda:
                torch.cuda.synchronize()
                assert attn.flash_attention.launches == n[0] + 1
                assert tuple(a - c for a, c in zip(_bwd_counts(), n[1])) \
                    == bwd
            grads.append([out.detach().cpu()] + [t.grad.cpu()
                                                 for t in leaves])
        _check_out(grads[0][0], grads[1][0], dtype)
        for g_, w_ in zip(grads[0][1:], grads[1][1:]):
            _check_grad(g_, w_, dtype)


def _counts():
    f = attn.flash_attention
    return (mma.mmdit_double_attention.launches,
            mma.mmdit_single_attention.launches,
            mma.mmdit_single_attention.mp_launches,
            f.launches, f.bwd_launches, f.bwd_f32_launches)


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128),
                                      (torch.bfloat16, 64)],
                         ids=["f32", "head_dim64"])
def test_unfused_streams_run_b5(dev, dtype, hd):
    """An f32 stream and a head_dim-64 stream leave the fused kernels for
    the unfused composition, which runs B5 on the card (forward and
    backward), and agree with the CPU."""
    heads, s = 2, 96
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    proj = torch.randn((1, s, 7 * heads * hd), generator=g, device=dev)
    proj = proj.to(dtype)
    ang = torch.rand((s, hd // 2), generator=g, device=dev) * 6.283
    cos, sin = torch.cos(ang), torch.sin(ang)
    norm = {"q": {"scale": 0.5 + torch.rand(hd, generator=g, device=dev)},
            "k": {"scale": 0.5 + torch.rand(hd, generator=g, device=dev)}}
    before = _counts()
    x = proj.clone().requires_grad_()
    out = mma.mmdit_single_attention(x, norm, cos, sin, heads, hd)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    after = _counts()
    assert after[:3] == before[:3]                       # no fused kernel
    # B5 once; B6: the bf16 kernel or the f32 one
    want = [1, 0, 1] if dtype == torch.float32 else [1, 1, 0]
    assert [a - b for a, b in zip(after[3:], before[3:])] == want
    xc = proj.cpu().requires_grad_()
    norm_c = {n: {"scale": w["scale"].cpu()} for n, w in norm.items()}
    ref = mma.mmdit_single_attention(xc, norm_c, cos.cpu(), sin.cpu(), heads,
                                     hd)
    ref.float().square().sum().backward()
    _check_out(out.detach().cpu(), ref.detach(), dtype)
    _check_grad(x.grad.cpu(), xc.grad, dtype)


def test_above_multipass_runs_b5(dev, monkeypatch):
    """Above the (lowered) multi-pass ceiling a bf16 head_dim-128 call
    runs B5, not B1-B3, and agrees with the dense composition."""
    monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    monkeypatch.setattr(mma, "_MAX_MULTIPASS", 128)
    heads = 2
    (txt, img), cos, sin, (tn, inorm) = _inputs(
        dev, 10, [(1, 40, 3 * heads * 128), (1, 120, 3 * heads * 128)], 160,
        heads)
    before = _counts(), mma.mmdit_double_attention.mp_launches
    got = mma.mmdit_double_attention(txt, img, tn, inorm, cos, sin, heads,
                                     128)
    torch.cuda.synchronize()
    after = _counts(), mma.mmdit_double_attention.mp_launches
    assert after[1] == before[1] and after[0][0] == before[0][0]
    assert after[0][3] == before[0][3] + 1
    with attn.dense_attention():
        want = mma.reference_double(
            txt, img, tn["q"]["scale"], tn["k"]["scale"], inorm["q"]["scale"],
            inorm["k"]["scale"], cos, sin, heads, 128)
    for g_, w_ in zip(got, want):
        _check(g_, w_)


@pytest.mark.parametrize("onepass", [True, False], ids=["onepass", "mp"])
def test_fused_autograd_card_vs_cpu(dev, monkeypatch, onepass):
    """Both fused wrappers' autograd on the card (fused forward, unfused
    B5/B6 backward) against the CPU (plain forward, dense backward), for
    the qkv streams and the f32 qk-norm scales."""
    if not onepass:
        monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    heads = 2
    (txt, img, proj), cos, sin, (tn, inorm) = _inputs(
        dev, 11, [(1, 40, 3 * heads * 128), (1, 88, 3 * heads * 128),
                  (1, 128, 7 * heads * 128)], 128, heads)
    results = []
    for where in (dev, torch.device("cpu")):
        before = _counts(), mma.mmdit_double_attention.mp_launches
        leaves = [t.to(where).clone().requires_grad_()
                  for t in (txt, img, proj, tn["q"]["scale"], tn["k"]["scale"],
                            inorm["q"]["scale"], inorm["k"]["scale"])]
        lt, li, lp, wqt, wkt, wqi, wki = leaves
        c, s_ = cos.to(where), sin.to(where)
        ot, oi = mma.mmdit_double_attention(
            lt, li, {"q": {"scale": wqt}, "k": {"scale": wkt}},
            {"q": {"scale": wqi}, "k": {"scale": wki}}, c, s_, heads, 128)
        op = mma.mmdit_single_attention(
            lp, {"q": {"scale": wqt}, "k": {"scale": wkt}}, c, s_, heads, 128)
        loss = sum((o.float() * torch.cos(o.float())).sum()
                   for o in (ot, oi, op))
        loss.backward()
        if where.type == "cuda":
            # one fused forward per wrapper; the backward recomputes the
            # unfused composition: the B5 forward twice, its out and lse
            # consumed by the bf16 B6 twice
            torch.cuda.synchronize()
            after = _counts(), mma.mmdit_double_attention.mp_launches
            fused = (after[0][0] - before[0][0],
                     after[0][1] - before[0][1],
                     after[0][2] - before[0][2], after[1] - before[1])
            assert fused == ((1, 1, 0, 0) if onepass else (0, 0, 1, 1))
            assert [a - c for a, c in zip(after[0][3:], before[0][3:])] \
                == [2, 2, 0]
        results.append([t.grad.float().cpu() for t in leaves])
    # bf16 forward and backward each within 1e-2 of their plain versions
    for g_, w_ in zip(*results):
        assert _rel(g_, w_) < 2e-2, _rel(g_, w_)


# ---------------------------------------------------------------------------
# int8 serving: the W8A8 GEMM B4 (csrc/int8_gemm.cu) and the int8 attention
# B7 (csrc/int8_attention.cu)
# ---------------------------------------------------------------------------
# B4 is bitwise equal to its plain version (exact integer dot, the same f32
# epilogue in the same order). B7 is held to its plain version with the
# bf16 bar above; the int8 P.V instance quantizes P against the same max
# window as the plain version (the whole row in one pass, 1024 keys in
# multi-pass), so it lands on the same integer grid.

from domainrag_tpu_torch.ops import int8_gemm as ig    # noqa: E402


# (K, N) of every quantized linear of the stage-3 and stage-4 int8 paths,
# then two ragged ones (K % 16 != 0: the mma instance; N = 64)
W8A8_KN = [(64, 3072), (256, 3072), (384, 3072), (768, 3072), (3072, 64),
           (3072, 3072), (3072, 6144), (3072, 9216), (3072, 12288),
           (3072, 18432), (3072, 21504), (4096, 3072), (12288, 3072),
           (15360, 3072), (1000, 70), (384, 64)]


# M: the gemv (1, 17, 63), the wgmma instance's first rows (64, 65), one
# 128-row tile past a multiple (640) and the stage-3 joint length (5337)
@pytest.mark.parametrize("m", [1, 17, 63, 64, 65, 640, 5337])
@pytest.mark.parametrize("k,n", W8A8_KN)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_w8a8_kernel_equals_plain(dev, m, k, n, dtype):
    g = torch.Generator(device=dev)
    g.manual_seed(m + k + n)
    x = (torch.randn((m, k), generator=g, device=dev) * 3).to(dtype)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                       dtype=torch.int8)                    # K-major
    ws = torch.rand(n, generator=g, device=dev) / 127
    b = torch.randn(n, generator=g, device=dev) if m != 17 else None
    inst = ig.instance(m, k, n)
    before = ig.w8a8_linear.launches
    before_inst = ig.w8a8_linear.launches_by_instance.get(inst, 0)
    _poison(torch.empty((m, n), dtype=dtype, device=dev))
    got = ig.w8a8_linear(x, wq, ws, b)
    torch.cuda.synchronize()
    assert ig.w8a8_linear.launches == before + 1
    assert ig.w8a8_linear.launches_by_instance[inst] == before_inst + 1
    xq, xs = ig.quantize_rowwise(x)
    want = ig.w8a8_reference(xq, wq, xs, ws, b, dtype)
    assert got.dtype == dtype and torch.equal(got, want)


# ragged M (and N) at each instance: wgmma (65 and 130 rows; bf16 with N
# % 8 == 0 takes its staged TMA store), gemv (63), mma (65, K % 16 != 0)
@pytest.mark.parametrize("m,k,n", [(65, 384, 64), (130, 3072, 300),
                                   (63, 384, 64), (65, 1000, 70)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_w8a8_kernel_stores_only_its_rows(dev, m, k, n, dtype):
    """The kernel writes rows 0..M-1 of its output and nothing past them:
    called straight into the head of a NaN-filled buffer with 130 more
    rows, which must stay NaN."""
    g = torch.Generator(device=dev)
    g.manual_seed(m * n)
    x = torch.randn((m, k), generator=g, device=dev) * 3
    wq = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                       dtype=torch.int8)
    ws = torch.rand(n, generator=g, device=dev) / 127
    b = torch.randn(n, generator=g, device=dev).to(dtype)
    xq, xs = ig.quantize_rowwise(x)
    xs = xs.reshape(m).contiguous()
    inst = ig.instance(m, k, n)
    buf = torch.full((m + 130, n), float("nan"), dtype=dtype, device=dev)
    rc = ig._lib().w8a8_gemm(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        b.data_ptr(), buf.data_ptr(), m, n, k, int(dtype == torch.float32),
        ig.INSTANCES.index(inst), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    want = ig.w8a8_reference(xq, wq, xs[:, None], ws, b, dtype)
    assert torch.equal(buf[:m], want), inst
    assert bool(torch.isnan(buf[m:]).all()), f"{inst} wrote past row {m}"


@pytest.fixture
def int8_attn():
    """Sets the int8 attention flags for a test; always reset."""
    def set_(pv):
        mma.set_int8_qk(True)
        mma.set_int8_pv(pv)
    try:
        yield set_
    finally:
        mma.set_int8_qk(False)
        mma.set_int8_pv(False)


def _i8_counts(wrapper):
    return (wrapper.launches, wrapper.mp_launches, wrapper.i8_launches,
            wrapper.i8_mp_launches)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "qk_pv"])
@pytest.mark.parametrize("mp", [False, True], ids=["onepass", "mp"])
@pytest.mark.parametrize("batch,s_txt,s_img,heads", [
    (1, 40, 88, 2), (2, 77, 300, 3),
    # the 128-row tiles' ragged edges: the txt/img boundary inside a key
    # tile, counts just under and over a multiple of 128, exact multiples
    (1, 200, 300, 2), (2, 127, 129, 3), (1, 128, 256, 2), (2, 129, 383, 2)])
def test_i8_double_kernel_matches_plain(dev, monkeypatch, int8_attn, pv, mp,
                                        batch, s_txt, s_img, heads):
    if mp:
        monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    int8_attn(pv)
    w = 3 * heads * 128
    (txt, img), cos, sin, (tn, inorm) = _inputs(
        dev, 12, [(batch, s_txt, w), (batch, s_img, w)], s_txt + s_img, heads)
    f = mma.mmdit_double_attention
    before = _i8_counts(f)
    got = f(txt, img, tn, inorm, cos, sin, heads, 128)
    torch.cuda.synchronize()
    step = (0, 0, 0, 1) if mp else (0, 0, 1, 0)
    assert _i8_counts(f) == tuple(a + b for a, b in zip(before, step))
    plain = mma.reference_mp_i8_double if mp else mma.reference_i8_double
    want = plain(txt, img, tn["q"]["scale"], tn["k"]["scale"],
                 inorm["q"]["scale"], inorm["k"]["scale"], cos, sin, heads,
                 128, pv=pv)
    for g_, w_ in zip(got, want):
        _check(g_, w_)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "qk_pv"])
@pytest.mark.parametrize("mp", [False, True], ids=["onepass", "mp"])
@pytest.mark.parametrize("batch,s,heads", [
    (1, 96, 2), (2, 1500, 3), (1, 127, 2), (2, 129, 3), (1, 256, 2),
    (2, 1025, 2)])
def test_i8_single_kernel_matches_plain(dev, monkeypatch, int8_attn, pv, mp,
                                        batch, s, heads):
    if mp:
        monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    int8_attn(pv)
    (proj,), cos, sin, (qn, _) = _inputs(dev, 13, [(batch, s, 7 * heads * 128)],
                                         s, heads)
    f = mma.mmdit_single_attention
    before = _i8_counts(f)
    got = f(proj, qn, cos, sin, heads, 128)
    torch.cuda.synchronize()
    step = (0, 0, 0, 1) if mp else (0, 0, 1, 0)
    assert _i8_counts(f) == tuple(a + b for a, b in zip(before, step))
    plain = mma.reference_mp_i8_single if mp else mma.reference_i8_single
    _check(got, plain(proj, qn["q"]["scale"], qn["k"]["scale"], cos, sin,
                      heads, 128, pv=pv))


def test_i8_mp_kernel_takes_the_1024_key_window(dev, monkeypatch, int8_attn):
    """With int8 P.V the max window sets the quantisation grid: over 3000
    keys the multi-pass kernel is far nearer the plain version at 1024-key
    windows than the same plain version at 2048-key windows."""
    monkeypatch.setattr(mma, "_MAX_ONEPASS", 64)
    int8_attn(True)
    heads, s = 2, 3000
    (proj,), cos, sin, (qn, _) = _inputs(dev, 14, [(1, s, 7 * heads * 128)],
                                         s, heads)
    got = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    args = (proj, qn["q"]["scale"], qn["k"]["scale"], cos, sin, heads, 128)
    near = _rel(got, mma.reference_mp_i8_single(*args, pv=True))
    far = _rel(got, mma.reference_mp_i8_single(*args, pv=True, bkv=2048))
    assert near < 0.2 * far, (near, far)


def test_scales_divide_by_127_exactly(dev):
    """The int8 scales are amax / 127 correctly rounded, as the JAX
    package's; on the card torch divides by a Python number through its
    reciprocal, which is 1 ulp off for some values, so the plain versions
    divide by a tensor (ops.int8_gemm.div127)."""
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    x = torch.rand(1 << 16, generator=g, device=dev) * 10
    want = x.cpu() / 127.0                 # true division on the CPU
    assert torch.equal(ig.div127(x).cpu(), want)


# ---------------------------------------------------------------------------
# B8: the fused GEMM + top-k of the stage-2 search. On integer-valued banks
# every inner product is exact in f32 under any order, so the kernel is held
# to its plain version with torch.equal, ties (duplicated rows) included.
# ---------------------------------------------------------------------------

import numpy as np    # noqa: E402

from domainrag_tpu_torch.ops import topk as tk           # noqa: E402
from domainrag_tpu_torch.stages import retrieve as tret  # noqa: E402


def _int_bank(dev, seed, nq, nb, d, ties):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lo, hi = (-2, 3) if ties else (-8, 8)
    bank = torch.randint(lo, hi, (nb, d), generator=g, device=dev).float()
    q = torch.randint(lo, hi, (nq, d), generator=g, device=dev).float()
    if ties:
        bank[nb // 3:2 * (nb // 3)] = bank[:nb // 3]
    return q, bank


def _fused_equal(q, bank, k):
    n = tk.topk_ip_fused.launches
    got = tk.topk_ip_fused(q, bank, k)
    torch.cuda.synchronize()
    assert tk.topk_ip_fused.launches == n + 1
    want = tk.reference_topk_ip_fused(q, bank, k)
    assert got[0].shape == (q.shape[0], k) and got[1].dtype == torch.int32
    assert torch.equal(got[1], want[1]), "indices differ"
    assert torch.equal(got[0], want[0]), "scores differ"


@pytest.mark.parametrize("nq,nb,d,k,ties", [
    (7, 333, 64, 100, False), (3, 513, 32, 100, True),
    (200, 20000, 512, 100, True), (65, 4099, 96, 100, True),
    (33, 1000, 50, 1, True),      # d % 4 != 0: the scalar-load instance
    (5, 777, 128, 256, True), (1, 100000, 512, 100, False),
    (4, 50, 32, 100, False),      # k > N: (-FLT_MAX, 2^31 - 1) fillers
    (33, 1000, 50, 300, True),    # k > 256: the lists in the scratch
    (65, 4099, 96, 1000, True),
])
def test_topk_fused_matches_plain(dev, nq, nb, d, k, ties):
    _fused_equal(*_int_bank(dev, nq + nb + d + k, nq, nb, d, ties), k)


def test_topk_fused_unaligned_and_strided(dev):
    """A bank whose rows start off 16-byte alignment (scalar loads) and a
    strided query view (made contiguous by the wrapper)."""
    q, bank = _int_bank(dev, 21, 9, 1500, 64, True)
    flat = torch.empty(bank.numel() + 1, device=dev)
    flat[1:] = bank.reshape(-1)
    _fused_equal(q, flat[1:].view(1500, 64), 100)
    wide = torch.zeros(9, 128, device=dev)
    wide[:, ::2] = q
    _fused_equal(wide[:, ::2], bank, 100)


def test_topk_fused_rejects_k_above_256(dev):
    """k = 257, the first k whose list (512 entries) takes the 8-row
    blocks: one launch of the kernel, equal to the plain version."""
    q, bank = _int_bank(dev, 22, 2, 600, 32, False)
    _fused_equal(q, bank, 257)


@pytest.mark.parametrize("k", [500, 1000])
@pytest.mark.parametrize("nb", [1500, 400])      # 400: k > N, fillers
def test_topk_fused_wide_k_on_duplicated_bank(dev, nb, k):
    """k = 500 and 1000 on a bank with a third of its rows duplicated:
    one launch, B8's contract exactly (indices and scores equal to the
    plain version, ties by index ascending), indices equal to
    ``topk_ip``'s."""
    q, bank = _int_bank(dev, 25, 6, nb, 64, True)
    _fused_equal(q, bank, k)
    m = min(k, nb)
    assert torch.equal(tk.topk_ip_fused(q, bank, k)[1][:, :m],
                       tk.topk_ip(q, bank, k)[1])


def _ordered_bank(dev, kind, nq, nb, d):
    """B8's hardest banks for its buffered selection, every sum exact:
    ``ascending`` (one-hot queries on lane 0, the bank's lane 0 its row
    index: score = index, so every tile beats every row's threshold and
    each tile merges every buffer) and ``all_equal`` (every score ties;
    the index order alone decides)."""
    if kind == "all_equal":
        return (torch.ones(nq, d, device=dev), torch.ones(nb, d, device=dev))
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    q = torch.zeros(nq, d, device=dev)
    q[:, 0] = 1
    bank = torch.randint(-8, 8, (nb, d), generator=g, device=dev).float()
    bank[:, 0] = torch.arange(nb, device=dev, dtype=torch.float32)
    return q, bank


@pytest.mark.parametrize("k", [100, 1000])
@pytest.mark.parametrize("kind", ["ascending", "all_equal"])
def test_topk_fused_ordered_banks(dev, kind, k):
    """The ascending and all-equal banks: one launch, torch.equal to the
    plain version."""
    _fused_equal(*_ordered_bank(dev, kind, 9, 20000, 128), k)


def _excused(plain_scores, k, tol=1e-5):
    """Positions (of the first k) whose score lies within tol of a
    neighbour in the plain version's order (k + 1 scores given): there
    the two float orders may swap ranks."""
    s = plain_scores
    near = (s[:, :-1] - s[:, 1:]).abs() <= tol          # pair (j, j + 1)
    out = torch.zeros_like(s[:, :k], dtype=torch.bool)
    out |= near[:, :k]
    out[:, 1:] |= near[:, :k - 1]
    return out


def test_topk_fused_unit_norm_bank(dev):
    """Random unit rows: the kernel's k-ascending FFMA sums and cuBLAS's
    differ in the last bits, so scores agree within 1e-5 and indices at
    every position not within 1e-5 of a neighbour."""
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    bank = torch.nn.functional.normalize(
        torch.randn(50000, 512, generator=g, device=dev), dim=1)
    q = torch.nn.functional.normalize(
        torch.randn(40, 512, generator=g, device=dev), dim=1)
    got = tk.topk_ip_fused(q, bank, 100)
    want = tk.reference_topk_ip_fused(q, bank, 101)
    assert (got[0] - want[0][:, :100]).abs().max().item() <= 1e-5
    ok = (got[1] == want[1][:, :100]) | _excused(want[0], 100)
    assert bool(ok.all())


def test_first_stage_use_pallas_launches_b8_once(dev):
    q, bank = _int_bank(dev, 24, 12, 3000, 64, True)
    paths = [f"{i}.jpg" for i in range(3000)]
    eb = tret.EmbeddingBank.from_sources({"coco": bank.cpu().numpy()},
                                         {"coco": paths}, device=dev)
    n = tk.topk_ip_fused.launches
    default = tret.first_stage_topk(q.cpu().numpy(), eb, 100)
    assert tk.topk_ip_fused.launches == n
    fused = tret.first_stage_topk(q.cpu().numpy(), eb, 100, use_pallas=True)
    assert tk.topk_ip_fused.launches == n + 1
    assert fused == default
    want = tk.topk_ip_numpy(q.cpu().numpy(), bank.cpu().numpy(), 100)[1]
    np.testing.assert_array_equal(
        np.array([[r["index"] for r in row] for row in fused]), want)

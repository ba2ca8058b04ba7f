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
Frobenius norm, in bf16 (as ``chip_smoke.py``). The multi-pass kernel is
held to the multi-pass plain version (``reference_mp_*``), never to the
one-pass one; the one-pass ceiling is lowered so that small shapes reach
it.
"""

import pytest
import torch

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


@pytest.mark.parametrize("batch,s_txt,s_img,heads", [
    (1, 64, 192, 2), (2, 40, 88, 3), (1, 1241, 4096, 24)])
def test_double_kernel_matches_plain(dev, batch, s_txt, s_img, heads):
    w = 3 * heads * 128
    (txt, img), cos, sin, (tn, inorm) = _inputs(
        dev, 0, [(batch, s_txt, w), (batch, s_img, w)], s_txt + s_img, heads)
    n = mma.mmdit_double_attention.launches
    got_t, got_i = mma.mmdit_double_attention(txt, img, tn, inorm, cos, sin,
                                              heads, 128)
    torch.cuda.synchronize()
    assert mma.mmdit_double_attention.launches == n + 1
    want_t, want_i = mma.reference_double(
        txt, img, tn["q"]["scale"], tn["k"]["scale"], inorm["q"]["scale"],
        inorm["k"]["scale"], cos, sin, heads, 128)
    _check(got_t, want_t)
    _check(got_i, want_i)


@pytest.mark.parametrize("batch,s,heads", [
    (1, 96, 2), (2, 130, 3), (1, 5337, 24)])
def test_single_kernel_matches_plain(dev, batch, s, heads):
    w = 7 * heads * 128                       # q/k/v + MLP lanes
    (proj,), cos, sin, (qn, _) = _inputs(dev, 1, [(batch, s, w)], s, heads)
    n = mma.mmdit_single_attention.launches
    got = mma.mmdit_single_attention(proj, qn, cos, sin, heads, 128)
    torch.cuda.synchronize()
    assert mma.mmdit_single_attention.launches == n + 1
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
    (2, 40, 88, 3), (2, 64, 192, 2), (1, 77, 300, 24)])
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
    (2, 130, 3), (2, 333, 2), (1, 1000, 24)])
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

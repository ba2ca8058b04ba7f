"""The port's fused MMDiT attention (domainrag_tpu_torch.ops.mmdit_attention)
against the JAX package's, on the same numpy inputs.

On the CPU the port's wrappers run their plain version, which the CUDA
kernels are held to on the card (tests/test_torch_cuda.py,
chip_smoke.py). Here that plain version is held to:

- the JAX wrappers with ``interpret=True``, which run the Pallas
  ``_joint_kernel`` / ``_seq_kernel`` as tests/test_mmdit_attention.py
  does, in bf16 at atol = rtol = 0.05 (that file's tolerance: the kernel
  folds the softmax prescale into q before the bf16 round);
- the JAX ``_reference_double`` / ``_reference_single`` in f32 at 1e-5
  (same algorithm, so only summation order differs).

The multi-pass regime's plain version (``reference_mp_*``, joint lengths
above ``_MAX_ONEPASS``) is held to:

- the JAX ``_fused_double_mp`` / ``_fused_single_mp`` with
  ``interpret=True, bq=64`` (several K/V passes of the Pallas
  ``_flash_mp_kernel``), in bf16 at atol = rtol = 0.05 as above;
- a dense JAX composition of the same rounding (``_prep_norm_rope``,
  f32 scores times the prescale, exp2 softmax, P rounded to bf16): in
  bf16 within 5e-4 in relative Frobenius norm, where the one-pass
  rounding (prescale folded into q) lands ~3e-3 away, and in f32 at
  1e-5.
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.ops import mmdit_attention as jmma
from domainrag_tpu_torch.ops import mmdit_attention as tmma

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

HEADS = 2
HD = 128


def _inputs(seed, shapes, s_total):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ang = rng.uniform(-np.pi, np.pi, size=(s_total, HD // 2))
    norms = [rng.uniform(0.5, 1.5, size=(HD,)).astype(np.float32)
             for _ in range(4)]
    return arrays, np.cos(ang).astype(np.float32), \
        np.sin(ang).astype(np.float32), norms


def _qknorm(wq, wk, lib):
    return {"q": {"scale": lib(wq)}, "k": {"scale": lib(wk)}}


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _t(x, dtype):
    return torch.from_numpy(np.asarray(x)).to(dtype)


@pytest.mark.parametrize("s_txt,s_img", [(64, 192), (512, 512)])
def test_double_matches_pallas_kernel(s_txt, s_img):
    (txt, img), cos, sin, (wqt, wkt, wqi, wki) = _inputs(
        1, [(1, s_txt, 3 * HEADS * HD), (1, s_img, 3 * HEADS * HD)],
        s_txt + s_img)
    want_t, want_i = jmma.mmdit_double_attention(
        jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
        _qknorm(wqt, wkt, jnp.asarray), _qknorm(wqi, wki, jnp.asarray),
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
    launches = tmma.mmdit_double_attention.launches
    got_t, got_i = tmma.mmdit_double_attention(
        _t(txt, torch.bfloat16), _t(img, torch.bfloat16),
        _qknorm(wqt, wkt, torch.from_numpy),
        _qknorm(wqi, wki, torch.from_numpy),
        torch.from_numpy(cos), torch.from_numpy(sin), HEADS, HD)
    assert tmma.mmdit_double_attention.launches == launches  # plain path
    assert got_t.dtype == torch.bfloat16
    assert tuple(got_t.shape) == (1, s_txt, HEADS * HD)
    assert tuple(got_i.shape) == (1, s_img, HEADS * HD)
    _close(got_t.float(), want_t, 0.05, 0.05)
    _close(got_i.float(), want_i, 0.05, 0.05)


@pytest.mark.parametrize("s", [96, 512])
def test_single_matches_pallas_kernel(s):
    width = 3 * HEADS * HD + 4 * HEADS * HD      # MLP lanes included
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(2, [(1, s, width)], s)
    want = jmma.mmdit_single_attention(
        jnp.asarray(proj, jnp.bfloat16), _qknorm(wq, wk, jnp.asarray),
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
    launches = tmma.mmdit_single_attention.launches
    got = tmma.mmdit_single_attention(
        _t(proj, torch.bfloat16), _qknorm(wq, wk, torch.from_numpy),
        torch.from_numpy(cos), torch.from_numpy(sin), HEADS, HD)
    assert tmma.mmdit_single_attention.launches == launches
    assert tuple(got.shape) == (1, s, HEADS * HD)
    _close(got.float(), want, 0.05, 0.05)


@pytest.mark.parametrize("s_txt,s_img", [(64, 192), (40, 88)])
def test_double_matches_jax_reference_f32(s_txt, s_img):
    (txt, img), cos, sin, (wqt, wkt, wqi, wki) = _inputs(
        3, [(2, s_txt, 3 * HEADS * HD), (2, s_img, 3 * HEADS * HD)],
        s_txt + s_img)
    want_t, want_i = jmma._reference_double(
        jnp.asarray(txt), jnp.asarray(img), wqt, wkt, wqi, wki,
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD)
    got_t, got_i = tmma.reference_double(
        torch.from_numpy(txt), torch.from_numpy(img),
        *(torch.from_numpy(w) for w in (wqt, wkt, wqi, wki)),
        torch.from_numpy(cos), torch.from_numpy(sin), HEADS, HD)
    _close(got_t, want_t, 1e-5, 1e-5)
    _close(got_i, want_i, 1e-5, 1e-5)


@pytest.mark.parametrize("s", [96, 130])
def test_single_matches_jax_reference_f32(s):
    width = 3 * HEADS * HD + 4 * HEADS * HD
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(4, [(2, s, width)], s)
    want = jmma._reference_single(jnp.asarray(proj), wq, wk,
                                  jnp.asarray(cos), jnp.asarray(sin),
                                  HEADS, HD)
    got = tmma.reference_single(torch.from_numpy(proj),
                                torch.from_numpy(wq), torch.from_numpy(wk),
                                torch.from_numpy(cos), torch.from_numpy(sin),
                                HEADS, HD)
    _close(got, want, 1e-5, 1e-5)


def test_single_ignores_mlp_lanes():
    """Only the first 3*H*128 lanes of linear1's output are read."""
    width = 3 * HEADS * HD + 4 * HEADS * HD
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(5, [(1, 64, width)], 64)
    other = proj.copy()
    other[..., 3 * HEADS * HD:] = 7.0
    args = (_qknorm(wq, wk, torch.from_numpy), torch.from_numpy(cos),
            torch.from_numpy(sin), HEADS, HD)
    a = tmma.mmdit_single_attention(torch.from_numpy(proj), *args)
    b = tmma.mmdit_single_attention(torch.from_numpy(other), *args)
    assert torch.equal(a, b)


def test_rope_is_interleaved_pairs():
    """(x[2i], x[2i+1]) rotates by angle i — not the half-split layout."""
    x = torch.zeros(1, 1, 1, 4)
    x[..., 2] = 1.0                       # pair 1, first element
    ang = torch.tensor([[0.0, np.pi / 2]])
    out = tmma.rope_interleaved(x, torch.cos(ang), torch.sin(ang))
    np.testing.assert_allclose(out.reshape(-1).numpy(), [0, 0, 0, 1],
                               atol=1e-6)


# ---------------------------------------------------------------------------
# multi-pass regime (above _MAX_ONEPASS)
# ---------------------------------------------------------------------------

def _jax_mp_dense(q_parts, k_parts, v, heads):
    """Dense JAX multi-pass numerics over prenormed parts: f32 scores x
    log2(e)/sqrt(128), exp2 softmax with the exact max, P in v's dtype."""
    q = jnp.concatenate(q_parts, axis=1)
    k = jnp.concatenate(k_parts, axis=1)
    b, s, _ = q.shape
    q4, k4, v4 = (x.reshape(b, s, heads, HD) for x in (q, k, v))
    sc = jnp.einsum("bqhd,bkhd->bhqk", q4, k4, precision="highest",
                    preferred_element_type=jnp.float32) \
        * (jmma.LOG2_E / math.sqrt(128.0))
    p = jnp.exp2(sc - sc.max(-1, keepdims=True))
    o = jnp.einsum("bhqk,bkhd->bhqd", p.astype(v.dtype), v4,
                   precision="highest", preferred_element_type=jnp.float32)
    o = o / jnp.maximum(p.sum(-1, keepdims=True), 1e-30)
    return o.astype(v.dtype).transpose(0, 2, 1, 3).reshape(b, s, heads * HD)


def _jax_mp_double(txt, img, wqt, wkt, wqi, wki, cos, sin):
    hd = HEADS * HD
    st = txt.shape[1]
    prep = jmma._prep_norm_rope
    out = _jax_mp_dense(
        [prep(txt[..., :hd], wqt, cos[:st], sin[:st]),
         prep(img[..., :hd], wqi, cos[st:], sin[st:])],
        [prep(txt[..., hd:2 * hd], wkt, cos[:st], sin[:st]),
         prep(img[..., hd:2 * hd], wki, cos[st:], sin[st:])],
        jnp.concatenate([txt[..., 2 * hd:3 * hd], img[..., 2 * hd:3 * hd]],
                        axis=1), HEADS)
    return out[:, :st], out[:, st:]


def _jax_mp_single(proj, wq, wk, cos, sin):
    hd = HEADS * HD
    prep = jmma._prep_norm_rope
    return _jax_mp_dense([prep(proj[..., :hd], wq, cos, sin)],
                         [prep(proj[..., hd:2 * hd], wk, cos, sin)],
                         proj[..., 2 * hd:3 * hd], HEADS)


def _rel_norm(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.linalg.norm(g - w) / np.linalg.norm(w)


def _double_args(seed, batch, s_txt, s_img):
    (txt, img), cos, sin, ws = _inputs(
        seed, [(batch, s_txt, 3 * HEADS * HD), (batch, s_img, 3 * HEADS * HD)],
        s_txt + s_img)
    return txt, img, ws, cos, sin


@pytest.mark.parametrize("s_txt,s_img", [(64, 192), (40, 88)])
def test_mp_double_matches_pallas_kernel(s_txt, s_img):
    txt, img, ws, cos, sin = _double_args(11, 2, s_txt, s_img)
    want = jmma._fused_double_mp(
        jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
        *(jnp.asarray(w) for w in ws), jnp.asarray(cos), jnp.asarray(sin),
        heads=HEADS, interpret=True, qkv3=False, bq=64)
    got = tmma.reference_mp_double(
        _t(txt, torch.bfloat16), _t(img, torch.bfloat16),
        *(torch.from_numpy(w) for w in ws), torch.from_numpy(cos),
        torch.from_numpy(sin), HEADS, HD)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        _close(g.float(), w, 0.05, 0.05)


@pytest.mark.parametrize("s", [96, 130])
def test_mp_single_matches_pallas_kernel(s):
    width = 3 * HEADS * HD + 4 * HEADS * HD      # MLP lanes included
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(12, [(2, s, width)], s)
    want = jmma._fused_single_mp(
        jnp.asarray(proj, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(wk),
        jnp.asarray(cos), jnp.asarray(sin), heads=HEADS, interpret=True,
        qkv3=False, bq=64)
    got = tmma.reference_mp_single(
        _t(proj, torch.bfloat16), torch.from_numpy(wq), torch.from_numpy(wk),
        torch.from_numpy(cos), torch.from_numpy(sin), HEADS, HD)
    assert tuple(got.shape) == (2, s, HEADS * HD)
    _close(got.float(), want, 0.05, 0.05)


def test_mp_rounding_is_the_multipass_one():
    """bf16: the plain multi-pass version is the dense JAX multi-pass
    composition up to summation order; the one-pass rounding is not."""
    txt, img, ws, cos, sin = _double_args(13, 2, 40, 88)
    want = _jax_mp_double(jnp.asarray(txt, jnp.bfloat16),
                          jnp.asarray(img, jnp.bfloat16),
                          *(jnp.asarray(w) for w in ws), jnp.asarray(cos),
                          jnp.asarray(sin))
    args = (_t(txt, torch.bfloat16), _t(img, torch.bfloat16),
            *(torch.from_numpy(w) for w in ws), torch.from_numpy(cos),
            torch.from_numpy(sin), HEADS, HD)
    got = tmma.reference_mp_double(*args)
    onepass = tmma.reference_double(*args)
    for g, o, w in zip(got, onepass, want):
        assert _rel_norm(g.float(), w) < 5e-4
        assert _rel_norm(o.float(), w) > 1e-3


@pytest.mark.parametrize("s_txt,s_img", [(64, 192), (40, 88)])
def test_mp_double_matches_jax_f32(s_txt, s_img):
    txt, img, ws, cos, sin = _double_args(14, 2, s_txt, s_img)
    want = _jax_mp_double(jnp.asarray(txt), jnp.asarray(img),
                          *(jnp.asarray(w) for w in ws), jnp.asarray(cos),
                          jnp.asarray(sin))
    got = tmma.reference_mp_double(
        torch.from_numpy(txt), torch.from_numpy(img),
        *(torch.from_numpy(w) for w in ws), torch.from_numpy(cos),
        torch.from_numpy(sin), HEADS, HD)
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-5)


@pytest.mark.parametrize("s", [96, 130])
def test_mp_single_matches_jax_f32(s):
    width = 3 * HEADS * HD + 4 * HEADS * HD
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(15, [(2, s, width)], s)
    want = _jax_mp_single(jnp.asarray(proj), jnp.asarray(wq),
                          jnp.asarray(wk), jnp.asarray(cos), jnp.asarray(sin))
    got = tmma.reference_mp_single(
        torch.from_numpy(proj), torch.from_numpy(wq), torch.from_numpy(wk),
        torch.from_numpy(cos), torch.from_numpy(sin), HEADS, HD)
    _close(got, want, 1e-5, 1e-5)


def test_prep_norm_rope_matches_jax():
    """f32 at 1e-5; bf16 within one bf16 rounding step."""
    (x,), cos, sin, (w, _, _, _) = _inputs(16, [(2, 37, HEADS * HD)], 37)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2 ** -7)):
        want = jmma._prep_norm_rope(jnp.asarray(x, jdt), jnp.asarray(w),
                                    jnp.asarray(cos), jnp.asarray(sin))
        got = tmma.prep_norm_rope(_t(x, dt), torch.from_numpy(w),
                                  torch.from_numpy(cos), torch.from_numpy(sin))
        assert got.dtype == dt
        _close(got.float(), want, tol, tol)


def test_plain_mp_blocks_q_rows(monkeypatch):
    """The plain multi-pass version gives the same output whatever the
    block of q rows it works in."""
    txt, img, ws, cos, sin = _double_args(17, 1, 24, 72)
    args = (torch.from_numpy(txt), torch.from_numpy(img),
            *(torch.from_numpy(w) for w in ws), torch.from_numpy(cos),
            torch.from_numpy(sin), HEADS, HD)
    whole = tmma.reference_mp_double(*args)
    monkeypatch.setattr(tmma, "_MP_ROWS", 7)
    blocked = tmma.reference_mp_double(*args)
    for a, b in zip(whole, blocked):
        _close(a, b, 1e-6, 1e-6)


def test_gate_routes_like_jax(monkeypatch):
    """With the one-pass ceiling lowered in both packages, the port's
    wrappers take the multi-pass plain version above it and agree with
    the JAX wrappers (which then run the Pallas multi-pass kernel)."""
    monkeypatch.setattr(jmma, "_MAX_ONEPASS", 128)
    monkeypatch.setattr(tmma, "_MAX_ONEPASS", 128)
    txt, img, ws, cos, sin = _double_args(18, 1, 64, 192)   # 256 > 128
    wqt, wkt, wqi, wki = ws
    want_t, want_i = jmma.mmdit_double_attention(
        jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
        _qknorm(wqt, wkt, jnp.asarray), _qknorm(wqi, wki, jnp.asarray),
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
    args = (_t(txt, torch.bfloat16), _t(img, torch.bfloat16))
    tables = (torch.from_numpy(cos), torch.from_numpy(sin))
    before = (tmma.mmdit_double_attention.launches,
              tmma.mmdit_double_attention.mp_launches)
    got_t, got_i = tmma.mmdit_double_attention(
        *args, _qknorm(wqt, wkt, torch.from_numpy),
        _qknorm(wqi, wki, torch.from_numpy), *tables, HEADS, HD)
    assert before == (tmma.mmdit_double_attention.launches,
                      tmma.mmdit_double_attention.mp_launches)
    plain_t, plain_i = tmma.reference_mp_double(
        *args, *(torch.from_numpy(w) for w in ws), *tables, HEADS, HD)
    assert torch.equal(got_t, plain_t) and torch.equal(got_i, plain_i)
    _close(got_t.float(), want_t, 0.05, 0.05)
    _close(got_i.float(), want_i, 0.05, 0.05)

    # the single block on both sides of the lowered gate
    width = 3 * HEADS * HD + 4 * HEADS * HD
    for s, plain in ((96, tmma.reference_single),
                     (160, tmma.reference_mp_single)):
        (proj,), c, sn, (wq, wk, _, _) = _inputs(19, [(1, s, width)], s)
        want = jmma.mmdit_single_attention(
            jnp.asarray(proj, jnp.bfloat16), _qknorm(wq, wk, jnp.asarray),
            jnp.asarray(c), jnp.asarray(sn), HEADS, HD, interpret=True)
        p = _t(proj, torch.bfloat16)
        got = tmma.mmdit_single_attention(
            p, _qknorm(wq, wk, torch.from_numpy), torch.from_numpy(c),
            torch.from_numpy(sn), HEADS, HD)
        assert torch.equal(got, plain(p, torch.from_numpy(wq),
                                      torch.from_numpy(wk),
                                      torch.from_numpy(c),
                                      torch.from_numpy(sn), HEADS, HD))
        _close(got.float(), want, 0.05, 0.05)


def test_above_multipass_raises(monkeypatch):
    """Above _MAX_MULTIPASS both packages leave the fused path for the
    unfused composition: on the CPU the port agrees with the JAX wrappers
    there, and a tensor off the CPU goes to the generic flash kernel (B5)
    and raises when that launch fails - it never reaches the fused
    kernels nor a plain version."""
    for mod in (tmma, jmma):
        monkeypatch.setattr(mod, "_MAX_ONEPASS", 64)
        monkeypatch.setattr(mod, "_MAX_MULTIPASS", 128)
    txt, img, ws, cos, sin = _double_args(20, 1, 64, 192)
    wqt, wkt, wqi, wki = ws
    want = jmma.mmdit_double_attention(
        jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
        _qknorm(wqt, wkt, jnp.asarray), _qknorm(wqi, wki, jnp.asarray),
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
    tables = (torch.from_numpy(cos), torch.from_numpy(sin))
    got = tmma.mmdit_double_attention(
        _t(txt, torch.bfloat16), _t(img, torch.bfloat16),
        _qknorm(wqt, wkt, torch.from_numpy),
        _qknorm(wqi, wki, torch.from_numpy), *tables, HEADS, HD)
    for g, w in zip(got, want):           # both run the dense composition
        _close(g.float(), w, 1e-2, 1e-2)

    def no_b5():
        raise RuntimeError("no B5 kernel here")

    def no_fused():
        raise AssertionError("the fused kernels must not run here")

    from domainrag_tpu_torch.ops import attention as tattn
    monkeypatch.setattr(tattn, "_lib", no_b5)
    monkeypatch.setattr(tmma, "_lib", no_fused)
    meta = dict(device="meta", dtype=torch.bfloat16)
    norm = _qknorm(wqt, wkt, lambda w: torch.from_numpy(w).to("meta"))
    tables = tuple(t.to("meta") for t in tables)
    mt = torch.empty(1, 64, 3 * HEADS * HD, **meta)
    mi = torch.empty(1, 192, 3 * HEADS * HD, **meta)
    before = tattn.flash_attention.launches
    with pytest.raises(RuntimeError, match="no B5 kernel"):
        tmma.mmdit_double_attention(mt, mi, norm, norm, *tables, HEADS, HD)
    with pytest.raises(RuntimeError, match="no B5 kernel"):
        tmma.mmdit_single_attention(torch.cat([mt, mi], 1), norm, *tables,
                                    HEADS, HD)
    assert tattn.flash_attention.launches == before


def test_mp_wrappers_launch_or_raise_off_cpu(monkeypatch):
    """Above the gate a tensor off the CPU goes to the multi-pass entry of
    the kernel library and nowhere else: when the launch fails, the
    wrapper raises and counts no launch of either regime."""
    def entry(regime):
        def fail(*_):
            raise RuntimeError(f"no {regime} kernel here")
        return fail

    lib = types.SimpleNamespace(mmdit_attention=entry("one-pass"),
                                mmdit_attention_mp=entry("multi-pass"))
    monkeypatch.setattr(tmma, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tmma, "_MAX_ONEPASS", 16)
    meta = dict(device="meta", dtype=torch.bfloat16)
    norm = {"q": {"scale": torch.ones(HD)}, "k": {"scale": torch.ones(HD)}}
    txt = torch.empty(1, 8, 3 * HEADS * HD, **meta)
    img = torch.empty(1, 16, 3 * HEADS * HD, **meta)
    cos = sin = torch.zeros(24, HD // 2)
    counts = lambda: tuple((w.launches, w.mp_launches)  # noqa: E731
                           for w in (tmma.mmdit_double_attention,
                                     tmma.mmdit_single_attention))
    before = counts()
    with pytest.raises(RuntimeError, match="no multi-pass kernel"):
        tmma.mmdit_double_attention(txt, img, norm, norm, cos, sin, HEADS, HD)
    with pytest.raises(RuntimeError, match="no multi-pass kernel"):
        tmma.mmdit_single_attention(torch.cat([txt, img], 1), norm, cos,
                                    sin, HEADS, HD)
    with pytest.raises(RuntimeError, match="no one-pass kernel"):
        tmma.mmdit_single_attention(txt, norm, cos[:8], sin[:8], HEADS, HD)
    assert counts() == before

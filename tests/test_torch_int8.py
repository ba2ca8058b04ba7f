"""The port's int8 serving modes against the JAX package's, on the same numpy
inputs (on the CPU, where the port runs its plain versions).

- ``models.quant``: ``quantize_linear`` / ``quantize_tree`` bitwise equal to
  the JAX ones on f32 weights; a JAX-quantized tree carried across by
  ``bridge.params`` keeps its int8 / f32 leaves.
- W8A8 ``common.linear``: bitwise equal to the JAX W8A8 branch (under
  ``set_int8_activations(True)``) and to ``int8_gemm.w8a8_linear(...,
  interpret=True)`` (the Pallas B4 in interpret mode) where the JAX gate
  lets that run, in bf16 and f32, with and without bias (in f32 with a
  bias the JAX package's own two paths differ by 1 ulp; there the port
  follows its W8A8 branch, and the Pallas path is held within 1 ulp).
- Weight-only int8 ``linear``: within one bf16 rounding of the output
  (atol = rtol = 2^-7) in bf16, 1e-5 in f32.
- int8 attention: each plain version (one pass and multi-pass, joint and
  single, int8 QK and int8 QK + P.V) against the JAX wrappers or
  ``_fused_*_mp`` running the Pallas int8 kernels in interpret mode. Same
  integer grid on both sides, so the gap is a rare +-1 of a quantised P
  or q/k at a rounding boundary (exp2 and rsqrt differ in their last bit
  between XLA and torch): every element within ATOL_I8 + RTOL_I8 * |ref|
  and the whole within REL_I8 in relative Frobenius norm, far inside the
  JAX package's own 0.08 / 0.1 envelopes against the exact composition.
  Each output also differs from the exact composition by more than
  MIN_I8_GAP in relative norm, so the flag is shown to reach the plain
  version.

The MMDiT and the stages under the int8 modes are in
``test_torch_int8_stage.py`` (``flux.apply`` and ``generate``) and
``test_torch_int8_fill.py`` (``fill_batch`` and the planted quantizers).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models import common as jcommon
from domainrag_tpu.models import quant as jquant
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.ops import int8_gemm as jgemm
from domainrag_tpu.ops import mmdit_attention as jmma
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models import common as tcommon
from domainrag_tpu_torch.models import quant as tquant
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.ops import int8_gemm as tgemm
from domainrag_tpu_torch.ops import mmdit_attention as tmma

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

HEADS, HD = 2, 128
# Measured over the 24 attention cases below: the port's plain versions
# are at most 4.0e-4 from the Pallas int8 kernels in relative norm and
# 2.2e-3 in any element, and at least 1.36e-2 from the exact composition.
# Plain versions with a planted wrong scale granularity land 1.1e-2 to
# 4e-1 from the kernels (test_i8_limits_catch_wrong_granularity).
ATOL_I8, RTOL_I8, REL_I8 = 6e-3, 1e-2, 2e-3
MIN_I8_GAP = 7e-3


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(np.asarray(x, np.float32)))
    return t if dtype is None else t.to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


def _rel(got, want):
    g, w = _np(got), _np(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


# ---------------------------------------------------------------------------
# quantization of weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,zero_col", [((64, 96), False),
                                            ((300, 17), True)])
def test_quantize_linear_bitwise(shape, zero_col):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    if zero_col:
        w[:, 3] = 0.0                    # scale 0 -> 1, as in JAX
    b = np.arange(shape[1], dtype=np.float32)
    want = jquant.quantize_linear({"w": w, "b": b})
    got = tquant.quantize_linear({"w": torch.from_numpy(w),
                                  "b": torch.from_numpy(b)})
    assert got["w_q"].dtype == torch.int8 and got["w_s"].dtype == torch.float32
    # the port's w_q is K-major, (out, in): the JAX (in, out) one transposed
    np.testing.assert_array_equal(got["w_q"].numpy(),
                                  np.asarray(want["w_q"]).T)
    np.testing.assert_array_equal(got["w_s"].numpy(), np.asarray(want["w_s"]))
    np.testing.assert_array_equal(got["b"].numpy(), b)


def test_quantize_tree_bitwise_and_bridge():
    """The tiny MMDiT quantized by both packages (min_size 1024: the
    default 65536 quantizes nothing at hidden 64), and the JAX-quantized
    tree carried across by the bridge, are the same tree."""
    params = jflux.init(jax.random.PRNGKey(3), jflux.TINY_FLUX)
    jq = jquant.quantize_tree(params, min_size=1024)
    carried = bridge.params(jax.tree.map(np.asarray, jq), device="cpu")
    port = tquant.quantize_tree(
        bridge.params(jax.tree.map(np.asarray, params), device="cpu"),
        min_size=1024)
    flat_c = jax.tree_util.tree_flatten_with_path(carried)[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(port)[0])
    assert len(flat_c) == len(flat_p)
    n_q = 0
    for path, leaf in flat_c:
        other = flat_p[path]
        assert leaf.dtype == other.dtype, path
        assert torch.equal(leaf, other), path
        n_q += path[-1].key == "w_q"
        if path[-1].key == "w_q":
            assert leaf.dtype == torch.int8
    assert n_q > 0
    assert tquant.quantized_bytes(carried) == jquant.quantized_bytes(jq)
    assert tquant.quantized_bytes(port) < tquant.quantized_bytes(
        bridge.params(jax.tree.map(np.asarray, params), device="cpu"))


# ---------------------------------------------------------------------------
# W8A8 and weight-only linear
# ---------------------------------------------------------------------------

@pytest.fixture
def w8a8_on():
    jcommon.set_int8_activations(True)
    tcommon.set_int8_activations(True)
    try:
        yield
    finally:
        jcommon.set_int8_activations(False)
        tcommon.set_int8_activations(False)


W8A8_SHAPES = [((640, 128), 384), ((2, 320, 128), 256), ((1, 256), 384)]


def _w8a8_linear_case(x_shape, n, with_bias, dtype):
    """One quantized linear under W8A8: JAX's params, input and output,
    and the port's params and output."""
    rng = np.random.default_rng(2)
    k = x_shape[-1]
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)}
    if with_bias:
        p["b"] = rng.standard_normal(n).astype(np.float32)
    jp = jquant.quantize_linear(p)
    tp = bridge.params(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal(x_shape).astype(np.float32) * 3.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jcommon.linear(jp, jx).astype(jnp.float32))
    got = tcommon.linear(tp, _t(x, getattr(torch, dtype)))
    return jp, tp, x, jx, got, want


@pytest.mark.parametrize("x_shape,n", W8A8_SHAPES,
                         ids=["m640_pad", "batched", "m1"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_w8a8_linear_bitwise(w8a8_on, x_shape, n, with_bias, dtype):
    k = x_shape[-1]
    jp, tp, x, jx, got, want = _w8a8_linear_case(x_shape, n, with_bias,
                                                 dtype)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    pallas = jgemm.w8a8_linear(jx, jp["w_q"], jp["w_s"], bias=jp.get("b"),
                               interpret=True)
    m = int(np.prod(x_shape[:-1]))
    assert (pallas is None) == (not jgemm.w8a8_eligible(m, k, n))
    assert tgemm.w8a8_eligible(m, k, n) == jgemm.w8a8_eligible(m, k, n)
    if pallas is None:
        return
    pallas = np.asarray(pallas.astype(jnp.float32))
    if dtype == "float32" and with_bias:
        # XLA's CPU build of the interpret-mode kernel contracts its last
        # multiply and the bias add into one FMA (its W8A8 branch above
        # does not), so here the JAX package's two paths differ by up to
        # 1 ulp of the product before the bias
        pre = tgemm.w8a8_linear(_t(x), tp["w_q"], tp["w_s"]).numpy()
        bound = np.spacing(np.abs(pre)) + np.spacing(np.abs(pallas))
        assert (np.abs(got.numpy() - pallas) <= bound).all()
    else:
        np.testing.assert_array_equal(got.float().numpy(), pallas)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2 ** -7),
                                       ("float32", 1e-5)])
def test_weight_only_int8_linear(dtype, tol):
    rng = np.random.default_rng(4)
    p = {"w": (rng.standard_normal((96, 160)) / np.sqrt(96)
               ).astype(np.float32),
         "b": rng.standard_normal(160).astype(np.float32)}
    jp = jquant.quantize_linear(p)
    tp = bridge.params(jax.tree.map(np.asarray, jp), device="cpu")
    x = rng.standard_normal((2, 33, 96)).astype(np.float32)
    want = jcommon.linear(jp, jnp.asarray(x, getattr(jnp, dtype)))
    got = tcommon.linear(tp, _t(x, getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_w8a8_reference_is_exact_past_f32():
    """The plain version's integer dot stays exact where an f32 sum of the
    products would not (|acc| > 2^24)."""
    k = 2048
    xq = torch.full((1, k), 127, dtype=torch.int8)
    w_q = torch.full((2, k), 127, dtype=torch.int8)     # K-major (N, K)
    w_q[1, 0] = 126
    y = tgemm.w8a8_reference(xq, w_q, torch.ones(1, 1), torch.ones(2), None,
                             torch.float32)
    exact = [k * 127 * 127, (k - 1) * 127 * 127 + 127 * 126]
    assert y.tolist() == [[float(np.float32(e)) for e in exact]]


# ---------------------------------------------------------------------------
# int8 attention plain versions against the Pallas int8 kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def int8_flags():
    """Sets both packages' int8 attention flags for a test; always reset."""
    def set_(qk, pv):
        for mod in (jmma, tmma):
            mod.set_int8_qk(qk)
            mod.set_int8_pv(pv)
    try:
        yield set_
    finally:
        set_(False, False)


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


def _gap_i8(got, want):
    """(largest element error over its limit, relative norm): both < 1
    and < REL_I8 within the limits."""
    g, w = _np(got), _np(want)
    assert got.dtype == torch.bfloat16 and g.shape == w.shape
    elem = float((np.abs(g - w) / (ATOL_I8 + RTOL_I8 * np.abs(w))).max())
    return elem, _rel(got, want)


def _close_i8(got, want, exact):
    elem, rel = _gap_i8(got, want)
    assert elem <= 1.0 and rel < REL_I8, (elem, rel)
    assert _rel(got, exact) > MIN_I8_GAP, _rel(got, exact)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "qk_pv"])
@pytest.mark.parametrize("s_txt,s_img", [(64, 192), (40, 88)])
def test_i8_double_matches_pallas_kernel(int8_flags, pv, s_txt, s_img):
    (txt, img), cos, sin, (wqt, wkt, wqi, wki) = _inputs(
        31, [(1, s_txt, 3 * HEADS * HD), (1, s_img, 3 * HEADS * HD)],
        s_txt + s_img)
    int8_flags(not pv, pv)                   # P.V implies QK
    want = jmma.mmdit_double_attention(
        jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
        _qknorm(wqt, wkt, jnp.asarray), _qknorm(wqi, wki, jnp.asarray),
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
    before = (tmma.mmdit_double_attention.launches,
              tmma.mmdit_double_attention.i8_launches)
    args = (_t(txt, torch.bfloat16), _t(img, torch.bfloat16),
            _qknorm(wqt, wkt, torch.from_numpy),
            _qknorm(wqi, wki, torch.from_numpy), _t(cos), _t(sin), HEADS, HD)
    got = tmma.mmdit_double_attention(*args)
    assert before == (tmma.mmdit_double_attention.launches,
                      tmma.mmdit_double_attention.i8_launches)
    plain = tmma.reference_i8_double(
        *args[:2], *(torch.from_numpy(w) for w in (wqt, wkt, wqi, wki)),
        *args[4:], pv=pv)
    int8_flags(False, False)
    exact = tmma.mmdit_double_attention(*args)
    for g, p, w, e in zip(got, plain, want, exact):
        assert torch.equal(g, p)
        _close_i8(g, w, e)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "qk_pv"])
@pytest.mark.parametrize("s", [96, 130])
def test_i8_single_matches_pallas_kernel(int8_flags, pv, s):
    width = 3 * HEADS * HD + 4 * HEADS * HD      # MLP lanes included
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(32, [(1, s, width)], s)
    int8_flags(True, pv)
    want = jmma.mmdit_single_attention(
        jnp.asarray(proj, jnp.bfloat16), _qknorm(wq, wk, jnp.asarray),
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
    args = (_t(proj, torch.bfloat16), _qknorm(wq, wk, torch.from_numpy),
            _t(cos), _t(sin), HEADS, HD)
    got = tmma.mmdit_single_attention(*args)
    plain = tmma.reference_i8_single(args[0], torch.from_numpy(wq),
                                     torch.from_numpy(wk), *args[2:], pv=pv)
    int8_flags(False, False)
    exact = tmma.mmdit_single_attention(*args)
    assert torch.equal(got, plain)
    _close_i8(got, want, exact)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "qk_pv"])
@pytest.mark.parametrize("s_txt,s_img", [(64, 192), (40, 88)])
def test_i8_mp_double_matches_pallas_kernel(pv, s_txt, s_img):
    """bq = bkv = 64: several max windows; the plain version takes the
    same window."""
    (txt, img), cos, sin, ws = _inputs(
        33, [(2, s_txt, 3 * HEADS * HD), (2, s_img, 3 * HEADS * HD)],
        s_txt + s_img)
    want = jmma._fused_double_mp(
        jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
        *(jnp.asarray(w) for w in ws), jnp.asarray(cos), jnp.asarray(sin),
        heads=HEADS, interpret=True, qkv3=False, bq=64, int8_qk=True,
        int8_pv=pv)
    args = (_t(txt, torch.bfloat16), _t(img, torch.bfloat16),
            *(torch.from_numpy(w) for w in ws), _t(cos), _t(sin), HEADS, HD)
    got = tmma.reference_mp_i8_double(*args, pv=pv, bkv=64)
    exact = tmma.reference_mp_double(*args)
    for g, w, e in zip(got, want, exact):
        _close_i8(g, w, e)


@pytest.mark.parametrize("pv", [False, True], ids=["qk", "qk_pv"])
@pytest.mark.parametrize("s", [96, 130])
def test_i8_mp_single_matches_pallas_kernel(pv, s):
    width = 3 * HEADS * HD + 4 * HEADS * HD
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(34, [(2, s, width)], s)
    want = jmma._fused_single_mp(
        jnp.asarray(proj, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(wk),
        jnp.asarray(cos), jnp.asarray(sin), heads=HEADS, interpret=True,
        qkv3=False, bq=64, int8_qk=True, int8_pv=pv)
    args = (_t(proj, torch.bfloat16), torch.from_numpy(wq),
            torch.from_numpy(wk), _t(cos), _t(sin), HEADS, HD)
    got = tmma.reference_mp_i8_single(*args, pv=pv, bkv=64)
    _close_i8(got, want, tmma.reference_mp_single(*args))


def test_i8_mp_window_is_the_plain_versions_own(monkeypatch):
    """With int8 P.V the max window changes the quantisation grid: the
    plain multi-pass version at 64-column windows is nearer JAX's bq = 64
    kernel than the same version at one window over all keys."""
    width = 3 * HEADS * HD + 4 * HEADS * HD
    (proj,), cos, sin, (wq, wk, _, _) = _inputs(35, [(1, 256, width)], 256)
    want = jmma._fused_single_mp(
        jnp.asarray(proj, jnp.bfloat16), jnp.asarray(wq), jnp.asarray(wk),
        jnp.asarray(cos), jnp.asarray(sin), heads=HEADS, interpret=True,
        qkv3=False, bq=64, int8_qk=True, int8_pv=True)
    args = (_t(proj, torch.bfloat16), torch.from_numpy(wq),
            torch.from_numpy(wk), _t(cos), _t(sin), HEADS, HD)
    same = tmma.reference_mp_i8_single(*args, pv=True, bkv=64)
    whole = tmma.reference_mp_i8_single(*args, pv=True, bkv=256)
    assert _rel(same, want) < 0.5 * _rel(whole, want)


def _plant_granularity(monkeypatch, plant):
    """Plants a wrong scale granularity in the port's one-pass int8 plain
    version: q with one scale instead of one per row, K with one per key
    instead of one per tensor, V with one per tensor instead of one per
    column, or one K (and V) scale over both streams of the joint block."""
    quant, head = tmma._quant, tmma._i8_onepass_head
    remap = {"q_per_tensor": {-1: None}, "v_per_tensor": {0: None}}

    def k_per_row(x, dim=None):
        if dim is not None:
            return quant(x, dim)
        x8, s = quant(x, -1)
        return x8, s.T

    if plant in remap:
        monkeypatch.setattr(tmma, "_quant", lambda x, dim=None: quant(
            x, remap[plant].get(dim, dim)))
    elif plant == "k_per_row":
        monkeypatch.setattr(tmma, "_quant", k_per_row)
    else:
        monkeypatch.setattr(
            tmma, "_i8_onepass_head", lambda qf, ks, vs, pv, dtype: head(
                qf, [torch.cat(ks)], [torch.cat(vs)], pv, dtype))


@pytest.mark.parametrize("plant,pv", [("q_per_tensor", False),
                                      ("k_per_row", False),
                                      ("v_per_tensor", True),
                                      ("one_k_scale", False)])
def test_i8_limits_catch_wrong_granularity(monkeypatch, int8_flags, plant,
                                           pv):
    """The limits the port's plain versions are held to above reject a
    plain version that quantizes at the wrong granularity (measured 1.1e-2
    to 4e-1 from the Pallas kernel in relative norm)."""
    if plant == "one_k_scale":
        (txt, img), cos, sin, ws = _inputs(
            31, [(1, 40, 3 * HEADS * HD), (1, 88, 3 * HEADS * HD)], 128)
    else:
        (proj,), cos, sin, (wq, wk, _, _) = _inputs(
            32, [(1, 96, 7 * HEADS * HD)], 96)
    int8_flags(True, pv)
    if plant == "one_k_scale":
        want = jmma.mmdit_double_attention(
            jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
            _qknorm(*ws[:2], jnp.asarray), _qknorm(*ws[2:], jnp.asarray),
            jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
        want = jnp.concatenate(want, axis=1)
        args = (_t(txt, torch.bfloat16), _t(img, torch.bfloat16),
                *(torch.from_numpy(w) for w in ws), _t(cos), _t(sin), HEADS,
                HD)
        good = torch.cat(tmma.reference_i8_double(*args, pv=pv), 1)
        _plant_granularity(monkeypatch, plant)
        bad = torch.cat(tmma.reference_i8_double(*args, pv=pv), 1)
    else:
        want = jmma.mmdit_single_attention(
            jnp.asarray(proj, jnp.bfloat16), _qknorm(wq, wk, jnp.asarray),
            jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
        args = (_t(proj, torch.bfloat16), torch.from_numpy(wq),
                torch.from_numpy(wk), _t(cos), _t(sin), HEADS, HD)
        good = tmma.reference_i8_single(*args, pv=pv)
        _plant_granularity(monkeypatch, plant)
        bad = tmma.reference_i8_single(*args, pv=pv)
    elem, rel = _gap_i8(good, want)
    assert elem <= 1.0 and rel < REL_I8, (elem, rel)
    elem, rel = _gap_i8(bad, want)
    assert rel > 2 * REL_I8 and elem > 1.0, (plant, elem, rel)


def test_i8_wrappers_route_like_jax(int8_flags, monkeypatch):
    """Under the flags, with the one-pass ceiling lowered in both packages,
    the port's wrappers take the int8 multi-pass plain version (1024-column
    windows) above it and agree with JAX's wrappers; f32 streams take the
    exact unfused composition whatever the flags say."""
    monkeypatch.setattr(jmma, "_MAX_ONEPASS", 128)
    monkeypatch.setattr(tmma, "_MAX_ONEPASS", 128)
    (txt, img), cos, sin, (wqt, wkt, wqi, wki) = _inputs(
        36, [(1, 64, 3 * HEADS * HD), (1, 192, 3 * HEADS * HD)], 256)
    int8_flags(True, True)
    want = jmma.mmdit_double_attention(
        jnp.asarray(txt, jnp.bfloat16), jnp.asarray(img, jnp.bfloat16),
        _qknorm(wqt, wkt, jnp.asarray), _qknorm(wqi, wki, jnp.asarray),
        jnp.asarray(cos), jnp.asarray(sin), HEADS, HD, interpret=True)
    norms = (_qknorm(wqt, wkt, torch.from_numpy),
             _qknorm(wqi, wki, torch.from_numpy))
    got = tmma.mmdit_double_attention(
        _t(txt, torch.bfloat16), _t(img, torch.bfloat16), *norms, _t(cos),
        _t(sin), HEADS, HD)
    plain = tmma.reference_mp_i8_double(
        _t(txt, torch.bfloat16), _t(img, torch.bfloat16),
        *(torch.from_numpy(w) for w in (wqt, wkt, wqi, wki)), _t(cos),
        _t(sin), HEADS, HD, pv=True)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)
        assert _rel(g, w) < REL_I8
    f32 = tmma.mmdit_double_attention(_t(txt), _t(img), *norms, _t(cos),
                                      _t(sin), HEADS, HD)
    exact = tmma.reference_double(
        _t(txt), _t(img), *(torch.from_numpy(w) for w in (wqt, wkt, wqi, wki)),
        _t(cos), _t(sin), HEADS, HD)
    assert all(torch.equal(a, b) for a, b in zip(f32, exact))


# ---------------------------------------------------------------------------
# off the CPU: launch or raise
# ---------------------------------------------------------------------------

def test_int8_wrappers_launch_or_raise_off_cpu(monkeypatch, int8_flags):
    """A tensor off the CPU goes to the int8 kernels and nowhere else: with
    the loaders failing, B4 and each B7 regime raise and count nothing,
    and the bf16 kernels are never reached."""
    def no_kernel(what):
        def fail():
            raise RuntimeError(f"no {what} kernel here")
        return fail

    monkeypatch.setattr(tgemm, "_lib", no_kernel("B4"))
    monkeypatch.setattr(tmma, "_lib_i8", no_kernel("B7"))
    monkeypatch.setattr(tmma, "_lib", no_kernel("bf16 attention"))
    meta = dict(device="meta", dtype=torch.bfloat16)
    w = {"w_q": torch.empty(32, 64, device="meta", dtype=torch.int8),
         "w_s": torch.empty(32, device="meta")}
    tcommon.set_int8_activations(True)
    try:
        with pytest.raises(RuntimeError, match="no B4 kernel"):
            tcommon.linear(w, torch.empty(1, 64, **meta))
    finally:
        tcommon.set_int8_activations(False)
    assert tgemm.w8a8_linear.launches == 0

    int8_flags(True, True)
    norm = {"q": {"scale": torch.ones(HD)}, "k": {"scale": torch.ones(HD)}}
    txt = torch.empty(1, 8, 3 * HEADS * HD, **meta)
    img = torch.empty(1, 16, 3 * HEADS * HD, **meta)
    cos = sin = torch.zeros(24, HD // 2)
    wrappers = (tmma.mmdit_double_attention, tmma.mmdit_single_attention)

    def counts():
        return tuple((f.launches, f.mp_launches, f.i8_launches,
                      f.i8_mp_launches) for f in wrappers)

    before = counts()
    for gate in (tmma._MAX_ONEPASS, 16):              # one pass, multi-pass
        monkeypatch.setattr(tmma, "_MAX_ONEPASS", gate)
        with pytest.raises(RuntimeError, match="no B7 kernel"):
            tmma.mmdit_double_attention(txt, img, norm, norm, cos, sin,
                                        HEADS, HD)
        with pytest.raises(RuntimeError, match="no B7 kernel"):
            tmma.mmdit_single_attention(torch.cat([txt, img], 1), norm, cos,
                                        sin, HEADS, HD)
    assert counts() == before


def test_i8_launch_layout(monkeypatch):
    """The B7 launch's padded row space (``_i8_plan``): one pass puts the
    second stream at the first 128-row tile boundary (no tile mixes two
    scales); the int8 P.V multi-pass keeps the joint sequence
    contiguous."""
    seen = []

    def entry(*args):
        seen.append(args)
        return 0

    monkeypatch.setattr(tmma, "_lib_i8", lambda: types.SimpleNamespace(
        mmdit_attention_i8=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    meta = dict(device="meta", dtype=torch.bfloat16)
    w = (torch.ones(HD), torch.ones(HD))
    txt = torch.empty(1, 41, 3 * HEADS * HD, **meta)
    img = torch.empty(1, 100, 3 * HEADS * HD, **meta)
    tab = torch.zeros(141, HD // 2)
    for mp, pv, b0, n_pad in ((False, False, 128, 256), (True, True, 41, 256)):
        tmma._launch_i8([txt, img], [w, w], tab, tab, HEADS, HD, mp, pv)
        args = seen[-1]
        assert args[3] == 41 and args[7] == 100
        assert args[23:27] == (b0, n_pad, int(mp), int(pv))


def test_fit_rejects_w8a8_mode():
    """fit() fails loudly under the serving-only W8A8 mode (round() has
    zero gradient: training would learn nothing), as the JAX fit does."""
    from domainrag_tpu_torch.train import loop

    tcommon.set_int8_activations(True)
    try:
        with pytest.raises(ValueError, match="W8A8"):
            loop.fit({}, tflux.TINY_FLUX, [], num_steps=1)
    finally:
        tcommon.set_int8_activations(False)

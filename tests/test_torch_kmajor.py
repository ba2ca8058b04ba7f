"""The port's K-major int8 weights and the W8A8 GEMM (B4) on the CPU.

The port keeps every quantized weight K-major, ``w_q`` (N, K) with K
contiguous, because the B4 kernel's ``wgmma`` reads 8-bit operands only
K-major; the JAX package keeps (K, N). Checked here without a card:

- ``models.quant.quantize_tree`` and ``bridge.params`` of a JAX-quantized
  tree give the transpose of the JAX ``w_q`` bit for bit, every other leaf
  unchanged, and the same bytes (no second copy);
- ``ops.int8_gemm.w8a8_linear`` on the CPU (its plain version on the
  K-major weights) against the JAX package's W8A8 at M 1, 17 and 640:
  the Pallas kernel in interpret mode where its gate takes the shape (M
  640), its XLA formulation, bitwise identical by the JAX package's
  contract, where it does not (M 1, 17); bitwise;
- a tiny f32 Flux ``apply`` under W8A8 on the JAX-quantized tree carried
  across, against the JAX model;
- B4's instance plan (``ops.int8_gemm.instance``) at the 27 (M, K, N) of
  the stage-3 and stage-4 int8 paths and over the shapes the kernel takes,
  and that the wrapper hands the kernel the plan's instance and the
  K-major weight (loader stubbed).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from domainrag_tpu.models import common as jcommon
from domainrag_tpu.models import quant as jquant
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.ops import int8_gemm as jgemm
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models import common as tcommon
from domainrag_tpu_torch.models import quant as tquant
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.ops import int8_gemm as tgemm

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("route", ["quantize_tree", "bridge"])
def test_kmajor_tree_is_the_jax_tree_transposed(route):
    """Both routes to a quantized port tree hold the JAX ``w_q`` transposed,
    bitwise, and every other leaf as it is."""
    params = jflux.init(jax.random.PRNGKey(3), jflux.TINY_FLUX)
    jq = jquant.quantize_tree(params, min_size=1024)
    if route == "bridge":
        port = bridge.params(jax.tree.map(np.asarray, jq), device="cpu")
    else:
        port = tquant.quantize_tree(
            bridge.params(jax.tree.map(np.asarray, params), device="cpu"),
            min_size=1024)
    want, got = _flat(jq), _flat(port)
    assert want.keys() == got.keys()
    n_q = 0
    for path, leaf in got.items():
        ref = np.asarray(want[path])
        if path[-1].key == "w_q":
            n_q += 1
            assert leaf.dtype == torch.int8 and leaf.is_contiguous(), path
            assert tuple(leaf.shape) == ref.shape[::-1], path
            np.testing.assert_array_equal(leaf.numpy(), ref.T)
        else:
            np.testing.assert_array_equal(leaf.numpy(), ref)
    assert n_q > 0
    assert tquant.quantized_bytes(port) == jquant.quantized_bytes(jq)


@pytest.fixture
def w8a8_on():
    jcommon.set_int8_activations(True)
    tcommon.set_int8_activations(True)
    try:
        yield
    finally:
        jcommon.set_int8_activations(False)
        tcommon.set_int8_activations(False)


@pytest.mark.parametrize("m", [1, 17, 640])
@pytest.mark.parametrize("dtype,with_bias", [("bfloat16", True),
                                             ("float32", False)],
                         ids=["bf16_bias", "f32"])
def test_w8a8_linear_kmajor_matches_jax(w8a8_on, m, dtype, with_bias):
    k, n = 256, 384
    rng = np.random.default_rng(m)
    p = {"w": (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)}
    if with_bias:
        p["b"] = rng.standard_normal(n).astype(np.float32)
    jp = jquant.quantize_linear(p)
    tp = bridge.params(jax.tree.map(np.asarray, jp), device="cpu")
    assert tuple(tp["w_q"].shape) == (n, k)
    x = rng.standard_normal((m, k)).astype(np.float32) * 3.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    got = tgemm.w8a8_linear(torch.from_numpy(x).to(getattr(torch, dtype)),
                            tp["w_q"], tp["w_s"], tp.get("b"))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, n)
    pallas = jgemm.w8a8_linear(jx, jp["w_q"], jp["w_s"], bias=jp.get("b"),
                               interpret=True)
    assert (pallas is None) == (not jgemm.w8a8_eligible(m, k, n))
    want = jcommon.linear(jp, jx) if pallas is None else pallas
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# Measured: 1.2e-7 in relative norm (f32 everywhere else, and the two
# W8A8 GEMMs bitwise equal on equal int8 inputs). The bar leaves room for
# an activation whose x / x_s lands on a rounding edge in one package and
# quantizes to the neighbouring integer in the other (one level in 127).
FLUX_W8A8_REL = 1e-4


def test_flux_apply_w8a8_on_kmajor_tree(w8a8_on):
    """The tiny f32 MMDiT quantized by JAX (min_size 1024 quantizes every
    block linear), carried across K-major, under W8A8 against the JAX
    model on the (K, N) tree."""
    cfg = jflux.TINY_FLUX
    params = jflux.init(jax.random.PRNGKey(7), cfg)
    jq = jquant.quantize_tree(params, min_size=1024)
    tq = bridge.params(jax.tree.map(np.asarray, jq), device="cpu")
    rng = np.random.default_rng(7)
    gh, gw, s_txt = 4, 6, 8
    img = rng.standard_normal((1, gh * gw, cfg.in_channels), np.float32)
    txt = rng.standard_normal((1, s_txt, cfg.text_dim), np.float32)
    pooled = rng.standard_normal((1, cfg.pooled_dim), np.float32)
    t, guid = np.asarray([0.6], np.float32), np.asarray([3.0], np.float32)
    img_ids, txt_ids = jflux.make_image_ids(gh, gw), jflux.make_text_ids(s_txt)
    want = np.asarray(jflux.apply(
        jq, jnp.asarray(img), jnp.asarray(txt), jnp.asarray(pooled),
        jnp.asarray(t), jnp.asarray(img_ids), jnp.asarray(txt_ids), cfg,
        guidance=jnp.asarray(guid)))
    before = tgemm.w8a8_linear.launches
    got = tflux.apply(tq, torch.from_numpy(img), torch.from_numpy(txt),
                      torch.from_numpy(pooled), torch.from_numpy(t),
                      torch.from_numpy(img_ids), torch.from_numpy(txt_ids),
                      bridge.config(cfg, tflux.FluxConfig),
                      guidance=torch.from_numpy(guid)).numpy()
    assert tgemm.w8a8_linear.launches == before      # the CPU runs no kernel
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < FLUX_W8A8_REL, rel


# ---------------------------------------------------------------------------
# the instance plan
# ---------------------------------------------------------------------------

# (M, K, N) -> instance at every quantized linear of one FLUX.1-dev forward
# at 1024 px (1241 text + 4096 image tokens) and of FLUX.1-Fill-dev at 2048
# px (16384 image tokens, 384 input channels): chip_smoke's
# _w8a8_path_shapes. The M = 1 modulation and embedder linears take the
# gemv, every other linear the wgmma instance, none the mma one.
PATH_PLAN = {
    (1, 256, 3072): "gemv", (1, 768, 3072): "gemv",
    (1, 3072, 3072): "gemv", (1, 3072, 6144): "gemv",
    (1, 3072, 9216): "gemv", (1, 3072, 18432): "gemv",
    (1241, 3072, 3072): "wgmma", (1241, 3072, 9216): "wgmma",
    (1241, 3072, 12288): "wgmma", (1241, 4096, 3072): "wgmma",
    (1241, 12288, 3072): "wgmma", (4096, 64, 3072): "wgmma",
    (4096, 3072, 64): "wgmma", (4096, 3072, 3072): "wgmma",
    (4096, 3072, 9216): "wgmma", (4096, 3072, 12288): "wgmma",
    (4096, 12288, 3072): "wgmma", (5337, 3072, 21504): "wgmma",
    (5337, 15360, 3072): "wgmma", (16384, 384, 3072): "wgmma",
    (16384, 3072, 64): "wgmma", (16384, 3072, 3072): "wgmma",
    (16384, 3072, 9216): "wgmma", (16384, 3072, 12288): "wgmma",
    (16384, 12288, 3072): "wgmma", (17625, 3072, 21504): "wgmma",
    (17625, 15360, 3072): "wgmma",
}


def test_path_shapes_take_their_instances():
    import chip_smoke
    shapes = set(chip_smoke._w8a8_path_shapes(
        tflux.FLUX_DEV, chip_smoke.S_TXT, (chip_smoke.SIZE // 16) ** 2))
    shapes |= set(chip_smoke._w8a8_path_shapes(
        tflux.FLUX_FILL_DEV, chip_smoke.S_TXT,
        (chip_smoke.FILL_SIZE // 16) ** 2))
    assert shapes == set(PATH_PLAN)
    assert {s: tgemm.instance(*s) for s in shapes} == PATH_PLAN


@pytest.mark.parametrize("shape,inst", [
    ((1000, 1000, 70), "mma"), ((17, 1000, 64), "mma"),
    ((65, 100, 70), "mma"), ((63, 384, 64), "gemv"),
    ((64, 384, 64), "wgmma"), ((640, 3072, 3072), "wgmma")])
def test_ragged_shapes_take_their_instances(shape, inst):
    assert tgemm.instance(*shape) == inst


@settings(max_examples=300, deadline=None)
@given(m=st.integers(1, 40000), k=st.integers(1, 20000),
       n=st.integers(1, 40000), aligned=st.booleans())
def test_instance_plan(m, k, n, aligned):
    """mma exactly where TMA and the 16-byte loads cannot describe the rows;
    elsewhere gemv below 64 rows (a wgmma tile's least) and wgmma above."""
    inst = tgemm.instance(m, k, n, aligned)
    assert inst in tgemm.INSTANCES
    if k % 16 or not aligned:
        assert inst == "mma"
    else:
        assert inst == ("gemv" if m < 64 else "wgmma")


STREAM = 0x7F00DEADBEEF       # a stream handle above 2^32


@pytest.mark.parametrize("m,k,n", [(1, 64, 48), (17, 100, 40),
                                   (70, 128, 24)])
def test_wrapper_hands_the_kernel_its_instance(monkeypatch, m, k, n):
    """With the loader stubbed, one ``w8a8_gemm`` call per linear, with the
    K-major weight, the shape, the plan's instance code and the stream;
    the count goes to its shape and its instance. The CPU tensors stand in
    for the card's (the stub reads nothing through the pointers)."""
    calls = []

    class Fn:
        argtypes = restype = None

        def __call__(self, *args):
            calls.append(args)
            return 0

    class Lib:
        w8a8_gemm = Fn()

    monkeypatch.setattr(tgemm, "_LIB", None)
    from domainrag_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "load", lambda name: Lib())

    class Stream:
        cuda_stream = STREAM
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    g = torch.Generator().manual_seed(m)
    x = torch.randn((m, k), generator=g)
    wq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    ws = torch.rand(n, generator=g)
    xq, xs = tgemm.quantize_rowwise(x)
    by_shape = dict(tgemm.w8a8_linear.launches_by_shape)
    out, inst = tgemm._launch(xq, wq, xs, ws, None, torch.float32)
    assert inst == tgemm.instance(m, k, n)
    assert out.shape == (m, n) and out.dtype == torch.float32
    (args,) = calls
    p, i = ctypes.c_void_p, ctypes.c_int
    assert Lib.w8a8_gemm.argtypes == [p] * 6 + [i] * 5 + [p]
    assert args[1] == wq.data_ptr() and args[4] is None
    assert args[6:] == (m, n, k, 1, tgemm.INSTANCES.index(inst), STREAM)
    assert tgemm.w8a8_linear.launches_by_shape == by_shape   # _launch only
    with pytest.raises(ValueError, match="K-major"):
        tgemm._launch(xq, wq.t().contiguous(), xs, ws, None, torch.float32)

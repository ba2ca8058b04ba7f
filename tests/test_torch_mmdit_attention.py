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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.ops import mmdit_attention as jmma
from domainrag_tpu_torch.ops import mmdit_attention as tmma

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

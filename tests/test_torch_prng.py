"""The port's threefry PRNG (``domainrag_tpu_torch.core.prng``) against
``jax.random`` on the CPU, from the same seeds.

Keys, splits, bits, uniforms, randint, permutation and choice are equal
to JAX's. f32 normals are within 4 ulp and 1e-6 of JAX's (XLA's erf_inv
polynomial, op for op; its log1p may differ by an ulp or two); bf16
normals are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu_torch.core import prng

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 123, 2 ** 31 - 1, -5]
# seeds JAX (64-bit types off) takes modulo 2^32
WIDE_SEEDS = [2 ** 31, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 2 ** 40, -1,
              -2 ** 31 - 1, 2 ** 63 - 1, -2 ** 63]
SHAPES = [(), (1,), (7,), (4096, 64), (2, 4608, 64)]
F32_ULP, F32_ABS = 4, 1e-6
UINT = {8: jnp.uint8, 16: jnp.uint16, 32: jnp.uint32}


def _np(x):
    return np.asarray(x).astype(np.int64)


def _ordered(a):
    """f32 bit patterns as integers in the floats' order (ulp steps)."""
    i = a.astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def test_jax_threefry_is_partitionable():
    """The port computes the partitionable threefry (fold-like split,
    bits over the 64-bit counter): a JAX whose default changes fails
    here first."""
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS + WIDE_SEEDS)
def test_prng_key_matches_jax(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2,)
    np.testing.assert_array_equal(got.numpy(), _np(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(prng.PRNGKey(np.int64(seed)).numpy(),
                                  _np(jax.random.PRNGKey(np.int64(seed))))


@pytest.mark.parametrize("seed,error", [(2 ** 63, OverflowError),
                                        (-2 ** 63 - 1, OverflowError),
                                        (1.5, TypeError),
                                        (np.arange(2), TypeError)])
def test_prng_key_refuses_what_jax_refuses(seed, error):
    with pytest.raises(error):
        jax.random.PRNGKey(seed)
    with pytest.raises(error):
        prng.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 6, (2, 3)])
def test_split_matches_jax(seed, num):
    got = prng.split(prng.PRNGKey(seed), num)
    want = _np(jax.random.split(jax.random.PRNGKey(seed), num))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a chain of splits, as the training loop walks its key
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for _ in range(3):
        key, sub = prng.split(key)
        jkey, jsub = jax.random.split(jkey)
    np.testing.assert_array_equal(sub.numpy(), _np(jsub))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_draws_match_jax(seed, shape):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for width in (8, 16, 32):
        np.testing.assert_array_equal(
            prng.bits(key, shape, width).numpy(),
            _np(jax.random.bits(jkey, shape, UINT[width])))
    got = prng.uniform(key, shape).numpy()
    want = np.asarray(jax.random.uniform(jkey, shape))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got = prng.uniform(key, shape, torch.bfloat16, -2.0, 3.0).float()
    want = np.asarray(jax.random.uniform(jkey, shape, jnp.bfloat16, -2.0,
                                         3.0), np.float32)
    np.testing.assert_array_equal(got.numpy(), want)

    got = prng.normal(key, shape).numpy()
    want = np.asarray(jax.random.normal(jkey, shape, jnp.float32))
    assert got.shape == want.shape and got.dtype == np.float32
    if got.size:
        assert np.abs(_ordered(got) - _ordered(want)).max() <= F32_ULP
        assert np.abs(got - want).max() <= F32_ABS
    got = prng.normal(key, shape, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jax.random.normal(jkey, shape, jnp.bfloat16), np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed):
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    for shape, lo, hi in [((), 0, 10), ((7,), 0, 1), ((4096, 64), 0, 5000),
                          ((37,), -5, 3), ((9,), 3, 3), ((9,), 10, 2),
                          ((33,), -2 ** 31, 2 ** 31 - 1), ((5,), 0, 2 ** 30)]:
        got = prng.randint(key, shape, lo, hi)
        want = np.asarray(jax.random.randint(jkey, shape, lo, hi))
        assert got.dtype == torch.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 5, 100, 1700, 5000])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_and_choice_match_jax(seed, n):
    """Below 1626 items JAX's shuffle sorts once, above twice."""
    key, jkey = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(prng.permutation(key, n).numpy(),
                                  np.asarray(jax.random.permutation(jkey, n)))
    for shape, replace in [((9,), True), ((min(n, 4),), False),
                           ((n,), False), ((2, 3), True), ((), True)]:
        got = prng.choice(key, n, shape, replace=replace)
        want = np.asarray(jax.random.choice(jkey, n, shape, replace=replace))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_choice_refuses_what_jax_refuses():
    key, jkey = prng.PRNGKey(0), jax.random.PRNGKey(0)
    for args in [(3, (4,), False), (0, (2,), True)]:
        with pytest.raises(ValueError):
            jax.random.choice(jkey, args[0], args[1], replace=args[2])
        with pytest.raises(ValueError):
            prng.choice(key, args[0], args[1], replace=args[2])
    assert tuple(prng.choice(key, 3, (0,)).shape) == (0,)


@pytest.mark.parametrize("fn", ["split", "bits", "uniform", "normal",
                                "permutation"])
def test_a_generator_is_not_a_key(fn):
    bad = torch.Generator().manual_seed(0)
    args = {"permutation": (5,)}.get(fn, ())
    with pytest.raises(TypeError, match="prng.PRNGKey"):
        getattr(prng, fn)(bad, *args)
    with pytest.raises(TypeError, match="prng.PRNGKey"):
        getattr(prng, fn)(torch.zeros(2, dtype=torch.int32), *args)


def test_key_device_is_where_the_draws_are():
    key = prng.PRNGKey(3, device="cpu")
    assert key.device.type == "cpu"
    assert prng.normal(key, (4,)).device.type == "cpu"
    assert prng.split(key).device.type == "cpu"

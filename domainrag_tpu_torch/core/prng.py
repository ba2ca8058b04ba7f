"""JAX's default PRNG in torch: threefry2x32, as ``jax.random`` draws it.

The JAX package draws every run-time random value (the denoise noise per
sample seed, the calibration probes, the VAE posterior sample, the
trainer's t, eps and image picks) through ``jax.random`` with its default
implementation, threefry2x32, in its partitionable form
(``jax_threefry_partitionable``, on by default). This module computes the
same values from the same seed or key, so a seed means the same noise in
the port as in the JAX package. It is the port's only source of random
values: the run-time draws and the random parameter inits
(``models.common.normal_init``, ``linear_init``, ``conv_init`` and every
model's ``init``) alike.

A key is a ``(2,)`` int64 tensor holding two uint32 words, on the device
its draws are made on (:func:`PRNGKey`, :func:`split`). Every uint32 lane
is an int64 holding a value in [0, 2^32), masked back after each add and
shift: torch's own uint32 has too few operations.

- :func:`bits` is ``bits1 ^ bits2`` of the hash of the 64-bit counter
  split into (hi, lo) words, truncated to 16 or 8 bits;
- :func:`uniform` sets the top mantissa bits of 1.0 (8 random bits for
  bf16, as JAX's ``_uniform`` takes for fewer than 8 mantissa bits);
- :func:`normal` is ``sqrt(2) * erf_inv(u)`` with u uniform in
  (-1, 1), erf_inv being XLA's single-precision polynomial (bf16 is
  computed in f32 and rounded);
- :func:`randint`, :func:`permutation` and :func:`choice` are JAX's
  modulus draw, its sort-based shuffle and its choice without weights.

The integers and uniforms are equal to JAX's on every device. The
normals differ from XLA's by the ulp or two its ``log1p`` may differ
by (``tests/test_torch_prng.py``), and are the same bits on the card as
on the CPU (:func:`_erf_inv_f32`). A draw of more elements than its
device's :data:`CHUNK` is made in flat chunks of the counter (chunk
[a, b) hashes ``arange(a, b)``, so the bits are the same), which bounds
its int64 temporaries.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_INT32 = (-2 ** 31, 2 ** 31 - 1)
# the most elements one pass of a draw hashes: 2^25 int64 counters are
# 268 MB a temporary on the card; on the CPU 2^20 (8 MB) keep a pass's
# temporaries near the caches, which draws ~3x faster there
CHUNK = {"cpu": 1 << 20}
CHUNK_DEFAULT = 1 << 25

Shape = Union[int, Sequence[int]]

# XLA's f32 erf_inv (Giles): w = -log1p(-x^2), one polynomial in w - 2.5
# below 5, another in sqrt(w) - 3 above
_ERF_INV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def check_key(key, name: str) -> torch.Tensor:
    """``key`` itself when it is a key of :func:`PRNGKey` or
    :func:`split`, else a ``TypeError`` naming ``name``."""
    if not (isinstance(key, torch.Tensor) and key.dtype == torch.int64
            and tuple(key.shape) == (2,)):
        raise TypeError(
            f"{name} takes a PRNG key (prng.PRNGKey(seed) or a row of "
            f"prng.split), as the JAX package does; got "
            f"{type(key).__name__}"
            + (f" {tuple(key.shape)} {key.dtype}"
               if isinstance(key, torch.Tensor) else ""))
    return key


def PRNGKey(seed, *, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the key (0,
    seed mod 2^32) for an integer seed in [-2^63, 2^63), on ``device``
    (the CPU by default). Other integers overflow and non-integers raise,
    as in JAX."""
    if isinstance(seed, (torch.Tensor, np.ndarray)):
        if seed.ndim:
            raise TypeError(f"PRNGKey takes a scalar seed; got an array "
                            f"of shape {tuple(seed.shape)}")
        seed = seed.item()
    if isinstance(seed, (bool, np.bool_)) or not isinstance(
            seed, (int, np.integer)):
        raise TypeError(f"PRNGKey takes an integer seed; got {seed!r}")
    if isinstance(seed, int) and not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) \
        else tuple(int(s) for s in shape)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return (x << d).bitwise_and_(MASK).bitwise_or_(x >> (32 - d))


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) of the counter words (x0, x1)
    under ``key``: two int64 tensors of uint32 values (in place on new
    tensors; the inputs are kept)."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def _counters(shape: Tuple[int, ...], device) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """``iota_2x32_shape``: the flat index of each element as (hi, lo)
    uint32 words."""
    n = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=device).reshape(shape)
    return n >> 32, n & MASK


def _flat(draw, key: torch.Tensor, shape: Tuple[int, ...],
          dtype: torch.dtype) -> torch.Tensor:
    """``draw(key, a, b)`` (the draw of the flat elements [a, b)) over the
    whole of ``shape``: in one pass up to the device's :data:`CHUNK`
    elements, else chunk by chunk into one output. On the meta device a
    draw is its shape alone."""
    n = math.prod(shape)
    if key.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=key.device)
    chunk = CHUNK.get(key.device.type, CHUNK_DEFAULT)
    if n <= chunk:
        return draw(key, 0, n).reshape(shape)
    out = torch.empty(n, dtype=dtype, device=key.device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        out[a:b] = draw(key, a, b)
    return out.reshape(shape)


def _bits_range(key: torch.Tensor, a: int, b: int, width: int
                ) -> torch.Tensor:
    """The bits of the flat elements [a, b) of a draw."""
    n = torch.arange(a, b, dtype=torch.int64, device=key.device)
    b0, b1 = threefry2x32(key, n >> 32, n & MASK)
    out = b0.bitwise_xor_(b1)
    return out if width == 32 else out.bitwise_and_((1 << width) - 1)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` keys (an int or a shape) as rows of a
    ``(*num, 2)`` tensor, the hash of the counters 0 .. num - 1 under
    ``key``."""
    key = check_key(key, "split")
    if key.device.type == "meta":
        return torch.empty(_shape(num) + (2,), dtype=torch.int64,
                           device=key.device)
    hi, lo = _counters(_shape(num), key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return torch.stack([b0, b1], dim=-1)


def bits(key: torch.Tensor, shape: Shape = (), width: int = 32
         ) -> torch.Tensor:
    """``jax.random.bits`` of ``width`` (8, 16 or 32) bits: int64 values
    in [0, 2^width)."""
    key = check_key(key, "bits")
    if width not in (8, 16, 32):
        raise TypeError(f"bits draws 8, 16 or 32 bits, not {width}")
    return _flat(lambda k, a, b: _bits_range(k, a, b, width), key,
                 _shape(shape), torch.int64)


_FLOAT = {torch.float32: (32, 23, torch.int32, 0x3F800000),
          torch.bfloat16: (16, 7, torch.int16, 0x3F80)}


def _float_info(dtype: torch.dtype):
    if dtype not in _FLOAT:
        raise TypeError(f"draws float32 or bfloat16, not {dtype}")
    return _FLOAT[dtype]


def _uniform_range(key: torch.Tensor, a: int, b: int, dtype: torch.dtype,
                   minval: float, maxval: float) -> torch.Tensor:
    """The uniforms of the flat elements [a, b) of a draw."""
    nbits, nmant, view, one = _float_info(dtype)
    rng_bits = 8 if nmant < 8 else nbits
    r = _bits_range(key, a, b, rng_bits)
    mant = (r >> (rng_bits - nmant)).bitwise_or_(one)
    floats = mant.to(view).view(dtype) - torch.ones((), dtype=dtype)
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: Shape = (),
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in [minval, maxval) on the key's device."""
    key = check_key(key, "uniform")
    _float_info(dtype)
    return _flat(lambda k, a, b: _uniform_range(k, a, b, dtype, minval,
                                                maxval),
                 key, _shape(shape), dtype)


def _erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv, op for op (no fused multiply-adds). Its
    ``log1p`` and square root are taken in f64 and rounded: the correctly
    rounded f32 values (a square root always; a ``log1p`` but where the
    f64 result lies within its own error of an f32 rounding edge), which
    torch's f32 kernels on the CPU do not always give; every other op is
    an IEEE f32 add or multiply. So the card draws the CPU's normals."""
    w = -torch.log1p((-(x * x)).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coeff = [torch.where(lt, torch.tensor(a, dtype=torch.float32,
                                          device=x.device),
                         torch.tensor(b, dtype=torch.float32,
                                      device=x.device))
             for a, b in zip(_ERF_INV_LO, _ERF_INV_HI)]
    p = coeff[0]
    for c in coeff[1:]:
        p = c + p * w
    big = x * torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1.0, big, p * x)


def _normal_range(key: torch.Tensor, a: int, b: int, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The normals of the flat elements [a, b) of a draw."""
    minus_one = torch.tensor(-1.0, dtype=dtype)
    lo = float(torch.nextafter(minus_one, torch.zeros((), dtype=dtype)))
    u = _uniform_range(key, a, b, dtype, lo, 1.0)
    e = _erf_inv_f32(u.float()).to(dtype)
    return e * torch.tensor(math.sqrt(2), dtype=dtype, device=key.device)


def normal(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)``, u uniform in
    [nextafter(-1, 0), 1) in ``dtype``; erf_inv in f32, rounded to
    ``dtype``."""
    key = check_key(key, "normal")
    _float_info(dtype)
    return _flat(lambda k, a, b: _normal_range(k, a, b, dtype), key,
                 _shape(shape), dtype)


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint`` in [minval, maxval) in JAX's default int32:
    two 32-bit draws from ``split(key)`` reduced modulo the span as JAX
    does (its small bias for spans that are not powers of two
    included)."""
    key = check_key(key, "randint")
    shape = _shape(shape)
    out_of_range = maxval > _INT32[1]
    minval = min(max(int(minval), _INT32[0]), _INT32[1])
    maxval = min(max(int(maxval), _INT32[0]), _INT32[1])
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & MASK
    if maxval <= minval:
        span = 1
    elif out_of_range:
        span = (span + 1) & MASK

    def rem(x):
        # XLA's unsigned remainder by zero is x
        return x if span == 0 else x % span

    multiplier = rem(rem(2 ** 16) * rem(2 ** 16) & MASK)
    offset = rem((rem(higher) * multiplier + rem(lower)) & MASK)
    out = (minval + offset) & MASK
    return torch.where(out > _INT32[1], out - 2 ** 32, out).to(torch.int32)


def _shuffle_rounds(n: int) -> int:
    """JAX's ``_shuffle`` rounds: enough 32-bit sort keys that ties are
    unlikely."""
    return int(np.ceil(3 * np.log(max(1, n))
                       / np.log(np.iinfo(np.uint32).max)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int32) shuffled
    by stable sorts on fresh 32-bit keys."""
    key = check_key(key, "permutation")
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    for _ in range(_shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = (),
           replace: bool = True) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` without weights:
    ``shape`` picks of ``arange(n)`` (int32), with replacement by
    :func:`randint`, without by the head of :func:`permutation`."""
    key = check_key(key, "choice")
    shape = _shape(shape)
    n_draws = math.prod(shape)
    if n_draws == 0:
        return torch.zeros(shape, dtype=torch.int32, device=key.device)
    if n <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if not replace and n_draws > n:
        raise ValueError(f"Cannot take a larger sample (size {n_draws}) "
                         f"than population (size {n}) when "
                         f"'replace=False'")
    if replace:
        return randint(key, shape, 0, n)
    return permutation(key, n)[:n_draws].reshape(shape)

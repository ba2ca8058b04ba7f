"""The fused MMDiT kernels' padded row space, held on the CPU.

The bf16 kernels behind B1-B3 (``csrc/mmdit_attention.cu``) write the
normed, roped q and k into (B, H, n_pad, 128) scratch with stream b from
b0, the first 128-row boundary after stream a (``_i8_plan(s_a, s_b,
False, False)``), read V in place per stream, and mask every 128-key
tile by its count of real keys (the front-end's ``valid(t)``: the stream
gap and the tail hold zero rows, whose scores are 0, not -inf). Here
that scheme runs as a plain PyTorch function, with the kernels' rounding
(one pass: q times log2(e)/sqrt(128) before its round; multi-pass: q
rounded unscaled, the f32 scores scaled), and is held, for the double and
the single block in both regimes, to:

- the unpadded plain version of its regime (``reference_double`` /
  ``reference_single``, ``reference_mp_double`` / ``reference_mp_single``)
  in f32 at atol = rtol = 1e-5 (the roundings agree to f32 precision and
  the masked keys add exact zeros; only summation order differs);
- the JAX package's fused kernels with ``interpret=True`` on the same
  numpy inputs (``_fused_double_impl`` / ``_fused_single_impl``, one pass,
  and ``_fused_double_mp`` / ``_fused_single_mp`` with ``bq=64``, the
  multi-pass kernel over several K/V passes, as the JAX package's own
  tests run them), in bf16 at atol = rtol = 0.05, the tolerance of
  tests/test_torch_mmdit_attention.py (the multi-pass kernel streams with
  an online max; in bf16 both round P);
- and, unmasked, it fails: with the gap's or the tail's keys counted the
  same inputs land far off (the fault the mask guards against).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.ops import mmdit_attention as jmma
from domainrag_tpu_torch.ops import mmdit_attention as tmma

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

HEADS, HD = 2, 128
TILE = 128
PRESCALE = tmma.LOG2_E / math.sqrt(HD)


def _valid(t, s_a, s_b, b0):
    """Real keys at the start of tile t (the kernels' ``valid``)."""
    key0 = t * TILE
    n = s_a - key0 if key0 < b0 else b0 + s_b - key0
    return max(0, min(TILE, n))


def padded_attention(streams, norms, cos, sin, multipass, masked=True):
    """The fused bf16 kernels' computation in their padded row space:
    streams (B, S_i, >= 3*H*128), norms [(wq, wk)] per stream; returns one
    (B, S_i, H*128) output per stream in the streams' dtype."""
    lens = [x.shape[1] for x in streams]
    s_a, s_b = lens[0], (lens[1] if len(lens) == 2 else 0)
    b0, n_pad = tmma._i8_plan(s_a, s_b, False, False)
    b, dt, hd = streams[0].shape[0], streams[0].dtype, HEADS * HD
    q = torch.zeros((b, n_pad, HEADS, HD), dtype=dt)
    k = torch.zeros_like(q)
    v = torch.zeros((b, n_pad, hd), dtype=dt)
    for x, (wq, wk), r0, p0 in zip(streams, norms, (0, b0), (0, s_a)):
        n = x.shape[1]
        c, s = cos[p0:p0 + n], sin[p0:p0 + n]
        qf = tmma._norm_rope_f32(x[..., :hd], wq, c, s, HEADS, HD)
        q[:, r0:r0 + n] = (qf if multipass else qf * PRESCALE).to(dt)
        k[:, r0:r0 + n] = tmma._norm_rope_f32(x[..., hd:2 * hd], wk, c, s,
                                              HEADS, HD).to(dt)
        v[:, r0:r0 + n] = x[..., 2 * hd:3 * hd]
    keep = torch.zeros(n_pad, dtype=torch.bool)
    for t in range(n_pad // TILE):
        nv = _valid(t, s_a, s_b, b0) if masked else TILE
        keep[t * TILE:t * TILE + nv] = True
    out = torch.empty((b, n_pad, hd), dtype=dt)
    for bi in range(b):
        for h in range(HEADS):
            lanes = slice(h * HD, (h + 1) * HD)
            sc = torch.matmul(q[bi, :, h].float(), k[bi, :, h].float().T)
            if multipass:
                sc = sc * PRESCALE
            sc = sc.masked_fill(~keep, float("-inf"))
            p = torch.exp2(sc - sc.amax(-1, keepdim=True))
            p = p.masked_fill(~keep, 0.0)
            o = torch.matmul(p.to(dt).float(), v[bi, :, lanes].float())
            out[bi, :, lanes] = (o / p.sum(-1, keepdim=True).clamp_min(1e-30)
                                 ).to(dt)
    return [out[:, r0:r0 + n] for r0, n in zip((0, b0), lens)]


def _inputs(seed, batch, lens, width):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((batch, n, width)).astype(np.float32)
          for n in lens]
    ang = rng.uniform(-np.pi, np.pi, size=(sum(lens), HD // 2))
    norms = [tuple(rng.uniform(0.5, 1.5, size=(HD,)).astype(np.float32)
                   for _ in range(2)) for _ in lens]
    return xs, np.cos(ang).astype(np.float32), \
        np.sin(ang).astype(np.float32), norms


def _torch(xs, cos, sin, norms, dtype):
    return ([torch.from_numpy(x).to(dtype) for x in xs],
            torch.from_numpy(cos), torch.from_numpy(sin),
            [tuple(torch.from_numpy(w) for w in pair) for pair in norms])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# (batch, stream lengths): the txt stream at, under and over a tile edge
# and ragged (stream b from b0 = 128 or 256), and a ragged single stream
DOUBLE = [(1, (127, 129)), (2, (128, 64)), (1, (129, 200)), (2, (40, 88))]
SINGLE = [(2, (130,)), (1, (257,)), (1, (96,))]
REGIMES = pytest.mark.parametrize("multipass", [False, True],
                                  ids=["onepass", "mp"])


def _plain(xs, cos, sin, norms, multipass):
    if len(xs) == 2:
        fn = tmma.reference_mp_double if multipass else tmma.reference_double
        return fn(*xs, *norms[0], *norms[1], cos, sin, HEADS, HD)
    fn = tmma.reference_mp_single if multipass else tmma.reference_single
    return [fn(xs[0], *norms[0], cos, sin, HEADS, HD)]


def _jax(xs, cos, sin, norms, multipass):
    j = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    w = [jnp.asarray(a) for pair in norms for a in pair]
    c, s = jnp.asarray(cos), jnp.asarray(sin)
    if len(xs) == 2:
        if multipass:
            return jmma._fused_double_mp(*j, *w, c, s, heads=HEADS,
                                         interpret=True, qkv3=False, bq=64)
        return jmma._fused_double_impl(*j, *w, c, s, heads=HEADS,
                                       interpret=True)
    if multipass:
        return [jmma._fused_single_mp(*j, *w, c, s, heads=HEADS,
                                      interpret=True, qkv3=False, bq=64)]
    return [jmma._fused_single_impl(*j, *w, c, s, heads=HEADS,
                                    interpret=True)]


@REGIMES
@pytest.mark.parametrize("batch,lens", DOUBLE + SINGLE,
                         ids=[f"{'x'.join(map(str, l))}_b{b}"
                              for b, l in DOUBLE + SINGLE])
def test_padded_equals_unpadded_plain_f32(batch, lens, multipass):
    width = (3 if len(lens) == 2 else 7) * HEADS * HD
    xs, cos, sin, norms = _torch(*_inputs(sum(lens), batch, lens, width),
                                 torch.float32)
    got = padded_attention(xs, norms, cos, sin, multipass)
    for g, w in zip(got, _plain(xs, cos, sin, norms, multipass)):
        assert g.shape == w.shape
        _close(g, w, 1e-5)


@REGIMES
@pytest.mark.parametrize("batch,lens", DOUBLE + SINGLE,
                         ids=[f"{'x'.join(map(str, l))}_b{b}"
                              for b, l in DOUBLE + SINGLE])
def test_padded_matches_jax_fused_bf16(batch, lens, multipass):
    width = (3 if len(lens) == 2 else 7) * HEADS * HD
    arrays = _inputs(100 + sum(lens), batch, lens, width)
    xs, cos, sin, norms = _torch(*arrays, torch.bfloat16)
    got = padded_attention(xs, norms, cos, sin, multipass)
    want = _jax(*arrays, multipass)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        _close(g.float(), w, 0.05)


@pytest.mark.parametrize("batch,lens", [(1, (127, 129)), (1, (130,))],
                         ids=["double_127x129", "single_130"])
def test_unmasked_gap_is_caught(batch, lens):
    """Counting the gap's (or the tail's) zero keys moves the output far
    outside the tolerance above: the mask is what makes the padded space
    exact."""
    width = (3 if len(lens) == 2 else 7) * HEADS * HD
    xs, cos, sin, norms = _torch(*_inputs(7, batch, lens, width),
                                 torch.float32)
    want = _plain(xs, cos, sin, norms, False)
    bad = padded_attention(xs, norms, cos, sin, False, masked=False)
    err = max((g - w).abs().max().item() for g, w in zip(bad, want))
    assert err > 1e-2, err

"""The port's generic flash attention (domainrag_tpu_torch.ops.attention)
against the JAX package's ``ops/attention.py``, on the same numpy inputs.

On the CPU the port runs the plain versions of its kernels
(``flash_forward_reference`` for B5, ``flash_backward_reference`` for
B6), which the CUDA kernels are held to on the card
(tests/test_torch_cuda.py, chip_smoke.py). Here they are held to the JAX
Pallas kernels run in interpret mode, as tests/test_attention.py runs
them:

- f32 forward and LSE at rtol = atol = 2e-5 (that file's bar; same
  algorithm, another summation order), against both the one-pass kernel
  (default blocks) and the streaming one (small explicit blocks);
- bf16 forward against the one-pass kernel at 1e-2 (one bf16 ulp of the
  output: both round q after the prescale and P before P.V against the
  exact row max);
- the backward against ``jax.grad`` through ``flash_attention`` at
  rtol 2e-4, atol 2e-5 in f32 (tests/test_attention.py's bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.ops import attention as jattn
from domainrag_tpu_torch.ops import attention as tattn


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, h, skv, d), (b, h, skv, d),
                          (b, h, sq, d))]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _launches():
    f = tattn.flash_attention
    return f.launches, f.bwd_launches, f.bwd_f32_launches


FWD_CASES = [     # sq, skv, d, causal, blocks (None: the one-pass policy)
    (128, 128, 128, False, None),
    (100, 200, 64, False, (64, 128)),       # ragged, streaming KV
    (96, 96, 64, True, (32, 128)),          # causal
    (77, 77, 16, True, None),               # causal, ragged, D = 16
    (64, 640, 32, False, (64, 256)),        # long KV, small D
]


@pytest.mark.parametrize("sq,skv,d,causal,blocks", FWD_CASES)
def test_plain_forward_matches_pallas_f32(sq, skv, d, causal, blocks):
    q, k, v, _ = _qkv(0, 1, 2, sq, skv, d)
    kw = {} if blocks is None else dict(block_q=blocks[0],
                                        block_kv=blocks[1])
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal,
                                 interpret=True, **kw)
    before = _launches()
    out, lse = tattn.flash_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal)
    assert _launches() == before              # the CPU runs no kernel
    assert torch.equal(got, out)
    assert out.dtype == torch.float32 and lse.shape == (1, 2, sq)
    _close(out, want, 2e-5)


@pytest.mark.parametrize("valid", ["full", "ragged", "one"])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_plain_lse_matches_pallas(valid, d):
    """flash_attention_lse with a runtime kv_valid, against JAX's (out and
    natural-log LSE, (B, H, Sq, 1))."""
    q, k, v, _ = _qkv(1, 2, 3, 40, 56, d)
    kv_valid = {"full": 56, "ragged": 29, "one": 1}[valid]
    want_o, want_l = jattn.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid=jnp.int32(kv_valid), block_q=16, block_kv=128,
        interpret=True)
    got_o, got_l = tattn.flash_attention_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_valid=kv_valid)
    assert tuple(got_l.shape) == want_l.shape == (2, 3, 40, 1)
    _close(got_o, want_o, 2e-5)
    _close(got_l, want_l, 2e-5)
    # and the LSE is that of the valid prefix
    dense = torch.logsumexp(
        torch.from_numpy(q) @ torch.from_numpy(k[:, :, :kv_valid])
        .transpose(-1, -2) / np.sqrt(d), -1, keepdim=True)
    _close(got_l, dense, 1e-4)


@pytest.mark.parametrize("sq,skv,d,causal", [
    (128, 128, 64, False), (100, 130, 128, False), (64, 64, 16, True)])
def test_plain_forward_matches_pallas_bf16(sq, skv, d, causal):
    q, k, v, _ = _qkv(2, 1, 2, sq, skv, d)
    want = jattn.flash_attention(*(jnp.asarray(x, jnp.bfloat16)
                                   for x in (q, k, v)), causal=causal,
                                 interpret=True)
    out, lse = tattn.flash_forward_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)), causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out.float(), want, 1e-2)


BWD_CASES = [     # sq, skv, d, causal, blocks of the JAX kernels
    (64, 64, 32, False, (64, 64)),
    (96, 160, 64, False, (32, 128)),         # multi-block, ragged
    (64, 64, 16, True, (32, 64)),            # causal, D = 16
    (100, 100, 128, True, (64, 128)),        # causal, ragged, D = 128
]


@pytest.mark.parametrize("sq,skv,d,causal,blocks", BWD_CASES)
def test_plain_backward_matches_jax_grad(sq, skv, d, causal, blocks):
    q, k, v, dout = _qkv(3, 1, 2, sq, skv, d)

    def loss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal,
                                    block_q=blocks[0], block_kv=blocks[1],
                                    interpret=True)
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = tattn.flash_forward_reference(tq, tk, tv, causal)
    got = tattn.flash_backward_reference(tq, tk, tv, out, lse, tdo, causal)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5, err_msg=f"d{name}")
    # the autograd Function runs the same backward on the CPU
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    before = _launches()
    tattn.flash_attention(*leaves, causal=causal).backward(tdo)
    assert _launches() == before
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_plain_backward_kv_valid_masks_the_tail():
    """With kv_valid the masked kv rows get zero dk/dv, and the valid part
    equals the backward over the valid prefix alone."""
    q, k, v, dout = (torch.from_numpy(x) for x in _qkv(4, 1, 2, 30, 50, 32))
    out, lse = tattn.flash_forward_reference(q, k, v, kv_valid=21)
    dq, dk, dv = tattn.flash_backward_reference(q, k, v, out, lse, dout,
                                                kv_valid=21)
    assert not dk[:, :, 21:].any() and not dv[:, :, 21:].any()
    o2, l2 = tattn.flash_forward_reference(q, k[:, :, :21], v[:, :, :21])
    want = tattn.flash_backward_reference(q, k[:, :, :21], v[:, :, :21], o2,
                                          l2, dout)
    for g, w in zip((dq, dk[:, :, :21], dv[:, :, :21]), want):
        _close(g, w, 1e-6)


def test_plain_versions_block_q_rows(monkeypatch):
    """The plain versions give the same result whatever the block of q
    rows they work in."""
    q, k, v, dout = (torch.from_numpy(x) for x in _qkv(5, 2, 2, 45, 45, 16))
    whole = tattn.flash_forward_reference(q, k, v, True)
    grads = tattn.flash_backward_reference(q, k, v, *whole, dout, True)
    monkeypatch.setattr(tattn, "_ROWS", 7)
    blocked = tattn.flash_forward_reference(q, k, v, True)
    for a, b in zip(whole, blocked):
        _close(a, b, 1e-6)
    for a, b in zip(grads, tattn.flash_backward_reference(q, k, v, *blocked,
                                                          dout, True)):
        _close(a, b, 1e-6)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

def test_dispatch_reference_on_cpu():
    q, k, v, _ = _qkv(6, 1, 1, 16, 16, 32)
    for causal in (False, True):
        want = jattn.attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
        before = _launches()
        got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=causal)
        assert _launches() == before
        assert torch.equal(got, tattn.attention_reference(
            *(torch.from_numpy(x) for x in (q, k, v)), causal=causal))
        _close(got, want, 1e-5)


def test_masked_dispatch_matches_jax():
    q, k, v, _ = _qkv(7, 1, 2, 8, 8, 16)
    mask = np.tril(np.ones((1, 1, 8, 8), bool))
    mask[..., 0, :] = True
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask=jnp.asarray(mask))
    got = tattn.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          mask=torch.from_numpy(mask))
    _close(got, want, 1e-5)


def test_dense_context_and_force_reference_take_the_dense_path(monkeypatch):
    """Off the CPU the dispatcher goes to the kernels, except with a mask,
    ``force_reference`` or inside ``dense_attention()``."""
    def no_kernel(*_a, **_k):
        raise RuntimeError("kernel path")

    monkeypatch.setattr(tattn, "flash_attention", no_kernel)
    q = torch.empty(1, 1, 8, 16, device="meta")
    with pytest.raises(RuntimeError, match="kernel path"):
        tattn.attention(q, q, q)
    for call in (lambda: tattn.attention(q, q, q, force_reference=True),
                 lambda: tattn.attention(q, q, q, mask=torch.ones(
                     8, 8, dtype=torch.bool, device="meta"))):
        assert call().shape == q.shape
    with tattn.dense_attention():
        assert tattn.forced_dense()
        assert tattn.attention(q, q, q).shape == q.shape
    assert not tattn.forced_dense()


def test_kernel_wrappers_check_inputs(monkeypatch):
    monkeypatch.setattr(tattn, "_lib", lambda: pytest.fail("launched"))
    meta = dict(device="meta")
    q = torch.empty(1, 2, 8, 64, dtype=torch.float16, **meta)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tattn._kernel_forward(q, q, q, False, None)
    q = torch.empty(1, 2, 8, 192, **meta)
    with pytest.raises(ValueError, match="D <= 128"):
        tattn._kernel_forward(q, q, q, False, None)
    q = torch.empty(1, 2, 8, 64, **meta)
    with pytest.raises(ValueError, match="kv_valid"):
        tattn._kernel_forward(q, q, q, False, 0)
    with pytest.raises(ValueError, match="differ"):
        tattn._kernel_forward(q, q.to(torch.bfloat16), q, False, None)

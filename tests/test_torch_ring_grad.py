"""The ring's gradient in one process, and the differentiable
partial-softmax form it is made of (``ops.attention.flash_attention_lse``),
on the CPU.

- The gradients of sum(ring(q, k, v)^2) on a one-rank mesh against JAX's
  ``jax.grad`` of its ring on the 8-device mesh and of dense attention,
  at JAX's rtol 2e-4 / atol 2e-5 (``tests/test_ring_attention.py:36-55``);
  the 4-rank group is ``test_torch_scaleout_train.py``'s.
- ``flash_backward_reference(..., dlse=)``, B6's plain version with a
  gradient on the LSE, and ``flash_attention_lse``'s backward, against
  autograd of the dense block fold ``_dense_block_lse`` within 1e-5 (f32;
  the same sums in another order).
- On a card's path (the block kernels' route forced, the kernel library
  stubbed as ``test_torch_flash_launch.py`` stubs it) the ring's backward
  launches B6 once per block of the fold with the block's ``kv_valid``
  and its delta less dlse, and a failed B6 raises: nothing falls back to
  the dense fold.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scaleout_driver as drv
from domainrag_tpu.ops import attention as jattn
from domainrag_tpu.ops import ring_attention as jring
from domainrag_tpu.parallel import mesh as jmesh
from domainrag_tpu_torch.ops import _build
from domainrag_tpu_torch.ops import attention as tattn
from domainrag_tpu_torch.ops import ring_attention as tring
from domainrag_tpu_torch.parallel import mesh as tmesh

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


def _loss_grads(fn, xs):
    return jax.grad(lambda q, k, v: jnp.sum(jnp.square(fn(q, k, v))),
                    argnums=(0, 1, 2))(*xs)


@pytest.mark.parametrize("case", drv.RING_GRAD_CASES[:2],
                         ids=lambda c: c[0])
def test_one_rank_ring_grads_match_jax(case):
    name, shape, _, fn = case
    xs = drv.qkv(*drv.RING_GRAD_SEEDS[name], shape)
    mesh8 = jmesh.create_mesh(model_parallel=1)
    want_ring = _loss_grads(lambda q, k, v: getattr(jring, fn)(q, k, v,
                                                               mesh8),
                            [jnp.asarray(x) for x in xs])
    want_dense = _loss_grads(jattn.attention_reference,
                             [jnp.asarray(x) for x in xs])
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in xs)
    one = tmesh.Mesh(np.arange(1), ("data",))
    out = getattr(tring, fn)(q, k, v, one)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    for g, r, d in zip(got, want_ring, want_dense):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(d), rtol=2e-4,
                                   atol=2e-5)


def _block(seed, s_q=40, s_kv=56, d=16, kv_valid=37):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 2, s_q, d), (1, 2, s_kv, d), (1, 2, s_kv, d)))
    dout = torch.from_numpy(rng.standard_normal((1, 2, s_q, d))
                            .astype(np.float32))
    dlse = torch.from_numpy(rng.standard_normal((1, 2, s_q))
                            .astype(np.float32))
    return q, k, v, dout, dlse, kv_valid


def _dense_grads(q, k, v, dout, dlse, kv_valid):
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out, lse = tring._dense_block_lse(*xs, 1 / math.sqrt(q.shape[-1]),
                                      kv_valid)
    loss = (out * dout).sum() + (lse[..., 0] * dlse).sum()
    return torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("kv_valid", [56, 37, 1])
def test_backward_reference_with_dlse_matches_autograd(kv_valid):
    q, k, v, dout, dlse, _ = _block(1, kv_valid=kv_valid)
    out, lse = tattn.flash_forward_reference(q, k, v, kv_valid=kv_valid)
    got = tattn.flash_backward_reference(q, k, v, out, lse, dout,
                                         kv_valid=kv_valid, dlse=dlse)
    want = _dense_grads(q, k, v, dout, dlse, kv_valid)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, l = tattn.flash_attention_lse(*xs, kv_valid=kv_valid)
    got = torch.autograd.grad((o * dout).sum() + (l[..., 0] * dlse).sum(),
                              xs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5)


class _Fn:
    """A library function: ctypes sets ``argtypes``/``restype`` on it."""

    def __init__(self, body):
        self.body = body
        self.argtypes = self.restype = None

    def __call__(self, *args):
        return self.body(*args)


class _Lib:
    """A stand-in kernel library: every launch returns 0, but the f32
    backward's returns ``rc``; the backward records its ``kv_valid``."""

    def __init__(self, rc=0):
        self.rc, self.bwd_calls = rc, []
        self.flash_fwd = _Fn(lambda *a: 0)
        self.flash_bwd_f32 = _Fn(self._bwd)
        self.flash_bwd_bf16 = _Fn(lambda *a: 1)

    def _bwd(self, *a):
        self.bwd_calls.append(a[12])          # kv_valid
        return self.rc


@pytest.fixture
def card_path(monkeypatch):
    """The ring's blocks take the kernels' route on CPU tensors; the
    kernels' entries are the plain versions behind a stubbed library
    call, so that the wrappers' launch code runs."""
    def install(lib):
        monkeypatch.setattr(tring, "_on_card", lambda x: True)
        monkeypatch.setattr(tattn, "_LIB", None)
        monkeypatch.setattr(_build, "load", lambda name: lib)
        monkeypatch.setattr(tattn, "_stream", lambda x: 0)
        real_fwd = tattn._kernel_forward

        def fwd(q, k, v, causal, kv_valid=None):
            real_fwd(q, k, v, causal, kv_valid)       # the launch
            return tattn.flash_forward_reference(q, k, v, causal, kv_valid)

        real_buffers = tattn.backward_buffers
        deltas = []

        def buffers(*a):
            buf = real_buffers(*a)
            deltas.append((buf.delta.clone(), a))
            return buf

        def bwd(q, k, v, out, lse, dout, causal, kv_valid=None, dlse=None):
            tattn._kernel_backward(q, k, v, out, lse, dout, causal,
                                   kv_valid, dlse)    # the launch
            return tattn.flash_backward_reference(q, k, v, out, lse, dout,
                                                  causal, kv_valid, dlse)

        monkeypatch.setattr(tattn, "_forward", fwd)
        monkeypatch.setattr(tattn, "_backward", bwd)
        monkeypatch.setattr(tattn, "backward_buffers", buffers)
        return deltas
    return install


def _ring_grads(q, k, v):
    xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tring.ring_attention_padded(*xs, tmesh.Mesh(np.arange(1),
                                                      ("data",)))
    return torch.autograd.grad(out.square().sum(), xs)


def test_ring_backward_launches_b6_per_block(card_path):
    q, k, v = (torch.from_numpy(x) for x in drv.qkv(21, (1, 2, 50, 16)))
    want = _ring_grads(q, k, v)            # the dense fold, no kernels
    lib = _Lib()
    deltas = card_path(lib)
    before = tattn.flash_attention.bwd_f32_launches
    by_shape = dict(tattn.flash_attention.bwd_launches_by_shape)
    got = _ring_grads(q, k, v)
    assert lib.bwd_calls == [50]
    assert tattn.flash_attention.bwd_f32_launches == before + 1
    by_shape[(50, 50, 50)] = by_shape.get((50, 50, 50), 0) + 1
    assert tattn.flash_attention.bwd_launches_by_shape == by_shape
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5,
                                   rtol=2e-4)
    delta, (_, _, _, out, _, dout, _, _, dlse) = deltas[-1]
    assert dlse is not None
    want_delta = ((dout * out).sum(-1) - dlse.reshape(out.shape[:3])
                  ).detach()
    np.testing.assert_allclose(delta[:, :50].numpy(),
                               want_delta.reshape(2, 50).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_failed_b6_in_the_ring_raises(card_path):
    q, k, v = (torch.from_numpy(x) for x in drv.qkv(21, (1, 2, 50, 16)))
    card_path(_Lib(rc=700))
    before = tattn.flash_attention.bwd_f32_launches
    by_shape = dict(tattn.flash_attention.bwd_launches_by_shape)
    with pytest.raises(RuntimeError, match="backward kernel launch failed"):
        _ring_grads(q, k, v)
    assert tattn.flash_attention.bwd_f32_launches == before
    assert tattn.flash_attention.bwd_launches_by_shape == by_shape

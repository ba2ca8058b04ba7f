"""The port's training path on bf16 batches against the JAX package's, on
the CPU. JAX's ``flow_match_loss`` multiplies a bf16 batch by an f32 t,
so x_t, and with it the whole model, is f32; the port follows it. Its
``flux.apply`` sees f32 for a bf16 batch, as JAX's does, the params and
their grads stay f32, and the loss and every gradient leaf match JAX's
own ``flow_match_loss`` (the same key's t and eps) at the f32 limits of
``test_torch_train.py``: 1e-5 relative on the loss, each leaf within 1e-4
of the largest gradient, and each leaf within 1e-4 in relative norm
(measured: the loss 4.7e-7 / 1.5e-7, the worst leaf 1.5e-6 / 1.6e-6 for
the tiny / head_dim-128 configs). Helpers are ``test_torch_train``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.train import flow_match as jflow
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.train import flow_match as tflow
from test_torch_train import (CONFIG_IDS, CONFIGS, HD128, _batch, _jax_t_eps,
                              _np, _paths, _port, _rel)

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

LANES = ("x0", "txt", "pooled")


def _spy(seen, real):
    def spy(p, x, *args, **kw):
        seen.append(str(x.dtype))
        return real(p, x, *args, **kw)
    return spy


def test_bf16_batch_computes_in_f32_as_jax(monkeypatch):
    """A bf16 batch enters both packages' ``flux.apply`` as f32 (x_t is
    promoted by the f32 t), while the port's params and their grads stay
    f32."""
    batch = _batch(HD128)
    jparams = jflux.init(jax.random.PRNGKey(3), HD128)
    jbatch = {k: jnp.asarray(v, jnp.bfloat16) if k in LANES
              else jnp.asarray(v) for k, v in batch.items()}
    seen_jax, seen_port = [], []
    monkeypatch.setattr(jflux, "apply", _spy(seen_jax, jflux.apply))
    jloss = jflow.flow_match_loss(jparams, jbatch, jax.random.PRNGKey(0),
                                  HD128, jflow.TrainConfig())
    assert seen_jax == ["float32"] and np.isfinite(float(jloss))

    cfg = bridge.config(HD128, tflux.FluxConfig)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in LANES:
        tbatch[k] = tbatch[k].to(torch.bfloat16)
    step, params, opt = tflow.make_train_step(cfg, tflow.TrainConfig(),
                                              _port(jparams))
    monkeypatch.setattr(tflux, "apply", _spy(seen_port, tflux.apply))
    _, _, loss = step(params, opt, tbatch, prng.PRNGKey(0))
    assert seen_port == ["torch.float32"] and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in tflow.leaves(params))


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_bf16_loss_and_grads_match_jax_flow_match_loss(cfg):
    """The loss and gradients of a bf16 batch against JAX's own
    ``flow_match_loss`` on the same bf16 batch, with JAX's t and eps (eps
    drawn in bf16 from the same key). Both compute in f32 from the same
    bf16 values, so the f32 limits hold: the loss within 1e-5 relative;
    every element within 1e-4 of the largest gradient (rtol 1e-4), and
    each leaf within 1e-4 in relative norm."""
    params = jflux.init(jax.random.PRNGKey(4), cfg)
    batch = _batch(cfg, seed=2)
    jbatch = {k: jnp.asarray(v, jnp.bfloat16) if k in LANES
              else jnp.asarray(v) for k, v in batch.items()}
    train_cfg = jflow.TrainConfig(remat=False)
    key = jax.random.PRNGKey(7)
    want_loss, want = jax.value_and_grad(jflow.flow_match_loss)(
        params, jbatch, key, cfg, train_cfg)
    t, eps = _jax_t_eps(key, jbatch["x0"], train_cfg)
    assert eps.dtype == jnp.bfloat16

    tbatch = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in jbatch.items()}
    for k in LANES:
        tbatch[k] = tbatch[k].to(torch.bfloat16)        # exact: bf16 values
    tparams = _port(params)
    leaves = tflow.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    loss = tflow.flow_match_loss(
        tparams, tbatch, None, bridge.config(cfg, tflux.FluxConfig),
        bridge.config(train_cfg, tflow.TrainConfig),
        t=torch.tensor(np.asarray(t)),
        eps=torch.tensor(np.asarray(eps, np.float32)))
    grads = torch.autograd.grad(loss, leaves)
    assert loss.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = jax.tree.leaves(jax.tree.map(np.asarray, want))
    # the port's leaf order is the tree's; JAX sorts dict keys
    flat = sorted(zip(_paths(_np(params)), grads), key=lambda x: x[0])
    assert len(flat) == len(want)
    top = max(float(np.abs(w).max()) for w in want)
    for (path, g), w in zip(flat, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * top, rtol=1e-4,
                                   err_msg=str(path))
        assert _rel(g.numpy(), w) < 1e-4, (path, _rel(g.numpy(), w))

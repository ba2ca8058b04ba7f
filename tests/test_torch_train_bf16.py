"""The port's training path on bf16 batches against the JAX package's, on
the CPU: a bf16 batch enters the model in bf16 while the params and their
grads stay f32, and the loss and gradients of a bf16 batch against JAX
``flux.apply`` fed the same bf16-rounded x_t, bounded by bf16 rounding
noise against JAX's own bf16 distance from f32 (the test states the
numbers). Helpers are ``test_torch_train``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.train import flow_match as jflow
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.train import flow_match as tflow
from test_torch_train import (CONFIG_IDS, CONFIGS, HD128, _batch, _jax_t_eps,
                              _np, _paths, _port, _rel)

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


def test_bf16_batch_computes_in_bf16():
    """A bf16 batch enters the model in bf16 (x_t mixed in f32, then
    rounded) while the params and their grads stay f32."""
    cfg = bridge.config(HD128, tflux.FluxConfig)
    params = _port(jflux.init(jax.random.PRNGKey(3), HD128))
    seen = []
    real = tflux.apply

    def spy(p, x, *args, **kw):
        seen.append(x.dtype)
        return real(p, x, *args, **kw)

    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _batch(HD128).items()}
    batch["x0"] = batch["x0"].to(torch.bfloat16)
    step, params, opt = tflow.make_train_step(cfg, tflow.TrainConfig(),
                                              params)
    orig = tflux.apply
    tflux.apply = spy
    try:
        _, _, loss = step(params, opt, batch, torch.Generator().manual_seed(0))
    finally:
        tflux.apply = orig
    assert seen == [torch.bfloat16] and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in tflow.leaves(params))


@pytest.mark.parametrize("cfg", CONFIGS, ids=CONFIG_IDS)
def test_bf16_loss_and_grads_match_jax_apply(cfg):
    """The port trains a bf16 batch in bf16: x_t is mixed in f32 and
    rounded to bf16 before the model. JAX's flow_match_loss would promote
    such a batch to f32, so the reference here is JAX ``flux.apply`` fed
    the same bf16-rounded x_t, from JAX's own t and eps, with the same
    loss, computed in bf16 and in f32. Each package's bf16 gradient (every
    leaf, concatenated) lies ~1.4e-2 in relative norm from the f32 one,
    and the two bf16 gradients ~1.6e-2 from each other (independent
    rounding, ~sqrt(2) x 1.4e-2). Limits: the port's bf16 gradient at most
    1.5x as far from the f32 gradient as JAX's bf16 gradient is, within
    3e-2 of JAX's bf16 gradient, and the loss within 2e-3 relative (4e-4
    measured)."""
    params = jflux.init(jax.random.PRNGKey(4), cfg)
    batch = _batch(cfg, seed=2)
    bf16 = {k: jnp.asarray(batch[k], jnp.bfloat16)
            for k in ("x0", "txt", "pooled")}
    train_cfg = jflow.TrainConfig(remat=False)
    t, eps = _jax_t_eps(jax.random.PRNGKey(7), bf16["x0"], train_cfg)

    def jloss(p, dtype):
        x_t = ((1.0 - t[:, None, None]) * bf16["x0"].astype(jnp.float32)
               + t[:, None, None] * eps.astype(jnp.float32)
               ).astype(jnp.bfloat16).astype(dtype)
        guidance = jnp.full((t.shape[0],), train_cfg.guidance_value,
                            jnp.float32) if cfg.guidance_embed else None
        v = jflux.apply(p, x_t, bf16["txt"].astype(dtype),
                        bf16["pooled"].astype(dtype), t,
                        jnp.asarray(batch["img_ids"]),
                        jnp.asarray(batch["txt_ids"]), cfg, guidance=guidance)
        target = eps - bf16["x0"]
        return jnp.mean(jnp.square(v.astype(jnp.float32)
                                   - target.astype(jnp.float32)))

    def flat(tree):
        return np.concatenate([np.asarray(w, np.float32).ravel()
                               for w in jax.tree.leaves(tree)])

    want_loss, want = jax.value_and_grad(jloss)(params, jnp.bfloat16)
    want_f32 = flat(jax.grad(jloss)(params, jnp.float32))
    want = flat(want)
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    for k in bf16:
        tbatch[k] = tbatch[k].to(torch.bfloat16)
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
    assert all(g.dtype == torch.float32 for g in grads)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-3)
    flat_port = sorted(zip(_paths(_np(params)), grads), key=lambda x: x[0])
    got = np.concatenate([g.numpy().ravel() for _, g in flat_port])
    assert _rel(got, want) < 3e-2, _rel(got, want)
    assert _rel(got, want_f32) < 1.5 * _rel(want, want_f32), \
        (_rel(got, want_f32), _rel(want, want_f32))

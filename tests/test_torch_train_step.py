"""The port's optimizer, train step and image -> latent data path against
the JAX package's (optax, ``train.loop.latent_batches_from_images``), on
the same numpy inputs and bridged weights, on the CPU. Limits, as
``test_torch_train.py`` states them: the global-norm clip within 1e-5;
one train step's update within 1e-3 of JAX's in relative norm per leaf
and every element within 2.2 lr; the latent batch within 1e-4. Helpers
are ``test_torch_train``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.train import flow_match as jflow
from domainrag_tpu.train import loop as jloop
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.train import flow_match as tflow
from domainrag_tpu_torch.train import loop as tloop
from test_torch_train import _batch, _jax_t_eps, _np, _paths, _port, _rel

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the optimizer and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [1e-3, 1e3], ids=["clipped", "kept"])
def test_clip_matches_optax(max_norm):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 5), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.tensor(g) for g in grads]
    norm = tflow.clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-9)


@pytest.mark.parametrize("grad_clip", [1e-3, 1e4], ids=["clipped", "kept"])
def test_train_step_matches_optax(grad_clip):
    cfg = jflux.TINY_FLUX
    params = jflux.init(jax.random.PRNGKey(7), cfg)
    batch = _batch(cfg, seed=2)
    train_cfg = jflow.TrainConfig(learning_rate=1e-3, grad_clip=grad_clip,
                                  remat=False)
    opt = jflow.make_optimizer(train_cfg)
    key = jax.random.PRNGKey(8)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams, _, jloss = jflow.train_step(params, opt.init(params), jbatch,
                                         key, cfg, train_cfg, opt)
    gnorm = optax.global_norm(jax.grad(jflow.flow_match_loss)(
        params, jbatch, key, cfg, train_cfg))
    assert (float(gnorm) > grad_clip) == (grad_clip < 1)

    t, eps = _jax_t_eps(key, jbatch["x0"], train_cfg)
    step, tparams, opt_state = tflow.make_train_step(
        bridge.config(cfg, tflux.FluxConfig),
        bridge.config(train_cfg, tflow.TrainConfig), _port(params))
    tparams, opt_state, loss = step(
        tparams, opt_state, {k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()}, None,
        t=torch.tensor(np.asarray(t)), eps=torch.tensor(np.asarray(eps)))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want, start = _np(jparams), _np(params)
    flat_want = dict(zip(map(str, _paths(want)), _leaves_np(want)))
    flat_start = dict(zip(map(str, _paths(start)), _leaves_np(start)))
    for path, got in zip(_paths(want), tflow.leaves(tparams)):
        p0 = flat_start[str(path)]
        d_got, d_want = got.detach().numpy() - p0, flat_want[str(path)] - p0
        assert _rel(d_got, d_want) < 1e-3, (path, _rel(d_got, d_want))
        assert np.abs(d_got - d_want).max() <= 2.2 * train_cfg.learning_rate


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_np(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves_np(v)]
    return [tree]


def test_bridged_tree_trains():
    """A bridged JAX tree's leaves accept requires_grad_, and one step
    moves every leaf that the loss reaches."""
    cfg = bridge.config(jflux.TINY_FLUX, tflux.FluxConfig)
    params = _port(jflux.init(jax.random.PRNGKey(9), jflux.TINY_FLUX))
    before = [p.clone() for p in tflow.leaves(params)]
    step, params, opt = tflow.make_train_step(
        cfg, tflow.TrainConfig(learning_rate=1e-3), params)
    assert all(p.requires_grad and p.is_leaf for p in tflow.leaves(params))
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _batch(jflux.TINY_FLUX).items()}
    step(params, opt, batch, prng.PRNGKey(1))
    moved = [not torch.equal(a, b) for a, b in
             zip(before, tflow.leaves(params))]
    assert all(moved)                 # weight decay moves even zero grads


# ---------------------------------------------------------------------------
# the image -> latent data path
# ---------------------------------------------------------------------------

def test_latent_batches_match_jax(tmp_path):
    """One image in the directory, so both packages pick it for every slot
    (JAX's picks from the same key are checked in test_torch_seeded.py);
    the batch (latents, prompt embeddings, ids) agrees with JAX's
    vae.encode + pack_latents and encode_prompt."""
    from test_torch_generate import _port_bundle
    jb = jfp.tiny_bundle(jax.random.PRNGKey(0))
    tb = _port_bundle(jb)
    rng = np.random.default_rng(13)
    Image.fromarray(rng.integers(0, 255, (20, 28, 3), np.uint8)).save(
        tmp_path / "a.png")
    want = next(jloop.latent_batches_from_images(
        [str(tmp_path)], jb.vae_params, jb.vae_cfg, jb, 2,
        jax.random.PRNGKey(0), prompt="a photo"))
    got = next(tloop.latent_batches_from_images(
        [str(tmp_path)], tb.vae_params, tb.vae_cfg, tb, 2,
        prng.PRNGKey(0), prompt="a photo"))
    assert set(got) == set(want)
    assert got["x0"].dtype == torch.float32
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    assert list(tloop.latent_batches_from_images(
        [str(tmp_path / "empty")], tb.vae_params, tb.vae_cfg, tb, 2,
        prng.PRNGKey(0))) == []

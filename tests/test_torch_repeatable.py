"""Run-to-run repeatability: the same seed and inputs give the same bits.

The reference keeps this contract, and the port keeps it too: on the card
the flash backward (B6) adds dq over the kv blocks in a fixed, ascending
order, as the TPU's dq kernel adds them along its sequential grid axis
(``tests/test_torch_cuda.py::test_flash_backward_repeatable`` and
``chip_smoke.py`` hold the card to it). Here, on the CPU, on the tiny
configs:

- the port's ``train.loop.fit``, run twice from the same params, batches
  and seed: equal losses, every leaf ``torch.equal``;
- the JAX package's ``fit``, run twice the same way: ``np.array_equal``
  (the reference's own contract, held without touching it);
- the port's ``generate`` on ``tiny_bundle``, run twice from the same
  seed: the denoised latents ``torch.equal`` and the images equal.
"""

import jax
import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.parallel import mesh as jmesh
from domainrag_tpu.train import flow_match as jflow
from domainrag_tpu.train import loop as jloop
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import pipeline as tpipe
from domainrag_tpu_torch.train import flow_match as tflow
from domainrag_tpu_torch.train import loop as tloop

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

STEPS = 3


@pytest.fixture(scope="module")
def setup():
    """The tiny config's JAX params (numpy) and STEPS batches (numpy)."""
    cfg = jflux.TINY_FLUX
    params = jax.tree.map(np.asarray, jflux.init(jax.random.PRNGKey(4), cfg))
    rng = np.random.default_rng(5)
    batches = [{
        "x0": rng.standard_normal((2, 6, cfg.in_channels)).astype(np.float32),
        "txt": rng.standard_normal((2, 4, cfg.text_dim)).astype(np.float32),
        "pooled": rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32),
        "img_ids": jflux.make_image_ids(2, 3),
        "txt_ids": jflux.make_text_ids(4)} for _ in range(STEPS)]
    return cfg, params, batches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_port_fit_repeats(setup, dtype):
    """Two ``fit`` runs of the port (remat on, a batch dtype each) from the
    same params, batches and seed are bit-equal, and they train."""
    jcfg, params, batches = setup
    cfg = bridge.config(jcfg, tflux.FluxConfig)

    def run():
        data = [{k: torch.from_numpy(v).to(dtype) if k in ("x0", "txt",
                                                           "pooled")
                 else torch.from_numpy(v) for k, v in b.items()}
                for b in batches]
        return tloop.fit(bridge.params(params, device="cpu"), cfg, data,
                         STEPS, tflow.TrainConfig(learning_rate=1e-3,
                                                  remat=True), seed=7,
                         log_every=STEPS)

    (first, losses), (second, again) = run(), run()
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert again == losses
    start = tflow.leaves(bridge.params(params, device="cpu"))
    one, two = tflow.leaves(first), tflow.leaves(second)
    assert len(one) == len(two) == len(start)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert not all(torch.equal(a, s) for a, s in zip(one, start))


def test_jax_fit_repeats(setup):
    """The reference's ``fit`` on a one-device mesh, twice from the same
    params, batches and seed: the same losses and leaves, bit for bit."""
    cfg, params, batches = setup

    def run():
        final, losses = jloop.fit(
            params, cfg, iter(batches), STEPS,
            jflow.TrainConfig(learning_rate=1e-3, remat=True),
            mesh=jmesh.create_mesh(devices=jax.devices()[:1]), seed=7,
            log_every=STEPS)
        return jax.tree.leaves(jax.device_get(final)), losses

    (first, losses), (second, again) = run(), run()
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert again == losses
    assert len(first) == len(second) == len(jax.tree.leaves(params))
    assert all(np.array_equal(a, b) for a, b in zip(first, second))
    assert not all(np.array_equal(a, p) for a, p in
                   zip(first, jax.tree.leaves(params)))


def test_port_generate_repeats(monkeypatch):
    """``generate`` on ``tiny_bundle``, twice from the same seed: the
    latents handed to the decode are torch.equal, the images equal."""
    bundle = tpipe.tiny_bundle(0, device="cpu")
    g = torch.Generator().manual_seed(8)
    cfg = bundle.flux_cfg
    embeds = torch.randn((1, 6, cfg.text_dim), generator=g)
    pooled = torch.randn((1, cfg.pooled_dim), generator=g)
    latents = []
    decode = tpipe._decode_tokens

    def keep(vae_params, tokens, *args, **kwargs):
        latents.append(tokens.clone())
        return decode(vae_params, tokens, *args, **kwargs)

    monkeypatch.setattr(tpipe, "_decode_tokens", keep)
    images = [tpipe.generate(bundle, embeds, pooled, 32, 32, num_steps=3,
                             seed=11) for _ in range(2)]
    assert len(latents) == 2 and bool(torch.isfinite(latents[0]).all())
    assert torch.equal(latents[0], latents[1])
    assert images[0].shape == (32, 32, 3)
    assert np.array_equal(images[0], images[1])

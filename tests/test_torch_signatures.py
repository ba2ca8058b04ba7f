"""The port's ``generate`` and ``fill_batch`` take the JAX package's
parameters (``domainrag_tpu/models/flux/pipeline.py``): the same names in
the same order with the same defaults, up to the JAX function's last
parameter, so that a call written for the JAX package binds the same
values in the port. The port's own ``noise`` and ``timer`` come after, and
only by keyword. Values the port cannot honour yet raise
``NotImplementedError``."""

import inspect

import numpy as np
import pytest
import torch

from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu_torch.models.flux import pipeline as tfp

FUNCS = ["generate", "fill_batch"]
SIZE = 32


def _params(fn):
    return list(inspect.signature(fn).parameters.values())


@pytest.mark.parametrize("name", FUNCS)
def test_parameters_match_jax(name):
    jax_params = _params(getattr(jfp, name))
    port = _params(getattr(tfp, name))[:len(jax_params)]
    assert [p.name for p in port] == [p.name for p in jax_params]
    assert [p.default for p in port] == [p.default for p in jax_params]
    assert all(p.kind is p.POSITIONAL_OR_KEYWORD for p in port)


@pytest.mark.parametrize("name", FUNCS)
def test_port_only_parameters_are_keyword_only(name):
    n_jax = len(_params(getattr(jfp, name)))
    extra = _params(getattr(tfp, name))[n_jax:]
    assert [p.name for p in extra] == ["noise", "timer"]
    assert all(p.kind is p.KEYWORD_ONLY for p in extra)


@pytest.fixture(scope="module")
def bundle():
    return tfp.tiny_bundle(0, device="cpu"), tfp.tiny_bundle(0, device="cpu",
                                                             fill=True)


def _cond(b, n=1):
    g = torch.Generator().manual_seed(4)
    cfg = b.flux_cfg
    return (torch.randn((n, 8, cfg.text_dim), generator=g),
            torch.randn((n, cfg.pooled_dim), generator=g))


def _fill_images(n=1):
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    masks = np.zeros((n, SIZE, SIZE), np.uint8)
    masks[:, 8:24, 4:20] = 255
    return images, masks


def test_generate_jax_order_positional_call(bundle):
    """mesh=None and data_axis="data" by position, as a JAX caller writes
    them: the port binds them as JAX does and matches the keyword call."""
    b = bundle[0]
    e, p = _cond(b)
    by_position = tfp.generate(b, e, p, SIZE, SIZE, 1, 2.5, 3, None, None,
                               "data")
    by_keyword = tfp.generate(b, e, p, height=SIZE, width=SIZE, num_steps=1,
                              guidance=2.5, seed=3)
    assert by_position.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(by_position, by_keyword)


def test_fill_batch_jax_order_positional_call(bundle):
    b = bundle[1]
    e, p = _cond(b)
    images, masks = _fill_images()
    by_position = tfp.fill_batch(b, images, masks, e, p, 2, 30.0, 1.0, [3],
                                 None, "data")
    by_keyword = tfp.fill_batch(b, images, masks, e, p, num_steps=2,
                                guidance=30.0, strength=1.0, seeds=[3])
    assert by_position.shape == (1, SIZE, SIZE, 3)
    np.testing.assert_array_equal(by_position, by_keyword)


@pytest.mark.parametrize("kwargs", [dict(microbatches=2),
                                    dict(velocity_cache_order=2)],
                         ids=["microbatches", "velocity_cache_order"])
@pytest.mark.parametrize("name", FUNCS)
def test_unported_values_raise(bundle, name, kwargs):
    if name == "generate":
        b = bundle[0]
        e, p = _cond(b)
        call = lambda: tfp.generate(b, e, p, height=SIZE, width=SIZE,  # noqa
                                    num_steps=1, **kwargs)
    else:
        b = bundle[1]
        e, p = _cond(b)
        images, masks = _fill_images()
        call = lambda: tfp.fill_batch(b, images, masks, e, p,  # noqa: E731
                                      num_steps=1, **kwargs)
    with pytest.raises(NotImplementedError):
        call()

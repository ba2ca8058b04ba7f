"""The port's int8 serving modes on the MMDiT and at stage level, against
the JAX package's (on the CPU, where the port runs its plain versions).

- ``flux.apply`` on a head_dim-128 bf16 toy, quantized, under W8A8 + int8
  QK (+ P.V), against JAX ``flux.apply`` with its fused wrappers in
  interpret mode.
- Stage level: the tiny f32 bundle quantized by JAX (``min_size=1024``),
  bridged, under W8A8: ``generate`` agrees with JAX's on the same noise
  within 4 uint8 levels and 0.3 on average (W8A8 turns last-bit f32
  differences into whole quantisation steps; see ``_uint8_close``). The
  prompts are tokenized without Python's salted ``hash()``
  (``_Crc32Tokenizer``), so these inputs are the same in every process.
  ``fill_batch`` is in ``test_torch_int8_fill.py``.
"""

import dataclasses
import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from domainrag_tpu.core import text as jtext
from domainrag_tpu.models import quant as jquant
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu.models.flux import pipeline as jfp
from domainrag_tpu.ops import mmdit_attention as jmma
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.models.flux import pipeline as tfp
from domainrag_tpu_torch.ops import mmdit_attention as tmma
from test_torch_int8 import _rel, _t, int8_flags, w8a8_on  # noqa: F401

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)



HD128 = dataclasses.replace(jflux.TINY_FLUX, hidden=256, heads=2,
                            head_dim=128, depth_double=1, depth_single=1,
                            axes_dim=(16, 56, 56))


@pytest.mark.parametrize("pv", [False, True], ids=["w8a8_qk", "w8a8_qk_pv"])
def test_flux_apply_int8_matches_jax(monkeypatch, int8_flags, w8a8_on, pv):
    """bf16 head_dim-128 toy MMDiT quantized by JAX (min_size 1024 quantizes
    every block linear), W8A8 + int8 QK (+ P.V): the JAX model reaches its
    Pallas int8 kernels in interpret mode through its fused wrappers,
    replaced here by interpret partials. Limit: 3e-2 in relative norm (bf16
    through 2 blocks, with the int8 attention's rare +-1)."""
    for name in ("mmdit_double_attention", "mmdit_single_attention"):
        monkeypatch.setattr(jflux, name, functools.partial(
            getattr(jmma, name), interpret=True))
    int8_flags(True, pv)
    params = jflux.init(jax.random.PRNGKey(6), HD128)
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    jq = jquant.quantize_tree(params, min_size=1024)
    n_q = sum(1 for p, _ in jax.tree_util.tree_flatten_with_path(jq)[0]
              if p[-1].key == "w_q")
    assert n_q >= 10 + 9 + 3
    rng = np.random.default_rng(6)
    gh, gw, s_txt = 6, 8, 16
    img = rng.standard_normal((1, gh * gw, HD128.in_channels))
    txt = rng.standard_normal((1, s_txt, HD128.text_dim))
    pooled = rng.standard_normal((1, HD128.pooled_dim))
    t, guid = np.asarray([0.7], np.float32), np.asarray([2.5], np.float32)
    img_ids, txt_ids = jflux.make_image_ids(gh, gw), jflux.make_text_ids(s_txt)
    want = jflux.apply(jq, jnp.asarray(img, jnp.bfloat16),
                       jnp.asarray(txt, jnp.bfloat16),
                       jnp.asarray(pooled, jnp.bfloat16), jnp.asarray(t),
                       jnp.asarray(img_ids), jnp.asarray(txt_ids), HD128,
                       guidance=jnp.asarray(guid))
    tq = _bridge_bf16(jq)
    before = tmma.mmdit_double_attention.i8_launches
    got = tflux.apply(tq, _t(img, torch.bfloat16), _t(txt, torch.bfloat16),
                      _t(pooled, torch.bfloat16), _t(t),
                      torch.from_numpy(img_ids), torch.from_numpy(txt_ids),
                      bridge.config(HD128, tflux.FluxConfig),
                      guidance=_t(guid))
    assert tmma.mmdit_double_attention.i8_launches == before
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < 3e-2, _rel(got, want)


SIZE, STEPS, SEEDS = 32, 3, [0, 1]


def _bridge_bf16(tree):
    """bridge.params for a tree with bf16 leaves (numpy has no bf16 that
    torch reads): carried as f32, cast back."""
    f32 = jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32))
                       if x.dtype == jnp.bfloat16 else np.asarray(x), tree)
    return jax.tree.map(lambda t, x: t.to(torch.bfloat16)
                        if x.dtype == jnp.bfloat16 else t,
                        bridge.params(f32, device="cpu"), tree)


@dataclasses.dataclass
class _Crc32Tokenizer(jtext.StubTokenizer):
    """The stub tokenizer with ``zlib.crc32`` for the word hash. Python's
    ``hash()`` of a str is salted per process (PYTHONHASHSEED), so with
    the stub a word's token id, the prior and the stage-level W8A8 gap
    below changed from run to run."""

    def __call__(self, text: str, max_len: int) -> np.ndarray:
        ids = [] if self.bos_id is None else [self.bos_id]
        ids += [zlib.crc32(w.encode()) % (self.vocab_size - 3) + 1
                for w in text.lower().split()]
        ids = (ids + [self.eos_id])[:max_len]
        return np.asarray(ids + [self.pad_id] * (max_len - len(ids)),
                          np.int32)


def w8a8_bundles(fill):
    """The JAX tiny bundle (``fill`` for Flux-Fill) with its MMDiT quantized
    by JAX and salt-free tokenizers, and the same as a port bundle on the
    CPU: (jax_bundle, port_bundle)."""
    jb = jfp.tiny_bundle(jax.random.PRNGKey(0), fill=fill)
    jb = dataclasses.replace(
        jb, flux_params=jquant.quantize_tree(jb.flux_params,
                                             min_size=1024),
        clip_tokenizer=_Crc32Tokenizer(
            **dataclasses.asdict(jb.clip_tokenizer)),
        t5_tokenizer=_Crc32Tokenizer(
            **dataclasses.asdict(jb.t5_tokenizer)))
    cfgs = tfp.tiny_configs(fill)
    trees = {name: bridge.params(jax.tree.map(np.asarray,
                                              getattr(jb, name)),
                                 device="cpu")
             for name in ("flux_params", "vae_params", "t5_params",
                          "clip_text_params", "siglip_params",
                          "redux_params")}
    tb = tfp.FluxBundle(**trees, **cfgs, **tfp.tiny_tokenizers(cfgs),
                        compute_dtype=torch.float32,
                        device=torch.device("cpu"))
    return jb, tb


@pytest.fixture(scope="module")
def tiny_w8a8():
    """The generate bundles of :func:`w8a8_bundles`, keyed ``False`` (the
    fill's are in ``test_torch_int8_fill.py``)."""
    return {False: w8a8_bundles(False)}


def _noise(jb, seeds, size=SIZE):
    seq = (size // jb.latent_factor) ** 2
    c = jb.vae_cfg.latent_channels * 4
    return jnp.stack([jax.random.normal(jax.random.PRNGKey(s), (seq, c),
                                        jnp.float32) for s in seeds])


def _uint8_gap(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    return np.abs(got.astype(int) - want.astype(int))


def _uint8_close(got, want):
    """Within 4 uint8 levels, 0.3 on average. Each linear is bitwise equal
    to JAX's, but its input differs from JAX's in the last f32 bit
    (summation order in attention and norms), and an activation on a
    rounding edge of x / x_s quantizes to the neighbouring integer: a step
    of rowmax|x| / 127 on one input, which the denoise steps carry on.
    Measured on the CPU at torch thread counts 1, 2, 4, 6 and 8 (the same
    readings at each): generate max 2, mean 0.155."""
    d = _uint8_gap(got, want)
    assert d.max() <= 4 and d.mean() < 0.3, (d.max(), d.mean())


def test_generate_w8a8_matches_jax(tiny_w8a8, w8a8_on):
    jb, tb = tiny_w8a8[False]
    assert any(p[-1].key == "w_q" for p, _ in
               jax.tree_util.tree_flatten_with_path(tb.flux_params)[0])
    pimgs = np.random.default_rng(3).uniform(
        -1, 1, (2, 2, jb.siglip_cfg.image_size, jb.siglip_cfg.image_size,
                3)).astype(np.float32)
    je, jp = jfp.redux_prior_pairs(jb, pimgs, "", [0.8, 1.0], [1.0, 1.0])
    want = jfp.generate(jb, je, jp, height=SIZE, width=SIZE,
                        num_steps=STEPS, seed=SEEDS)
    got = tfp.generate(tb, _t(je), _t(jp), height=SIZE, width=SIZE,
                       num_steps=STEPS, seed=SEEDS,
                       noise=_t(_noise(jb, SEEDS)))
    _uint8_close(got, want)

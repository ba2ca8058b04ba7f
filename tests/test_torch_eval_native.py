"""The port's ``eval/`` and ``native/`` against the JAX package's.

- ``flux_forward_flops``: equal to JAX's, field by field, for FLUX.1-dev,
  FLUX.1-Fill-dev and the tiny config; ``mfu`` on the H100 peak by
  default, JAX's figure given JAX's peak;
- FID: ``compute_stats``, ``frechet_distance`` and ``fid_from_features``
  within 1e-9 of JAX's on the same features; ``fid_from_paths`` within
  1e-4 on a tiny CLIP (bridged weights) over the same files;
- the native library (built with ``g++`` into ``build/`` at first use):
  ``resize_native`` and ``resize_batch_native`` byte-equal to PIL and to
  the JAX package's native library, ``topk_ip_native`` equal to a numpy
  oracle and to JAX's; the port's CLIP and style preprocessing served by
  it, byte for byte JAX's. Skipped only where ``native_available()`` is
  false, as the JAX package's tests skip.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.eval import fid as jfid
from domainrag_tpu.eval import flops as jflops
from domainrag_tpu.models.flux import model as jflux
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.eval import fid as tfid
from domainrag_tpu_torch.eval import flops as tflops
from domainrag_tpu_torch.models.flux import model as tflux
from domainrag_tpu_torch.native import build as tnative

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

CFGS = {"dev": (jflux.FLUX_DEV, tflux.FLUX_DEV),
        "fill": (jflux.FLUX_FILL_DEV, tflux.FLUX_FILL_DEV),
        "tiny": (jflux.TINY_FLUX, tflux.TINY_FLUX)}


@pytest.mark.parametrize("s_img,s_txt,batch", [(4096, 512, 1),
                                               (4096, 1241, 2),
                                               (16384, 1241, 1),
                                               (16, 6, 3)])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_flux_forward_flops_equal_jax(name, s_img, s_txt, batch):
    jcfg, tcfg = CFGS[name]
    want = jflops.flux_forward_flops(jcfg, s_img, s_txt, batch)
    got = tflops.flux_forward_flops(tcfg, s_img, s_txt, batch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total == want.total


def test_mfu_and_peaks():
    assert {k: v for k, v in tflops.PEAK_TFLOPS.items() if k != "h100-sxm"} \
        == jflops.PEAK_TFLOPS
    assert tflops.PEAK_TFLOPS["h100-sxm"] == 989.0
    flops = tflops.flux_forward_flops(tflux.FLUX_DEV, 4096, 1241).total
    assert tflops.mfu(flops, 0.21) == flops / 0.21 / 989.0e12
    assert tflops.mfu(flops, 0.21, jflops.PEAK_TFLOPS["a100"]) == \
        jflops.mfu(flops, 0.21, jflops.PEAK_TFLOPS["a100"])


@pytest.mark.parametrize("n,d,shift", [(500, 16, 0.0), (2000, 8, 3.0),
                                       (40, 32, 0.5)])
def test_fid_core_matches_jax(n, d, shift):
    rng = np.random.default_rng(n + d)
    a = rng.standard_normal((n, d))
    b = rng.standard_normal((n, d)) * 1.5 + shift
    for x in (a, b):
        for got, want in zip(tfid.compute_stats(x), jfid.compute_stats(x)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    mu_a, s_a = jfid.compute_stats(a)
    mu_b, s_b = jfid.compute_stats(b)
    assert abs(tfid.frechet_distance(mu_a, s_a, mu_b, s_b)
               - jfid.frechet_distance(mu_a, s_a, mu_b, s_b)) <= 1e-9
    assert abs(tfid.fid_from_features(a, b)
               - jfid.fid_from_features(a, b)) <= 1e-9
    assert abs(tfid.fid_from_features(a, a)) < 1e-8
    np.testing.assert_allclose(
        tfid.frechet_distance(np.array([0.0]), np.array([[4.0]]),
                              np.array([1.0]), np.array([[1.0]])), 2.0,
        rtol=1e-9)


def test_fid_from_paths_matches_jax(tmp_path):
    from domainrag_tpu.models import clip as jclip
    from domainrag_tpu.stages.encoders import ClipImageEncoder as JEnc
    from domainrag_tpu_torch.models import clip as tclip
    from domainrag_tpu_torch.stages.encoders import ClipImageEncoder as TEnc
    cfg = jclip.TINY_VISION
    params = jclip.init_vision(jax.random.PRNGKey(0), cfg)
    jenc = JEnc(params, cfg, batch_size=16)
    tenc = TEnc(bridge.params(jax.tree.map(np.asarray, params),
                              device="cpu"),
                bridge.config(cfg, tclip.ClipVisionConfig), batch_size=16,
                device="cpu")
    rng = np.random.default_rng(4)
    real, gen = [], []
    for i in range(48):
        for paths, lo, hi in ((real, 0, 255), (gen, 90, 160)):
            p = tmp_path / f"{len(real) + len(gen)}.png"
            Image.fromarray(rng.integers(lo, hi, (40, 36, 3),
                                         dtype=np.uint8)).save(p)
            paths.append(str(p))
    want = jfid.fid_from_paths(real, gen, jenc)
    got = tfid.fid_from_paths(real, gen, tenc)
    assert np.isfinite(got) and abs(got - want) <= 1e-4, (got, want)
    assert abs(tfid.fid_from_paths(real, real, tenc)) < 1e-6
    with pytest.raises(ValueError, match="at least 2"):
        tfid.fid_from_paths(real[:1], gen, tenc)


# ---------------------------------------------------------------------------
# native
# ---------------------------------------------------------------------------

@pytest.fixture
def native_lib():
    """Skips where no library can be built or loaded (decided when the
    test runs, not when the module is imported)."""
    if not tnative.native_available():
        pytest.skip("no g++ to build the native library")


native = pytest.mark.usefixtures("native_lib")


@native
def test_native_library_builds_into_build_dir():
    lib = tnative.load_native()
    assert lib is not None
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent == tnative._DIR.parents[1]


@native
@pytest.mark.parametrize("in_size,out_size", [
    ((300, 400), (224, 298)), ((100, 150), (224, 336)),
    ((224, 224), (224, 224)), ((37, 53), (224, 224)),
    ((400, 300), (256, 256)), ((800, 800), (384, 384))])
@pytest.mark.parametrize("filt", ["bicubic", "bilinear"])
def test_resize_native_byte_equal(in_size, out_size, filt):
    from domainrag_tpu.native import build as jnative
    rng = np.random.default_rng(sum(in_size) + sum(out_size))
    img = rng.integers(0, 256, in_size + (3,), dtype=np.uint8)
    method = Image.BICUBIC if filt == "bicubic" else Image.BILINEAR
    fid = tnative.FILTER_BICUBIC if filt == "bicubic" \
        else tnative.FILTER_BILINEAR
    ref = np.asarray(Image.fromarray(img).resize(out_size[::-1], method))
    got = tnative.resize_native(img, *out_size, fid)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jnative.resize_native(img, *out_size,
                                                             fid))


@native
def test_resize_batch_native_byte_equal():
    from domainrag_tpu.native import build as jnative
    imgs = np.random.default_rng(6).integers(0, 256, (6, 80, 60, 3),
                                             dtype=np.uint8)
    got = tnative.resize_batch_native(imgs, 32, 48, n_threads=3)
    np.testing.assert_array_equal(
        got, jnative.resize_batch_native(imgs, 32, 48, n_threads=2))
    for i in range(6):
        np.testing.assert_array_equal(got[i], np.asarray(
            Image.fromarray(imgs[i]).resize((48, 32), Image.BICUBIC)))
        np.testing.assert_array_equal(got[i],
                                      tnative.resize_native(imgs[i], 32, 48))


@native
@pytest.mark.parametrize("nq,nb,d,k", [(5, 300, 16, 10), (3, 50, 8, 100),
                                       (7, 1000, 33, 1), (1, 64, 4, 64)])
def test_topk_ip_native_matches_oracle_and_jax(nq, nb, d, k):
    from domainrag_tpu.native import build as jnative
    rng = np.random.default_rng(nq * nb + k)
    # integer-valued rows: exact sums and many ties
    q = rng.integers(-3, 4, (nq, d)).astype(np.float32)
    bank = rng.integers(-3, 4, (nb, d)).astype(np.float32)
    scores, idx = tnative.topk_ip_native(q, bank, k, n_threads=2)
    ref = q @ bank.T
    order = np.lexsort((np.broadcast_to(np.arange(nb), ref.shape), -ref),
                       axis=1)[:, :min(k, nb)]
    np.testing.assert_array_equal(idx, order)
    np.testing.assert_array_equal(scores, np.take_along_axis(ref, order, 1))
    js, ji = jnative.topk_ip_native(q, bank, k, n_threads=2)
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(scores, js)


@native
def test_preprocessing_served_natively_and_equal_to_jax():
    from domainrag_tpu.core import imaging as jimaging
    from domainrag_tpu_torch.core import imaging as timaging
    rng = np.random.default_rng(8)
    before = dict(timaging.resize_counts)
    for h, w in ((300, 400), (97, 61)):
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                          dtype=np.uint8))
        np.testing.assert_array_equal(timaging.clip_preprocess(im),
                                      jimaging.clip_preprocess(im))
        np.testing.assert_array_equal(timaging.style_preprocess(im, 64),
                                      jimaging.style_preprocess(im, 64))
    assert timaging.resize_counts["native"] == before["native"] + 4
    assert timaging.resize_counts["pil"] == before["pil"]


def test_pil_serves_when_no_library_loads(monkeypatch):
    from domainrag_tpu_torch.core import imaging as timaging
    monkeypatch.setattr(tnative, "load_native", lambda: None)
    im = Image.fromarray(np.random.default_rng(9).integers(
        0, 256, (50, 70, 3), dtype=np.uint8))
    before = dict(timaging.resize_counts)
    arr = timaging.style_preprocess(im, 32)
    np.testing.assert_array_equal(
        arr, np.asarray(im.resize((32, 32), Image.BILINEAR),
                        np.float32) / 255.0)
    assert timaging.resize_counts["pil"] == before["pil"] + 1
    assert torch.from_numpy(arr).shape == (32, 32, 3)


@native
@pytest.mark.parametrize("call", ["gray", "rgba_batch", "topk_k0",
                                  "topk_widths"])
def test_native_rejects_bad_shapes(call):
    """Shapes the C++ side would read past are refused before the call."""
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        if call == "gray":
            tnative.resize_native(np.zeros((8, 8), np.uint8), 4, 4)
        elif call == "rgba_batch":
            tnative.resize_batch_native(np.zeros((2, 8, 8, 4), np.uint8), 4,
                                        4)
        elif call == "topk_k0":
            tnative.topk_ip_native(q, q, 0)
        else:
            tnative.topk_ip_native(q, q[:, :4], 1)

"""Stage 1 of the port (LaMa inpainting) against the JAX package's, on the
same numpy inputs and bridged weights, on the CPU, all in f32.

Limits, each with its reason:
- ``conv2d_transpose`` / ``conv2d(padding="VALID")``: 1e-5 absolute at
  unit-scale inputs (the same sums in another order);
- ``fourier_unit``, ``spectral_transform``, ``ffc_bn_act`` and ``apply`` at
  ``TINY_LAMA``: 1e-5 absolute (pocketfft in both, convolutions summed in
  another order; the generator's output is a sigmoid in [0, 1]), with the
  batchnorm statistics drawn at random so that no norm is the identity;
- the uint8 outputs (``inpaint_image``, the runner, the stage's files):
  within 1 level (a value on a rounding edge may land on either side);
- ``inpaint_mask_from_bboxes`` and the stage's file tree, manifest
  statuses and ``category_mapping.json``: equal.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from domainrag_tpu.core import imaging as jimaging
from domainrag_tpu.core.coco import write_coco as jwrite_coco
from domainrag_tpu.models import common as jcommon
from domainrag_tpu.models import lama as jlama
from domainrag_tpu.stages import inpaint as jinpaint
from domainrag_tpu_torch import bridge
from domainrag_tpu_torch.core import imaging as timaging
from domainrag_tpu_torch.core.coco import write_coco as twrite_coco
from domainrag_tpu_torch.models import common as tcommon
from domainrag_tpu_torch.models import lama as tlama
from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.stages import inpaint as tinpaint

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def _randomize_bn(tree, rng):
    """Random running statistics and affine terms in every batchnorm."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape
            return {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                    "bias": rng.uniform(-0.2, 0.2, n).astype(np.float32),
                    "mean": rng.uniform(-0.2, 0.2, n).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def tiny():
    """TINY_LAMA weights as numpy (random batchnorms), the JAX tree and
    the port's tree through the bridge."""
    tree = jax.tree.map(np.asarray,
                        jlama.init(jax.random.PRNGKey(0), jlama.TINY_LAMA))
    tree = _randomize_bn(tree, np.random.default_rng(1))
    return (jax.tree.map(jnp.asarray, tree),
            bridge.params(tree, device="cpu"))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_config_and_init_tree_match_jax(tiny):
    """The port's init draws the JAX tree's keys in the bridged layout."""
    for name in ("TINY_LAMA", "BIG_LAMA"):
        assert bridge.config(getattr(jlama, name), tlama.LamaConfig) \
            == getattr(tlama, name)
    assert tlama.BIG_LAMA.bottleneck == 512 and tlama.BIG_LAMA.n_blocks == 18
    port = tlama.init(prng.PRNGKey(0), tlama.TINY_LAMA)
    assert _shapes(port) == _shapes(tiny[1])
    # the up-convs' kernels: (c_out, c_in, 3, 3), the layout of
    # conv2d_transpose
    assert _shapes(port)["up"][0]["conv"]["w"] == (16, 32, 3, 3)


@pytest.mark.parametrize("k,stride,padding,h,w", [
    (3, 2, "SAME", 5, 7), (3, 2, "SAME", 6, 3), (3, 2, "VALID", 5, 7),
    (4, 2, "SAME", 6, 3), (2, 3, "SAME", 4, 5), (2, 3, "VALID", 4, 5),
    (3, 1, "SAME", 5, 6), (5, 2, "SAME", 3, 4),
    (3, 2, ((1, 1), (2, 1)), 5, 4)])
def test_conv2d_transpose_matches_lax(k, stride, padding, h, w):
    rng = np.random.default_rng(k * 10 + stride + h)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    want = jax.lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(kernel), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision="highest") + bias
    got = tcommon.conv2d_transpose(
        bridge.params({"w": kernel, "b": bias}, device="cpu"),
        torch.from_numpy(x), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    # the JAX package's own wrapper agrees with lax
    np.testing.assert_allclose(np.asarray(jcommon.conv2d_transpose(
        {"w": jnp.asarray(kernel), "b": jnp.asarray(bias)},
        jnp.asarray(x), stride=stride, padding=padding)), np.asarray(want),
        atol=ATOL)


def test_conv2d_transpose_rejects_unreachable_padding():
    p = {"w": torch.zeros(4, 3, 3, 3)}
    with pytest.raises(ValueError):
        tcommon.conv2d_transpose(p, torch.zeros(1, 4, 4, 3), stride=2,
                                 padding=((3, 1), (1, 1)))


@pytest.mark.parametrize("stride,shape", [(1, (1, 9, 11, 3)),
                                          (2, (2, 12, 7, 3))])
def test_conv2d_valid_matches_jax(stride, shape):
    rng = np.random.default_rng(stride)
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"w": rng.standard_normal((7, 5, 3, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    want = jcommon.conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          stride=stride, padding="VALID")
    got = tcommon.conv2d(bridge.params(p, device="cpu"),
                         torch.from_numpy(x), stride=stride,
                         padding="VALID")
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def _block(tree, i=0):
    return tree["blocks"][i]["conv1"]


@pytest.mark.parametrize("h,w", [(8, 8), (6, 10), (7, 5)])
def test_fourier_unit_matches_jax(tiny, h, w):
    jt, tt = tiny
    fu_j, fu_t = _block(jt)["g2g"]["fu"], _block(tt)["g2g"]["fu"]
    c = fu_t["conv"]["w"].shape[1] // 2
    x = np.random.default_rng(h * w).standard_normal(
        (2, h, w, c)).astype(np.float32)
    want = jlama.fourier_unit(fu_j, jnp.asarray(x))
    got = tlama.fourier_unit(fu_t, torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, h, w, c)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_spectral_and_ffc_block_match_jax(tiny):
    jt, tt = tiny
    rng = np.random.default_rng(3)
    c_l, c_g = tlama._split(tlama.TINY_LAMA.bottleneck, 0.75)
    xl = rng.standard_normal((1, 6, 10, c_l)).astype(np.float32)
    xg = rng.standard_normal((1, 6, 10, c_g)).astype(np.float32)
    want = jlama.spectral_transform(_block(jt)["g2g"], jnp.asarray(xg))
    got = tlama.spectral_transform(_block(tt)["g2g"], torch.from_numpy(xg))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
    for reflect in (False, True):
        wl, wg = jlama.ffc_bn_act(_block(jt), jnp.asarray(xl),
                                  jnp.asarray(xg), reflect=reflect)
        gl, gg = tlama.ffc_bn_act(_block(tt), torch.from_numpy(xl),
                                  torch.from_numpy(xg), reflect=reflect)
        np.testing.assert_allclose(_np(gl), np.asarray(wl), atol=ATOL)
        np.testing.assert_allclose(_np(gg), np.asarray(wg), atol=ATOL)
    # stride 2 from a local-only input into both branches (the last
    # downsample)
    x = rng.standard_normal((1, 8, 12, 16)).astype(np.float32)
    wl, wg = jlama.ffc_bn_act(jt["down"][-1], jnp.asarray(x), None,
                              stride=2, pad=1)
    gl, gg = tlama.ffc_bn_act(tt["down"][-1], torch.from_numpy(x), None,
                              stride=2, pad=1)
    np.testing.assert_allclose(_np(gl), np.asarray(wl), atol=ATOL)
    np.testing.assert_allclose(_np(gg), np.asarray(wg), atol=ATOL)


def _inputs(b, h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w, 3)).astype(np.float32)
    mask = np.zeros((b, h, w, 1), np.float32)
    mask[:, h // 4:h // 2, w // 5:w // 2] = 1.0
    return img, mask


@pytest.mark.parametrize("b,h,w", [(1, 32, 40), (2, 24, 48), (1, 48, 16)])
def test_apply_matches_jax(tiny, b, h, w):
    jt, tt = tiny
    img, mask = _inputs(b, h, w, seed=h + w)
    want = jlama.apply(jt, jnp.asarray(img), jnp.asarray(mask),
                       jlama.TINY_LAMA)
    got = tlama.apply(tt, torch.from_numpy(img), torch.from_numpy(mask),
                      tlama.TINY_LAMA)
    assert tuple(got.shape) == want.shape == (b, h, w, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def test_inpaint_image_matches_jax(tiny):
    jt, tt = tiny
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (30, 37, 3), dtype=np.uint8)  # not /8
    mask = np.zeros((30, 37), np.uint8)
    mask[5:15, 5:20] = 255
    mask[20:25, 30:33] = 100             # below the binarization threshold
    want = jlama.inpaint_image(jt, img, mask, jlama.TINY_LAMA)
    got = tlama.inpaint_image(tt, img, mask, tlama.TINY_LAMA)
    assert got.dtype == np.uint8 and got.shape == want.shape == (30, 37, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert tlama.pad_to_multiple(30, 37) == jlama.pad_to_multiple(30, 37)


MASK_CASES = [
    [(2, 3, 5, 4)],                              # inside
    [(10.6, 2.2, 7.9, 3.5)],                     # fractional
    [(-4, -3, 10, 9)],                           # clamped at the top-left
    [(15, 10, 40, 30)],                          # past the right/bottom
    [(0, 0, 20, 16)],                            # the whole image
    [(5, 5, 0, 3), (3, 3, 2, 0)],                # empty boxes
    [(25, 3, 4, 4), (3, 20, 2, 2)],              # entirely outside
    [(1, 1, 3, 3), (2, 2, 6, 5), (19, 15, 1, 1)],
]


@pytest.mark.parametrize("boxes", MASK_CASES, ids=str)
def test_inpaint_mask_matches_jax(boxes):
    want = jimaging.inpaint_mask_from_bboxes(20, 16, boxes)
    got = timaging.inpaint_mask_from_bboxes(20, 16, boxes)
    assert got.dtype == np.uint8 and got.shape == (16, 20)
    np.testing.assert_array_equal(got, want)


def test_runner_batch_matches_single_and_jax(tiny):
    jt, tt = tiny
    rng = np.random.default_rng(6)
    imgs = [rng.integers(0, 255, (30, 37, 3), dtype=np.uint8),
            rng.integers(0, 255, (32, 40, 3), dtype=np.uint8)]
    masks = [np.zeros(im.shape[:2], np.uint8) for im in imgs]
    for m in masks:
        m[4:12, 6:20] = 255
    runner = tinpaint.LamaRunner(tt, tlama.TINY_LAMA, bucket_multiple=16,
                                 batch_size=2, device="cpu")
    jrunner = jinpaint.LamaRunner(jt, jlama.TINY_LAMA, bucket_multiple=16,
                                  batch_size=2)
    batch = runner.inpaint_batch(imgs, masks)
    want = jrunner.inpaint_batch(imgs, masks)
    for b, w, im, m in zip(batch, want, imgs, masks):
        assert b.shape == im.shape and b.dtype == np.uint8
        assert np.abs(b.astype(int) - w.astype(int)).max() <= 1
        single = runner.inpaint(im, m)
        assert np.abs(single.astype(int) - b.astype(int)).max() <= 1
    assert runner._pad_shape(30, 37) == jrunner._pad_shape(30, 37)


def test_runner_defaults_to_the_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tinpaint.LamaRunner(tiny[1], tlama.TINY_LAMA)


# ---------------------------------------------------------------------------
# the stage
# ---------------------------------------------------------------------------

DATASET, SHOT = "NEU-DET", 1


def toy_kshot(root, write, n=5):
    """datasets/NEU-DET with a 1-shot annotation file: five images, one
    without boxes (skipped), one whose pixels disagree with its
    annotation's size (resized), one with a box past the border, two
    classes; and a second shot file name that is missing."""
    rng = np.random.default_rng(11)
    ds = root / "datasets" / DATASET
    (ds / "train").mkdir(parents=True)
    cats = [{"id": 1, "name": "crazing"}, {"id": 2, "name": "patches"}]
    images, anns = [], []
    sizes = [(40, 36), (48, 40), (40, 36), (33, 29), (40, 36)][:n]
    for i, (w, h) in enumerate(sizes):
        name = f"{cats[i % 2]['name']}_{i + 1}.jpg"
        images.append({"id": i + 1, "file_name": name, "width": w,
                       "height": h})
        pw, ph = (w + 6, h + 2) if i == 2 else (w, h)   # needs a resize
        Image.fromarray(rng.integers(0, 255, (ph, pw, 3), dtype=np.uint8)
                        ).save(ds / "train" / name)
        if i == 3:
            continue                                   # no boxes
        anns.append({"id": len(anns) + 1, "image_id": i + 1,
                     "category_id": cats[i % 2]["id"],
                     "bbox": [4 + i, 3, 12, 10]})
        if i == 1:
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "bbox": [40, 30, 20, 20]})
    write(str(ds / "annotations" / f"{SHOT}_shot.json"), images=images,
          annotations=anns, categories=cats)
    return str(root / "datasets")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _statuses(path):
    with open(path) as f:
        return {k: v["status"] for k, v in json.load(f)["samples"].items()}


@pytest.fixture(scope="module")
def stage_runs(tiny, tmp_path_factory):
    jt, tt = tiny
    out = {}
    for name, mod, write, params, kw in (
            ("jax", jinpaint, jwrite_coco, jt, {}),
            ("port", tinpaint, twrite_coco, tt, {"device": "cpu"})):
        root = tmp_path_factory.mktemp(name)
        datasets = toy_kshot(root, write)
        lama_mod = jlama if name == "jax" else tlama
        runner = mod.LamaRunner(params, lama_mod.TINY_LAMA,
                                bucket_multiple=16, batch_size=2, **kw)
        result = mod.run_inpaint([DATASET, "DIOR"], [SHOT, 5], runner,
                                 datasets, str(root / "output"))
        out[name] = (root / "output", result)
    return out


def test_stage_writes_the_jax_tree(stage_runs):
    (jroot, jres), (troot, tres) = stage_runs["jax"], stage_runs["port"]
    assert tres == jres == {f"{DATASET}/{SHOT}": {"processed": 4,
                                                   "skipped": 1,
                                                   "failed": 0}}
    assert _files(troot) == _files(jroot)
    shot = os.path.join("lamainpaint", DATASET, f"{SHOT}_shot")
    assert _files(troot) == sorted(
        [os.path.join(shot, n) for n in (
            "category_mapping.json", "manifest.json", "crazing_1.jpg",
            "patches_2.jpg", "crazing_3.jpg", "crazing_5.jpg")])
    for name in ("category_mapping.json",):
        with open(troot / shot / name) as f, open(jroot / shot / name) as g:
            assert json.load(f) == json.load(g)
    with open(troot / shot / "category_mapping.json") as f:
        assert json.load(f) == {"crazing_1": "crazing", "patches_2":
                                "patches", "crazing_3": "crazing",
                                "crazing_5": "crazing"}
    assert _statuses(troot / shot / "manifest.json") == _statuses(
        jroot / shot / "manifest.json") == {str(i): "done"
                                            for i in (1, 2, 3, 5)}
    with open(troot / shot / "manifest.json") as f:
        rec = json.load(f)["samples"]["1"]
    assert rec["outputs"]["path"] == str(troot / shot / "crazing_1.jpg")


def test_stage_images_match_jax(stage_runs):
    """The saved backgrounds, decoded, within 1 uint8 level (both stages
    encode with PIL's JPEG encoder)."""
    (jroot, _), (troot, _) = stage_runs["jax"], stage_runs["port"]
    shot = os.path.join("lamainpaint", DATASET, f"{SHOT}_shot")
    for name in ("crazing_1.jpg", "patches_2.jpg", "crazing_3.jpg",
                 "crazing_5.jpg"):
        a = np.asarray(Image.open(troot / shot / name)).astype(int)
        b = np.asarray(Image.open(jroot / shot / name)).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1


def test_stage_resume_skips_done(tiny, tmp_path):
    datasets = toy_kshot(tmp_path, twrite_coco, n=3)
    runner = tinpaint.LamaRunner(tiny[1], tlama.TINY_LAMA, device="cpu")
    first = tinpaint.process_dataset(DATASET, SHOT, runner, datasets,
                                     str(tmp_path / "out"))
    again = tinpaint.process_dataset(DATASET, SHOT, runner, datasets,
                                     str(tmp_path / "out"), resume=True)
    assert first == {"processed": 3, "skipped": 0, "failed": 0}
    assert again == {"processed": 0, "skipped": 3, "failed": 0}


def test_stage_failure_marks_its_batch(tiny, tmp_path):
    datasets = toy_kshot(tmp_path, twrite_coco, n=3)
    os.remove(os.path.join(datasets, DATASET, "train", "patches_2.jpg"))
    runner = tinpaint.LamaRunner(tiny[1], tlama.TINY_LAMA, device="cpu")
    counters = tinpaint.process_dataset(DATASET, SHOT, runner, datasets,
                                        str(tmp_path / "out"))
    assert counters == {"processed": 2, "skipped": 0, "failed": 1}
    shot = tmp_path / "out" / "lamainpaint" / DATASET / f"{SHOT}_shot"
    assert _statuses(shot / "manifest.json") == {"1": "done", "2": "failed",
                                                 "3": "done"}


def test_stage_spans(tiny, tmp_path):
    from domainrag_tpu_torch.core.log import StepTimer
    datasets = toy_kshot(tmp_path, twrite_coco, n=3)
    runner = tinpaint.LamaRunner(tiny[1], tlama.TINY_LAMA, device="cpu")
    timer = StepTimer()
    tinpaint.process_dataset(DATASET, SHOT, runner, datasets,
                             str(tmp_path / "out"), timer=timer)
    assert timer.counts == {"load": 3, "mask": 3, "lama": 3, "save": 3}

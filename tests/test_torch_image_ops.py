"""The port's ``ops/image.py`` against ``domainrag_tpu.ops.image`` on the
CPU, on the same numpy inputs: the box masks (the box sets and padding
case of ``tests/test_ops_image.py``) equal; ``composite`` and
``paste_box`` equal; both resizes up and down within 1e-5 (f32: the same
separable weights, contracted in another order), and away from
``F.interpolate``'s bicubic (a = -0.75, no antialiasing), which the port
must not be."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from domainrag_tpu.core import imaging
from domainrag_tpu.ops import image as jimg
from domainrag_tpu_torch.ops import image as timg

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

BOX_SETS = [
    [(10, 20, 30, 40)],
    [(0, 0, 64, 64)],
    [(-5, -5, 20, 20)],
    [(50, 50, 100, 100)],
    [(10, 10, 5, 5), (30, 30, 20, 10)],
]


@pytest.mark.parametrize("bboxes", BOX_SETS)
def test_boxes_mask_matches_jax(bboxes):
    want = np.asarray(jimg.boxes_mask(64, 64, jnp.asarray(bboxes),
                                      inside_value=255.0))
    got = timg.boxes_mask(64, 64, torch.tensor(bboxes), inside_value=255.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy().astype(np.uint8),
        imaging.inpaint_mask_from_bboxes(64, 64, bboxes))


def test_boxes_mask_padding_matches_jax():
    boxes = np.asarray([[5, 5, 10, 10], [0, 0, 64, 64]], np.float32)
    for n_valid in (None, 1, 0):
        want = np.asarray(jimg.boxes_mask(
            64, 64, jnp.asarray(boxes),
            n_valid=None if n_valid is None else jnp.int32(n_valid),
            inside_value=2.0, outside_value=-1.0))
        got = timg.boxes_mask(64, 64, torch.from_numpy(boxes),
                              n_valid=n_valid, inside_value=2.0,
                              outside_value=-1.0)
        np.testing.assert_array_equal(got.numpy(), want)


def test_composite_and_paste_match_jax(rng):
    for lead in ((), (2,)):
        fg = rng.random(lead + (8, 8, 3)).astype(np.float32)
        bg = rng.random(lead + (8, 8, 3)).astype(np.float32)
        mask = (rng.random(lead + (8, 8)) > 0.5).astype(np.float32) * 0.75
        np.testing.assert_array_equal(
            timg.composite(*(torch.from_numpy(x) for x in (fg, bg, mask)))
            .numpy(),
            np.asarray(jimg.composite(jnp.asarray(fg), jnp.asarray(bg),
                                      jnp.asarray(mask))))
    for canvas, patch, y, x in (
            (np.zeros((10, 10, 3), np.float32),
             rng.random((4, 4, 3)).astype(np.float32), 2, 3),
            (np.zeros((2, 10, 12, 3), np.float32),
             rng.random((2, 3, 5, 3)).astype(np.float32), 7, 0),
            (np.zeros((10, 10, 3), np.float32),
             rng.random((4, 4, 3)).astype(np.float32), 8, -2)):   # clamped
        want = np.asarray(jimg.paste_box(jnp.asarray(canvas),
                                         jnp.asarray(patch), y, x))
        got = timg.paste_box(torch.from_numpy(canvas),
                             torch.from_numpy(patch), y, x)
        np.testing.assert_array_equal(got.numpy(), want)


RESIZES = [((1, 16, 24, 3), 32, 48), ((16, 24, 3), 8, 12),
           ((37, 53, 3), 20, 29), ((2, 37, 53, 4), 74, 29)]


@pytest.mark.parametrize("shape,out_h,out_w", RESIZES,
                         ids=["up", "down", "odd_down", "mixed"])
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
def test_resize_matches_jax(rng, shape, out_h, out_w, method):
    img = rng.random(shape).astype(np.float32)
    want = np.asarray(getattr(jimg, f"resize_{method}")(
        jnp.asarray(img), out_h, out_w))
    got = getattr(timg, f"resize_{method}")(torch.from_numpy(img), out_h,
                                            out_w)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    if method == "bicubic":
        x = torch.from_numpy(img).reshape((-1,) + shape[-3:]).permute(
            0, 3, 1, 2)
        torch_default = F.interpolate(x, (out_h, out_w), mode="bicubic",
                                      align_corners=False)
        assert np.abs(torch_default.permute(0, 2, 3, 1).numpy()
                      .reshape(want.shape) - want).max() > 1e-3


def test_every_jax_module_has_a_counterpart():
    """The port holds a module for each of the JAX package's (the last
    one missing was ``ops/image.py``)."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent

    def modules(pkg):
        return {str(p.relative_to(root / pkg))
                for p in (root / pkg).rglob("*.py")}

    assert modules("domainrag_tpu") <= modules("domainrag_tpu_torch")

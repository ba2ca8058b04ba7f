"""The LayerNorm + AdaLN-modulation kernel's dispatch and launch contract,
on the CPU with the kernel library stubbed (no card, no nvcc).

- ``models.flux.model._ln_modulate`` keeps the plain pair
  ``_modulate(_ln_no_affine(x), shift, scale)`` bit for bit, and launches
  nothing, for a CPU tensor, an f32 one, one that records a gradient and
  any width, stride or alignment the kernel does not take.
- Where the card is stood in for (``adaln._on_card``), every input the
  kernel takes launches it once, through ``adaln_modulate`` with the
  tensors' own pointers and strides (a stand-in library reads them from
  memory and writes the plain pair's bits), and counts one launch.
- ``ln_modulate``'s argument checks raise before any library is loaded.
- The tiny Flux forward launches it 11 times (4 x 2 double blocks, 2
  single blocks, the output layer), and not at all under autograd.
"""

import ctypes

import numpy as np
import pytest
import torch

from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models.flux import model as fm
from domainrag_tpu_torch.ops import _build
from domainrag_tpu_torch.ops import adaln

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

STREAM = 0x7F00DEADBEEF       # a stream handle above 2^32
BF16 = torch.bfloat16


def _plain(x, shift, scale):
    return fm._modulate(fm._ln_no_affine(x), shift, scale)


def _read(ptr, shape, strides):
    """The bf16 tensor of ``shape`` at ``ptr`` with element ``strides``,
    copied out of memory."""
    extent = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    raw = np.ctypeslib.as_array((ctypes.c_uint16 * extent).from_address(ptr))
    view = np.lib.stride_tricks.as_strided(
        raw, shape, [2 * st for st in strides])
    return torch.from_numpy(view.astype(np.int16)).view(BF16)


class _Lib:
    """A stand-in ``libadaln``: ``adaln_modulate`` reads its operands
    through the pointers and strides it is given and writes the plain
    pair's bits into the contiguous ``out``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []
        self.adaln_modulate = _Fn(self._call)

    def _call(self, x, x_batch, x_row, shift, shift_batch, scale,
              scale_batch, out, b, s, h, eps, stream):
        self.calls.append((x_batch, x_row, shift_batch, scale_batch, b, s,
                           h, eps, stream))
        if self.rc:
            return self.rc
        xs = _read(x, (b, s, h), (x_batch, x_row, 1))
        sh = _read(shift, (b, h), (shift_batch, 1))
        sc = _read(scale, (b, h), (scale_batch, 1))
        y = adaln.modulate(adaln.ln_no_affine(xs, eps), sh, sc)
        dst = np.ctypeslib.as_array(
            (ctypes.c_uint16 * (b * s * h)).from_address(out))
        dst[:] = y.reshape(-1).view(torch.int16).numpy().view(np.uint16)
        return 0


class _Fn:
    """A library function: ctypes sets ``argtypes``/``restype`` on it."""

    def __init__(self, body):
        self.body = body
        self.argtypes = self.restype = None

    def __call__(self, *args):
        return self.body(*args)


@pytest.fixture
def card(monkeypatch):
    """The CPU standing in for the card, with a stand-in library; returns
    it."""
    lib = _Lib()
    monkeypatch.setattr(adaln, "_LIB", None)
    monkeypatch.setattr(adaln, "_on_card", lambda x: True)
    monkeypatch.setattr(adaln, "_stream", lambda x: STREAM)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    return lib


@pytest.fixture
def no_library(monkeypatch):
    """The CPU standing in for the card, with no library to load."""
    def refuse(name):
        raise AssertionError(f"library {name} loaded")
    monkeypatch.setattr(adaln, "_LIB", None)
    monkeypatch.setattr(adaln, "_on_card", lambda x: True)
    monkeypatch.setattr(_build, "load", refuse)


def _inputs(b=2, s=37, h=64, dtype=BF16, seed=0):
    """x with a non-zero mean, and shift / scale as the .chunk views of a
    (B, 6h) modulation, as the double block has them."""
    g = torch.Generator().manual_seed(seed)
    x = (3.0 * torch.randn(b, s, h, generator=g) + 0.5).to(dtype)
    mod = (0.5 * torch.randn(b, 6 * h, generator=g)).to(dtype)
    shift, scale = mod.chunk(6, dim=-1)[:2]
    return x, shift, scale


def test_cpu_tensor_keeps_the_plain_pair():
    x, shift, scale = _inputs()
    n = adaln.ln_modulate.launches
    assert not adaln.takes(x, shift, scale)
    got = fm._ln_modulate(x, shift, scale)
    assert adaln.ln_modulate.launches == n
    assert torch.equal(got, _plain(x, shift, scale))
    assert torch.equal(adaln.ln_modulate(x, shift, scale), got)


def _misaligned(b=2, s=37, h=64):
    x, shift, scale = _inputs(b, s, h)
    flat = torch.empty(x.numel() + 4, dtype=BF16)
    moved = flat[4:].view(b, s, h)           # 8 bytes past the base
    moved.copy_(x)
    return moved, shift, scale


def _lanes_strided():
    x, shift, scale = _inputs(h=64)
    return x.transpose(1, 2).contiguous().transpose(1, 2), shift, scale


REFUSED = {
    "f32": lambda: _inputs(dtype=torch.float32),
    "f32_modulation": lambda: (_inputs()[0],) + tuple(
        t.float() for t in _inputs()[1:]),
    "width_60": lambda: _inputs(h=60),
    "width_4104": lambda: _inputs(s=3, h=4104),
    "lanes_strided": _lanes_strided,
    "base_misaligned": _misaligned,
    "row_stride_not_8": lambda: (
        _inputs(h=68)[0][..., :64],) + _inputs()[1:],
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_the_kernel_refuses_keeps_the_plain_pair(no_library, case):
    x, shift, scale = REFUSED[case]()
    n = adaln.ln_modulate.launches
    assert adaln.unsupported(x, shift, scale) is not None
    assert not adaln.takes(x, shift, scale)
    got = fm._ln_modulate(x, shift, scale)
    assert adaln.ln_modulate.launches == n
    assert torch.equal(got, _plain(x, shift, scale))
    with pytest.raises(ValueError, match="ln_modulate"):
        adaln.ln_modulate(x, shift, scale)
    assert adaln._LIB is None


@pytest.mark.parametrize("which", ["x", "shift", "scale"])
def test_recorded_gradient_keeps_the_plain_pair(no_library, which):
    x, shift, scale = _inputs()
    args = {"x": x, "shift": shift.clone(), "scale": scale.clone()}
    args[which].requires_grad_(True)
    n = adaln.ln_modulate.launches
    got = fm._ln_modulate(args["x"], args["shift"], args["scale"])
    assert adaln.ln_modulate.launches == n
    assert got.requires_grad
    want = _plain(args["x"], args["shift"], args["scale"])
    assert torch.equal(got, want)
    got.float().square().sum().backward()
    assert args[which].grad is not None


def _final_slice():
    """The output layer's input: the image rows of the joint stream."""
    x, shift, scale = _inputs(b=3, s=50, h=64)
    return x[:, 11:], shift, scale


TAKEN = {
    "contiguous_modulation": lambda: tuple(
        t.contiguous() for t in _inputs()),
    "chunk_views": _inputs,
    "final_slice": _final_slice,
    "batch_1": lambda: _inputs(b=1, s=5),
    "ragged_rows": lambda: _inputs(b=3, s=13, h=136),
    "width_8": lambda: _inputs(s=4, h=8),
    "width_4096": lambda: _inputs(b=1, s=3, h=4096),
}


@pytest.mark.parametrize("case", sorted(TAKEN))
def test_taken_inputs_launch_once_with_their_strides(card, case):
    x, shift, scale = TAKEN[case]()
    assert adaln.takes(x, shift, scale)
    n = adaln.ln_modulate.launches
    got = fm._ln_modulate(x, shift, scale)
    assert adaln.ln_modulate.launches == n + 1
    (call,) = card.calls
    b, s, h = x.shape
    assert call == (x.stride(0), x.stride(1), shift.stride(0),
                    scale.stride(0), b, s, h, adaln.EPS, STREAM)
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    assert card.adaln_modulate.argtypes == [
        p, ll, ll, p, ll, p, ll, p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, p]
    assert card.adaln_modulate.restype is ctypes.c_int
    assert got.is_contiguous() and got.dtype == BF16
    assert torch.equal(got, _plain(x, shift, scale))


def test_gradient_off_launches(card):
    x, shift, scale = _inputs()
    x.requires_grad_(True)
    n = adaln.ln_modulate.launches
    with torch.no_grad():
        got = fm._ln_modulate(x, shift, scale)
    assert adaln.ln_modulate.launches == n + 1
    assert torch.equal(got, _plain(x.detach(), shift, scale))


def test_failed_launch_raises_and_counts_nothing(card):
    card.rc = 700
    n = adaln.ln_modulate.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        adaln.ln_modulate(*_inputs())
    assert adaln.ln_modulate.launches == n


def _tiny_forward(params, cfg, remat=False, seed=1):
    g = torch.Generator().manual_seed(seed)
    b, grid, s_txt = 2, 4, 7
    img = torch.randn(b, grid * grid, cfg.in_channels, generator=g)
    txt = torch.randn(b, s_txt, cfg.text_dim, generator=g)
    pooled = torch.randn(b, cfg.pooled_dim, generator=g)
    t = torch.tensor([0.7, 0.3])
    img_ids = torch.as_tensor(fm.make_image_ids(grid, grid))
    txt_ids = torch.as_tensor(fm.make_text_ids(s_txt))
    return fm.apply(params, img.to(BF16), txt.to(BF16), pooled.to(BF16), t,
                    img_ids, txt_ids, cfg, guidance=torch.tensor([2.5, 4.0]),
                    remat=remat)


def test_tiny_flux_forward_launches_11(monkeypatch):
    cfg = fm.TINY_FLUX
    params = fm.init(prng.PRNGKey(0), cfg, dtype=BF16)
    want = _tiny_forward(params, cfg)
    lib = _Lib()
    monkeypatch.setattr(adaln, "_LIB", None)
    monkeypatch.setattr(adaln, "_on_card", lambda x: True)
    monkeypatch.setattr(adaln, "_stream", lambda x: STREAM)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    n = adaln.ln_modulate.launches
    got = _tiny_forward(params, cfg)
    per_forward = 4 * cfg.depth_double + cfg.depth_single + 1
    assert per_forward == 11
    assert adaln.ln_modulate.launches == n + per_forward
    assert torch.equal(got, want)


def test_tiny_flux_training_forward_launches_nothing(no_library):
    cfg = fm.TINY_FLUX
    params = fm.init(prng.PRNGKey(0), cfg, dtype=BF16)
    leaves = []

    def grads_on(tree):
        if isinstance(tree, dict):
            return {k: grads_on(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [grads_on(v) for v in tree]
        leaves.append(tree.requires_grad_(True))
        return tree

    params = grads_on(params)
    n = adaln.ln_modulate.launches
    out = _tiny_forward(params, cfg, remat=True)
    out.float().square().mean().backward()
    assert adaln.ln_modulate.launches == n
    assert all(p.grad is not None for p in leaves
               if p.dtype == BF16 and p.dim() == 2)

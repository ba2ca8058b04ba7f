"""The VAE decode's memory-saving forms give the one-call decode's bits on
the CPU: its convolutions row strip by row strip (``vae._conv_rows``),
one image at a time (``pipeline._decode_tokens``), and the residual
block's activations and sum taken in place (``vae._resnet``,
``common.groupnorm``), in the forward and the gradient."""

import pytest
import torch
import torch.nn.functional as F

from domainrag_tpu_torch.core import prng
from domainrag_tpu_torch.models import common
from domainrag_tpu_torch.models.flux import model as fm
from domainrag_tpu_torch.models.flux import pipeline as fp
from domainrag_tpu_torch.models.flux import vae

# tiny shapes: one intra-op thread is fastest, and the test workers share
# the cores
torch.set_num_threads(1)

CFG = vae.TINY_VAE


@pytest.fixture(scope="module")
def params():
    return vae.init(prng.PRNGKey(3), CFG)


def _latents(b=3, h=16, w=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, h, w, CFG.latent_channels, generator=g)


@pytest.mark.parametrize("rows", [1, 8, 13, 31, 32])
def test_decode_in_row_strips_equals_one_call(params, monkeypatch, rows):
    lat = _latents()
    monkeypatch.setattr(vae, "DECODE_ROWS", 10 ** 6)
    want = vae.decode(params, lat, CFG)
    monkeypatch.setattr(vae, "DECODE_ROWS", rows)
    got = vae.decode(params, lat, CFG)
    assert got.shape == want.shape == (3, 32, 40, 3)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", [1, 3])
def test_conv_rows_equals_conv2d(monkeypatch, kernel):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 23, 9, 6, generator=g)
    p = {"w": torch.randn(5, 6, kernel, kernel, generator=g),
         "b": torch.randn(5, generator=g)}
    monkeypatch.setattr(vae, "DECODE_ROWS", 4)
    assert torch.equal(vae._conv_rows(p, x), common.conv2d(p, x))


def test_decode_tokens_one_image_at_a_time_equals_the_batch(params):
    lat = _latents(b=4, seed=2)
    tokens = fm.pack_latents(lat)
    got = fp._decode_tokens(params, tokens, 8, 10, CFG)
    assert torch.equal(got, vae.decode(params, lat, CFG))


def _groupnorm_out_of_place(p, x, groups, eps=1e-6):
    b, h, w, c = x.shape
    cg = c // groups
    xf = x.float().reshape(b, h, w, groups, cg)
    mean = xf.mean(dim=(1, 2, 4))
    m2 = xf.square().mean(dim=(1, 2, 4))
    var = torch.clamp(m2 - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    a = inv.repeat_interleave(cg, dim=-1) * p["scale"][None]
    off = p["bias"][None] - mean.repeat_interleave(cg, dim=-1) * a
    return (x.float() * a[:, None, None, :]
            + off[:, None, None, :]).to(x.dtype)


def _resnet_out_of_place(p, x, groups):
    gn = _groupnorm_out_of_place
    h = common.conv2d(p["conv1"], F.silu(gn(p["norm1"], x, groups)))
    h = common.conv2d(p["conv2"], F.silu(gn(p["norm2"], h, groups)))
    if "shortcut" in p:
        x = common.conv2d(p["shortcut"], x)
    return x + h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_in_place_equals_out_of_place(params, dtype):
    res = params["decoder"]["up"][-1]["res"][0]       # 16 -> 8: a shortcut
    assert "shortcut" in res
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 6, 7, 16, generator=g)
    cast = {k: {n: t.to(dtype) for n, t in v.items()} if "w" in v else v
            for k, v in res.items()}
    x = x.to(dtype)
    got = vae._resnet(cast, x, CFG.norm_groups)
    assert torch.equal(got, _resnet_out_of_place(cast, x, CFG.norm_groups))


def test_resnet_in_place_gradients(params):
    res = params["decoder"]["up"][-1]["res"][0]
    g = torch.Generator().manual_seed(5)
    x0 = torch.randn(2, 6, 7, 16, generator=g)
    grads = []
    for fn in (vae._resnet, _resnet_out_of_place):
        x = x0.clone().requires_grad_(True)
        w = res["conv1"]["w"].clone().requires_grad_(True)
        p = dict(res, conv1={"w": w, "b": res["conv1"]["b"]})
        fn(p, x, CFG.norm_groups).square().sum().backward()
        grads.append((x.grad, w.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])

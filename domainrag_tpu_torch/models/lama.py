"""LaMa FFC inpainting generator (port of ``domainrag_tpu/models/lama.py``).

The big-lama Fast Fourier Convolution ResNet generator that the reference
runs through ``simple_lama_inpainting.SimpleLama``
(lama_inpaint/lama_inpaint.py:5,103,185). Topology (big-lama):
reflect-pad 7x7 stem (4 input channels: masked RGB + mask), 3 stride-2
FFC downsamples (64->128->256->512; the global branch, ratio 0.75, enters
at the last one), N FFC resnet blocks at 512 with local/global residuals,
3 transposed-conv upsamples, 7x7 head + sigmoid.

The JAX package computes the spectral path and every conv in XLA, outside
any Pallas kernel, so here they are ``torch.fft`` (cuFFT on the card) and
``F.conv2d`` / ``F.conv_transpose2d`` (cuDNN): this module holds no
hand-written kernel. The FFT runs in f32 whatever the compute dtype.
Activations are NHWC at every function, conv weights (out, in, kh, kw)
as :mod:`models.common` takes them (the bridge turns JAX's HWIO once).

:func:`inpaint_image` reproduces the SimpleLama wrapper: pad the input to
a multiple of 8, normalize /255, binarize the mask, run, crop, scale back
to [0, 255].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from .common import (Params, batchnorm, batchnorm_init, conv2d,
                     conv2d_transpose, conv_init)


@dataclasses.dataclass(frozen=True)
class LamaConfig:
    ngf: int = 64
    n_downsampling: int = 3
    n_blocks: int = 18            # big-lama
    global_ratio: float = 0.75    # FFC alpha at the bottleneck
    in_channels: int = 4          # masked RGB + mask
    out_channels: int = 3

    @property
    def bottleneck(self) -> int:
        return self.ngf * 2 ** self.n_downsampling


TINY_LAMA = LamaConfig(ngf=8, n_downsampling=2, n_blocks=2)
BIG_LAMA = LamaConfig()


def _split(c: int, ratio: float) -> Tuple[int, int]:
    cg = int(c * ratio)
    return c - cg, cg            # (local, global)


# ---------------------------------------------------------------------------
# Fourier unit / spectral transform
# ---------------------------------------------------------------------------

def _fourier_unit_init(key, c_in: int, c_out: int) -> Params:
    return {"conv": conv_init(key, 1, 1, c_in * 2, c_out * 2, bias=False),
            "bn": batchnorm_init(c_out * 2, device=key.device)}


def fourier_unit(p: Params, x: torch.Tensor) -> torch.Tensor:
    """NHWC FFT conv: rfft2 (ortho) over H, W in f32 -> 1x1 conv over
    [real, imag] stacked on channels -> BN + ReLU -> irfft2 to (H, W)."""
    b, h, w, c = x.shape
    f = torch.fft.rfft2(x.float(), dim=(1, 2), norm="ortho")
    y = torch.cat([f.real, f.imag], dim=-1).to(x.dtype)    # (B, H, Wf, 2C)
    y = torch.relu(batchnorm(p["bn"], conv2d(p["conv"], y)))
    yr, yi = torch.chunk(y.float(), 2, dim=-1)
    out = torch.fft.irfft2(torch.complex(yr, yi), s=(h, w), dim=(1, 2),
                           norm="ortho")
    return out.to(x.dtype)


def _spectral_init(key, c_in: int, c_out: int) -> Params:
    k1, k2, k3 = prng.split(key, 3)
    mid = c_out // 2
    return {
        "conv1": conv_init(k1, 1, 1, c_in, mid, bias=False),
        "bn1": batchnorm_init(mid, device=key.device),
        "fu": _fourier_unit_init(k2, mid, mid),
        "conv2": conv_init(k3, 1, 1, mid, c_out, bias=False),
    }


def spectral_transform(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(batchnorm(p["bn1"], conv2d(p["conv1"], x)))
    out = fourier_unit(p["fu"], x)
    return conv2d(p["conv2"], x + out)


# ---------------------------------------------------------------------------
# FFC conv block
# ---------------------------------------------------------------------------

def _ffc_init(key, c_in: int, c_out: int, kernel: int,
              ratio_in: float, ratio_out: float) -> Params:
    """``split(key, 4)``, one key per branch; a branch that a ratio of 0
    leaves out leaves its key unused."""
    in_l, in_g = _split(c_in, ratio_in)
    out_l, out_g = _split(c_out, ratio_out)
    ks = prng.split(key, 4)
    p: Params = {}
    if in_l and out_l:
        p["l2l"] = conv_init(ks[0], kernel, kernel, in_l, out_l, bias=False)
    if in_l and out_g:
        p["l2g"] = conv_init(ks[1], kernel, kernel, in_l, out_g, bias=False)
    if in_g and out_l:
        p["g2l"] = conv_init(ks[2], kernel, kernel, in_g, out_l, bias=False)
    if in_g and out_g:
        p["g2g"] = _spectral_init(ks[3], in_g, out_g)
    if out_l:
        p["bn_l"] = batchnorm_init(out_l, device=key.device)
    if out_g:
        p["bn_g"] = batchnorm_init(out_g, device=key.device)
    return p


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad H and W of NHWC data (on its NCHW view)."""
    if pad == 0:
        return x
    return F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
                 mode="reflect").permute(0, 2, 3, 1)


def ffc_bn_act(p: Params, xl: torch.Tensor, xg: Optional[torch.Tensor],
               stride: int = 1, pad: int = 1, reflect: bool = False
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One FFC + BN + ReLU. xl/xg are the local/global branches; the
    branch sums run in the JAX package's order (l2l + g2l, l2g + g2g)."""
    def run_conv(w, x):
        if reflect:
            return conv2d(w, _reflect_pad(x, pad), stride=stride,
                          padding="VALID")
        return conv2d(w, x, stride=stride, padding=((pad, pad), (pad, pad)))

    out_l = None
    out_g = None
    if "l2l" in p:
        out_l = run_conv(p["l2l"], xl)
    if "g2l" in p and xg is not None:
        gl = run_conv(p["g2l"], xg)
        out_l = gl if out_l is None else out_l + gl
    if "l2g" in p:
        out_g = run_conv(p["l2g"], xl)
    if "g2g" in p and xg is not None:
        gg = spectral_transform(p["g2g"], xg)
        out_g = gg if out_g is None else out_g + gg
    if out_l is not None:
        out_l = torch.relu(batchnorm(p["bn_l"], out_l))
    if out_g is not None:
        out_g = torch.relu(batchnorm(p["bn_g"], out_g))
    return out_l, out_g


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------

def init(key, cfg: LamaConfig = BIG_LAMA) -> Params:
    """JAX's tree, drawn from ``iter(split(key, 8 + n_downsampling + 2 *
    n_blocks))`` in JAX's order on the key's device (batchnorm at
    identity statistics). The up convs' (kh, kw, c_in, c_out) draws are
    kept as (c_out, c_in, kh, kw), unflipped, as ``bridge`` keeps JAX's."""
    ks = iter(prng.split(prng.check_key(key, "init"),
                         8 + cfg.n_downsampling + 2 * cfg.n_blocks))
    ngf, nd, ratio = cfg.ngf, cfg.n_downsampling, cfg.global_ratio
    params: Params = {
        "stem": _ffc_init(next(ks), cfg.in_channels, ngf, 7, 0.0, 0.0),
        "down": [],
        "blocks": [],
        "up": [],
    }
    for i in range(nd):
        c_in = ngf * 2 ** i
        c_out = ngf * 2 ** (i + 1)
        r_out = ratio if i == nd - 1 else 0.0
        params["down"].append(_ffc_init(next(ks), c_in, c_out, 3, 0.0,
                                        r_out))
    feat = cfg.bottleneck
    for _ in range(cfg.n_blocks):
        params["blocks"].append({
            "conv1": _ffc_init(next(ks), feat, feat, 3, ratio, ratio),
            "conv2": _ffc_init(next(ks), feat, feat, 3, ratio, ratio),
        })
    for i in range(nd):
        c_in = ngf * 2 ** (nd - i)
        c_out = ngf * 2 ** (nd - i - 1)
        params["up"].append({
            "conv": conv_init(next(ks), 3, 3, c_in, c_out),
            "bn": batchnorm_init(c_out, device=key.device),
        })
    params["head"] = conv_init(next(ks), 7, 7, ngf, cfg.out_channels)
    return params


def apply(params: Params, image: torch.Tensor, mask: torch.Tensor,
          cfg: LamaConfig = BIG_LAMA) -> torch.Tensor:
    """image (B, H, W, 3) in [0, 1]; mask (B, H, W, 1) binary {0, 1}
    (1 = inpaint). H, W must be multiples of 8. Returns (B, H, W, 3) in
    [0, 1]."""
    masked = image * (1.0 - mask)
    x = torch.cat([masked, mask], dim=-1)

    xl, xg = ffc_bn_act(params["stem"], _reflect_pad(x, 3), None,
                        stride=1, pad=0)
    for down in params["down"]:
        xl, xg = ffc_bn_act(down, xl, xg, stride=2, pad=1)
    for block in params["blocks"]:
        rl, rg = xl, xg
        yl, yg = ffc_bn_act(block["conv1"], xl, xg, pad=1, reflect=True)
        yl, yg = ffc_bn_act(block["conv2"], yl, yg, pad=1, reflect=True)
        xl = rl + yl
        xg = rg + yg if rg is not None and yg is not None else rg
    x = xl if xg is None else torch.cat([xl, xg], dim=-1)
    for up in params["up"]:
        x = conv2d_transpose(up["conv"], x, stride=2)
        x = torch.relu(batchnorm(up["bn"], x))
    x = _reflect_pad(x, 3)
    x = conv2d(params["head"], x, padding="VALID")
    return torch.sigmoid(x)


# ---------------------------------------------------------------------------
# SimpleLama-compatible host wrapper
# ---------------------------------------------------------------------------

def pad_to_multiple(h: int, w: int, multiple: int = 8) -> Tuple[int, int]:
    return (math.ceil(h / multiple) * multiple,
            math.ceil(w / multiple) * multiple)


@torch.inference_mode()
def inpaint_image(params: Params, image_u8: np.ndarray, mask_u8: np.ndarray,
                  cfg: LamaConfig = BIG_LAMA,
                  apply_fn=None) -> np.ndarray:
    """SimpleLama semantics: uint8 RGB (H, W, 3) + uint8 mask (H, W,
    255 = remove) -> uint8 RGB. Pads to /8, runs the net on the weights'
    device, crops back. ``apply_fn(image, mask)`` replaces the forward."""
    h, w = image_u8.shape[:2]
    ph, pw = pad_to_multiple(h, w)
    img = np.zeros((ph, pw, 3), np.float32)
    img[:h, :w] = image_u8.astype(np.float32) / 255.0
    msk = np.zeros((ph, pw, 1), np.float32)
    msk[:h, :w, 0] = (mask_u8.astype(np.float32) > 127).astype(np.float32)
    fn = apply_fn if apply_fn is not None else (
        lambda i, m: apply(params, i, m, cfg))
    dev = params["head"]["w"].device
    out = fn(torch.from_numpy(img[None]).to(dev),
             torch.from_numpy(msk[None]).to(dev))
    out = out[0].float().cpu().numpy()[:h, :w]
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)

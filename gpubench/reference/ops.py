"""The reference's few operations, and the precision it computes in.

Every product (linear, convolution, attention's two products) goes
through :func:`operand`, so the controls can put the reference in the
program's place one precision lower: ``tf32`` (TF32 tensor cores, for
a float32 stage), ``fp8`` (operands rounded to float8 e4m3 with a
per-tensor scale, for a bfloat16 stage) or ``int4`` (operands rounded to
symmetric int4, [-7, 7], with a scale per token of an activation and
per output channel of a weight, for an int8 stage). ``f32`` is the
reference.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_MODE = "f32"
FP8_MAX = 448.0
INT4_MAX = 7.0


@contextlib.contextmanager
def precision(mode: str):
    """Compute the reference in ``mode`` inside the block."""
    global _MODE
    if mode not in ("f32", "tf32", "fp8", "int4"):
        raise ValueError(mode)
    saved = (_MODE, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    _MODE = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        (_MODE, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def operand(x: torch.Tensor, dim=-1) -> torch.Tensor:
    """An f32 operand of a product, rounded as the mode says. ``dim``: the
    axis (or axes) the product contracts, over which ``int4`` takes each
    scale (None: one scale for the tensor)."""
    x = x.float()
    if _MODE == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    if _MODE == "int4":
        amax = x.abs().amax() if dim is None \
            else x.abs().amax(dim, keepdim=True)
        scale = amax.clamp_min(1e-30) / INT4_MAX
        return torch.round(x / scale).clamp(-INT4_MAX, INT4_MAX) * scale
    return x


def linear(w: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
    """torch ``Linear`` ``{prefix}.weight`` (out, in) [+ bias], f32."""
    y = torch.matmul(operand(x), operand(w[f"{prefix}.weight"]).t())
    b = w.get(f"{prefix}.bias")
    return y if b is None else y + b.float()


def conv(w: dict, prefix: str, x: torch.Tensor, stride: int = 1,
         padding=1) -> torch.Tensor:
    """NCHW convolution with ``{prefix}.weight`` (out, in, kh, kw)."""
    b = w.get(f"{prefix}.bias")
    return F.conv2d(operand(x, None), operand(w[f"{prefix}.weight"],
                                              (1, 2, 3)),
                    None if b is None else b.float(), stride=stride,
                    padding=padding)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-6):
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y


def rms_norm(x, weight, eps: float = 1e-6):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * weight.float()


def group_norm(x, weight, bias, groups: int, eps: float = 1e-6):
    """NCHW group norm, f32 statistics."""
    b, c, h, w_ = x.shape
    xg = x.float().reshape(b, groups, -1)
    mean = xg.mean(-1, keepdim=True)
    var = (xg - mean).square().mean(-1, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w_)
    return y * weight.float()[None, :, None, None] \
        + bias.float()[None, :, None, None]


def attention(q, k, v, scale: float, mask=None, bias=None,
              head_chunk: int = 4) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v over (B, H, S, D), f32, a row and
    a few heads at a time so the scores fit. ``mask`` (Sq, Sk) bool: True
    attends; ``bias`` (1 or B, H, Sq, Sk)."""
    out = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=torch.float32,
                      device=q.device)
    for r in range(q.shape[0]):
        for h0 in range(0, q.shape[1], head_chunk):
            hs = slice(h0, h0 + head_chunk)
            s = torch.matmul(operand(q[r, hs]),
                             operand(k[r, hs]).transpose(-1, -2)) \
                * scale
            if bias is not None:
                s = s + bias[0 if bias.shape[0] == 1 else r, hs].float()
            if mask is not None:
                s = s.masked_fill(~mask, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out[r, hs] = torch.matmul(operand(p),
                                      operand(v[r, hs], -2))
            del s, p
    return out


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def sdpa_scale(head_dim: int) -> float:
    return 1.0 / math.sqrt(head_dim)

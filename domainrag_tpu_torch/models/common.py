"""Shared functional building blocks (port of
``domainrag_tpu/models/common.py``).

Models are plain functions over nested param dicts with the JAX package's
keys: ``init(key, cfg) -> params``, ``key`` a ``core.prng`` key split and
drawn as the JAX init splits and draws it, and ``apply(params, x, ...)``.
Linear weights keep the ``(in, out)`` layout; convolution weights are in
torch's ``(out, in, kh, kw)`` layout (the bridge converts HWIO once) while
activations stay NHWC at every public function. Weights may be stored in
the dtype they are cast to at use; norm scales stay float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import prng
from ..ops.int8_gemm import w8a8_linear

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# checkpoint tensors (the converters of models/*.py and models/convert.py)
# ---------------------------------------------------------------------------

def leaves(tree) -> list:
    """The tensors of a param tree, in the tree's order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def ckpt_tensor(x, device: torch.device, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """A checkpoint tensor (torch, e.g. a view of a mapped safetensors
    file, or numpy) on ``device`` in ``dtype``: moved at its own width
    first and cast there, so the host holds no widened copy."""
    # always a copy: the source may be a read-only file mapping
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True).to(dtype)
    return torch.from_numpy(np.array(x)).to(device).to(dtype)


class RenamedKeys:
    """A state dict seen under its keys with ``prefix`` removed, read on
    demand (a lazy checkpoint stays lazy); where two keys collide, the
    later one wins, as in a dict built from the stripped keys."""

    def __init__(self, state_dict, prefix: str):
        self._sd = state_dict
        self._keys = {k.removeprefix(prefix): k for k in state_dict.keys()}

    def __contains__(self, key) -> bool:
        return key in self._keys

    def __getitem__(self, key):
        return self._sd[self._keys[key]]


def ckpt_linear(sd, prefix: str, device: torch.device,
                dtype: torch.dtype = torch.float32) -> Params:
    """torch ``Linear`` ``{prefix}.weight`` (out, in) [+ ``.bias``] ->
    ``{"w": (in, out)[, "b"]}``."""
    p = {"w": ckpt_tensor(sd[f"{prefix}.weight"], device, dtype).t()
         .contiguous()}
    if f"{prefix}.bias" in sd:
        p["b"] = ckpt_tensor(sd[f"{prefix}.bias"], device, dtype)
    return p


# ---------------------------------------------------------------------------
# initializers: the JAX package's, drawn through core.prng
# ---------------------------------------------------------------------------
#
# Each init takes a ``core.prng`` key where JAX's takes its PRNG key,
# splits it as JAX's does and draws each leaf with ``prng.normal`` in
# JAX's shape, on the key's device: the same key gives JAX's tree (f32
# normals within the ulp or two of ``prng.normal``). A port-only
# ``dtype=`` stores the weights rounded from JAX's f32 leaf.

def _draw(key, shape, std: float, dtype: torch.dtype,
          draw_dtype: torch.dtype = torch.float32, oihw: bool = False
          ) -> torch.Tensor:
    """The one draw of every random leaf: ``normal(key, shape,
    draw_dtype) * std`` in ``draw_dtype``, stored in ``dtype``; a 4-D
    HWIO draw turned to OIHW with ``oihw``."""
    x = prng.normal(key, shape, draw_dtype) * torch.tensor(
        std, dtype=draw_dtype, device=key.device)
    if oihw:
        x = x.permute(3, 2, 0, 1).contiguous()
    return x.to(dtype)


def normal_init(key, shape, std=0.02, dtype=torch.float32) -> torch.Tensor:
    """``normal(key, shape, dtype) * std``, in ``dtype`` as JAX's."""
    return _draw(prng.check_key(key, "normal_init"), shape, std, dtype,
                 dtype)


def lecun_init(key, shape, fan_in, dtype=torch.float32) -> torch.Tensor:
    key = prng.check_key(key, "lecun_init")
    return normal_init(key, shape, math.sqrt(1.0 / fan_in), dtype)


def linear_init(key, d_in: int, d_out: int, bias: bool = True,
                std: Optional[float] = None, *,
                dtype: torch.dtype = torch.float32) -> Params:
    key = prng.check_key(key, "linear_init")
    if std is None:
        std = math.sqrt(1.0 / d_in)
    kw, _ = prng.split(key)
    p = {"w": _draw(kw, (d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=key.device)
    return p


def _f32(fill: float, dim: int, device) -> torch.Tensor:
    """A (dim,) f32 norm leaf on ``device``, or on torch's default device
    without one (as the JAX norm inits land on JAX's)."""
    return torch.full((dim,), fill, dtype=torch.float32, device=device)


def layernorm_init(dim: int, *, device=None) -> Params:
    return {"scale": _f32(1.0, dim, device), "bias": _f32(0.0, dim, device)}


def rmsnorm_init(dim: int, *, device=None) -> Params:
    return {"scale": _f32(1.0, dim, device)}


def groupnorm_init(dim: int, *, device=None) -> Params:
    return layernorm_init(dim, device=device)


def conv_init(key, kh: int, kw: int, c_in: int, c_out: int,
              bias: bool = True, groups: int = 1) -> Params:
    """JAX's HWIO draw (kh, kw, c_in // groups, c_out) with std
    sqrt(1/fan_in), fan-in that of one group, turned to torch's (out,
    in // groups, kh, kw) as ``bridge`` turns a JAX kernel."""
    key = prng.check_key(key, "conv_init")
    fan_in = kh * kw * (c_in // groups)
    p = {"w": _draw(key, (kh, kw, c_in // groups, c_out),
                    math.sqrt(1.0 / fan_in), torch.float32, oihw=True)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=torch.float32,
                             device=key.device)
    return p


def batchnorm_init(dim: int, *, device=None) -> Params:
    """Inference-mode batchnorm (running statistics)."""
    return {"scale": _f32(1.0, dim, device), "bias": _f32(0.0, dim, device),
            "mean": _f32(0.0, dim, device), "var": _f32(1.0, dim, device)}


def mha_init(key, dim: int, bias: bool = True) -> Params:
    ks = prng.split(prng.check_key(key, "mha_init"), 4)
    return {name: linear_init(k, dim, dim, bias=bias)
            for name, k in zip(("q", "k", "v", "o"), ks)}


# ---------------------------------------------------------------------------
# dense ops
# ---------------------------------------------------------------------------

# Serving mode (models.quant): when on, quantized linears also quantize
# their activations per token to int8 and run the exact int8 product (W8A8,
# the B4 kernel on the card). A process-wide mode, read at every call, as
# the JAX package's trace-time flag (common.py:44-62).
_INT8_ACTIVATIONS = False


def set_int8_activations(enabled: bool) -> None:
    global _INT8_ACTIVATIONS
    _INT8_ACTIVATIONS = bool(enabled)


def int8_activations_enabled() -> bool:
    return _INT8_ACTIVATIONS


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b) in x's dtype, with the three paths of the JAX
    ``common.linear`` (:69-104):

    - dense ``{"w"}``: a plain GEMM, which the JAX package left to XLA, so
      here ``torch.matmul`` (f32 accumulation inside);
    - quantized ``{"w_q", "w_s"}`` (``w_q`` K-major, (out, in)),
      weight-only int8: ``(x @ w_q.to(x.dtype).T) * w_s.to(x.dtype)``,
      XLA in the JAX package and ``torch.matmul`` here;
    - quantized under :func:`set_int8_activations`, W8A8:
      :func:`ops.int8_gemm.w8a8_linear` (bias added in its epilogue)."""
    if "w_q" in p:
        if _INT8_ACTIVATIONS:
            return w8a8_linear(x, p["w_q"], p["w_s"], p.get("b"))
        y = torch.matmul(x, p["w_q"].to(x.dtype).t()) * p["w_s"].to(x.dtype)
    else:
        y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def linear_widths(p: Params) -> Tuple[int, int]:
    """(in, out) features of a linear's params, dense or K-major int8."""
    if "w_q" in p:
        return p["w_q"].shape[1], p["w_q"].shape[0]
    return p["w"].shape[0], p["w"].shape[1]


def linear_row_sharded(p: Params, x: torch.Tensor, mesh,
                       axis: str) -> torch.Tensor:
    """:func:`linear` of a row-sharded layer under tensor parallelism:
    ``x`` holds this rank's share of the contraction dim and ``p`` the
    matching rows of ``w`` (columns of the K-major ``w_q``) and the whole
    bias. The ranks' partial products are summed over ``axis`` of
    ``mesh``, then the bias is added once. Under W8A8 the activations
    quantize with the amax of the whole row (an all-reduce of the max, as
    GSPMD reduces the JAX ``quantize_rowwise``), B4 writes each rank's
    partial in f32, and the partials are summed before the rounding to
    x's dtype. The sum is ``parallel.mesh.reduce_from``, whose gradient
    passes to every rank's partial unchanged, so the layer trains."""
    from ..parallel.mesh import reduce_from
    if "w_q" in p and _INT8_ACTIVATIONS:
        y = w8a8_linear(x, p["w_q"], p["w_s"],
                        row_max=lambda a: mesh.all_reduce(a, axis, "max"),
                        out_dtype=torch.float32)
        y = reduce_from(mesh, y, axis).to(x.dtype)
    else:
        y = reduce_from(mesh, linear({k: v for k, v in p.items()
                                      if k != "b"}, x), axis)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def linear_col_sharded(p: Params, x: torch.Tensor, mesh,
                       axis: str) -> torch.Tensor:
    """:func:`linear` of a column-sharded layer under tensor parallelism:
    ``x`` is whole on every rank and ``p`` holds this rank's output
    columns. ``x`` enters through ``parallel.mesh.copy_to``, which sums
    its gradient over ``axis``: each rank's holds only the part that
    flows back from its own columns."""
    from ..parallel.mesh import copy_to
    return linear(p, copy_to(mesh, x, axis))


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm with f32 statistics regardless of compute dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """OpenAI CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# conv / norm (NHWC at the API)
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding="SAME", groups: int = 1) -> torch.Tensor:
    """NHWC conv with an (out, in // groups, kh, kw) weight. ``padding`` is
    "SAME", "VALID" or explicit ((top, bottom), (left, right)). The NCHW
    view of NHWC data is channels-last, so cuDNN runs it without a
    copy."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    if padding == "SAME":
        padding = (_same_pads(x.shape[1], kh, stride),
                   _same_pads(x.shape[2], kw, stride))
    elif padding == "VALID":
        padding = ((0, 0), (0, 0))
    (t, b), (l, r) = padding
    xn = x.permute(0, 3, 1, 2)
    if t == b and l == r:
        y = F.conv2d(xn, w, stride=stride, padding=(t, l), groups=groups)
    else:
        y = F.conv2d(F.pad(xn, (l, r, t, b)), w, stride=stride,
                     groups=groups)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _transpose_pads(k: int, stride: int, padding: str):
    """``lax.conv_transpose``'s (before, after) padding of the
    stride-dilated input for a string ``padding``."""
    if padding == "SAME":
        pad_len = k + stride - 2
        before = k - 1 if stride > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + stride - 2 + max(k - stride, 0)
        before = k - 1
    else:
        raise ValueError(f"padding must be SAME or VALID, not {padding!r}")
    return before, pad_len - before


def conv2d_transpose(p: Params, x: torch.Tensor, stride: int = 2,
                     padding="SAME") -> torch.Tensor:
    """NHWC transposed conv with the semantics of the JAX package's
    ``conv2d_transpose`` (``lax.conv_transpose`` with its default
    ``transpose_kernel=False``): the input dilated by ``stride``, padded
    (before, after) per spatial axis (for "SAME" at kernel 3 and stride 2
    that is (2, 1)), then correlated with the kernel AS GIVEN, unflipped.
    The weight is the bridge's OIHW of the JAX HWIO kernel, (out, in, kh,
    kw), as :func:`conv2d` takes it.

    Computed as ``F.conv_transpose2d``, which flips its kernel and reads
    it as (in, out, kh, kw): it gets ``w`` with its first two axes swapped
    and both spatial axes flipped, which undoes the flip. Its symmetric
    ``padding = k - 1 - before`` pads ``before`` on both sides of the
    dilated input; an ``after`` below ``before`` is cropped from the end
    of the output, and one above it is ``output_padding``.
    ``padding`` is "SAME", "VALID" or explicit ((top, bottom), (left,
    right)) pads of the dilated input."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    if isinstance(padding, str):
        padding = (_transpose_pads(kh, stride, padding),
                   _transpose_pads(kw, stride, padding))
    sym, extra = [], []
    for k, (before, after) in zip((kh, kw), padding):
        if not 0 <= before <= k - 1 or after - before >= stride:
            raise ValueError(f"unsupported transpose padding {padding}")
        sym.append(k - 1 - before)
        extra.append(after - before)
    y = F.conv_transpose2d(
        x.permute(0, 3, 1, 2), w.transpose(0, 1).flip(2, 3), stride=stride,
        padding=tuple(sym), output_padding=tuple(max(e, 0) for e in extra))
    crop_h, crop_w = (min(e, 0) for e in extra)
    y = y[:, :, :y.shape[2] + crop_h or None, :y.shape[3] + crop_w or None]
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def groupnorm(p: Params, x: torch.Tensor, groups: int = 32,
              eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NHWC with f32 statistics: mean and E[x^2] in one
    reduction, then one per-channel affine y = x * a + b (the JAX
    package's single-reduction formulation)."""
    b, h, w, c = x.shape
    cg = c // groups
    xf = x.float().reshape(b, h, w, groups, cg)
    mean = xf.mean(dim=(1, 2, 4))                            # (B, G)
    m2 = xf.square().mean(dim=(1, 2, 4))
    var = torch.clamp(m2 - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(cg, dim=-1)                # (B, C)
    mean_c = mean.repeat_interleave(cg, dim=-1)
    a = inv_c * p["scale"][None]
    off = p["bias"][None] - mean_c * a
    y = x.float() * a[:, None, None, :]
    y += off[:, None, None, :]           # in place: one temporary fewer
    return y.to(x.dtype)


def batchnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference batchnorm over the last (channel) axis, in f32."""
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return ((x.float() - p["mean"]) * inv + p["bias"]).to(x.dtype)


def max_pool(x: torch.Tensor, window: int, stride: int, padding
             ) -> torch.Tensor:
    """NHWC max pool; ``padding`` explicit ((t, b), (l, r)) or "VALID".
    Pads with -inf (torch's ``MaxPool2d`` semantics)."""
    xn = x.permute(0, 3, 1, 2)
    if padding != "VALID":
        (t, b), (l, r) = padding
        xn = F.pad(xn, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(xn, window, stride).permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, window: int, stride: int,
             padding="VALID") -> torch.Tensor:
    """NHWC average pool as the JAX ``lax.reduce_window`` sum makes it:
    "SAME" pads zeros (the extra one after, at an odd total) and every
    window is divided by ``window**2``, padding included."""
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (t, b), (l, r) = (_same_pads(x.shape[1], window, stride),
                          _same_pads(x.shape[2], window, stride))
        xn = F.pad(xn, (l, r, t, b))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, not {padding!r}")
    s = F.avg_pool2d(xn, window, stride, divisor_override=1)
    return (s / (window * window)).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# attention (dense; f32 softmax)
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def sdpa(q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, H, S, Dh); f32 softmax."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs.to(q.dtype), v)


def mha(p: Params, x: torch.Tensor, n_heads: int, mask=None,
        attn_fn=None) -> torch.Tensor:
    """``attn_fn(q, k, v, mask)`` over (B, H, S, Dh) replaces :func:`sdpa`
    when given."""
    q = split_heads(linear(p["q"], x), n_heads)
    k = split_heads(linear(p["k"], x), n_heads)
    v = split_heads(linear(p["v"], x), n_heads)
    fn = attn_fn if attn_fn is not None else sdpa
    return linear(p["o"], merge_heads(fn(q, k, v, mask)))


def causal_mask(seq: int, *, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((1, 1, seq, seq), dtype=torch.bool,
                                 device=device))


def count_params(params) -> int:
    """The number of elements in every tensor leaf of a param tree."""
    return sum(math.prod(t.shape) for t in leaves(params)
               if hasattr(t, "shape"))

"""Weight-only int8 quantization for serving (port of
``domainrag_tpu/models/quant.py``).

Per-output-channel symmetric int8 for every large linear weight:
``w ~ diag(w_s) w_q`` with ``w_s = max|w_col| / 127``. Quantized leaves
keep the JAX package's keys ``{"w_q", "w_s"[, "b"]}``, but ``w_q`` is
K-major, ``(out, in)``: the transpose of the JAX package's ``(in, out)``
``w_q``, because the B4 kernel's ``wgmma`` reads 8-bit operands only
K-major. :func:`domainrag_tpu_torch.bridge.params` transposes a
JAX-quantized ``w_q`` as it carries it across, so that tree is the same
tree this module makes, and no second copy of the weight is kept.
:func:`models.common.linear` runs such leaves: weight-only int8 by
default, W8A8 (the B4 kernel on the card) under
``common.set_int8_activations(True)``.
"""

from __future__ import annotations

from typing import Any

import torch

from ..ops.int8_gemm import div127


def quantize_linear(p: dict) -> dict:
    """{"w": (in, out) [, "b"]} -> {"w_q": int8 (out, in), "w_s": f32
    (out,) [, "b"]}, computed in f32 on the weight's own device from
    whatever dtype it is stored in; the bias tensor is reused as is."""
    w = p["w"].float()
    scale = div127(w.abs().amax(dim=0))
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    out = {"w_q": w_q.t().contiguous(), "w_s": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _is_linear_leaf(node: Any) -> bool:
    return (isinstance(node, dict) and "w" in node
            and isinstance(node["w"], torch.Tensor) and node["w"].dim() == 2)


def quantize_tree(params: Any, min_size: int = 1 << 16) -> Any:
    """A new tree with every linear whose weight has >= ``min_size``
    elements quantized (small layers stay in their dtype)."""
    if _is_linear_leaf(params) and params["w"].numel() >= min_size:
        return quantize_linear(params)
    if isinstance(params, dict):
        return {k: quantize_tree(v, min_size) for k, v in params.items()}
    if isinstance(params, list):
        return [quantize_tree(v, min_size) for v in params]
    return params


def quantized_bytes(params: Any) -> int:
    """Bytes of every tensor leaf of the tree."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0

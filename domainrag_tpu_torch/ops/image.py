"""Image ops on the device: resize, box-mask rasterization, compositing
(port of ``domainrag_tpu/ops/image.py``).

Plain torch on any device, as the JAX module is plain ``jnp`` (it reaches
no kernel). Host PIL stays authoritative where bit-parity feeds retrieval
(``core.imaging`` and the native resampler); these run on tensors already
on the card, e.g. a batch of box masks at once.

The resizes are ``jax.image.resize``'s, not ``F.interpolate``'s: the JAX
function takes the Keys cubic kernel with a = -0.5 (``F.interpolate``'s
bicubic uses a = -0.75) and the triangle for linear, samples at
half-pixel centres, and on a downscale widens the kernel by the scale and
normalises the weights (antialiasing, which ``F.interpolate`` does not do
by default). So each resized axis gets the weight matrix that
``jax.image.scale_and_translate`` builds (``compute_weight_mat``), and
the image is contracted with it.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _weight_mat(in_size: int, out_size: int, kernel: Callable,
                device) -> torch.Tensor:
    """(in_size, out_size) f32 weights of one axis (JAX's
    ``compute_weight_mat`` at translation 0 with antialiasing)."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(out_size, **f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, **f32)[:, None]).abs() \
        / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def _resize(image: torch.Tensor, out_h: int, out_w: int,
            kernel: Callable) -> torch.Tensor:
    if not image.is_floating_point():
        image = image.float()
    out = image
    for dim, size in ((image.dim() - 3, out_h), (image.dim() - 2, out_w)):
        if out.shape[dim] == size:
            continue            # JAX skips an axis that keeps its size
        w = _weight_mat(out.shape[dim], size, kernel, image.device)
        out = torch.tensordot(out.movedim(dim, -1), w.to(out.dtype),
                              dims=1).movedim(-1, dim)
    return out


def resize_bicubic(image: torch.Tensor, out_h: int, out_w: int
                   ) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C), cubic interpolation
    (``jax.image.resize`` "cubic": Keys, a = -0.5, antialiased on
    downscale; the same family as PIL's bicubic, not bit-identical to it:
    use the native resampler where that matters)."""
    return _resize(image, out_h, out_w, _keys_cubic)


def resize_bilinear(image: torch.Tensor, out_h: int, out_w: int
                    ) -> torch.Tensor:
    """(..., H, W, C) -> (..., out_h, out_w, C), linear interpolation
    (``jax.image.resize`` "linear": the triangle, antialiased on
    downscale)."""
    return _resize(image, out_h, out_w, _triangle)


def boxes_mask(height: int, width: int, bboxes,
               n_valid: Optional[int] = None,
               inside_value: float = 1.0,
               outside_value: float = 0.0) -> torch.Tensor:
    """Rasterize a union of boxes.

    bboxes: (N, 4) float [x, y, w, h] (a fixed-size, possibly padded
    buffer: pass ``n_valid`` to ignore the tail), a tensor (its device is
    the mask's) or anything ``torch.as_tensor`` takes. PIL-inclusive fill
    semantics, to match ``core.imaging.inpaint_mask_from_bboxes``.
    Returns (height, width) f32."""
    boxes = torch.as_tensor(bboxes, dtype=torch.float32).reshape(-1, 4)
    dev = boxes.device
    ys = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    x, y, w, h = (boxes[:, i, None, None] for i in range(4))
    x0, y0 = x.clamp(min=0.0), y.clamp(min=0.0)
    x1 = torch.minimum(torch.full_like(x0, float(width)), x0 + w)
    y1 = torch.minimum(torch.full_like(y0, float(height)), y0 + h)
    valid = (x1 > x0) & (y1 > y0)
    xi1 = torch.minimum(x1.floor(), torch.full_like(x1, width - 1.0))
    yi1 = torch.minimum(y1.floor(), torch.full_like(y1, height - 1.0))
    masks = ((ys >= y0.floor()) & (ys <= yi1) & (xs >= x0.floor())
             & (xs <= xi1) & valid)                    # (N, H, W)
    if n_valid is not None:
        idx = torch.arange(boxes.shape[0], device=dev)
        masks = masks & (idx < int(n_valid))[:, None, None]
    union = masks.any(dim=0)
    return torch.where(union, torch.tensor(float(inside_value), device=dev),
                       torch.tensor(float(outside_value), device=dev))


def composite(foreground: torch.Tensor, background: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """mask == 1 keeps the foreground, 0 takes the background. mask (H, W)
    or broadcastable; images (..., H, W, C)."""
    m = mask[..., None] if mask.dim() == foreground.dim() - 1 else mask
    return foreground * m + background * (1.0 - m)


def paste_box(canvas: torch.Tensor, patch: torch.Tensor, y: int, x: int
              ) -> torch.Tensor:
    """``patch`` pasted into a copy of ``canvas`` (H, W, C) or
    (B, H, W, C) with its top-left corner at (y, x), as
    ``jax.lax.dynamic_update_slice`` places it: a negative start counts
    from the end, and the start is clamped so that the patch fits."""
    out = canvas.clone()
    h, w = canvas.shape[-3], canvas.shape[-2]
    ph, pw = patch.shape[-3], patch.shape[-2]
    y, x = int(y) + (h if y < 0 else 0), int(x) + (w if x < 0 else 0)
    y = min(max(y, 0), h - ph)
    x = min(max(x, 0), w - pw)
    out[..., y:y + ph, x:x + pw, :] = patch.to(canvas.dtype)
    return out

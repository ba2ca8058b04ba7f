"""LayerNorm without affine, then AdaLN modulation, in one pass: what the
Flux MMDiT blocks apply before each attention and MLP input and in the
output layer.

- :func:`ln_no_affine` and :func:`modulate` — the plain version, the
  model's two functions (``models/flux/model.py`` names them
  ``_ln_no_affine`` and ``_modulate``, as the JAX package does): f32
  statistics, the normalized row rounded to x's dtype, then
  ``x * (1 + scale) + shift`` in x's dtype.
- :func:`ln_modulate` — the kernel of ``csrc/adaln.cu`` on a CUDA tensor,
  the plain version on a CPU tensor. The kernel reads each bf16 row once
  and writes the modulated row once, with the plain version's roundings;
  only the order of its f32 sums differs (``csrc/adaln.cu``). It counts
  ``ln_modulate.launches``.

The JAX package has no kernel here: XLA fuses the chain on the TPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

EPS = 1e-6
MAX_WIDTH = 4096          # csrc/adaln.cu: 16 vectors of 8 lanes a thread


def ln_no_affine(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def _aligned(t: torch.Tensor, strides) -> bool:
    """16-byte aligned base, and every stride of a dimension longer than
    one a multiple of 8 elements."""
    return t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for n, st in zip(t.shape, strides) if n > 1)


def unsupported(x: torch.Tensor, shift: torch.Tensor,
                scale: torch.Tensor) -> Optional[str]:
    """Why the kernel does not take these arguments, or None where it
    does: x (B, S, h) and shift, scale (B, h), bf16 on one device, h a
    multiple of 8 up to :data:`MAX_WIDTH`, unit lane strides, 16-byte
    aligned bases and strides of 8 elements."""
    if x.dim() != 3 or shift.dim() != 2 or scale.dim() != 2:
        return (f"x (B, S, h) and shift, scale (B, h) expected, got "
                f"{tuple(x.shape)}, {tuple(shift.shape)}, "
                f"{tuple(scale.shape)}")
    b, s, h = x.shape
    if shift.shape != (b, h) or scale.shape != (b, h):
        return (f"shift {tuple(shift.shape)} and scale {tuple(scale.shape)} "
                f"do not match x {tuple(x.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (x, shift, scale)):
        return (f"the kernel takes bf16, got {x.dtype}, {shift.dtype}, "
                f"{scale.dtype}")
    if shift.device != x.device or scale.device != x.device:
        return "x, shift and scale on different devices"
    if h % 8 or not 0 < h <= MAX_WIDTH:
        return f"width {h} is not a multiple of 8 in 8..{MAX_WIDTH}"
    if b * s == 0:
        return "no rows"
    if x.stride(2) != 1 or shift.stride(1) != 1 or scale.stride(1) != 1:
        return "the lanes of x, shift and scale must be contiguous"
    if not (_aligned(x, x.stride()[:2])
            and _aligned(shift, shift.stride()[:1])
            and _aligned(scale, scale.stride()[:1])):
        return ("bases must be 16-byte aligned and strides multiples of 8 "
                "elements")
    return None


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("adaln")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.adaln_modulate.argtypes = [p, ll, ll, p, ll, p, ll, p, i, i, i,
                                       ctypes.c_float, p]
        lib.adaln_modulate.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def takes(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> bool:
    """Whether :func:`ln_modulate` would launch the kernel on these
    arguments and no gradient is wanted of the result (the kernel has no
    backward): on the card, no autograd graph recorded through them, and
    nothing :func:`unsupported` refuses."""
    if not _on_card(x):
        return False
    if torch.is_grad_enabled() and (x.requires_grad or shift.requires_grad
                                    or scale.requires_grad):
        return False
    return unsupported(x, shift, scale) is None


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(x: torch.Tensor, shift: torch.Tensor,
            scale: torch.Tensor) -> torch.Tensor:
    b, s, h = x.shape
    out = torch.empty((b, s, h), dtype=x.dtype, device=x.device)
    rc = _lib().adaln_modulate(
        x.data_ptr(), x.stride(0), x.stride(1), shift.data_ptr(),
        shift.stride(0), scale.data_ptr(), scale.stride(0), out.data_ptr(),
        b, s, h, EPS, _stream(x))
    if rc != 0:
        raise RuntimeError(f"adaln_modulate kernel launch failed (x "
                           f"{tuple(x.shape)}): CUDA error {rc}")
    return out


def ln_modulate(x: torch.Tensor, shift: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``modulate(ln_no_affine(x), shift, scale)``: x (B, S, h), shift
    and scale (B, h). On a CUDA tensor one kernel launch, which raises
    ``ValueError`` for arguments it does not take (:func:`unsupported`);
    on a CPU tensor the plain version."""
    if not _on_card(x):
        return modulate(ln_no_affine(x), shift, scale)
    reason = unsupported(x, shift, scale)
    if reason is not None:
        raise ValueError(f"ln_modulate: {reason}")
    out = _launch(x, shift, scale)
    ln_modulate.launches += 1
    return out


ln_modulate.launches = 0

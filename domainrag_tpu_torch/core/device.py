"""Device selection and numerics shared by every entry point.

The JAX package requests ``precision="highest"`` on every matmul and
convolution (domainrag_tpu/models/common.py:65-68, 164). PyTorch keeps
float32 matmuls exact on the card by default, but cuDNN convolutions
default to TF32, which would make the f32 VAE decode differ. So the
path turns TF32 off everywhere where it starts (:func:`resolve`).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for and absent:
    an entry point never carries on quietly on the CPU. Sets full float32
    (no TF32) for matmuls and convolutions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dev


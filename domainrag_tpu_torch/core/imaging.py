"""Host-side image loading and SigLIP preprocessing (own copy of
``domainrag_tpu/core/imaging.py:46-93``)."""

from __future__ import annotations

import numpy as np
from PIL import Image

# SigLIP (FLUX.1-Redux image encoder) preprocessing constants.
SIGLIP_MEAN = np.array([0.5, 0.5, 0.5], dtype=np.float32)
SIGLIP_STD = np.array([0.5, 0.5, 0.5], dtype=np.float32)


def ensure_rgb(image: Image.Image) -> Image.Image:
    if image.mode != "RGB":
        return image.convert("RGB")
    return image


def load_rgb(path: str) -> Image.Image:
    return ensure_rgb(Image.open(path))


def siglip_preprocess(image: Image.Image, size: int = 384) -> np.ndarray:
    """Bicubic resize to size x size, rescale, normalize to [-1, 1].
    Returns HWC float32."""
    image = ensure_rgb(image).resize((size, size), Image.BICUBIC)
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return (arr - SIGLIP_MEAN) / SIGLIP_STD

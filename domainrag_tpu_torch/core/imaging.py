"""Host-side image loading, the retrieval and SigLIP preprocessing, the
inpaint stage's removal mask, the compose stage's keep-mask and resolution
policy (own copy of ``domainrag_tpu/core/imaging.py:16-215``).

The CLIP and style-path resizes go through the native resampler
(``native/imageproc.cpp``, threaded C++ byte-equal to PIL) when its
library loads and ``USE_NATIVE_RESIZE`` is set, and through PIL
otherwise, as in the JAX package; the bytes are the same either way.
``resize_counts`` counts which one served."""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image

# OpenAI CLIP normalization constants (clip.load preprocess).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)

# SigLIP (FLUX.1-Redux image encoder) preprocessing constants.
SIGLIP_MEAN = np.array([0.5, 0.5, 0.5], dtype=np.float32)
SIGLIP_STD = np.array([0.5, 0.5, 0.5], dtype=np.float32)


# False sends every resize to PIL (read at each call)
USE_NATIVE_RESIZE = True

# resizes served by the native resampler and by PIL, since import (the
# encoders resize on their prefetch threads too)
resize_counts = {"native": 0, "pil": 0}
_counts_lock = threading.Lock()


def _resize_rgb(image: Image.Image, size_wh, method) -> np.ndarray:
    """Resize an RGB PIL image to ``size_wh`` (w, h) -> uint8 HWC: the
    native resampler for bicubic and bilinear when
    :data:`USE_NATIVE_RESIZE` is set and its library loads, else PIL."""
    from ..native import build as native
    served = "pil"
    if USE_NATIVE_RESIZE and method in (Image.BICUBIC, Image.BILINEAR) \
            and native.load_native() is not None:
        served = "native"
        out = native.resize_native(
            np.asarray(image), size_wh[1], size_wh[0],
            native.FILTER_BICUBIC if method == Image.BICUBIC
            else native.FILTER_BILINEAR)
    else:
        out = np.asarray(image.resize(size_wh, method))
    with _counts_lock:
        resize_counts[served] += 1
    return out


def ensure_rgb(image: Image.Image) -> Image.Image:
    if image.mode != "RGB":
        return image.convert("RGB")
    return image


def load_rgb(path: str) -> Image.Image:
    return ensure_rgb(Image.open(path))


def clip_preprocess(image: Image.Image, size: int = 224) -> np.ndarray:
    """OpenAI CLIP preprocess: bicubic resize (short side -> ``size``),
    center crop, scale to [0,1], normalize. Returns HWC float32.

    Matches ``clip.load("ViT-B/32")``'s torchvision transform used at
    retrieval/clip100_resnet_style_all_shots.py:209.
    """
    image = ensure_rgb(image)
    w, h = image.size
    # torchvision Resize(size) on PIL: scale the SHORT side to `size`.
    if w <= h:
        new_w, new_h = size, max(size, int(round(size * h / w)))
    else:
        new_w, new_h = max(size, int(round(size * w / h))), size
    resized = _resize_rgb(image, (new_w, new_h), Image.BICUBIC)
    # CenterCrop(size): torchvision uses round() on the half-offsets.
    left = int(round((new_w - size) / 2.0))
    top = int(round((new_h - size) / 2.0))
    arr = resized[top:top + size, left:left + size].astype(np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def style_preprocess(image: Image.Image, size: int = 256) -> np.ndarray:
    """ResNet-style-path preprocess: bilinear resize to size x size and
    scale to [0,1] — deliberately NO ImageNet normalization, matching the
    reference exactly (retrieval/...py:188-190 does only
    ``cv2.resize(256,256)`` + ``/255.0``). Returns HWC float32."""
    arr = _resize_rgb(ensure_rgb(image), (size, size), Image.BILINEAR)
    return arr.astype(np.float32) / 255.0


def siglip_preprocess(image: Image.Image, size: int = 384) -> np.ndarray:
    """Bicubic resize to size x size, rescale, normalize to [-1, 1].
    Returns HWC float32."""
    image = ensure_rgb(image).resize((size, size), Image.BICUBIC)
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return (arr - SIGLIP_MEAN) / SIGLIP_STD


# PIL ImageDraw.rectangle([x0, y0, x1, y1]) fills pixels x0..x1 and
# y0..y1 INCLUSIVE; the masks below reproduce that exactly.
Bbox = Tuple[float, float, float, float]  # x, y, w, h


def inpaint_mask_from_bboxes(width: int, height: int,
                             bboxes: Sequence[Bbox]) -> np.ndarray:
    """Union-of-bboxes removal mask: 255 inside bboxes (inpaint there),
    0 elsewhere. Parity with ``create_mask_from_multiple_bboxes``
    (lama_inpaint/lama_inpaint.py:52-71)."""
    mask = np.zeros((height, width), dtype=np.uint8)
    for x, y, w, h in bboxes:
        x0 = max(0, x)
        y0 = max(0, y)
        x1 = min(width, x0 + w)   # ref clamps right/bottom to W/H
        y1 = min(height, y0 + h)
        if x1 > x0 and y1 > y0:
            # PIL inclusive fill of [x0, x1] x [y0, y1]
            xi0, yi0 = int(x0), int(y0)
            xi1, yi1 = min(int(x1), width - 1), min(int(y1), height - 1)
            mask[yi0:yi1 + 1, xi0:xi1 + 1] = 255
    return mask


def outpaint_keep_mask(width: int, height: int,
                       bboxes: Sequence[Bbox]) -> np.ndarray:
    """Keep-foreground mask: 0 inside bboxes (keep pixels), 255 elsewhere
    (redraw). Parity with ``generate_outpaint_mask``
    (outpainting_updown_sampling_redux.py:836-870)."""
    mask = np.full((height, width), 255, dtype=np.uint8)
    for x, y, w, h in bboxes:
        x2 = x + w
        y2 = y + h
        x0 = max(0, min(x, width - 1))
        y0 = max(0, min(y, height - 1))
        x1 = max(0, min(x2, width))
        y1 = max(0, min(y2, height))
        xi0, yi0 = int(x0), int(y0)
        xi1, yi1 = min(int(x1), width - 1), min(int(y1), height - 1)
        if xi1 >= xi0 and yi1 >= yi0:
            mask[yi0:yi1 + 1, xi0:xi1 + 1] = 0
    return mask


# ---------------------------------------------------------------------------
# Resolution policy (outpainting_updown_sampling_redux.py:403-498)
# ---------------------------------------------------------------------------

class ResolutionConflictError(ValueError):
    """Image needs up- AND down-sampling at once (ref :424-427)."""


def resolve_resolution(width: int, height: int,
                       min_dimension: int = 1024,
                       max_dimension: int = 2800
                       ) -> Tuple[Tuple[int, int], float, float, bool, bool]:
    """Truth-table parity with ``process_image_resolution``.

    Returns ((new_w, new_h), up_factor, down_factor, was_up, was_down).
    """
    max_size = max(width, height)
    min_size = min(width, height)

    if min_size < min_dimension and max_size > max_dimension:
        raise ResolutionConflictError(
            f"image {width}x{height} needs both upscale (<{min_dimension}) "
            f"and downscale (>{max_dimension})")

    if min_size < min_dimension:
        scale_w = min_dimension / width if width < min_dimension else 1.0
        scale_h = min_dimension / height if height < min_dimension else 1.0
        up = max(scale_w, scale_h)
        return (int(width * up), int(height * up)), up, 1.0, True, False

    if max_size > max_dimension:
        down = max_dimension / max_size
        return (int(width * down), int(height * down)), 1.0, down, False, True

    return (width, height), 1.0, 1.0, False, False


def scale_bboxes(bboxes: Sequence[Bbox], factor: float) -> List[List[int]]:
    """int-truncating coordinate scaling (ref :1167-1179)."""
    return [[int(c * factor) for c in bbox] for bbox in bboxes]


def apply_resolution(image: Image.Image,
                     min_dimension: int = 1024,
                     max_dimension: int = 2800):
    """PIL bicubic resize per the policy; returns
    (image, up, down, was_up, was_down)."""
    (nw, nh), up, down, was_up, was_down = resolve_resolution(
        image.width, image.height, min_dimension, max_dimension)
    if was_up or was_down:
        image = image.resize((nw, nh), Image.BICUBIC)
    return image, up, down, was_up, was_down


def restore_resolution(image: Image.Image, up: float, down: float,
                       was_up: bool, was_down: bool) -> Image.Image:
    """Invert apply_resolution (ref downscale_image/upscale_image
    :462-498,1264-1278)."""
    if was_up and up > 1.0:
        return image.resize((int(image.width / up), int(image.height / up)),
                            Image.BICUBIC)
    if was_down and down < 1.0:
        inv = 1.0 / down
        return image.resize((int(image.width * inv), int(image.height * inv)),
                            Image.BICUBIC)
    return image


def to_multiple_of(value: int, multiple: int, minimum: int = 0) -> int:
    """Floor to a multiple with a lower bound (batch_generate_flux_kshot.py:
    448-456 floors H/W to multiples of 16 with min 64)."""
    return max((value // multiple) * multiple, minimum)

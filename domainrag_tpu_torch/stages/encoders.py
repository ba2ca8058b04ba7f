"""Batched encoder wrappers for the retrieval stage (port of
``domainrag_tpu/stages/encoders.py``).

The reference embeds images one at a time (batch=1 CLIP forwards,
retrieval/clip100_resnet_style_all_shots.py:280-287) and recomputes all 100
re-rank features per query (:468). These wrappers batch the forwards,
overlap the host decode of the next batch with the device encode of the
current one, and memoize the style features. The JAX wrappers pad each
batch to a fixed size so that jit compiles one graph; eager torch needs no
padding (each image's embedding is computed independently), so a last
short batch runs as it is.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..core import device as device_mod
from ..core import imaging
from ..models import clip as tclip
from ..models import resnet_stem


class ClipImageEncoder:
    """CLIP image tower with host preprocess + device batch embed, in f32
    (TF32 off: ``core.device.resolve``)."""

    def __init__(self, params, cfg: tclip.ClipVisionConfig,
                 batch_size: int = 32, *, device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = device_mod.resolve(device)
        self._params = params

    def preprocess(self, image: Image.Image) -> np.ndarray:
        return imaging.clip_preprocess(image, self.cfg.image_size)

    @torch.no_grad()
    def encode_arrays(self, pixel_batches: np.ndarray) -> np.ndarray:
        """(N, H, W, 3) preprocessed -> (N, projection_dim) L2-normalized
        f32."""
        out = []
        bs = self.batch_size
        for i in range(0, len(pixel_batches), bs):
            chunk = torch.from_numpy(
                np.ascontiguousarray(pixel_batches[i:i + bs], np.float32))
            emb = tclip.encode_image(self._params, chunk.to(self.device),
                                     self.cfg)
            out.append(emb.cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros(
            (0, self.cfg.projection_dim), np.float32)

    def encode_paths(self, paths: Sequence[str],
                     on_error: Optional[Callable[[str, Exception], None]] = None
                     ) -> tuple[np.ndarray, List[str]]:
        """Load+preprocess+embed; skips unreadable files (the reference
        warns and continues, ref :288-292). Returns (features, kept_paths).

        Host decode/preprocess of the NEXT chunk overlaps the device encode
        of the current one (double buffering)."""
        from ..core.prefetch import PrefetchError, prefetch

        bs = self.batch_size
        chunks = [list(paths[i:i + bs]) for i in range(0, len(paths), bs)]

        def load_chunk(chunk):
            pixels, kept = [], []
            for path in chunk:
                try:
                    pixels.append(self.preprocess(imaging.load_rgb(path)))
                    kept.append(path)
                except Exception as e:  # unreadable/corrupt image
                    if on_error:
                        on_error(path, e)
            return pixels, kept

        feats: List[np.ndarray] = []
        kept_all: List[str] = []
        for loaded in prefetch(chunks, load_chunk, depth=2):
            if isinstance(loaded, PrefetchError):
                continue
            pixels, kept = loaded
            if not pixels:
                continue
            feats.append(self.encode_arrays(np.stack(pixels)))
            kept_all.extend(kept)
        if not feats:
            return np.zeros((0, self.cfg.projection_dim), np.float32), []
        return np.concatenate(feats, axis=0), kept_all


class StyleEncoder:
    """ResNet-stem style features with host preprocess + batch embed."""

    def __init__(self, params, cfg: resnet_stem.ResNetStemConfig = None,
                 batch_size: int = 32, resize: int = 256, *, device=None):
        self.cfg = cfg or resnet_stem.ResNetStemConfig()
        self.batch_size = batch_size
        self.resize = resize
        self.device = device_mod.resolve(device)
        self._params = params
        self._cache: dict[str, np.ndarray] = {}

    @torch.no_grad()
    def encode_paths(self, paths: Sequence[str]) -> dict[str, np.ndarray]:
        """Returns {path: (128,) style vector}; memoized across queries
        (the reference recomputed candidates per query — do not replicate)."""
        missing = [p for p in paths if p not in self._cache]
        pixels, kept = [], []
        for path in missing:
            try:
                img = imaging.load_rgb(path)
                pixels.append(imaging.style_preprocess(img, self.resize))
                kept.append(path)
            except Exception:
                continue
        bs = self.batch_size
        for i in range(0, len(pixels), bs):
            chunk = torch.from_numpy(np.stack(pixels[i:i + bs]))
            feats = resnet_stem.style_features(
                self._params, chunk.to(self.device), self.cfg).cpu().numpy()
            for path, feat in zip(kept[i:i + bs], feats):
                self._cache[path] = feat
        return {p: self._cache[p] for p in paths if p in self._cache}

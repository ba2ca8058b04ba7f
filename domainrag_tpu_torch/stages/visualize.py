"""Retrieval result visualization (own copy of
``domainrag_tpu/stages/visualize.py``; reference ``visualize_results``,
retrieval/clip100_resnet_style_all_shots.py:354-393: a 3x4 matplotlib grid
of the query plus its top retrieved images, saved per sample).

matplotlib is optional — a PIL grid fallback keeps the artifact available
in minimal environments.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from ..core.imaging import load_rgb
from ..core.log import get_logger

logger = get_logger("domainrag_tpu_torch.visualize")

GRID_ROWS, GRID_COLS = 3, 4
THUMB = 256


def visualize_results(query_path: str, result_paths: Sequence[str],
                      output_path: str, max_results: int = 10) -> Optional[str]:
    """Query + top-N retrieved thumbnails in one grid image."""
    try:
        images = [("query", load_rgb(query_path))]
        for i, path in enumerate(result_paths[:max_results]):
            try:
                images.append((f"rank {i + 1}", load_rgb(path)))
            except Exception:
                continue
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        try:
            return _matplotlib_grid(images, output_path)
        except Exception:
            return _pil_grid(images, output_path)
    except Exception as e:
        logger.warning("visualization failed for %s: %s", query_path, e)
        return None


def _matplotlib_grid(images, output_path: str) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(GRID_ROWS, GRID_COLS,
                             figsize=(4 * GRID_COLS, 4 * GRID_ROWS))
    for ax in axes.flat:
        ax.axis("off")
    for ax, (title, img) in zip(axes.flat, images):
        ax.imshow(np.asarray(img))
        ax.set_title(title, fontsize=10)
    fig.tight_layout()
    fig.savefig(output_path, dpi=72)
    plt.close(fig)
    return output_path


def _pil_grid(images, output_path: str) -> str:
    canvas = Image.new("RGB", (GRID_COLS * THUMB, GRID_ROWS * THUMB),
                       (255, 255, 255))
    for i, (_title, img) in enumerate(images[:GRID_ROWS * GRID_COLS]):
        thumb = img.copy()
        thumb.thumbnail((THUMB, THUMB))
        canvas.paste(thumb, ((i % GRID_COLS) * THUMB,
                             (i // GRID_COLS) * THUMB))
    canvas.save(output_path)
    return output_path

"""COCO-style annotation access (own copy of
``domainrag_tpu/core/coco.py``).

Replaces the ad-hoc dict building repeated in every reference script
(``lama_inpaint/lama_inpaint.py:106-132``,
``outpainting_updown_sampling_redux.py:545-682``) with one reader.

Annotation schema (datasets/structure.md): ``{k}_shot.json`` with
``images`` (id, file_name, width, height), ``annotations``
(id, image_id, category_id, bbox=[x, y, w, h]), ``categories`` (id, name).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class ImageInfo:
    id: int
    file_name: str
    width: int
    height: int


@dataclass(frozen=True)
class Annotation:
    id: int
    image_id: int
    category_id: int
    bbox: Tuple[float, float, float, float]  # x, y, w, h


class CocoAnnotations:
    """In-memory index over a COCO-style annotation JSON."""

    def __init__(self, data: dict):
        self._data = data
        self.images: Dict[int, ImageInfo] = {}
        for img in data.get("images", []):
            info = ImageInfo(
                id=int(img["id"]),
                file_name=img["file_name"],
                width=int(img.get("width", 0)),
                height=int(img.get("height", 0)),
            )
            self.images[info.id] = info

        self.categories: Dict[int, str] = {
            int(c["id"]): c["name"] for c in data.get("categories", [])
        }

        self.annotations_by_image: Dict[int, List[Annotation]] = {}
        for ann in data.get("annotations", []):
            a = Annotation(
                id=int(ann.get("id", -1)),
                image_id=int(ann["image_id"]),
                category_id=int(ann["category_id"]),
                bbox=tuple(float(v) for v in ann["bbox"]),
            )
            self.annotations_by_image.setdefault(a.image_id, []).append(a)

    @classmethod
    def load(cls, path: str) -> "CocoAnnotations":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f))

    @classmethod
    def load_shot(cls, dataset_dir: str, shot: int) -> "CocoAnnotations":
        """Load ``{dataset_dir}/annotations/{shot}_shot.json``."""
        return cls.load(os.path.join(dataset_dir, "annotations",
                                     f"{shot}_shot.json"))

    def image_ids(self) -> List[int]:
        return sorted(self.images)

    def bboxes_for_image(self, image_id: int) -> List[Tuple[float, float, float, float]]:
        return [a.bbox for a in self.annotations_by_image.get(image_id, [])]

    def category_names_for_image(self, image_id: int) -> List[str]:
        return [
            self.categories.get(a.category_id, f"cat{a.category_id}")
            for a in self.annotations_by_image.get(image_id, [])
        ]

    def file_name(self, image_id: int) -> str:
        return self.images[image_id].file_name

    def image_size(self, image_id: int) -> Tuple[int, int]:
        """Returns (width, height) from the annotation record.

        The reference resizes the actual pixels to these dims when they
        disagree (lama_inpaint.py:173-175); callers should do the same.
        """
        info = self.images[image_id]
        return info.width, info.height


def write_coco(path: str,
               images: Sequence[dict],
               annotations: Sequence[dict],
               categories: Sequence[dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"images": list(images),
                   "annotations": list(annotations),
                   "categories": list(categories)}, f, indent=2)

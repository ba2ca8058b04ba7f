"""Export composited images as a COCO detection training set (port of
``domainrag_tpu/pipeline/export.py``).

The reference's output contract is implicit: composited images inherit the
original k-shot bbox annotations verbatim (SURVEY.md: "free detection
training data"), and users re-pair ``final_results`` images with the
original ``{k}_shot.json`` by hand. This tool makes the pairing explicit:
one COCO JSON whose ``images`` are the composited outputs and whose
``annotations`` are the inherited boxes (one image entry per sample x
rank), ready to concatenate with the real k-shot file for detector
training.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

from ..core.coco import CocoAnnotations
from ..core.log import get_logger

logger = get_logger("domainrag_tpu_torch.export")


def export_synthetic_coco(datasets_dir: str, output_dir: str,
                          dataset: str, shot: int, process_id: str,
                          out_path: Optional[str] = None) -> dict:
    """Build the synthetic-set COCO JSON from a finished compose run."""
    coco = CocoAnnotations.load_shot(os.path.join(datasets_dir, dataset),
                                     shot)
    outpaint_root = os.path.join(output_dir, "outpaint_hires",
                                 f"process_{process_id}", dataset,
                                 f"{shot}_shot")
    sample_to_image = {
        os.path.splitext(coco.file_name(i))[0]: i for i in coco.image_ids()}

    images: List[dict] = []
    annotations: List[dict] = []
    next_img_id = 1
    next_ann_id = 1
    for sample_id, image_id in sorted(sample_to_image.items()):
        finals = sorted(glob.glob(os.path.join(
            outpaint_root, sample_id, f"{sample_id}_final_result*.png")))
        info = coco.images[image_id]
        anns = coco.annotations_by_image.get(image_id, [])
        for path in finals:
            images.append({
                "id": next_img_id,
                "file_name": os.path.relpath(path, output_dir),
                "width": info.width,
                "height": info.height,
                "source_image_id": image_id,
                "source_sample_id": sample_id,
            })
            for ann in anns:
                annotations.append({
                    "id": next_ann_id,
                    "image_id": next_img_id,
                    "category_id": ann.category_id,
                    "bbox": list(ann.bbox),
                    "area": ann.bbox[2] * ann.bbox[3],
                    "iscrowd": 0,
                })
                next_ann_id += 1
            next_img_id += 1

    result = {
        "info": {"description": f"domainrag_tpu synthetic set: {dataset} "
                                f"{shot}-shot (process {process_id})"},
        "images": images,
        "annotations": annotations,
        "categories": [{"id": cid, "name": name}
                       for cid, name in sorted(coco.categories.items())],
    }
    if out_path is None:
        out_path = os.path.join(output_dir,
                                f"synthetic_{dataset}_{shot}shot.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=2)
    logger.info("exported %d synthetic images / %d annotations to %s",
                len(images), len(annotations), out_path)
    return result

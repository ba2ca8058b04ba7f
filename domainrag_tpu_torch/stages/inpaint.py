"""Stage 1 — foreground removal with LaMa (port of
``domainrag_tpu/stages/inpaint.py``).

Per dataset x shot: load the COCO-style ``{k}_shot.json``, group the
annotations by image, rasterize the union-of-bboxes removal mask, inpaint,
and save the background under the ORIGINAL file name in
``{out}/lamainpaint/{dataset}/{k}_shot/``, with a manifest for resume and
the ``category_mapping.json`` sidecar (sample_id -> first category) that
stage 2 reads.

Images are grouped by padded shape (``bucket_multiple``) so same-bucket
images run as one batched forward; bucket multiple 8 is SimpleLama's own
padding.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from ..core import device as device_mod
from ..core import imaging
from ..core.coco import CocoAnnotations
from ..core.config import worker_slice
from ..core.log import StepTimer, get_logger
from ..core.manifest import Manifest, STATUS_DONE, STATUS_FAILED
from ..models import lama

logger = get_logger("domainrag_tpu_torch.inpaint")


class LamaRunner:
    """The LaMa forward over same-bucket batches, on the card unless
    ``device="cpu"``; ``params`` live on that device."""

    def __init__(self, params, cfg: lama.LamaConfig,
                 bucket_multiple: int = 8, compute_dtype=torch.float32,
                 batch_size: int = 1, *, device=None):
        self.device = device_mod.resolve(device)
        self.params = params
        self.cfg = cfg
        self.bucket = max(bucket_multiple, 8)
        self.batch_size = max(batch_size, 1)
        self.dtype = compute_dtype

    def _pad_shape(self, h: int, w: int):
        m = self.bucket
        return ((h + m - 1) // m * m, (w + m - 1) // m * m)

    def inpaint(self, image_u8: np.ndarray, mask_u8: np.ndarray
                ) -> np.ndarray:
        return self.inpaint_batch([image_u8], [mask_u8])[0]

    @torch.inference_mode()
    def inpaint_batch(self, images_u8, masks_u8) -> list:
        """Same-bucket batch: all images pad to the max dims in the batch
        and run as one forward (callers group by padded shape)."""
        n = len(images_u8)
        dims = [self._pad_shape(im.shape[0], im.shape[1])
                for im in images_u8]
        ph = max(d[0] for d in dims)
        pw = max(d[1] for d in dims)
        img = np.zeros((n, ph, pw, 3), np.float32)
        msk = np.zeros((n, ph, pw, 1), np.float32)
        for i, (im, ma) in enumerate(zip(images_u8, masks_u8)):
            h, w = im.shape[:2]
            img[i, :h, :w] = im.astype(np.float32) / 255.0
            msk[i, :h, :w, 0] = (ma > 127).astype(np.float32)

        def dev(a):
            return torch.from_numpy(a).to(self.device, self.dtype)

        out = lama.apply(self.params, dev(img), dev(msk), self.cfg)
        out = out.float().cpu().numpy()
        results = []
        for i, im in enumerate(images_u8):
            h, w = im.shape[:2]
            results.append(np.clip(out[i, :h, :w] * 255.0, 0,
                                   255).astype(np.uint8))
        return results


def process_dataset(dataset: str, shot: int, runner: LamaRunner,
                    datasets_dir: str, output_dir: str,
                    resume: bool = False,
                    manifest: Optional[Manifest] = None,
                    timer: Optional[StepTimer] = None,
                    worker_id: int = 0,
                    num_workers: int = 1) -> Dict[str, int]:
    """One dataset x shot sweep. Returns the counters {processed, skipped,
    failed} (ref :214-221). ``timer`` gets ``load``, ``mask`` (per
    image), ``lama`` and ``save`` (per batch) spans."""
    dataset_dir = os.path.join(datasets_dir, dataset)
    coco = CocoAnnotations.load_shot(dataset_dir, shot)
    out_dir = os.path.join(output_dir, "lamainpaint", dataset,
                           f"{shot}_shot")
    os.makedirs(out_dir, exist_ok=True)
    manifest = manifest or Manifest(os.path.join(out_dir, "manifest.json"))
    timer = timer or StepTimer()

    keys = worker_slice([str(i) for i in coco.image_ids()],
                        worker_id, num_workers)
    todo = set(manifest.pending(keys, resume=resume))
    counters = {"processed": 0, "skipped": 0, "failed": 0}
    category_mapping: Dict[str, str] = {}

    def load_one(image_id):
        info = coco.images[image_id]
        src = os.path.join(dataset_dir, "train", info.file_name)
        if not os.path.exists(src):
            src = os.path.join(dataset_dir, info.file_name)
        with timer.span("load"):
            image = imaging.load_rgb(src)
            # resize pixels to the annotation dims when they disagree
            # (ref :173-175)
            if image.size != (info.width, info.height):
                image = image.resize((info.width, info.height))
        with timer.span("mask"):
            mask = imaging.inpaint_mask_from_bboxes(
                info.width, info.height, coco.bboxes_for_image(image_id))
        return np.asarray(image), mask

    pending_ids = []
    for image_id in coco.image_ids():
        info = coco.images[image_id]
        sample_id = os.path.splitext(info.file_name)[0]
        cats = coco.category_names_for_image(image_id)
        if cats:
            category_mapping[sample_id] = cats[0]
        if str(image_id) not in todo or not coco.bboxes_for_image(image_id):
            counters["skipped"] += 1
            continue
        pending_ids.append(image_id)

    groups: Dict[tuple, list] = {}
    for image_id in pending_ids:
        info = coco.images[image_id]
        groups.setdefault(runner._pad_shape(info.height, info.width),
                          []).append(image_id)

    for shape, ids in sorted(groups.items()):
        for chunk_start in range(0, len(ids), runner.batch_size):
            chunk = ids[chunk_start:chunk_start + runner.batch_size]
            start = time.perf_counter()
            try:
                loaded = [load_one(i) for i in chunk]
                with timer.span("lama"):
                    results = runner.inpaint_batch(
                        [im for im, _ in loaded], [m for _, m in loaded])
                with timer.span("save"):
                    per = (time.perf_counter() - start) / len(chunk)
                    for image_id, result in zip(chunk, results):
                        info = coco.images[image_id]
                        out_path = os.path.join(out_dir, info.file_name)
                        os.makedirs(os.path.dirname(out_path) or out_dir,
                                    exist_ok=True)
                        Image.fromarray(result).save(out_path)
                        counters["processed"] += 1
                        manifest.mark(str(image_id), STATUS_DONE,
                                      outputs={"path": out_path},
                                      elapsed_s=per)
            except Exception as e:
                logger.exception("inpaint failed for images %s", chunk)
                for image_id in chunk:
                    counters["failed"] += 1
                    manifest.mark(str(image_id), STATUS_FAILED,
                                  error=str(e))

    with open(os.path.join(out_dir, "category_mapping.json"), "w") as f:
        json.dump(category_mapping, f, indent=2)
    logger.info("%s %d_shot inpaint: %s", dataset, shot, counters)
    return counters


def run_inpaint(datasets: Sequence[str], shots: Sequence[int],
                runner: LamaRunner, datasets_dir: str, output_dir: str,
                resume: bool = False, worker_id: int = 0,
                num_workers: int = 1) -> Dict[str, Dict[str, int]]:
    """Every dataset x shot; a missing annotation file skips its pair."""
    results = {}
    for dataset in datasets:
        for shot in shots:
            try:
                results[f"{dataset}/{shot}"] = process_dataset(
                    dataset, shot, runner, datasets_dir, output_dir,
                    resume=resume, worker_id=worker_id,
                    num_workers=num_workers)
            except FileNotFoundError as e:
                logger.warning("skipping %s %d_shot: %s", dataset, shot, e)
    return results

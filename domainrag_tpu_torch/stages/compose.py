"""Stage 4 — Flux-Fill outpaint/composite (port of
``domainrag_tpu/stages/compose.py``).

Mirrors ``outpainting_updown_sampling_redux.py:872-1361`` per sample:

1. recover original image + ALL bboxes + categories from ``{k}_shot.json``
   (ref :570-682);
2. resolution policy: upscale min-dim to the per-dataset target (UODD
   2048), downscale max-dim to <= 2800, conflict -> error (ref :403-458);
3. scale bbox coords by the factor (int truncation, ref :1167-1179);
4. keep-mask: 0 inside bboxes, 255 outside (ref :836-870);
5. per generated background (ranks 1..5): single-image Redux prior with
   the per-dataset prompt + image_prompt_scale (ref :1237-1243), then
   Flux-Fill at per-dataset guidance 30-40 / strength 0.3-0.9, 50 steps
   (ref :1246-1257);
6. restore to original resolution, write hires/final/mask/params JSON
   (ref :1259-1322) and the formatted result JSON (ref :1383-1456).

The on-disk contract (file names, JSON keys) is the JAX package's. The
models load once per process; the <= 5 backgrounds of a sample share one
batched prior and fill, or chunks of ``max_rank_batch``; resume is
manifest-driven. With ``mesh`` (hires fills ring their attention over its
data axis) or ``pipe_mesh`` (the fill's depth pipelined), every rank runs
the sweep and rank 0 alone writes.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import random
import time
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image

from ..core import imaging
from ..core.coco import CocoAnnotations
from ..core.config import ComposeConfig, DatasetParams, worker_slice
from ..core.interrupt import should_stop
from ..core.log import StepTimer, get_logger
from ..core.manifest import Manifest, STATUS_DONE, STATUS_FAILED
from ..core.prefetch import PrefetchError, prefetch
from ..core.progress import ProgressReporter
from ..models.flux import pipeline as flux_pipeline

logger = get_logger("domainrag_tpu_torch.compose")


def find_sample_backgrounds(result_root: str, dataset: str, shot: int,
                            sample_id: str) -> List[str]:
    """Generated backgrounds for a sample: glob
    ``{result_root}/{dataset}_{shot}shot_retrieval/results_*/{sample}/
    generated_image*.png`` (ref :795-825,1083)."""
    pattern = os.path.join(result_root, f"{dataset}_{shot}shot_retrieval",
                           "results_*", sample_id, "generated_image*.png")
    return sorted(glob.glob(pattern))


def rank_suffix(bg_path: str, index: int) -> str:
    """Extract the rank suffix from a background file name (ref
    :1199-1206): 'generated_image_rank3.png' -> '_rank3', else '_{i+1}'."""
    name = os.path.basename(bg_path)
    if "rank" in name:
        return "_rank" + name.split("rank")[1].split(".")[0]
    return f"_{index + 1}"


def fallback_sample_inputs(dataset: str, sample_id: str, result_root: str,
                           shot: int,
                           bbox_crops_dir: Optional[str] = None):
    """Recover (original_image, bboxes, categories) for a sample missing
    from the annotations (ref :924-1077):

    1. original = the generate stage's ``target_input.png`` copy;
    2. bboxes from ``{bbox_crops_dir}/{dataset}/{sample_id}*`` crops placed
       on a synthetic grid (ref's offset layout: i%3 / i//3 sixths), else
    3. a default centered bbox covering 30% of each dimension.
    Returns None when no target_input.png exists either."""
    pattern = os.path.join(result_root, f"{dataset}_{shot}shot_retrieval",
                           "results_*", sample_id, "target_input.png")
    matches = sorted(glob.glob(pattern))
    if not matches:
        return None
    original = imaging.load_rgb(matches[0])
    w, h = original.size

    crops = []
    if bbox_crops_dir:
        crops = sorted(glob.glob(os.path.join(
            bbox_crops_dir, dataset, f"{sample_id}*")))
    if crops:
        bboxes, categories = [], []
        for i, path in enumerate(crops):
            try:
                crop = imaging.load_rgb(path)
            except Exception:
                continue
            bw, bh = crop.size
            offset_x = (i % 3) * (w // 6)
            offset_y = (i // 3) * (h // 6)
            x = max(0, min(w // 2 - bw // 2 + offset_x, w - bw))
            y = max(0, min(h // 2 - bh // 2 + offset_y, h - bh))
            bboxes.append((x, y, bw, bh))
            categories.append("unknown")
        if bboxes:
            return original, bboxes, categories
    bw, bh = int(w * 0.3), int(h * 0.3)
    return original, [((w - bw) // 2, (h - bh) // 2, bw, bh)], ["unknown"]


@dataclasses.dataclass
class ComposeStage:
    bundle: flux_pipeline.FluxBundle
    cfg: ComposeConfig
    process_id: str = "0"
    seed: Optional[int] = None   # None -> random per image (ref :1230)
    mesh: Optional[object] = None  # hires: ring attention over its data axis
    pipe_mesh: Optional[object] = None  # PP: depth-sharded fill serving
    pipe_axis: str = "pipe"

    def writes(self) -> bool:
        """True where this process writes artifacts: without a mesh, or on
        its rank 0 (every rank of a mesh runs the same sweep)."""
        return all(m is None or m.is_writer()
                   for m in (self.mesh, self.pipe_mesh))

    def dataset_params(self, dataset: str) -> DatasetParams:
        for key, value in self.cfg.dataset_params.items():
            if key.lower() == dataset.lower():
                return value
        return DatasetParams()

    def process_sample(self, dataset: str, shot: int, sample_id: str,
                       original_image: Image.Image,
                       bboxes: Sequence[imaging.Bbox],
                       categories: Sequence[str],
                       bg_paths: Sequence[str],
                       outpaint_dir: str,
                       image_id=None,
                       timer: Optional[StepTimer] = None) -> dict:
        """One sample; returns the log record feeding the result JSON."""
        timer = timer or StepTimer()
        write = self.writes()
        if write:
            os.makedirs(outpaint_dir, exist_ok=True)
        params = self.dataset_params(dataset)
        lf = self.bundle.latent_factor

        with timer.span("prepare"):
            # resolution policy + /16 alignment for the fill model
            processed, up, down, was_up, was_down = imaging.apply_resolution(
                original_image, params.upscale_dimension,
                self.cfg.resolution.max_dimension)
            aligned_w = imaging.to_multiple_of(processed.width, lf, lf * 4)
            aligned_h = imaging.to_multiple_of(processed.height, lf, lf * 4)
            if (aligned_w, aligned_h) != processed.size:
                processed = processed.resize((aligned_w, aligned_h),
                                             Image.BICUBIC)
            # bbox transform covers BOTH the policy resize and the /16
            # alignment (the reference scaled by the policy factor only
            # because it never re-aligned; our fill model needs
            # /latent_factor dims)
            sx = aligned_w / original_image.width
            sy = aligned_h / original_image.height
            scaled_bboxes = [[int(x * sx), int(y * sy),
                              int(w * sx), int(h * sy)]
                             for (x, y, w, h) in bboxes]

            keep_mask = imaging.outpaint_keep_mask(aligned_w, aligned_h,
                                                   scaled_bboxes)
            processed_np = np.asarray(processed)

            # optional shape bucketing: pad to the bucket multiple with
            # edge pixels; padding is keep-masked (0) so the fill never
            # redraws it, and the output is cropped back before restore.
            bucket = self.cfg.resolution_bucket
            pad_h = pad_w = 0
            if bucket and bucket > 0:
                bucket_h = -aligned_h % max(bucket, lf)
                bucket_w = -aligned_w % max(bucket, lf)
                if bucket_h or bucket_w:
                    pad_h, pad_w = bucket_h, bucket_w
                    processed_np = np.pad(processed_np,
                                          ((0, pad_h), (0, pad_w), (0, 0)),
                                          mode="edge")
                    keep_mask = np.pad(keep_mask, ((0, pad_h), (0, pad_w)),
                                       mode="constant", constant_values=0)

        log: dict = {
            "sample_id": sample_id, "sample_prefix": sample_id,
            "status": "completed",
            "category": categories[0] if categories else "unknown",
            "categories": list(categories),
            "image_id": image_id if image_id is not None else "unknown",
            "original_image_size": [original_image.width,
                                    original_image.height],
            "bbox_coords_list": [list(b) for b in bboxes],
            "outpainted_images": [],
        }

        # all <=5 backgrounds of the sample denoise as ONE batch (the
        # reference ran 5 sequential 50-step fills per sample). Each bg is
        # a K=1 conditioning group through the SAME model API the generate
        # stage uses (single-image Redux prior, ref :1237-1243) — one
        # implementation of the prior, not two.
        size = self.bundle.siglip_cfg.image_size
        n_bg = len(bg_paths)
        with timer.span("prior"):
            with timer.span("prior/inputs"):
                bg_images = [imaging.load_rgb(p) for p in bg_paths]
                pxs = np.stack([imaging.siglip_preprocess(b, size)
                                for b in bg_images])
            embeds_all, pooled_all = flux_pipeline.redux_prior_pairs(
                self.bundle, pxs[:, None], params.redux_prompt,
                prompt_embeds_scale=[params.image_prompt_scale],
                pooled_prompt_embeds_scale=[1.0], timer=timer)

        seeds = [self.seed if self.seed is not None
                 else random.randint(0, 2**32 - 1) for _ in bg_paths]
        for m in (self.mesh, self.pipe_mesh):
            if m is not None and self.seed is None:
                seeds = m.broadcast_object(seeds)    # rank 0's draws

        def fill(emb, pool, sds, nb):
            return flux_pipeline.fill_batch(
                self.bundle, np.broadcast_to(
                    processed_np, (nb,) + processed_np.shape),
                np.broadcast_to(keep_mask, (nb,) + keep_mask.shape),
                emb, pool,
                num_steps=self.cfg.num_steps,
                guidance=params.guidance_scale,
                strength=params.strength, seeds=sds,
                hires_threshold_px=self.cfg.hires_threshold_px,
                velocity_cache_interval=self.cfg.velocity_cache_interval,
                velocity_cache_order=self.cfg.velocity_cache_order,
                mesh=self.pipe_mesh if self.pipe_mesh is not None
                else self.mesh,
                pipe_axis=self.pipe_axis if self.pipe_mesh is not None
                else None,
                timer=timer)

        mb = self.cfg.max_rank_batch
        with timer.span("fill"):
            if mb and self.pipe_mesh is None and n_bg > mb:
                # fill in chunks of max_rank_batch backgrounds, as the
                # generate stage chunks its ranks
                results = np.concatenate([
                    fill(embeds_all[i:i + mb], pooled_all[i:i + mb],
                         seeds[i:i + mb], min(mb, n_bg - i))
                    for i in range(0, n_bg, mb)])
            else:
                results = fill(embeds_all, pooled_all, seeds, n_bg)
            if pad_h or pad_w:
                results = results[:, :aligned_h, :aligned_w]

        for i, bg_path in enumerate(bg_paths):
            suffix = rank_suffix(bg_path, i)
            bg_image = bg_images[i]
            seed = seeds[i]
            result = results[i]
            with timer.span("save"):
                mask_path = os.path.join(
                    outpaint_dir, f"{sample_id}_mask{suffix}.png")
                bg_copy = os.path.join(
                    outpaint_dir, f"{sample_id}_bg{suffix}_original.png")
                hires_path = os.path.join(
                    outpaint_dir, f"{sample_id}_hires_result{suffix}.png")
                final_path = os.path.join(
                    outpaint_dir, f"{sample_id}_final_result{suffix}.png")
                if write:
                    Image.fromarray(keep_mask).save(mask_path)
                    bg_image.save(bg_copy)
                    hires = Image.fromarray(result)
                    hires.save(hires_path)
                    final = hires.resize(original_image.size,
                                         Image.BICUBIC) \
                        if hires.size != original_image.size else hires
                    final.save(final_path)

                params_record = {
                    "categories": list(categories),
                    "image_prompt_scale": params.image_prompt_scale,
                    "guidance_scale": params.guidance_scale,
                    "num_inference_steps": self.cfg.num_steps,
                    "strength": params.strength,
                    "redux_prompt": params.redux_prompt,
                    "seed": seed,
                    "process_id": self.process_id,
                    "shot_number": shot,
                    "bg_index": i,
                    "bg_filename": os.path.basename(bg_path),
                    "original_bg_path": bg_path,
                    "copied_bg_path": bg_copy,
                    "original_resolution": {
                        "width": original_image.width,
                        "height": original_image.height},
                    "processed_resolution": {"width": aligned_w,
                                             "height": aligned_h},
                    "min_dimension_used": params.upscale_dimension,
                    "up_scale_factor": up,
                    "down_scale_factor": down,
                    "was_upscaled": was_up,
                    "was_downscaled": was_down,
                    "bbox_coords_list": [list(b) for b in bboxes],
                    "processed_bbox_coords_list": scaled_bboxes,
                    "image_id": image_id if image_id is not None
                    else "unknown",
                    "num_bbox": len(bboxes),
                }
                params_path = os.path.join(
                    outpaint_dir, f"{sample_id}_params{suffix}.json")
                if write:
                    with open(params_path, "w") as f:
                        json.dump(params_record, f, indent=2)

            log["outpainted_images"].append({
                "original_bg_path": bg_path,
                "copied_bg_path": bg_copy,
                "hires_result_path": hires_path,
                "final_result_path": final_path,
                "mask_path": mask_path,
                "params_path": params_path,
                "bbox_coords_list": scaled_bboxes,
                "params": params_record,
            })
        return log


def formatted_result_json(dataset: str, logs: List[dict], shot: int,
                          process_id: str) -> dict:
    """Result JSON with the reference's field layout (ref :1383-1456)."""
    samples = []
    for log in logs:
        if log.get("status") != "completed" or not log["outpainted_images"]:
            continue
        samples.append({
            "sample_id": log["sample_id"],
            "category": log.get("category", "unknown"),
            "categories": log.get("categories", []),
            "sample_prefix": log["sample_prefix"],
            "process_id": process_id,
            "shot_number": shot,
            "image_id": log["image_id"],
            "original_image_size": log["original_image_size"],
            "bbox_coords_list": log.get("bbox_coords_list", []),
            "num_bbox": len(log.get("bbox_coords_list", [])),
            "outpainted_images": [{
                "original_bg_path": r["original_bg_path"],
                "copied_bg_path": r["copied_bg_path"],
                "outpainted_image_path": r["hires_result_path"],
                "final_result_path": r["final_result_path"],
                "mask_path": r["mask_path"],
                "params_path": r["params_path"],
                "bbox_coords_list": r.get("bbox_coords_list", []),
                "shot_number": shot,
                "params": r["params"],
            } for r in log["outpainted_images"]],
        })
    return {"dataset": dataset,
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            "process_id": process_id,
            "shot_number": shot,
            "samples": samples}


def process_dataset(stage: ComposeStage, dataset: str, shot: int,
                    datasets_dir: str, output_dir: str,
                    resume: bool = False,
                    failed_only: bool = False,
                    worker_id: int = 0,
                    num_workers: int = 1, *,
                    timer: Optional[StepTimer] = None) -> dict:
    """Full dataset x shot sweep + result JSON + final collection.
    ``timer`` gets every sample's spans (``prepare``, ``prior`` with
    ``prior/inputs``, ``prior/text`` and ``prior/image``, ``fill`` with
    the fill's ``fill/inputs``/``encode``/``step``/``decode``,
    ``save``)."""
    coco = CocoAnnotations.load_shot(os.path.join(datasets_dir, dataset),
                                     shot)
    result_root = os.path.join(output_dir, "result")
    outpaint_root = os.path.join(output_dir, "outpaint_hires",
                                 f"process_{stage.process_id}", dataset,
                                 f"{shot}_shot")
    manifest = Manifest(os.path.join(outpaint_root, "manifest.json"),
                        process_id=stage.process_id)
    write = stage.writes()
    for m in (stage.mesh, stage.pipe_mesh):
        if m is not None:       # every rank read the manifest before
            m.barrier()         # rank 0 writes it
    mark = manifest.mark if write else (lambda *a, **kw: None)

    sample_map = {}
    for image_id in coco.image_ids():
        sample_id = os.path.splitext(coco.file_name(image_id))[0]
        sample_map[sample_id] = image_id
    # the reference also enumerates samples straight from the generate
    # stage's result dirs (ref :1458-1577); result-only samples take the
    # fallback input path (target_input.png + synthetic bboxes)
    result_pattern = os.path.join(result_root,
                                  f"{dataset}_{shot}shot_retrieval",
                                  "results_*", "*")
    for sample_dir in glob.glob(result_pattern):
        name = os.path.basename(sample_dir)
        if os.path.isdir(sample_dir):
            sample_map.setdefault(name, None)
    todo = set(manifest.pending(
        worker_slice(sorted(sample_map), worker_id, num_workers),
        resume=resume, failed_only=failed_only))

    work = [(s_id, i_id) for s_id, i_id in sorted(sample_map.items())
            if s_id in todo]
    bbox_crops_dir = os.path.join(output_dir, "bbox_crops")

    def load_item(item):
        sample_id, image_id = item
        bg_paths = find_sample_backgrounds(result_root, dataset, shot,
                                           sample_id)
        if not bg_paths:
            return sample_id, image_id, [], None, None, None
        if image_id is None:
            # not in annotations: fallback recovery (ref :924-1077)
            fb = fallback_sample_inputs(dataset, sample_id, result_root,
                                        shot, bbox_crops_dir)
            if fb is None:
                raise ValueError(
                    f"sample {sample_id} has no annotations and no "
                    "target_input.png to fall back on")
            original, bboxes, categories = fb
            return sample_id, None, bg_paths, original, bboxes, categories
        info = coco.images[image_id]
        src = os.path.join(datasets_dir, dataset, "train", info.file_name)
        if not os.path.exists(src):
            src = os.path.join(datasets_dir, dataset, info.file_name)
        original = imaging.load_rgb(src)
        if original.size != (info.width, info.height):
            original = original.resize((info.width, info.height))
        return (sample_id, image_id, bg_paths, original,
                coco.bboxes_for_image(image_id),
                coco.category_names_for_image(image_id))

    logs: List[dict] = []
    reporter = ProgressReporter(len(work), label="compose")
    # host IO/preprocess overlaps the device denoise (double buffering)
    loader = prefetch(work, load_item, depth=2)
    for loaded in loader:
        if should_stop():
            logger.warning("graceful stop requested; %d samples remain",
                           reporter.total - reporter.done)
            loader.close()
            break
        if isinstance(loaded, PrefetchError):
            sample_id = loaded.item[0]
            logger.error("failed to load sample %s: %s", sample_id,
                         loaded.__cause__)
            mark(sample_id, STATUS_FAILED,
                 error=f"load failed: {loaded.__cause__}")
            reporter.update(ok=False, detail=sample_id)
            continue
        sample_id, image_id, bg_paths, original, bboxes, categories = loaded
        if not bg_paths:
            logger.warning("no generated backgrounds for %s", sample_id)
            mark(sample_id, STATUS_FAILED, error="no generated backgrounds")
            reporter.update(ok=False, detail=sample_id)
            continue
        start = time.perf_counter()
        try:
            log = stage.process_sample(
                dataset, shot, sample_id, original, bboxes, categories,
                bg_paths,
                os.path.join(outpaint_root, sample_id),
                image_id=image_id, timer=timer)
            logs.append(log)
            mark(sample_id, STATUS_DONE,
                 elapsed_s=time.perf_counter() - start)
            reporter.update(ok=True, detail=sample_id)
        except Exception as e:
            logger.exception("compose failed for %s", sample_id)
            mark(sample_id, STATUS_FAILED, error=str(e),
                 elapsed_s=time.perf_counter() - start)
            reporter.update(ok=False, detail=sample_id)

    result = formatted_result_json(dataset, logs, shot, stage.process_id)
    if write:
        os.makedirs(outpaint_root, exist_ok=True)
        out_json = os.path.join(outpaint_root,
                                f"outpaint_results_{shot}shot.json")
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
        collect_final_results(output_dir, stage.process_id, shot)
    return result


def collect_final_results(output_dir: str, process_id: str,
                          shot: Optional[int] = None) -> str:
    """Copy ``*_final_result*.png`` into ``final_results/process_{id}``
    (ref :1813-1886)."""
    import shutil
    collection = os.path.join(output_dir, "final_results",
                              f"process_{process_id}")
    if shot is not None:
        collection = os.path.join(collection, f"{shot}_shot")
    os.makedirs(collection, exist_ok=True)
    outpaint_root = os.path.join(output_dir, "outpaint_hires",
                                 f"process_{process_id}")
    if not os.path.isdir(outpaint_root):
        return collection
    pattern = os.path.join(outpaint_root, "*",
                           f"{shot}_shot" if shot else "*", "*",
                           "*_final_result*.png")
    for path in glob.glob(pattern):
        parts = path.split(os.sep)
        dataset = parts[-4]
        dest_dir = os.path.join(collection, dataset)
        os.makedirs(dest_dir, exist_ok=True)
        shutil.copy(path, os.path.join(dest_dir, os.path.basename(path)))
    return collection

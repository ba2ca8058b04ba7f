"""Stage 3 — domain-guided background generation (port of
``domainrag_tpu/stages/generate.py``).

Per sample of the lamainpaint shot dir: the top retrieved corpus images
from stage 2's ``all_shots_retrieval_results.json`` (or a seeded random
corpus fallback), the dual-image Redux prior of each (retrieved ref,
target) pair (scales [0.8, 1.0] / [1.0, 1.0], empty prompt) and
FLUX.1-dev (guidance 2.5, 50 steps, 1024x1024, seed 0), all ranks of a
sample denoised as one batch or in chunks of ``max_rank_batch``.

Run tree (what stage 4's ``results_*`` glob reads):
``{out}/result/{dataset}_{shot}shot_retrieval/{run_name}/`` with
``batch_params.txt`` (header, then the totals), ``manifest.json`` and one
dir per sample holding ``generated_image_rank{r}.png``,
``ref_inforank{r}*.txt``, ``ref_inputrank{r}.jpg``, ``target_input.png``
and ``params.txt``.

:func:`process_dataset` runs the single-device pipelined loop: the next
sample's SigLIP inputs are decoded in a prefetch thread and the previous
sample's PNG writes run on one writer thread while the card denoises.
With ``mesh`` (every rank of a ``parallel.mesh.Mesh`` running the same
sweep) the (sample, rank) rows of groups of samples denoise data-parallel
(:func:`generate_samples_dp`); with ``pipe_mesh`` each sample's denoise
pipelines the transformer depth. Under either, rank 0 alone writes, and
the tree is the one a single-device run writes.
"""

from __future__ import annotations

import glob
import os
import random
import shutil
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import imaging
from ..core.config import GenerateConfig, worker_slice
from ..core.interrupt import should_stop
from ..core.log import StepTimer, get_logger
from ..core.manifest import Manifest, STATUS_DONE, STATUS_FAILED
from ..core.progress import ProgressReporter
from ..models.flux import pipeline as flux_pipeline

logger = get_logger("domainrag_tpu_torch.generate")


def _writes(*meshes) -> bool:
    """True where this process writes the run's artifacts: always without
    a mesh, on the mesh's rank 0 with one."""
    return all(m is None or m.is_writer() for m in meshes)


def top_ranked_refs(retrieval_results: dict, dataset: str, shot: int,
                    sample_id: str, top_ranks: int = 5
                    ) -> Optional[List[dict]]:
    """A sample's <= top_ranks retrieved refs in the all-shots JSON, by
    its canonical keys (the tolerant reader is :mod:`stages.migrate`)."""
    shot_block = retrieval_results.get(dataset, {}).get(f"{shot}_shot")
    if not shot_block:
        return None
    for category_entries in shot_block.values():
        for entry in category_entries:
            if entry.get("sample_id") == sample_id:
                sims = entry.get("similar_images", [])
                return [s for s in sims
                        if s.get("rank", 99) <= top_ranks][:top_ranks]
    return None


def fallback_seed(dataset: str, shot: int, sample_id: str) -> int:
    """Process-stable seed for the random-corpus fallback: CRC32 of the
    canonical key (Python's str ``hash`` is salted per interpreter)."""
    return zlib.crc32(f"{dataset}/{shot}_shot/{sample_id}".encode("utf-8"))


def random_fallback_refs(corpus_paths: Sequence[str], top_ranks: int,
                         seed: int) -> List[dict]:
    """ref :1213-1228: random corpus refs with similarities 1.0 - 0.1*i,
    drawn by ``random.Random(seed)`` (see :func:`fallback_seed`)."""
    rng = random.Random(seed)
    picks = rng.sample(list(corpus_paths), min(top_ranks, len(corpus_paths)))
    return [{"rank": i + 1, "similarity": 1.0 - 0.1 * i, "image_path": p,
             "source_dataset": "random_fallback"}
            for i, p in enumerate(picks)]


@dataclass
class GenerateStage:
    bundle: flux_pipeline.FluxBundle
    cfg: GenerateConfig

    def _prior_for_pair(self, ref_path: str, target_path: str):
        """One (ref, target) pair's prior, both images through the tower."""
        size = self.bundle.siglip_cfg.image_size
        ref_px = imaging.siglip_preprocess(imaging.load_rgb(ref_path), size)
        tgt_px = imaging.siglip_preprocess(imaging.load_rgb(target_path),
                                           size)
        r = self.cfg.redux
        return flux_pipeline.redux_prior(
            self.bundle, np.stack([ref_px, tgt_px]),
            [r.prompt, r.prompt],
            prompt_embeds_scale=[r.ref_image_scale, r.target_image_scale],
            pooled_prompt_embeds_scale=[r.ref_text_scale,
                                        r.target_text_scale])

    def _prior_inputs(self, refs: List[dict], target_path: str):
        """Host-side half of the prior: PIL decode + SigLIP preprocess of
        the sample's unique images (the refs, then the target) and the
        (ref, target) index pairs. Pure host work, safe in a prefetch
        thread while the card denoises the previous sample."""
        size = self.bundle.siglip_cfg.image_size
        unique = np.stack(
            [imaging.siglip_preprocess(imaging.load_rgb(r["image_path"]),
                                       size) for r in refs]
            + [imaging.siglip_preprocess(imaging.load_rgb(target_path),
                                         size)])
        k = len(refs)
        pair_idx = np.stack([np.arange(k), np.full(k, k)], axis=1)
        return unique, pair_idx

    def _priors_for_sample(self, refs: List[dict], target_path: str,
                           prior_inputs=None,
                           timer: Optional[StepTimer] = None):
        """All ranks' (ref, target) priors in one batched tower forward,
        the shared target encoded once; ``prior_inputs`` are
        :meth:`_prior_inputs`' arrays when the caller prefetched them,
        else they are made here in a ``prior/inputs`` span of ``timer``,
        which also gets the towers' ``prior/text`` and ``prior/image``."""
        timer = timer or StepTimer()
        if prior_inputs is None:
            with timer.span("prior/inputs"):
                prior_inputs = self._prior_inputs(refs, target_path)
        unique, pair_idx = prior_inputs
        r = self.cfg.redux
        return flux_pipeline.redux_prior_pairs_indexed(
            self.bundle, unique, pair_idx, r.prompt,
            prompt_embeds_scale=[r.ref_image_scale, r.target_image_scale],
            pooled_prompt_embeds_scale=[r.ref_text_scale,
                                        r.target_text_scale],
            timer=timer)

    def generate_sample(self, sample_id: str, target_path: str,
                        refs: List[dict], sample_dir: str,
                        timer: Optional[StepTimer] = None,
                        pipe_mesh=None, pipe_axis: str = "pipe",
                        prior_inputs=None, writer=None):
        """All ranks of one sample; returns the written image paths.

        ``timer`` gets ``prior`` (holding ``prior/inputs`` where the
        inputs are not given, ``prior/text`` where the text towers run,
        and ``prior/image``), ``denoise`` (with the pipeline's ``step``
        and ``decode``) and, without a writer, ``save``. ``prior_inputs``:
        precomputed :meth:`_prior_inputs`. ``writer``: an executor; the
        PNG/provenance writes of the decoded host arrays are submitted
        there and a Future of the written paths is returned instead.
        ``pipe_mesh``: the transformer depth pipelined over its
        ``pipe_axis`` (``parallel.pipeline_parallel``); every rank of it
        makes this call and only rank 0 writes (the others return the
        paths rank 0 writes)."""
        timer = timer or StepTimer()
        s = self.cfg.sampling
        write = _writes(pipe_mesh)
        if write:
            os.makedirs(sample_dir, exist_ok=True)
        with timer.span("prior"):
            embeds, pooleds = self._priors_for_sample(refs, target_path,
                                                      prior_inputs, timer)

        def run(e, p, n):
            out = flux_pipeline.generate(
                self.bundle, e, p, height=s.height, width=s.width,
                num_steps=s.num_steps, guidance=s.guidance_scale,
                seed=[s.seed] * n,
                scheduler_overrides={
                    "use_dynamic_shifting": s.use_dynamic_shifting,
                    "base_shift": s.base_shift, "max_shift": s.max_shift},
                block_cache_interval=getattr(s, "block_cache_interval", 1),
                velocity_cache_interval=getattr(
                    s, "velocity_cache_interval", 1),
                velocity_cache_order=getattr(s, "velocity_cache_order", 1),
                mesh=pipe_mesh,
                pipe_axis=pipe_axis if pipe_mesh is not None else None,
                timer=timer)
            return out[None] if out.ndim == 3 else out

        mb = self.cfg.max_rank_batch
        with timer.span("denoise"):
            if mb and pipe_mesh is None and len(refs) > mb:
                images = np.concatenate([
                    run(embeds[i:i + mb], pooleds[i:i + mb],
                        min(mb, len(refs) - i))
                    for i in range(0, len(refs), mb)])
            else:
                images = run(embeds, pooleds, len(refs))

        def save():
            if not write:
                return [_rank_image_path(sample_dir, ref) for ref in refs]
            out_paths = [_write_rank_artifacts(sample_dir, ref, target_path,
                                               img)
                         for ref, img in zip(refs, images)]
            _write_sample_provenance(sample_dir, target_path, self.cfg)
            return out_paths

        if writer is not None:
            return writer.submit(save)
        with timer.span("save"):
            return save()


def _rank_image_path(sample_dir: str, ref: dict) -> str:
    return os.path.join(sample_dir,
                        f"generated_image_rank{ref.get('rank', 1)}.png")


def _write_rank_artifacts(sample_dir: str, ref: dict, target_path: str,
                          img: np.ndarray) -> str:
    """One rank's image + provenance."""
    from PIL import Image
    os.makedirs(sample_dir, exist_ok=True)
    rank = ref.get("rank", 1)
    out = _rank_image_path(sample_dir, ref)
    Image.fromarray(img).save(out)
    sim = ref.get("similarity")
    sim_str = f"_sim{sim:.4f}" if sim is not None else ""
    with open(os.path.join(sample_dir,
                           f"ref_inforank{rank}{sim_str}.txt"), "w") as f:
        f.write(f"reference: {ref['image_path']}\n"
                f"target: {target_path}\n"
                f"rank: {rank}\nsimilarity: {sim}\n"
                f"source: {ref.get('source_dataset')}\n")
    try:
        shutil.copy(ref["image_path"],
                    os.path.join(sample_dir, f"ref_inputrank{rank}.jpg"))
    except OSError:
        pass
    return out


def _write_sample_provenance(sample_dir: str, target_path: str,
                             cfg: GenerateConfig) -> None:
    target_copy = os.path.join(sample_dir, "target_input.png")
    if not os.path.exists(target_copy):
        shutil.copy(target_path, target_copy)
    params_file = os.path.join(sample_dir, "params.txt")
    if not os.path.exists(params_file):
        r, s = cfg.redux, cfg.sampling
        with open(params_file, "w") as f:
            f.write(
                f"ref_image_scale: {r.ref_image_scale}\n"
                f"target_image_scale: {r.target_image_scale}\n"
                f"ref_text_scale: {r.ref_text_scale}\n"
                f"target_text_scale: {r.target_text_scale}\n"
                f"prompt: {r.prompt}\n"
                f"guidance_scale: {s.guidance_scale}\n"
                f"num_inference_steps: {s.num_steps}\n"
                f"size: {s.width}x{s.height}\nseed: {s.seed}\n")


def generate_samples_dp(stage: GenerateStage, items: List[dict], mesh,
                        timer: Optional[StepTimer] = None
                        ) -> Dict[str, List[str]]:
    """Data-parallel batch across SAMPLES and ranks: every (sample, rank)
    pair is one row of a batch split over the mesh's data axis (one
    denoise for the whole group instead of a process per card). Every
    rank of the mesh makes this call; rank 0 writes.

    items: [{sample_id, target_path, refs, sample_dir}]. Returns
    {sample_id: [image paths]}."""
    timer = timer or StepTimer()
    s = stage.cfg.sampling
    r = stage.cfg.redux
    size = stage.bundle.siglip_cfg.image_size

    pairs = [(item, ref) for item in items for ref in item["refs"]]
    if not pairs:
        return {}

    with timer.span("prior"):
        # unique-image prior: each path's tower forward runs once even
        # though a sample's target appears in every one of its ranks
        path_to_idx: Dict[str, int] = {}
        unique_imgs: List[np.ndarray] = []

        def idx_of(path: str) -> int:
            if path not in path_to_idx:
                path_to_idx[path] = len(unique_imgs)
                unique_imgs.append(imaging.siglip_preprocess(
                    imaging.load_rgb(path), size))
            return path_to_idx[path]

        pair_idx = np.asarray([[idx_of(ref["image_path"]),
                                idx_of(item["target_path"])]
                               for item, ref in pairs])
        embeds, pooleds = flux_pipeline.redux_prior_pairs_indexed(
            stage.bundle, np.stack(unique_imgs), pair_idx, r.prompt,
            prompt_embeds_scale=[r.ref_image_scale, r.target_image_scale],
            pooled_prompt_embeds_scale=[r.ref_text_scale,
                                        r.target_text_scale],
            timer=timer)
    with timer.span("denoise"):
        images = flux_pipeline.generate(
            stage.bundle, embeds, pooleds, height=s.height, width=s.width,
            num_steps=s.num_steps, guidance=s.guidance_scale,
            seed=[s.seed] * len(pairs), mesh=mesh,
            scheduler_overrides={
                "use_dynamic_shifting": s.use_dynamic_shifting,
                "base_shift": s.base_shift, "max_shift": s.max_shift},
            block_cache_interval=getattr(s, "block_cache_interval", 1),
            velocity_cache_interval=getattr(
                s, "velocity_cache_interval", 1),
            velocity_cache_order=getattr(s, "velocity_cache_order", 1),
            timer=timer)
    if images.ndim == 3:
        images = images[None]

    out: Dict[str, List[str]] = {}
    write = _writes(mesh)
    with timer.span("save"):
        for (item, ref), img in zip(pairs, images):
            path = (_write_rank_artifacts(item["sample_dir"], ref,
                                          item["target_path"], img)
                    if write else _rank_image_path(item["sample_dir"], ref))
            out.setdefault(item["sample_id"], []).append(path)
        if write:
            for item in items:
                _write_sample_provenance(item["sample_dir"],
                                         item["target_path"], stage.cfg)
    return out


def results_dir_name(cfg: GenerateConfig, timestamp: str) -> str:
    r = cfg.redux
    return (f"results_coco_{r.ref_image_scale}_target_{r.target_image_scale}"
            f"_cocotext_{r.ref_text_scale}_targettext_{r.target_text_scale}"
            f"_{timestamp}")


def write_batch_params_header(base_dir: str, dataset: str,
                              cfg: GenerateConfig, n_samples: int) -> None:
    """The run's parameter record, written before the sweep (ref
    batch_generate_flux_kshot.py:552-564)."""
    r, s = cfg.redux, cfg.sampling
    with open(os.path.join(base_dir, "batch_params.txt"), "w") as f:
        f.write(f"dataset: {dataset}\n"
                f"ref_image_scale: {r.ref_image_scale}\n"
                f"target_image_scale: {r.target_image_scale}\n"
                f"ref_text_scale: {r.ref_text_scale}\n"
                f"target_text_scale: {r.target_text_scale}\n"
                f"prompt: {r.prompt}\n"
                f"guidance_scale: {s.guidance_scale}\n"
                f"num_inference_steps: {s.num_steps}\n"
                f"num_samples: {n_samples}\n"
                f"images_per_sample: up to {cfg.top_ranks} "
                f"(highest-similarity refs)\n"
                f"image_size: {s.width}x{s.height}\n")


def append_batch_params_totals(base_dir: str, counters: Dict[str, int],
                               total_images: int,
                               image_sizes: Dict[str, int],
                               worker_tag: str = None) -> None:
    """The sweep's totals, appended after it (ref :1045-1056): sample
    counts, generated images, a histogram of image sizes and the
    completion time; a sharded worker appends its own tagged block."""
    with open(os.path.join(base_dir, "batch_params.txt"), "a") as f:
        if worker_tag:
            f.write(f"\n[{worker_tag}]\n")
        f.write(f"succeeded_samples: {counters.get('processed', 0)}\n"
                f"failed_samples: {counters.get('failed', 0)}\n"
                f"total_generated_images: {total_images}\n"
                f"\ngenerated_size_histogram:\n")
        for size_str, count in sorted(image_sizes.items(),
                                      key=lambda x: x[1], reverse=True):
            f.write(f"  - {size_str}: {count} images\n")
        f.write(f"\ncompleted: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")


def process_dataset(stage: GenerateStage, dataset: str, shot: int,
                    retrieval_results: dict, lamainpaint_dir: str,
                    output_dir: str,
                    corpus_paths: Sequence[str] = (),
                    resume: bool = False,
                    run_name: Optional[str] = None,
                    worker_id: int = 0,
                    num_workers: int = 1,
                    mesh=None,
                    dp_samples: int = 0,
                    pipe_mesh=None,
                    pipe_axis: str = "pipe",
                    reference_artifacts: bool = False,
                    corpus_roots: Optional[Dict[str, str]] = None, *,
                    timer: Optional[StepTimer] = None) -> Dict[str, int]:
    """One dataset x shot sweep (ref :766-1058): the samples of the
    lamainpaint shot dir (this worker's round-robin share), their refs
    resolved first (seeded random corpus fallback for a sample the JSON
    lacks), then the pipelined loop. Returns the counters {processed,
    failed, skipped, fallback} (+ the migration tallies).

    ``reference_artifacts``: read the retrieval JSON through the tolerant
    reader of :mod:`stages.migrate`. ``timer`` (the port's own) gets
    every sample's spans.

    With ``mesh``, samples are processed in data-parallel groups of
    ``dp_samples`` (default: enough samples to fill the data axis with
    (sample, rank) rows) through :func:`generate_samples_dp`. With
    ``pipe_mesh`` (not with ``mesh``), each sample's batched-rank denoise
    pipelines the transformer depth over the pipe axis instead. Every
    rank of the mesh runs the sweep; rank 0 alone writes the tree."""
    if mesh is not None and pipe_mesh is not None:
        raise ValueError("mesh and pipe_mesh are mutually exclusive: data "
                         "parallelism or a pipelined transformer")
    write = _writes(mesh, pipe_mesh)
    shot_dir = os.path.join(lamainpaint_dir, dataset, f"{shot}_shot")
    if not os.path.isdir(shot_dir):
        logger.error("missing shot dir %s", shot_dir)
        return {}
    samples = worker_slice(
        sorted(os.path.splitext(os.path.basename(p))[0]
               for p in glob.glob(os.path.join(shot_dir, "*.jpg"))),
        worker_id, num_workers)
    result_root = os.path.join(output_dir, "result",
                               f"{dataset}_{shot}shot_retrieval")
    if run_name is None:
        run_name = results_dir_name(stage.cfg,
                                    time.strftime("%Y%m%d_%H%M%S"))
    base_dir = os.path.join(result_root, run_name)
    # a manifest per worker under sharding (each is rewritten whole)
    mname = "manifest.json" if num_workers <= 1 \
        else f"manifest.worker{worker_id}.json"
    manifest = Manifest(os.path.join(base_dir, mname))
    for m in (mesh, pipe_mesh):
        if m is not None:       # every rank read the manifest before
            m.barrier()         # rank 0 writes into the run dir
    if write:
        os.makedirs(base_dir, exist_ok=True)
        if worker_id == 0:
            write_batch_params_header(base_dir, dataset, stage.cfg,
                                      len(samples))
    mark = manifest.mark if write else (lambda *a, **kw: None)

    counters = {"processed": 0, "failed": 0, "skipped": 0, "fallback": 0}
    total_images = 0
    image_sizes: Dict[str, int] = {}
    todo = set(manifest.pending(samples, resume=resume))
    reporter = ProgressReporter(len(todo), label="generate")

    mig_stats = None
    if reference_artifacts:
        from .migrate import MigrationStats, find_sample_refs_tolerant
        mig_stats = MigrationStats()

    # resolve refs for every pending sample first (cheap host work)
    items = []
    for sample_id in samples:
        if sample_id not in todo:
            counters["skipped"] += 1
            continue
        target_path = os.path.join(shot_dir, f"{sample_id}.jpg")
        if reference_artifacts:
            refs = find_sample_refs_tolerant(
                retrieval_results, dataset, shot, sample_id,
                stage.cfg.top_ranks, corpus_roots=corpus_roots,
                stats=mig_stats)
        else:
            refs = top_ranked_refs(retrieval_results, dataset, shot,
                                   sample_id, stage.cfg.top_ranks)
        if not refs:
            if not corpus_paths:
                logger.warning("no retrieval refs and no corpus fallback "
                               "for %s", sample_id)
                counters["failed"] += 1
                mark(sample_id, STATUS_FAILED, error="no retrieval refs")
                reporter.update(ok=False, detail=sample_id)
                continue
            refs = random_fallback_refs(
                corpus_paths, stage.cfg.top_ranks,
                seed=fallback_seed(dataset, shot, sample_id))
            counters["fallback"] += 1
            logger.warning(
                "sample %s missing from retrieval JSON — using seeded "
                "random corpus fallback (ref :1213-1228)", sample_id)
        items.append({"sample_id": sample_id, "target_path": target_path,
                      "refs": refs,
                      "sample_dir": os.path.join(base_dir, sample_id)})

    size_key = (f"{stage.cfg.sampling.width}x"
                f"{stage.cfg.sampling.height}")

    def _mark_done(item, paths, elapsed):
        nonlocal total_images
        counters["processed"] += 1
        total_images += len(paths)
        image_sizes[size_key] = image_sizes.get(size_key, 0) + len(paths)
        mark(item["sample_id"], STATUS_DONE, outputs={"images": paths},
             elapsed_s=elapsed)
        reporter.update(ok=True, detail=item["sample_id"])

    def _mark_failed(item, e):
        logger.error("generation failed for %s", item["sample_id"],
                     exc_info=e)
        if write:
            os.makedirs(item["sample_dir"], exist_ok=True)
            with open(os.path.join(item["sample_dir"],
                                   "generation_failed.txt"), "w") as f:
                f.write(str(e))
        counters["failed"] += 1
        mark(item["sample_id"], STATUS_FAILED, error=str(e))
        reporter.update(ok=False, detail=item["sample_id"])

    if mesh is not None:
        # data-parallel groups: a failure inside the group's collectives
        # is every rank's, so it ends the run rather than desynchronizing
        if dp_samples <= 0:
            dp_samples = max(1, mesh.shape.get("data", 1)
                             // max(stage.cfg.top_ranks, 1))
        for i in range(0, len(items), dp_samples):
            if should_stop():
                logger.warning("graceful stop requested during generate")
                break
            group = items[i:i + dp_samples]
            start = time.perf_counter()
            paths = generate_samples_dp(stage, group, mesh, timer=timer)
            elapsed = (time.perf_counter() - start) / len(group)
            for item in group:
                _mark_done(item, paths.get(item["sample_id"], []), elapsed)
        return _finish(base_dir, dataset, shot, counters, total_images,
                       image_sizes, mig_stats, worker_id, num_workers,
                       write)

    # The pipelined single-device loop: the prior/denoise/decode work
    # serializes on the card, so the overlap to win is host work on both
    # sides of the device queue. The next sample's PIL decode + SigLIP
    # preprocessing runs in a prefetch thread and the previous sample's
    # PNG/provenance writes in a writer thread while the card denoises the
    # current one (the reference ran all of it in line, ref :996-1058).
    from concurrent.futures import ThreadPoolExecutor

    from ..core.prefetch import PrefetchError
    from ..core.prefetch import prefetch as _prefetch

    def _resolve(entry):
        item, start, fut = entry
        try:
            paths = fut.result()
            _mark_done(item, paths, time.perf_counter() - start)
        except Exception as e:
            _mark_failed(item, e)

    pending: List[tuple] = []
    writer = ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="gen-writer")
    prior_stream = _prefetch(
        items, lambda it: (it, stage._prior_inputs(it["refs"],
                                                   it["target_path"])),
        depth=2)
    try:
        for got in prior_stream:
            if should_stop():
                logger.warning("graceful stop requested during generate")
                break
            if isinstance(got, PrefetchError):
                _mark_failed(got.item, got.__cause__ or got)
                continue
            item, prior_inputs = got
            start = time.perf_counter()
            try:
                fut = stage.generate_sample(
                    item["sample_id"], item["target_path"], item["refs"],
                    item["sample_dir"], timer=timer, pipe_mesh=pipe_mesh,
                    pipe_axis=pipe_axis, prior_inputs=prior_inputs,
                    writer=writer)
            except Exception as e:
                _mark_failed(item, e)
                continue
            pending.append((item, start, fut))
            while len(pending) > 1:
                _resolve(pending.pop(0))
    finally:
        prior_stream.close()
        for entry in pending:
            _resolve(entry)
        writer.shutdown(wait=True)
    return _finish(base_dir, dataset, shot, counters, total_images,
                   image_sizes, mig_stats, worker_id, num_workers, write)


def _finish(base_dir, dataset, shot, counters, total_images, image_sizes,
            mig_stats, worker_id, num_workers, write) -> Dict[str, int]:
    """The sweep's migration tallies and the totals block of
    ``batch_params.txt`` (where this process writes)."""
    if mig_stats is not None:
        logger.warning("%s %d_shot %s", dataset, shot, mig_stats.summary())
        counters["fuzzy_hits"] = mig_stats.fuzzy
        counters["migration_missed"] = mig_stats.missed
        counters["repaired_paths"] = mig_stats.repaired_paths
    if write:
        append_batch_params_totals(base_dir, counters, total_images,
                                   image_sizes,
                                   worker_tag=(f"worker{worker_id}"
                                               if num_workers > 1 else None))
    logger.info("%s %d_shot generate: %s", dataset, shot, counters)
    return counters


# ---------------------------------------------------------------------------
# legacy no-retrieval-JSON mode (ref batch_generate_flux_kshot.py:526-736)
# ---------------------------------------------------------------------------

def load_legacy_retrieval_results(retrieval_results_dir: str,
                                  dataset: str) -> Optional[dict]:
    """Per-dataset legacy retrieval file (ref :155-163):
    ``{dir}/{dataset}_all_categories_retrieval_results.json`` with layout
    {category: [{original_filename, similar_images: [{image_path,
    similarity}]}]}."""
    import json
    path = os.path.join(retrieval_results_dir,
                        f"{dataset}_all_categories_retrieval_results.json")
    if not os.path.exists(path):
        logger.warning("no legacy retrieval results for %s (%s)", dataset,
                       path)
        return None
    with open(path) as f:
        return json.load(f)


def find_similar_image_legacy(retrieval_results: dict, sample_name: str,
                              categories: Sequence[str]
                              ) -> Optional[str]:
    """Single best match per the legacy rules (ref :250-300): substring
    match of the sample name in ``original_filename``, prefer
    non-"_blurred" corpus paths, highest similarity wins."""
    if isinstance(categories, str):
        categories = [categories]
    for category in categories:
        for item in retrieval_results.get(category, []):
            if sample_name not in item.get("original_filename", ""):
                continue
            non_blurred, blurred = [], []
            for similar in item.get("similar_images", []):
                path = similar.get("image_path", "")
                if not path or not os.path.exists(path):
                    continue
                bucket = blurred if "_blurred" in os.path.basename(path) \
                    else non_blurred
                bucket.append((similar.get("similarity", 0.0), path))
            for bucket in (non_blurred, blurred):
                if bucket:
                    return max(bucket, key=lambda x: x[0])[1]
    return None


def legacy_sample_folders(inpainted_dir: str, dataset: str) -> List[str]:
    """Sample dirs of the legacy (non-k-shot) inpaint layout
    ``{inpainted_dir}/{dataset}/inpainted_images/{sample}/`` (ref
    :165-177)."""
    root = os.path.join(inpainted_dir, dataset, "inpainted_images")
    if not os.path.isdir(root):
        logger.warning("no legacy inpainted dir for %s (%s)", dataset, root)
        return []
    return sorted(f for f in os.listdir(root)
                  if os.path.isdir(os.path.join(root, f))
                  and f != "__pycache__")


def process_dataset_legacy(stage: GenerateStage, dataset: str,
                           inpainted_dir: str, retrieval_results_dir: str,
                           output_dir: str,
                           resume: bool = False,
                           run_name: Optional[str] = None
                           ) -> Dict[str, int]:
    """Legacy generation mode (ref ``process_dataset`` :526-736): no
    all-shots retrieval JSON and no k-shot sweep. Targets come from the
    legacy inpaint layout (``inpainted_images/{sample}/1_inpainted.png``),
    the single most similar corpus image is chosen per sample from the
    per-dataset legacy retrieval file, and ONE ``generated_image.png`` is
    written per sample, with the same ``batch_params.txt`` run summary."""
    from ..core.config import DATASET_CATEGORIES

    retrieval_results = load_legacy_retrieval_results(
        retrieval_results_dir, dataset)
    samples = legacy_sample_folders(inpainted_dir, dataset)
    if retrieval_results is None or not samples:
        return {}
    if run_name is None:
        run_name = results_dir_name(stage.cfg,
                                    time.strftime("%Y%m%d_%H%M%S"))
    base_dir = os.path.join(output_dir, dataset, run_name)
    os.makedirs(base_dir, exist_ok=True)
    manifest = Manifest(os.path.join(base_dir, "manifest.json"))
    write_batch_params_header(base_dir, dataset, stage.cfg, len(samples))

    categories = DATASET_CATEGORIES.get(dataset.lower(), [dataset.lower()])
    counters = {"processed": 0, "failed": 0, "skipped": 0}
    total_images = 0
    image_sizes: Dict[str, int] = {}
    todo = set(manifest.pending(samples, resume=resume))
    reporter = ProgressReporter(len(todo), label="generate-legacy")
    for sample_name in samples:
        if should_stop():
            logger.warning("graceful stop requested during legacy generate")
            break
        if sample_name not in todo:
            counters["skipped"] += 1
            continue
        target = os.path.join(inpainted_dir, dataset, "inpainted_images",
                              sample_name, "1_inpainted.png")
        if not os.path.exists(target):
            counters["failed"] += 1
            manifest.mark(sample_name, STATUS_FAILED,
                          error="missing 1_inpainted.png")
            reporter.update(ok=False, detail=sample_name)
            continue
        ref_path = find_similar_image_legacy(retrieval_results,
                                             sample_name, categories)
        if ref_path is None:
            counters["failed"] += 1
            manifest.mark(sample_name, STATUS_FAILED,
                          error="no matching corpus image")
            reporter.update(ok=False, detail=sample_name)
            continue
        sample_dir = os.path.join(base_dir, sample_name)
        try:
            paths = stage.generate_sample(
                sample_name, target, [{"image_path": ref_path, "rank": 1}],
                sample_dir)
            # legacy naming: one un-ranked generated_image.png (ref :608)
            legacy_path = os.path.join(sample_dir, "generated_image.png")
            os.replace(paths[0], legacy_path)
            counters["processed"] += 1
            total_images += 1
            size_key = (f"{stage.cfg.sampling.width}x"
                        f"{stage.cfg.sampling.height}")
            image_sizes[size_key] = image_sizes.get(size_key, 0) + 1
            manifest.mark(sample_name, STATUS_DONE,
                          outputs={"images": [legacy_path]})
            reporter.update(ok=True, detail=sample_name)
        except Exception as e:
            logger.exception("legacy generation failed for %s", sample_name)
            os.makedirs(sample_dir, exist_ok=True)
            with open(os.path.join(sample_dir,
                                   "generation_failed.txt"), "w") as f:
                f.write(str(e))
            counters["failed"] += 1
            manifest.mark(sample_name, STATUS_FAILED, error=str(e))
            reporter.update(ok=False, detail=sample_name)
    append_batch_params_totals(base_dir, counters, total_images,
                               image_sizes)
    logger.info("%s legacy generate: %s", dataset, counters)
    return counters

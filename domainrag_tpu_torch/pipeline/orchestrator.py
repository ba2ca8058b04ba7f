"""Manifest-driven pipeline orchestrator — replaces ``domainrag.sh`` (port
of ``domainrag_tpu/pipeline/orchestrator.py``).

The reference's end-to-end run is four fire-and-forget shell phases with no
cross-phase scheduler (domainrag.sh:1-31; SURVEY.md §3.5). Here the DAG is
explicit: inpaint -> retrieve -> generate -> compose, each stage consuming
the previous stage's on-disk artifacts (the L4 contract is preserved so
stages stay independently re-runnable) and reporting into per-stage
manifests.

The port serves one card per process. The processes launched together
(``torchrun --nproc_per_node G``) form one mesh (``parallel/mesh.py``):
every rank runs the same DAG over the same samples, the bank shards over
the data axis, stage 3 batches (sample, rank) rows over it (or pipelines
the depth over a ``pipe`` axis), stage 4's hires fills ring their
attention over it, and rank 0 alone writes, with a barrier after each
stage. Several cards also run as workers over disjoint sample slices
(``cfg.worker_id`` / ``num_workers``, or ``--distributed``); worker 0
merges the retrieval partials and generate manifests. Under
``--distributed`` a worker is a host, and its processes run its slice
as one mesh (``parallel.multihost.worker_mesh``) whose first rank writes.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import device as device_mod
from ..core import prng
from ..core.config import PipelineConfig
from ..core.log import StepTimer, get_logger
from ..models import clip as clip_mod
from ..models import lama as lama_mod
from ..models import resnet_stem
from ..models.flux import pipeline as flux_pipeline
from ..parallel import multihost
from ..parallel.mesh import Mesh, create_mesh
from ..stages import compose as compose_stage
from ..stages import generate as generate_stage
from ..stages import inpaint as inpaint_stage
from ..stages import retrieve as retrieve_stage
from ..stages.encoders import ClipImageEncoder, StyleEncoder

logger = get_logger("domainrag_tpu_torch.pipeline")

STAGES = ("inpaint", "retrieve", "generate", "compose")


@dataclasses.dataclass
class PipelineRunner:
    """Holds all models + config; runs any subset of the stage DAG. The
    models live on one device (the card unless built for the CPU)."""

    cfg: PipelineConfig
    lama_runner: inpaint_stage.LamaRunner
    clip_encoder: ClipImageEncoder
    style_encoder: StyleEncoder
    flux_bundle: flux_pipeline.FluxBundle       # dev (generation)
    fill_bundle: flux_pipeline.FluxBundle       # fill (composition)
    corpus_sources: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)                   # source -> image paths
    timer: StepTimer = dataclasses.field(default_factory=StepTimer)
    force_recompute: bool = False               # ignore feature caches
    # migration path: precomputed reference caches per source,
    # {source: (features.npy|.pt, paths.json)} — used instead of encoding
    pretrained_features: Dict[str, tuple] = dataclasses.field(
        default_factory=dict)

    # -- stage entries -----------------------------------------------------
    @property
    def lamainpaint_dir(self) -> str:
        return os.path.join(self.cfg.output_dir, "lamainpaint")

    @property
    def retrieval_dir(self) -> str:
        return os.path.join(self.cfg.output_dir, "retrieval_results")

    def _workers(self) -> bool:
        """Processes as workers over disjoint sample slices (each on one
        card), not one mesh."""
        return self.cfg.num_workers > 1

    def _group(self) -> bool:
        """Several processes in one group running the same program: a
        mesh over every rank (JAX's one process over ``jax.devices()``)."""
        return multihost.is_distributed() and not self._workers()

    def _span(self) -> int:
        """The processes that run this one's samples with it: the whole
        group as one mesh, a ``--distributed`` worker's host, or this
        process alone."""
        if self._group():
            return multihost.process_count()
        if self._workers() and multihost.is_distributed():
            return multihost.local_size()
        return 1

    def _own_mesh(self, key, build):
        """A mesh over this process's span, ``build(ranks)``: over the
        whole group, or over each worker's ranks (every process builds
        every worker's, in order); None for a process alone."""
        if self._span() == 1:
            return None
        if self._group():
            return self._mesh(key, lambda: build(list(range(
                multihost.process_count()))))
        return self._mesh(key, lambda: multihost.worker_mesh(build))

    def _mesh(self, key, build):
        cache = self.__dict__.setdefault("_meshes", {})
        if key not in cache:        # new_group is collective: build once
            cache[key] = build()
        return cache[key]

    def _writer(self) -> bool:
        """The first rank of this process's mesh (the process alone)."""
        return multihost.process_index() % self._span() == 0

    def _stage_done(self, name: str) -> None:
        """Under a mesh, the other ranks read what its first rank wrote."""
        if self._span() > 1:
            multihost.barrier(f"{name}-done")

    def run_inpaint(self, resume: bool = False):
        with self.timer.span("stage/inpaint"):
            out = {}
            if self._writer():      # not sharded: one rank runs and writes
                out = inpaint_stage.run_inpaint(
                    self.cfg.datasets, self.cfg.shots, self.lama_runner,
                    self.cfg.datasets_dir, self.cfg.output_dir,
                    resume=resume, worker_id=self.cfg.worker_id,
                    num_workers=self.cfg.num_workers)
            self._stage_done("inpaint")
            return out

    def _data_mesh(self):
        """A (data, model) mesh (sharded retrieval + DP generation) over
        every rank of the group when several processes run as one, over
        a ``--distributed`` worker's processes (JAX's multihost mesh over
        ``local_devices()``), else None."""
        return self._own_mesh("data", lambda ranks: create_mesh(
            model_parallel=self.cfg.mesh.model_parallel_size,
            devices=ranks))

    def _pipe_mesh(self):
        """Pipe mesh for depth-sharded PP serving when configured
        (mesh.pipeline_parallel_size > 1), else None: one stage per
        process of the group."""
        pp = self.cfg.mesh.pipeline_parallel_size
        if pp <= 1:
            return None
        n = self._span()
        if n < pp:              # a device is a process here: one per card
            raise ValueError(f"pipeline_parallel_size={pp} needs {pp} "
                             f"devices, found {n}")
        if n > pp:
            raise ValueError(f"pipeline_parallel_size={pp} on {n} "
                             "processes: launch one process per stage")
        return self._own_mesh("pipe", lambda ranks: Mesh(
            np.asarray(ranks), (self.cfg.mesh.pipe_axis,)))

    def _build_bank(self, mesh=None) -> retrieve_stage.EmbeddingBank:
        if mesh is not None and not mesh.is_writer():
            mesh.barrier()          # rank 0 encodes and caches the corpus
        feats, paths = {}, {}
        for source, spec in self.pretrained_features.items():
            f, kept = retrieve_stage.load_pretrained_features(*spec)
            feats[source], paths[source] = f, kept
        for source, image_paths in self.corpus_sources.items():
            if source in feats:
                continue
            f, kept = retrieve_stage.load_or_compute_source_features(
                self.retrieval_dir, source, image_paths, self.clip_encoder,
                force_recompute=self.force_recompute and (
                    mesh is None or mesh.is_writer()))
            feats[source], paths[source] = f, kept
        if mesh is not None and mesh.is_writer():
            mesh.barrier()
        return retrieve_stage.EmbeddingBank.from_sources(
            feats, paths, mesh=mesh, device=self.clip_encoder.device)

    def run_retrieve(self):
        with self.timer.span("stage/retrieve"):
            bank = self._build_bank(mesh=self._data_mesh())
            out = retrieve_stage.run_retrieval(
                self.cfg.datasets, self.cfg.shots, bank, self.clip_encoder,
                self.style_encoder, self.lamainpaint_dir,
                self.retrieval_dir, self.cfg.retrieval,
                worker_id=self.cfg.worker_id,
                num_workers=self.cfg.num_workers)
            if self._workers():
                # fence the workers, then worker 0 merges the partials
                # into the all-shots contract the next stage reads
                multihost.barrier("retrieve-done")
                if multihost.is_distributed():
                    if multihost.process_index() == 0:
                        multihost.merge_worker_retrieval_results(
                            self.retrieval_dir)
                    multihost.barrier("retrieve-merged")
                elif self.cfg.worker_id == 0:
                    # independent workers: no barrier exists; worker 0
                    # merges whatever partials are present (the launcher
                    # sequences the workers)
                    multihost.merge_worker_retrieval_results(
                        self.retrieval_dir)
            self._stage_done("retrieve")
            return out

    def run_generate(self, resume: bool = False,
                     reference_artifacts: bool = False):
        results_file = os.path.join(self.retrieval_dir,
                                    "all_shots_retrieval_results.json")
        retrieval_results = {}
        if os.path.exists(results_file):
            with open(results_file) as f:
                retrieval_results = json.load(f)
        stage = generate_stage.GenerateStage(self.flux_bundle,
                                             self.cfg.generate)
        corpus_paths = [p for paths in self.corpus_sources.values()
                        for p in paths]
        corpus_roots = {
            src: os.path.commonpath(paths) if len(paths) > 1
            else os.path.dirname(paths[0])
            for src, paths in self.corpus_sources.items() if paths}
        # PP (depth-sharded serving) when configured, else DP sample
        # batching over the group's mesh
        pipe_mesh = self._pipe_mesh()
        mesh = None if pipe_mesh is not None else self._data_mesh()
        # several workers or ranks: the timestamped run dir must agree
        run_name = None
        if self._workers() or self._group():
            run_name = generate_stage.results_dir_name(
                self.cfg.generate, multihost.shared_timestamp())
        out = {}
        with self.timer.span("stage/generate"):
            for dataset in self.cfg.datasets:
                for shot in self.cfg.shots:
                    out[f"{dataset}/{shot}"] = generate_stage.process_dataset(
                        stage, dataset, shot, retrieval_results,
                        self.lamainpaint_dir, self.cfg.output_dir,
                        corpus_paths=corpus_paths, resume=resume,
                        run_name=run_name,
                        worker_id=self.cfg.worker_id,
                        num_workers=self.cfg.num_workers,
                        mesh=mesh, pipe_mesh=pipe_mesh,
                        pipe_axis=self.cfg.mesh.pipe_axis,
                        reference_artifacts=reference_artifacts,
                        corpus_roots=corpus_roots, timer=self.timer)
            if self._workers() and multihost.is_distributed():
                multihost.barrier("generate-done")
            if self._workers() and self.cfg.worker_id == 0 \
                    and self._writer():
                for dataset in self.cfg.datasets:
                    for shot in self.cfg.shots:
                        base = os.path.join(
                            self.cfg.output_dir, "result",
                            f"{dataset}_{shot}shot_retrieval", run_name)
                        parts = sorted(glob.glob(os.path.join(
                            base, "manifest.worker*.json")))
                        if parts:
                            multihost.merge_worker_manifests(
                                parts, os.path.join(base, "manifest.json"))
            if self._workers() and multihost.is_distributed():
                multihost.barrier("generate-merged")
            self._stage_done("generate")
        return out

    def run_generate_legacy(self, resume: bool = False,
                            inpainted_dir: str = None,
                            retrieval_results_dir: str = None):
        """Legacy no-retrieval-JSON generation (ref
        batch_generate_flux_kshot.py:526-736): one generated_image.png per
        sample from the per-dataset legacy retrieval file."""
        stage = generate_stage.GenerateStage(self.flux_bundle,
                                             self.cfg.generate)
        out = {}
        with self.timer.span("stage/generate-legacy"):
            if self._writer():      # not sharded: one rank runs and writes
                for dataset in self.cfg.datasets:
                    out[dataset] = generate_stage.process_dataset_legacy(
                        stage, dataset,
                        inpainted_dir or self.lamainpaint_dir,
                        retrieval_results_dir or self.retrieval_dir,
                        os.path.join(self.cfg.output_dir, "result"),
                        resume=resume)
            self._stage_done("generate-legacy")
        return out

    def run_compose(self, resume: bool = False, failed_only: bool = False):
        pipe_mesh = self._pipe_mesh()
        stage = compose_stage.ComposeStage(
            self.fill_bundle, self.cfg.compose,
            process_id=self.cfg.process_id,
            mesh=None if pipe_mesh is not None else self._data_mesh(),
            pipe_mesh=pipe_mesh, pipe_axis=self.cfg.mesh.pipe_axis)
        out = {}
        with self.timer.span("stage/compose"):
            for dataset in self.cfg.datasets:
                for shot in self.cfg.shots:
                    out[f"{dataset}/{shot}"] = compose_stage.process_dataset(
                        stage, dataset, shot, self.cfg.datasets_dir,
                        self.cfg.output_dir, resume=resume,
                        failed_only=failed_only,
                        worker_id=self.cfg.worker_id,
                        num_workers=self.cfg.num_workers, timer=self.timer)
            self._stage_done("compose")
        return out

    def run(self, stages: Sequence[str] = STAGES, resume: bool = False,
            failed_only: bool = False, reference_artifacts: bool = False):
        """Run the DAG (or a contiguous subset — artifacts on disk carry
        state between invocations, exactly like the reference's phases).

        ``failed_only`` forwards to compose's failed-only re-run
        (ref outpainting_updown_sampling_redux.py:2064-2079);
        ``reference_artifacts`` forwards to generate's tolerant reader for
        reference-produced retrieval JSONs (stages/migrate.py)."""
        results = {}
        for stage in stages:
            if stage not in STAGES:
                raise ValueError(f"unknown stage {stage!r}; "
                                 f"choose from {STAGES}")
            logger.info("=== stage: %s ===", stage)
            if stage == "retrieve":
                results[stage] = self.run_retrieve()
            elif stage == "compose":
                results[stage] = self.run_compose(resume=resume,
                                                  failed_only=failed_only)
            elif stage == "generate":
                results[stage] = self.run_generate(
                    resume=resume, reference_artifacts=reference_artifacts)
            else:
                results[stage] = getattr(self, f"run_{stage}")(resume=resume)
        results["timings"] = self.timer.summary()
        return results


def build_tiny_runner(cfg: PipelineConfig,
                      corpus_sources: Optional[Dict[str, List[str]]] = None,
                      seed: int = 0, *, device=None) -> PipelineRunner:
    """Random tiny-model runner on ``device`` (the card unless
    ``device="cpu"``): full pipeline mechanics without real weights
    (tests, smoke runs — SURVEY.md §4.4). The JAX runner's trees:
    ``split(PRNGKey(seed), 4)``, LaMa, the vision tower and the stem on
    keys 0-2 and both bundles on key 3."""
    dev = device_mod.resolve(device)
    ks = prng.split(prng.PRNGKey(seed, device=dev), 4)
    lama_cfg = lama_mod.TINY_LAMA
    clip_cfg = clip_mod.TINY_VISION
    return PipelineRunner(
        cfg=cfg,
        lama_runner=inpaint_stage.LamaRunner(lama_mod.init(ks[0], lama_cfg),
                                             lama_cfg, device=dev),
        clip_encoder=ClipImageEncoder(clip_mod.init_vision(ks[1], clip_cfg),
                                      clip_cfg, batch_size=8, device=dev),
        style_encoder=StyleEncoder(resnet_stem.init(ks[2]), batch_size=8,
                                   resize=64, device=dev),
        flux_bundle=flux_pipeline.tiny_bundle(ks[3], device=dev),
        fill_bundle=flux_pipeline.tiny_bundle(ks[3], device=dev, fill=True),
        corpus_sources=corpus_sources or {},
    )

"""Manifest-driven pipeline orchestrator — replaces ``domainrag.sh`` (port
of ``domainrag_tpu/pipeline/orchestrator.py``).

The reference's end-to-end run is four fire-and-forget shell phases with no
cross-phase scheduler (domainrag.sh:1-31; SURVEY.md §3.5). Here the DAG is
explicit: inpaint -> retrieve -> generate -> compose, each stage consuming
the previous stage's on-disk artifacts (the L4 contract is preserved so
stages stay independently re-runnable) and reporting into per-stage
manifests.

The port serves one card per process: ``_data_mesh`` is None, and a
tensor- or pipeline-parallel degree above 1 raises (ROADMAP A6). Several
cards run as independent workers (``cfg.worker_id`` / ``num_workers``);
worker 0 merges the retrieval partials and generate manifests.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

from ..core import device as device_mod
from ..core.config import PipelineConfig
from ..core.log import StepTimer, get_logger
from ..models import clip as clip_mod
from ..models import lama as lama_mod
from ..models import resnet_stem
from ..models.common import Init
from ..models.flux import pipeline as flux_pipeline
from ..parallel import multihost
from ..stages import compose as compose_stage
from ..stages import generate as generate_stage
from ..stages import inpaint as inpaint_stage
from ..stages import retrieve as retrieve_stage
from ..stages.encoders import ClipImageEncoder, StyleEncoder

logger = get_logger("domainrag_tpu_torch.pipeline")

STAGES = ("inpaint", "retrieve", "generate", "compose")


def _no_parallel(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A6, scale-out); the port "
        f"serves one card per process")


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

    def run_inpaint(self, resume: bool = False):
        with self.timer.span("stage/inpaint"):
            return inpaint_stage.run_inpaint(
                self.cfg.datasets, self.cfg.shots, self.lama_runner,
                self.cfg.datasets_dir, self.cfg.output_dir, resume=resume,
                worker_id=self.cfg.worker_id,
                num_workers=self.cfg.num_workers)

    def _data_mesh(self):
        """None: one card per process (the JAX package's data mesh over
        the visible devices is ROADMAP A6); a tensor-parallel degree above
        1 raises."""
        if self.cfg.mesh.model_parallel_size > 1:
            raise _no_parallel("tensor-parallel serving (model_parallel)")
        return None

    def _pipe_mesh(self):
        """None; a pipeline-parallel degree above 1 raises (ROADMAP A6)."""
        if self.cfg.mesh.pipeline_parallel_size > 1:
            raise _no_parallel("pipeline-parallel serving "
                               "(pipeline_parallel)")
        return None

    def _build_bank(self, mesh=None) -> retrieve_stage.EmbeddingBank:
        feats, paths = {}, {}
        for source, spec in self.pretrained_features.items():
            f, kept = retrieve_stage.load_pretrained_features(*spec)
            feats[source], paths[source] = f, kept
        for source, image_paths in self.corpus_sources.items():
            if source in feats:
                continue
            f, kept = retrieve_stage.load_or_compute_source_features(
                self.retrieval_dir, source, image_paths, self.clip_encoder,
                force_recompute=self.force_recompute)
            feats[source], paths[source] = f, kept
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
            if self.cfg.num_workers > 1 and self.cfg.worker_id == 0:
                # independent workers: no barrier exists; worker 0 merges
                # whatever partials are present (the launcher sequences
                # the workers)
                multihost.merge_worker_retrieval_results(self.retrieval_dir)
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
        pipe_mesh = self._pipe_mesh()
        mesh = self._data_mesh()
        # several workers: the timestamped run dir must agree across them
        run_name = None
        if self.cfg.num_workers > 1:
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
                        corpus_roots=corpus_roots)
            if run_name is not None and self.cfg.worker_id == 0:
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
            for dataset in self.cfg.datasets:
                out[dataset] = generate_stage.process_dataset_legacy(
                    stage, dataset,
                    inpainted_dir or self.lamainpaint_dir,
                    retrieval_results_dir or self.retrieval_dir,
                    os.path.join(self.cfg.output_dir, "result"),
                    resume=resume)
        return out

    def run_compose(self, resume: bool = False, failed_only: bool = False):
        pipe_mesh = self._pipe_mesh()
        stage = compose_stage.ComposeStage(
            self.fill_bundle, self.cfg.compose,
            process_id=self.cfg.process_id, mesh=self._data_mesh(),
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
                        num_workers=self.cfg.num_workers)
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
    (tests, smoke runs — SURVEY.md §4.4)."""
    dev = device_mod.resolve(device)
    ini = Init(device_mod.generator(seed, dev), dev)
    lama_cfg = lama_mod.TINY_LAMA
    clip_cfg = clip_mod.TINY_VISION
    return PipelineRunner(
        cfg=cfg,
        lama_runner=inpaint_stage.LamaRunner(lama_mod.init(ini, lama_cfg),
                                             lama_cfg, device=dev),
        clip_encoder=ClipImageEncoder(clip_mod.init_vision(clip_cfg, ini),
                                      clip_cfg, batch_size=8, device=dev),
        style_encoder=StyleEncoder(resnet_stem.init(ini), batch_size=8,
                                   resize=64, device=dev),
        flux_bundle=flux_pipeline.tiny_bundle(seed, device=dev),
        fill_bundle=flux_pipeline.tiny_bundle(seed, device=dev, fill=True),
        corpus_sources=corpus_sources or {},
    )

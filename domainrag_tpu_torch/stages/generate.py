"""Stage 3 — domain-guided background generation (port of
``domainrag_tpu/stages/generate.py:86-240``).

Per sample: the dual-image Redux prior of each (retrieved ref, target)
pair (scales [0.8, 1.0] / [1.0, 1.0], empty prompt) and FLUX.1-dev
(guidance 2.5, 50 steps, 1024x1024, seed 0), all ranks of a sample
denoised as one batch or in chunks of ``max_rank_batch``. Artifacts per
sample dir: ``generated_image_rank{r}.png``, ``ref_inforank{r}*.txt``,
``ref_inputrank{r}.jpg``, ``target_input.png`` and ``params.txt`` — the
file set the compose stage consumes.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..core import imaging
from ..core.config import GenerateConfig
from ..core.log import StepTimer
from ..models.flux import pipeline as flux_pipeline


@dataclass
class GenerateStage:
    bundle: flux_pipeline.FluxBundle
    cfg: GenerateConfig

    def _priors_for_sample(self, refs: List[dict], target_path: str):
        """All ranks' (ref, target) priors in one batched tower forward:
        the refs and the shared target are preprocessed and encoded once
        each, and pair k is (ref k, target)."""
        size = self.bundle.siglip_cfg.image_size
        unique = np.stack(
            [imaging.siglip_preprocess(imaging.load_rgb(r["image_path"]),
                                       size) for r in refs]
            + [imaging.siglip_preprocess(imaging.load_rgb(target_path),
                                         size)])
        k = len(refs)
        pair_idx = np.stack([np.arange(k), np.full(k, k)], axis=1)
        r = self.cfg.redux
        return flux_pipeline.redux_prior_pairs_indexed(
            self.bundle, unique, pair_idx, r.prompt,
            prompt_embeds_scale=[r.ref_image_scale, r.target_image_scale],
            pooled_prompt_embeds_scale=[r.ref_text_scale,
                                        r.target_text_scale])

    def generate_sample(self, sample_id: str, target_path: str,
                        refs: List[dict], sample_dir: str,
                        timer: Optional[StepTimer] = None) -> List[str]:
        """All ranks of one sample; returns the written image paths."""
        timer = timer or StepTimer()
        s = self.cfg.sampling
        os.makedirs(sample_dir, exist_ok=True)
        with timer.span("prior"):
            embeds, pooleds = self._priors_for_sample(refs, target_path)

        def run(e, p, n):
            out = flux_pipeline.generate(
                self.bundle, e, p, height=s.height, width=s.width,
                num_steps=s.num_steps, guidance=s.guidance_scale,
                seed=[s.seed] * n,
                scheduler_overrides={
                    "use_dynamic_shifting": s.use_dynamic_shifting,
                    "base_shift": s.base_shift, "max_shift": s.max_shift},
                block_cache_interval=s.block_cache_interval,
                velocity_cache_interval=s.velocity_cache_interval,
                timer=timer)
            return out[None] if out.ndim == 3 else out

        mb = self.cfg.max_rank_batch
        with timer.span("denoise"):
            if mb and len(refs) > mb:
                images = np.concatenate([
                    run(embeds[i:i + mb], pooleds[i:i + mb],
                        min(mb, len(refs) - i))
                    for i in range(0, len(refs), mb)])
            else:
                images = run(embeds, pooleds, len(refs))

        with timer.span("save"):
            out_paths = [_write_rank_artifacts(sample_dir, ref, target_path,
                                               img)
                         for ref, img in zip(refs, images)]
            _write_sample_provenance(sample_dir, target_path, self.cfg)
        return out_paths


def _write_rank_artifacts(sample_dir: str, ref: dict, target_path: str,
                          img: np.ndarray) -> str:
    """One rank's image + provenance."""
    from PIL import Image
    os.makedirs(sample_dir, exist_ok=True)
    rank = ref.get("rank", 1)
    out = os.path.join(sample_dir, f"generated_image_rank{rank}.png")
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

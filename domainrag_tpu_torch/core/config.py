"""Pipeline configuration (own copy of ``domainrag_tpu/core/config.py``).

The cache fields reach the port's ``generate`` and ``fill_batch``,
which take every form the JAX package takes (an int, an anchor tuple,
``"auto"``, ``"sched:K"``). :class:`MeshConfig` shapes the orchestrator's
meshes over the processes launched together (``parallel/mesh.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class DatasetParams:
    """Per-dataset knobs for the compose (Flux-Fill outpaint) stage.

    Mirrors the tables at ``outpainting_updown_sampling_redux.py:31-95``.
    """

    strength: float = 0.75          # default_strength (ref :83)
    guidance_scale: float = 30.0    # default_guidance_scale (ref :86)
    image_prompt_scale: float = 1.0
    upscale_dimension: int = 1024   # min target dim for upsampling
    redux_prompt: str = ""


# Reference tables, outpainting_updown_sampling_redux.py:31-81.
DATASET_PARAMS: Dict[str, DatasetParams] = {
    "FISH": DatasetParams(
        strength=0.8, guidance_scale=35.0, image_prompt_scale=1.2,
        upscale_dimension=1024,
        redux_prompt=(
            "wihout fish, A crystal-clear underwater environment, crisp and "
            "in sharp focus, foreground clarity is high; natural lighting "
            "and color continuity."
        ),
    ),
    "DIOR": DatasetParams(strength=0.8, guidance_scale=30.0),
    "ArTaxOr": DatasetParams(strength=0.9, guidance_scale=30.0),
    "UODD": DatasetParams(strength=0.4, guidance_scale=30.0,
                          upscale_dimension=2048),
    "NEU-DET": DatasetParams(strength=0.3, guidance_scale=30.0),
    "clipart1k": DatasetParams(strength=0.9, guidance_scale=40.0),
    "NWPU_VHR-10": DatasetParams(strength=0.8, guidance_scale=30.0),
    "Camouflage": DatasetParams(strength=0.6, guidance_scale=30.0),
    "coco": DatasetParams(strength=0.8, guidance_scale=30.0),
}


# Per-dataset category lists (batch_generate_flux_kshot.py:738-764); the
# legacy stage-3 mode reads them.
DATASET_CATEGORIES: Dict[str, List[str]] = {
    "fish": ["fish"],
    "dior": [
        "Expressway-Service-area", "airplane", "airport", "baseballfield",
        "basketballcourt", "bridge", "chimney", "dam", "golffield",
        "groundtrackfield", "harbor", "overpass", "ship", "stadium",
        "storagetank", "tenniscourt", "trainstation", "vehicle", "windmill",
    ],
    "artaxor": ["Araneae"],
    "uodd": ["seacucumber", "scallop", "seaurchin"],
    "neu-det": ["crazing", "inclusion", "patches", "pitted_surface",
                "rolled-in_scale", "scratches"],
    "clipart1k": ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
                  "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
                  "motorbike", "person", "pottedplant", "sheep", "sofa",
                  "train", "tvmonitor"],
    "nwpu_vhr_10": ["NWPU_VHR_10"],
    "coco": ["coco"],
}


# Shot configurations (retrieval/...py:47, domainrag.sh:4,
# outpainting_updown_sampling_redux.py:1898).
DEFAULT_SHOTS: Tuple[int, ...] = (1, 5, 10)
NWPU_SHOTS: Tuple[int, ...] = (3, 5, 10, 20)
CAMOUFLAGE_SHOTS: Tuple[int, ...] = (1, 2, 3, 5)


def get_shots_for_dataset(dataset: str) -> Tuple[int, ...]:
    """Per-dataset shot sweeps (retrieval/...py:47, domainrag.sh:4,
    outpainting_updown_sampling_redux.py:1898)."""
    d = dataset.lower()
    if "nwpu" in d:
        return NWPU_SHOTS
    if "camouflage" in d:
        return CAMOUFLAGE_SHOTS
    return DEFAULT_SHOTS


def get_dataset_params(dataset: str,
                       custom_upscale: Optional[Dict[str, int]] = None
                       ) -> DatasetParams:
    """Case-insensitive lookup with defaults for unknown datasets.

    ``custom_upscale`` mirrors ``--custom_upscale DATASET:DIM``
    (outpainting_updown_sampling_redux.py:1920-1932).
    """
    params = None
    for key, value in DATASET_PARAMS.items():
        if key.lower() == dataset.lower():
            params = value
            break
    if params is None:
        params = DatasetParams()
    if custom_upscale:
        for key, dim in custom_upscale.items():
            if key.lower() == dataset.lower():
                params = replace(params, upscale_dimension=int(dim))
    return params


@dataclass(frozen=True)
class ResolutionPolicy:
    """Up/down-sampling window for the compose stage.

    Mirrors ``MIN_DIMENSION``/``MAX_DIMENSION``
    (outpainting_updown_sampling_redux.py:89-92).
    """

    min_dimension: int = 1024
    max_dimension: int = 2800


@dataclass(frozen=True)
class RetrievalConfig:
    """Stage-2 retriever configuration (retrieval/clip100_resnet_style_all_shots.py).

    ``bank_shard_axis`` is kept for the JAX signature; the port has no
    sharded bank yet."""

    top_k: int = 100                 # first-stage CLIP top-k (ref :851)
    rerank_top_k: int = 100          # how many candidates get style re-rank
    clip_image_size: int = 224
    clip_embed_dim: int = 512
    style_resize: int = 256          # ResNet style path resizes to 256x256 (ref :189)
    style_dim: int = 128             # 64-ch mean ++ 64-ch std (ref :196-199)
    bank_shard_axis: str = "data"    # mesh axis the embedding bank shards over
    cache_dir: str = "clip_features_cache"
    visualize: bool = True           # per-sample top-10 grids (ref :874)


@dataclass(frozen=True)
class FluxSamplingConfig:
    """One Flux denoise run. Background-gen defaults mirror
    ``batch_generate_flux_kshot.py:467-474``."""

    num_steps: int = 50
    guidance_scale: float = 2.5
    height: int = 1024
    width: int = 1024
    seed: int = 0
    strength: float = 1.0            # 1.0 = full denoise (t2i); <1 = fill
    use_dynamic_shifting: bool = True
    base_shift: float = 0.5
    max_shift: float = 1.15
    # int interval, or "auto" (the largest interval within a divergence
    # budget, calibrated at first use)
    block_cache_interval: object = 1
    # velocity-extrapolation caching: the MMDiT runs every N-th step, the
    # others integrate an extrapolated velocity (outputs change). An int,
    # an anchor tuple, "auto" or "sched:K"; exclusive with the block cache
    velocity_cache_interval: object = 1
    # 1 = linear extrapolation in sigma, 0 = hold the last velocity
    velocity_cache_order: int = 1


@dataclass(frozen=True)
class ReduxConfig:
    """Dual-image Redux conditioning (batch_generate_flux_kshot.py:52-64)."""

    ref_image_scale: float = 0.8
    target_image_scale: float = 1.0
    ref_text_scale: float = 1.0
    target_text_scale: float = 1.0
    prompt: str = ""


@dataclass(frozen=True)
class GenerateConfig:
    """Stage-3 background generation."""

    sampling: FluxSamplingConfig = field(default_factory=FluxSamplingConfig)
    redux: ReduxConfig = field(default_factory=ReduxConfig)
    top_ranks: int = 5
    # denoise the ranks of one sample in chunks of at most this many;
    # None = all ranks in one batch
    max_rank_batch: object = None


@dataclass(frozen=True)
class ComposeConfig:
    """Stage-4 Flux-Fill outpaint/composite."""

    resolution: ResolutionPolicy = field(default_factory=ResolutionPolicy)
    num_steps: int = 50
    # denoise the backgrounds of one sample in chunks of at most this
    # many; None = all backgrounds in one batch
    max_rank_batch: object = None
    dataset_params: Dict[str, DatasetParams] = field(
        default_factory=lambda: dict(DATASET_PARAMS))
    # round fill resolutions up to this multiple (0 = exact sizes): the
    # image is padded with edge pixels, keep-masked, and the output is
    # cropped back
    resolution_bucket: int = 0
    # >= this many pixels: the VAE runs tiled — the reference's 2048 px
    # upscale / 2800 px cap regime
    # (outpainting_updown_sampling_redux.py:72-82,104-108). 0 disables.
    hires_threshold_px: int = 2048 * 2048
    # velocity-extrapolation caching on the fill denoise: an int, an anchor
    # tuple over the strength-trimmed steps, "auto" or "sched:K" (these two
    # calibrate on the fill core per model, resolution, steps, strength and
    # guidance: pipeline.calibrate_fill_vcache)
    velocity_cache_interval: object = 1
    velocity_cache_order: int = 1


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. data = sample-parallel, model = tensor-parallel,
    pipe = depth-sharded pipeline serving; one process per card, so the
    degrees are over the processes launched together."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1     # TP degree for the Flux MMDiT
    pipe_axis: str = "pipe"
    pipeline_parallel_size: int = 1  # PP stages; >1 replaces DP in generate


@dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration (replaces domainrag.sh)."""

    datasets: Tuple[str, ...] = ("NEU-DET",)
    shots: Tuple[int, ...] = DEFAULT_SHOTS
    datasets_dir: str = "./datasets"
    output_dir: str = "./output"
    process_id: str = "0"
    # this worker handles samples with index % num_workers == worker_id
    # (deterministic round-robin over the sorted sample list; one process
    # per card, as the reference's one-shell-job-per-GPU)
    worker_id: int = 0
    num_workers: int = 1
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    generate: GenerateConfig = field(default_factory=GenerateConfig)
    compose: ComposeConfig = field(default_factory=ComposeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


def worker_slice(items, worker_id: int, num_workers: int):
    """Deterministic round-robin shard of a sorted work list."""
    if num_workers <= 1:
        return list(items)
    return [x for i, x in enumerate(items) if i % num_workers == worker_id]


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)

"""Stage-3 configuration (own copy of
``domainrag_tpu/core/config.py:141-201``).

The port's ``generate`` accepts the cache intervals only at their exact
default of 1; the fields stay so that a config asking for a cache raises
instead of being ignored.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FluxSamplingConfig:
    """One Flux denoise run. Background-gen defaults mirror
    ``batch_generate_flux_kshot.py:467-474``."""

    num_steps: int = 50
    guidance_scale: float = 2.5
    height: int = 1024
    width: int = 1024
    seed: int = 0
    use_dynamic_shifting: bool = True
    base_shift: float = 0.5
    max_shift: float = 1.15
    block_cache_interval: object = 1
    velocity_cache_interval: object = 1


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

"""Deployment sharding for full Flux bundles (port of
``domainrag_tpu/parallel/deploy.py``).

Serving shards the 12B MMDiT Megatron-style over the ``model`` axis: each
rank holds its heads and its slice of every MLP
(``parallel.sharding.shard_params``), and the row-sharded layers sum over
the axis. Everything else (the VAE, T5, CLIP, SigLIP and Redux) is small
and stays whole on every rank. The bundle records the mesh and axis, which
``models.flux.pipeline`` enters as ``ops.attention.tp_attention``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..models.flux.pipeline import FluxBundle
from . import sharding as sharding_mod


def shard_bundle(bundle: FluxBundle, mesh,
                 model_axis: str = "model",
                 fsdp_axis: Optional[str] = None) -> FluxBundle:
    """A bundle whose MMDiT params are this rank's tensor-parallel share
    over ``model_axis`` of ``mesh`` and whose other models are the same
    (whole on every rank). ``fsdp_axis`` validates the FSDP layout as
    JAX's does (each FSDP leaf's dim 0 must divide over that axis); the
    JAX serving path all-gathers an FSDP leaf before every use, so the
    port's bundle holds those leaves gathered: JAX's numbers, with TP's
    memory. Training shards them (``train.flow_match``)."""
    specs = sharding_mod.flux_param_specs(bundle.flux_params,
                                          model_axis=model_axis,
                                          fsdp_axis=fsdp_axis)
    sharding_mod.validate_divisibility(bundle.flux_params, specs, mesh)
    flux_params = sharding_mod.shard_params(bundle.flux_params, mesh,
                                            model_axis=model_axis)
    return dataclasses.replace(bundle, tp_mesh=mesh, tp_axis=model_axis,
                               flux_params=flux_params)

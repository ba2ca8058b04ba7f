"""Training loop (port of ``domainrag_tpu/train/loop.py``): domain
fine-tuning of the Flux MMDiT on the pipeline's own outputs (or any latent
dataset).

``fit`` runs the sharded flow-matching step over a mesh with periodic
checkpoints, graceful SIGINT stop and progress/ETA reporting, as the JAX
``fit`` does. Without a mesh it builds ``create_mesh(model_parallel)``
over the processes launched together (``torchrun --nproc_per_node N``,
one per card): one process is the 1 x 1 mesh, whose step is the one-card
step. Rank 0 writes the checkpoints, of the gathered, unsharded tree, so
a checkpoint from a mesh restores like one from one card. Like the JAX
``fit``, it refuses the W8A8 serving mode
(``models.common.set_int8_activations(True)``).
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ..core import prng
from ..core import imaging
from ..core.interrupt import should_stop
from ..core.log import StepTimer, get_logger
from ..core.progress import ProgressReporter
from ..models import common
from ..models.flux import model as flux_mod
from ..parallel import sharding as sharding_mod
from ..parallel.mesh import create_mesh
from . import checkpoint as ckpt_mod
from . import flow_match

logger = get_logger("domainrag_tpu_torch.train")


def latent_batches_from_images(image_dirs, vae_params, vae_cfg, bundle,
                               batch_size: int, key: torch.Tensor,
                               prompt: str = "") -> Iterator[dict]:
    """Stream training batches from directories of images: VAE-encode (the
    posterior's mode, f32) to packed latent tokens, pair with the (shared)
    encoded prompt. Each batch's images are JAX's picks from the PRNG
    ``key``: ``key, sub = split(key)``, then ``choice(sub, n, (batch_size,),
    replace=n < batch_size)``."""
    from ..models.flux import pipeline as fp
    from ..models.flux import vae as vae_mod

    paths = sorted(p for d in image_dirs
                   for p in globlib.glob(os.path.join(d, "*.png"))
                   + globlib.glob(os.path.join(d, "*.jpg")))
    key = prng.check_key(key, "latent_batches_from_images")
    if not paths:
        return
    dev = bundle.device
    with torch.no_grad():
        txt, pooled = fp.encode_prompt(bundle, [prompt])
    lf = bundle.latent_factor
    while True:
        key, sub = prng.split(key)
        picks = prng.choice(sub, len(paths), (batch_size,),
                            replace=len(paths) < batch_size)
        pixels = []
        size = None
        for idx in picks.tolist():
            img = imaging.load_rgb(paths[idx])
            if size is None:
                w = imaging.to_multiple_of(img.width, lf, lf * 2)
                h = imaging.to_multiple_of(img.height, lf, lf * 2)
                size = (w, h)
            pixels.append(np.asarray(img.resize(size)) / 127.5 - 1.0)
        batch_px = torch.as_tensor(np.stack(pixels), dtype=torch.float32,
                                   device=dev)
        with torch.no_grad():
            latents = vae_mod.encode(vae_params, batch_px, vae_cfg)
        x0 = flux_mod.pack_latents(latents)
        yield {
            "x0": x0,
            "txt": txt.expand((batch_size,) + tuple(txt.shape[1:])),
            "pooled": pooled.expand((batch_size,) + tuple(pooled.shape[1:])),
            "img_ids": torch.as_tensor(flux_mod.make_image_ids(
                latents.shape[1] // 2, latents.shape[2] // 2), device=dev),
            "txt_ids": torch.as_tensor(flux_mod.make_text_ids(txt.shape[1]),
                                       device=dev),
        }


def fit(params, flux_cfg: flux_mod.FluxConfig,
        batches: Iterable[dict],
        num_steps: int,
        train_cfg: Optional[flow_match.TrainConfig] = None,
        mesh=None, model_parallel: int = 1, fsdp: bool = True,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 100,
        seed: int = 0,
        log_every: int = 10, *,
        timer: Optional[StepTimer] = None):
    """Run ``num_steps`` sharded flow-matching steps on the device of
    ``params`` (f32 leaves; each rank's share trains in place) over
    ``mesh`` (default ``create_mesh(model_parallel)`` over the group),
    FSDP over its data axis with ``fsdp``. Every rank reads the same
    batches and takes its rows. Each step's t and eps come from JAX's key
    chain on that device: ``key = PRNGKey(seed)``, then ``key, sub =
    split(key)`` per step (the same on every rank). ``timer`` gets a
    ``step`` span per step and a ``save`` span per checkpoint. Returns
    (final_params, losses): the whole, unsharded tree on every rank, and
    the global batch's losses."""
    if common.int8_activations_enabled():
        # W8A8 quantizes activations through round(), whose gradient is
        # zero almost everywhere: training would silently learn nothing
        raise ValueError(
            "training is incompatible with the W8A8 serving mode "
            "(set_int8_activations(True) / --w8a8): activation round() has "
            "zero gradient. Disable it before fit().")
    train_cfg = train_cfg or flow_match.TrainConfig()
    if mesh is None:
        mesh = create_mesh(model_parallel=model_parallel)
    fsdp_axis = "data" if fsdp else None
    whole = sharding_mod._map_with_path(
        lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        params)
    step_fn, params, opt_state, _ = flow_match.make_sharded_train_step(
        mesh, flux_cfg, train_cfg, params, fsdp=fsdp)

    def unsharded():
        return sharding_mod.unshard_params(params, whole, mesh,
                                           fsdp_axis=fsdp_axis)

    def save(n):
        tree = unsharded()          # a collective: every rank gathers
        if mesh.is_writer():
            with timer.span("save"):
                ckpt_mod.save_checkpoint(checkpoint_dir, n, tree)

    dev = flow_match.leaves(params)[0].device
    key = prng.PRNGKey(seed, device=dev)
    timer = timer or StepTimer()
    reporter = ProgressReporter(num_steps, label="train-steps",
                                log_every=log_every)
    losses = []
    it = iter(batches)
    for step in range(num_steps):
        if should_stop():
            logger.warning("graceful stop at step %d", step)
            break
        try:
            batch = next(it)
        except StopIteration:
            logger.warning("data exhausted at step %d", step)
            break
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        key, sub = prng.split(key)
        with timer.span("step"):
            params, opt_state, loss = step_fn(params, opt_state, batch, sub)
            losses.append(float(loss))
        reporter.update(ok=bool(np.isfinite(losses[-1])),
                        detail=f"loss={losses[-1]:.4f}")
        if checkpoint_dir and (step + 1) % checkpoint_every == 0:
            save(step + 1)
    if checkpoint_dir:
        save(num_steps)
    return unsharded(), losses

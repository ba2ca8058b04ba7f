"""Rectified-flow (flow-matching) training for the Flux MMDiT (port of
``domainrag_tpu/train/flow_match.py``).

Objective: x_t = (1 - t) x0 + t eps, target velocity v* = eps - x0,
loss = E ||v_theta(x_t, t) - v*||^2 with logit-normal t sampling (the
SD3/Flux recipe).

The model computes in the batch's dtype (bf16 batches run the fused
attention kernels in the forward, the generic flash kernels in the
backward); params, grads and optimizer moments stay f32. x_t is mixed in
f32 and rounded to the batch's dtype: the JAX code multiplies a bf16
batch by an f32 t and so promotes it, and its bf16 batch would train in
f32; the port keeps bf16, so that bf16 batches reach the fused kernels. The optimizer is optax's ``chain(clip_by_global_norm, adamw)``:
optax's own clip (g * max/||g|| when ||g|| >= max; torch's
``clip_grad_norm_`` adds 1e-6 to the norm), then ``torch.optim.AdamW``,
whose update is optax's (eps outside the sqrt of the bias-corrected
second moment, decoupled decay of every leaf). Params are updated in
place: the tree handed to :func:`make_train_step` is the tree that
trains. Single device: meshes, tensor parallelism and FSDP over more than
one device come with the last slice of the port (ROADMAP A7) and raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from ..models.common import leaves
from ..models.flux import model as flux_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-5
    remat: bool = True              # checkpoint blocks (12B training)
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0
    guidance_value: float = 1.0     # distillation-style fixed guidance
    t_mean: float = 0.0             # logit-normal t distribution
    t_std: float = 1.0


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax ``clip_by_global_norm``, in place: g / ||g|| * max when the
    global norm ||g|| >= max, g unchanged otherwise (both branches without
    a host sync). Returns the norm."""
    norm = torch.stack([torch.linalg.vector_norm(g.float()).square()
                        for g in grads]).sum().sqrt()
    clip = norm >= max_norm
    den = torch.where(clip, norm, torch.ones_like(norm))
    num = torch.where(clip, torch.full_like(norm, max_norm),
                      torch.ones_like(norm))
    for g in grads:
        g.div_(den).mul_(num)
    return norm


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(...)): ``init``
    gives the state (a ``torch.optim.AdamW`` over the tree's leaves),
    ``update`` clips the grads and steps the params in place."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    def init(self, params) -> torch.optim.AdamW:
        cfg = self.cfg
        return torch.optim.AdamW(leaves(params), lr=cfg.learning_rate,
                                 betas=(cfg.b1, cfg.b2), eps=1e-8,
                                 weight_decay=cfg.weight_decay)

    def update(self, grads: List[torch.Tensor], opt_state: torch.optim.AdamW,
               params) -> None:
        clip_by_global_norm_(grads, self.cfg.grad_clip)
        for p, g in zip(leaves(params), grads):
            p.grad = g
        opt_state.step()
        for p in leaves(params):
            p.grad = None


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def sample_timesteps(generator: torch.Generator, batch: int,
                     cfg: TrainConfig) -> torch.Tensor:
    """Logit-normal t in (0, 1), drawn on the generator's device."""
    z = torch.randn((batch,), generator=generator, device=generator.device)
    return torch.sigmoid(z * cfg.t_std + cfg.t_mean)


def flow_match_loss(params, batch, generator: Optional[torch.Generator],
                    flux_cfg: flux_mod.FluxConfig, train_cfg: TrainConfig,
                    t: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """batch: dict with x0 (B, S, C) latent tokens, txt (B, S_t, D_t5),
    pooled (B, P), img_ids (S, 3), txt_ids (S_t, 3). ``t`` (B,) and ``eps``
    (like x0) are drawn from ``generator`` unless given."""
    x0 = batch["x0"]
    b, dev, dtype = x0.shape[0], x0.device, x0.dtype
    if t is None:
        t = sample_timesteps(generator, b, train_cfg)
    if eps is None:
        eps = torch.randn(x0.shape, generator=generator, device=dev)
    t = t.to(device=dev, dtype=torch.float32)
    eps = eps.to(device=dev, dtype=dtype)
    tb = t[:, None, None]
    x_t = ((1.0 - tb) * x0.float() + tb * eps.float()).to(dtype)
    target = eps - x0
    guidance = torch.full((b,), train_cfg.guidance_value, device=dev) \
        if flux_cfg.guidance_embed else None
    v = flux_mod.apply(params, x_t, batch["txt"], batch["pooled"], t,
                       batch["img_ids"], batch["txt_ids"], flux_cfg,
                       guidance=guidance, remat=train_cfg.remat)
    return (v.float() - target.float()).square().mean()


def train_step(params, opt_state, batch, generator,
               flux_cfg: flux_mod.FluxConfig, train_cfg: TrainConfig,
               optimizer: Optimizer, t=None, eps=None
               ) -> Tuple[dict, torch.optim.AdamW, torch.Tensor]:
    loss = flow_match_loss(params, batch, generator, flux_cfg, train_cfg,
                           t=t, eps=eps)
    grads = list(torch.autograd.grad(loss, leaves(params)))
    optimizer.update(grads, opt_state, params)
    return params, opt_state, loss.detach()


def make_train_step(flux_cfg: flux_mod.FluxConfig, train_cfg: TrainConfig,
                    params, mesh=None, model_parallel: int = 1,
                    fsdp: bool = False
                    ) -> Tuple[Callable, dict, torch.optim.AdamW]:
    """The single-device counterpart of the JAX
    ``make_sharded_train_step``: marks every leaf of ``params`` (f32
    master weights, floating point) as trainable and returns
    (step_fn, params, opt_state); ``step_fn(params, opt_state, batch,
    generator, t=None, eps=None) -> (params, opt_state, loss)``."""
    if mesh is not None or model_parallel > 1:
        raise NotImplementedError("training over a mesh (FSDP / TP) comes "
                                  "with the last slice of the port "
                                  "(ROADMAP A7)")
    for p in leaves(params):
        if not p.is_floating_point():
            raise ValueError(f"non-float param leaf {p.dtype}")
        p.requires_grad_(True)
    optimizer = make_optimizer(train_cfg)
    opt_state = optimizer.init(params)

    def step(p, o, batch, generator, t=None, eps=None):
        return train_step(p, o, batch, generator, flux_cfg, train_cfg,
                          optimizer, t=t, eps=eps)

    return step, params, opt_state

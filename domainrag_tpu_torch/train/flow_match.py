"""Rectified-flow (flow-matching) training for the Flux MMDiT (port of
``domainrag_tpu/train/flow_match.py``).

Objective: x_t = (1 - t) x0 + t eps, target velocity v* = eps - x0,
loss = E ||v_theta(x_t, t) - v*||^2 with logit-normal t sampling (the
SD3/Flux recipe).

The dtypes are JAX's, line by line: eps is drawn in (or rounded to) the
batch's dtype, x_t = (1 - t) x0 + t eps takes the promotion of x0 and the
f32 t and is not rounded back, the target eps - x0 stays in the batch's
dtype, and the loss is the f32 mean. So a bf16 batch trains in f32, as in
JAX: ``flux.apply`` takes its dtype from x_t, casts txt and pooled to it
and every weight in ``models.common.linear``, and its attention takes the
unfused composition (the generic flash kernels in f32, forward and
backward). Params, grads and optimizer moments are f32. The optimizer is optax's ``chain(clip_by_global_norm, adamw)``:
optax's own clip (g * max/||g|| when ||g|| >= max; torch's
``clip_grad_norm_`` adds 1e-6 to the norm), then ``torch.optim.AdamW``,
whose update is optax's (eps outside the sqrt of the bias-corrected
second moment, decoupled decay of every leaf). Params are updated in
place: the tree handed to :func:`train_step` (JAX's step on one device)
or :func:`make_train_step` is the tree that trains.

Over a mesh (:func:`make_sharded_train_step`, the JAX entry of the same
name) one step computes JAX's step on the global batch, one process per
card. Each rank takes its rows of x0, txt and pooled over ``data`` and
its share of the params: the blocks' TP layers over ``model``
(``parallel.sharding``, trained through Megatron's conjugate collectives
in ``models.common``), and with FSDP the other 2-d leaves cut along dim 0
over ``data``, all-gathered before use (their gradient arrives
reduce-scattered). t and eps are drawn for the global batch from the
step's key, as JAX draws them (``core.prng``), and each rank takes its
rows, so the step does not depend on the mesh. The loss is the global
mean; gradients are averaged over ``data``; the clip takes the norm of the
logical tree (the squares of sharded leaves summed over their axes,
replicated leaves counted once); AdamW steps each rank's share.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from ..core import prng
from ..models.common import leaves
from ..models.flux import model as flux_mod
from ..ops.attention import tp_attention
from ..parallel import mesh as mesh_mod
from ..parallel import sharding as sharding_mod


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


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sum_squares: Optional[Callable] = None
                         ) -> torch.Tensor:
    """optax ``clip_by_global_norm``, in place: g / ||g|| * max when the
    global norm ||g|| >= max, g unchanged otherwise (both branches without
    a host sync). ``sum_squares`` maps the leaves' squared norms to those
    of the whole leaves they are shares of (over a mesh). Returns the
    norm."""
    squares = [torch.linalg.vector_norm(g.float()).square() for g in grads]
    if sum_squares is not None:
        squares = sum_squares(squares)
    norm = torch.stack(squares).sum().sqrt()
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
               params, sum_squares: Optional[Callable] = None) -> None:
        clip_by_global_norm_(grads, self.cfg.grad_clip, sum_squares)
        for p, g in zip(leaves(params), grads):
            p.grad = g
        opt_state.step()
        for p in leaves(params):
            p.grad = None


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


def sample_timesteps(key: torch.Tensor, batch: int,
                     cfg: TrainConfig) -> torch.Tensor:
    """Logit-normal t in (0, 1), JAX's draw from the PRNG ``key``, on the
    key's device."""
    key = prng.check_key(key, "sample_timesteps")
    z = prng.normal(key, (batch,), torch.float32)
    return torch.sigmoid(z * cfg.t_std + cfg.t_mean)


def _draw_t_eps(key: Optional[torch.Tensor], x0: torch.Tensor,
               train_cfg: TrainConfig, t: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (t, eps) of JAX's ``flow_match_loss`` for the batch ``x0``:
    ``k_t, k_eps = split(key)``, t from :func:`sample_timesteps`, eps
    ``normal(k_eps, x0.shape, x0.dtype)``, drawn on x0's device. A ``t``
    or ``eps`` given is kept (``key`` may be None when both are)."""
    if t is None or eps is None:
        key = prng.check_key(key, "flow_match_loss").to(x0.device)
        k_t, k_eps = prng.split(key)
        if t is None:
            t = sample_timesteps(k_t, x0.shape[0], train_cfg)
        if eps is None:
            eps = prng.normal(k_eps, x0.shape, x0.dtype)
    return t, eps


def flow_match_loss(params, batch, key: Optional[torch.Tensor],
                    flux_cfg: flux_mod.FluxConfig, train_cfg: TrainConfig,
                    *, t: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """batch: dict with x0 (B, S, C) latent tokens, txt (B, S_t, D_t5),
    pooled (B, P), img_ids (S, 3), txt_ids (S_t, 3). ``t`` (B,) and ``eps``
    (like x0) are drawn from the PRNG ``key`` as JAX draws them
    (:func:`_draw_t_eps`) unless given."""
    x0 = batch["x0"]
    b, dev = x0.shape[0], x0.device
    t, eps = _draw_t_eps(key, x0, train_cfg, t, eps)
    t = t.to(device=dev, dtype=torch.float32)
    eps = eps.to(device=dev, dtype=x0.dtype)
    tb = t[:, None, None]
    # f32 t promotes a bf16 batch: x_t, and so the model, is f32
    x_t = (1.0 - tb) * x0 + tb * eps
    target = eps - x0
    guidance = torch.full((b,), train_cfg.guidance_value, device=dev) \
        if flux_cfg.guidance_embed else None
    v = flux_mod.apply(params, x_t, batch["txt"], batch["pooled"], t,
                       batch["img_ids"], batch["txt_ids"], flux_cfg,
                       guidance=guidance, remat=train_cfg.remat)
    return (v.float() - target.float()).square().mean()


def _step(params, opt_state, batch, key, flux_cfg, train_cfg,
          optimizer: Optimizer, t, eps, gather=None, reduce=None,
          sum_squares=None, ctx=None):
    """Loss, gradient and update of one step, the body that
    :func:`train_step` and :func:`make_sharded_train_step`'s step share:
    the loss of ``gather(params)`` (``params`` itself without ``gather``)
    inside ``ctx``, its gradient in ``params``' leaves, ``reduce(grads,
    loss)`` over a mesh, then ``optimizer`` steps ``params`` in place."""
    with ctx if ctx is not None else contextlib.nullcontext():
        loss = flow_match_loss(params if gather is None else gather(params),
                               batch, key, flux_cfg, train_cfg, t=t,
                               eps=eps)
        grads = list(torch.autograd.grad(loss, leaves(params)))
    loss = loss.detach()
    if reduce is not None:
        grads, loss = reduce(grads, loss)
    optimizer.update(grads, opt_state, params, sum_squares)
    return params, opt_state, loss


def train_step(params, opt_state, batch, key: Optional[torch.Tensor],
               flux_cfg: flux_mod.FluxConfig, train_cfg: TrainConfig,
               optimizer: Optimizer, *, t: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None):
    """One step of the JAX ``train_step`` on this device: the loss of
    ``batch``, its gradient and ``optimizer``'s update, which steps
    ``params`` in place (``opt_state`` is ``optimizer.init(params)``).
    The PRNG ``key`` draws ``t`` and ``eps`` as JAX's does unless they
    are given. Returns (params, opt_state, loss)."""
    _trainable(params)
    return _step(params, opt_state, batch, key, flux_cfg, train_cfg,
                 optimizer, t, eps)


def make_train_step(flux_cfg: flux_mod.FluxConfig, train_cfg: TrainConfig,
                    params) -> Tuple[Callable, dict, torch.optim.AdamW]:
    """The one-device step: :func:`make_sharded_train_step` over a mesh of
    this process alone, whose share is the whole tree (the tree handed in
    trains in place). Returns (step_fn, params, opt_state)."""
    mesh = mesh_mod.create_mesh(devices=[mesh_mod._rank()])
    return make_sharded_train_step(mesh, flux_cfg, train_cfg, params)[:3]


def _trainable(params) -> None:
    for p in leaves(params):
        if not p.is_floating_point():
            raise ValueError(f"non-float param leaf {p.dtype}")
        p.requires_grad_(True)


def make_sharded_train_step(mesh, flux_cfg: flux_mod.FluxConfig,
                            train_cfg: TrainConfig, params,
                            data_axis: str = "data",
                            model_axis: str = "model",
                            fsdp: bool = False):
    """The full training step over ``mesh``: params TP-sharded over
    ``model`` (and with ``fsdp`` the other 2-d leaves over ``data``), the
    batch over ``data``, the optimizer state like the params. Returns
    (step_fn, sharded_params, opt_state, batch_shardings), as JAX's.

    ``sharded_params`` is this rank's share of ``params`` (the same
    tensors where a leaf is whole) and trains in place.
    ``step_fn(params, opt_state, batch, key, t=None, eps=None) ->
    (params, opt_state, loss)`` takes the whole batch (every rank the
    same); ``batch_shardings`` says which rows of each key a rank takes
    (``parallel.mesh.local_rows``). t and eps, drawn from the PRNG
    ``key`` for the whole batch as JAX's ``flow_match_loss`` draws them
    unless given, are sliced the same way. A batch
    that does not divide over ``data``, and a TP split that cannot train
    (``parallel.sharding.check_trainable``), raise."""
    fsdp_axis = data_axis if fsdp else None
    specs = sharding_mod.flux_param_specs(params, model_axis=model_axis,
                                          fsdp_axis=fsdp_axis)
    sharding_mod.validate_divisibility(params, specs, mesh)
    sharding_mod.check_trainable(params, mesh, model_axis)
    n_data = mesh.shape.get(data_axis, 1)
    n_model = mesh.shape.get(model_axis, 1)
    local = sharding_mod.shard_params(params, mesh, specs,
                                      model_axis=model_axis,
                                      fsdp_axis=fsdp_axis)
    _trainable(local)
    optimizer = make_optimizer(train_cfg)
    opt_state = optimizer.init(local)
    kinds = leaves(sharding_mod._map_with_path(
        lambda names, _: _kind(sharding_mod._leaf_at(specs, names), n_data,
                               n_model, model_axis, fsdp_axis), local))
    rows = mesh_mod.NamedSharding(mesh, mesh_mod.P(data_axis))
    batch_shardings = {"x0": rows, "txt": rows, "pooled": rows,
                       "img_ids": mesh_mod.replicated(mesh),
                       "txt_ids": mesh_mod.replicated(mesh)}

    def gathered(tree):
        """The tree the model runs on: FSDP leaves gathered over data."""
        if n_data == 1 or fsdp_axis is None:
            return tree
        return sharding_mod._map_with_path(
            lambda names, x: mesh_mod.gather_from(mesh, x, data_axis, 0)
            if sharding_mod.fsdp_leaf(sharding_mod._leaf_at(specs, names),
                                      fsdp_axis) else x, tree)

    def sum_squares(squares):
        """Each leaf's squared norm as the whole leaf's: TP shares summed
        over ``model``, FSDP shares over ``data``."""
        for kind, axis in (("tp", model_axis), ("fsdp", data_axis)):
            at = [i for i, k in enumerate(kinds) if k == kind]
            if at:
                total = mesh.all_reduce(torch.stack([squares[i]
                                                     for i in at]), axis)
                for j, i in enumerate(at):
                    squares[i] = total[j]
        return squares

    def data_mean(grads, loss):
        """The global mean's gradient: FSDP shares arrive summed over the
        data ranks (the gather's reduce-scatter), the rest are summed
        here."""
        grads = [g if k == "fsdp" else mesh.all_reduce(g, data_axis)
                 for g, k in zip(grads, kinds)]
        for g in grads:
            g.div_(n_data)
        return grads, mesh.all_reduce(loss.clone(), data_axis) / n_data

    def step(p, o, batch, key, t=None, eps=None):
        t, eps = _draw_t_eps(key, batch["x0"], train_cfg, t, eps)
        local_batch = {k: mesh_mod.local_rows(v, batch_shardings[k])
                       for k, v in batch.items()}
        t, eps = mesh_mod.local_rows(t, rows), mesh_mod.local_rows(eps, rows)
        return _step(p, o, local_batch, None, flux_cfg, train_cfg, optimizer,
                     t, eps, gather=gathered,
                     reduce=data_mean if n_data > 1 else None,
                     sum_squares=sum_squares if n_data * n_model > 1
                     else None,
                     ctx=tp_attention(mesh, model_axis) if n_model > 1
                     else None)

    return step, local, opt_state, batch_shardings


def _kind(spec, n_data, n_model, model_axis, fsdp_axis) -> str:
    """How a leaf is held: ``"fsdp"`` (cut over data), ``"tp"`` (cut over
    model) or ``"rep"`` (whole on every rank)."""
    if n_data > 1 and sharding_mod.fsdp_leaf(spec, fsdp_axis):
        return "fsdp"
    if n_model > 1 and model_axis in tuple(spec):
        return "tp"
    return "rep"

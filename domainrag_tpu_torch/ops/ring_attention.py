"""Ring (sequence-parallel) attention over a mesh axis (port of
``domainrag_tpu/ops/ring_attention.py``): the sequence-sharded form for
the >= 2048 px fill, where the joint sequence reaches ~31k tokens.

Every rank of the mesh holds q, k and v whole (each runs the same
program). Rank i of ``axis`` takes query block i of S/n rows (and, with
``head_axis``, its share of the heads) and visits the K/V blocks in the
JAX ring's order, i, i + 1, ..., as its ``ppermute`` would bring them:
each step folds one block into a running pair of normalized partial
attention and log-sum-exp (:func:`ring_step`). The JAX ring rotates the
blocks because its ``shard_map`` inputs are sharded; here each rank
already holds every block, so it slices them locally and no K/V crosses
the group (the fold, and so the result, is the same). The output blocks
are all-gathered, so every rank returns the whole (B, H, S, D) attention.

Per step, on the card: B5, ``ops.attention.flash_attention_lse`` with the
block's ``kv_valid`` (the ragged tail of a padded sequence), as the JAX
package runs its flash kernel per block on the TPU; on the CPU (and
inside ``dense_attention``) the dense fold :func:`_dense_block_lse`. A
block with no valid key adds nothing and is skipped.

Differentiable, as the JAX ring is through ``shard_map``: rank i
differentiates its own fold (:func:`fold_backward`): each block through
B6 on the card (``flash_attention_lse``'s backward, the LSE's gradient
in delta and the block's ``kv_valid``), or autograd of the dense fold on
the CPU, and the LSE merge by autograd. Every rank holds q, k and v
whole and sees the whole output's gradient, so dq is all-gathered over
the axis and dk, dv are all-reduced.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from .attention import (entered, flash_attention_lse, forced_dense,
                        saved_contexts)

NEG_INF = -1e30


def _dense_block_lse(q, k, v, scale, kv_valid):
    """Normalized partial attention of one kv block.

    q: (B, H, Sq, D); k/v: (B, H, Skv, D); kv positions >= ``kv_valid``
    are masked. Returns (out f32, lse f32 (B, H, Sq, 1))."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = torch.arange(k.shape[2], device=q.device) < kv_valid
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = out / l.clamp_min(1e-30)
    lse = m + torch.log(l.clamp_min(1e-30))
    return out, lse


def _merge_partials(out_run, lse_run, out_i, lse_i):
    """Combine two normalized softmax partials over disjoint kv sets."""
    lse = torch.logaddexp(lse_run, lse_i)
    return (out_run * torch.exp(lse_run - lse)
            + out_i * torch.exp(lse_i - lse)), lse


def _on_card(x: torch.Tensor) -> bool:
    """True where a block runs the flash kernels (a CUDA tensor outside
    ``dense_attention``); else the dense fold."""
    return x.device.type != "cpu" and not forced_dense()


def ring_step(q_blk, k_blk, v_blk, out, lse, kv_valid: int):
    """Fold one K/V block (its first ``kv_valid`` keys) into the running
    (out f32, lse f32) pair: B5 on a CUDA tensor, the dense fold on the
    CPU or inside ``dense_attention``."""
    if kv_valid <= 0:
        return out, lse
    if _on_card(q_blk):
        o_i, lse_i = flash_attention_lse(q_blk, k_blk, v_blk,
                                         kv_valid=kv_valid)
        o_i = o_i.float()
    else:
        o_i, lse_i = _dense_block_lse(q_blk, k_blk, v_blk,
                                      1.0 / math.sqrt(q_blk.shape[-1]),
                                      kv_valid)
    return _merge_partials(out, lse, o_i, lse_i)


def _heads(x, mesh, head_axis):
    """The head share of ``head_axis`` that this rank computes."""
    if head_axis is None:
        return x
    h, nh = x.shape[1], mesh.shape[head_axis]
    assert h % nh == 0, f"heads {h} not divisible by {head_axis} axis"
    j, hl = mesh.index(head_axis), h // nh
    return x[:, j * hl:(j + 1) * hl]


def fold(q, k, v, i: int, n: int, valid_len: int) -> torch.Tensor:
    """Rank i's fold of n: its query block of q (B, H, S, D) over the n
    K/V blocks in the ring's order, i, i + 1, ... -> (B, H, S/n, D) f32.
    Differentiable (B5 forward and B6 backward on the card)."""
    block = q.shape[2] // n
    q_blk = q[:, :, i * block:(i + 1) * block].contiguous()
    out = torch.zeros(q_blk.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q_blk.shape[:-1] + (1,), NEG_INF, dtype=torch.float32,
                     device=q.device)
    for step in range(n):
        owner = (i + step) % n          # whose block this rank holds now
        kv_valid = min(max(valid_len - owner * block, 0), block)
        cols = slice(owner * block, (owner + 1) * block)
        out, lse = ring_step(q_blk, k[:, :, cols].contiguous(),
                             v[:, :, cols].contiguous(), out, lse, kv_valid)
    return out


def fold_backward(q, k, v, dout_blk, i: int, n: int, valid_len: int):
    """The gradient of rank i's fold: (dq of its query block, dk, dv of
    the whole sequence from its block alone), given ``dout_blk``, the
    output's gradient on its block. The ring's backward sums the ranks'
    dk and dv and gathers their dq."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        out = fold(q, k, v, i, n, valid_len).to(q.dtype)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout_blk)
    block = q.shape[2] // n
    return dq[:, :, i * block:(i + 1) * block], dk, dv


def _forward(q, k, v, mesh, axis, valid_len, head_axis):
    q, k, v = (_heads(x, mesh, head_axis) for x in (q, k, v))
    out = fold(q, k, v, mesh.index(axis), mesh.shape[axis], valid_len)
    out = mesh.all_gather(out.to(q.dtype), axis, dim=2)
    if head_axis is not None:
        out = mesh.all_gather(out, head_axis, dim=1)
    return out


class _Ring(torch.autograd.Function):
    """The ring as one differentiable op. Every rank holds q, k, v and
    the output's gradient whole: rank i differentiates its own fold
    (:func:`fold_backward`) on its head share, then dq is gathered over
    the axis and dk, dv summed; with ``head_axis`` all three are then
    gathered over the head shares."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, valid_len, head_axis):
        ctx.save_for_backward(q, k, v)
        ctx.args = (mesh, axis, valid_len, head_axis)
        # the backward may run on autograd's device thread
        ctx.contexts = saved_contexts()
        return _forward(q, k, v, mesh, axis, valid_len, head_axis)

    @staticmethod
    def backward(ctx, dout):
        mesh, axis, valid_len, head_axis = ctx.args
        q, k, v, dout = (_heads(x, mesh, head_axis)
                         for x in ctx.saved_tensors + (dout,))
        n, i = mesh.shape[axis], mesh.index(axis)
        block = q.shape[2] // n
        with entered(ctx.contexts):
            dq, dk, dv = fold_backward(
                q, k, v, dout[:, :, i * block:(i + 1) * block].contiguous(),
                i, n, valid_len)
        grads = (mesh.all_gather(dq, axis, dim=2), mesh.all_reduce(dk, axis),
                 mesh.all_reduce(dv, axis))
        if head_axis is not None:
            grads = tuple(mesh.all_gather(g, head_axis, dim=1)
                          for g in grads)
        return grads + (None,) * 4


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   axis: str = "data", seq_valid: Optional[int] = None,
                   head_axis: Optional[str] = None) -> torch.Tensor:
    """(B, H, S, D) with S divisible by the axis size (pad and pass
    ``seq_valid`` for ragged lengths). Returns (B, H, S, D), the dense
    softmax attention, on every rank; differentiable.

    ``head_axis`` also splits the heads over that mesh axis (SP x TP: heads
    over ``model``, sequence blocks around ``data``)."""
    s = q.shape[2]
    assert s % mesh.shape[axis] == 0, \
        "pad the sequence to a multiple of the axis size"
    valid_len = s if seq_valid is None else int(seq_valid)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _Ring.apply(q, k, v, mesh, axis, valid_len, head_axis)
    return _forward(q, k, v, mesh, axis, valid_len, head_axis)


def ring_attention_padded(q, k, v, mesh, axis: str = "data",
                          head_axis: Optional[str] = None) -> torch.Tensor:
    """:func:`ring_attention` of a ragged sequence: zero-padded to the
    axis multiple, the pad keys masked, the pad rows cut off."""
    s = q.shape[2]
    n = mesh.shape[axis]
    s_pad = -(-s // n) * n
    if s_pad != s:
        q, k, v = (F.pad(x, (0, 0, 0, s_pad - s)) for x in (q, k, v))
    out = ring_attention(q, k, v, mesh, axis=axis, seq_valid=s,
                         head_axis=head_axis)
    return out[:, :, :s]

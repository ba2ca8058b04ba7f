"""Pipeline parallelism for the Flux MMDiT over a ``pipe`` mesh axis (port
of ``domainrag_tpu/parallel/pipeline_parallel.py``).

With S stages each rank holds ceil(19/S) double blocks and ceil(38/S)
single blocks: rank s holds double chunk s and single chunk s, so every
microbatch makes two trips around the ring, the doubles loop and then,
after the crossover at rank 0, the singles loop:

    rank 0 (d0) -> rank 1 (d1) -> ... -> rank S-1 (dS-1)
      -> rank 0 (s0) -> rank 1 (s1) -> ... -> rank S-1 (sS-1) -> rank 0

The schedule is JAX's interleaved two-loop ring of M + 2S steps
(:168-236): at step t rank s runs its double chunk on microbatch t - s
and its single chunk on microbatch t - S - s, and skips a slot whose
microbatch lies outside [0, M) (JAX's warm-up and drain ghosts). So
while rank s works on microbatch m, rank s + 1 works on m - 1: the stages
overlap. After each step the activations move one rank on, all of a
step's transfers posted together (``Mesh.exchange``: JAX's ``ppermute``,
but only the live slots travel). Rank 0 collects the finished
microbatches and broadcasts them over the axis. Each microbatch's path
through the blocks is the serial one's, so the output is bit for bit
the same.

Depth padding: chunks are equalised with ALL-ZERO blocks. Under the
gated-residual block structure a zero block is an exact identity (its
modulation gives gates of 0.0, and ``x + 0.0 * f(x) == x``), so the
pipelined forward equals the unsharded one. The embedders and the final
modulation and projection run outside the pipeline, on every rank.
Inference only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..models.flux import model as flux


def _zero_block_like(block):
    if isinstance(block, dict):
        return {k: _zero_block_like(v) for k, v in block.items()}
    return torch.zeros_like(block)


@dataclasses.dataclass(frozen=True)
class PipelineStages:
    """Depth-padded block params: with a mesh, this rank's chunks (``d``
    doubles and ``g`` singles); without one, all ``S*d`` and ``S*g``."""
    doubles: List[dict]
    singles: List[dict]
    per_stage_double: int  # d
    per_stage_single: int  # g
    n_stages: int


def prepare_stages(params, n_stages: int, mesh=None,
                   axis: str = "pipe") -> PipelineStages:
    """Pad both block lists to a multiple of ``n_stages`` with exact
    identity (all-zero) blocks. With ``mesh``, keep only this rank's
    chunks (its place along ``axis``), so that a rank holds 1/S of the
    blocks plus at most one zero block of each kind."""
    doubles = list(params["double"])
    singles = list(params["single"])
    d = -(-len(doubles) // n_stages)
    g = -(-len(singles) // n_stages)
    if mesh is not None:
        s = mesh.index(axis)
        doubles, singles = (doubles[s * d:(s + 1) * d],
                            singles[s * g:(s + 1) * g])
        n_d, n_s = d, g
    else:
        n_d, n_s = n_stages * d, n_stages * g
    doubles += [_zero_block_like(params["double"][0])] * (n_d - len(doubles))
    singles += [_zero_block_like(params["single"][0])] * (n_s - len(singles))
    return PipelineStages(doubles=doubles, singles=singles,
                          per_stage_double=d, per_stage_single=g,
                          n_stages=n_stages)


def run_doubles(chunk, x, vec, cos, sin, t_len: int, cfg):
    """A chunk of double blocks on the joint [txt; img] activation."""
    img, txt = x[:, t_len:], x[:, :t_len]
    for block in chunk:
        img, txt = flux._double_block(block, img, txt, vec, cos, sin, cfg)
    return torch.cat([txt, img], dim=1)


def run_singles(chunk, x, vec, cos, sin, cfg):
    """A chunk of single blocks on the joint activation."""
    for block in chunk:
        x = flux._single_block(block, x, vec, cos, sin, cfg)
    return x


def pipelined_apply(params, stages: PipelineStages,
                    img_tokens: torch.Tensor, txt_tokens: torch.Tensor,
                    pooled: torch.Tensor, timestep: torch.Tensor,
                    img_ids: torch.Tensor, txt_ids: torch.Tensor,
                    cfg: flux.FluxConfig, mesh, axis: str = "pipe",
                    guidance: Optional[torch.Tensor] = None,
                    microbatches: Optional[int] = None, *,
                    schedule: Optional[list] = None) -> torch.Tensor:
    """:func:`models.flux.model.apply` with the blocks pipelined over
    ``mesh``'s ``axis``: ``params`` supplies the embedder and final-layer
    weights, ``stages`` (:func:`prepare_stages` with the mesh) this rank's
    blocks. The batch is split into ``microbatches`` (default: one per
    row). Every rank returns the whole (B, S_img, out_channels). A
    ``schedule`` list gets this rank's steps, (t, "double" or "single",
    microbatch), in order."""
    n = mesh.shape[axis]
    if stages.n_stages != n:
        raise ValueError(f"stages for {stages.n_stages} ranks on a "
                         f"{axis} axis of {n}")
    b = img_tokens.shape[0]
    m_count = microbatches or b
    if b % m_count:
        raise ValueError(f"batch {b} not divisible into {m_count} "
                         "microbatches")
    mb = b // m_count
    t_len = txt_tokens.shape[1]
    img, txt, vec, cos, sin = flux._embed(params, img_tokens, txt_tokens,
                                          pooled, timestep, img_ids, txt_ids,
                                          cfg, guidance)
    x = torch.cat([txt, img], dim=1)
    s = mesh.index(axis)
    rows = [slice(m * mb, (m + 1) * mb) for m in range(m_count)]
    if schedule is None:
        schedule = []
    if n == 1:
        outs = []
        for m, r in enumerate(rows):
            a = run_doubles(stages.doubles, x[r], vec[r], cos, sin, t_len,
                            cfg)
            outs.append(run_singles(stages.singles, a, vec[r], cos, sin,
                                    cfg))
            schedule += [(m, "double", m), (m, "single", m)]
        return flux._final(params, torch.cat(outs, dim=0)[:, t_len:], vec)

    def live(m):
        return 0 <= m < m_count

    like = x[rows[0]]
    mesh.all_reduce(torch.zeros(1, device=x.device), axis)  # group warm-up
    a_d = a_s = None                # this step's inputs, once received
    outs = [None] * m_count
    for t in range(m_count + 2 * n):
        m_d, m_s = t - s, t - n - s
        if s == 0 and live(m_d):
            a_d = x[rows[m_d]]
        if live(m_d):
            a_d = run_doubles(stages.doubles, a_d, vec[rows[m_d]], cos, sin,
                              t_len, cfg)
            schedule.append((t, "double", m_d))
        if live(m_s):
            a_s = run_singles(stages.singles, a_s, vec[rows[m_s]], cos, sin,
                              cfg)
            schedule.append((t, "single", m_s))
        # on around the ring: each output to the next rank; rank S-1's
        # doubles cross over to rank 0's singles, its singles are done
        sends = [(a, (s + 1) % n) for a, m in ((a_d, m_d), (a_s, m_s))
                 if live(m)]
        nxt_d, nxt_s = m_d + 1, m_s + 1
        recvs = []
        if s > 0 and live(nxt_d):
            recvs.append((like, s - 1))           # doubles input
        if live(nxt_s):
            recvs.append((like, (s - 1) % n))     # singles input
        if s == 0 and live(t + 1 - 2 * n):
            recvs.append((like, n - 1))           # a finished microbatch
        got = mesh.exchange(axis, sends, recvs)
        if s > 0 and live(nxt_d):
            a_d = got.pop(0)
        if live(nxt_s):
            a_s = got.pop(0)
        if s == 0 and live(t + 1 - 2 * n):
            outs[t + 1 - 2 * n] = got.pop(0)
    done = torch.cat(outs, dim=0) if s == 0 else torch.empty_like(x)
    x = mesh.broadcast(done, axis, 0)
    return flux._final(params, x[:, t_len:], vec)


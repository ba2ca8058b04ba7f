"""Flux MMDiT — the rectified-flow transformer of FLUX.1-dev (port of
``domainrag_tpu/models/flux/model.py:39-448``).

Hidden 3072 = 24 heads x 128, 19 double-stream + 38 single-stream
blocks, 3-axis RoPE with axes_dim (16, 56, 56), AdaLN modulation from a
timestep + guidance + pooled-text vector. Runs in the caller's dtype
(bf16 at full width) with f32 LayerNorm statistics. Each block's
attention goes through ``ops.mmdit_attention`` and each LayerNorm +
modulation through ``ops.adaln``: the Hopper kernels on the card, the
plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...core import prng
from ...ops import adaln
# the plain LayerNorm + modulation, under the JAX package's names
from ...ops.adaln import ln_no_affine as _ln_no_affine
from ...ops.adaln import modulate as _modulate
from ...ops.attention import entered, saved_contexts, tp_context
from ...ops.mmdit_attention import (mmdit_double_attention,
                                    mmdit_single_attention)
# the JAX name of the interleaved-pair rotation (f32, cast back)
from ...ops.mmdit_attention import rope_interleaved as apply_rope  # noqa
from ..common import (Params, gelu_tanh, int8_activations_enabled,
                      linear, linear_col_sharded, linear_init,
                      linear_row_sharded, linear_widths, rmsnorm_init)


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    out_channels: int = 64
    hidden: int = 3072
    heads: int = 24
    head_dim: int = 128
    depth_double: int = 19
    depth_single: int = 38
    mlp_ratio: int = 4
    text_dim: int = 4096             # T5-XXL
    pooled_dim: int = 768            # CLIP-L pooled
    time_embed_dim: int = 256
    axes_dim: Tuple[int, int, int] = (16, 56, 56)
    theta: int = 10000
    guidance_embed: bool = True      # flux-dev (distilled guidance input)

    @property
    def mlp_hidden(self) -> int:
        return self.hidden * self.mlp_ratio


TINY_FLUX = FluxConfig(in_channels=16, out_channels=16, hidden=64, heads=4,
                       head_dim=16, depth_double=2, depth_single=2,
                       text_dim=32, pooled_dim=24, time_embed_dim=32,
                       axes_dim=(4, 6, 6))

FLUX_DEV = FluxConfig()
# FLUX.1-Fill-dev: latents + masked-image latents + 256 mask channels
FLUX_FILL_DEV = FluxConfig(in_channels=384)


# ---------------------------------------------------------------------------
# embeddings and RoPE
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding of sigma in [0,1] (BFL convention: t*1000)."""
    t = t.float() * time_factor
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _mlp_embedder_init(key, d_in: int, hidden: int, dtype: torch.dtype
                       ) -> Params:
    k1, k2 = prng.split(key)
    return {"in": linear_init(k1, d_in, hidden, dtype=dtype),
            "out": linear_init(k2, hidden, hidden, dtype=dtype)}


def _vec_linear(p: Params, vec: torch.Tensor) -> torch.Tensor:
    """``linear`` on the per-sample conditioning vectors (B, D), one
    sample at a time: BLAS takes another kernel for one row than for
    several, so, computed together, a sample's embeddings and modulation
    would depend on the batch it came in (a data-parallel rank's rows
    would not be the whole batch's, bit for bit). W8A8 keeps its one
    kernel launch per layer."""
    if vec.shape[0] == 1 or ("w_q" in p and int8_activations_enabled()):
        return linear(p, vec)
    return torch.cat([linear(p, v) for v in vec.split(1)])


def _mlp_embedder(p: Params, x: torch.Tensor) -> torch.Tensor:
    return _vec_linear(p["out"], F.silu(_vec_linear(p["in"], x)))


def rope_cos_sin(ids: torch.Tensor, axes_dim: Tuple[int, ...], theta: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids (S, n_axes) int positions -> cos/sin (S, head_dim/2) f32, the
    per-axis frequency tables concatenated."""
    cos_parts, sin_parts = [], []
    for axis, dim in enumerate(axes_dim):
        pos = ids[..., axis].float()
        scale = torch.arange(0, dim, 2, dtype=torch.float32,
                             device=ids.device) / dim
        omega = 1.0 / (theta ** scale)
        angles = pos[..., None] * omega
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def make_image_ids(grid_h: int, grid_w: int) -> np.ndarray:
    """(grid_h*grid_w, 3): axis0 = 0, axis1 = row, axis2 = col."""
    ids = np.zeros((grid_h, grid_w, 3), np.int32)
    ids[..., 1] = np.arange(grid_h)[:, None]
    ids[..., 2] = np.arange(grid_w)[None, :]
    return ids.reshape(-1, 3)


def make_text_ids(seq_len: int) -> np.ndarray:
    return np.zeros((seq_len, 3), np.int32)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _qknorm_init(head_dim: int, device) -> Params:
    return {"q": rmsnorm_init(head_dim, device=device),
            "k": rmsnorm_init(head_dim, device=device)}


def _double_block_init(key, cfg: FluxConfig,
                       dtype: torch.dtype = torch.float32) -> Params:
    ks = prng.split(key, 10)
    h, mh = cfg.hidden, cfg.mlp_hidden

    def lin(i, d_in, d_out):
        return linear_init(ks[i], d_in, d_out, dtype=dtype)
    return {
        "img_mod": lin(0, h, 6 * h),
        "txt_mod": lin(1, h, 6 * h),
        "img_qkv": lin(2, h, 3 * h),
        "txt_qkv": lin(3, h, 3 * h),
        "img_qknorm": _qknorm_init(cfg.head_dim, key.device),
        "txt_qknorm": _qknorm_init(cfg.head_dim, key.device),
        "img_proj": lin(4, h, h),
        "txt_proj": lin(5, h, h),
        "img_mlp1": lin(6, h, mh),
        "img_mlp2": lin(7, mh, h),
        "txt_mlp1": lin(8, h, mh),
        "txt_mlp2": lin(9, mh, h),
    }


def _single_block_init(key, cfg: FluxConfig,
                       dtype: torch.dtype = torch.float32) -> Params:
    ks = prng.split(key, 3)
    h, mh = cfg.hidden, cfg.mlp_hidden
    return {
        "mod": linear_init(ks[0], h, 3 * h, dtype=dtype),
        "linear1": linear_init(ks[1], h, 3 * h + mh, dtype=dtype),
        "linear2": linear_init(ks[2], h + mh, h, dtype=dtype),
        "qknorm": _qknorm_init(cfg.head_dim, key.device),
    }


def _ln_modulate(x, shift, scale):
    """``_modulate(_ln_no_affine(x), shift, scale)``: one kernel launch
    (``ops.adaln``) where x is on the card in a form the kernel takes and
    no autograd graph is recorded, else the two functions (the CPU, f32
    runs and training keep them bit for bit)."""
    if adaln.takes(x, shift, scale):
        return adaln.ln_modulate(x, shift, scale)
    return _modulate(_ln_no_affine(x), shift, scale)


def _tp() -> tuple:
    ctx = tp_context()
    if ctx is None:
        raise ValueError("tensor-parallel block weights "
                         "(parallel.sharding.shard_params) run inside "
                         "ops.attention.tp_attention of their mesh")
    return ctx


def _row_linear(p: Params, x, sharded: bool):
    """A row-sharded layer (attention output, MLP down): the sum of the
    ranks' partial products under tensor parallelism."""
    if not sharded:
        return linear(p, x)
    return linear_row_sharded(p, x, *_tp())


def _col_linear(p: Params, x, sharded: bool):
    """A column-sharded layer (qkv, MLP up) on the replicated ``x``:
    this rank's output columns, the input's gradient summed over the
    ranks under tensor parallelism."""
    if not sharded:
        return linear(p, x)
    return linear_col_sharded(p, x, *_tp())


def _qknorm(p: Params, sharded: bool) -> Params:
    """The qk-RMSNorm weights, which every rank applies to its own heads:
    under tensor parallelism their gradient is summed over the ranks."""
    if not sharded:
        return p
    from ...parallel.mesh import copy_to
    mesh, axis = _tp()
    return {k: {"scale": copy_to(mesh, v["scale"], axis)}
            for k, v in p.items()}


def _double_block(p: Params, img, txt, vec, cos, sin, cfg: FluxConfig):
    # a tensor-parallel rank's weights hold its heads and its slice of the
    # MLP hidden (parallel.sharding): the local widths come from them
    heads = linear_widths(p["img_qkv"])[1] // (3 * cfg.head_dim)
    sharded = linear_widths(p["img_mlp1"])[1] != cfg.mlp_hidden
    vec_act = F.silu(vec)
    (i_shift1, i_scale1, i_gate1, i_shift2, i_scale2,
     i_gate2) = _vec_linear(p["img_mod"], vec_act).chunk(6, dim=-1)
    (t_shift1, t_scale1, t_gate1, t_shift2, t_scale2,
     t_gate2) = _vec_linear(p["txt_mod"], vec_act).chunk(6, dim=-1)

    img_in = _ln_modulate(img, i_shift1, i_scale1)
    txt_in = _ln_modulate(txt, t_shift1, t_scale1)
    # joint [txt; img] attention (BFL order) over the raw fused qkv GEMM
    # outputs: head split, qk-RMSNorm, RoPE and softmax in one op
    txt_attn, img_attn = mmdit_double_attention(
        _col_linear(p["txt_qkv"], txt_in, sharded),
        _col_linear(p["img_qkv"], img_in, sharded),
        _qknorm(p["txt_qknorm"], sharded), _qknorm(p["img_qknorm"], sharded),
        cos, sin, heads, cfg.head_dim)

    img = img + i_gate1[:, None, :] * _row_linear(p["img_proj"], img_attn,
                                                   sharded)
    txt = txt + t_gate1[:, None, :] * _row_linear(p["txt_proj"], txt_attn,
                                                   sharded)

    img_h = _ln_modulate(img, i_shift2, i_scale2)
    img = img + i_gate2[:, None, :] * _row_linear(
        p["img_mlp2"], gelu_tanh(_col_linear(p["img_mlp1"], img_h,
                                             sharded)), sharded)
    txt_h = _ln_modulate(txt, t_shift2, t_scale2)
    txt = txt + t_gate2[:, None, :] * _row_linear(
        p["txt_mlp2"], gelu_tanh(_col_linear(p["txt_mlp1"], txt_h,
                                             sharded)), sharded)
    return img, txt


def _single_block(p: Params, x, vec, cos, sin, cfg: FluxConfig):
    # linear1 is [q k v | mlp] and linear2's input [attn | mlp], so their
    # widths give this rank's attention width (parallel.sharding)
    w1, w2 = linear_widths(p["linear1"])[1], linear_widths(p["linear2"])[0]
    h_local = (w1 - w2) // 2
    sharded = w2 != cfg.hidden + cfg.mlp_hidden
    shift, scale, gate = _vec_linear(p["mod"], F.silu(vec)).chunk(3,
                                                                  dim=-1)
    x_in = _ln_modulate(x, shift, scale)
    proj = _col_linear(p["linear1"], x_in, sharded)
    # the attention reads q/k/v in place from proj's first 3h lanes
    out = mmdit_single_attention(proj, _qknorm(p["qknorm"], sharded),
                                 cos, sin,
                                 h_local // cfg.head_dim, cfg.head_dim)
    combined = torch.cat([out, gelu_tanh(proj[..., 3 * h_local:])], dim=-1)
    return x + gate[:, None, :] * _row_linear(p["linear2"], combined,
                                              sharded)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def init(key, cfg: FluxConfig, *, dtype: torch.dtype = torch.float32
         ) -> Params:
    """JAX's tree from the same key: ``split(key, 8 + depth_double +
    depth_single)``, the embedders and final layers on keys 0-5 (guidance
    on 6), key 7 unused, the blocks from key 8. Weights and biases are
    stored in ``dtype`` (JAX's f32 leaves rounded), the qk norms in f32."""
    ks = prng.split(prng.check_key(key, "init"),
                    8 + cfg.depth_double + cfg.depth_single)
    h = cfg.hidden
    params: Params = {
        "img_in": linear_init(ks[0], cfg.in_channels, h, dtype=dtype),
        "txt_in": linear_init(ks[1], cfg.text_dim, h, dtype=dtype),
        "time_in": _mlp_embedder_init(ks[2], cfg.time_embed_dim, h, dtype),
        "vector_in": _mlp_embedder_init(ks[3], cfg.pooled_dim, h, dtype),
        "final_mod": linear_init(ks[4], h, 2 * h, dtype=dtype),
        "final_proj": linear_init(ks[5], h, cfg.out_channels, dtype=dtype),
        "double": [_double_block_init(ks[8 + i], cfg, dtype)
                   for i in range(cfg.depth_double)],
        "single": [_single_block_init(ks[8 + cfg.depth_double + i], cfg,
                                      dtype)
                   for i in range(cfg.depth_single)],
    }
    if cfg.guidance_embed:
        params["guidance_in"] = _mlp_embedder_init(
            ks[6], cfg.time_embed_dim, h, dtype)
    return params


def _embed(params: Params, img_tokens, txt_tokens, pooled, timestep,
           img_ids, txt_ids, cfg: FluxConfig, guidance):
    """The input projections, the conditioning vector and the RoPE tables
    -> (img, txt, vec, cos, sin), in img_tokens' dtype."""
    dtype = img_tokens.dtype
    img = linear(params["img_in"], img_tokens)
    txt = linear(params["txt_in"], txt_tokens.to(dtype))
    vec = _mlp_embedder(params["time_in"],
                        timestep_embedding(timestep, cfg.time_embed_dim)
                        .to(dtype))
    if cfg.guidance_embed:
        if guidance is None:
            raise ValueError("flux-dev requires a guidance value")
        vec = vec + _mlp_embedder(
            params["guidance_in"],
            timestep_embedding(guidance, cfg.time_embed_dim).to(dtype))
    vec = vec + _mlp_embedder(params["vector_in"], pooled.to(dtype))

    ids = torch.cat([txt_ids, img_ids], dim=0)
    cos, sin = rope_cos_sin(ids, cfg.axes_dim, cfg.theta)
    return img, txt, vec, cos, sin


def _final(params: Params, img, vec):
    shift, scale = _vec_linear(params["final_mod"], F.silu(vec)).chunk(
        2, dim=-1)
    img = _ln_modulate(img, shift, scale)
    return linear(params["final_proj"], img)


def apply(params: Params, img_tokens: torch.Tensor,
          txt_tokens: torch.Tensor, pooled: torch.Tensor,
          timestep: torch.Tensor, img_ids: torch.Tensor,
          txt_ids: torch.Tensor, cfg: FluxConfig,
          guidance: Optional[torch.Tensor] = None,
          remat: bool = False) -> torch.Tensor:
    """One velocity prediction.

    img_tokens (B, S_img, in_channels) packed latents; txt_tokens
    (B, S_txt, text_dim); pooled (B, pooled_dim); timestep (B,) sigma in
    [0,1]; guidance (B,); img_ids/txt_ids (S, 3) RoPE position ids.
    ``remat=True`` checkpoints every block (its activations are recomputed
    in the backward pass), as training the 12B model needs.
    Returns (B, S_img, out_channels) in img_tokens' dtype."""
    img, txt, vec, cos, sin = _embed(params, img_tokens, txt_tokens, pooled,
                                     timestep, img_ids, txt_ids, cfg,
                                     guidance)

    def run(block_fn, *args):
        if remat:
            # the recompute re-enters this thread's attention contexts:
            # on the card it runs on autograd's device thread
            contexts = saved_contexts()

            def block(*a):
                with entered(contexts):
                    return block_fn(*a)

            return checkpoint(block, *args, cfg, use_reentrant=False)
        return block_fn(*args, cfg)

    for block in params["double"]:
        img, txt = run(_double_block, block, img, txt, vec, cos, sin)
    x = torch.cat([txt, img], dim=1)
    for block in params["single"]:
        x = run(_single_block, block, x, vec, cos, sin)
    return _final(params, x[:, txt.shape[1]:], vec)


# ---------------------------------------------------------------------------
# block-residual caching (port of ``model.py:340-425``; "Cache Me if You
# Can", arXiv:2312.03209): a refresh step runs every block and records its
# residual (out - in); a cached step replays the residuals. The embedders
# and the final layer always run (they carry the timestep). Refreshing at
# every step is exactly :func:`apply`.
# ---------------------------------------------------------------------------

def init_block_cache(cfg: FluxConfig, batch: int, s_img: int, s_txt: int,
                     dtype=torch.bfloat16, *, device=None) -> dict:
    """Zeroed residual cache: per double block an (img, txt) pair, per
    single block the joint stream's residual, in ``dtype`` on ``device``
    (the CPU when None)."""
    def z(s):
        return torch.zeros((batch, s, cfg.hidden), dtype=dtype,
                           device=device)
    return {"double": [(z(s_img), z(s_txt))
                       for _ in range(cfg.depth_double)],
            "single": [z(s_txt + s_img) for _ in range(cfg.depth_single)]}


def apply_with_cache(params: Params, img_tokens: torch.Tensor,
                     txt_tokens: torch.Tensor, pooled: torch.Tensor,
                     timestep: torch.Tensor, img_ids: torch.Tensor,
                     txt_ids: torch.Tensor, cfg: FluxConfig, cache: dict,
                     refresh: bool,
                     guidance: Optional[torch.Tensor] = None):
    """:func:`apply` with block-residual caching -> (velocity, new_cache).

    ``refresh=True`` runs every block and records each residual, cast to
    the cache's dtype; ``refresh=False`` replays ``cache`` (``x + c``, the
    residual cast to the stream's dtype) and launches no block."""
    img, txt, vec, cos, sin = _embed(params, img_tokens, txt_tokens, pooled,
                                     timestep, img_ids, txt_ids, cfg,
                                     guidance)
    new_cache = {"double": [], "single": []}
    for block, (c_img, c_txt) in zip(params["double"], cache["double"]):
        if refresh:
            i2, t2 = _double_block(block, img, txt, vec, cos, sin, cfg)
            c_img, c_txt = (i2 - img).to(c_img.dtype), (t2 - txt).to(
                c_txt.dtype)
            img, txt = i2, t2
        else:
            img, txt = img + c_img.to(img.dtype), txt + c_txt.to(txt.dtype)
        new_cache["double"].append((c_img, c_txt))

    x = torch.cat([txt, img], dim=1)
    for block, c_x in zip(params["single"], cache["single"]):
        if refresh:
            x2 = _single_block(block, x, vec, cos, sin, cfg)
            c_x = (x2 - x).to(c_x.dtype)
            x = x2
        else:
            x = x + c_x.to(x.dtype)
        new_cache["single"].append(c_x)
    return _final(params, x[:, txt.shape[1]:], vec), new_cache


# ---------------------------------------------------------------------------
# latent packing (diffusers _pack_latents layout: channel-major, then 2x2)
# ---------------------------------------------------------------------------

def pack_latents(latents: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) NHWC latents -> (B, H/2*W/2, C*4) tokens; feature
    index = c*4 + dy*2 + dx."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)            # B, h2, w2, C, dy, dx
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, grid_h: int, grid_w: int
                   ) -> torch.Tensor:
    """Inverse of :func:`pack_latents` -> (B, 2*grid_h, 2*grid_w, C)."""
    b, s, d = tokens.shape
    c = d // 4
    x = tokens.reshape(b, grid_h, grid_w, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)            # B, h2, dy, w2, dx, C
    return x.reshape(b, grid_h * 2, grid_w * 2, c)

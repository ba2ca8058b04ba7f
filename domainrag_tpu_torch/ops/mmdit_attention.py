"""Fused MMDiT attention (port of ``domainrag_tpu/ops/mmdit_attention.py``).

Two entry points replace the whole per-block attention chain of the Flux
MMDiT — head split, qk-RMSNorm, interleaved RoPE, softmax and the output
merge — reading q/k/v straight from the fused qkv GEMM output in its
(B, S, W) lane layout and writing (B, S, H*128):

- :func:`mmdit_double_attention`: joint [txt; img] attention over the two
  streams of a double block;
- :func:`mmdit_single_attention`: one stream whose first 3*H*128 lanes
  are q/k/v (the single block's MLP lanes are never read).

Two regimes, split on the joint length S as in the JAX package:

- one pass, S <= ``_MAX_ONEPASS`` (17408; 1024 px is 5337 tokens): the
  TPU ``_joint_kernel`` (ops/mmdit_attention.py:400) and ``_seq_kernel``
  (:328). The log2(e)/sqrt(128) prescale is folded into q before its
  bf16 round. Plain version :func:`reference_double` /
  :func:`reference_single`, mirroring the JAX ``_reference_double`` /
  ``_reference_single`` (:189-211): dense f32 scores and softmax,
  probabilities rounded to the input dtype.
- multi-pass, ``_MAX_ONEPASS`` < S <= ``_MAX_MULTIPASS`` (49152; the
  2048 px fill is 17625 tokens, the 2800 px cap 31866): the TPU
  ``_flash_mp_kernel`` (:533) behind one ``_prep_norm_rope`` pass (:568).
  q and k are normed and roped and rounded WITHOUT the prescale, which
  multiplies the f32 scores instead. Plain version
  :func:`reference_mp_double` / :func:`reference_mp_single`: exp2
  softmax with the exact row max, P rounded to the input dtype, one
  head and one block of q rows at a time, so that 31866 tokens need
  ~0.5 GB of scores and not 97 GB.

The fused kernels take what the JAX package's ``_fused_ok`` (:1161-1179)
lets through: bf16 streams with head_dim 128 and a joint length up to
``_MAX_MULTIPASS``, outside :func:`ops.attention.dense_attention`. Every
other call (f32, another head width, a longer sequence) runs the unfused
composition :func:`reference_double` / :func:`reference_single`, whose
attention is :func:`ops.attention.attention`: on the card the generic
flash kernels (B5, and B6 in the backward), on the CPU the dense
reference. Under ``dense_attention()`` that composition is the plain
version of the one-pass kernels on every device.

On a CUDA tensor each wrapper launches the hand-written Hopper kernels of
``csrc/mmdit_attention.cu`` (its header states the bound and the design)
for the regime or raises; it never falls back. On a CPU tensor it runs
the regime's plain version. The kernels stream K/V with an online
softmax, so they agree with the plain version to |err| <= 4e-3 +
2e-2*|ref| per element and 1e-2 in relative Frobenius norm in bf16, not
bit for bit.

Both wrappers are differentiable as the JAX ``_make_double`` /
``_make_single`` custom VJPs (:1095-1145): the forward is the fused
kernel, the backward recomputes the unfused composition and returns its
gradients for the qkv streams and the f32 qk-norm scales.

Each wrapper counts its kernel launches: one-pass in
``<wrapper>.launches``, multi-pass in ``<wrapper>.mp_launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from .attention import attention, forced_dense

LOG2_E = 1.4426950408889634
_EPS = 1e-6             # qk-rmsnorm epsilon (models.common.rmsnorm)
HEAD_DIM = 128          # the only head width the kernels take
# joint lengths of the two regimes (the JAX package's gates, :70, :86)
_MAX_ONEPASS = 17408
_MAX_MULTIPASS = 49152
_MP_ROWS = 4096         # q rows per block of the plain multi-pass version


# ---------------------------------------------------------------------------
# plain version (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + _EPS)
    return (y * w.float()).to(x.dtype)


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """x (..., D); cos/sin (..., D/2), broadcasting against x's leading
    dims: (S, D/2) for (B, H, S, D), (S, 1, D/2) for (B, S, H, D). The
    pair (x[2i], x[2i+1]) rotates by angle i — not the half-split
    ``rotate_half`` layout."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c, s = cos.float(), sin.float()
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(shape).to(x.dtype)


def _split_heads(qkv: torch.Tensor, heads: int, head_dim: int):
    b, s, _ = qkv.shape
    qkv = qkv[..., :3 * heads * head_dim].reshape(b, s, 3, heads, head_dim)
    return tuple(qkv[:, :, i].transpose(1, 2) for i in range(3))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def prenormed_double(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                     heads: int, head_dim: int):
    """(q, k, v) in (B, H, S_txt + S_img, D), q/k normed and roped."""
    tq, tk, tv = _split_heads(txt_qkv, heads, head_dim)
    iq, ik, iv = _split_heads(img_qkv, heads, head_dim)
    q = torch.cat([_rms(tq, wq_t), _rms(iq, wq_i)], dim=2)   # text first
    k = torch.cat([_rms(tk, wk_t), _rms(ik, wk_i)], dim=2)
    v = torch.cat([tv, iv], dim=2)
    return rope_interleaved(q, cos, sin), rope_interleaved(k, cos, sin), v


def prenormed_single(proj, wq, wk, cos, sin, heads: int, head_dim: int):
    q, k, v = _split_heads(proj, heads, head_dim)
    return (rope_interleaved(_rms(q, wq), cos, sin),
            rope_interleaved(_rms(k, wk), cos, sin), v)


def reference_double(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                     heads: int, head_dim: int):
    q, k, v = prenormed_double(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i,
                               cos, sin, heads, head_dim)
    out = _merge_heads(attention(q, k, v))
    t_len = txt_qkv.shape[1]
    return out[:, :t_len], out[:, t_len:]


def reference_single(proj, wq, wk, cos, sin, heads: int, head_dim: int):
    q, k, v = prenormed_single(proj, wq, wk, cos, sin, heads, head_dim)
    return _merge_heads(attention(q, k, v))


def prep_norm_rope(x: torch.Tensor, w: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, head_dim: int = HEAD_DIM
                   ) -> torch.Tensor:
    """qk-RMSNorm + interleaved RoPE over a (B, S, H*head_dim) stream,
    with no prescale (the JAX ``_prep_norm_rope``, :568-581): f32
    statistics, rounded to x's dtype after the weight scale, rotated in
    f32 and cast back."""
    b, s, hd = x.shape
    y = _rms(x.reshape(b, s, hd // head_dim, head_dim), w)
    return rope_interleaved(y, cos[:, None], sin[:, None]).reshape(b, s, hd)


def _mp_attention(q, k, v, heads: int, head_dim: int) -> torch.Tensor:
    """Dense multi-pass numerics over (B, S, H*D) prenormed q/k and raw v:
    s = (q k^T in f32) * log2(e)/sqrt(D), p = exp2(s - rowmax), P rounded
    to v's dtype for P.V, o = (P V) / max(sum p, 1e-30). One (batch,
    head, block of q rows) at a time."""
    b, s, _ = q.shape
    scale = LOG2_E / math.sqrt(head_dim)
    out = torch.empty((b, s, heads * head_dim), dtype=v.dtype,
                      device=v.device)
    for bi in range(b):
        for h in range(heads):
            lanes = slice(h * head_dim, (h + 1) * head_dim)
            kh = k[bi, :, lanes].float()
            vh = v[bi, :, lanes].float()
            for r0 in range(0, s, _MP_ROWS):
                rows = slice(r0, r0 + _MP_ROWS)
                sc = torch.matmul(q[bi, rows, lanes].float(), kh.T)
                sc.mul_(scale)
                sc.sub_(sc.amax(-1, keepdim=True)).exp2_()
                l = sc.sum(-1, keepdim=True)
                o = torch.matmul(sc.to(v.dtype).float(), vh)
                out[bi, rows, lanes] = (o / l.clamp_min(1e-30)).to(v.dtype)
    return out


def _lanes(qkv: torch.Tensor, heads: int, head_dim: int):
    hd = heads * head_dim
    return qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:3 * hd]


def reference_mp_double(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                        heads: int, head_dim: int):
    """Plain multi-pass joint attention (the JAX ``_fused_double_mp``,
    :867-898, with the kernel's streaming replaced by the exact max)."""
    tq, tk, tv = _lanes(txt_qkv, heads, head_dim)
    iq, ik, iv = _lanes(img_qkv, heads, head_dim)
    t_len = tq.shape[1]
    ct, st = cos[:t_len], sin[:t_len]
    ci, si = cos[t_len:], sin[t_len:]
    q = torch.cat([prep_norm_rope(tq, wq_t, ct, st, head_dim),
                   prep_norm_rope(iq, wq_i, ci, si, head_dim)], dim=1)
    k = torch.cat([prep_norm_rope(tk, wk_t, ct, st, head_dim),
                   prep_norm_rope(ik, wk_i, ci, si, head_dim)], dim=1)
    out = _mp_attention(q, k, torch.cat([tv, iv], dim=1), heads, head_dim)
    return out[:, :t_len], out[:, t_len:]


def reference_mp_single(proj, wq, wk, cos, sin, heads: int, head_dim: int):
    """Plain multi-pass single-stream attention (the JAX
    ``_fused_single_mp``, :924-942)."""
    q, k, v = _lanes(proj, heads, head_dim)
    return _mp_attention(prep_norm_rope(q, wq, cos, sin, head_dim),
                         prep_norm_rope(k, wk, cos, sin, head_dim), v,
                         heads, head_dim)


def _multipass(s_total: int) -> bool:
    """The fused regime of a joint length: False one pass, True
    multi-pass."""
    return s_total > _MAX_ONEPASS


def _fused_ok(head_dim: int, dtype: torch.dtype, s_total: int) -> bool:
    """The JAX ``_fused_ok`` gate: bf16, head_dim 128, at most
    ``_MAX_MULTIPASS`` joint tokens, and not inside ``dense_attention``."""
    return (head_dim == HEAD_DIM and dtype == torch.bfloat16
            and s_total <= _MAX_MULTIPASS and not forced_dense())


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("mmdit_attention")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for fn in (lib.mmdit_attention, lib.mmdit_attention_mp):
            fn.argtypes = [p, ll, ll, i, p, ll, ll, i, p, p, p, p, p, p, p,
                           p, p, p, i, i, ctypes.c_float, p]
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_stream(x: torch.Tensor, heads: int, what: str) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        raise ValueError(f"{what}: expected a (B, S, W) bf16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.shape[-1] < 3 * heads * HEAD_DIM or x.stride(-1) != 1:
        raise ValueError(f"{what}: needs >= {3 * heads * HEAD_DIM} "
                         f"unit-stride lanes, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8:
        raise ValueError(f"{what}: rows must be 16-byte aligned "
                         f"(strides {x.stride()})")


def _launch(streams: Sequence[torch.Tensor],
            norm_w: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            cos: torch.Tensor, sin: torch.Tensor, heads: int,
            head_dim: int, multipass: bool):
    """One or two row sources -> one (B, S_i, H*128) output per source.
    ``multipass`` launches the multi-pass entry (no q prescale; the
    prescale multiplies the f32 scores) instead of the one-pass one."""
    if head_dim != HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head_dim {HEAD_DIM} only, "
                         f"got {head_dim}")
    dev = streams[0].device
    b = streams[0].shape[0]
    for i, x in enumerate(streams):
        _check_stream(x, heads, f"stream {i}")
        if x.device != dev or x.shape[0] != b:
            raise ValueError("streams differ in device or batch")
    lens = [x.shape[1] for x in streams]
    s_tot = sum(lens)
    half = head_dim // 2
    cos = cos.to(device=dev, dtype=torch.float32).contiguous()
    sin = sin.to(device=dev, dtype=torch.float32).contiguous()
    if cos.shape != (s_tot, half) or sin.shape != (s_tot, half):
        raise ValueError(f"cos/sin must be ({s_tot}, {half}), got "
                         f"{tuple(cos.shape)}")
    ws = [tuple(w.to(device=dev, dtype=torch.float32).contiguous()
                for w in pair) for pair in norm_w]
    for w in (t for pair in ws for t in pair):
        if w.shape != (head_dim,):
            raise ValueError(f"norm weights must be ({head_dim},)")
    qs = torch.empty((b, heads, s_tot, head_dim), dtype=torch.bfloat16,
                     device=dev)
    ks = torch.empty_like(qs)
    outs = [torch.empty((b, n, heads * head_dim), dtype=torch.bfloat16,
                        device=dev) for n in lens]
    a, bb = streams[0], streams[-1]
    (wq_a, wk_a), (wq_b, wk_b) = ws[0], ws[-1]
    s_b = lens[1] if len(streams) == 2 else 0
    lib = _lib()
    entry = lib.mmdit_attention_mp if multipass else lib.mmdit_attention
    rc = entry(
        a.data_ptr(), a.stride(0), a.stride(1), lens[0],
        bb.data_ptr(), bb.stride(0), bb.stride(1), s_b,
        wq_a.data_ptr(), wk_a.data_ptr(), wq_b.data_ptr(), wk_b.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), qs.data_ptr(), ks.data_ptr(),
        outs[0].data_ptr(), outs[-1].data_ptr(), b, heads,
        LOG2_E / math.sqrt(head_dim),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mmdit_attention kernel launch failed "
                           f"(multipass={multipass}): CUDA error {rc}")
    return outs


# ---------------------------------------------------------------------------
# fused forward, unfused backward (the JAX custom VJPs)
# ---------------------------------------------------------------------------

def _double_forward(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                    heads: int, head_dim: int):
    mp = _multipass(txt_qkv.shape[1] + img_qkv.shape[1])
    if txt_qkv.device.type == "cpu":
        plain = reference_mp_double if mp else reference_double
        return plain(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                     heads, head_dim)
    out_t, out_i = _launch([txt_qkv, img_qkv], [(wq_t, wk_t), (wq_i, wk_i)],
                           cos, sin, heads, head_dim, mp)
    if mp:
        mmdit_double_attention.mp_launches += 1
    else:
        mmdit_double_attention.launches += 1
    return out_t, out_i


def _single_forward(proj, wq, wk, cos, sin, heads: int, head_dim: int):
    mp = _multipass(proj.shape[1])
    if proj.device.type == "cpu":
        plain = reference_mp_single if mp else reference_single
        return plain(proj, wq, wk, cos, sin, heads, head_dim)
    (out,) = _launch([proj], [(wq, wk)], cos, sin, heads, head_dim, mp)
    if mp:
        mmdit_single_attention.mp_launches += 1
    else:
        mmdit_single_attention.launches += 1
    return out


def _unfused_grads(ctx, reference, grads, n_diff: int):
    """Gradients of the unfused composition at the saved inputs (the JAX
    ``bwd``: ``jax.vjp(ref, *res)[1](g)``), for the first ``n_diff``
    inputs (the qkv streams and the qk-norm scales; cos/sin get None)."""
    saved = ctx.saved_tensors
    want = [i for i in range(n_diff) if ctx.needs_input_grad[i]]
    with torch.enable_grad():
        args = [x.detach().requires_grad_(i in want)
                for i, x in enumerate(saved)]
        out = reference(*args, *ctx.dims)
    got = torch.autograd.grad(out, [args[i] for i in want], grads,
                              allow_unused=True) if want else ()
    result = [None] * (len(saved) + len(ctx.dims))
    for i, g in zip(want, got):
        result[i] = g
    return tuple(result)


class _FusedDouble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                heads, head_dim):
        ctx.save_for_backward(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos,
                              sin)
        ctx.dims = (heads, head_dim)
        return _double_forward(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos,
                               sin, heads, head_dim)

    @staticmethod
    def backward(ctx, g_t, g_i):
        return _unfused_grads(ctx, reference_double, (g_t, g_i), 6)


class _FusedSingle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj, wq, wk, cos, sin, heads, head_dim):
        ctx.save_for_backward(proj, wq, wk, cos, sin)
        ctx.dims = (heads, head_dim)
        return _single_forward(proj, wq, wk, cos, sin, heads, head_dim)

    @staticmethod
    def backward(ctx, g):
        return _unfused_grads(ctx, reference_single, (g,), 3)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def mmdit_double_attention(txt_qkv, img_qkv, txt_qknorm, img_qknorm,
                           cos, sin, heads: int, head_dim: int):
    """Joint [txt; img] attention from the two raw qkv GEMM outputs.

    txt_qkv/img_qkv: (B, S, 3*heads*head_dim) fused projections;
    *_qknorm: rmsnorm param dicts ({"q": {"scale"}, "k": {"scale"}});
    cos/sin: RoPE tables (S_txt + S_img, head_dim/2), text rows first.
    Returns (txt_attn, img_attn), each (B, S, heads*head_dim)."""
    wq_t, wk_t = txt_qknorm["q"]["scale"], txt_qknorm["k"]["scale"]
    wq_i, wk_i = img_qknorm["q"]["scale"], img_qknorm["k"]["scale"]
    args = (txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin, heads,
            head_dim)
    if not _fused_ok(head_dim, txt_qkv.dtype,
                     txt_qkv.shape[1] + img_qkv.shape[1]):
        return reference_double(*args)
    return _FusedDouble.apply(*args)


def mmdit_single_attention(proj, qknorm, cos, sin, heads: int,
                           head_dim: int):
    """Attention over one joint stream from the fused linear1 output.

    proj: (B, S, W) with q/k/v in the first 3*heads*head_dim lanes (the
    trailing MLP lanes are not read). Returns (B, S, heads*head_dim)."""
    args = (proj, qknorm["q"]["scale"], qknorm["k"]["scale"], cos, sin,
            heads, head_dim)
    if not _fused_ok(head_dim, proj.dtype, proj.shape[1]):
        return reference_single(*args)
    return _FusedSingle.apply(*args)


for _wrapper in (mmdit_double_attention, mmdit_single_attention):
    _wrapper.launches = 0
    _wrapper.mp_launches = 0

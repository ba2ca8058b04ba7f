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
``_MAX_MULTIPASS``, outside :func:`ops.attention.dense_attention` and the
tensor- and sequence-parallel contexts (``tp_attention``,
``sp_attention``). Every
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

The int8 serving modes (:func:`set_int8_qk`, :func:`set_int8_pv`;
process-wide flags read at every call; int8 P.V implies int8 QK) change
what the fused path computes, never its routing: under them the one-pass
regime is the int8 branches of ``_seq_kernel`` / ``_joint_kernel``
(:339-397, :416-504; plain versions :func:`reference_i8_double` /
:func:`reference_i8_single`) and the multi-pass regime
``_flash_mp_kernel_i8`` (:638; :func:`reference_mp_i8_double` /
:func:`reference_mp_i8_single`, max windows of 1024 keys). On the card
they run the B7 kernels of ``csrc/int8_attention.cu``; the backward stays
the unfused composition's.

Each wrapper counts its kernel launches: one-pass in
``<wrapper>.launches``, multi-pass in ``<wrapper>.mp_launches``, and the
int8 kernels in ``<wrapper>.i8_launches`` / ``<wrapper>.i8_mp_launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence, Tuple

import torch

from .attention import attention, forced_dense, sp_context, tp_context
from .int8_gemm import div127

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


def _rope_f32(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], shape[-1] // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    c, s = cos.float(), sin.float()
    out = torch.stack([x0 * c - x1 * s, x0 * s + x1 * c], dim=-1)
    return out.reshape(shape)


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """x (..., D); cos/sin (..., D/2), broadcasting against x's leading
    dims: (S, D/2) for (B, H, S, D), (S, 1, D/2) for (B, S, H, D). The
    pair (x[2i], x[2i+1]) rotates by angle i — not the half-split
    ``rotate_half`` layout."""
    return _rope_f32(x, cos, sin).to(x.dtype)


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


# ---------------------------------------------------------------------------
# int8 modes: plain versions (the JAX int8 branches, exactly)
# ---------------------------------------------------------------------------

_INT8_QK = False
_INT8_PV = False
_BKV_I8 = 1024          # K/V columns per max window of the int8 multi-pass


def set_int8_qk(enabled: bool) -> None:
    """int8 QK scores inside the fused attention (process-wide, read at
    every call, as the JAX package's trace-time flag)."""
    global _INT8_QK
    _INT8_QK = bool(enabled)


def int8_qk_enabled() -> bool:
    return _INT8_QK


def set_int8_pv(enabled: bool) -> None:
    """int8 P.V as well (implies int8 QK at dispatch)."""
    global _INT8_PV
    _INT8_PV = bool(enabled)


def int8_pv_enabled() -> bool:
    return _INT8_PV


def _quant(x: torch.Tensor, dim=None):
    """Symmetric int8 over ``dim`` (None: the whole tensor), as integer-
    valued f32 (exact in every product below) and its f32 scale:
    max(amax / 127, 1e-12), round half to even, clip to +-127."""
    ax = x.abs()
    amax = ax.amax() if dim is None else ax.amax(dim=dim, keepdim=True)
    s = div127(amax).clamp_min(1e-12)
    return torch.clamp(torch.round(x / s), -127, 127), s


def _int_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of integer-valued tensors, exact (float64: any sum of up to
    2^38 products of int8 values), rounded once to f32 as int32 -> f32."""
    return torch.matmul(a.double(), b.double()).float()


def _i8_onepass_head(qf, ks, vs, pv: bool, out_dtype):
    """One (batch, head) of the one-pass int8 kernels (``_seq_kernel`` /
    ``_joint_kernel`` int8 branches, ops/mmdit_attention.py:339-397,
    :416-504). qf (S, 128): normed, roped, prescaled f32 q; ks: one (single
    block) or two (joint, txt then img) f32 K streams; vs: the V streams.
    q is quantized per row, each K stream per tensor, each V stream per
    column. Scores are exact integers (|s| <= 128 * 127^2 < 2^24, so f32
    products are exact); the single block folds the dequant into
    exp2((s - m) * alpha) with the integer row max, the joint block takes
    the max in the real domain over both streams, exp2(s * alpha - m)."""
    k8 = [_quant(k) for k in ks]
    v8 = [_quant(v.float(), 0) for v in vs] if pv else None
    out = torch.empty((qf.shape[0], qf.shape[1]), dtype=out_dtype,
                      device=qf.device)
    for r0 in range(0, qf.shape[0], _MP_ROWS):
        rows = slice(r0, r0 + _MP_ROWS)
        q8, sq = _quant(qf[rows], -1)
        scores = [torch.matmul(q8, k.T) for k, _ in k8]
        if len(ks) == 1:
            m = scores[0].amax(-1, keepdim=True)
            ps = [torch.exp2((scores[0] - m) * (sq * k8[0][1]))]
        else:
            alphas = [sq * sk for _, sk in k8]
            m = torch.maximum(*[s.amax(-1, keepdim=True) * a
                                for s, a in zip(scores, alphas)])
            ps = [torch.exp2(s * a - m) for s, a in zip(scores, alphas)]
        del scores
        if pv:
            pq = [torch.round(p * 127.0) for p in ps]
            l = sum(p.sum(-1, keepdim=True) for p in pq)
            o = sum(_int_dot(p, v) * s for p, (v, s) in zip(pq, v8))
            out[rows] = (o / l).to(out_dtype)
        else:
            l = sum(p.sum(-1, keepdim=True) for p in ps)
            o = sum(torch.matmul(p.to(v.dtype).float(), v.float())
                    for p, v in zip(ps, vs))
            out[rows] = (o / l.clamp_min(1e-30)).to(out_dtype)
    return out


def _norm_rope_f32(x, w, cos, sin, heads: int, head_dim: int):
    """(B, S, H*D) raw lanes -> (B, S, H, D) f32 normed and roped, with no
    round at the end (the JAX ``_norm_rope(..., out_dtype=f32)``,
    :276-290)."""
    b, s, _ = x.shape
    y = _rms(x.reshape(b, s, heads, head_dim), w)
    return _rope_f32(y, cos[:, None], sin[:, None])


def reference_i8_double(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                        heads: int, head_dim: int, pv: bool = False):
    """Plain one-pass joint int8 attention (``_joint_kernel``'s int8
    branches; ``pv``: int8 P.V too). Returns (txt_out, img_out)."""
    tq, tk, tv = _lanes(txt_qkv, heads, head_dim)
    iq, ik, iv = _lanes(img_qkv, heads, head_dim)
    t_len = tq.shape[1]
    ct, st, ci, si = cos[:t_len], sin[:t_len], cos[t_len:], sin[t_len:]
    prescale = LOG2_E / math.sqrt(head_dim)
    qf = torch.cat([_norm_rope_f32(tq, wq_t, ct, st, heads, head_dim),
                    _norm_rope_f32(iq, wq_i, ci, si, heads, head_dim)],
                   dim=1) * prescale
    kt = _norm_rope_f32(tk, wk_t, ct, st, heads, head_dim)
    ki = _norm_rope_f32(ik, wk_i, ci, si, heads, head_dim)
    b = txt_qkv.shape[0]
    out = torch.empty((b, qf.shape[1], heads * head_dim),
                      dtype=txt_qkv.dtype, device=txt_qkv.device)
    for bi in range(b):
        for h in range(heads):
            lanes = slice(h * head_dim, (h + 1) * head_dim)
            out[bi, :, lanes] = _i8_onepass_head(
                qf[bi, :, h], [kt[bi, :, h], ki[bi, :, h]],
                [tv[bi, :, lanes], iv[bi, :, lanes]], pv, out.dtype)
    return out[:, :t_len], out[:, t_len:]


def reference_i8_single(proj, wq, wk, cos, sin, heads: int, head_dim: int,
                        pv: bool = False):
    """Plain one-pass single-stream int8 attention (``_seq_kernel``'s
    int8 branches)."""
    q, k, v = _lanes(proj, heads, head_dim)
    qf = _norm_rope_f32(q, wq, cos, sin, heads, head_dim) \
        * (LOG2_E / math.sqrt(head_dim))
    kf = _norm_rope_f32(k, wk, cos, sin, heads, head_dim)
    out = torch.empty((proj.shape[0], proj.shape[1], heads * head_dim),
                      dtype=proj.dtype, device=proj.device)
    for bi in range(proj.shape[0]):
        for h in range(heads):
            lanes = slice(h * head_dim, (h + 1) * head_dim)
            out[bi, :, lanes] = _i8_onepass_head(
                qf[bi, :, h], [kf[bi, :, h]], [v[bi, :, lanes]], pv,
                out.dtype)
    return out


def _mp_i8_attention(q, k, v, heads: int, head_dim: int, pv: bool,
                     bkv: int) -> torch.Tensor:
    """The int8 multi-pass numerics (``_mp_i8_common`` ->
    ``_flash_mp_kernel_i8``, :901-921, :638-683) over (B, S, H*D)
    prenormed q/k and raw v: q and k quantized per (batch, head) over the
    whole joint sequence with the prescale folded into q's scale, V per
    (batch, head, column) with ``pv``; f32 scores s = (q8 k8^T) * alpha;
    an online softmax whose max is updated once per window of ``bkv``
    columns, P quantized against that running max with ``pv`` (rounded
    to v's dtype without), and the V column scale applied once at the end.
    One (batch, head, block of q rows) at a time."""
    b, s, _ = q.shape
    prescale = LOG2_E / math.sqrt(head_dim)
    out = torch.empty((b, s, heads * head_dim), dtype=v.dtype,
                      device=v.device)
    for bi in range(b):
        for h in range(heads):
            lanes = slice(h * head_dim, (h + 1) * head_dim)
            q8, qs = _quant(q[bi, :, lanes].float())
            k8, ks = _quant(k[bi, :, lanes].float())
            alpha = (qs * prescale) * ks
            if pv:
                vh, vs = _quant(v[bi, :, lanes].float(), 0)
            else:
                vh = v[bi, :, lanes].float()
            for r0 in range(0, s, _MP_ROWS):
                rows = slice(r0, r0 + _MP_ROWS)
                sc = torch.matmul(q8[rows], k8.T) * alpha
                n = sc.shape[0]
                m = torch.full((n, 1), -1e30, device=q.device)
                l = torch.zeros((n, 1), device=q.device)
                acc = torch.zeros((n, head_dim), device=q.device)
                for w0 in range(0, s, bkv):
                    sw = sc[:, w0:w0 + bkv]
                    m_new = torch.maximum(m, sw.amax(-1, keepdim=True))
                    corr = torch.exp2(m - m_new)
                    p = torch.exp2(sw - m_new)
                    if pv:
                        p = torch.round(p * 127.0)
                        pv_w = _int_dot(p, vh[w0:w0 + bkv])
                    else:
                        pv_w = torch.matmul(p.to(v.dtype).float(),
                                            vh[w0:w0 + bkv])
                    l = l * corr + p.sum(-1, keepdim=True)
                    acc = acc * corr + pv_w
                    m = m_new
                o = acc / l.clamp_min(1e-30)
                if pv:
                    o = o * vs
                out[bi, rows, lanes] = o.to(v.dtype)
    return out


def reference_mp_i8_double(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos,
                           sin, heads: int, head_dim: int, pv: bool = False,
                           bkv: int = _BKV_I8):
    """Plain multi-pass joint int8 attention (``_fused_double_mp`` with
    int8 QK, :867-898): ``_prep_norm_rope`` per stream, the streams
    concatenated, then :func:`_mp_i8_attention`."""
    tq, tk, tv = _lanes(txt_qkv, heads, head_dim)
    iq, ik, iv = _lanes(img_qkv, heads, head_dim)
    t_len = tq.shape[1]
    ct, st = cos[:t_len], sin[:t_len]
    ci, si = cos[t_len:], sin[t_len:]
    q = torch.cat([prep_norm_rope(tq, wq_t, ct, st, head_dim),
                   prep_norm_rope(iq, wq_i, ci, si, head_dim)], dim=1)
    k = torch.cat([prep_norm_rope(tk, wk_t, ct, st, head_dim),
                   prep_norm_rope(ik, wk_i, ci, si, head_dim)], dim=1)
    out = _mp_i8_attention(q, k, torch.cat([tv, iv], dim=1), heads,
                           head_dim, pv, bkv)
    return out[:, :t_len], out[:, t_len:]


def reference_mp_i8_single(proj, wq, wk, cos, sin, heads: int,
                           head_dim: int, pv: bool = False,
                           bkv: int = _BKV_I8):
    """Plain multi-pass single-stream int8 attention (``_fused_single_mp``
    with int8 QK, :924-942)."""
    q, k, v = _lanes(proj, heads, head_dim)
    return _mp_i8_attention(prep_norm_rope(q, wq, cos, sin, head_dim),
                            prep_norm_rope(k, wk, cos, sin, head_dim), v,
                            heads, head_dim, pv, bkv)


def _multipass(s_total: int) -> bool:
    """The fused regime of a joint length: False one pass, True
    multi-pass."""
    return s_total > _MAX_ONEPASS


def _fused_ok(head_dim: int, dtype: torch.dtype, s_total: int) -> bool:
    """The JAX ``_fused_ok`` gate: bf16, head_dim 128, at most
    ``_MAX_MULTIPASS`` joint tokens, and not inside ``dense_attention``,
    ``tp_attention`` or ``sp_attention``."""
    return (head_dim == HEAD_DIM and dtype == torch.bfloat16
            and s_total <= _MAX_MULTIPASS and not forced_dense()
            and tp_context() is None and sp_context() is None)


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
                           p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
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




def _prepare(streams, norm_w, cos, sin, heads: int, head_dim: int):
    """Checks the row sources and returns (device, batch, lengths, f32
    cos, f32 sin, f32 norm weight pairs) for a launch."""
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
    return dev, b, lens, cos, sin, ws


def _rows_args(streams, lens, ws):
    """The C entries' leading arguments: both row sources (the second is
    the first again, with 0 rows, for the single block) and the norm
    weights."""
    a, bb = streams[0], streams[-1]
    (wq_a, wk_a), (wq_b, wk_b) = ws[0], ws[-1]
    s_b = lens[1] if len(streams) == 2 else 0
    return (a.data_ptr(), a.stride(0), a.stride(1), lens[0],
            bb.data_ptr(), bb.stride(0), bb.stride(1), s_b,
            wq_a.data_ptr(), wk_a.data_ptr(), wq_b.data_ptr(),
            wk_b.data_ptr())


def _launch(streams: Sequence[torch.Tensor],
            norm_w: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            cos: torch.Tensor, sin: torch.Tensor, heads: int,
            head_dim: int, multipass: bool):
    """One or two row sources -> one (B, S_i, H*128) output per source.
    ``multipass`` launches the multi-pass entry (no q prescale; the
    prescale multiplies the f32 scores) instead of the one-pass one. The
    prepped q and k go to (B, H, n_pad, 128) scratch in the padded row
    space of :func:`_i8_plan` (QK-only layout: stream b from the first
    128-row boundary after stream a); V is read in place, from the lanes
    at 2*H*128 of each stream's rows."""
    dev, b, lens, cos, sin, ws = _prepare(streams, norm_w, cos, sin, heads,
                                          head_dim)
    plan = _i8_plan(lens[0], lens[1] if len(streams) == 2 else 0, False,
                    False)
    qs = torch.empty((b, heads, plan.n_pad, head_dim), dtype=torch.bfloat16,
                     device=dev)
    ks = torch.empty_like(qs)
    outs = [torch.empty((b, n, heads * head_dim), dtype=torch.bfloat16,
                        device=dev) for n in lens]
    v_off = 2 * heads * head_dim * streams[0].element_size()
    rows = _rows_args(streams, lens, ws)
    lib = _lib()
    entry = lib.mmdit_attention_mp if multipass else lib.mmdit_attention
    rc = entry(
        *rows[:8], streams[0].data_ptr() + v_off,
        streams[-1].data_ptr() + v_off, *rows[8:], cos.data_ptr(),
        sin.data_ptr(), qs.data_ptr(), ks.data_ptr(), outs[0].data_ptr(),
        outs[-1].data_ptr(), b, heads, plan.b0, plan.n_pad,
        LOG2_E / math.sqrt(head_dim),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mmdit_attention kernel launch failed "
                           f"(multipass={multipass}): CUDA error {rc}")
    return outs


_LIB_I8 = None


def _lib_i8():
    global _LIB_I8
    if _LIB_I8 is None:
        from . import _build
        lib = _build.load("int8_attention")
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mmdit_attention_i8.argtypes = [
            p, ll, ll, i, p, ll, ll, i, p, p, p, p, p, p, p, p, p, p, p, p,
            p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.mmdit_attention_i8.restype = ctypes.c_int
        _LIB_I8 = lib
    return _LIB_I8


_I8_TILE = 128          # q rows per block and keys per tile (int8 kernels)


class I8Plan(NamedTuple):
    """The padded row space of the fused kernels' scratch (int8, and bf16
    in the QK-only layout): stream a at rows [0, s_a), stream b at [b0, b0
    + s_b), ``n_pad`` rows in all."""
    b0: int
    n_pad: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _i8_plan(s_a: int, s_b: int, multipass: bool, pv: bool) -> I8Plan:
    """Where the fused kernels put the two streams. A K/V tile of
    ``_I8_TILE`` keys must not mix two streams' K or V scales (int8 one
    pass), and the int8 QK-only instance and the bf16 kernels (both
    regimes: ``multipass=pv=False``) read each stream's bf16 V in place
    from a tile boundary, so stream b starts at the first tile boundary
    after stream a. The int8 P.V multi-pass keeps the joint sequence contiguous
    instead (one scale per (batch, head)), so that its max windows of
    ``_BKV_I8`` keys count from the first joint row, as the plain
    version's do. n_pad is a whole number of tiles (and of 128-row q
    blocks)."""
    b0 = s_a if multipass and pv else _round_up(s_a, _I8_TILE)
    return I8Plan(b0, _round_up(b0 + s_b, _I8_TILE))


def _launch_i8(streams, norm_w, cos, sin, heads: int, head_dim: int,
               multipass: bool, pv: bool):
    """The int8 kernels (B7) of ``csrc/int8_attention.cu`` for the regime:
    one or two row sources -> one (B, S_i, H*128) bf16 output per source.
    Scratch, in the padded row space of :func:`_i8_plan`: int8 q and k
    (B, H, n_pad, 128), q's f32 row scales, int8 V transposed
    (B, H, 128, n_pad) with ``pv``, and the f32 maxima the scales come
    from."""
    dev, b, lens, cos, sin, ws = _prepare(streams, norm_w, cos, sin, heads,
                                          head_dim)
    s_a, s_b = lens[0], (lens[1] if len(streams) == 2 else 0)
    plan = _i8_plan(s_a, s_b, multipass, pv)
    q8 = torch.empty((b, heads, plan.n_pad, head_dim), dtype=torch.int8,
                     device=dev)
    k8 = torch.empty_like(q8)
    qsc = torch.empty((b, heads, plan.n_pad), dtype=torch.float32,
                      device=dev)
    v8t = torch.empty((b, heads, head_dim, plan.n_pad), dtype=torch.int8,
                      device=dev) if pv else q8
    amax = torch.zeros((b, heads, 3 + 2 * head_dim), dtype=torch.float32,
                       device=dev)
    outs = [torch.empty((b, n, heads * head_dim), dtype=torch.bfloat16,
                        device=dev) for n in lens]
    rc = _lib_i8().mmdit_attention_i8(
        *_rows_args(streams, lens, ws),
        cos.data_ptr(), sin.data_ptr(), q8.data_ptr(), qsc.data_ptr(),
        k8.data_ptr(), v8t.data_ptr(), amax.data_ptr(), outs[0].data_ptr(),
        outs[-1].data_ptr(), b, heads, plan.b0, plan.n_pad, int(multipass),
        int(pv), LOG2_E / math.sqrt(head_dim),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mmdit_attention_i8 kernel launch failed "
                           f"(multipass={multipass}, pv={pv}): CUDA error "
                           f"{rc}")
    return outs


# ---------------------------------------------------------------------------
# fused forward, unfused backward (the JAX custom VJPs)
# ---------------------------------------------------------------------------

_BF16 = (False, False)  # the dispatch mode: (int8 QK, int8 P.V)


def _mode():
    """(int8 QK, int8 P.V) as the flags stand: int8 P.V implies int8 QK
    (the JAX dispatch, :1209-1211, :1235-1237)."""
    return (_INT8_QK or _INT8_PV, _INT8_PV)


def _double_forward(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                    heads: int, head_dim: int, mode=_BF16):
    int8, pv = mode
    args = (txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin, heads,
            head_dim)
    mp = _multipass(txt_qkv.shape[1] + img_qkv.shape[1])
    if txt_qkv.device.type == "cpu":
        if int8:
            plain = reference_mp_i8_double if mp else reference_i8_double
            return plain(*args, pv=pv)
        plain = reference_mp_double if mp else reference_double
        return plain(*args)
    streams, norms = [txt_qkv, img_qkv], [(wq_t, wk_t), (wq_i, wk_i)]
    if int8:
        out_t, out_i = _launch_i8(streams, norms, cos, sin, heads, head_dim,
                                  mp, pv)
        counter = "i8_mp_launches" if mp else "i8_launches"
    else:
        out_t, out_i = _launch(streams, norms, cos, sin, heads, head_dim, mp)
        counter = "mp_launches" if mp else "launches"
    setattr(mmdit_double_attention, counter,
            getattr(mmdit_double_attention, counter) + 1)
    return out_t, out_i


def _single_forward(proj, wq, wk, cos, sin, heads: int, head_dim: int,
                    mode=_BF16):
    int8, pv = mode
    args = (proj, wq, wk, cos, sin, heads, head_dim)
    mp = _multipass(proj.shape[1])
    if proj.device.type == "cpu":
        if int8:
            plain = reference_mp_i8_single if mp else reference_i8_single
            return plain(*args, pv=pv)
        plain = reference_mp_single if mp else reference_single
        return plain(*args)
    if int8:
        (out,) = _launch_i8([proj], [(wq, wk)], cos, sin, heads, head_dim,
                            mp, pv)
        counter = "i8_mp_launches" if mp else "i8_launches"
    else:
        (out,) = _launch([proj], [(wq, wk)], cos, sin, heads, head_dim, mp)
        counter = "mp_launches" if mp else "launches"
    setattr(mmdit_single_attention, counter,
            getattr(mmdit_single_attention, counter) + 1)
    return out


def _unfused_grads(ctx, reference, grads, n_diff: int):
    """Gradients of the unfused composition at the saved inputs (the JAX
    ``bwd``: ``jax.vjp(ref, *res)[1](g)``), for the first ``n_diff``
    inputs (the qkv streams and the qk-norm scales; cos/sin and the
    non-tensor arguments get None)."""
    saved = ctx.saved_tensors
    want = [i for i in range(n_diff) if ctx.needs_input_grad[i]]
    with torch.enable_grad():
        args = [x.detach().requires_grad_(i in want)
                for i, x in enumerate(saved)]
        out = reference(*args, *ctx.dims)
    got = torch.autograd.grad(out, [args[i] for i in want], grads,
                              allow_unused=True) if want else ()
    result = [None] * len(ctx.needs_input_grad)
    for i, g in zip(want, got):
        result[i] = g
    return tuple(result)


class _FusedDouble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos, sin,
                heads, head_dim, mode):
        ctx.save_for_backward(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos,
                              sin)
        ctx.dims = (heads, head_dim)
        return _double_forward(txt_qkv, img_qkv, wq_t, wk_t, wq_i, wk_i, cos,
                               sin, heads, head_dim, mode)

    @staticmethod
    def backward(ctx, g_t, g_i):
        return _unfused_grads(ctx, reference_double, (g_t, g_i), 6)


class _FusedSingle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj, wq, wk, cos, sin, heads, head_dim, mode):
        ctx.save_for_backward(proj, wq, wk, cos, sin)
        ctx.dims = (heads, head_dim)
        return _single_forward(proj, wq, wk, cos, sin, heads, head_dim,
                               mode)

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
    return _FusedDouble.apply(*args, _mode())


def mmdit_single_attention(proj, qknorm, cos, sin, heads: int,
                           head_dim: int):
    """Attention over one joint stream from the fused linear1 output.

    proj: (B, S, W) with q/k/v in the first 3*heads*head_dim lanes (the
    trailing MLP lanes are not read). Returns (B, S, heads*head_dim)."""
    args = (proj, qknorm["q"]["scale"], qknorm["k"]["scale"], cos, sin,
            heads, head_dim)
    if not _fused_ok(head_dim, proj.dtype, proj.shape[1]):
        return reference_single(*args)
    return _FusedSingle.apply(*args, _mode())


for _wrapper in (mmdit_double_attention, mmdit_single_attention):
    _wrapper.launches = 0
    _wrapper.mp_launches = 0
    _wrapper.i8_launches = 0
    _wrapper.i8_mp_launches = 0

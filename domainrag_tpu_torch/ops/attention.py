"""Generic flash attention (port of ``domainrag_tpu/ops/attention.py``).

(B, H, S, D) attention with a natural-log LSE, differentiable through a
custom backward, as the JAX package's ``flash_attention`` (:455-493):

- forward, B5: the TPU ``_flash_kernel_1pass`` (:110) and ``_flash_kernel``
  (:43) behind ``_flash_forward`` (:184). q is multiplied by
  log2(e)/sqrt(D) in f32 and rounded back to its dtype before the kernel
  (:199-200); the softmax is exp2; the LSE is m*ln2 + log(l) (:107, :137).
  An optional causal mask and a runtime ``kv_valid`` bound mask kv
  positions; masked probabilities are zeroed explicitly (:89-93). In f32
  the kernel runs its products on the tensor cores as bf16 terms, in a
  bf16 scratch of ``F32_TERM_PLANES`` planes of q, k and v that the
  wrapper allocates for the call.
- backward, B6: the TPU ``_flash_bwd_dq_kernel`` (:296) and
  ``_flash_bwd_dkv_kernel`` (:336) behind ``_flash_backward`` (:382), from
  the stored LSE and delta = rowsum(dO*O): p = exp(s/sqrt(D) - lse) in
  natural units on an unscaled q, ds = p*(dp - delta), dq = ds k/sqrt(D),
  dk = ds^T q/sqrt(D), dv = p^T dO. In each dtype one kernel computes all
  three and adds dq into an f32 tensor across blocks (its sum order varies
  from run to run), which the wrapper zeroes first. In bf16 that is an
  accumulator the wrapper then scales by 1/sqrt(D) and rounds to bf16; in
  f32 (every product as 3xTF32 on the tensor cores) the kernel scales, and
  it is dq.

On a CUDA tensor the wrappers launch the hand-written Hopper kernels of
``csrc/flash_attention.cu`` (its header states each kernel's bound and
design) or raise; on a CPU tensor they run the plain versions
:func:`flash_forward_reference` / :func:`flash_backward_reference`, which
work one (batch, head) and one block of q rows at a time so that a
50k-token check fits in memory. Launches are counted on
:func:`flash_attention`: ``.launches`` (forward, also through
:func:`flash_attention_lse`), ``.bwd_launches`` (the bf16 backward's one
kernel) and ``.bwd_f32_launches`` (the f32 backward's one; both also
through :func:`flash_attention_lse`'s backward, where a gradient on the
LSE output enters B6 as delta - dlse); ``.bwd_launches_by_shape`` counts
both B6 kernels per (Sq, Skv, kv_valid), so that a ragged ring block's
launches are told from its full ones.

:func:`attention` is the dispatcher the unfused MMDiT composition calls
(:592-620): a ``mask`` takes the dense masked path, a CPU tensor the dense
:func:`attention_reference`, a CUDA tensor the kernels. Inside
:func:`dense_attention` (or with ``force_reference``) every tensor takes
the dense path: the plain versions of the fused MMDiT kernels use it.
Inside the tensor- and sequence-parallel contexts (:func:`tp_attention`,
:func:`sp_attention`) it computes the rank's heads, or rings the K/V
blocks over the mesh (``ops.ring_attention``).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
LOG2_E = 1.4426950408889634
LN_2 = 0.6931471805599453
HEAD_DIM = 128          # the kernels' head width; narrower heads are padded
BWD_Q_TILE = 64         # lse/delta rows are padded to a multiple of this
F32_TERM_PLANES = 3     # bf16 planes per f32 tensor of the f32 forward
DQ_ACCUM_SPAN = "flash_bwd_dq_accum"   # profiler range of its dq_accum ops
_ROWS = 4096            # q rows per block of the plain versions


# ---------------------------------------------------------------------------
# dense reference and the dispatcher's contexts
# ---------------------------------------------------------------------------

def attention_reference(q, k, v, causal: bool = False) -> torch.Tensor:
    """Dense attention over (B, H, S, D): f32 scores and softmax, the
    probabilities rounded to q's dtype for the P.V product (:28-40)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s_q, s_k = logits.shape[-2], logits.shape[-1]
        keep = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


_FORCE_REFERENCE = threading.local()


@contextlib.contextmanager
def dense_attention():
    """Every :func:`attention` call inside takes the dense path, on every
    device (the plain versions of the fused kernels, and debugging)."""
    prev = getattr(_FORCE_REFERENCE, "value", False)
    _FORCE_REFERENCE.value = True
    try:
        yield
    finally:
        _FORCE_REFERENCE.value = prev


def forced_dense() -> bool:
    return getattr(_FORCE_REFERENCE, "value", False)


# ---------------------------------------------------------------------------
# plain versions of B5 and B6 (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------

def _mask(rows: range, s_kv: int, kv_valid: int, causal: bool,
          device) -> torch.Tensor:
    kv_pos = torch.arange(s_kv, device=device)
    keep = (kv_pos < kv_valid)[None, :].expand(len(rows), s_kv)
    if causal:
        q_pos = torch.arange(rows.start, rows.stop, device=device)
        keep = keep & (kv_pos[None, :] <= q_pos[:, None])
    return keep


def flash_forward_reference(q, k, v, causal: bool = False,
                            kv_valid: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The B5 numerics, dense per block of q rows: q prescaled by
    log2(e)/sqrt(D) and rounded to its dtype, s = q k^T in f32, masked to
    -1e30, p = exp2(s - rowmax) zeroed where masked, P rounded to v's
    dtype for P.V, o = (P V) / max(sum p, 1e-30). Returns (out (B, H, Sq,
    D) in q's dtype, lse (B, H, Sq) f32, natural log)."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    kv_valid = s_kv if kv_valid is None else int(kv_valid)
    qs = (q.float() * (LOG2_E / math.sqrt(d))).to(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kf, vf = k[bi, hi].float(), v[bi, hi].float()
            for r0 in range(0, s_q, _ROWS):
                rows = range(r0, min(r0 + _ROWS, s_q))
                keep = _mask(rows, s_kv, kv_valid, causal, q.device)
                s = torch.matmul(qs[bi, hi, r0:rows.stop].float(), kf.T)
                s = s.masked_fill(~keep, NEG_INF)
                m = s.amax(-1, keepdim=True)
                p = torch.exp2(s - m).masked_fill(~keep, 0.0)
                l = p.sum(-1, keepdim=True).clamp_min(1e-30)
                o = torch.matmul(p.to(v.dtype).float(), vf) / l
                out[bi, hi, r0:rows.stop] = o.to(q.dtype)
                lse[bi, hi, r0:rows.stop] = (m * LN_2 + torch.log(l))[:, 0]
    return out, lse


def flash_backward_reference(q, k, v, out, lse, dout, causal: bool = False,
                             kv_valid: Optional[int] = None, dlse=None):
    """The B6 numerics with every product in f32 (:287-380): delta =
    rowsum(dO*O); per block of q rows, p = exp(q k^T/sqrt(D) - lse) zeroed
    where masked, ds = p*(dp - delta) with dp = dO v^T, dq = ds k/sqrt(D),
    dk += ds^T q/sqrt(D), dv += p^T dO. ``dlse`` (B, H, Sq), a gradient on
    the LSE output, adds p*dlse to ds: delta becomes delta - dlse. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    kv_valid = s_kv if kv_valid is None else int(kv_valid)
    scale = 1.0 / math.sqrt(d)
    delta = _delta(out, dout, dlse)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    for bi in range(b):
        for hi in range(h):
            kf, vf = k[bi, hi].float(), v[bi, hi].float()
            dk_acc = torch.zeros_like(kf)
            dv_acc = torch.zeros_like(vf)
            for r0 in range(0, s_q, _ROWS):
                rows = range(r0, min(r0 + _ROWS, s_q))
                sl = slice(r0, rows.stop)
                keep = _mask(rows, s_kv, kv_valid, causal, q.device)
                qf, do = q[bi, hi, sl].float(), dout[bi, hi, sl].float()
                s = torch.matmul(qf, kf.T) * scale
                p = torch.exp(s.masked_fill(~keep, NEG_INF)
                              - lse[bi, hi, sl, None]).masked_fill(~keep, 0.0)
                ds = p * (torch.matmul(do, vf.T) - delta[bi, hi, sl, None])
                dq[bi, hi, sl] = (torch.matmul(ds, kf) * scale).to(q.dtype)
                dk_acc += torch.matmul(ds.T, qf) * scale
                dv_acc += torch.matmul(p.T, do)
            dk[bi, hi] = dk_acc.to(k.dtype)
            dv[bi, hi] = dv_acc.to(v.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel launch
# ---------------------------------------------------------------------------

_LIB = None
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        f = ctypes.c_float
        lib.flash_fwd.argtypes = [i] + [p] * 5 + [i] * 5 + [p, p]
        lib.flash_bwd_bf16.argtypes = [p] * 9 + [i] * 5 + [f, p]
        lib.flash_bwd_f32.argtypes = [p] * 9 + [i] * 5 + [f, p]
        for fn in (lib.flash_fwd, lib.flash_bwd_bf16, lib.flash_bwd_f32):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(tensors, what: str):
    q = tensors[0]
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: the CUDA kernels take bf16 or f32, got "
                         f"{q.dtype}")
    if q.dim() != 4 or q.shape[-1] > HEAD_DIM:
        raise ValueError(f"{what}: expected (B, H, S, D <= {HEAD_DIM}), got "
                         f"{tuple(q.shape)}")
    for t in tensors[1:]:
        if t.dtype != q.dtype or t.device != q.device \
                or t.shape[:2] != q.shape[:2] or t.shape[-1] != q.shape[-1]:
            raise ValueError(f"{what}: q/k/v differ in dtype, device, batch,"
                             " heads or head width")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> contiguous (B*H, S, 128), D zero-padded (the JAX
    ``_pad_to``: padded lanes add nothing to q.k and give zero output)."""
    b, h, s, d = x.shape
    if d < HEAD_DIM:
        x = F.pad(x, (0, HEAD_DIM - d))
    return x.reshape(b * h, s, HEAD_DIM).contiguous()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _kernel_forward(q, k, v, causal: bool, kv_valid: Optional[int]):
    _check((q, k, v), "flash forward")
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    kv_valid = s_kv if kv_valid is None else int(kv_valid)
    if not 0 < kv_valid <= s_kv:
        raise ValueError(f"kv_valid {kv_valid} outside (0, {s_kv}]")
    # one pass: the product is taken in f32 and rounded once to q's dtype,
    # bit for bit the JAX (q.astype(f32) * scale).astype(q.dtype)
    qs = q * (LOG2_E / math.sqrt(d))
    qp, kp, vp = _rows(qs), _rows(k), _rows(v)
    out = torch.empty_like(qp)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device)
    # f32: the kernel's scratch for the three bf16 term planes of q, k, v
    terms = (torch.empty(F32_TERM_PLANES * b * h * HEAD_DIM
                         * (s_q + 2 * s_kv), dtype=torch.bfloat16,
                         device=q.device)
             if q.dtype == torch.float32 else None)
    rc = _lib().flash_fwd(_DTYPES[q.dtype], qp.data_ptr(), kp.data_ptr(),
                          vp.data_ptr(), out.data_ptr(), lse.data_ptr(),
                          b * h, s_q, s_kv, kv_valid, int(causal),
                          None if terms is None else terms.data_ptr(),
                          _stream(q))
    if rc != 0:
        raise RuntimeError(f"flash forward kernel launch failed: CUDA error "
                           f"{rc}")
    flash_attention.launches += 1
    return (out.reshape(b, h, s_q, HEAD_DIM)[..., :d],
            lse.reshape(b, h, s_q))


def _delta(out, dout, dlse=None) -> torch.Tensor:
    """B6's delta, (B, H, Sq) f32: rowsum(dO*O), less ``dlse`` when the
    LSE output has a gradient."""
    delta = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float().reshape(delta.shape)
    return delta


def backward_buffers(q, k, v, out, lse, dout, causal: bool,
                     kv_valid: Optional[int] = None,
                     dlse=None) -> SimpleNamespace:
    """The B6 kernel's inputs (head width padded to 128, delta =
    rowsum(dO*O) - dlse in f32, outside the kernel as in JAX; the lse and
    delta rows zero padded to a multiple of ``BWD_Q_TILE``) and the dk/dv
    outputs, allocated; :func:`launch_backward` runs the kernel and sets
    ``dq``."""
    _check((q, k, v, out, dout), "flash backward")
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    delta = _delta(out, dout, dlse).reshape(b * h, s_q)
    lse = lse.float().reshape(b * h, s_q)
    pad = -s_q % BWD_Q_TILE
    lse, delta = F.pad(lse, (0, pad)), F.pad(delta, (0, pad))
    kp = _rows(k)
    qp = _rows(q)
    return SimpleNamespace(
        shape=(b, h, s_q, s_kv, d), causal=bool(causal),
        kv_valid=s_kv if kv_valid is None else int(kv_valid),
        q=qp, k=kp, v=_rows(v), dout=_rows(dout), lse=lse.contiguous(),
        delta=delta.contiguous(), dq=None, dk=torch.empty_like(kp),
        dv=torch.empty_like(kp))


def launch_backward(buf: SimpleNamespace) -> None:
    """Run B6, one kernel, on ``buf``. bf16: ``dq_accum`` zeroed, the
    kernel (dq into ``dq_accum``, dk, dv), then ``dq`` =
    bf16(dq_accum/sqrt(D)); the two tensor ops run in a profiler range
    named ``DQ_ACCUM_SPAN``. f32: ``dq`` zeroed, then the kernel, which
    adds dq/sqrt(D) into it and writes dk, dv."""
    b, h, s_q, s_kv, d = buf.shape
    scale = 1.0 / math.sqrt(d)
    lib = _lib()
    common = (buf.q.data_ptr(), buf.k.data_ptr(), buf.v.data_ptr(),
              buf.dout.data_ptr(), buf.lse.data_ptr(), buf.delta.data_ptr())
    if buf.q.dtype == torch.bfloat16:
        with torch.profiler.record_function(DQ_ACCUM_SPAN):
            buf.dq_accum = acc = torch.zeros(
                (b * h, s_q, HEAD_DIM), dtype=torch.float32,
                device=buf.q.device)
        fn = lib.flash_bwd_bf16
    else:
        buf.dq = acc = torch.zeros_like(buf.q)
        fn = lib.flash_bwd_f32
    rc = fn(*common, acc.data_ptr(), buf.dk.data_ptr(), buf.dv.data_ptr(),
            b * h, s_q, s_kv, buf.kv_valid, int(buf.causal), scale,
            _stream(buf.q))
    if rc != 0:
        raise RuntimeError(f"flash backward kernel launch failed: CUDA "
                           f"error {rc}")
    by_shape = flash_attention.bwd_launches_by_shape
    key = (s_q, s_kv, buf.kv_valid)
    by_shape[key] = by_shape.get(key, 0) + 1
    if buf.q.dtype == torch.bfloat16:
        flash_attention.bwd_launches += 1
        with torch.profiler.record_function(DQ_ACCUM_SPAN):
            buf.dq = acc.mul_(scale).to(buf.q.dtype)
    else:
        flash_attention.bwd_f32_launches += 1


def _kernel_backward(q, k, v, out, lse, dout, causal: bool,
                     kv_valid: Optional[int], dlse=None):
    buf = backward_buffers(q, k, v, out, lse, dout, causal, kv_valid, dlse)
    launch_backward(buf)
    b, h, s_q, s_kv, d = buf.shape

    def unpad(x, s):
        return x.reshape(b, h, s, HEAD_DIM)[..., :d]

    return unpad(buf.dq, s_q), unpad(buf.dk, s_kv), unpad(buf.dv, s_kv)


def _forward(q, k, v, causal, kv_valid=None):
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, kv_valid)
    return _kernel_forward(q, k, v, causal, kv_valid)


def _backward(q, k, v, out, lse, dout, causal, kv_valid=None, dlse=None):
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, dout, causal,
                                        kv_valid, dlse)
    return _kernel_backward(q, k, v, out, lse, dout, causal, kv_valid, dlse)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """The JAX ``_flash_attention_diff`` custom VJP: the forward saves
    (q, k, v, out, lse) (:461-463) and the backward runs B6."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(),
                               ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """(B, H, Sq, D) x (B, H, Skv, D) -> (B, H, Sq, D), D <= 128, any
    lengths. Differentiable: the backward runs B6 from the stored LSE."""
    return _FlashAttention.apply(q, k, v, causal)


class _FlashAttentionLse(torch.autograd.Function):
    """The partial-softmax form with both outputs differentiable: a
    gradient on the LSE adds p*dlse to ds, so the backward is B6 with
    delta = rowsum(dO*O) - dlse and the block's ``kv_valid``."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid):
        out, lse = _forward(q, k, v, False, kv_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_valid = kv_valid
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout.contiguous(), False,
                               ctx.kv_valid, dlse)
        return dq, dk, dv, None


def flash_attention_lse(q, k, v, kv_valid: Optional[int] = None):
    """Flash forward returning (out (B, H, Sq, D), lse (B, H, Sq, 1) f32):
    the partial-softmax form (:270-284) that the ring merges.
    Differentiable in both outputs: the backward runs B6 with the LSE's
    gradient folded into delta (the JAX function is not)."""
    out, lse = _FlashAttentionLse.apply(q, k, v, kv_valid)
    return out, lse[..., None]


def attention(q, k, v, causal: bool = False, mask=None,
              force_reference: bool = False) -> torch.Tensor:
    """Dispatch (:592-620): a ``mask`` takes the dense masked path; inside
    :func:`sp_attention` the ring, inside :func:`tp_attention` the rank's
    heads; a CPU tensor, :func:`dense_attention` or ``force_reference`` the
    dense reference; a CUDA tensor the flash kernels (B5 forward, B6
    backward). ``force_reference`` is kept for the JAX signature: it does
    for one call what :func:`dense_attention` does for a block of code."""
    if mask is not None:
        scale = 1.0 / math.sqrt(q.shape[-1])
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        logits = logits.masked_fill(~mask, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.matmul(probs.float(), v.float()).to(q.dtype)
    if sp_context() is not None:
        out = _sp_sharded(q, k, v, causal)
        if out is not None:
            return out
    if tp_context() is not None:
        out = _tp_sharded(q, k, v, causal)
        if out is not None:
            return out
    if force_reference or forced_dense() or q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal)


# ---------------------------------------------------------------------------
# tensor- and sequence-parallel contexts (JAX :521-590). Under a mesh each
# process holds its own share: a tensor-parallel bundle's blocks hold their
# rank's heads (``parallel.sharding.shard_params``), so attention is local
# and B5 runs on the rank's H/n heads; a sequence-parallel call rings the
# K/V blocks over the axis (``ops.ring_attention``). Inside either context
# the fused MMDiT wrappers decline (as the JAX ``_fused_ok`` does) and the
# unfused composition calls :func:`attention`.
# ---------------------------------------------------------------------------

_TP_CONTEXT = threading.local()
_SP_CONTEXT = threading.local()


@contextlib.contextmanager
def tp_attention(mesh, axis: str = "model"):
    """Within this context, attention is tensor-parallel over ``axis`` of
    ``mesh``: each rank computes its own heads (the model's row-sharded
    layers sum the ranks' partial products over ``axis``)."""
    prev = getattr(_TP_CONTEXT, "value", None)
    _TP_CONTEXT.value = (mesh, axis)
    try:
        yield
    finally:
        _TP_CONTEXT.value = prev


@contextlib.contextmanager
def sp_attention(mesh, axis: str = "data"):
    """Within this context, :func:`attention` runs sequence-sharded over
    ``axis`` through the ring (``ops.ring_attention``), the >= 2048 px fill
    regime (~31k joint tokens at the 2800 px cap). Composes with
    :func:`tp_attention`: each rank's heads are its own already, and the
    ring runs over them."""
    prev = getattr(_SP_CONTEXT, "value", None)
    _SP_CONTEXT.value = (mesh, axis)
    try:
        yield
    finally:
        _SP_CONTEXT.value = prev


def saved_contexts():
    """The calling thread's attention contexts (:func:`tp_attention`,
    :func:`sp_attention`, :func:`dense_attention`), which are
    thread-local: a checkpointed block is recomputed in the backward,
    which on the card runs on autograd's device thread, so the block
    re-enters them (:func:`entered`)."""
    return tp_context(), sp_context(), forced_dense()


@contextlib.contextmanager
def entered(contexts):
    """Re-enter contexts that :func:`saved_contexts` returned."""
    tp, sp, dense = contexts
    with contextlib.ExitStack() as stack:
        if tp is not None:
            stack.enter_context(tp_attention(*tp))
        if sp is not None:
            stack.enter_context(sp_attention(*sp))
        if dense:
            stack.enter_context(dense_attention())
        yield


def tp_context():
    """(mesh, axis) of the enclosing :func:`tp_attention`, or None."""
    return getattr(_TP_CONTEXT, "value", None)


def sp_context():
    """(mesh, axis) of the enclosing :func:`sp_attention`, or None."""
    return getattr(_SP_CONTEXT, "value", None)


def _sp_sharded(q, k, v, causal: bool):
    """The ring over the SP axis (JAX :556-569); None where it does not
    apply (causal, or an axis of one rank)."""
    if causal:
        return None        # the ring's fold is non-causal (MMDiT is not)
    mesh, axis = sp_context()
    if mesh.shape[axis] <= 1:
        return None
    from .ring_attention import ring_attention_padded
    return ring_attention_padded(q, k, v, mesh, axis=axis)


def _tp_sharded(q, k, v, causal: bool):
    """Attention over this rank's heads (JAX :572-590). The JAX package
    splits the heads here with ``shard_map``; in the port the rank's
    tensors hold only its heads already (or all of them, where the heads
    do not divide over the axis and ``shard_params`` kept the attention
    whole: the JAX fallback of :576-577), so this is the local call: B5 on
    the card, the dense reference on the CPU. None on an axis of one
    rank."""
    mesh, axis = tp_context()
    if mesh.shape[axis] <= 1:
        return None
    if forced_dense() or q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal)
    return flash_attention(q, k, v, causal=causal)


flash_attention.launches = 0
flash_attention.bwd_launches = 0
flash_attention.bwd_f32_launches = 0
flash_attention.bwd_launches_by_shape = {}  # (Sq, Skv, kv_valid) -> launches

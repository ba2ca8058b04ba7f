#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (domainrag_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``--parent DIR``, a checkout of the parent commit, builds the parent's
fused MMDiT kernels (B1-B3), generic flash kernels (B5, B6 in bf16 and
f32) and fused top-k (B8) from its ``csrc/`` and times each beside this
commit's on the same inputs, in turns: parent, change, change, parent;
and the f32 train step with the parent's f32 B6 in its place.)

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. build every CUDA kernel of the stage-2, stage-3, stage-4, int8 serving
   and trainer paths from ``csrc/`` (one ``nvcc`` per source, started
   together) and print the compiler's register report; for each instance
   of the shared bf16 forward (``csrc/flash_fwd.cuh``: B1-B3 and B5) its
   registers and spills, and the count of HGMMA and HMMA instructions in
   its SASS (``cuobjdump -sass``): it fails unless every instance holds
   HGMMA and no HMMA (``mma.sync``);
3. each one-pass kernel at its full-width main-path shape (B = 1, 24
   heads x 128, 1241 text + 4096 image tokens, single-block rows 21504
   wide) against its plain PyTorch version, then both fused regimes at
   the padded row space's edges (``EDGES``: text streams of 64, 127, 128
   and 129 rows, batch 1 and 2), with the main-path shape's time, the plain
   version's, one PyTorch library call's (SDPA on pre-normed q/k/v, a
   yardstick only) and the least time the card could take
   (``bound_ms``);
4. the same for the multi-pass kernel (joint lengths above 17408) at the
   fill's lengths: 1241 + 16384 = 17625 tokens (2048 px) and 1241 +
   30625 = 31866 (the 2800 px cap), both variants at B = 1, and the
   single variant at B = 4 x 31866, whose element offsets pass 2^31
   (compared on its last batch element), each against the multi-pass
   plain version;
5. the generic flash kernels (B5 forward; B6 backward: one kernel in
   each dtype, the f32 one in 3xTF32) against their plain versions: a small
   causal + ``kv_valid`` case with ragged lengths in bf16 and f32, four
   ragged bf16 backward cases (RAGGED_BWD), the trainer's attention shape
   (2, 24, 4608, 128) in bf16 and f32 with each kernel's time beside the
   plain version's, SDPA's (forward, and its autograd backward for the B6
   rows) and the bound (B6: the least work, 10*B*H*S^2*D FLOP, at the bf16
   peak, and in f32 three TF32 products per f32 product at the TF32
   peak), and
   B5 above the multi-pass ceiling at (1, 24, 50393, 128) bf16, compared
   on two heads; they run right after the MMDiT kernels, so that a fault
   in B5 or B6 fails the run within a few minutes;
6. the int8 kernels against their plain versions: the W8A8 GEMM (B4)
   with torch.equal at every (M, K, N) of the stage-3 and stage-4 int8
   paths and at ragged shapes, each path shape timed beside the plain
   version, torch._int_mm with the same epilogue and the bf16 matmul of
   the same linear; the int8 attention (B7), int8 QK and int8 QK + P.V,
   one pass (joint, single) at 5337 tokens and multi-pass at 17625 and
   31866, each instance under its own bar (I8_BARS), timed beside SDPA,
   with its two prep kernels' (stats, quant) share of one traced call;
7. B8, the fused GEMM + top-k, against its plain version: torch.equal on
   integer-valued banks with a third of the rows duplicated (exact sums,
   exact ties) at the stage-2 shape (200 queries x 178287 x 512, k 1,
   100, 500 and 1000) and at ragged ones (7 x 333 x 64, 3 x 513 x 32, d
   50 with k 256 and 300, k > N), and on an ascending and an all-equal
   bank (every tile merges every buffer; every score ties) at k 100 and
   1000, one launch each; on a random unit-norm bank at the stage-2 shape
   within 1e-5 (indices equal except at near ties); timed at k 100, 500
   and 1000 beside the plain version and torch.topk(q @ bank.T), at k 1000
   with the merge pass's share of one traced call, and at k 1 beside the
   matmul alone (the GEMM's share);
8. stage 2 at full width: a random CLIP ViT-B/32 and ResNet-50 stem
   (87.86 M f32 params) on the card, 512 synthetic corpus JPEGs through
   ``load_or_compute_source_features``, the bank filled with random unit
   rows to COCO train2017 + miniImageNet size (178287 x 512 f32, 365 MB),
   and ``run_retrieval`` on a synthetic DIOR 10-shot directory (200
   queries, 20 classes) with the default config (top-100, re-rank 100,
   grids on): every artifact and JSON schema checked, no B8 launch on the
   default route, then ``first_stage_topk(use_pallas=True)`` on the same
   query features: one B8 launch, agreeing with the default route;
   encode rates, first-stage ms by both routes, re-rank seconds per query
   and seconds per dataset-shot; which renderer drew the grids; then the
   same dataset-shot once more under torch.profiler for the device's busy
   time and idle share (``OUT/profile_retrieval.txt``);
9. the stage-3 slice on a small input: a head_dim-128 toy bundle
   generates on the card (kernels) and on the CPU (plain versions) from
   the same weights and noise, and the images must agree;
10. the stage-4 fill on a small input: a head_dim-128 toy Fill bundle with
   the one-pass ceiling lowered (so the toy runs the multi-pass kernel)
   and the VAE tiled, on the card and on the CPU, from the same weights
   and noise;
11. the small int8 slices: both toy bundles quantized (every block
   linear), generate and the tiled multi-pass fill under W8A8 + int8 QK +
   int8 P.V, card against CPU, launch counts asserted;
12. the stage-3 slice at full width: a random FLUX.1-dev bundle (MMDiT,
   T5-XXL, CLIP-L, SigLIP so400m, Redux, VAE; ~46 GB) drawn on the card,
   and ``GenerateStage.generate_sample`` on a synthetic sample at
   1024x1024, cut to 4 denoise steps (stage default 50) and 2 ranks
   (default 5), denoised one rank at a time. It checks the written PNGs,
   that the image was finite before quantisation, and that every
   one-pass kernel ran 19 or 38 times per step per rank chunk (the
   multi-pass one never);
13. one full-width denoise step (batch 1, 1024 px) under
    ``torch.profiler``, its device time grouped into the attention
    kernels, the GEMMs and the rest (full table in ``profile.txt`` under
    ``OUT``, the script's output directory);
14. stage 3 under the CLI's ``--w8a8 --int8_qk``: the same bundle's MMDiT
    quantized (quantize_tree, 11.9 GB), the same sample; B4 314 and the
    one-pass B7 19 / 38 launches per step per rank chunk, the bf16 fused
    kernels never; seconds per step and the mean uint8 difference to the
    bf16 images (a report); then one traced step with int8 P.V added
    (``OUT/profile_int8.txt``);
15. stage 4 at full width: the stage-3 bundle is freed and a random
   FLUX.1-Fill-dev bundle drawn (384 input channels), and
   ``compose.process_dataset`` runs a synthetic UODD 1-shot dataset (one
   1024x1024 sample, two bboxes) whose two backgrounds are phase 12's
   PNGs. UODD's parameters lift it to 2048x2048 (17625 tokens, the
   multi-pass regime), strength 0.4, guidance 30, the VAE tiled (9 tiles
   per encode and decode). Cuts: 10 steps (stage default 50, so 4 denoise
   steps instead of 20), 2 backgrounds (default 5), ``max_rank_batch``
   1. It checks every artifact, finiteness, and that the multi-pass
   kernel ran 19 or 38 times per step per background and the one-pass
   one never;
16. one full-width fill denoise step (batch 1, 2048 px, 384 channels)
    under ``torch.profiler`` (full table in ``OUT/profile_fill.txt``);
17. stage 4 under ``--w8a8 --int8_qk``: the Fill MMDiT quantized, the
    same dataset through ``compose.process_dataset``; B4 314 and the
    multi-pass B7 19 / 38 per step per background, B3 never; then one
    traced fill step with int8 P.V (``OUT/profile_fill_int8.txt``);
18. the Fill bundle is freed; the serving path above the multi-pass
    ceiling: both attention
    wrappers at 1241 + 49152 = 50393 joint tokens (a 4096x3072 image),
    where they take the unfused composition and so B5; launches counted
    on this run alone (B5 2, the fused kernels 0), heads 0-1 of each
    output against the plain B5 forward;
19. a small trainer card vs CPU: a head_dim-128 toy MMDiT (hidden 256,
    one double and one single block) at 128 px, three ``train_step``s
    from the same weights, batches, t and eps, with bf16 and with f32
    batches, losses, first-step gradients and updates within stated
    limits, launch counts asserted;
20. the trainer at FLUX.1-dev width cut in depth to 2 double + 4 single
    blocks (default 19 + 38; 1.31 B f32 params drawn on the card):
    ``train.loop.fit`` with remat for 4 steps on synthetic bf16 batches
    (batch 2, 1024 px = 4096 image tokens, 512 T5 tokens), one checkpoint
    written at the end under ``OUT`` and restored (then deleted); finite
    losses, changed params and the launch counts per step (B1 4, B2 8,
    B5 6, B6 6, B3 0), seconds per step, peak memory, checkpoint time;
21. one traced full-width train step (``OUT/profile_train.txt``), grouped
    into the fused forward, B5, B6 (with its dq_accum zeroing, scale and
    cast), GEMMs, the optimizer and the rest;
22. one full-width ``fit`` step on f32 batches (the dtype
    ``latent_batches_from_images`` yields): no fused kernel, B5 12 and B6
    6 launches, finite loss, changed params; the f32 kernel rows take
    these counts; with ``--parent``, four steady f32 steps timed in
    turns, the parent's f32 B6 in two;

Then a ``{"kernels": [...]}`` line and, last, the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
STEPS = 4                 # cut: the stage default is 50
RANKS = 2                 # cut: the stage default is 5 retrieval ranks
MAX_RANK_BATCH = 1        # ranks denoised one at a time
SIZE = 1024               # the stage default resolution
FILL_STEPS = 10           # cut: the compose default is 50
FILL_SIZE = 2048          # UODD's upscale of the 1024 px sample
S_TXT = 512 + 729         # T5 tokens + Redux image tokens
HEADS, HD = 24, 128
# Kernel vs plain version, bf16: every element within ATOL + RTOL*|plain|
# and the whole output within REL_NORM in relative Frobenius norm. At the
# main-path shape the outputs are ~0.025 RMS and the kernels' error is
# ~1e-3 at most (bf16 output rounding plus P rounded against a running
# max); a kernel that drops the ragged last K/V tile, uses exp for exp2 or
# misses the q prescale by 2% fails the norm check.
ATOL, RTOL, REL_NORM = 4e-3, 2e-2, 1e-2
PEAK_BF16 = 989e12        # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
PEAK_F32 = 67e12          # H100 SXM f32 FMA FLOP/s (no tensor cores)
PEAK_TF32 = 495e12        # H100 SXM dense TF32 FLOP/s (tensor cores)
PEAK_INT8 = 1979e12       # H100 SXM dense int8 OP/s
SOURCES = ("mmdit_attention", "flash_attention", "int8_gemm",
           "int8_attention", "topk")
PARENT = None             # --parent DIR: a checkout of the parent commit


def _ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _weight_bytes(bundle) -> int:
    return sum(_bytes(getattr(bundle, f.name))
               for f in dataclasses.fields(bundle)
               if f.name.endswith("_params"))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_build():
    """One nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from domainrag_tpu_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = list(pool.map(_build.build, SOURCES))
    print(f"build: {', '.join(p.name for p in paths)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for path in paths:
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if any(w in line for w in ("registers", "spill", "entry",
                                           "Performance Loss")):
                    print(f"  ptxas: {line.strip()[:160]}")
    for path in paths:
        if path.name.startswith(("libmmdit_attention", "libflash_attention")):
            _forward_report(path)


FORWARD = "fwd_kernel"    # the shared bf16 forward's instances (flash_fwd.cuh)


def _forward_report(lib):
    """Each instance of the shared forward in ``lib``: its registers and
    spills (the ptxas log) and its HGMMA / HMMA counts (the SASS). Raises
    unless every instance runs on wgmma (HGMMA) and none on mma.sync
    (HMMA)."""
    ptxas, name = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and FORWARD in name:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill"
                              r" loads", line)
            if regs:
                ptxas.setdefault(name, {})["registers"] = int(regs.group(1))
            if spill:
                ptxas.setdefault(name, {})["spills"] = (int(spill.group(1)),
                                                        int(spill.group(2)))
    from domainrag_tpu_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).resolve().parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = [0, 0]
        elif name:
            counts[name][0] += "HGMMA" in line
            counts[name][1] += bool(re.search(r"\bHMMA\b", line))
    found = [n for n in counts if FORWARD in n]
    if not found:
        raise AssertionError(f"{lib.name}: no instance of the shared forward")
    for n in found:
        info = ptxas.get(n, {})
        hgmma, hmma = counts[n]
        print(f"forward {n}: {info.get('registers')} registers, spill "
              f"stores/loads {info.get('spills')} bytes; SASS HGMMA {hgmma},"
              f" HMMA {hmma}")
        if hgmma == 0 or hmma:
            raise AssertionError(f"{n}: expected wgmma (HGMMA) and no "
                                 f"mma.sync (HMMA)")


def _fused_fwd(kernel: str) -> bool:
    """A profiled kernel of the fused bf16 MMDiT attention (B1-B3): the
    shared forward's Fused instances or their prep."""
    return ("fwd_kernel" in kernel and "Fused<" in kernel) \
        or "norm_rope_kernel" in kernel


def _rope_tables(dev, grid=SIZE // 16):
    import torch
    from domainrag_tpu_torch.models.flux import model as fm
    ids = np.concatenate([fm.make_text_ids(S_TXT),
                          fm.make_image_ids(grid, grid)])
    return fm.rope_cos_sin(torch.as_tensor(ids, device=dev),
                           fm.FLUX_DEV.axes_dim, fm.FLUX_DEV.theta)


def _bound(batch, s_tot):
    """The least time for one attention call: two S x S x 128 products per
    head at the bf16 peak, or the bytes (q/k/v lanes read once, the output
    written once, the f32 RoPE tables read once) at the memory rate."""
    hd = HEADS * HD
    ops = 4.0 * batch * HEADS * s_tot * s_tot * HD / PEAK_BF16 * 1e3
    nbytes = (batch * 4 * s_tot * hd * 2 + 2 * s_tot * (HD // 2) * 4) \
        / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops, nbytes),
            "bound_by": "operations" if ops >= nbytes else "bytes"}


def _check(name, got, want, bar=(ATOL, RTOL, REL_NORM)):
    """Kernel vs plain: raises unless within ``bar`` (atol, rtol, relative
    norm); returns the max abs error."""
    atol, rtol, rel_bar = bar
    err = (got.float() - want.float()).abs()
    max_abs = err.max().item()
    rel = max_abs / max(want.float().abs().max().item(), 1e-30)
    rel_norm = (err.norm() / want.float().norm()).item()
    ok = (bool((err <= atol + rtol * want.float().abs()).all())
          and rel_norm < rel_bar)
    print(f"kernel {name}: max_abs_err {max_abs:.3e} rel {rel:.3e} "
          f"rel_norm {rel_norm:.3e} (tol {atol} + {rtol}*|ref|, norm "
          f"{rel_bar})")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"(max_abs_err {max_abs:.3e}, rel_norm "
                             f"{rel_norm:.3e})")
    return max_abs


def _cat(x):
    import torch
    return torch.cat(tuple(x), 1) if isinstance(x, (tuple, list)) else x


def _row(name, replaces, kernel, plain, prenormed, bound, reps,
         compare=None, bar=(ATOL, RTOL, REL_NORM), source="mmdit_attention"):
    """One kernel's line: held against its plain version within ``bar``
    (on ``compare``'s pair when given, else on the whole outputs), then
    timed beside the plain version and SDPA on the pre-normed q/k/v
    (B, H, S, D); with ``--parent`` the same call on the parent commit's
    bf16 kernel timed in turns with this one (not for the int8 kernels,
    ``source`` "int8_attention", whose loader the swap does not reach).
    ``reps``: (kernel, plain, plain warm-up, SDPA) repetitions."""
    import torch
    import torch.nn.functional as F
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    got, want = compare() if compare else (_cat(kernel()), _cat(plain()))
    torch.cuda.synchronize()
    max_abs = _check(name, got, want, bar)
    del got, want
    row = {"name": name, "route": "cuda",
           "source": f"domainrag_tpu_torch/csrc/{source}.cu",
           "replaces": f"domainrag_tpu/{replaces}",
           "launches": 0, "max_abs_err": max_abs,
           "ms": _ms(kernel, reps[0]),
           "plain_ms": _ms(plain, reps[1], reps[2]), **bound}
    q, k, v = prenormed()
    row["library_ms"] = _ms(lambda: F.scaled_dot_product_attention(q, k, v),
                            reps[3])
    del q, k, v
    if PARENT and source == "mmdit_attention":
        parent = _parent_call(mma, source, kernel)
        _in_turns(name, parent, kernel, reps[0],
                  [_rel_norm(_cat(parent()), _cat(kernel()))])
    print(f"kernel {name}: ms {row['ms']:.3f} plain_ms "
          f"{row['plain_ms']:.3f} library_ms {row['library_ms']:.3f} "
          f"bound_ms {row['bound_ms']:.3f} ({row['bound_by']})")
    return row


def _dense(fn):
    """``fn`` run inside ``dense_attention()``: the unfused composition as
    the plain version of the one-pass kernels (its attention dense, not
    the generic flash kernel)."""
    from domainrag_tpu_torch.ops import attention as attn

    def run():
        with attn.dense_attention():
            return fn()
    return run


def phase_kernels(dev):
    """Each kernel vs its plain version at the main-path shape."""
    import torch
    import torch.nn.functional as F
    from domainrag_tpu_torch.ops import mmdit_attention as mma

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cos, sin = _rope_tables(dev)
    s_img = (SIZE // 16) ** 2
    s_tot = S_TXT + s_img

    def norm():
        return {"q": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)},
                "k": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)}}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    hd = HEADS * HD
    txt, img = randn(1, S_TXT, 3 * hd), randn(1, s_img, 3 * hd)
    proj = randn(1, s_tot, 7 * hd)
    tn, inorm, sn = norm(), norm(), norm()
    w = lambda n: (n["q"]["scale"], n["k"]["scale"])     # noqa: E731
    cases = [
        ("mmdit_joint_attention", "ops/mmdit_attention.py:400",
         lambda: mma.mmdit_double_attention(
             txt, img, tn, inorm, cos, sin, HEADS, HD),
         _dense(lambda: mma.reference_double(
             txt, img, *w(tn), *w(inorm), cos, sin, HEADS, HD)),
         lambda: mma.prenormed_double(txt, img, *w(tn), *w(inorm), cos, sin,
                                      HEADS, HD)),
        ("mmdit_seq_attention", "ops/mmdit_attention.py:328",
         lambda: mma.mmdit_single_attention(proj, sn, cos, sin, HEADS, HD),
         _dense(lambda: mma.reference_single(proj, *w(sn), cos, sin, HEADS,
                                             HD)),
         lambda: mma.prenormed_single(proj, *w(sn), cos, sin, HEADS, HD)),
    ]
    bound = _bound(1, s_tot)
    rows = {case[0]: _row(*case, bound, (20, 5, 2, 20)) for case in cases}
    del txt, img, proj
    _edge_checks(dev, randn, norm)
    return rows


# (batch, text rows, image rows) at the padded row space's edges: the text
# stream under, at and over a 128-row tile boundary
EDGES = ((2, 64, 192), (1, 127, 200), (2, 128, 128), (1, 129, 77))


def _edge_checks(dev, randn, norm):
    """The fused bf16 kernels (B1-B3) at EDGES, one pass and multi-pass
    (the one-pass ceiling lowered), double and single block (a ragged
    tail), against the plain versions: the gap and tail keys are a large
    share of these keys, so a kernel that counts them fails the bar, where
    at the main path's 1241 + 4096 tokens the 39 gap keys move the output
    by less than it."""
    import torch
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    w = lambda n: (n["q"]["scale"], n["k"]["scale"])     # noqa: E731
    onepass = mma._MAX_ONEPASS
    try:
        for mp in (False, True):
            mma._MAX_ONEPASS = 64 if mp else onepass
            for batch, s_txt, s_img in EDGES:
                s_tot = s_txt + s_img
                txt, img = randn(batch, s_txt, 3 * HEADS * HD), \
                    randn(batch, s_img, 3 * HEADS * HD)
                proj = randn(batch, s_tot, 7 * HEADS * HD)
                ang = randn(s_tot, HD // 2).float() * 3.0
                cos, sin = torch.cos(ang), torch.sin(ang)
                tn, inorm, sn = norm(), norm(), norm()
                got = (torch.cat(mma.mmdit_double_attention(
                    txt, img, tn, inorm, cos, sin, HEADS, HD), 1),
                    mma.mmdit_single_attention(proj, sn, cos, sin, HEADS, HD))
                if mp:
                    want = (torch.cat(mma.reference_mp_double(
                        txt, img, *w(tn), *w(inorm), cos, sin, HEADS, HD), 1),
                        mma.reference_mp_single(proj, *w(sn), cos, sin, HEADS,
                                                HD))
                else:
                    with attn.dense_attention():
                        want = (torch.cat(mma.reference_double(
                            txt, img, *w(tn), *w(inorm), cos, sin, HEADS,
                            HD), 1), mma.reference_single(
                                proj, *w(sn), cos, sin, HEADS, HD))
                regime = "mp" if mp else "one-pass"
                _check(f"mmdit {regime} double {batch}x({s_txt}+{s_img})",
                       got[0], want[0])
                _check(f"mmdit {regime} single {batch}x{s_tot}", got[1],
                       want[1])
    finally:
        mma._MAX_ONEPASS = onepass


def phase_mp_kernels(dev):
    """The multi-pass kernel at the fill's joint lengths (B3), against the
    multi-pass plain version: 2048 px and the 2800 px cap, both variants,
    and the single variant at B = 4 x 31866 (its last batch element lies
    past 2^31 elements into the GEMM output; compared there)."""
    import torch
    from domainrag_tpu_torch.ops import mmdit_attention as mma

    g = torch.Generator(device=dev)
    g.manual_seed(1)
    hd = HEADS * HD

    def norm():
        return {"q": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)},
                "k": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)}}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    def heads(x):
        b, s, _ = x.shape
        return x.reshape(b, s, HEADS, HD).transpose(1, 2)

    w = lambda n: (n["q"]["scale"], n["k"]["scale"])     # noqa: E731
    replaces = "ops/mmdit_attention.py:533"
    rows = {}
    for grid, batch in ((FILL_SIZE // 16, 1), (2800 // 16, 1),
                        (2800 // 16, 4)):
        s_img = grid * grid
        s_tot = S_TXT + s_img
        if s_tot <= mma._MAX_ONEPASS:
            raise AssertionError(f"{s_tot} tokens stay in the one-pass "
                                 "regime")
        cos, sin = _rope_tables(dev, grid)
        suffix = f"_s{s_tot}_b{batch}"
        if batch == 1:
            txt, img = randn(1, S_TXT, 3 * hd), randn(1, s_img, 3 * hd)
            tn, inorm = norm(), norm()
            name = "mmdit_mp_joint_attention" + suffix

            def prenormed_double():
                def prep(part, which):
                    lanes = slice(part * hd, (part + 1) * hd)
                    return heads(torch.cat([
                        mma.prep_norm_rope(txt[..., lanes],
                                           tn[which]["scale"],
                                           cos[:S_TXT], sin[:S_TXT]),
                        mma.prep_norm_rope(img[..., lanes],
                                           inorm[which]["scale"],
                                           cos[S_TXT:], sin[S_TXT:])], 1))
                return prep(0, "q"), prep(1, "k"), heads(torch.cat(
                    [txt[..., 2 * hd:], img[..., 2 * hd:]], 1))

            rows[name] = _row(
                name, replaces,
                lambda: mma.mmdit_double_attention(
                    txt, img, tn, inorm, cos, sin, HEADS, HD),
                lambda: mma.reference_mp_double(
                    txt, img, *w(tn), *w(inorm), cos, sin, HEADS, HD),
                prenormed_double, _bound(1, s_tot), (10, 2, 1, 10))
            del txt, img
        proj, sn = randn(batch, s_tot, 7 * hd), norm()
        name = "mmdit_mp_seq_attention" + suffix

        def prenormed_single():
            return (heads(mma.prep_norm_rope(proj[..., :hd], sn["q"]["scale"],
                                             cos, sin)),
                    heads(mma.prep_norm_rope(proj[..., hd:2 * hd],
                                             sn["k"]["scale"], cos, sin)),
                    heads(proj[..., 2 * hd:3 * hd]))

        def last_element():
            got = mma.mmdit_single_attention(proj, sn, cos, sin, HEADS, HD)
            return got[-1:], mma.reference_mp_single(
                proj[-1:], *w(sn), cos, sin, HEADS, HD)

        rows[name] = _row(
            name, replaces,
            lambda: mma.mmdit_single_attention(proj, sn, cos, sin, HEADS, HD),
            lambda: mma.reference_mp_single(proj, *w(sn), cos, sin, HEADS,
                                            HD),
            prenormed_single, _bound(batch, s_tot),
            (10, 1 if batch > 1 else 2, 1, 10),
            compare=last_element if batch > 1 else None)
        del proj
        torch.cuda.empty_cache()
    return rows


def _small_bundle(dev, fill=False):
    """A toy bundle whose MMDiT has head_dim 128 (the kernels' width)."""
    import torch
    from domainrag_tpu_torch.models.flux import pipeline as fp
    cfgs = fp.tiny_configs(fill)
    cfgs["flux_cfg"] = dataclasses.replace(
        cfgs["flux_cfg"], hidden=256, heads=2, head_dim=128, depth_double=2,
        depth_single=2, axes_dim=(16, 56, 56))
    return fp._random_bundle(cfgs, 7, torch.device("cpu"), torch.bfloat16,
                             torch.bfloat16, **fp.tiny_tokenizers(cfgs))


def _to_card(cpu, dev):
    return dataclasses.replace(
        cpu, device=dev,
        **{f.name: _tree(lambda t: t.to(dev), getattr(cpu, f.name))
           for f in dataclasses.fields(cpu) if f.name.endswith("_params")})


def phase_small_slice(dev):
    """Small input: the same bundle and noise through the kernels on the
    card and through the plain versions on the CPU."""
    import torch
    from domainrag_tpu_torch.models.flux import pipeline as fp
    cpu = _small_bundle(dev)
    card = _to_card(cpu, dev)
    uniq = np.random.default_rng(1).uniform(
        -1, 1, (3, 28, 28, 3)).astype(np.float32)
    pairs = np.asarray([[0, 2], [1, 2]])
    size, steps = 64, 3
    seq = (size // cpu.latent_factor) ** 2
    noise = torch.randn((2, seq, cpu.vae_cfg.latent_channels * 4),
                        generator=torch.Generator().manual_seed(3))
    images = []
    for bundle in (card, cpu):
        e, p = fp.redux_prior_pairs_indexed(bundle, uniq, pairs, "",
                                            [0.8, 1.0], [1.0, 1.0])
        with torch.inference_mode():
            images.append(fp._generate_float(bundle, e, p, size, size, steps,
                                             2.5, noise).float().cpu())
    diff = (images[0] - images[1]).abs()
    print(f"small slice ({size} px, {steps} steps, head_dim 128): card vs "
          f"CPU image max abs diff {diff.max().item():.3e} mean "
          f"{diff.mean().item():.3e}")
    if not (bool(torch.isfinite(images[0]).all())
            and diff.mean().item() < 7e-3 and diff.max().item() < 5e-2):
        raise AssertionError("small slice: card and CPU images disagree")


def phase_small_fill(dev):
    """Small fill: a toy Fill bundle (head_dim 128, bf16) on the card and
    on the CPU from the same weights, image, mask and noise, with the
    one-pass ceiling lowered so that its 288 tokens run the multi-pass
    kernel and the VAE tiled (16 tiles of 12 latent cells, ragged at the
    edge). Same limits as the stage-3 small slice."""
    import torch
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.models.flux import scheduler as sched
    cpu = _small_bundle(dev, fill=True)
    card = _to_card(cpu, dev)
    rng = np.random.default_rng(2)
    size, steps, strength = 64, 4, 0.75
    image = fp.from_uint8(rng.integers(0, 255, (1, size, size, 3), np.uint8))
    mask = np.ones((1, size, size), np.float32)
    mask[:, 16:40, 8:30] = 0.0                 # keep region
    px = rng.uniform(-1, 1, (1, 1, 28, 28, 3)).astype(np.float32)
    seq = (size // cpu.latent_factor) ** 2
    noise = torch.randn((1, seq, cpu.vae_cfg.latent_channels * 4),
                        generator=torch.Generator().manual_seed(4))
    sigmas = torch.as_tensor(sched.make_schedule(
        steps, image_seq_len=seq, strength=strength).sigmas)
    gate = mma._MAX_ONEPASS
    mma._MAX_ONEPASS = 64
    try:
        before = mma.mmdit_double_attention.mp_launches
        images = []
        for bundle in (card, cpu):
            e, p = fp.redux_prior_pairs(bundle, px, "", [1.0], [1.0])
            dt, d = bundle.compute_dtype, bundle.device
            with torch.inference_mode():
                images.append(fp._fill_float(
                    bundle, torch.as_tensor(image, device=d).to(dt),
                    torch.as_tensor(mask, device=d).to(dt),
                    noise.to(device=d, dtype=dt), e, p, sigmas.to(d), 30.0,
                    hires=True, vae_tile=12, vae_overlap=4
                ).float().cpu())
        mp = mma.mmdit_double_attention.mp_launches - before
    finally:
        mma._MAX_ONEPASS = gate
    diff = (images[0] - images[1]).abs()
    print(f"small fill ({size} px, {steps} steps x strength {strength}, "
          f"head_dim 128, multi-pass kernel {mp} double launches, tiled "
          f"VAE): card vs CPU image max abs diff {diff.max().item():.3e} "
          f"mean {diff.mean().item():.3e}")
    if mp == 0:
        raise AssertionError("small fill: the multi-pass kernel never ran")
    if not (bool(torch.isfinite(images[0]).all())
            and diff.mean().item() < 7e-3 and diff.max().item() < 5e-2):
        raise AssertionError("small fill: card and CPU images disagree")


def phase_slice(dev, rows):
    import torch
    from PIL import Image
    from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                                 GenerateConfig, ReduxConfig)
    from domainrag_tpu_torch.models.flux import pipeline as fp

    print(f"slice cuts: {STEPS} denoise steps (stage default 50), {RANKS} "
          f"ranks (stage default 5), max_rank_batch {MAX_RANK_BATCH}, "
          f"{SIZE}x{SIZE}")
    t0 = time.perf_counter()
    bundle = fp.full_bundle(seed=0)
    torch.cuda.synchronize()
    print(f"full-width bundle: {_weight_bytes(bundle) / 1e9:.2f} GB of "
          f"weights drawn on the card in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    inputs = OUT / "inputs"
    inputs.mkdir(parents=True, exist_ok=True)

    def picture(path, h, w):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 // w, yy * 255 // h,
                         (xx + yy) * 255 // (h + w)], -1)
        noise = rng.integers(-40, 40, (h, w, 3))
        Image.fromarray(np.clip(base + noise, 0, 255).astype(np.uint8)
                        ).save(path)
        return str(path)

    target = picture(inputs / "target.png", 768, 1024)
    refs = [{"image_path": picture(inputs / f"ref{i}.jpg", 640, 480),
             "rank": i + 1, "similarity": 0.9 - 0.1 * i,
             "source_dataset": "synthetic"} for i in range(RANKS)]
    cfg = GenerateConfig(
        sampling=FluxSamplingConfig(num_steps=STEPS, height=SIZE,
                                    width=SIZE, seed=0),
        redux=ReduxConfig(), top_ranks=RANKS, max_rank_batch=MAX_RANK_BATCH)
    sample = (target, refs, cfg)
    paths, step = _run_slice(bundle, sample, rows, "sample0", int8=False)
    return bundle, sample, paths, step


def _run_slice(bundle, sample, rows, out_name, int8):
    """``GenerateStage.generate_sample`` on the synthetic sample, with the
    launch counts of the path read just after (bf16: B1/B2; int8: B4 and
    the one-pass B7). Returns the PNG paths and seconds per step."""
    import torch
    from PIL import Image
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.stages.generate import GenerateStage

    target, refs, cfg = sample
    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mma)
    fp.generate.nonfinite_images = 0
    timer = StepTimer(sync=torch.cuda.synchronize)
    paths = GenerateStage(bundle, cfg).generate_sample(
        "sample0", target, refs, str(OUT / out_name), timer=timer)
    torch.cuda.synchronize()
    chunks = math.ceil(RANKS / MAX_RANK_BATCH)
    if int8:
        _read_i8_counts(mma, rows, "one-pass", bundle.flux_cfg,
                        STEPS * chunks, S_TXT, (SIZE // 16) ** 2)
    else:
        _read_counts(mma, rows, "one-pass", bundle.flux_cfg, STEPS * chunks)

    if len(paths) != RANKS:
        raise AssertionError(f"{len(paths)} images for {RANKS} ranks")
    for p in paths:
        arr = np.asarray(Image.open(p))
        if arr.dtype != np.uint8 or arr.shape != (SIZE, SIZE, 3):
            raise AssertionError(f"{p}: {arr.dtype} {arr.shape}")
    if fp.generate.nonfinite_images:
        raise AssertionError(f"{fp.generate.nonfinite_images} decoded "
                             "images not finite before quantisation")
    mean = {k: timer.totals[k] / timer.counts[k] for k in timer.totals}
    print(f"slice{' (int8)' if int8 else ''}: {len(paths)} PNGs uint8 "
          f"{SIZE}x{SIZE}x3, finite before quantisation; prior "
          f"{mean['prior']:.3f} s, {mean['step']:.3f} s per denoise step "
          f"(mean of {timer.counts['step']}, batch {MAX_RANK_BATCH}), decode "
          f"{mean['decode']:.3f} s per image, stage spans "
          f"{ {k: round(v, 3) for k, v in timer.totals.items()} }, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return paths, mean["step"]


def _reset_counts(mma):
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.ops import int8_gemm
    for wrapper in (mma.mmdit_double_attention, mma.mmdit_single_attention):
        wrapper.launches = wrapper.mp_launches = 0
        wrapper.i8_launches = wrapper.i8_mp_launches = 0
    f = attn.flash_attention
    f.launches = f.bwd_launches = f.bwd_f32_launches = 0
    int8_gemm.w8a8_linear.launches = 0
    int8_gemm.w8a8_linear.launches_by_shape = {}


def _i8_counts(mma):
    """(B4, one-pass B7 double/single, multi-pass B7 double/single)."""
    from domainrag_tpu_torch.ops import int8_gemm
    d, s = mma.mmdit_double_attention, mma.mmdit_single_attention
    return (int8_gemm.w8a8_linear.launches, d.i8_launches, s.i8_launches,
            d.i8_mp_launches, s.i8_mp_launches)


def _flash_counts():
    """(B5, B6 bf16, B6 f32) launches."""
    from domainrag_tpu_torch.ops import attention as attn
    f = attn.flash_attention
    return f.launches, f.bwd_launches, f.bwd_f32_launches


def _flash_launches(rows, tag, counts):
    """Writes a trainer run's B5 and B6 counts (``_flash_counts``) into the
    rows at the trainer's attention shape in ``tag``'s dtype, and no other
    row: one B6 kernel in each dtype."""
    kinds = {"fwd": counts[0], "bwd": counts[1 if tag == "bf16" else 2]}
    for kind, n in kinds.items():
        rows[f"flash_{kind}_{tag}_b{TRAIN_B}_s{S_TRAIN}"]["launches"] = n


def _read_counts(mma, rows, regime, depth, passes):
    """The launch counts of a path's run: the regime's kernel ran once per
    block per pass (19 double and 38 single blocks), the other regime's
    never. Writes them into the regime's rows."""
    d, s = mma.mmdit_double_attention, mma.mmdit_single_attention
    counts = {"one-pass": (d.launches, s.launches),
              "multi-pass": (d.mp_launches, s.mp_launches)}
    want = (depth.depth_double * passes, depth.depth_single * passes)
    other = "multi-pass" if regime == "one-pass" else "one-pass"
    print(f"launches on the path: {regime} double/single {counts[regime]} "
          f"(expected {want}), {other} {counts[other]} (expected (0, 0)), "
          f"generic flash B5/B6/B6 f32 {_flash_counts()} (expected "
          f"(0, 0, 0)),"
          f" int8 B4/B7 {_i8_counts(mma)} (expected all 0)")
    if counts[regime] != want or counts[other] != (0, 0) \
            or any(_flash_counts()) or any(_i8_counts(mma)):
        raise AssertionError("kernel launch counts differ from the path")
    prefix = "mmdit_mp_" if regime == "multi-pass" else "mmdit_"
    for name, row in rows.items():
        if name.startswith(prefix + "joint"):
            row["launches"] = counts[regime][0]
        elif name.startswith(prefix + "seq"):
            row["launches"] = counts[regime][1]


def phase_profile(bundle, size, out_name):
    """One full-width denoise step (batch 1, ``size`` px, random latents
    and conditioning at the bundle's input width) under torch.profiler:
    device time per kernel, grouped, beside the wall time of the same
    step untraced. Under the int8 modes (a quantized bundle) the B4 and B7
    kernels get groups of their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from domainrag_tpu_torch.models.flux import model as fm

    dev, cfg, dt = bundle.device, bundle.flux_cfg, bundle.compute_dtype
    grid = size // 16
    g = torch.Generator(device=dev)
    g.manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    x, embeds = randn(1, grid * grid, cfg.in_channels), randn(
        1, S_TXT, cfg.text_dim)
    pooled = randn(1, cfg.pooled_dim)
    img_ids = torch.as_tensor(fm.make_image_ids(grid, grid), device=dev)
    txt_ids = torch.as_tensor(fm.make_text_ids(S_TXT), device=dev)
    sigma = torch.full((1,), 0.5, device=dev)
    guid = torch.full((1,), 2.5, device=dev)

    def step():
        return fm.apply(bundle.flux_params, x, embeds, pooled, sigma,
                        img_ids, txt_ids, cfg, guidance=guid)

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    total = sum(ms for ms, _, _ in kernels)
    if not total:
        print("profile: the profiler recorded no device time (not measured)")
        return
    groups = {"B4 W8A8 GEMM (csrc)": 0.0, "B7 int8 attention (csrc)": 0.0,
              "attention (csrc)": 0.0, "GEMM (cuBLAS)": 0.0, "other": 0.0}
    for ms, _, name in kernels:
        if "w8a8_kernel" in name:
            groups["B4 W8A8 GEMM (csrc)"] += ms
        elif re.search(r"(attn|stats|quant)_kernel<", name):
            groups["B7 int8 attention (csrc)"] += ms
        elif _fused_fwd(name):
            groups["attention (csrc)"] += ms
        elif re.search(r"gemm|nvjet|cutlass|xmma|cublas", name, re.I):
            groups["GEMM (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    b7_prep = sum(ms for ms, _, name in kernels
                  if re.search(r"(stats|quant)_kernel<", name))
    if groups["B7 int8 attention (csrc)"]:
        print(f"profile: B7 prep (stats + quant) {b7_prep:.3f} ms of "
              f"{groups['B7 int8 attention (csrc)']:.3f} ms B7")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / out_name).write_text("".join(
        f"{ms:10.3f} ms {n:6d}x  {name}\n" for ms, n, name in kernels))
    print(f"profile: one denoise step ({size} px, {grid * grid + S_TXT} "
          f"tokens, {cfg.in_channels} input channels), device time "
          f"{total:.3f} ms "
          f"(untraced wall {wall_ms:.3f} ms), {sum(n for _, n, _ in kernels)}"
          f" device events; "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in groups.items()))
    for ms, n, name in kernels[:8]:
        print(f"  {ms:9.3f} ms {n:5d}x  {name[:100]}")


def phase_compose(dev, rows, backgrounds):
    """Stage 4 at full width through ``compose.process_dataset`` on a
    synthetic UODD 1-shot sample whose backgrounds are ``backgrounds``
    (the stage-3 PNGs), as the pipeline chains the stages."""
    import shutil
    import torch
    from PIL import Image
    from domainrag_tpu_torch.core.coco import write_coco
    from domainrag_tpu_torch.core.config import ComposeConfig
    from domainrag_tpu_torch.models.flux import pipeline as fp

    dataset, shot, sample = "UODD", 1, "uodd_0"
    cfg = ComposeConfig(num_steps=FILL_STEPS, max_rank_batch=MAX_RANK_BATCH)
    params = cfg.dataset_params[dataset]
    n_steps = int(FILL_STEPS * params.strength)
    print(f"compose cuts: {FILL_STEPS} steps (stage default 50; x strength "
          f"{params.strength} = {n_steps} denoise steps instead of "
          f"{int(50 * params.strength)}), {len(backgrounds)} backgrounds "
          f"(stage default 5), max_rank_batch {MAX_RANK_BATCH}; {dataset}: "
          f"{SIZE}x{SIZE} source lifted to {FILL_SIZE}x{FILL_SIZE}, guidance "
          f"{params.guidance_scale}, tiled VAE")
    t0 = time.perf_counter()
    bundle = fp.full_bundle(seed=1, fill=True)
    torch.cuda.synchronize()
    print(f"full-width Fill bundle ({bundle.flux_cfg.in_channels} input "
          f"channels): {_weight_bytes(bundle) / 1e9:.2f} GB of weights "
          f"drawn on the card in {time.perf_counter() - t0:.1f} s")

    root = OUT / "compose"
    shutil.rmtree(root, ignore_errors=True)
    ds = root / "datasets" / dataset
    (ds / "train").mkdir(parents=True)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    source = np.stack([xx * 255 // SIZE, yy * 255 // SIZE,
                       (xx + yy) * 255 // (2 * SIZE)], -1)
    source = np.clip(source + rng.integers(-30, 30, source.shape), 0, 255)
    Image.fromarray(source.astype(np.uint8)).save(
        ds / "train" / f"{sample}.jpg")
    write_coco(str(ds / "annotations" / f"{shot}_shot.json"),
               images=[{"id": 1, "file_name": f"{sample}.jpg",
                        "width": SIZE, "height": SIZE}],
               annotations=[{"id": 1, "image_id": 1, "category_id": 1,
                             "bbox": [200, 300, 180, 140]},
                            {"id": 2, "image_id": 1, "category_id": 2,
                             "bbox": [620, 540, 96, 120]}],
               categories=[{"id": 1, "name": "scallop"},
                           {"id": 2, "name": "seaurchin"}])
    paths, step = _run_compose(bundle, root, backgrounds, rows, "output",
                               int8=False)
    return bundle, root, paths, step


def _run_compose(bundle, root, backgrounds, rows, out_name, int8):
    """``compose.process_dataset`` over the synthetic UODD sample under
    ``root`` into ``root / out_name``, with the launch counts of the path
    read just after (bf16: B3; int8: B4 and the multi-pass B7). Returns
    the hires PNG paths and seconds per step."""
    import shutil
    import torch
    from PIL import Image
    from domainrag_tpu_torch.core.config import ComposeConfig
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.core.manifest import Manifest
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.stages import compose

    dataset, shot, sample = "UODD", 1, "uodd_0"
    cfg = ComposeConfig(num_steps=FILL_STEPS, max_rank_batch=MAX_RANK_BATCH)
    n_steps = int(FILL_STEPS * cfg.dataset_params[dataset].strength)
    output = root / out_name
    bg_dir = (output / "result" / f"{dataset}_{shot}shot_retrieval"
              / "results_0" / sample)
    bg_dir.mkdir(parents=True)
    for path in backgrounds:
        shutil.copy(path, bg_dir / Path(path).name)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts(mma)
    fp.fill_batch.nonfinite_images = 0
    timer = StepTimer(sync=torch.cuda.synchronize)
    result = compose.process_dataset(
        compose.ComposeStage(bundle, cfg, seed=0), dataset, shot,
        str(root / "datasets"), str(output), timer=timer)
    torch.cuda.synchronize()
    op = output / "outpaint_hires" / "process_0" / dataset / f"{shot}_shot"
    entry = Manifest(str(op / "manifest.json")).entry(sample)
    if entry.get("status") != "done":
        raise AssertionError(f"compose failed on {sample}: {entry}")
    passes = n_steps * math.ceil(len(backgrounds) / MAX_RANK_BATCH)
    if int8:
        _read_i8_counts(mma, rows, "multi-pass", bundle.flux_cfg, passes,
                        S_TXT, (FILL_SIZE // 16) ** 2)
    else:
        _read_counts(mma, rows, "multi-pass", bundle.flux_cfg, passes)

    (record,) = result["samples"]
    outs = record["outpainted_images"]
    if len(outs) != len(backgrounds):
        raise AssertionError(f"{len(outs)} results for {len(backgrounds)} "
                             "backgrounds")
    for out in outs:
        for key, shape in (("outpainted_image_path", (FILL_SIZE, FILL_SIZE)),
                           ("final_result_path", (SIZE, SIZE)),
                           ("mask_path", (FILL_SIZE, FILL_SIZE))):
            arr = np.asarray(Image.open(out[key]))
            if arr.dtype != np.uint8 or arr.shape[:2] != shape:
                raise AssertionError(f"{out[key]}: {arr.dtype} {arr.shape}")
        if not Path(out["params_path"]).exists():
            raise AssertionError(f"missing {out['params_path']}")
    finals = sorted((output / "final_results" / "process_0" / f"{shot}_shot"
                     / dataset).glob("*_final_result*.png"))
    if not (op / f"outpaint_results_{shot}shot.json").exists() \
            or len(finals) != len(backgrounds):
        raise AssertionError("compose result JSON or final collection "
                             "missing")
    if fp.fill_batch.nonfinite_images:
        raise AssertionError(f"{fp.fill_batch.nonfinite_images} filled "
                             "images not finite before quantisation")
    mean = {k: timer.totals[k] / timer.counts[k] for k in timer.totals}
    print(f"compose{' (int8)' if int8 else ''}: {len(outs)} backgrounds -> "
          f"hires PNGs uint8 "
          f"{FILL_SIZE}x{FILL_SIZE}x3, finals {SIZE}x{SIZE}, masks, params "
          f"JSON, result JSON, {len(finals)} collected finals; finite before "
          f"quantisation; prior {mean['prior']:.3f} s per sample, encode "
          f"{mean['encode']:.3f} s per tiled encode ({timer.counts['encode']}"
          f"), {mean['step']:.3f} s per denoise step (mean of "
          f"{timer.counts['step']}, batch {MAX_RANK_BATCH}, "
          f"{FILL_SIZE // 16 * (FILL_SIZE // 16) + S_TXT} tokens), decode "
          f"{mean['decode']:.3f} s per tiled decode, save {mean['save']:.3f} "
          f"s per background, spans "
          f"{ {k: round(v, 3) for k, v in timer.totals.items()} }, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return [out["outpainted_image_path"] for out in outs], mean["step"]


# ---------------------------------------------------------------------------
# the int8 serving modes: W8A8 GEMM (B4) and int8 attention (B7)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _int8_modes(w8a8=True, qk=True, pv=False):
    """The CLI's int8 serving flags for a block (``--w8a8 --int8_qk``, and
    int8 P.V), reset when it ends."""
    from domainrag_tpu_torch.models import common
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    common.set_int8_activations(w8a8)
    mma.set_int8_qk(qk)
    mma.set_int8_pv(pv)
    try:
        yield
    finally:
        common.set_int8_activations(False)
        mma.set_int8_qk(False)
        mma.set_int8_pv(False)


def _w8a8_path_shapes(cfg, s_txt, s_img):
    """(M, K, N) -> launches per forward of every quantized linear of one
    MMDiT forward at batch 1 (quantize_tree's default min_size quantizes
    them all at full width): 10 per double block, 3 per single block, 10
    outside the blocks."""
    h, mh, s = cfg.hidden, cfg.mlp_hidden, s_txt + s_img
    per = {}

    def add(shape, n=1):
        per[shape] = per.get(shape, 0) + n

    add((s_img, cfg.in_channels, h))
    add((s_txt, cfg.text_dim, h))
    for _ in range(2 if cfg.guidance_embed else 1):
        add((1, cfg.time_embed_dim, h))
        add((1, h, h))
    add((1, cfg.pooled_dim, h))
    add((1, h, h))
    add((1, h, 2 * h))
    add((s_img, h, cfg.out_channels))
    d = cfg.depth_double
    for m in (s_txt, s_img):
        add((1, h, 6 * h), d)
        add((m, h, 3 * h), d)
        add((m, h, h), d)
        add((m, h, mh), d)
        add((m, mh, h), d)
    add((1, h, 3 * h), cfg.depth_single)
    add((s, h, 3 * h + mh), cfg.depth_single)
    add((s, h + mh, h), cfg.depth_single)
    return per


def _read_i8_counts(mma, rows, regime, cfg, passes, s_txt, s_img):
    """The launch counts of an int8 path's run: B4 once per quantized
    linear per pass, at each (M, K, N) as the model has it; the regime's B7
    once per block per pass; the bf16 fused kernels and B5/B6 never. Adds
    the B4 counts to the rows of their shapes (a shape both stages have
    gets both runs' counts) and writes the B7 counts."""
    from domainrag_tpu_torch.ops import int8_gemm
    d, s = mma.mmdit_double_attention, mma.mmdit_single_attention
    want_shapes = {k: v * passes
                   for k, v in _w8a8_path_shapes(cfg, s_txt, s_img).items()}
    got_shapes = dict(int8_gemm.w8a8_linear.launches_by_shape)
    b7 = {"one-pass": (d.i8_launches, s.i8_launches),
          "multi-pass": (d.i8_mp_launches, s.i8_mp_launches)}
    other = "multi-pass" if regime == "one-pass" else "one-pass"
    want = (cfg.depth_double * passes, cfg.depth_single * passes)
    bf16 = (d.launches, s.launches, d.mp_launches, s.mp_launches)
    print(f"launches on the path (int8): B4 {int8_gemm.w8a8_linear.launches} "
          f"(expected {sum(want_shapes.values())} = "
          f"{sum(want_shapes.values()) // passes} x {passes} passes, at "
          f"{len(want_shapes)} shapes), B7 {regime} double/single "
          f"{b7[regime]} (expected {want}), B7 {other} {b7[other]}, bf16 "
          f"B1/B2/B3 {bf16}, B5/B6 {_flash_counts()} (expected 0)")
    if got_shapes != want_shapes or b7[regime] != want \
            or b7[other] != (0, 0) or any(bf16) or any(_flash_counts()):
        raise AssertionError(f"int8 launch counts differ from the path: "
                             f"{sorted(got_shapes.items())}")
    for shape, n in got_shapes.items():      # stage 3's run, then 4's
        name = _gemm_name(shape)
        if name in rows:
            rows[name]["launches"] += n
    kind = "" if regime == "one-pass" else "mp_"
    tag = "" if regime == "one-pass" else f"_s{s_txt + s_img}"
    for part, n in zip(("joint", "seq"), b7[regime]):
        row = rows.get(f"mmdit_{kind}i8_{part}_attention_qk{tag}")
        if row is not None:
            row["launches"] = n


def _gemm_name(shape):
    m, k, n = shape
    return f"w8a8_gemm_m{m}_k{k}_n{n}"


def _check_w8a8_wrapper(ig, x, wq, ws, b):
    """B4's wrapper ``w8a8_linear`` on the card (activation quant, leading
    dims flattened, the kernel) against the plain version fed the CPU's
    quantization of the same x: torch.equal, and exactly one launch
    counted, at the flattened (M, K, N)."""
    import torch
    k, n = wq.shape
    m = x.numel() // k
    before = ig.w8a8_linear.launches
    before_shape = ig.w8a8_linear.launches_by_shape.get((m, k, n), 0)
    got = ig.w8a8_linear(x, wq, ws, b)
    xq, xs = ig.quantize_rowwise(x.cpu().reshape(m, k))
    want = ig.w8a8_reference(xq.to(x.device), wq, xs.to(x.device), ws, b,
                             x.dtype).reshape(*x.shape[:-1], n)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"w8a8_linear differs from its plain version "
                             f"at x {tuple(x.shape)} (K, N) {(k, n)} "
                             f"{x.dtype}")
    if ig.w8a8_linear.launches != before + 1 or \
            ig.w8a8_linear.launches_by_shape.get((m, k, n)) != \
            before_shape + 1:
        raise AssertionError(f"w8a8_linear did not count one launch at "
                             f"{(m, k, n)}")


def phase_int8_gemm(dev):
    """B4 through its wrapper ``w8a8_linear`` against its plain version with
    torch.equal at every (M, K, N) of the stage-3 (1024 px) and stage-4
    (2048 px, 384 input channels) paths, bf16 out with bias, and at ragged
    shapes (M 640 / 17 / 1, K not a multiple of the 64-deep tile, N 64 and
    70, f32 out, no bias, a batched (2, 320, K) input); each path shape's
    kernel timed beside the plain version, torch._int_mm with the same
    epilogue (a yardstick: M > 16 only) and the bf16 torch.matmul of the
    same linear, with its bound."""
    import torch
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import int8_gemm as ig

    g = torch.Generator(device=dev)
    g.manual_seed(17)
    ragged = [((640,), 3072, 3072, torch.bfloat16, True),
              ((17,), 1000, 64, torch.float32, False),
              ((1,), 384, 3072, torch.float32, True),
              ((33,), 100, 70, torch.bfloat16, True),
              ((2, 320), 128, 3072, torch.bfloat16, True)]
    for lead, k, n, dt, bias in ragged:
        x = torch.randn((*lead, k), generator=g, device=dev).to(dt)
        wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(n, generator=g, device=dev) / (127 * math.sqrt(k))
        b = torch.randn(n, generator=g, device=dev) if bias else None
        _check_w8a8_wrapper(ig, x, wq, ws, b)
    print(f"kernel w8a8_gemm: w8a8_linear torch.equal to its plain version "
          f"at ragged shapes {[(*r[0], r[1], r[2]) for r in ragged]}")
    rows = {}
    shapes = set(_w8a8_path_shapes(fm.FLUX_DEV, S_TXT, (SIZE // 16) ** 2))
    shapes |= set(_w8a8_path_shapes(fm.FLUX_FILL_DEV, S_TXT,
                                    (FILL_SIZE // 16) ** 2))
    for i, (m, k, n) in enumerate(sorted(shapes)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(n, generator=g, device=dev) / (127 * math.sqrt(k))
        b = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
        _check_w8a8_wrapper(ig, x, wq, ws, b)
        xq, xs = ig.quantize_rowwise(x)
        name = _gemm_name((m, k, n))
        ops = 2.0 * m * k * n / PEAK_INT8 * 1e3
        nbytes = (m * k + k * n + 4 * (m + n) + 2 * n + 2 * m * n) \
            / PEAK_BYTES * 1e3
        big = m * k * n > 2e10
        row = {"name": name, "route": "cuda",
               "source": "domainrag_tpu_torch/csrc/int8_gemm.cu",
               "replaces": "domainrag_tpu/ops/int8_gemm.py:117",
               "launches": 0, "max_abs_err": 0.0,
               "ms": _ms(lambda: ig._launch(xq, wq, xs, ws, b,
                                            torch.bfloat16), 10),
               "plain_ms": _ms(lambda: ig.w8a8_reference(
                   xq, wq, xs, ws, b, torch.bfloat16),
                   1 if big else 3, 1),
               "bound_ms": max(ops, nbytes),
               "bound_by": "operations" if ops >= nbytes else "bytes"}
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            row["library_ms"] = _ms(lambda: (
                torch._int_mm(xq, wq).float() * xs * ws).to(
                    torch.bfloat16) + b, 10)
        else:
            row["library_ms"] = None
        wb = (wq.float() * ws).to(torch.bfloat16)
        bf16_ms = _ms(lambda: torch.matmul(x, wb) + b, 10)
        del wb
        rows[name] = row
        lib = "n/a" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f}"
        gate = "Pallas" if ig.w8a8_eligible(m, k, n) else "XLA"
        print(f"kernel {name}: torch.equal to plain; ms {row['ms']:.4f} "
              f"plain_ms {row['plain_ms']:.3f} library_ms (_int_mm) "
              f"{lib} bf16 matmul {bf16_ms:.4f} bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']}); the JAX gate "
              f"sends this shape to {gate}")
        if i % 8 == 7:
            torch.cuda.empty_cache()
    return rows


def _i8_bound(batch, s_tot, pv):
    """The least time of one int8 attention call: the QK^T product at the
    int8 peak, P.V at the int8 (``pv``) or bf16 peak, or the bytes (q/k/v
    lanes read once, the output written once, the f32 RoPE tables read
    once) at the memory rate."""
    hd = HEADS * HD
    half = 2.0 * batch * HEADS * s_tot * s_tot * HD
    ops = (half / PEAK_INT8 + half / (PEAK_INT8 if pv else PEAK_BF16)) * 1e3
    nbytes = (batch * 4 * s_tot * hd * 2 + 2 * s_tot * (HD // 2) * 4) \
        / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops, nbytes),
            "bound_by": "operations" if ops >= nbytes else "bytes"}


# B7 against its plain versions, per instance: (atol, rtol, relative norm).
# Read on the H100 at these shapes: the QK-only instance (bf16 P from
# ex2.approx) 1.35e-3 to 2.39e-3 in norm, at most 9.8e-4 per element; the
# int8 P.V instance (P on the plain version's integer grid) 0 in one pass
# and at most 2.4e-5 in norm (2.4e-4 per element) in multi-pass. Each bar
# is ~2x (QK) or ~20x (P.V) the largest reading; the bf16 kernels' bar
# (4e-3 + 2e-2|ref|, 1e-2) let a B7 whose ragged key tiles went unmasked
# (5.0e-3 in norm at 5337 tokens, QK) through at these shapes.
I8_BARS = {"qk": (2e-3, 1e-2, 4e-3), "pv": (1e-3, 1e-2, 5e-4)}


def _b7_prep_share(name, kernel):
    """B7's two prep kernels (stats, quant) against all of its device time
    in one call of ``kernel``, from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel()
        torch.cuda.synchronize()
    prep = b7 = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if re.search(r"(stats|quant)_kernel<", e.key):
            prep += us / 1e3
        if re.search(r"(attn|stats|quant)_kernel<", e.key):
            b7 += us / 1e3
    if not b7:
        print(f"kernel {name}: prep share not measured (no device time)")
        return
    print(f"kernel {name}: prep (stats + quant) {prep:.4f} of {b7:.4f} "
          f"device ms in one traced call, {100 * prep / b7:.1f}%")


def phase_int8_attention(dev):
    """B7 against its plain versions, int8 QK and int8 QK + P.V: one pass,
    joint and single, at 1 x 5337 tokens; multi-pass, joint and single, at
    1 x 17625 and 1 x 31866 tokens, each instance within its bar in
    I8_BARS; SDPA in bf16 on the pre-normed q/k/v is the yardstick. Every
    case is checked before the phase fails on those that disagree."""
    import torch
    from domainrag_tpu_torch.ops import mmdit_attention as mma

    g = torch.Generator(device=dev)
    g.manual_seed(19)
    hd = HEADS * HD

    def norm():
        return {"q": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)},
                "k": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)}}

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    w = lambda n: (n["q"]["scale"], n["k"]["scale"])     # noqa: E731
    rows, failed = {}, []
    for grid in (SIZE // 16, FILL_SIZE // 16, 2800 // 16):
        s_img = grid * grid
        s_tot = S_TXT + s_img
        mp = s_tot > mma._MAX_ONEPASS
        cos, sin = _rope_tables(dev, grid)
        txt, img = randn(1, S_TXT, 3 * hd), randn(1, s_img, 3 * hd)
        proj = randn(1, s_tot, 7 * hd)
        tn, inorm, sn = norm(), norm(), norm()
        kind = "mp_" if mp else ""
        tag = f"_s{s_tot}" if mp else ""
        line = "ops/mmdit_attention.py:" + ("638" if mp else "416")
        plain_d = mma.reference_mp_i8_double if mp else mma.reference_i8_double
        plain_s = mma.reference_mp_i8_single if mp else mma.reference_i8_single
        for pv in (False, True):
            var = "pv" if pv else "qk"
            cases = [
                (f"mmdit_{kind}i8_joint_attention_{var}{tag}", line,
                 lambda: mma.mmdit_double_attention(
                     txt, img, tn, inorm, cos, sin, HEADS, HD),
                 lambda: plain_d(txt, img, *w(tn), *w(inorm), cos, sin,
                                 HEADS, HD, pv=pv),
                 lambda: mma.prenormed_double(txt, img, *w(tn), *w(inorm),
                                              cos, sin, HEADS, HD)),
                (f"mmdit_{kind}i8_seq_attention_{var}{tag}",
                 "ops/mmdit_attention.py:" + ("638" if mp else "339"),
                 lambda: mma.mmdit_single_attention(proj, sn, cos, sin,
                                                    HEADS, HD),
                 lambda: plain_s(proj, *w(sn), cos, sin, HEADS, HD, pv=pv),
                 lambda: mma.prenormed_single(proj, *w(sn), cos, sin, HEADS,
                                              HD))]
            with _int8_modes(w8a8=False, qk=True, pv=pv):
                for case in cases:
                    try:
                        row = _row(*case, _i8_bound(1, s_tot, pv),
                                   (10, 1 if mp else 3, 1, 10),
                                   bar=I8_BARS[var], source="int8_attention")
                    except AssertionError as err:     # raised below
                        failed.append(str(err))
                        continue
                    rows[case[0]] = row
                    _b7_prep_share(case[0], case[2])
        del txt, img, proj
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return rows


def _quantized(bundle, min_size=1 << 16):
    """The bundle with its MMDiT quantized (quantize_tree) and the bf16
    tree dropped."""
    import torch
    from domainrag_tpu_torch.models import quant
    bundle.flux_params = quant.quantize_tree(bundle.flux_params, min_size)
    gc.collect()
    torch.cuda.empty_cache()
    return bundle


def _n_quantized(tree):
    if isinstance(tree, dict):
        return ("w_q" in tree) + sum(_n_quantized(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_quantized(v) for v in tree)
    return 0


def phase_small_int8(dev):
    """Small int8 slices, card against CPU: the head_dim-128 toy bf16
    bundles quantized with min_size 1024 (every block linear), under W8A8
    + int8 QK + int8 P.V, run ``generate`` and the tiled fill (the one-pass
    ceiling lowered, so the fill takes the multi-pass int8 kernel) from the
    same weights and noise on the card and on the CPU; the uint8 images
    agree within SMALL_I8_MAX levels and SMALL_I8_MEAN on average. B4 runs
    once per quantized linear per forward, B7 once per block per forward,
    B1-B3 never."""
    import torch
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.models.flux import scheduler as sched
    from domainrag_tpu_torch.ops import mmdit_attention as mma

    for fill in (False, True):
        cpu = _quantized(_small_bundle(dev, fill), min_size=1024)
        card = _to_card(cpu, dev)
        n_q = _n_quantized(cpu.flux_params)
        cfg = cpu.flux_cfg
        rng = np.random.default_rng(5 + fill)
        size = 64
        seq = (size // cpu.latent_factor) ** 2
        images = []
        gate = mma._MAX_ONEPASS
        if fill:
            steps, strength = 4, 0.75
            image = fp.from_uint8(rng.integers(0, 255, (1, size, size, 3),
                                               np.uint8))
            mask = np.ones((1, size, size), np.float32)
            mask[:, 16:40, 8:30] = 0.0
            px = rng.uniform(-1, 1, (1, 1, 28, 28, 3)).astype(np.float32)
            noise = torch.randn((1, seq, cpu.vae_cfg.latent_channels * 4),
                                generator=torch.Generator().manual_seed(6))
            sigmas = torch.as_tensor(sched.make_schedule(
                steps, image_seq_len=seq, strength=strength).sigmas)
            forwards = len(sigmas) - 1
            mma._MAX_ONEPASS = 64
        else:
            steps = forwards = 3
            uniq = rng.uniform(-1, 1, (3, 28, 28, 3)).astype(np.float32)
            noise = torch.randn((2, seq, cpu.vae_cfg.latent_channels * 4),
                                generator=torch.Generator().manual_seed(7))
        try:
            with _int8_modes(w8a8=True, qk=True, pv=True):
                for bundle in (card, cpu):
                    _reset_counts(mma)
                    d, dt = bundle.device, bundle.compute_dtype
                    with torch.inference_mode():
                        if fill:
                            e, p = fp.redux_prior_pairs(bundle, px, "", [1.0],
                                                        [1.0])
                            out = fp._fill_float(
                                bundle, torch.as_tensor(image, device=d).to(dt),
                                torch.as_tensor(mask, device=d).to(dt),
                                noise.to(device=d, dtype=dt), e, p,
                                sigmas.to(d), 30.0, hires=True, vae_tile=12,
                                vae_overlap=4)
                        else:
                            e, p = fp.redux_prior_pairs_indexed(
                                bundle, uniq, np.asarray([[0, 2], [1, 2]]),
                                "", [0.8, 1.0], [1.0, 1.0])
                            out = fp._generate_float(bundle, e, p, size, size,
                                                     steps, 2.5, noise)
                    images.append(fp.to_uint8(out.float().cpu().numpy()))
                    if bundle is card:
                        counts = _i8_counts(mma)
        finally:
            mma._MAX_ONEPASS = gate
        b7 = (counts[3], counts[4]) if fill else (counts[1], counts[2])
        want = (n_q * forwards, cfg.depth_double * forwards,
                cfg.depth_single * forwards)
        diff = np.abs(images[0].astype(int) - images[1].astype(int))
        what = "fill (multi-pass)" if fill else "generate (one pass)"
        print(f"small int8 {what} ({size} px, {forwards} forwards, head_dim "
              f"128, {n_q} quantized linears, W8A8 + int8 QK + P.V): card vs "
              f"CPU uint8 max diff {diff.max()} mean {diff.mean():.4f}; "
              f"launches B4 {counts[0]}, B7 double/single {b7} (expected "
              f"{want})")
        if (counts[0], *b7) != want:
            raise AssertionError(f"small int8 {what}: launch counts differ")
        if diff.max() > SMALL_I8_MAX or diff.mean() > SMALL_I8_MEAN:
            raise AssertionError(f"small int8 {what}: card and CPU disagree")


# card vs CPU limits of the small int8 slices, in uint8 levels: B4 is
# bitwise equal to its plain version, but the bf16 streams around it differ
# in the last bit (cuBLAS vs CPU summation order, the B7 kernels' rounding),
# and W8A8 turns an activation on a rounding edge of x / x_s into a whole
# quantisation step.
SMALL_I8_MAX, SMALL_I8_MEAN = 24, 1.5


def _uint8_diff(a_paths, b_paths):
    from PIL import Image
    return float(np.mean([np.abs(np.asarray(Image.open(a), np.int32)
                                 - np.asarray(Image.open(b), np.int32)).mean()
                          for a, b in zip(a_paths, b_paths)]))


def phase_slice_int8(bundle, sample, rows, bf16_paths, bf16_step):
    """Stage 3 at full width under the CLI's ``--w8a8 --int8_qk``: the
    phase-11 bundle's MMDiT quantized (quantize_tree, the bf16 tree
    dropped), then the same sample through ``generate_sample``."""
    import shutil
    import torch
    from domainrag_tpu_torch.models import quant
    t0 = time.perf_counter()
    _quantized(bundle)
    torch.cuda.synchronize()
    print(f"stage 3 int8: MMDiT quantized in {time.perf_counter() - t0:.1f} s"
          f" ({_n_quantized(bundle.flux_params)} linears): "
          f"{quant.quantized_bytes(bundle.flux_params) / 1e9:.2f} GB, bundle "
          f"{_weight_bytes(bundle) / 1e9:.2f} GB on the card")
    with _int8_modes(w8a8=True, qk=True, pv=False):
        paths, step = _run_slice(bundle, sample, rows, "sample0_int8",
                                 int8=True)
    print(f"stage 3 int8: {step:.3f} s per denoise step (bf16 {bf16_step:.3f}"
          f" s); mean abs uint8 difference to the bf16 images of the same "
          f"seed {_uint8_diff(paths, bf16_paths):.3f} (a report: random "
          f"weights)")
    shutil.rmtree(OUT / "sample0_int8")     # checked; keeps OUT small


def phase_compose_int8(bundle, root, backgrounds, rows, bf16_paths,
                       bf16_step):
    """Stage 4 at full width under ``--w8a8 --int8_qk``: the phase-9 Fill
    bundle's MMDiT quantized, then the same dataset through
    ``compose.process_dataset`` (2048 px, the multi-pass int8 kernel)."""
    import shutil
    import torch
    from domainrag_tpu_torch.models import quant
    t0 = time.perf_counter()
    _quantized(bundle)
    torch.cuda.synchronize()
    print(f"stage 4 int8: Fill MMDiT quantized in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{quant.quantized_bytes(bundle.flux_params) / 1e9:.2f} GB")
    with _int8_modes(w8a8=True, qk=True, pv=False):
        paths, step = _run_compose(bundle, root, backgrounds, rows,
                                   "output_int8", int8=True)
    print(f"stage 4 int8: {step:.3f} s per denoise step (bf16 "
          f"{bf16_step:.3f} s); mean abs uint8 difference of the hires "
          f"images to bf16's {_uint8_diff(paths, bf16_paths):.3f} (a report:"
          f" random weights)")
    shutil.rmtree(root / "output_int8")     # checked; keeps OUT small


def phase_profile_int8(bundle, size, out_name, rows, stage):
    """One traced full-width denoise step under W8A8 + int8 QK + int8 P.V;
    its B4 and B7 launches are the P.V rows' counts."""
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    _reset_counts(mma)
    with _int8_modes(w8a8=True, qk=True, pv=True):
        phase_profile(bundle, size, out_name)
    n = _i8_counts(mma)
    mp = size // 16 * (size // 16) + S_TXT > mma._MAX_ONEPASS
    kind, tag = ("mp_", f"_s{size // 16 * (size // 16) + S_TXT}") if mp \
        else ("", "")
    b7 = n[3:] if mp else n[1:3]
    for part, c in zip(("joint", "seq"), b7):
        rows[f"mmdit_{kind}i8_{part}_attention_pv{tag}"]["launches"] = c
    print(f"int8 trace launches (3 forwards: warm-up, untraced, traced): "
          f"B4 {n[0]}, B7 double/single {b7}")


# ---------------------------------------------------------------------------
# the trainer's slice: generic flash attention (B5, B6) and training
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_GRID, TRAIN_TXT = 2, 64, 512   # batch, 1024 px, T5 tokens
TRAIN_STEPS = 4
TRAIN_DEPTH = (2, 4)      # cut: FLUX.1-dev has 19 double + 38 single blocks
S_TRAIN = TRAIN_GRID * TRAIN_GRID + TRAIN_TXT          # 4608 joint tokens
S_LONG = 1241 + 49152     # above _MAX_MULTIPASS: the unfused serving path
# Gradients, bf16: relative Frobenius norm GRAD_REL and every element
# within GRAD_ELEM * max|plain| (P and dS rounded to bf16 for the tensor-
# core products, where the plain version keeps every product in f32).
# f32 (no TF32): F32_REL in norm and F32_REL * max|plain| per element
# (measured on the H100: 1.3e-6 in norm; summation order and exp2f/expf).
GRAD_REL, GRAD_ELEM, F32_REL = 1e-2, 2e-2, 1e-5
LSE_ATOL = 1e-3


def _check_grad(name, got, want, f32):
    """Gradient (or f32 output) vs plain: raises unless within the
    tolerance; returns the max abs error."""
    err = (got.float() - want.float()).abs()
    max_abs = err.max().item()
    top = want.float().abs().max().item()
    rel_norm = (err.norm() / want.float().norm().clamp_min(1e-30)).item()
    rel, elem = (F32_REL, F32_REL) if f32 else (GRAD_REL, GRAD_ELEM)
    print(f"kernel {name}: max_abs_err {max_abs:.3e} (max|ref| {top:.3e}) "
          f"rel_norm {rel_norm:.3e} (tol {rel} in norm, {elem}*max|ref|)")
    if not (max_abs <= elem * top and rel_norm < rel):
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def _flash_bound(flop_per, shape, f32, tensors=4, peak=None):
    """The least time for ``flop_per``*B*H*Sq*Skv*D FLOP at ``peak`` (by
    default the peak of the dtype: f32 FMA or bf16), or the bytes: each of
    ``tensors`` (B, H, S, D) tensors read or written once (forward: q, k,
    v, o; backward 8: q, k, v, o, dO, dq, dk, dv)."""
    b, h, s_q, s_kv, d = shape
    peak = peak or (PEAK_F32 if f32 else PEAK_BF16)
    ops = flop_per * b * h * s_q * s_kv * d / peak * 1e3
    nbytes = tensors * b * h * max(s_q, s_kv) * d * (4 if f32 else 2) \
        / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops, nbytes),
            "bound_by": "operations" if ops >= nbytes else "bytes"}


def _flash_row(name, replaces, max_abs, ms, plain_ms, library_ms, bound):
    row = {"name": name, "route": "cuda",
           "source": "domainrag_tpu_torch/csrc/flash_attention.cu",
           "replaces": f"domainrag_tpu/{replaces}", "launches": 0,
           "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **bound}
    print(f"kernel {name}: ms {ms:.3f} plain_ms {plain_ms:.3f} library_ms "
          f"{library_ms:.3f} bound_ms {row['bound_ms']:.3f} "
          f"({row['bound_by']})")
    return row


# ragged bf16 backward cases (b, h, s_q, s_kv, causal, kv_valid): kv_valid
# one past a 128-row kv tile, whole kv tiles past kv_valid, causal with
# s_q > s_kv and s_q < s_kv (kv rows no q reaches)
RAGGED_BWD = ((1, 2, 300, 400, False, 257), (1, 2, 200, 700, False, 130),
              (1, 2, 520, 200, True, None), (1, 2, 200, 520, True, None))


def _poison(like, n=8):
    """Leave n freed blocks of ``like``'s size filled with NaN in the
    caching allocator, so that an output a kernel fails to write does not
    happen to hold zeros."""
    import torch
    junk = [torch.full_like(like, float("nan")) for _ in range(n)]
    del junk


_PARENT_LIBS = {}


def _parent_lib(name):
    """The parent commit's ``csrc/<name>.cu`` (PARENT), built once into
    ``build/parent``."""
    import ctypes
    from domainrag_tpu_torch.ops import _build
    lib = _PARENT_LIBS.get(name)
    if lib is None:
        src = Path(PARENT) / "domainrag_tpu_torch" / "csrc" / f"{name}.cu"
        path = _build.BUILD / "parent" / f"lib{name}.so"
        path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o",
                               str(path), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        lib = _PARENT_LIBS[name] = ctypes.CDLL(str(path))
    return lib


def _in_turns(tag, parent, change, reps, agree):
    """``parent`` and ``change`` timed in turns (parent, change, change,
    parent); prints one line with the parent's outputs' relative norms
    against this commit's (``agree``)."""
    t = [_ms(parent, reps), _ms(change, reps), _ms(change, reps),
         _ms(parent, reps)]
    print(f"{tag} parent vs this commit (parent, change, change, parent): "
          f"{t[0]:.3f} / {t[1]:.3f} / {t[2]:.3f} / {t[3]:.3f} ms; the "
          f"parent's outputs within "
          + " / ".join(f"{a:.2e}" for a in agree)
          + " (relative norm) of this commit's")
    return t


def _rel_norm(x, y):
    return ((x.float() - y.float()).norm() / y.float().norm()).item()


def _parent_call(module, name, fn):
    """A call of ``fn`` with the parent commit's ``csrc/<name>.cu`` library
    in place of this commit's behind ``module``'s wrappers (its loader sets
    the argument types): for a kernel whose C interface the parent
    shares."""
    from domainrag_tpu_torch.ops import _build
    parent = _parent_lib(name)

    def run():
        own, own_lib = _build._LOADED.get(name), module._LIB
        _build._LOADED[name], module._LIB = parent, None
        try:
            module._lib()
            return fn()
        finally:
            module._LIB = own_lib
            if own is None:
                _build._LOADED.pop(name, None)
            else:
                _build._LOADED[name] = own
    return run


def _parent_b5_turns(name, q, k, v, out, lse, reps):
    """The parent's bf16 B5 on this row's inputs, timed in turns with this
    commit's; ``out`` and ``lse`` are this commit's outputs."""
    from domainrag_tpu_torch.ops import attention as attn

    def change():
        return attn._kernel_forward(q, k, v, False, None)
    parent = _parent_call(attn, "flash_attention", change)
    p_out, p_lse = parent()
    _in_turns(name, parent, change, reps,
              [_rel_norm(p_out, out), _rel_norm(p_lse, lse)])
    del p_out, p_lse


def _parent_launch_backward_f32(change):
    """``attn.launch_backward`` with the parent commit's f32 B6 (its dq and
    dk/dv kernels, PARENT's csrc) for f32 buffers and ``change`` for the
    others."""
    import ctypes
    import torch
    fn = _parent_lib("flash_attention").flash_bwd_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i] + [p] * 9 + [i] * 5 + [ctypes.c_float, p]
    fn.restype = ctypes.c_int

    def launch(buf):
        if buf.q.dtype != torch.float32:
            return change(buf)
        b, h, s_q, s_kv, d = buf.shape
        lse, delta = (x[:, :s_q].contiguous() for x in (buf.lse, buf.delta))
        buf.dq = torch.empty_like(buf.q)
        for which in (0, 1):
            rc = fn(which, buf.q.data_ptr(), buf.k.data_ptr(),
                    buf.v.data_ptr(), buf.dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), buf.dq.data_ptr(), buf.dk.data_ptr(),
                    buf.dv.data_ptr(), b * h, s_q, s_kv, buf.kv_valid,
                    int(buf.causal), 1.0 / math.sqrt(d),
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"the parent's f32 B6 failed: CUDA error "
                                   f"{rc}")
    return launch


def _parent_b6(buf, change, reps):
    """The parent commit's B6 (bf16: its one kernel, behind this commit's
    wrapper; f32: its dq and dk/dv kernels on f32 FMA) on the same inputs
    as ``buf``, into outputs of its own, timed in turns with this commit's
    ``change``."""
    import torch
    from domainrag_tpu_torch.ops import attention as attn
    mine = SimpleNamespace(**vars(buf))
    mine.dk, mine.dv = torch.empty_like(buf.dk), torch.empty_like(buf.dv)
    if buf.q.dtype == torch.float32:
        launch = _parent_launch_backward_f32(attn.launch_backward)
        parent = lambda: launch(mine)                        # noqa: E731
    else:
        parent = _parent_call(attn, "flash_attention",
                              lambda: attn.launch_backward(mine))
    parent()
    change()
    torch.cuda.synchronize()
    _in_turns("B6 f32" if buf.q.dtype == torch.float32 else "B6 bf16",
              parent, change, reps,
              [_rel_norm(x, y) for x, y in ((mine.dq, buf.dq),
                                            (mine.dk, buf.dk),
                                            (mine.dv, buf.dv))])
    del mine


def phase_flash_kernels(dev):
    """B5 and B6 against their plain versions: at the trainer's attention
    shape (2, 24, 4608, 128) in bf16 and f32 (forward; B6: one kernel in
    each dtype), B5 above _MAX_MULTIPASS at (1,
    24, 50393, 128) bf16 (compared on two heads with the blocked plain
    version), a small causal + kv_valid case with ragged lengths in both
    dtypes and the RAGGED_BWD bf16 backward cases. With ``--parent`` the
    parent commit's B6 (bf16, and its two f32 kernels) is timed beside
    this one."""
    import torch
    import torch.nn.functional as F
    from domainrag_tpu_torch.ops import attention as attn

    g = torch.Generator(device=dev)
    g.manual_seed(11)

    def qkvo(shape, dtype):
        b, h, s_q, s_kv, d = shape
        return [torch.randn(sh, generator=g, device=dev).to(dtype)
                for sh in ((b, h, s_q, d), (b, h, s_kv, d), (b, h, s_kv, d),
                           (b, h, s_q, d))]

    rows = {}
    # the small causal + kv_valid case, ragged (1000 = 15 x 64 + 40)
    for dtype in (torch.bfloat16, torch.float32):
        f32 = dtype == torch.float32
        q, k, v, do = qkvo((1, 4, 1000, 1000, 128), dtype)
        out, lse = attn._kernel_forward(q, k, v, True, 613)
        want, want_lse = attn.flash_forward_reference(q, k, v, True, 613)
        tag = f"flash small causal kv_valid {dtype}"
        if f32:
            _check_grad(tag + " out", out, want, True)
        else:
            _check(tag + " out", out, want)
        if (lse - want_lse).abs().max().item() > LSE_ATOL:
            raise AssertionError(f"{tag}: lse disagrees")
        _poison(k)
        got = attn._kernel_backward(q, k, v, want, want_lse, do, True, 613)
        ref = attn.flash_backward_reference(q, k, v, want, want_lse, do,
                                            True, 613)
        for nm, a, b in zip(("dq", "dk", "dv"), got, ref):
            _check_grad(f"{tag} {nm}", a, b, f32)
    for b_, h_, s_q, s_kv, causal, kv_valid in RAGGED_BWD:
        q, k, v, do = qkvo((b_, h_, s_q, s_kv, 128), torch.bfloat16)
        want, want_lse = attn.flash_forward_reference(q, k, v, causal,
                                                      kv_valid)
        _poison(k)
        got = attn._kernel_backward(q, k, v, want, want_lse, do, causal,
                                    kv_valid)
        ref = attn.flash_backward_reference(q, k, v, want, want_lse, do,
                                            causal, kv_valid)
        tag = (f"flash bwd bf16 {s_q}x{s_kv} causal {causal} kv_valid "
               f"{kv_valid}")
        for nm, a, b in zip(("dq", "dk", "dv"), got, ref):
            _check_grad(f"{tag} {nm}", a, b, False)

    for dtype, reps in ((torch.bfloat16, (20, 3, 20, 10)),
                        (torch.float32, (5, 3, 5, 3))):
        f32 = dtype == torch.float32
        tag = "f32" if f32 else "bf16"
        shape = (TRAIN_B, HEADS, S_TRAIN, S_TRAIN, HD)
        q, k, v, do = qkvo(shape, dtype)
        out, lse = attn._kernel_forward(q, k, v, False, None)
        want, want_lse = attn.flash_forward_reference(q, k, v)
        torch.cuda.synchronize()
        max_abs = (_check_grad(f"flash_fwd_{tag}", out, want, True) if f32
                   else _check(f"flash_fwd_{tag}", out, want))
        if (lse - want_lse).abs().max().item() > LSE_ATOL:
            raise AssertionError(f"flash_fwd_{tag}: lse disagrees")
        name = f"flash_fwd_{tag}_b{TRAIN_B}_s{S_TRAIN}"
        rows[name] = _flash_row(
            name, "ops/attention.py:110", max_abs,
            _ms(lambda: attn._kernel_forward(q, k, v, False, None), reps[0]),
            _ms(lambda: attn.flash_forward_reference(q, k, v), reps[1], 1),
            _ms(lambda: F.scaled_dot_product_attention(q, k, v), reps[2]),
            _flash_bound(4, shape, f32))
        if PARENT and not f32:
            _parent_b5_turns(name, q, k, v, out, lse, reps[0])
        # backward from the plain forward's out/lse
        buf = attn.backward_buffers(q, k, v, want, want_lse, do, False)
        attn.launch_backward(buf)
        ref = attn.flash_backward_reference(q, k, v, want, want_lse, do)
        torch.cuda.synchronize()
        unpad = [x.reshape(q.shape) for x in (buf.dq, buf.dk, buf.dv)]
        errs = [_check_grad(f"flash_bwd_{tag} {nm}", a, b, f32)
                for nm, a, b in zip(("dq", "dk", "dv"), unpad, ref)]
        plain_ms = _ms(lambda: attn.flash_backward_reference(
            q, k, v, want, want_lse, do), reps[1], 1)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves)
        library_ms = _ms(lambda: torch.autograd.grad(
            sdpa, leaves, do, retain_graph=True), reps[3])
        # one kernel for dq, dk and dv, the least work: 10 units. bf16: the
        # bound at the bf16 peak, ms with the dq_accum zeroing, scale and
        # cast. f32: every product as 3xTF32, so its route's bound is 30
        # units at the TF32 peak (on f32 FMA it would be 10 at 67 TFLOP/s);
        # ms with dq's zeroing
        name = f"flash_bwd_{tag}_b{TRAIN_B}_s{S_TRAIN}"
        rows[name] = _flash_row(
            name, "ops/attention.py:296,336", max(errs),
            _ms(lambda: attn.launch_backward(buf), reps[3]), plain_ms,
            library_ms, _flash_bound(30, shape, f32, 8, PEAK_TF32) if f32
            else _flash_bound(10, shape, f32, 8))
        if f32:
            print(f"kernel {name}: bound on f32 FMA (the route not taken) "
                  f"{_flash_bound(10, shape, f32, 8)['bound_ms']:.3f} ms")
        if PARENT:
            _parent_b6(buf, lambda: attn.launch_backward(buf), reps[3])
        del q, k, v, do, out, want, buf, ref, leaves, sdpa, unpad
        torch.cuda.empty_cache()

    # above _MAX_MULTIPASS: the serving path's unfused composition
    shape = (1, HEADS, S_LONG, S_LONG, HD)
    q, k, v, _ = qkvo(shape, torch.bfloat16)
    out, lse = attn._kernel_forward(q, k, v, False, None)
    want, want_lse = attn.flash_forward_reference(q[:, :2], k[:, :2],
                                                  v[:, :2])
    torch.cuda.synchronize()
    max_abs = _check(f"flash_fwd_bf16_s{S_LONG} (heads 0-1)", out[:, :2],
                     want)
    if (lse[:, :2] - want_lse).abs().max().item() > LSE_ATOL:
        raise AssertionError("flash_fwd long: lse disagrees")
    del want
    name = f"flash_fwd_bf16_b1_s{S_LONG}"
    rows[name] = _flash_row(
        name, "ops/attention.py:43", max_abs,
        _ms(lambda: attn._kernel_forward(q, k, v, False, None), 3),
        _ms(lambda: attn.flash_forward_reference(q, k, v), 1, 0),
        _ms(lambda: F.scaled_dot_product_attention(q, k, v), 3),
        _flash_bound(4, shape, False))
    if PARENT:
        _parent_b5_turns(name, q, k, v, out, lse, 3)
    del q, k, v, out, lse
    torch.cuda.empty_cache()
    return rows


def phase_long_serving(dev, rows):
    """The serving path above _MAX_MULTIPASS: a 4096 x 3072 px image
    (256 x 192 = 49152 latent tokens) behind the 1241-token Redux prompt
    is S_LONG joint tokens, where both attention wrappers take the unfused
    composition and so B5. Each wrapper runs once, with the counts set to 0
    just before and read just after; heads 0-1 of each output are held
    against the plain B5 forward on the same pre-normed q/k/v."""
    import torch
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.ops import mmdit_attention as mma

    gh, gw = 256, 192
    s_img = gh * gw
    if S_TXT + s_img != S_LONG or S_LONG <= mma._MAX_MULTIPASS:
        raise AssertionError(f"{S_TXT + s_img} tokens are not the long path")
    ids = np.concatenate([fm.make_text_ids(S_TXT), fm.make_image_ids(gh, gw)])
    cos, sin = fm.rope_cos_sin(torch.as_tensor(ids, device=dev),
                               fm.FLUX_DEV.axes_dim, fm.FLUX_DEV.theta)
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    hd = HEADS * HD

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def norm():
        return {"q": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)},
                "k": {"scale": 0.5 + torch.rand(HD, generator=g, device=dev)}}

    txt, img, proj = randn(1, S_TXT, 3 * hd), randn(1, s_img, 3 * hd), \
        randn(1, S_LONG, 7 * hd)
    tn, inorm, sn = norm(), norm(), norm()
    w = lambda n: (n["q"]["scale"], n["k"]["scale"])     # noqa: E731
    torch.cuda.synchronize()
    _reset_counts(mma)
    with torch.no_grad():
        out_d = torch.cat(mma.mmdit_double_attention(
            txt, img, tn, inorm, cos, sin, HEADS, HD), 1)
        out_s = mma.mmdit_single_attention(proj, sn, cos, sin, HEADS, HD)
    torch.cuda.synchronize()
    d, s = mma.mmdit_double_attention, mma.mmdit_single_attention
    counts = (d.launches + d.mp_launches, s.launches + s.mp_launches,
              *_flash_counts())
    print(f"launches on the path: {S_LONG} tokens, fused double/single "
          f"{counts[:2]} (expected (0, 0)), generic flash B5/B6/B6 f32 "
          f"{counts[2:]} (expected (2, 0, 0))")
    if counts != (0, 0, 2, 0, 0):
        raise AssertionError("long serving path: launch counts differ")
    for tag, out, (q, k, v) in (
            ("double", out_d, mma.prenormed_double(
                txt, img, *w(tn), *w(inorm), cos, sin, HEADS, HD)),
            ("single", out_s, mma.prenormed_single(
                proj, *w(sn), cos, sin, HEADS, HD))):
        if out.shape != (1, S_LONG, hd) or not torch.isfinite(out).all():
            raise AssertionError(f"long serving path ({tag}): output")
        want, _ = attn.flash_forward_reference(q[:, :2], k[:, :2], v[:, :2])
        got = out[..., :2 * HD].reshape(1, S_LONG, 2, HD).transpose(1, 2)
        _check(f"long serving path {tag} (heads 0-1)", got, want)
        del q, k, v, want, got
    rows[f"flash_fwd_bf16_b1_s{S_LONG}"]["launches"] = counts[2]
    del txt, img, proj, out_d, out_s
    torch.cuda.empty_cache()


def _train_cfg_small():
    from domainrag_tpu_torch.models.flux import model as fm
    return dataclasses.replace(
        fm.TINY_FLUX, hidden=256, heads=2, head_dim=128, depth_double=1,
        depth_single=1, axes_dim=(16, 56, 56), in_channels=64,
        out_channels=64)


def _leaves_cat(tree):
    import torch
    from domainrag_tpu_torch.train import flow_match
    return torch.cat([t.detach().float().reshape(-1).cpu()
                      for t in flow_match.leaves(tree)])


def phase_small_trainer(dev):
    """A head_dim-128 toy MMDiT (hidden 256, one double and one single
    block) at 128 px: three ``train_step``s on the card and on the CPU
    from the same weights, batches, t and eps, once with bf16 batches (the
    fused forward, B5/B6 in the backward) and once with f32 batches (B5/B6
    only). Also the first step's gradients, card vs CPU."""
    import torch
    from domainrag_tpu_torch.models.common import Init
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.train import flow_match

    cfg = _train_cfg_small()
    tcfg = flow_match.TrainConfig(learning_rate=1e-4)
    steps, grid, s_txt = 3, 8, 32
    rng = np.random.default_rng(21)
    cpu = torch.device("cpu")
    base = fm.init(cfg, Init(torch.Generator().manual_seed(21), cpu))
    ids = (torch.as_tensor(fm.make_image_ids(grid, grid)),
           torch.as_tensor(fm.make_text_ids(s_txt)))
    data = [{"x0": rng.standard_normal((2, grid * grid, 64)),
             "txt": rng.standard_normal((2, s_txt, cfg.text_dim)),
             "pooled": rng.standard_normal((2, cfg.pooled_dim)),
             "t": 1 / (1 + np.exp(-rng.standard_normal(2))),
             "eps": rng.standard_normal((2, grid * grid, 64))}
            for _ in range(steps)]
    # per step: each block's fused forward twice (forward and the remat
    # recompute), the unfused recompute's B5 and B6 once per block; f32
    # runs B5 in each forward instead, and the f32 B6
    want_counts = {torch.bfloat16: (2, 2, 2, 2, 0),
                   torch.float32: (0, 0, 4, 0, 2)}
    for dtype in (torch.bfloat16, torch.float32):
        runs = []
        for where in (dev, cpu):
            params = _tree(lambda t: t.clone().to(where), base)
            step, params, opt = flow_match.make_train_step(cfg, tcfg, params)
            batches = [{"x0": torch.as_tensor(d["x0"], dtype=dtype,
                                              device=where),
                        "txt": torch.as_tensor(d["txt"], dtype=dtype,
                                               device=where),
                        "pooled": torch.as_tensor(d["pooled"], dtype=dtype,
                                                  device=where),
                        "img_ids": ids[0].to(where),
                        "txt_ids": ids[1].to(where)} for d in data]
            t_eps = [(torch.as_tensor(d["t"], dtype=torch.float32),
                      torch.as_tensor(d["eps"], dtype=torch.float32))
                     for d in data]
            loss = flow_match.flow_match_loss(params, batches[0], None, cfg,
                                              tcfg, *t_eps[0])
            grads = torch.autograd.grad(loss, flow_match.leaves(params))
            grad0 = torch.cat([gr.float().reshape(-1).cpu() for gr in grads])
            _reset_counts(mma)
            losses = []
            for b, (t, e) in zip(batches, t_eps):
                params, opt, l_ = step(params, opt, b, None, t=t, eps=e)
                losses.append(l_.item())
            counts = (mma.mmdit_double_attention.launches,
                      mma.mmdit_single_attention.launches, *_flash_counts())
            runs.append((losses, grad0, _leaves_cat(params), counts))
        (l_card, g_card, p_card, counts), (l_cpu, g_cpu, p_cpu, _) = runs
        p0 = _leaves_cat(base)
        d_card, d_cpu = p_card - p0, p_cpu - p0
        grad_rel = ((g_card - g_cpu).norm() / g_cpu.norm()).item()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
        upd_rel = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
        upd_max = (d_card - d_cpu).abs().max().item()
        want = tuple(steps * n for n in want_counts[dtype])
        print(f"small trainer ({dtype}, {steps} steps, 128 px, head_dim 128):"
              f" losses card {[round(x, 6) for x in l_card]} CPU "
              f"{[round(x, 6) for x in l_cpu]} (max rel {loss_rel:.3e}), "
              f"first-step grads rel_norm {grad_rel:.3e}, param updates "
              f"rel_norm {upd_rel:.3e} max abs {upd_max:.3e} (lr "
              f"{tcfg.learning_rate}); launches B1/B2/B5/B6/B6 f32 "
              f"{counts}"
              f" (expected {want})")
        f32 = dtype == torch.float32
        lim = SMALL_TRAIN_F32 if f32 else SMALL_TRAIN_BF16
        if counts != want:
            raise AssertionError("small trainer: launch counts differ")
        if not (all(np.isfinite(l_card)) and loss_rel < lim[0]
                and grad_rel < lim[1] and upd_rel < lim[2]):
            raise AssertionError(f"small trainer ({dtype}): card and CPU "
                                 "disagree")


# card vs CPU limits of the small trainer: (loss rel, first-step grads
# rel norm, param updates rel norm), about 5x what was measured on the
# H100. f32: summation order only, then Adam (g/(|g|+eps) ~ sign g)
# amplifies it for near-zero gradients. bf16: the kernels round P against
# a running max and P, dS to bf16, the CPU plain versions do not, and Adam
# turns the sign of small gradients.
SMALL_TRAIN_F32 = (1e-6, 1e-5, 5e-4)
SMALL_TRAIN_BF16 = (1e-3, 2e-2, 0.15)


class _Spans:
    """A StepTimer that also keeps each span's seconds."""

    def __init__(self):
        import torch
        from domainrag_tpu_torch.core.log import StepTimer
        self.timer = StepTimer(sync=torch.cuda.synchronize)
        self.each = {}

    @contextlib.contextmanager
    def span(self, name):
        before = self.timer.totals.get(name, 0.0)
        with self.timer.span(name):
            yield
        self.each.setdefault(name, []).append(self.timer.totals[name]
                                              - before)


def _full_train_setup(dev):
    import torch
    from domainrag_tpu_torch.models.common import Init
    from domainrag_tpu_torch.models.flux import model as fm
    cfg = dataclasses.replace(fm.FLUX_DEV, depth_double=TRAIN_DEPTH[0],
                              depth_single=TRAIN_DEPTH[1])
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    params = fm.init(cfg, Init(g, dev, torch.float32))
    img_ids = torch.as_tensor(fm.make_image_ids(TRAIN_GRID, TRAIN_GRID),
                              device=dev)
    txt_ids = torch.as_tensor(fm.make_text_ids(TRAIN_TXT), device=dev)

    def batches():
        while True:
            yield {"x0": torch.randn((TRAIN_B, TRAIN_GRID ** 2,
                                      cfg.in_channels), generator=g,
                                     device=dev).to(torch.bfloat16),
                   "txt": torch.randn((TRAIN_B, TRAIN_TXT, cfg.text_dim),
                                      generator=g, device=dev
                                      ).to(torch.bfloat16),
                   "pooled": torch.randn((TRAIN_B, cfg.pooled_dim),
                                         generator=g, device=dev
                                         ).to(torch.bfloat16),
                   "img_ids": img_ids, "txt_ids": txt_ids}
    return cfg, params, batches


def phase_train(dev, rows):
    """The trainer at FLUX.1-dev width cut in depth: ``fit`` with remat
    for TRAIN_STEPS steps on synthetic bf16 batches (batch 2, 1024 px =
    4096 image tokens, 512 T5 tokens), one checkpoint at the end under
    OUT, restored; the launch counts per step."""
    import shutil
    import torch
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.train import checkpoint as ckpt
    from domainrag_tpu_torch.train import flow_match, loop

    print(f"trainer cuts: depth {TRAIN_DEPTH[0]} double + {TRAIN_DEPTH[1]} "
          f"single blocks (FLUX.1-dev has 19 + 38), {TRAIN_STEPS} steps, "
          f"batch {TRAIN_B}, {TRAIN_GRID * 16} px ({TRAIN_GRID ** 2} image "
          f"tokens) + {TRAIN_TXT} T5 tokens, synthetic bf16 batches")
    torch.cuda.reset_peak_memory_stats()
    cfg, params, batches = _full_train_setup(dev)
    n_params = sum(t.numel() for t in flow_match.leaves(params))
    probe = params["single"][-1]["linear1"]["w"]
    before = probe.clone()
    print(f"trainer params: {n_params / 1e9:.3f} B f32 drawn on the card")
    root = OUT / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    spans = _Spans()
    _reset_counts(mma)
    params, losses = loop.fit(
        params, cfg, batches(), TRAIN_STEPS,
        flow_match.TrainConfig(remat=True), checkpoint_dir=str(root),
        checkpoint_every=1000, seed=0, log_every=1, timer=spans)
    torch.cuda.synchronize()
    counts = (mma.mmdit_double_attention.launches,
              mma.mmdit_single_attention.launches,
              mma.mmdit_double_attention.mp_launches
              + mma.mmdit_single_attention.mp_launches, *_flash_counts())
    d, sg = cfg.depth_double, cfg.depth_single
    # per step: each fused block twice (forward, remat recompute), then one
    # unfused recompute per block in the backward: B5 once, B6 once
    want = tuple(TRAIN_STEPS * n for n in (2 * d, 2 * sg, 0, d + sg, d + sg,
                                           0))
    print(f"launches on the path: B1 {counts[0]}, B2 {counts[1]}, B3 "
          f"{counts[2]}, B5 {counts[3]}, B6 {counts[4]}, B6 f32 "
          f"{counts[5]} (expected {want})")
    if counts != want:
        raise AssertionError("trainer: kernel launch counts differ")
    _flash_launches(rows, "bf16", counts[3:])
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"trainer losses {losses}")
    moved = (probe - before).abs().max().item()
    if not moved > 0:
        raise AssertionError("trainer: the params did not change")
    t0 = time.perf_counter()
    restored = ckpt.restore_checkpoint(str(root))
    t_restore = time.perf_counter() - t0
    if ckpt.latest_step(str(root)) != TRAIN_STEPS or not torch.equal(
            restored["params"]["single"][-1]["linear1"]["w"],
            probe.detach().cpu()):
        raise AssertionError("trainer: the checkpoint does not restore the "
                             "final params")
    size = sum(f.stat().st_size for f in root.rglob("*") if f.is_file())
    del restored
    shutil.rmtree(root)
    steps = spans.each["step"]
    print(f"trainer: losses {[round(x, 5) for x in losses]}, params moved "
          f"(max |dw| {moved:.3e} on one leaf), {statistics.mean(steps[1:]):.3f}"
          f" s per step (mean of steps 2-{TRAIN_STEPS}; first "
          f"{steps[0]:.3f} s), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, checkpoint "
          f"step_{TRAIN_STEPS} {size / 1e9:.2f} GB written in "
          f"{spans.each['save'][0]:.2f} s, restored in {t_restore:.2f} s")
    return cfg, params, batches


def phase_profile_train(dev, cfg, params, batches):
    """One full-width train step (the phase_train model and batch) under
    torch.profiler, device time grouped (full table in
    OUT/profile_train.txt), beside the wall time of the same step
    untraced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.train import flow_match

    step, params, opt = flow_match.make_train_step(
        cfg, flow_match.TrainConfig(remat=True), params)
    it = batches()
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    step(params, opt, next(it), g)              # the moments are allocated
    batch = next(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(params, opt, batch, g)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch, g)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        # device-side kernels only: a user annotation's range (the
        # optimizer step's) spans kernels counted already
        if e.device_type != DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    total = sum(ms for ms, _, _ in kernels)
    if not total:
        print("profile: the profiler recorded no device time (not measured)")
        return
    groups = {"fused forward (B1/B2)": 0.0, "B5": 0.0, "B6": 0.0,
              "GEMM (cuBLAS)": 0.0, "optimizer": 0.0, "other": 0.0}
    for ms, _, name in kernels:
        if _fused_fwd(name):
            groups["fused forward (B1/B2)"] += ms
        elif "FwdRows" in name or "fwd_simt_kernel" in name:
            groups["B5"] += ms
        elif re.search(r"bwd_(bf16|f32)_kernel", name):
            groups["B6"] += ms
        elif re.search(r"gemm|nvjet|cutlass|xmma|cublas", name, re.I):
            groups["GEMM (cuBLAS)"] += ms
        elif re.search(r"multi_tensor_apply|adam", name, re.I):
            groups["optimizer"] += ms
        else:
            groups["other"] += ms
    # B6's dq_accum zeroing, scale and cast are generic elementwise
    # kernels: their profiler range moves them from "other" to B6
    accum = _range_device_ms(prof, attn.DQ_ACCUM_SPAN)
    groups["B6"] += accum
    groups["other"] -= accum
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile_train.txt").write_text("".join(
        f"{ms:10.3f} ms {n:6d}x  {name}\n" for ms, n, name in kernels))
    print(f"profile: one train step (batch {TRAIN_B}, {S_TRAIN} tokens, "
          f"{TRAIN_DEPTH[0]} + {TRAIN_DEPTH[1]} blocks, remat), device time "
          f"{total:.3f} ms (untraced wall {wall_ms:.3f} ms), "
          f"{sum(n for _, n, _ in kernels)} device events; "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in groups.items())
          + f"; B6 includes its dq_accum ops, {accum:.3f} ms")
    for ms, n, name in kernels[:10]:
        print(f"  {ms:9.3f} ms {n:5d}x  {name[:100]}")


def _range_device_ms(prof, name):
    """Device time (ms) of the kernels launched inside the host ranges
    ``name`` (torch.profiler.record_function) of a trace."""
    from torch.autograd import DeviceType
    total = 0.0
    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            us = getattr(e, "device_time_total", None)
            total += (e.cuda_time_total if us is None else us) / 1e3
    return total


def phase_train_f32(dev, cfg, params, batches, rows):
    """One full-width ``fit`` step (the phase_train model) on f32 batches,
    the dtype ``latent_batches_from_images`` yields: the fused kernels want
    bf16, so every block runs the unfused composition, B5 in its forward
    and in its remat recompute and B6 in its backward. The counts are set
    to 0 just before and read just after; the f32 rows take them. With
    ``--parent``, four steady steps follow, timed in turns with the
    parent's f32 B6 in two."""
    import torch
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.train import flow_match, loop

    lanes = ("x0", "txt", "pooled")
    f32 = ({k: v.float() if k in lanes else v for k, v in b.items()}
           for b in batches())
    probe = params["double"][0]["img_qkv"]["w"]
    before = probe.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _reset_counts(mma)
    params, losses = loop.fit(params, cfg, f32, 1,
                              flow_match.TrainConfig(remat=True), seed=1,
                              log_every=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = (mma.mmdit_double_attention.launches,
              mma.mmdit_single_attention.launches,
              mma.mmdit_double_attention.mp_launches
              + mma.mmdit_single_attention.mp_launches, *_flash_counts())
    n = cfg.depth_double + cfg.depth_single
    want = (0, 0, 0, 2 * n, 0, n)
    print(f"launches on the path (f32 trainer, one step): B1 {counts[0]}, "
          f"B2 {counts[1]}, B3 {counts[2]}, B5 {counts[3]}, B6 bf16 "
          f"{counts[4]}, B6 f32 {counts[5]} (expected {want})")
    if counts != want:
        raise AssertionError("f32 trainer: kernel launch counts differ")
    moved = (probe.detach() - before).abs().max().item()
    if len(losses) != 1 or not np.isfinite(losses[0]) or not moved > 0:
        raise AssertionError(f"f32 trainer: loss {losses}, max |dw| {moved}")
    _flash_launches(rows, "f32", counts[3:])
    print(f"f32 trainer: loss {losses[0]:.5f}, params moved (max |dw| "
          f"{moved:.3e} on one leaf), {secs:.3f} s for the step (the first, "
          f"with the optimizer's state allocated), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not PARENT:
        return
    # steady f32 steps: this commit's B6 and the parent's two f32 kernels
    # in its place, in turns
    step, params, opt = flow_match.make_train_step(
        cfg, flow_match.TrainConfig(remat=True), params)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    batch = next(f32)
    step(params, opt, batch, g)                 # the moments are allocated

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, batch, g)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    change = attn.launch_backward
    parent = _parent_launch_backward_f32(change)
    t = []
    for launch in (parent, change, change, parent):
        attn.launch_backward = launch
        try:
            t.append(timed())
        finally:
            attn.launch_backward = change
    print(f"f32 train step parent vs this commit (parent, change, change, "
          f"parent): {t[0]:.3f} / {t[1]:.3f} / {t[2]:.3f} / {t[3]:.3f} s")


TOPK_Q, TOPK_N, TOPK_D, TOPK_K = 200, 118_287 + 60_000, 512, 100
COCO_ROWS, MINI_ROWS = 118_287, 60_000   # COCO train2017, miniImageNet
CORPUS_IMAGES = 512       # cut: the rest of the bank is random unit rows
SHOTS = 10
DIOR_CLASSES = ("airplane", "airport", "baseballfield", "basketballcourt",
                "bridge", "chimney", "dam", "expresswayservicearea",
                "expresswaytollstation", "golffield", "groundtrackfield",
                "harbor", "overpass", "ship", "stadium", "storagetank",
                "tenniscourt", "trainstation", "vehicle", "windmill")
# B8 on a random unit-norm bank: the kernel sums k ascending with FFMA,
# cuBLAS in another order, so scores may differ in the last bits (~1e-7 at
# |score| <= 1): scores within 1e-5, indices equal wherever the plain
# version's neighbouring scores are more than 1e-5 apart.
TOPK_TOL = 1e-5


def _topk_bound(nq, n, d, k):
    """2*Q*N*d f32 FMA operations at the f32 peak, or the bytes (queries
    and bank read once, (Q, k) scores and indices written once)."""
    ops = 2.0 * nq * n * d / PEAK_F32 * 1e3
    nbytes = (4.0 * (nq + n) * d + 8.0 * nq * k) / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops, nbytes),
            "bound_by": "operations" if ops >= nbytes else "bytes"}


def _int_bank(g, dev, nq, n, d):
    """tests/test_topk.py's integer-valued case: every inner product is
    exact in f32 under any order; a third of the rows duplicated, so
    exact ties occur."""
    import torch
    bank = torch.randint(-8, 8, (n, d), generator=g, device=dev).float()
    bank[n // 3:2 * (n // 3)] = bank[:n // 3]
    q = torch.randint(-8, 8, (nq, d), generator=g, device=dev).float()
    return q, bank


def _excused(plain_scores, k, tol=TOPK_TOL):
    """Positions of the first k whose plain score lies within tol of a
    neighbour (k + 1 scores given): there the two orders may swap."""
    import torch
    near = (plain_scores[:, :-1] - plain_scores[:, 1:]).abs() <= tol
    out = torch.zeros_like(plain_scores[:, :k], dtype=torch.bool)
    out |= near[:, :k]
    out[:, 1:] |= near[:, :k - 1]
    return out


def _topk_close(name, got, plain_k1, k):
    """B8 (or a route) against the plain version's k + 1 best: scores
    within TOPK_TOL, indices equal except at near ties. Returns the max
    abs score error."""
    import torch
    max_abs = (got[0] - plain_k1[0][:, :k]).abs().max().item()
    excused = _excused(plain_k1[0], k)
    bad = (got[1] != plain_k1[1][:, :k]) & ~excused
    print(f"kernel {name}: max_abs_err {max_abs:.3e} (tol {TOPK_TOL}); "
          f"{int(excused.sum())} of {excused.numel()} positions within "
          f"{TOPK_TOL} of a neighbour, {int(bad.sum())} wrong indices "
          f"elsewhere")
    if max_abs > TOPK_TOL or bool(bad.any()):
        raise AssertionError(f"{name} disagrees with its plain version")
    return max_abs


def _ordered_banks(g, dev, nq, n, d):
    """Two integer banks that strain B8's buffered selection, every sum
    exact in f32: ascending (the queries one-hot on lane 0, the bank's lane
    0 its row index and the other lanes random integers, so score = index
    and every bank tile beats every row's threshold: each tile merges every
    buffer) and all-equal (every score ties, so the first tile fills every
    buffer and the index order alone decides)."""
    import torch
    one_hot = torch.zeros(nq, d, device=dev)
    one_hot[:, 0] = 1
    ramp = torch.randint(-8, 8, (n, d), generator=g, device=dev).float()
    ramp[:, 0] = torch.arange(n, device=dev, dtype=torch.float32)
    return ((one_hot, ramp),
            (torch.ones(nq, d, device=dev), torch.ones(n, d, device=dev)))


def _topk_parent(q, bank, k):
    """The parent commit's B8 (PARENT's csrc) on the same inputs: returns a
    call that launches it and gives (scores, indices)."""
    import ctypes
    import torch
    lib = _parent_lib("topk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_ip_fused_splits.argtypes = [i, i, i]
    lib.topk_ip_fused_splits.restype = ctypes.c_int
    lib.topk_ip_fused.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.topk_ip_fused.restype = ctypes.c_int
    nq, d = q.shape
    n = bank.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    splits = lib.topk_ip_fused_splits(nq, n, sms)
    part_s = torch.empty((nq, splits, k), device=q.device)
    part_i = torch.empty((nq, splits, k), dtype=torch.int32, device=q.device)
    out_s = torch.empty((nq, k), device=q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=q.device)

    def run():
        rc = lib.topk_ip_fused(q.data_ptr(), bank.data_ptr(),
                               part_s.data_ptr(), part_i.data_ptr(),
                               out_s.data_ptr(), out_i.data_ptr(), nq, n, d,
                               k, sms, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's B8 failed: CUDA error {rc}")
        return out_s, out_i
    return run


def _topk_merge_share(q, bank, k):
    """Device ms of B8's two passes (topk_partial, topk_merge) in one
    traced call."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from domainrag_tpu_torch.ops import topk as tk
    import torch
    tk.topk_ip_fused(q, bank, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tk.topk_ip_fused(q, bank, k)
        torch.cuda.synchronize()
    ms = {"topk_partial": 0.0, "topk_merge": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        for name in ms:
            if name in e.key:
                ms[name] += us / 1e3
    return ms


def phase_topk_kernel(dev):
    """B8 against its plain version: torch.equal on integer banks with
    ties at the stage's shape (200 x 178287 x 512, k 100, 500 and 1000)
    and at ragged ones (k = 1, k > N, N and d off the tiles, k 256 and
    300), on an ascending and an all-equal bank (_ordered_banks) at k 100
    and 1000, then a random unit-norm bank at the stage's shape under
    TOPK_TOL; timed at k 100, 500 and 1000 beside the plain version and
    torch.topk(q @ bank.T) (TF32 off), a yardstick only, at k 1000 with
    the merge pass's share of one traced call; with ``--parent`` the
    parent commit's B8 in turns."""
    import torch
    from domainrag_tpu_torch.ops import topk as tk

    g = torch.Generator(device=dev)
    g.manual_seed(31)

    def equal(tag, q, bank, k):
        before = tk.topk_ip_fused.launches
        got = tk.topk_ip_fused(q, bank, k)
        launches = tk.topk_ip_fused.launches - before
        want = tk.reference_topk_ip_fused(q, bank, k)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        nq, d = q.shape
        print(f"kernel topk_ip_fused {nq}x{bank.shape[0]}x{d} k {k}, {tag}: "
              f"torch.equal to the plain version: {same}; launches "
              f"{launches}")
        if not same or launches != 1:
            raise AssertionError("topk_ip_fused disagrees with its plain "
                                 f"version at {nq}x{bank.shape[0]}x{d} k "
                                 f"{k} ({tag})")

    for nq, n, d, k in ((TOPK_Q, TOPK_N, TOPK_D, TOPK_K), (7, 333, 64, 100),
                        (3, 513, 32, 100), (TOPK_Q, TOPK_N, TOPK_D, 1),
                        (33, 1000, 50, 256), (4, 50, 32, 100),
                        (33, 1000, 50, 300), (4, 300, 32, 500),
                        (TOPK_Q, TOPK_N, TOPK_D, 500),
                        (TOPK_Q, TOPK_N, TOPK_D, 1000)):
        equal("integer bank with ties", *_int_bank(g, dev, nq, n, d), k)
    for k in (TOPK_K, 1000):
        for tag, (q, bank) in zip(("ascending bank", "all-equal bank"),
                                  _ordered_banks(g, dev, TOPK_Q, TOPK_N,
                                                 TOPK_D)):
            equal(tag, q, bank, k)
    del q, bank
    q = torch.nn.functional.normalize(
        torch.randn(TOPK_Q, TOPK_D, generator=g, device=dev), dim=1)
    bank = torch.nn.functional.normalize(
        torch.randn(TOPK_N, TOPK_D, generator=g, device=dev), dim=1)
    max_abs = _topk_close(
        "topk_ip_fused unit-norm bank", tk.topk_ip_fused(q, bank, TOPK_K),
        tk.reference_topk_ip_fused(q, bank, TOPK_K + 1), TOPK_K)
    rows = {}
    for k in (TOPK_K, 500, 1000):
        t = {"ms": _ms(lambda: tk.topk_ip_fused(q, bank, k), 20),
             "plain_ms": _ms(lambda: tk.reference_topk_ip_fused(q, bank, k),
                             5),
             "library_ms": _ms(lambda: torch.topk(
                 torch.matmul(q, bank.T), k, dim=1), 20),
             **_topk_bound(TOPK_Q, TOPK_N, TOPK_D, k)}
        print(f"kernel topk_ip_fused {TOPK_Q}x{TOPK_N}x{TOPK_D} k {k}: ms "
              f"{t['ms']:.4f} plain_ms {t['plain_ms']:.4f} library_ms "
              f"{t['library_ms']:.4f} bound_ms {t['bound_ms']:.4f} "
              f"({t['bound_by']})")
        if k == 1000:       # the merge pass's share where it is largest
            print(f"kernel topk_ip_fused k {k}, one traced call: " + ", ".join(
                f"{name} {ms:.4f} ms" if ms else f"{name} not measured (no "
                "device time recorded)"
                for name, ms in _topk_merge_share(q, bank, k).items()))
        if PARENT:
            parent = _topk_parent(q, bank, k)
            p_out = parent()
            out = tk.topk_ip_fused(q, bank, k)
            torch.cuda.synchronize()
            print(f"B8 k {k}: the parent's indices differ from this "
                  f"commit's at a share "
                  f"{(p_out[1] != out[1]).float().mean().item():.2e} of "
                  "positions")
            _in_turns(f"B8 k {k}", parent,
                      lambda: tk.topk_ip_fused(q, bank, k), 10,
                      [_rel_norm(p_out[0], out[0])])
        if k == TOPK_K:
            rows["topk_ip_fused"] = {
                "name": "topk_ip_fused", "route": "cuda",
                "source": "domainrag_tpu_torch/csrc/topk.cu",
                "replaces": "domainrag_tpu/ops/topk.py:183", "launches": 0,
                "max_abs_err": max_abs, **t}
    # where the time goes: k = 1 keeps the GEMM and drops almost every
    # merge of the buffers into the lists; the library's GEMM alone
    print(f"kernel topk_ip_fused split: k 1 "
          f"{_ms(lambda: tk.topk_ip_fused(q, bank, 1), 20):.4f} ms; the "
          f"library's matmul alone "
          f"{_ms(lambda: torch.matmul(q, bank.T), 20):.4f} ms")
    return rows


def _jpeg(rng, path, w, h):
    """A smooth random image (blurred low-resolution noise), JPEG."""
    from PIL import Image
    low = rng.integers(0, 256, (h // 32 + 2, w // 32 + 2, 3), dtype=np.uint8)
    Image.fromarray(low).resize((w, h), Image.BILINEAR).save(path,
                                                             quality=90)


def _check_retrieval(results, out, queries, corpus, mapping):
    """Every artifact of the stage and its JSON schema, as the JAX stage
    writes them (tests/test_torch_retrieve.py holds the port's tree to
    JAX's)."""
    from PIL import Image
    from domainrag_tpu_torch.stages import retrieve as ret
    res = Path(results)
    with open(res / "all_shots_retrieval_results.json") as f:
        assert json.load(f) == out
    tag = f"DIOR_{SHOTS}_shot"
    cats = out["DIOR"][f"{SHOTS}_shot"]
    with open(res / f"{tag}_retrieval_results.json") as f:
        assert json.load(f) == cats
    assert sorted(cats) == sorted(DIOR_CLASSES)
    corpus = set(corpus)
    n_samples = 0
    for cat, entries in cats.items():
        assert len(entries) == SHOTS
        for e in entries:
            n_samples += 1
            assert list(e) == ["sample_id", "image_path", "category",
                               "similar_images"]
            assert e["category"] == cat == mapping[e["sample_id"]]
            assert e["image_path"] == queries[e["sample_id"]]
            sims = e["similar_images"]
            assert len(sims) == TOPK_K
            assert [s["rank"] for s in sims] == list(range(1, TOPK_K + 1))
            vals = [s["similarity"] for s in sims]
            assert all(0 < v <= 1 for v in vals)
            assert vals == sorted(vals, reverse=True)
            for s in sims:
                assert list(s) == ["rank", "similarity", "image_path",
                                   "source_dataset"]
                assert s["image_path"] in corpus
                assert s["source_dataset"] in ("coco", "miniimagenet")
            stem = f"{tag}_{cat}_{e['sample_id']}"
            with open(res / f"{stem}_retrieval_results.json") as f:
                assert json.load(f) == sims
            with Image.open(res / f"{stem}_visual.jpg") as im:
                assert im.size[0] > 0
    assert n_samples == len(DIOR_CLASSES) * SHOTS
    feats = np.load(res / f"{tag}_inpainted_clip_features.npy")
    assert feats.shape == (n_samples, 512) and np.isfinite(feats).all()
    assert np.allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-5)
    with open(res / f"{tag}_inpainted_image_paths.json") as f:
        assert json.load(f) == [queries[s] for s in sorted(queries)]
    feat_file, paths_file = ret.bank_cache_files(results, "coco")
    assert np.load(feat_file).shape == (CORPUS_IMAGES, 512)
    with open(paths_file) as f:
        assert len(json.load(f)) == CORPUS_IMAGES
    return feats


def _grid_renderer(results):
    """Which renderer drew the stage's grids, from a grid's size: the
    matplotlib figure (16 x 12 in at 72 dpi) or the PIL fallback (4 x 3
    thumbnails of 256 px)."""
    from PIL import Image
    from domainrag_tpu_torch.stages import visualize as vis
    path = sorted(Path(results).glob("*_visual.jpg"))[0]
    with Image.open(path) as im:
        size = im.size
    pil = (vis.GRID_COLS * vis.THUMB, vis.GRID_ROWS * vis.THUMB)
    mpl = (4 * 72 * vis.GRID_COLS, 4 * 72 * vis.GRID_ROWS)
    return {pil: "PIL", mpl: "matplotlib"}.get(size, f"unknown {size}")


def _profile_retrieval(bank, clip_enc, stem_p, root, results, dev):
    """The same dataset-shot again under torch.profiler, into a fresh
    results directory with a fresh style memo (so it encodes, re-ranks and
    writes as the first run did): the device's busy time (its kernels'
    summed time) and idle share over the traced wall time (full kernel
    table in ``OUT/profile_retrieval.txt``)."""
    import shutil
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from domainrag_tpu_torch.core.config import RetrievalConfig
    from domainrag_tpu_torch.stages import encoders, retrieve

    print(f"stage 2 grids drawn by {_grid_renderer(results)}")
    traced = str(root / "retrieval_results_traced")
    style_enc = encoders.StyleEncoder(stem_p, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        retrieve.run_retrieval(["DIOR"], [SHOTS], bank, clip_enc, style_enc,
                               str(root / "lamainpaint"), traced,
                               RetrievalConfig())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(traced)
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    if not busy:
        print("profile stage 2: the profiler recorded no device time "
              "(idle share not measured)")
        return
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile_retrieval.txt").write_text("".join(
        f"{ms:10.3f} ms {n:6d}x  {name}\n" for ms, n, name in kernels))
    print(f"profile stage 2: one dataset-shot traced, wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms in "
          f"{sum(n for _, n, _ in kernels)} device events, idle share "
          f"{100 * (1 - busy / wall_ms):.3f}%")
    for ms, n, name in kernels[:5]:
        print(f"  {ms:9.3f} ms {n:5d}x  {name[:100]}")


def phase_retrieval(dev, rows):
    """Stage 2 at full width: a random CLIP ViT-B/32 (224 px, patch 32,
    12 x 768, 12 heads, proj 512) and ResNet-50 stem drawn on the card;
    512 corpus JPEGs (640x480) through the feature cache, the bank filled
    to COCO train2017 + miniImageNet size with random unit rows whose
    paths cycle over the JPEGs; ``run_retrieval`` on a DIOR 10-shot
    directory (200 queries at 800x800, 20 classes) with the default
    RetrievalConfig (top-100, re-rank 100, grids on). Then
    ``first_stage_topk(use_pallas=True)`` (B8, one launch) against the
    default route on the same query features."""
    import shutil
    import torch
    from domainrag_tpu_torch.core import device as device_mod
    from domainrag_tpu_torch.core.config import RetrievalConfig
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.models import clip, resnet_stem
    from domainrag_tpu_torch.models.common import Init
    from domainrag_tpu_torch.ops import topk as tk
    from domainrag_tpu_torch.stages import encoders, retrieve

    root = OUT / "retrieval"
    shutil.rmtree(root, ignore_errors=True)
    corpus_dir = root / "coco" / "train2017"
    shot_dir = root / "lamainpaint" / "DIOR" / f"{SHOTS}_shot"
    corpus_dir.mkdir(parents=True)
    shot_dir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    corpus = []
    for i in range(CORPUS_IMAGES):
        corpus.append(str(corpus_dir / f"{i:012d}.jpg"))
        _jpeg(rng, corpus[-1], 640, 480)
    mapping, queries = {}, {}
    for c, cls in enumerate(DIOR_CLASSES):
        for s in range(SHOTS):
            sid = f"{c * SHOTS + s:05d}"
            mapping[sid] = cls
            queries[sid] = str(shot_dir / f"{sid}.jpg")
            _jpeg(rng, queries[sid], 800, 800)
    with open(shot_dir / "category_mapping.json", "w") as f:
        json.dump(mapping, f)
    print(f"retrieval data: {CORPUS_IMAGES} corpus JPEGs 640x480, "
          f"{len(queries)} DIOR queries 800x800 in "
          f"{time.perf_counter() - t0:.1f} s")

    ini = Init(device_mod.generator(0, dev), dev)
    vit_b32 = clip.ClipVisionConfig()      # the defaults are ViT-B/32's
    clip_p = clip.init_vision(vit_b32, ini)
    stem_p = resnet_stem.init(ini)
    n_params = sum(t.numel() for t in _leaves(clip_p)) + sum(
        t.numel() for t in _leaves(stem_p))
    clip_enc = encoders.ClipImageEncoder(clip_p, vit_b32,
                                         batch_size=32, device=dev)
    style_enc = encoders.StyleEncoder(stem_p, device=dev)
    print(f"retrieval encoders: CLIP ViT-B/32 + ResNet-50 stem, "
          f"{n_params / 1e6:.2f} M f32 params")

    x = rng.standard_normal((32, 224, 224, 3)).astype(np.float32)
    clip_enc.encode_arrays(x)
    t0 = time.perf_counter()
    for _ in range(5):
        clip_enc.encode_arrays(x)           # returns to the host: synced
    clip_rate = 5 * 32 / (time.perf_counter() - t0)
    px = torch.from_numpy(rng.random((32, 256, 256, 3), np.float32)).to(dev)
    style_ms = _ms(lambda: resnet_stem.style_features(stem_p, px), 10)

    results = str(root / "retrieval_results")
    t0 = time.perf_counter()
    feats, kept = retrieve.load_or_compute_source_features(
        results, "coco", corpus, clip_enc)
    corpus_s = time.perf_counter() - t0
    assert kept == corpus and feats.shape == (CORPUS_IMAGES, 512)
    t0 = time.perf_counter()
    encoders.StyleEncoder(stem_p, device=dev).encode_paths(corpus[:128])
    style_paths_rate = 128 / (time.perf_counter() - t0)

    g = torch.Generator(device=dev)
    g.manual_seed(7)

    def unit_rows(n):
        return torch.nn.functional.normalize(torch.randn(
            n, 512, generator=g, device=dev), dim=1).cpu().numpy()

    coco = np.concatenate([feats, unit_rows(COCO_ROWS - CORPUS_IMAGES)])
    paths = {"coco": corpus + [corpus[i % CORPUS_IMAGES] for i in
                               range(COCO_ROWS - CORPUS_IMAGES)],
             "miniimagenet": [corpus[i % CORPUS_IMAGES]
                              for i in range(MINI_ROWS)]}
    bank = retrieve.EmbeddingBank.from_sources(
        {"coco": coco, "miniimagenet": unit_rows(MINI_ROWS)}, paths,
        device=dev)
    del coco
    assert bank.features.shape == (TOPK_N, 512)
    assert bank.features.device.type == dev.type     # on the card
    assert bank.size == TOPK_N

    timer = StepTimer(sync=torch.cuda.synchronize)
    torch.cuda.reset_peak_memory_stats()
    tk.topk_ip_fused.launches = 0
    t0 = time.perf_counter()
    out = retrieve.run_retrieval(["DIOR"], [SHOTS], bank, clip_enc,
                                 style_enc, str(root / "lamainpaint"),
                                 results, RetrievalConfig(), timer=timer)
    stage_s = time.perf_counter() - t0
    default_launches = tk.topk_ip_fused.launches
    if default_launches != 0:
        raise AssertionError("the default first stage launched B8")
    qfeats = _check_retrieval(results, out, queries, corpus, mapping)

    tk.topk_ip_fused.launches = 0
    fused = retrieve.first_stage_topk(qfeats, bank, TOPK_K, use_pallas=True)
    launches = tk.topk_ip_fused.launches
    if launches != 1:
        raise AssertionError(f"first_stage_topk(use_pallas=True) launched "
                             f"B8 {launches} times, not once")
    rows["topk_ip_fused"]["launches"] = launches
    qt = torch.from_numpy(qfeats).to(dev)
    plain = tk.topk_ip(qt, bank.features, TOPK_K + 1)
    got = (torch.tensor([[r["similarity"] for r in row] for row in fused],
                        device=dev),
           torch.tensor([[r["index"] for r in row] for row in fused],
                        device=dev, dtype=torch.int32))
    _topk_close("first_stage_topk(use_pallas=True) vs the default route",
                got, plain, TOPK_K)
    default_ms = _ms(lambda: tk.topk_ip(qt, bank.features, TOPK_K), 10)
    fused_ms = _ms(lambda: tk.topk_ip_fused(qt, bank.features, TOPK_K), 10)
    n_q = len(queries)
    tot = timer.totals
    print(f"stage 2 (DIOR {SHOTS}-shot, {n_q} queries, bank {TOPK_N} x 512 f32 "
          f"on the card): run_retrieval {stage_s:.3f} s per dataset-shot "
          f"(encode {tot['encode']:.3f} s, search {tot['search']:.3f} s, "
          f"rerank {tot['rerank']:.3f} s = {tot['rerank'] / n_q:.4f} s per "
          f"query, write {tot['write']:.3f} s = {tot['write'] / n_q:.4f} s "
          f"per query); B8 launches {default_launches} in it, "
          f"{launches} for first_stage_topk(use_pallas=True); "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"stage 2 rates: CLIP encode {clip_rate:.1f} images/s at batch 32 "
          f"(device, preprocessed); corpus features {CORPUS_IMAGES} JPEGs "
          f"in {corpus_s:.3f} s = {CORPUS_IMAGES / corpus_s:.1f} images/s "
          f"(decode + preprocess + encode, through the cache); style "
          f"{32e3 / style_ms:.1f} images/s at batch 32 (device, 256 px), "
          f"{style_paths_rate:.1f} images/s from JPEG; first stage "
          f"{default_ms:.4f} ms by the default route, {fused_ms:.4f} ms by "
          f"B8 ({n_q} x {TOPK_N} x 512, k {TOPK_K})")
    print(f"stage 2 cuts: {CORPUS_IMAGES} real corpus images, the other "
          f"{TOPK_N - CORPUS_IMAGES} bank rows random unit vectors; random "
          f"weights; one dataset-shot (DIOR {SHOTS}-shot)")
    _profile_retrieval(bank, clip_enc, stem_p, root, results, dev)
    for pattern in ("*_visual.jpg", "*_*_retrieval_results.json"):
        for path in sorted(Path(results).glob(pattern))[2:]:
            path.unlink()        # checked; keeps OUT small
    shutil.rmtree(root / "coco")
    shutil.rmtree(root / "lamainpaint")
    del bank, clip_p, stem_p, clip_enc, style_enc, qt, plain
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    global PARENT
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: its B1-B3, "
                         "B5, B6 and B8 are built and timed beside this "
                         "commit's")
    PARENT = ap.parse_args().parent
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from domainrag_tpu_torch.core import device as device_mod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    dev = device_mod.resolve("cuda")
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev)
    rows.update(phase_mp_kernels(dev))
    rows.update(phase_flash_kernels(dev))
    rows.update(phase_int8_gemm(dev))
    rows.update(phase_int8_attention(dev))
    rows.update(phase_topk_kernel(dev))
    phase_retrieval(dev, rows)
    phase_small_slice(dev)
    phase_small_fill(dev)
    phase_small_int8(dev)
    bundle, sample, backgrounds, bf16_step = phase_slice(dev, rows)
    phase_profile(bundle, SIZE, "profile.txt")
    phase_slice_int8(bundle, sample, rows, backgrounds, bf16_step)
    phase_profile_int8(bundle, SIZE, "profile_int8.txt", rows, 3)
    del bundle                 # two ~46 GB bundles do not fit 80 GB
    gc.collect()
    torch.cuda.empty_cache()
    bundle, root, hires, fill_step = phase_compose(dev, rows, backgrounds)
    phase_profile(bundle, FILL_SIZE, "profile_fill.txt")
    phase_compose_int8(bundle, root, backgrounds, rows, hires, fill_step)
    phase_profile_int8(bundle, FILL_SIZE, "profile_fill_int8.txt", rows, 4)
    del bundle                 # the trainer needs the card to itself
    gc.collect()
    torch.cuda.empty_cache()
    phase_long_serving(dev, rows)
    phase_small_trainer(dev)
    cfg, params, batches = phase_train(dev, rows)
    phase_profile_train(dev, cfg, params, batches)
    phase_train_f32(dev, cfg, params, batches, rows)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())},
                     separators=(",", ":")))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

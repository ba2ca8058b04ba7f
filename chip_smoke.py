#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (domainrag_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

(``--parent DIR``, a checkout of the parent commit, builds the parent's
fused MMDiT kernels (B1-B3), generic flash kernels (B5, B6 in bf16 and
f32), W8A8 GEMM (B4) and fused top-k (B8) from its ``csrc/`` and times
each beside this commit's on the same inputs, in turns: parent, change,
change, parent; and the bf16 and f32 train steps with the parent's B6
in its place.)

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
   (``bound_ms``); then the LayerNorm + AdaLN-modulation kernel
   (``csrc/adaln.cu``) against the eager pair at the joint streams of the
   benchmark's batches (5 x 5337 and 5 x 17625 rows, width 3072): >=
   99.9% of the outputs bit-equal and the rest the modulation of a
   normalized value 1 bf16 ulp away, the same bits twice, timed in turns with the eager pair beside
   ``F.layer_norm`` alone and the bytes' bound (4 bytes an element); the
   stage phases check its launches (4 per double block, 1 per single
   block, 1 in the output layer, per forward);
4. the same for the multi-pass kernel (joint lengths above 17408) at the
   fill's lengths: 1241 + 16384 = 17625 tokens (2048 px) and 1241 +
   30625 = 31866 (the 2800 px cap), both variants at B = 1, and the
   single variant at B = 4 x 31866, whose element offsets pass 2^31
   (compared on its last batch element), each against the multi-pass
   plain version;
5. the generic flash kernels (B5 forward, the f32 one as bf16 terms on
   wgmma; B6 backward: one kernel in each dtype, the f32 one in 3xTF32)
   against their plain versions: a small
   causal + ``kv_valid`` case with ragged lengths in bf16 and f32, four
   ragged bf16 backward cases (RAGGED_BWD), the trainer's attention shape
   (2, 24, 4608, 128) in bf16 and f32 with each kernel's time beside the
   plain version's, SDPA's (forward, and its autograd backward for the B6
   rows) and the bound (B5 f32: six bf16 products per f32 product at the
   bf16 peak; B6: the least work, 10*B*H*S^2*D FLOP, at the bf16 peak,
   and in f32 three TF32 products per f32 product at the TF32 peak), and
   B5 above the multi-pass ceiling at (1, 24, 50393, 128) bf16, compared
   on two heads; every B6 call checked against its plain version (here,
   at a TP rank's shape and on the ring's blocks) runs twice, and the two
   runs' dq, dk and dv must be torch.equal (B6 adds dq over the kv blocks
   in ascending order); they run right after the MMDiT kernels, so that a
   fault in B5 or B6 fails the run within a few minutes;
6. the int8 kernels against their plain versions: the W8A8 GEMM (B4,
   K-major int8 weights; wgmma, gemv and mma instances) with torch.equal
   at every (M, K, N) of the stage-3 and stage-4 int8 paths and at ragged
   shapes, no row past M written, each path shape timed beside the plain
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
8. the run-time draws (``core.prng``, JAX's threefry2x32) on the card
   against the same draws on the CPU at the main path's shapes: the
   stage-4 noise at 2048 px (1 x 16384 x 64 f32), the trainer's t and
   eps at 2 x 4608 x 64 in bf16 and f32, a chain of 16 splits and the
   loader's picks (``choice`` with and without replacement): integers,
   keys, uniforms and bf16 normals torch.equal, f32 normals within
   ``PRNG_ULP`` (8) ulp and 2e-6; each draw's card and CPU time; then
   the random inits at full width (``phase_init_draws``): the first
   double and single block of ``full_bundle(PRNGKey(0))``'s MMDiT (f32)
   and its T5-XXL embedding (32128 x 4096), each drawn on the card and on
   the CPU from the same key, every leaf within ``INIT_ULP`` (3) f32 ulp;
   each ``full_bundle`` draw (stages 3 and 4) prints its seconds and GB/s
   where it is drawn, and the last lines before the result sum them;
9. stage 1 at big-lama width: ``BIG_LAMA`` (18 FFC blocks, ngf 64) drawn
   on the card, ``lama.apply`` on one 256x256 image on the card and on
   the CPU from the same weights within ``LAMA_BAR`` (1e-4 max abs on
   the [0, 1] output; both against an f64 run on the card, beside a TF32
   run, for the error's source), then ``inpaint.process_dataset`` on a
   synthetic DIOR 10-shot COCO dataset (200 images at 800x800, 20
   classes, 1-3 boxes each): the file tree, the manifest (all done) and
   ``category_mapping.json``, seconds per image and the load / mask /
   lama / save spans;
10. stage 2 at full width: a random CLIP ViT-B/32 and ResNet-50 stem
   (87.86 M f32 params) on the card, 512 synthetic corpus JPEGs through
   ``load_or_compute_source_features``, the bank filled with random unit
   rows to COCO train2017 + miniImageNet size (178287 x 512 f32, 365 MB),
   and ``run_retrieval`` on stage 1's DIOR 10-shot output (its 200
   inpainted queries and their ``category_mapping.json``, 20 classes)
   with the default config (top-100, re-rank 100,
   grids on): every artifact and JSON schema checked, no B8 launch on the
   default route, then ``first_stage_topk(use_pallas=True)`` on the same
   query features: one B8 launch, agreeing with the default route;
   encode rates, first-stage ms by both routes, re-rank seconds per query
   and seconds per dataset-shot; which renderer drew the grids; then the
   same dataset-shot once more under torch.profiler for the device's busy
   time and idle share (``OUT/profile_retrieval.txt``). The native library
   (``native/``, g++ into ``build/``) must build and serve every CLIP and
   style resize of the run (``imaging.resize_counts``: no PIL), and the
   host top-k ``topk_ip_native`` must agree with ``topk_ip`` on the bank
   at k 100, its host seconds printed; ``topk_ip_pallas`` (the JAX name
   of B8) torch.equal to ``topk_ip_fused`` on the stage's queries and
   bank at k 100, B8's counter moved by exactly one;
11. the stage-3 slice on a small input: a head_dim-128 toy bundle
   generates on the card (kernels) and on the CPU (plain versions) from
   the same weights and noise (the seeds' draws), and the images must
   agree;
12. the stage-4 fill on a small input: a head_dim-128 toy Fill bundle with
   the one-pass ceiling lowered (so the toy runs the multi-pass kernel)
   and the VAE tiled, on the card and on the CPU, from the same weights
   and noise; then the denoise caches on the same toy bundles, card
   against CPU within phase 11's bar: generate under the velocity cache
   at interval 2 (order 1 and 0) and the block cache at interval 2, and
   the tiled fill with an anchor tuple, each with the fused launches of
   the forwards the cache leaves;
13. the small int8 slices: both toy bundles quantized (every block
   linear), generate and the tiled multi-pass fill under W8A8 + int8 QK +
   int8 P.V, card against CPU, launch counts asserted;
14. the stage-3 slice at full width: a random FLUX.1-dev bundle (MMDiT,
   T5-XXL, CLIP-L, SigLIP so400m, Redux, VAE; ~46 GB) drawn on the card,
   and ``GenerateStage.generate_sample`` on a synthetic sample at
   1024x1024, cut to 4 denoise steps (stage default 50) and 2 ranks
   (default 5), denoised one rank at a time. It checks the written PNGs,
   that the image was finite before quantisation, and that every
   one-pass kernel ran 19 or 38 times per step per rank chunk (the
   multi-pass one never); the step's MFU (``eval.flops``); before it,
   ``models.flux.model.apply_rope`` (the JAX name of the rotation)
   torch.equal to ``rope_interleaved`` on a 1 x 24 x 5337 x 128 bf16
   tensor; then stage 3 repeats itself: ``pipeline.generate`` for one
   rank's prior at 1024 px, 2 steps, twice from the same seed, the
   latents torch.equal and the images equal;
15. stage 3's dataset sweep on the same bundle: ``process_dataset`` over
    stage 1's output with stage 2's ``all_shots_retrieval_results.json``
    as the refs, worker 0 of 100 (two samples), the same cuts; the run
    tree (``batch_params.txt`` header and totals, the manifest with both
    done, each sample's artifact set), the one-pass launch counts, and
    the first sample's rank PNGs byte-equal to a direct
    ``generate_sample`` on the same refs; seconds per sample with the
    writer thread beside the direct call's prior + denoise + save; then,
    in a one-rank NCCL group (NCCL refuses two ranks on one card), the
    same sweep over ``create_mesh()`` (``generate_samples_dp``) and
    without a mesh, the ranks batched alike: the same files, the rank
    PNGs byte-equal;
    the scale-out phase: the per-rank bodies of a 4-card mesh at full
    width, in turn on the one card (TP and the bank shards in threads
    whose collectives meet at a barrier, ``_ThreadMesh``): the SP ring of
    the 2800 px fill (31866 tokens as 4 blocks of 7967, the last
    ``kv_valid`` 7965) folded through ``ring_attention.ring_step``
    against the dense plain version, B5 16 launches and B3 none, then
    ``ring_attention`` over the group's mesh; sharded B8 (4 shards of
    44572 rows of the 200 x 178287 x 512 bank, k 100) through
    ``sharded_topk``, torch.equal to ``topk_ip`` on the whole bank, B8 4
    launches; one double and one single block at 5337 tokens
    tensor-parallel at n = 2 and 4, bf16 and W8A8, against the unsharded
    blocks (``TP_BAR``); the MMDiT's blocks as 4 pipeline chunks (5
    doubles with 1 zero block, 10 singles with 2) in ring order and
    ``pipelined_apply`` over the one-rank pipe mesh, torch.equal to
    ``apply``; each per-rank time beside the card's name and limit;
16. one full-width denoise step (batch 1, 1024 px) under
    ``torch.profiler``, its device time grouped into the attention
    kernels, the GEMMs and the rest (full table in ``profile.txt`` under
    ``OUT``, the script's output directory), with its MFU; then the same
    sample under each denoise cache (velocity 2, block 2, velocity
    "auto" and "sched:2", the last two calibrated once first), each with
    its launch counts (2 forwards per rank chunk at interval 2), seconds
    per step and per image, peak memory and the relative L2 to the dense
    images, and a CLIP-FID (``eval.fid``, random ViT-B/32) between the
    dense and the velocity-2 PNGs, which must be finite;
17. stage 3 under the CLI's ``--w8a8 --int8_qk``: the same bundle's MMDiT
    quantized (quantize_tree, 11.9 GB), the same sample; B4 314 and the
    one-pass B7 19 / 38 launches per step per rank chunk, the bf16 fused
    kernels never; seconds per step and the mean uint8 difference to the
    bf16 images (a report); one rank under the velocity cache at interval
    2 (B4 314 per model call, never per step); then one traced step with
    int8 P.V added (``OUT/profile_int8.txt``);
18. stage 4 at full width: the stage-3 bundle is freed and a random
   FLUX.1-Fill-dev bundle drawn (384 input channels), and
   ``compose.process_dataset`` runs a synthetic UODD 1-shot dataset (one
   1024x1024 sample, two bboxes) whose two backgrounds are phase 14's
   PNGs. UODD's parameters lift it to 2048x2048 (17625 tokens, the
   multi-pass regime), strength 0.4, guidance 30, the VAE tiled (9 tiles
   per encode and decode). Cuts: 10 steps (stage default 50, so 4 denoise
   steps instead of 20), 2 backgrounds (default 5), ``max_rank_batch``
   1. It checks every artifact, finiteness, and that the multi-pass
   kernel ran 19 or 38 times per step per background and the one-pass
   one never; before it, ``vae.encode_tiled(key=)`` on a 2048 px image
   in bf16 within 1e-3 (relative norm) of the blend of per-tile
   ``encode(key=)`` samples (JAX hands every tile the same key), and
   unequal to the mode;
19. one full-width fill denoise step (batch 1, 2048 px, 384 channels)
    under ``torch.profiler`` (full table in ``OUT/profile_fill.txt``),
    with its MFU; then the same dataset under the velocity cache at
    interval 2 (2 multi-pass forwards per background) and "auto"
    (calibrated on the fill core once first), launch counts asserted;
20. stage 4 under ``--w8a8 --int8_qk``: the Fill MMDiT quantized, the
    same dataset through ``compose.process_dataset``; B4 314 and the
    multi-pass B7 19 / 38 per step per background, B3 never; then one
    traced fill step with int8 P.V (``OUT/profile_fill_int8.txt``);
21. the Fill bundle is freed; the serving path above the multi-pass
    ceiling: both attention
    wrappers at 1241 + 49152 = 50393 joint tokens (a 4096x3072 image),
    where they take the unfused composition and so B5; launches counted
    on this run alone (B5 2, the fused kernels 0), heads 0-1 of each
    output against the plain B5 forward;
22. the CLI from a checkpoint tree on disk, at full width and depth
    (``phase_cli``): random weights drawn on the card by the port's inits,
    each tower from its own seed and both MMDiTs from one (the Fill
    MMDiT's blocks are the dev blocks), written in the published layouts as
    safetensors (written here, the format's inverse) under ``OUT``:
    ``flux-dev/`` and ``flux-fill/`` (bf16, through
    ``export_flux_to_diffusers``), ``vae/``, ``t5/`` (T5-XXL, bf16),
    ``clip-text/``, ``siglip/``, ``redux/``, ``clip-vision/``,
    ``resnet-stem/`` and ``lama/`` (big-lama, ordered leaves), about 37 GB
    written (the Fill MMDiT links the dev MMDiT's block shards: the run's
    disk writes stay under 45 GiB), 61 GB as the loader reads it;
    then ``cli.main(["pipeline", "--checkpoints", ...])`` in this process
    on a synthetic UODD 1-shot sample (phase 18's) and CLI_CORPUS corpus
    JPEGs, CLI_STEPS steps: before the stages run, every converted leaf
    equals the drawn one (drawn again from its key, JAX shape, scale and
    dtypes; ``torch.equal``, bf16 -> bf16, bf16 -> f32 for T5, f32 ->
    f32), the Fill MMDiT's blocks equal the dev bundle's, and the two
    bundles hold the same tower tensors; after, every stage's
    artifacts, the four ``stage/*`` timings, and B1/B2 19 / 38 launches
    per step per rank, B3 19 / 38 per denoise step per background and no
    other kernel; then ``generate --w8a8 --int8_qk`` from the same tree
    (B4 314 per forward, one-pass B7 19 / 38, no bf16 fused kernel); load
    seconds per subtree, peak host RSS, card memory and seconds per stage
    and per image, beside the card's name and power limit; the tree is
    deleted, pass or fail;
23. a small trainer card vs CPU: a head_dim-128 toy MMDiT (hidden 256,
    one double and one single block) at 128 px, three ``train_step``s
    from the same weights, batches and keys (t and eps drawn on each
    side from ``fit``'s key walk), with bf16 and with f32
    batches, both computed in f32 (a bf16 batch is promoted, as JAX's
    flow_match_loss promotes it), losses, first-step gradients and
    updates within stated limits, compute dtype and launch counts
    asserted;
24. the trainer at FLUX.1-dev width cut in depth to 2 double + 4 single
    blocks (default 19 + 38; 1.31 B f32 params drawn on the card):
    ``train.loop.fit`` with remat for 4 steps on synthetic bf16 batches
    (batch 2, 1024 px = 4096 image tokens, 512 T5 tokens), one checkpoint
    written at the end under ``OUT`` and restored (then deleted); finite
    losses, changed params, compute dtype float32 and the launch counts
    per step (B5 f32 12, B6 f32 6; B1, B2, B3 and B6 bf16 0), which the
    f32 kernel rows take, seconds per step, peak memory, checkpoint
    time; then one step through ``train_step`` (JAX's name) and one
    through ``make_train_step``'s step from the same params and key:
    losses and every updated leaf torch.equal;
25. one traced full-width train step (``OUT/profile_train.txt``), grouped
    into the fused forward, B5, B6 (with its dq_accum zeroing, scale and
    cast), GEMMs, the optimizer and the rest;
26. one full-width ``fit`` step on f32 batches (the dtype
    ``latent_batches_from_images`` yields), the same computation as a
    bf16 batch's: no fused kernel, B5 12 and B6 f32 6 launches, finite
    loss, changed params; with ``--parent``, four steady f32 steps timed
    in turns, the parent's B6 in two (and after phase 25, four bf16-batch
    steps the same way);
27. training over a mesh (``phase_train_mesh``): ``fit(mesh=
    create_mesh(), fsdp=True)`` on the one-rank NCCL group against the
    one-card step from the same params, batches and seed, run twice (2
    steps: both losses and every leaf torch.equal across the three runs);
    a TP train step at 2 ranks in
    threads (full width cut to 1 + 1 blocks; the gathered gradients
    against the unsharded step's on the same kernels), then rank 0 of 4
    (6 of 24 heads) alone at the trainer's cut on a bf16 batch
    (computed in f32), forward + backward ms and B5 12 / B6 f32 6
    launches, with B5 and B6 rows at its shape in f32 and bf16; an FSDP
    rank of 4 alone (its params, gradients and AdamW bytes against the
    whole, its step's time and its launches); the ring's gradient at the
    trainer's 4608 tokens over 4 ranks, in f32 and in bf16: B5 and B6
    with the LSE's gradient against their plain versions on a 1152-key
    block and a ragged one (B6 rows with kernel, plain and SDPA-backward
    times), every rank's fold differentiated in turn and gathered
    against autograd of f32 dense attention, with exact B5 / B6 counts;
    ``ops/image.py`` on the card against the CPU;

Then a ``{"kernels": [...]}`` line and, last, the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
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
           "int8_attention", "topk", "adaln")
# LayerNorm + modulation rows: (name, batch, joint-stream rows, the
# stage's denoise steps per image at its defaults: 50; 50 x strength 0.4)
ADALN_ROWS = (("adaln_modulate_s5337", 5, S_TXT + (SIZE // 16) ** 2, 50),
              ("adaln_modulate_s17625", 5, S_TXT + (FILL_SIZE // 16) ** 2,
               20))
PARENT = None             # --parent DIR: a checkout of the parent commit
CARD = None               # the card's name and power limit (nvidia-smi)
DRAWS = {}                # full_bundle's draws: stage -> seconds, GB


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


def _drawn_bundle(fp, seed, fill, stage):
    """``full_bundle(PRNGKey(seed), fill)`` on the card, its draw timed:
    every leaf through ``core.prng`` (JAX's threefry), as JAX's inits
    draw it."""
    import torch
    from domainrag_tpu_torch.core import prng
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = fp.full_bundle(prng.PRNGKey(seed), fill)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    trees = [getattr(bundle, f.name) for f in dataclasses.fields(bundle)
             if f.name.endswith("_params")]
    n = sum(t.numel() for tree in trees for t in _leaves(tree))
    gb = _weight_bytes(bundle) / 1e9
    print(f"full_bundle draw ({stage}, {bundle.flux_cfg.in_channels} MMDiT "
          f"input channels): {gb:.2f} GB of weights, {n / 1e9:.3f}e9 "
          f"elements drawn on the card through core.prng in {seconds:.1f} s"
          f" ({gb / seconds:.2f} GB/s of weights, {n / seconds / 1e9:.3f}e9 "
          f"elements/s; {CARD})")
    DRAWS[stage] = {"seconds": seconds, "gb": gb, "elements": n}
    return bundle


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
        if path.name.startswith(("libmmdit_attention", "libflash_attention",
                                 "libint8_gemm")):
            _wgmma_report(path)


# kernels that must run on wgmma: name in the SASS -> (the wgmma opcode it
# must hold, the mma.sync opcode it must not): the shared bf16 forward's
# instances (flash_fwd.cuh: B1-B3, B5 bf16), B5 f32 and B4's wgmma instance
WGMMA = {"fwd_kernel": ("HGMMA", "HMMA"), "fwd_f32_kernel": ("HGMMA", "HMMA"),
         "w8a8_wgmma_kernel": ("IGMMA", "IMMA")}


def _wgmma_report(lib):
    """Each kernel of ``WGMMA`` in ``lib``: its registers and spills (the
    ptxas log) and its wgmma / mma.sync instruction counts (the SASS).
    Raises unless every such kernel runs on wgmma and none on mma.sync."""
    def kind(name):
        return next((k for k in WGMMA if re.search(rf"\d{k}", name)), None)

    ptxas, name = {}, None
    for line in lib.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and kind(name):
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
        elif name and kind(name):
            gmma, mma = WGMMA[kind(name)]
            counts[name][0] += gmma in line
            counts[name][1] += bool(re.search(rf"\b{mma}\b", line))
    found = [n for n in counts if kind(n)]
    if not found:
        raise AssertionError(f"{lib.name}: no kernel that must run on wgmma")
    for n in found:
        info = ptxas.get(n, {})
        gmma, mma = WGMMA[kind(n)]
        print(f"wgmma kernel {n}: {info.get('registers')} registers, spill "
              f"stores/loads {info.get('spills')} bytes; SASS {gmma} "
              f"{counts[n][0]}, {mma} {counts[n][1]}")
        if counts[n][0] == 0 or counts[n][1]:
            raise AssertionError(f"{n}: expected wgmma ({gmma}) and no "
                                 f"mma.sync ({mma})")


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


def _bf16_step(t, k):
    """t moved ``k`` bf16 ulps (the bit patterns ordered as integers)."""
    import torch
    u = t.view(torch.int16).to(torch.int32) & 0xFFFF
    o = torch.where(u >= 0x8000, 0x8000 - u, u) + k
    u = torch.where(o < 0, 0x8000 - o, o)
    return torch.where(u >= 0x8000, u - 0x10000, u).to(
        torch.int16).view(torch.bfloat16)


def phase_adaln(dev):
    """The LayerNorm + modulation kernel against the eager pair
    (``_modulate(_ln_no_affine(x), shift, scale)``) at the joint stream of
    each benchmark batch, shift and scale the .chunk views of a (B, 6h)
    modulation: >= 99.9% of the outputs bit-equal, every other one the
    eager modulation of a normalized value 1 bf16 ulp from the eager one
    (the f32 sums' order reaches the output through that rounding alone),
    two runs torch.equal; then timed in turns with the eager pair
    (plain, kernel, kernel, plain), beside ``F.layer_norm`` alone (a
    yardstick: no modulation) and the bytes' bound."""
    import torch
    import torch.nn.functional as F
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import adaln

    hd = HEADS * HD
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    rows = {}
    for name, batch, s, _ in ADALN_ROWS:
        x = (3.0 * torch.randn(batch, s, hd, generator=g, device=dev)
             + 0.5).to(torch.bfloat16)
        shift, scale = (0.5 * torch.randn(batch, 6 * hd, generator=g,
                                          device=dev)).to(
            torch.bfloat16).chunk(6, dim=-1)[:2]

        def kernel():
            return adaln.ln_modulate(x, shift, scale)

        def plain():
            return fm._modulate(fm._ln_no_affine(x), shift, scale)

        got, again = kernel(), kernel()
        n = fm._ln_no_affine(x)
        same = got.view(torch.int16) == fm._modulate(n, shift, scale).view(
            torch.int16)
        near = same.clone()
        for k in (1, -1):
            near |= got == fm._modulate(_bf16_step(n, k), shift, scale)
        equal = same.float().mean().item()
        off, moved = (~near).sum().item(), (near & ~same).sum().item()
        print(f"kernel {name}: {equal:.7f} of {got.numel()} outputs "
              f"bit-equal to the eager pair, {moved} the "
              f"modulation of a normalized value 1 ulp away, {off} "
              f"neither; repeat torch.equal {torch.equal(got, again)}")
        if equal < 0.999 or off or not torch.equal(got, again):
            raise AssertionError(f"{name} disagrees with the eager pair")
        del got, again, n, same, near
        turns = [_ms(plain, 10), _ms(kernel, 50), _ms(kernel, 50),
                 _ms(plain, 10)]
        row = {"name": name, "route": "cuda",
               "source": "domainrag_tpu_torch/csrc/adaln.cu",
               "replaces": "none (XLA fuses models/flux/model.py "
                           "_ln_no_affine + _modulate)",
               "launches": 0, "equal_share": equal,
               "ms": (turns[1] + turns[2]) / 2,
               "plain_ms": (turns[0] + turns[3]) / 2,
               "library_ms": _ms(lambda: F.layer_norm(x, (hd,), eps=1e-6),
                                 50),
               "bound_ms": 4 * x.numel() / PEAK_BYTES * 1e3,
               "bound_by": "bytes"}
        print(f"kernel {name} ({batch}x{s}x{hd}): turns plain / kernel / "
              f"kernel / plain {' / '.join(f'{t:.4f}' for t in turns)} ms; "
              f"F.layer_norm alone {row['library_ms']:.4f} ms; bound_ms "
              f"{row['bound_ms']:.4f} (bytes), the kernel at "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of it ({CARD})")
        rows[name] = row
        del x, shift, scale
    return rows


def _adaln_launches(rows, regime, cfg, passes, replays=0):
    """The LayerNorm + modulation kernel ran once per site per pass (4 per
    double block, 1 per single block, 1 in the output layer) and once per
    block-cache replay (the output layer alone); writes the launches per
    image at the stage's default steps into the stage's row."""
    from domainrag_tpu_torch.ops import adaln
    per_forward = 4 * cfg.depth_double + cfg.depth_single + 1
    got = adaln.ln_modulate.launches
    print(f"launches on the path: LayerNorm + modulation {got} (expected "
          f"{per_forward} x {passes} passes + {replays} replays)")
    if got != per_forward * passes + replays:
        raise AssertionError("LayerNorm + modulation launches differ from "
                             "the path")
    name, _, _, steps = ADALN_ROWS[regime == "multi-pass"]
    if name in rows:
        rows[name]["launches"] = per_forward * steps


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
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import pipeline as fp
    cfgs = fp.tiny_configs(fill)
    cfgs["flux_cfg"] = dataclasses.replace(
        cfgs["flux_cfg"], hidden=256, heads=2, head_dim=128, depth_double=2,
        depth_single=2, axes_dim=(16, 56, 56))
    return fp._random_bundle(cfgs, prng.PRNGKey(7), torch.device("cpu"),
                             torch.bfloat16, torch.bfloat16,
                             **fp.tiny_tokenizers(cfgs))


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
    noise = fp._noise(cpu, [3, 30], seq, cpu.vae_cfg.latent_channels * 4)
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
    noise = fp._noise(cpu, [4], seq, cpu.vae_cfg.latent_channels * 4)
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


def _model_calls(form, n_steps):
    """MMDiT forwards of an ``n_steps`` denoise under a resolved cache
    form: every step (1), the anchors of an interval (ceil(n / k)), or of
    an anchor tuple. A block-cache interval k refreshes ceil(n / k) times,
    and only a refresh runs the blocks' attention."""
    if isinstance(form, tuple):
        return len(form)
    return math.ceil(n_steps / form) if form > 1 else n_steps


def phase_small_caches(dev):
    """The denoise caches on small inputs, card against CPU: the
    head_dim-128 toy bundles of phases 11 and 12 generate under the
    velocity cache at interval 2 (order 1 and 0) and the block cache at
    interval 2, and fill with an anchor tuple (the one-pass ceiling
    lowered and the VAE tiled, as phase 12), from the same weights and
    noise; phase 11's bar. The card's fused-kernel launches are the
    forwards the cache leaves (the block cache's cached steps launch
    none)."""
    import torch
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.models.flux import scheduler as sched
    from domainrag_tpu_torch.ops import mmdit_attention as mma

    def launches():
        d = mma.mmdit_double_attention
        return d.launches + d.mp_launches

    cpu = _small_bundle(dev)
    card = _to_card(cpu, dev)
    uniq = np.random.default_rng(1).uniform(
        -1, 1, (3, 28, 28, 3)).astype(np.float32)
    pairs = np.asarray([[0, 2], [1, 2]])
    size, steps = 64, 4
    seq = (size // cpu.latent_factor) ** 2
    noise = fp._noise(cpu, [3, 30], seq, cpu.vae_cfg.latent_channels * 4)
    cases = (("velocity 2, order 1", dict(vcache_interval=2), 2),
             ("velocity 2, order 0", dict(vcache_interval=2,
                                          vcache_order=0), 2),
             ("block 2", dict(cache_interval=2), 2))
    for name, kw, calls in cases:
        images = []
        for bundle in (card, cpu):
            e, p = fp.redux_prior_pairs_indexed(bundle, uniq, pairs, "",
                                                [0.8, 1.0], [1.0, 1.0])
            before = launches()
            with torch.inference_mode():
                images.append(fp._generate_float(
                    bundle, e, p, size, size, steps, 2.5, noise, **kw
                ).float().cpu())
            if bundle is card:
                n = launches() - before
        _small_verdict(f"small generate, {name}", images, size, steps, n,
                       calls * card.flux_cfg.depth_double)

    cpu = _small_bundle(dev, fill=True)
    card = _to_card(cpu, dev)
    rng = np.random.default_rng(2)
    steps, strength, anchors = 6, 1.0, (0, 1, 4)
    image = fp.from_uint8(rng.integers(0, 255, (1, size, size, 3), np.uint8))
    mask = np.ones((1, size, size), np.float32)
    mask[:, 16:40, 8:30] = 0.0
    px = rng.uniform(-1, 1, (1, 1, 28, 28, 3)).astype(np.float32)
    noise = fp._noise(cpu, [4], seq, cpu.vae_cfg.latent_channels * 4)
    sigmas = torch.as_tensor(sched.make_schedule(
        steps, image_seq_len=seq, strength=strength).sigmas)
    gate = mma._MAX_ONEPASS
    mma._MAX_ONEPASS = 64
    try:
        images = []
        for bundle in (card, cpu):
            e, p = fp.redux_prior_pairs(bundle, px, "", [1.0], [1.0])
            dt, d = bundle.compute_dtype, bundle.device
            before = launches()
            with torch.inference_mode():
                images.append(fp._fill_float(
                    bundle, torch.as_tensor(image, device=d).to(dt),
                    torch.as_tensor(mask, device=d).to(dt),
                    noise.to(device=d, dtype=dt), e, p, sigmas.to(d), 30.0,
                    hires=True, vae_tile=12, vae_overlap=4,
                    vcache_interval=anchors).float().cpu())
            if bundle is card:
                n = launches() - before
    finally:
        mma._MAX_ONEPASS = gate
    _small_verdict(f"small fill, anchors {anchors}", images, size, steps, n,
                   len(anchors) * card.flux_cfg.depth_double)


def _small_verdict(what, images, size, steps, launches, want):
    import torch
    diff = (images[0] - images[1]).abs()
    print(f"{what} ({size} px, {steps} steps, head_dim 128): card vs CPU "
          f"image max abs diff {diff.max().item():.3e} mean "
          f"{diff.mean().item():.3e}; double-block launches on the card "
          f"{launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{what}: launch counts differ")
    if not (bool(torch.isfinite(images[0]).all())
            and diff.mean().item() < 7e-3 and diff.max().item() < 5e-2):
        raise AssertionError(f"{what}: card and CPU images disagree")


def _rope_jax_name(dev):
    """``models.flux.model.apply_rope``, the JAX name of the interleaved
    rotation, on a 1 x HEADS x (S_TXT + 4096) x HD bf16 tensor with the
    stage's rope tables: torch.equal to ``rope_interleaved``."""
    import torch
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops.mmdit_attention import rope_interleaved
    cos, sin = _rope_tables(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    x = torch.randn((1, HEADS, cos.shape[0], HD), generator=g,
                    device=dev).to(torch.bfloat16)
    if not torch.equal(fm.apply_rope(x, cos, sin),
                       rope_interleaved(x, cos, sin)):
        raise AssertionError("apply_rope differs from rope_interleaved")
    print(f"apply_rope (the JAX name of the rotation): torch.equal to "
          f"rope_interleaved at {tuple(x.shape)} bf16")


def phase_slice(dev, rows):
    import torch
    from PIL import Image
    from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                                 GenerateConfig, ReduxConfig)
    from domainrag_tpu_torch.models.flux import pipeline as fp

    print(f"slice cuts: {STEPS} denoise steps (stage default 50), {RANKS} "
          f"ranks (stage default 5), max_rank_batch {MAX_RANK_BATCH}, "
          f"{SIZE}x{SIZE}")
    bundle = _drawn_bundle(fp, 0, False, "stage 3")

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
    _rope_jax_name(dev)
    paths, step, _ = _run_slice(bundle, sample, rows, "sample0", int8=False)
    print(f"stage 3 MFU: {_mfu(bundle.flux_cfg, (SIZE // 16) ** 2, step):.4f}"
          f" of the dense bf16 peak at {step:.3f} s per step "
          f"(eval.flops, {CARD})")
    return bundle, sample, paths, step


REPEAT_STEPS = 2          # the serving repeat's cut


def phase_slice_repeat(bundle, sample):
    """Stage 3 repeats itself: ``pipeline.generate`` for the sample's first
    rank (its Redux prior computed once) at SIZE px, REPEAT_STEPS steps,
    twice from the same seed; the denoised latents (the decode's input)
    must be torch.equal and the uint8 images equal."""
    import torch
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.stages.generate import GenerateStage
    target, refs, cfg = sample
    t0 = time.perf_counter()
    embeds, pooled = GenerateStage(bundle, cfg)._priors_for_sample(
        refs[:1], target)
    s = cfg.sampling
    latents = []
    decode = fp._decode_tokens

    def keep(vae_params, tokens, *args, **kwargs):
        latents.append(tokens.clone())
        return decode(vae_params, tokens, *args, **kwargs)

    images = []
    fp._decode_tokens = keep
    try:
        for _ in range(2):
            images.append(fp.generate(
                bundle, embeds, pooled, height=s.height, width=s.width,
                num_steps=REPEAT_STEPS, guidance=s.guidance_scale,
                seed=[s.seed], scheduler_overrides={
                    "use_dynamic_shifting": s.use_dynamic_shifting,
                    "base_shift": s.base_shift, "max_shift": s.max_shift}))
    finally:
        fp._decode_tokens = decode
    torch.cuda.synchronize()
    same = torch.equal(latents[0], latents[1])
    print(f"stage 3 repeat: one rank, {s.height} px, {REPEAT_STEPS} steps, "
          f"seed {s.seed}, twice: latents {tuple(latents[0].shape)} "
          f"torch.equal {same}, images equal "
          f"{np.array_equal(images[0], images[1])}, "
          f"{time.perf_counter() - t0:.2f} s in all ({CARD})")
    if not (same and np.array_equal(images[0], images[1])
            and bool(torch.isfinite(latents[0]).all())):
        raise AssertionError("stage 3 does not repeat itself from the same "
                             "seed")


def _run_slice(bundle, sample, rows, out_name, int8, calls=STEPS,
               replays=0):
    """``GenerateStage.generate_sample`` on the synthetic sample, with the
    launch counts of the path read just after (bf16: B1/B2; int8: B4 and
    the one-pass B7): ``calls`` MMDiT forwards per rank chunk, and
    ``replays`` that run the output layer alone. Returns the PNG paths,
    seconds per step and the timer."""
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
    chunks = math.ceil(len(refs) / MAX_RANK_BATCH)
    if int8:
        _read_i8_counts(mma, rows, "one-pass", bundle.flux_cfg,
                        calls * chunks, S_TXT, (SIZE // 16) ** 2)
    else:
        _read_counts(mma, rows, "one-pass", bundle.flux_cfg, calls * chunks,
                     replays * chunks)

    if len(paths) != len(refs):
        raise AssertionError(f"{len(paths)} images for {len(refs)} ranks")
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
    return paths, mean["step"], timer


def _mfu(cfg, s_img, seconds, batch=1):
    """Model FLOP utilization of one MMDiT forward of ``seconds`` at the
    card's dense bf16 peak (``eval.flops``; S_TXT text tokens)."""
    from domainrag_tpu_torch.eval import flops
    return flops.mfu(flops.flux_forward_flops(cfg, s_img, S_TXT,
                                              batch).total, seconds)


def _rel_l2(paths, ref_paths):
    """Mean over the images of ||a - b|| / ||b||, on the PNGs' values."""
    from PIL import Image
    rels = []
    for a, b in zip(paths, ref_paths):
        x = np.asarray(Image.open(a), np.float64)
        y = np.asarray(Image.open(b), np.float64)
        rels.append(np.linalg.norm(x - y) / (np.linalg.norm(y) or 1.0))
    return float(np.mean(rels))


SLICE_CACHES = (("velocity 2", dict(velocity_cache_interval=2)),
                ("block 2", dict(block_cache_interval=2)),
                ("velocity auto", dict(velocity_cache_interval="auto")),
                ("velocity sched:2", dict(velocity_cache_interval="sched:2")))


def _resolved(table, bundle, tag):
    """The calibration ``table`` (a pipeline dict) holds for ``bundle``
    under the key tag ``tag``."""
    from domainrag_tpu_torch.models.flux import pipeline as fp
    token = fp._params_token(bundle)
    (value,) = [v for k, v in table.items() if k[0] is token and tag in k]
    return value


def phase_slice_caches(bundle, sample, dense_paths, dense_step):
    """Stage 3 at full width under each denoise cache (SLICE_CACHES):
    the same sample through ``generate_sample``. "auto" and "sched:2"
    calibrate in a first call (its ``calibrate`` seconds); every mode's
    counted run asserts the one-pass launches of the forwards it leaves
    (interval 2 at 4 steps: 2 per rank chunk, B1 38 and B2 76 per chunk;
    the block cache's refreshes at steps 0 and 2 the same). Seconds per
    step and per image beside the dense run, peak memory, and the
    relative L2 of the images to the dense ones (a report: random
    weights). Returns the velocity-2 PNGs."""
    import torch
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.stages.generate import GenerateStage

    target, refs, cfg = sample
    keep = None
    for name, kw in SLICE_CACHES:
        s_cfg = dataclasses.replace(cfg, sampling=dataclasses.replace(
            cfg.sampling, **kw))
        tag = name.replace(" ", "_").replace(":", "")
        form = next(iter(kw.values()))
        calib = ""
        if isinstance(form, str):
            timer = StepTimer(sync=torch.cuda.synchronize)
            GenerateStage(bundle, s_cfg).generate_sample(
                "sample0", target, refs, str(OUT / f"calib_{tag}"),
                timer=timer)
            shutil.rmtree(OUT / f"calib_{tag}")
            form = (_resolved(fp._BLOCK_CACHE_CALIBRATIONS, bundle,
                              "velocity") if form == "auto" else
                    _resolved(fp._VCACHE_SCHEDULES, bundle,
                              "velocity-sched"))
            calib = (f"calibration {timer.totals['calibrate']:.3f} s once "
                     f"-> {form}; ")
        calls = _model_calls(form, STEPS)
        paths, step, timer = _run_slice(
            bundle, (target, refs, s_cfg), {}, f"sample0_{tag}", int8=False,
            calls=calls,
            replays=STEPS - calls if "block_cache_interval" in kw else 0)
        per_image = timer.totals["denoise"] / len(paths)
        print(f"stage 3 cache {name}: {calib}{step:.3f} s per denoise step "
              f"averaged (dense {dense_step:.3f}), {per_image:.3f} s per "
              f"image (denoise + decode), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; image "
              f"rel L2 to the dense images {_rel_l2(paths, dense_paths):.4f}"
              f" (a report: random weights; {CARD})")
        if name == "velocity 2":
            keep = paths
        else:
            shutil.rmtree(OUT / f"sample0_{tag}")
    return keep


def phase_fid(dense_paths, cached_paths, dev):
    """A CLIP-FID (``eval.fid.fid_from_paths``) on a random ViT-B/32 on
    the card between the dense stage-3 PNGs and the velocity-cached ones
    of the same sample: finite, printed, not judged."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.eval import fid
    from domainrag_tpu_torch.models import clip
    from domainrag_tpu_torch.stages import encoders
    vit = clip.ClipVisionConfig()
    enc = encoders.ClipImageEncoder(
        clip.init_vision(prng.PRNGKey(3, device=dev), vit), vit, device=dev)
    t0 = time.perf_counter()
    value = fid.fid_from_paths(dense_paths, cached_paths, enc)
    print(f"CLIP-FID (random ViT-B/32 on the card) dense vs velocity-2 "
          f"stage-3 images ({len(dense_paths)} each): {value:.4f} in "
          f"{time.perf_counter() - t0:.3f} s ({CARD})")
    if not math.isfinite(value):
        raise AssertionError("CLIP-FID is not finite")
    del enc
    torch.cuda.empty_cache()


BATCH_WORKERS = 100       # worker 0's round-robin share: 2 of 200 samples


def phase_generate_batch(bundle, sample):
    """Stage 3's dataset sweep on the full-width bundle: ``process_dataset``
    over stage 1's DIOR 10-shot output with stage 2's
    ``all_shots_retrieval_results.json`` as the refs, worker 0 of
    BATCH_WORKERS (two samples), the slice's cuts (RANKS ranks, STEPS
    steps, one rank at a time). It checks the run tree
    (``batch_params.txt`` header and totals, the worker's manifest with
    both done, each sample's artifact set), that the one-pass kernels ran
    19 / 38 times per step per rank chunk of each sample, and that the
    first sample's rank PNGs are byte-equal to a direct
    ``generate_sample`` on the same refs; seconds per sample with the
    writer thread beside the direct call's prior + denoise + save."""
    import shutil
    import torch
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.stages import generate as gen

    _, _, cfg = sample
    with open(STAGE_ROOT / "retrieval_results"
              / "all_shots_retrieval_results.json") as f:
        rr = json.load(f)
    lama_dir = str(STAGE_ROOT / "lamainpaint")
    out = OUT / "stage3_batch"
    shutil.rmtree(out, ignore_errors=True)
    stage = gen.GenerateStage(bundle, cfg)
    timer = StepTimer(sync=torch.cuda.synchronize)
    _reset_counts(mma)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counters = gen.process_dataset(stage, "DIOR", SHOTS, rr, lama_dir,
                                   str(out), run_name="run", worker_id=0,
                                   num_workers=BATCH_WORKERS, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chunks = math.ceil(RANKS / MAX_RANK_BATCH)
    _read_counts(mma, {}, "one-pass", bundle.flux_cfg, 2 * STEPS * chunks)
    if counters != {"processed": 2, "failed": 0, "skipped": 0,
                    "fallback": 0}:
        raise AssertionError(f"stage 3 batch counters {counters}")
    samples = ["00000", f"{BATCH_WORKERS:05d}"]
    base = out / "result" / f"DIOR_{SHOTS}shot_retrieval" / "run"
    if sorted(p.name for p in base.iterdir()) != sorted(
            ["batch_params.txt", "manifest.worker0.json"] + samples):
        raise AssertionError(f"stage 3 run tree: {sorted(base.iterdir())}")
    text = (base / "batch_params.txt").read_text()
    for line in ("dataset: DIOR", f"num_inference_steps: {STEPS}",
                 "num_samples: 2", f"images_per_sample: up to {RANKS}",
                 f"image_size: {SIZE}x{SIZE}", "[worker0]",
                 "succeeded_samples: 2", "failed_samples: 0",
                 f"total_generated_images: {2 * RANKS}",
                 f"  - {SIZE}x{SIZE}: {2 * RANKS} images", "completed: "):
        if line not in text:
            raise AssertionError(f"batch_params.txt lacks {line!r}")
    with open(base / "manifest.worker0.json") as f:
        records = json.load(f)["samples"]
    if {k: r["status"] for k, r in records.items()} != dict.fromkeys(
            samples, "done"):
        raise AssertionError(f"stage 3 manifest {records}")
    for sid in samples:
        refs = gen.top_ranked_refs(rr, "DIOR", SHOTS, sid, RANKS)
        names = sorted(p.name for p in (base / sid).iterdir())
        want = sorted(
            [f"generated_image_rank{r}.png" for r in range(1, RANKS + 1)]
            + [f"ref_inputrank{r}.jpg" for r in range(1, RANKS + 1)]
            + [f"ref_inforank{r['rank']}_sim{r['similarity']:.4f}.txt"
               for r in refs] + ["params.txt", "target_input.png"])
        if names != want:
            raise AssertionError(f"stage 3 sample {sid}: {names}")

    refs = gen.top_ranked_refs(rr, "DIOR", SHOTS, samples[0], RANKS)
    direct = StepTimer(sync=torch.cuda.synchronize)
    paths = stage.generate_sample(
        samples[0], str(Path(lama_dir) / "DIOR" / f"{SHOTS}_shot"
                        / f"{samples[0]}.jpg"),
        refs, str(OUT / "stage3_direct"), timer=direct)
    for p in paths:
        a = Path(p).read_bytes()
        b = (base / samples[0] / Path(p).name).read_bytes()
        if a != b:
            raise AssertionError(f"stage 3: {Path(p).name} of the dataset "
                                 "sweep differs from generate_sample's")
    direct_s = sum(direct.totals[k] for k in ("prior", "denoise", "save"))
    print(f"stage 3 dataset sweep (DIOR {SHOTS}-shot refs from stage 2, "
          f"worker 0 of {BATCH_WORKERS}: 2 samples x {RANKS} ranks, {STEPS} "
          f"steps, {SIZE} px): process_dataset {wall:.3f} s = "
          f"{wall / 2:.3f} s per sample with the writer thread; direct "
          f"generate_sample prior + denoise + save {direct_s:.3f} s (save "
          f"{direct.totals['save']:.3f} s); spans "
          f"{ {k: round(v, 3) for k, v in timer.totals.items()} }; rank "
          f"PNGs byte-equal to the direct call's ({CARD})")
    shutil.rmtree(out)
    shutil.rmtree(OUT / "stage3_direct")
    _stage3_mesh(bundle, cfg, rr, lama_dir)
    shutil.rmtree(STAGE_ROOT)        # stages 1 and 2's trees: checked


def _reset_counts(mma):
    from domainrag_tpu_torch.ops import adaln
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.ops import int8_gemm
    adaln.ln_modulate.launches = 0
    for wrapper in (mma.mmdit_double_attention, mma.mmdit_single_attention):
        wrapper.launches = wrapper.mp_launches = 0
        wrapper.i8_launches = wrapper.i8_mp_launches = 0
    f = attn.flash_attention
    f.launches = f.bwd_launches = f.bwd_f32_launches = 0
    f.bwd_launches_by_shape = {}
    int8_gemm.w8a8_linear.launches = 0
    int8_gemm.w8a8_linear.launches_by_shape = {}
    int8_gemm.w8a8_linear.launches_by_instance = {}


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


def _flash_launches(rows, counts):
    """Writes a trainer run's B5 and B6 f32 counts (``_flash_counts``) into
    the f32 rows at the trainer's attention shape, and no other row: the
    trainer computes in f32 for a batch of any dtype."""
    rows[f"flash_fwd_f32_b{TRAIN_B}_s{S_TRAIN}"]["launches"] = counts[0]
    rows[f"flash_bwd_f32_b{TRAIN_B}_s{S_TRAIN}"]["launches"] = counts[2]


def _read_counts(mma, rows, regime, depth, passes, replays=0):
    """The launch counts of a path's run: the regime's kernel ran once per
    block per pass (19 double and 38 single blocks), the other regime's
    never; ``replays`` forwards ran the output layer alone (a block
    cache's). Writes them into the regime's rows."""
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
    _adaln_launches(rows, regime, depth, passes, replays)
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
        if re.search(r"w8a8_(wgmma|gemv|mma)_kernel", name):
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
    print(f"profile MFU (eval.flops, dense bf16 peak): "
          f"{_mfu(cfg, grid * grid, wall_ms / 1e3):.4f} on the untraced wall "
          f"time, {_mfu(cfg, grid * grid, total / 1e3):.4f} on the traced "
          f"device time ({CARD})")
    for ms, n, name in kernels[:8]:
        print(f"  {ms:9.3f} ms {n:5d}x  {name[:100]}")


def _encode_sample_per_tile(bundle, dev):
    """``vae.encode_tiled(key=)`` on a FILL_SIZE image in the stage's
    dtype: the JAX package hands every tile the same key, so every tile
    samples JAX's draw from it. Held within 1e-3 in relative norm to the
    blend of per-tile ``encode(key=)``s; the sample is not the mode."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import vae
    cfg, p = bundle.vae_cfg, bundle.vae_params
    tile, overlap = 96, 16                  # fill_batch's defaults
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    x = (torch.rand((1, FILL_SIZE, FILL_SIZE, 3), generator=g, device=dev)
         * 2 - 1).to(bundle.compute_dtype)

    key = prng.PRNGKey(23, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = vae.encode_tiled(p, x, cfg, tile, overlap, key)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = FILL_SIZE // cfg.spatial_factor
    want = vae._tiled(lambda xt: vae.encode(p, xt, cfg, key), x, n, n,
                      cfg.spatial_factor, 1, cfg.latent_channels, tile,
                      overlap)
    mode = vae.encode_tiled(p, x, cfg, tile, overlap)
    rel = _rel_norm(got, want)
    n_tiles = len(vae._tile_starts(n, tile, overlap)) ** 2
    print(f"encode_tiled(key=) at {FILL_SIZE} px ({n_tiles} tiles, "
          f"{x.dtype}): {secs:.3f} s; relative norm {rel:.3e} to the "
          f"per-tile encode(key=) blend (bar 1e-3), "
          f"{_rel_norm(got, mode):.3e} to the mode ({CARD})")
    if not rel < 1e-3:
        raise AssertionError("encode_tiled(key=) differs from the per-tile "
                             "encode(key=) blend")
    if torch.equal(got, mode):
        raise AssertionError("encode_tiled(key=) drew no sample")


def phase_compose(dev, rows, backgrounds):
    """Stage 4 at full width through ``compose.process_dataset`` on a
    synthetic UODD 1-shot sample whose backgrounds are ``backgrounds``
    (the stage-3 PNGs), as the pipeline chains the stages."""
    import shutil
    import torch
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
    bundle = _drawn_bundle(fp, 1, True, "stage 4")

    _encode_sample_per_tile(bundle, dev)
    root = OUT / "compose"
    shutil.rmtree(root, ignore_errors=True)
    _uodd_dataset(root / "datasets" / dataset, sample, shot)
    paths, step, _ = _run_compose(bundle, root, backgrounds, rows, "output",
                                  int8=False)
    print(f"stage 4 MFU: "
          f"{_mfu(bundle.flux_cfg, (FILL_SIZE // 16) ** 2, step):.4f} of "
          f"the dense bf16 peak at {step:.3f} s per step (eval.flops, "
          f"{CARD})")
    return bundle, root, paths, step


def phase_compose_caches(bundle, root, backgrounds, dense_paths,
                         dense_step):
    """Stage 4 at full width under the velocity cache: interval 2 (the
    4 trimmed denoise steps take 2 multi-pass forwards per background,
    B3 38 / 76) and "auto", calibrated on the fill core in a first call
    (its seconds), then counted at the interval it chose. Seconds per
    step and per background beside the dense run, and the relative L2
    of the hires images to the dense ones (a report)."""
    import torch
    from domainrag_tpu_torch.core.config import ComposeConfig
    from domainrag_tpu_torch.models.flux import pipeline as fp
    n_steps = int(FILL_STEPS * ComposeConfig().dataset_params["UODD"].strength)
    for name, vci in (("velocity 2", 2), ("velocity auto", "auto")):
        tag = name.replace(" ", "_")
        calib, form = "", vci
        if vci == "auto":
            _, _, timer = _run_compose(bundle, root, backgrounds, {},
                                       f"calib_{tag}", int8=False, vci=vci,
                                       calls=0)
            shutil.rmtree(root / f"calib_{tag}")
            form = _resolved(fp._FILL_VCACHE_CALIBRATIONS, bundle,
                             "fill-auto")
            calib = (f"calibration {timer.totals['calibrate']:.3f} s once "
                     f"-> {form}; ")
        paths, step, timer = _run_compose(
            bundle, root, backgrounds, {}, f"output_{tag}", int8=False,
            vci=vci, calls=_model_calls(form, n_steps))
        print(f"stage 4 cache {name}: {calib}{step:.3f} s per denoise step "
              f"averaged (dense {dense_step:.3f}), "
              f"{timer.totals['fill'] / len(paths):.3f} s per background "
              f"(encode + denoise + decode), max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; hires "
              f"image rel L2 to the dense images "
              f"{_rel_l2(paths, dense_paths):.4f} (a report; {CARD})")
        shutil.rmtree(root / f"output_{tag}")


def _uodd_dataset(ds, sample, shot):
    """A synthetic UODD k-shot set: one 1024x1024 image (a smooth gradient
    with noise) with two boxes."""
    from PIL import Image
    from domainrag_tpu_torch.core.coco import write_coco
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


def _run_compose(bundle, root, backgrounds, rows, out_name, int8, vci=1,
                 calls=None):
    """``compose.process_dataset`` over the synthetic UODD sample under
    ``root`` into ``root / out_name`` with the velocity cache ``vci``,
    with the launch counts of the path read just after (bf16: B3; int8:
    B4 and the multi-pass B7): ``calls`` MMDiT forwards per background
    chunk (None: every denoise step; 0: not read, for a run that
    calibrates). Returns the hires PNG paths, seconds per step and the
    timer."""
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
    cfg = ComposeConfig(num_steps=FILL_STEPS, max_rank_batch=MAX_RANK_BATCH,
                        velocity_cache_interval=vci)
    n_steps = int(FILL_STEPS * cfg.dataset_params[dataset].strength)
    calls = n_steps if calls is None else calls
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
    passes = calls * math.ceil(len(backgrounds) / MAX_RANK_BATCH)
    if int8:
        _read_i8_counts(mma, rows, "multi-pass", bundle.flux_cfg, passes,
                        S_TXT, (FILL_SIZE // 16) ** 2)
    elif calls:
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
    return ([out["outpainted_image_path"] for out in outs], mean["step"],
            timer)


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
    want_insts = {}
    for (m, k, n), c in want_shapes.items():
        inst = int8_gemm.instance(m, k, n)
        want_insts[inst] = want_insts.get(inst, 0) + c
    got_insts = dict(int8_gemm.w8a8_linear.launches_by_instance)
    b7 = {"one-pass": (d.i8_launches, s.i8_launches),
          "multi-pass": (d.i8_mp_launches, s.i8_mp_launches)}
    other = "multi-pass" if regime == "one-pass" else "one-pass"
    want = (cfg.depth_double * passes, cfg.depth_single * passes)
    bf16 = (d.launches, s.launches, d.mp_launches, s.mp_launches)
    print(f"launches on the path (int8): B4 {int8_gemm.w8a8_linear.launches} "
          f"(expected {sum(want_shapes.values())} = "
          f"{sum(want_shapes.values()) // passes} x {passes} passes, at "
          f"{len(want_shapes)} shapes; by instance {got_insts}, expected "
          f"{want_insts}), B7 {regime} double/single "
          f"{b7[regime]} (expected {want}), B7 {other} {b7[other]}, bf16 "
          f"B1/B2/B3 {bf16}, B5/B6 {_flash_counts()} (expected 0)")
    if got_shapes != want_shapes or got_insts != want_insts \
            or b7[regime] != want \
            or b7[other] != (0, 0) or any(bf16) or any(_flash_counts()):
        raise AssertionError(f"int8 launch counts differ from the path: "
                             f"{sorted(got_shapes.items())}")
    _adaln_launches({}, regime, cfg, passes)
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
    counted, at the flattened (M, K, N) and at its instance. ``wq`` is
    K-major, (N, K)."""
    import torch
    n, k = wq.shape
    m = x.numel() // k
    inst = ig.instance(m, k, n)
    before = ig.w8a8_linear.launches
    before_shape = ig.w8a8_linear.launches_by_shape.get((m, k, n), 0)
    before_inst = ig.w8a8_linear.launches_by_instance.get(inst, 0)
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
            before_shape + 1 or \
            ig.w8a8_linear.launches_by_instance.get(inst) != before_inst + 1:
        raise AssertionError(f"w8a8_linear did not count one launch at "
                             f"{(m, k, n)} ({inst})")
    return inst


def _check_w8a8_rows(ig, g, dev, m, k, n, dtype):
    """B4's kernel at (M, K, N), called straight into the head of a
    NaN-filled buffer of ``dtype`` with 130 rows more: rows 0..M-1 equal
    to the plain version, the rest untouched (no row past M is stored)."""
    import torch
    x = torch.randn((m, k), generator=g, device=dev) * 3
    wq = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                       dtype=torch.int8)
    ws = torch.rand(n, generator=g, device=dev) / 127
    b = torch.randn(n, generator=g, device=dev).to(dtype)
    xq, xs = ig.quantize_rowwise(x)
    xs = xs.reshape(m).contiguous()
    inst = ig.instance(m, k, n)
    buf = torch.full((m + 130, n), float("nan"), dtype=dtype, device=dev)
    rc = ig._lib().w8a8_gemm(
        xq.data_ptr(), wq.data_ptr(), xs.data_ptr(), ws.data_ptr(),
        b.data_ptr(), buf.data_ptr(), m, n, k, int(dtype == torch.float32),
        ig.INSTANCES.index(inst), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    want = ig.w8a8_reference(xq, wq, xs[:, None], ws, b, dtype)
    if rc != 0 or not torch.equal(buf[:m], want) \
            or not bool(torch.isnan(buf[m:]).all()):
        raise AssertionError(f"B4 {inst} at {(m, k, n)} {dtype}: rows "
                             f"0..{m - 1} differ from the plain version or "
                             f"a row past them was written (rc {rc})")
    print(f"kernel w8a8_gemm: {inst} at {(m, k, n)} {dtype} writes its {m} "
          f"rows and none past them")


def phase_int8_gemm(dev):
    """B4 through its wrapper ``w8a8_linear`` (K-major weights) against its
    plain version with torch.equal at every (M, K, N) of the stage-3 (1024
    px) and stage-4 (2048 px, 384 input channels) paths, bf16 out with
    bias, and at ragged shapes that reach all three instances (M 640 / 63
    / 65 / 17 / 1, K % 16 != 0, N 64 and 70, f32 out, no bias, a batched
    (2, 320, K) input); each instance called straight into a guarded
    buffer, which must keep every row past M; each path shape's kernel
    timed beside the plain version, torch._int_mm with the same epilogue
    (a yardstick: M > 16 only) and the bf16 torch.matmul of the same
    linear, with its bound, and with ``--parent`` in turns with the
    parent's kernel on the (K, N) copy of the weight."""
    import torch
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import int8_gemm as ig

    g = torch.Generator(device=dev)
    g.manual_seed(17)
    ragged = [((640,), 3072, 3072, torch.bfloat16, True),
              ((17,), 1000, 64, torch.float32, False),
              ((1,), 384, 3072, torch.float32, True),
              ((33,), 100, 70, torch.bfloat16, True),
              ((63,), 384, 64, torch.float32, True),
              ((65,), 1000, 70, torch.bfloat16, True),
              ((1000,), 384, 70, torch.float32, False),
              ((2, 320), 128, 3072, torch.bfloat16, True)]
    insts = []
    for lead, k, n, dt, bias in ragged:
        x = torch.randn((*lead, k), generator=g, device=dev).to(dt)
        wq = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        ws = torch.rand(n, generator=g, device=dev) / (127 * math.sqrt(k))
        b = torch.randn(n, generator=g, device=dev) if bias else None
        insts.append(_check_w8a8_wrapper(ig, x, wq, ws, b))
    if set(insts) != set(ig.INSTANCES):
        raise AssertionError(f"B4's ragged shapes reached {set(insts)}")
    for m, k, n in ((65, 384, 64), (63, 384, 64), (65, 1000, 70)):
        for dt in (torch.bfloat16, torch.float32):
            _check_w8a8_rows(ig, g, dev, m, k, n, dt)
    print(f"kernel w8a8_gemm: w8a8_linear torch.equal to its plain version "
          f"at ragged shapes "
          f"{[(*r[0], r[1], r[2], i) for r, i in zip(ragged, insts)]}")
    rows = {}
    shapes = set(_w8a8_path_shapes(fm.FLUX_DEV, S_TXT, (SIZE // 16) ** 2))
    shapes |= set(_w8a8_path_shapes(fm.FLUX_FILL_DEV, S_TXT,
                                    (FILL_SIZE // 16) ** 2))
    for i, (m, k, n) in enumerate(sorted(shapes)):
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (n, k), generator=g, device=dev,
                           dtype=torch.int8)
        wkn = wq.t().contiguous()        # the (K, N) layout, for the yardsticks
        ws = torch.rand(n, generator=g, device=dev) / (127 * math.sqrt(k))
        b = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
        inst = _check_w8a8_wrapper(ig, x, wq, ws, b)
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
                                            torch.bfloat16)[0], 10),
               "plain_ms": _ms(lambda: ig.w8a8_reference(
                   xq, wq, xs, ws, b, torch.bfloat16),
                   1 if big else 3, 1),
               "bound_ms": max(ops, nbytes),
               "bound_by": "operations" if ops >= nbytes else "bytes"}
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            row["library_ms"] = _ms(lambda: (
                torch._int_mm(xq, wkn).float() * xs * ws).to(
                    torch.bfloat16) + b, 10)
        else:
            row["library_ms"] = None
        wb = (wkn.float() * ws).to(torch.bfloat16)
        bf16_ms = _ms(lambda: torch.matmul(x, wb) + b, 10)
        del wb
        rows[name] = row
        lib = "n/a" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f}"
        gate = "Pallas" if ig.w8a8_eligible(m, k, n) else "XLA"
        print(f"kernel {name}: {inst}, torch.equal to plain; ms "
              f"{row['ms']:.4f} plain_ms {row['plain_ms']:.3f} library_ms "
              f"(_int_mm) {lib} bf16 matmul {bf16_ms:.4f} bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']}); the JAX gate "
              f"sends this shape to {gate}")
        if PARENT:
            change = lambda: ig._launch(xq, wq, xs, ws, b,   # noqa: E731
                                        torch.bfloat16)[0]
            parent = _parent_call(ig, "int8_gemm", change)
            same = torch.equal(parent(), change())
            _in_turns(f"B4 {name}", parent, change, 10,
                      [_rel_norm(parent(), change())])
            if not same:
                raise AssertionError(f"{name}: the parent's B4 output "
                                     f"differs from this commit's")
        del wkn
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
            noise = fp._noise(cpu, [6], seq, cpu.vae_cfg.latent_channels * 4)
            sigmas = torch.as_tensor(sched.make_schedule(
                steps, image_seq_len=seq, strength=strength).sigmas)
            forwards = len(sigmas) - 1
            mma._MAX_ONEPASS = 64
        else:
            steps = forwards = 3
            uniq = rng.uniform(-1, 1, (3, 28, 28, 3)).astype(np.float32)
            noise = fp._noise(cpu, [7, 70], seq,
                              cpu.vae_cfg.latent_channels * 4)
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
        paths, step, _ = _run_slice(bundle, sample, rows, "sample0_int8",
                                    int8=True)
        # one rank under the velocity cache at interval 2: B4 runs per
        # model call (314 each), not per step
        target, refs, cfg = sample
        vc_cfg = dataclasses.replace(cfg, sampling=dataclasses.replace(
            cfg.sampling, velocity_cache_interval=2))
        _, vc_step, _ = _run_slice(
            bundle, (target, refs[:1], vc_cfg), {}, "sample0_int8_vc2",
            int8=True, calls=_model_calls(2, STEPS))
    print(f"stage 3 int8 velocity cache 2 (one rank): {vc_step:.3f} s per "
          f"denoise step averaged ({CARD})")
    shutil.rmtree(OUT / "sample0_int8_vc2")
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
        paths, step, _ = _run_compose(bundle, root, backgrounds, rows,
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
    """The parent's B5 (behind this commit's wrapper: the forward's C
    interface is unchanged) on this row's inputs, timed in turns with this
    commit's; ``out`` and ``lse`` are this commit's outputs."""
    from domainrag_tpu_torch.ops import attention as attn

    def change():
        return attn._kernel_forward(q, k, v, False, None)
    parent = _parent_call(attn, "flash_attention", change)
    p_out, p_lse = parent()
    _in_turns(name, parent, change, reps,
              [_rel_norm(p_out, out), _rel_norm(p_lse, lse)])
    del p_out, p_lse


def _parent_launch_backward():
    """``launch_backward`` with the parent commit's B6 (its one kernel in
    each dtype, dq added in arrival order) by its C interface (no turns)
    and its wrapper's steps: the f32 tensor dq is added into zeroed, in
    bf16 scaled and cast after; it sets ``buf.dq`` and writes ``buf.dk``,
    ``buf.dv``, and counts no launch."""
    import ctypes
    import torch
    from domainrag_tpu_torch.ops import attention as attn
    lib = _parent_lib("flash_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    fns = {torch.bfloat16: lib.flash_bwd_bf16, torch.float32: lib.flash_bwd_f32}

    def launch(buf):
        fn = fns[buf.q.dtype]
        fn.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        b, h, s_q, s_kv, d = buf.shape
        scale = 1.0 / math.sqrt(d)
        acc = torch.zeros((b * h, s_q, attn.HEAD_DIM), dtype=torch.float32,
                          device=buf.q.device)
        rc = fn(*(t.data_ptr() for t in (buf.q, buf.k, buf.v, buf.dout,
                                          buf.lse, buf.delta, acc, buf.dk,
                                          buf.dv)),
                b * h, s_q, s_kv, buf.kv_valid, int(buf.causal), scale,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the parent's B6 failed: CUDA error {rc}")
        buf.dq = acc.mul_(scale).to(buf.q.dtype) \
            if buf.q.dtype == torch.bfloat16 else acc
    return launch


def _parent_b6(name, buf, change, reps):
    """The parent commit's B6 on the same inputs as ``buf``, into outputs
    of its own, timed in turns with this commit's ``change``; the line
    starts with ``name``."""
    import torch
    mine = SimpleNamespace(**vars(buf))
    mine.dk, mine.dv = torch.empty_like(buf.dk), torch.empty_like(buf.dv)
    launch = _parent_launch_backward()
    parent = lambda: launch(mine)                       # noqa: E731
    parent()
    change()
    torch.cuda.synchronize()
    _in_turns(f"B6 {name}", parent, change, reps,
              [_rel_norm(x, y) for x, y in ((mine.dq, buf.dq),
                                            (mine.dk, buf.dk),
                                            (mine.dv, buf.dv))])
    del mine


def _parent_step_turns(tag, run, reps=3):
    """``run()``, one train step, timed in turns with the parent's B6 in
    place of this commit's (parent, change, change, parent): the median of
    ``reps`` steps per turn."""
    import torch
    from domainrag_tpu_torch.ops import attention as attn
    change, parent = attn.launch_backward, _parent_launch_backward()

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    t = []
    for launch in (parent, change, change, parent):
        attn.launch_backward = launch
        try:
            t.append(statistics.median(timed() for _ in range(reps)))
        finally:
            attn.launch_backward = change
    print(f"{tag} parent vs this commit (the parent's B6 in place; parent, "
          f"change, change, parent; the median of {reps} steps each): "
          f"{t[0]:.3f} / {t[1]:.3f} / {t[2]:.3f} / {t[3]:.3f} s ({CARD})")


def _b6_repeats(name, run):
    """``run()`` -> (dq, dk, dv) of one B6 call, made twice: raises unless
    the two runs are torch.equal (B6 adds dq over the kv blocks in a fixed
    order). Returns the first run's."""
    import torch
    first = [x.clone() for x in run()]
    second = run()
    torch.cuda.synchronize()
    for nm, a, b in zip(("dq", "dk", "dv"), first, second):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name}: {nm} differs between two runs of the same "
                f"backward (relative norm {_rel_norm(b, a):.3e})")
    print(f"kernel {name}: dq, dk, dv torch.equal over two runs")
    return first


def phase_flash_kernels(dev):
    """B5 and B6 against their plain versions: at the trainer's attention
    shape (2, 24, 4608, 128) in bf16 and f32 (forward; B6: one kernel in
    each dtype), B5 above _MAX_MULTIPASS at (1,
    24, 50393, 128) bf16 (compared on two heads with the blocked plain
    version), a small causal + kv_valid case with ragged lengths in both
    dtypes and the RAGGED_BWD bf16 backward cases; every B6 call runs
    twice, torch.equal. With ``--parent`` the parent commit's B6 (bf16 and
    f32, by its own C interface) is timed beside this one."""
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
        got = _b6_repeats(tag, lambda: attn._kernel_backward(
            q, k, v, want, want_lse, do, True, 613))
        ref = attn.flash_backward_reference(q, k, v, want, want_lse, do,
                                            True, 613)
        for nm, a, b in zip(("dq", "dk", "dv"), got, ref):
            _check_grad(f"{tag} {nm}", a, b, f32)
    for b_, h_, s_q, s_kv, causal, kv_valid in RAGGED_BWD:
        q, k, v, do = qkvo((b_, h_, s_q, s_kv, 128), torch.bfloat16)
        want, want_lse = attn.flash_forward_reference(q, k, v, causal,
                                                      kv_valid)
        tag = (f"flash bwd bf16 {s_q}x{s_kv} causal {causal} kv_valid "
               f"{kv_valid}")
        _poison(k)
        got = _b6_repeats(tag, lambda: attn._kernel_backward(
            q, k, v, want, want_lse, do, causal, kv_valid))
        ref = attn.flash_backward_reference(q, k, v, want, want_lse, do,
                                            causal, kv_valid)
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
            # f32: six bf16 products per f32 product (its route) at the
            # bf16 peak
            _flash_bound(24, shape, f32, 4, PEAK_BF16) if f32
            else _flash_bound(4, shape, f32))
        if f32:
            print(f"kernel {name}: bound on f32 FMA (the route not taken) "
                  f"{_flash_bound(4, shape, f32)['bound_ms']:.3f} ms")
        if PARENT:
            _parent_b5_turns(name, q, k, v, out, lse, reps[0])
        # backward from the plain forward's out/lse
        buf = attn.backward_buffers(q, k, v, want, want_lse, do, False)

        def b6():
            attn.launch_backward(buf)
            return buf.dq, buf.dk, buf.dv
        unpad = [x.reshape(q.shape)
                 for x in _b6_repeats(f"flash_bwd_{tag}", b6)]
        ref = attn.flash_backward_reference(q, k, v, want, want_lse, do)
        torch.cuda.synchronize()
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
            _parent_b6(tag, buf, lambda: attn.launch_backward(buf), reps[3])
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


# ---------------------------------------------------------------------------
# the CLI from a checkpoint tree on disk (stages 1 -> 4 from safetensors)
# ---------------------------------------------------------------------------

CLI_STEPS = 10            # cut: stage default 50 (stage 4: x 0.4 = 4 steps)
CLI_RANKS = 5             # the stage default: 5 ranks, 5 backgrounds
CLI_CORPUS = 32           # cut: a few dozen corpus JPEGs
SHARD_BYTES = 5 << 30     # checkpoint shard size, as HF shards its files
_ST_DTYPES = {"float32": "F32", "bfloat16": "BF16"}


def _write_safetensors(path, tensors):
    """The safetensors format, written here (the format's inverse of
    ``models.convert``'s reader): an 8-byte little-endian header length,
    the JSON header (dtype, shape, data offsets), then each tensor's
    bytes."""
    import struct
    import torch
    header, offset = {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": _ST_DTYPES[str(t.dtype).split(".")[1]],
                       "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(t.detach().contiguous().reshape(-1).view(
                torch.uint8).cpu().numpy().data)


def _write_sharded(directory, tensors, prefix="model"):
    """``tensors`` in files of about SHARD_BYTES, in key order. Returns
    the file paths."""
    directory.mkdir(parents=True, exist_ok=True)
    shards, cur, size = [], {}, 0
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        if cur and size + n > SHARD_BYTES:
            shards.append(cur)
            cur, size = {}, 0
        cur[key] = t
        size += n
    if cur:
        shards.append(cur)
    paths = []
    for i, shard in enumerate(shards):
        path = directory / f"{prefix}-{i:05d}-of-{len(shards):05d}" \
                           f".safetensors"
        _write_safetensors(path, shard)
        paths.append(path)
    return paths


def _draw(init_fn, seed, dev, dtype=None):
    """A tree drawn by a port ``init`` on the card from ``PRNGKey(seed)``,
    its random leaves stored in ``dtype`` (None: as drawn), and its recipe
    tree: each random leaf's draw (the arguments of its
    ``models.common._draw`` call: key, JAX shape, scale, dtypes), or a CPU
    copy of the leaves not drawn at random (biases, norm scales,
    batchnorm statistics)."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import common
    drawn, plain = {}, common._draw

    def recording(key, shape, std, leaf_dtype, draw_dtype=torch.float32,
                  oihw=False):
        t = plain(key, shape, std, leaf_dtype, draw_dtype, oihw)
        drawn[t.data_ptr()] = [key.clone(), tuple(shape), std, leaf_dtype,
                               draw_dtype, oihw]
        return t
    common._draw = recording
    try:
        tree = init_fn(prng.PRNGKey(seed, device=dev))
    finally:
        common._draw = plain

    def leaf(t):
        recipe = drawn.get(t.data_ptr())
        if recipe is None:
            return t, t.detach().cpu().clone()
        if dtype is not None:
            t, recipe[3] = t.to(dtype), dtype
        return t, tuple(recipe)
    pairs = _tree(leaf, tree)
    return _tree(lambda p: p[0], pairs), _tree(lambda p: p[1], pairs)


def _redraw(recipe, dev):
    from domainrag_tpu_torch.models import common
    if isinstance(recipe, tuple):
        key, *rest = recipe
        return common._draw(key.to(dev), *rest)
    return recipe.to(dev)


def _flat_paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat_paths(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _flat_paths(v, path + (i,))]
    return [(path, tree)]


def _check_loaded(name, loaded, recipes, dev, dtype=None):
    """Every converted leaf equals the drawn one, drawn again from its
    recipe, in ``dtype`` (None: the drawn dtype; bf16 -> f32 is exact),
    and the two trees have the same paths. Returns the leaf count."""
    import torch
    got, want = dict(_flat_paths(loaded)), dict(_flat_paths(recipes))
    if sorted(got, key=str) != sorted(want, key=str):
        raise AssertionError(f"{name}: converted tree paths differ: "
                             f"{sorted(set(got) ^ set(want), key=str)[:5]}")
    for path, leaf in got.items():
        expect = _redraw(want[path], dev)
        expect = expect.to(dtype or expect.dtype)
        if leaf.dtype != expect.dtype or not torch.equal(leaf, expect):
            raise AssertionError(f"{name} {path}: converted {leaf.dtype} "
                                 f"differs from the drawn {expect.dtype}")
        del expect
    return len(got)


def _hf_lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["w"].t()
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]


def _hf_ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]


def _hf_layers(sd, prefix, blocks):
    """CLIP / SigLIP encoder layers in the transformers layout."""
    for i, b in enumerate(blocks):
        pre = f"{prefix}.encoder.layers.{i}"
        _hf_ln(sd, f"{pre}.layer_norm1", b["ln1"])
        for k, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                        ("o", "out_proj")):
            _hf_lin(sd, f"{pre}.self_attn.{name}", b["attn"][k])
        _hf_ln(sd, f"{pre}.layer_norm2", b["ln2"])
        _hf_lin(sd, f"{pre}.mlp.fc1", b["fc1"])
        _hf_lin(sd, f"{pre}.mlp.fc2", b["fc2"])


def _hf_patch(patch_w, patch):
    """(P*P*3, hidden) channel-last patch weight -> the conv's (hidden, 3,
    P, P)."""
    return patch_w.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1)


def _hf_clip_text(p, cfg):
    sd = {"text_model.embeddings.token_embedding.weight": p["tok_emb"],
          "text_model.embeddings.position_embedding.weight": p["pos_emb"],
          "text_projection.weight": p["proj"].t()}
    _hf_ln(sd, "text_model.final_layer_norm", p["ln_final"])
    _hf_layers(sd, "text_model", p["blocks"])
    return sd


def _hf_clip_vision(p, cfg):
    v = "vision_model"
    sd = {f"{v}.embeddings.patch_embedding.weight":
          _hf_patch(p["patch_w"], cfg.patch_size),
          f"{v}.embeddings.class_embedding": p["class_emb"],
          f"{v}.embeddings.position_embedding.weight": p["pos_emb"],
          "visual_projection.weight": p["proj"].t()}
    _hf_ln(sd, f"{v}.pre_layrnorm", p["ln_pre"])
    _hf_ln(sd, f"{v}.post_layernorm", p["ln_post"])
    _hf_layers(sd, v, p["blocks"])
    return sd


def _hf_siglip(p, cfg):
    v = "vision_model"
    sd = {f"{v}.embeddings.patch_embedding.weight":
          _hf_patch(p["patch_w"], cfg.patch_size),
          f"{v}.embeddings.patch_embedding.bias": p["patch_b"],
          f"{v}.embeddings.position_embedding.weight": p["pos_emb"]}
    _hf_ln(sd, f"{v}.post_layernorm", p["post_ln"])
    _hf_layers(sd, v, p["blocks"])
    return sd


def _hf_t5(p, cfg):
    """T5 encoder in the transformers layout, bf16 as published."""
    import torch
    sd = {"shared.weight": p["embed"],
          "encoder.final_layer_norm.weight": p["final_norm"]["scale"]}
    for i, b in enumerate(p["blocks"]):
        pre = f"encoder.block.{i}.layer"
        for k in ("q", "k", "v", "o"):
            sd[f"{pre}.0.SelfAttention.{k}.weight"] = b["attn"][k]["w"].t()
        if "rel_bias" in b["attn"]:
            sd[f"{pre}.0.SelfAttention.relative_attention_bias.weight"] = \
                b["attn"]["rel_bias"]
        sd[f"{pre}.0.layer_norm.weight"] = b["ln_attn"]["scale"]
        sd[f"{pre}.1.layer_norm.weight"] = b["ln_ff"]["scale"]
        for k in ("wi_0", "wi_1", "wo"):
            sd[f"{pre}.1.DenseReluDense.{k}.weight"] = b[k]["w"].t()
    return {k: v.to(torch.bfloat16) for k, v in sd.items()}


def _hf_redux(p, cfg):
    sd = {}
    _hf_lin(sd, "redux_up", p["up"])
    _hf_lin(sd, "redux_down", p["down"])
    return sd


def _hf_stem(p, cfg):
    bn = p["bn1"]
    return {"conv1.weight": p["conv1"]["w"], "bn1.weight": bn["scale"],
            "bn1.bias": bn["bias"], "bn1.running_mean": bn["mean"],
            "bn1.running_var": bn["var"]}


def _hf_lama(p, cfg):
    """big-lama's leaves in module order, keys that sort in that order."""
    from domainrag_tpu_torch.models.convert import lama_leaf_order
    return {f"{i:04d}.param": leaf
            for i, (_, leaf) in enumerate(lama_leaf_order(p))}


def _towers():
    """(subdir, init, config, dtype drawn in, layout writer) of every
    checkpoint subtree but the MMDiTs, at full width."""
    import torch
    from domainrag_tpu_torch.models import clip, lama, redux, resnet_stem
    from domainrag_tpu_torch.models import siglip, t5
    from domainrag_tpu_torch.models.export_diffusers import \
        export_vae_to_diffusers
    from domainrag_tpu_torch.models.flux import vae
    f32, bf16 = torch.float32, torch.bfloat16
    return [
        ("vae", lambda i: vae.init(i, vae.FLUX_VAE), None, f32,
         lambda p, c: export_vae_to_diffusers(p)),
        ("t5", lambda i: t5.init(i, t5.T5_XXL), None, bf16, _hf_t5),
        ("clip-text", lambda i: clip.init_text(i, clip.CLIP_L_TEXT), None,
         f32, _hf_clip_text),
        ("siglip", lambda i: siglip.init(i, siglip.SIGLIP_SO400M),
         siglip.SIGLIP_SO400M, f32, _hf_siglip),
        ("redux", lambda i: redux.init(i, redux.REDUX_DEV), None, f32,
         _hf_redux),
        ("clip-vision", lambda i: clip.init_vision(i,
                                                   clip.ClipVisionConfig()),
         clip.ClipVisionConfig(), f32, _hf_clip_vision),
        ("resnet-stem", lambda i: resnet_stem.init(i), None, f32, _hf_stem),
        ("lama", lambda i: lama.init(i, lama.BIG_LAMA), None, f32, _hf_lama),
    ]


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _write_checkpoints(ckpt, dev):
    """The checkpoint tree ``models.convert`` reads, of random full-width
    weights drawn on the card by the port's inits, each tower from its
    own seed and written in its published layout: the towers, then the
    FLUX.1-dev and FLUX.1-Fill-dev MMDiTs in bf16 through
    ``export_flux_to_diffusers``. The Fill MMDiT is drawn from the dev
    MMDiT's key, as ``build_tiny_runner`` draws both bundles from one key:
    a split gives its i-th key whatever the count, so its blocks are the
    dev blocks. It draws and writes its own embedders and final layer (the
    init at depth 0) and links the dev MMDiT's block shards (full width
    and depth still), which keeps the tree at ~37 GB and the run's disk
    writes under 45 GiB. Returns the recipe tree and the bytes of each
    subtree."""
    import gc
    import shutil
    import torch
    from domainrag_tpu_torch.models.export_diffusers import \
        export_flux_to_diffusers
    from domainrag_tpu_torch.models.flux import model as fm

    recipes, seconds = {}, {}
    for seed, (sub, init, cfg, dtype, layout) in enumerate(_towers(), 10):
        tree, recipes[sub] = _draw(init, seed, dev, dtype)
        t0 = time.perf_counter()
        _write_sharded(ckpt / sub, layout(tree, cfg))
        seconds[sub] = time.perf_counter() - t0
        del tree
    block_files = None
    for sub, cfg in (("flux-dev", fm.FLUX_DEV),
                     ("flux-fill", dataclasses.replace(
                         fm.FLUX_FILL_DEV, depth_double=0, depth_single=0))):
        tree, recipes[sub] = _draw(
            lambda k: fm.init(k, cfg, dtype=torch.bfloat16), 20, dev)
        sd = export_flux_to_diffusers(tree, cfg)
        blocks = {k: v for k, v in sd.items() if k.startswith(
            ("transformer_blocks.", "single_transformer_blocks."))}
        t0 = time.perf_counter()
        _write_sharded(ckpt / sub, {k: v for k, v in sd.items()
                                    if k not in blocks}, "embedders")
        if block_files is None:
            block_files = _write_sharded(ckpt / sub, blocks, "blocks")
        else:
            for path in block_files:
                (ckpt / sub / path.name).symlink_to(path)
        seconds[sub] = time.perf_counter() - t0
        del tree, sd, blocks
        gc.collect()
        torch.cuda.empty_cache()
    read = {sub: _dir_bytes(ckpt / sub) for sub in recipes}
    written = sum(read.values()) - sum(p.stat().st_size for p in block_files)
    print(f"[{CARD}] checkpoint tree written: {written / 1e9:.2f} GB in "
          f"{sum(seconds.values()):.1f} s of writes "
          f"({written / sum(seconds.values()) / 1e9:.2f} GB/s), "
          f"{sum(read.values()) / 1e9:.2f} GB as the loader reads it (the "
          f"Fill MMDiT links the dev block shards); per subtree GB read / "
          f"s written: { {k: (round(read[k] / 1e9, 3), round(seconds[k], 1)) for k in read} }"
          f"; free disk left {shutil.disk_usage(ckpt).free / 1e9:.2f} GB")
    return recipes, read


class _PeakRss:
    """The process's resident set, sampled every 20 ms in a thread while
    it is open: its peak."""

    def __enter__(self):
        import threading
        self.peak = self.start = _rss()
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._done.wait(0.02):
            self.peak = max(self.peak, _rss())

    def __exit__(self, *exc):
        self._done.set()
        self._thread.join(timeout=5)
        self.peak = max(self.peak, _rss())


def _rss():
    import os
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _check_runner(runner, recipes, dev):
    """The converted trees equal the drawn ones; the two bundles hold the
    same tower tensors. The Fill MMDiT's blocks, drawn from the dev
    MMDiT's keys and read from its linked shards, equal the dev bundle's
    blocks (held to their draws just before)."""
    import torch
    fb, fill = runner.flux_bundle, runner.fill_bundle
    n = _check_loaded("flux-dev", fb.flux_params, recipes["flux-dev"], dev)
    blocks = ("double", "single")
    n += _check_loaded(
        "flux-fill",
        {k: v for k, v in fill.flux_params.items() if k not in blocks},
        {k: v for k, v in recipes["flux-fill"].items() if k not in blocks},
        dev)
    for part in blocks:
        a, b = _flat_paths(fill.flux_params[part]), \
            _flat_paths(fb.flux_params[part])
        if [p for p, _ in a] != [p for p, _ in b] or not all(
                torch.equal(x, y) for (_, x), (_, y) in zip(a, b)):
            raise AssertionError(f"flux-fill {part}: the Fill MMDiT's "
                                 f"blocks differ from the dev MMDiT's")
        n += len(a)
    for sub, attr in (("vae", "vae_params"), ("t5", "t5_params"),
                      ("clip-text", "clip_text_params"),
                      ("siglip", "siglip_params"),
                      ("redux", "redux_params")):
        n += _check_loaded(sub, getattr(fb, attr), recipes[sub], dev,
                           torch.float32)
        a, b = _flat_paths(getattr(fb, attr)), _flat_paths(getattr(fill, attr))
        if len(a) != len(b) or any(x is not y for (_, x), (_, y) in zip(a, b)):
            raise AssertionError(f"{attr}: the bundles do not share it")
    for sub, tree in (("clip-vision", runner.clip_encoder._params),
                      ("resnet-stem", runner.style_encoder._params),
                      ("lama", runner.lama_runner.params)):
        n += _check_loaded(sub, tree, recipes[sub], dev, torch.float32)
    return n


def _hooked_build(cli, stats, check=None):
    """``cli._build_runner`` that also times the load, samples the host's
    RSS and reads the card's memory, and runs ``check`` on the runner
    before the stages do."""
    import resource
    import torch
    real = cli._build_runner

    def build(args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _PeakRss() as rss:
            runner = real(args)
            torch.cuda.synchronize()
        stats.update(
            load_s=time.perf_counter() - t0, rss_before=rss.start,
            rss_peak=rss.peak, device=torch.cuda.memory_allocated(),
            device_peak=torch.cuda.max_memory_allocated(),
            maxrss=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            spans={k: v for k, v in runner.timer.totals.items()},
            timer=runner.timer)
        if check is not None:
            t0 = time.perf_counter()
            stats["checked"] = check(runner)
            stats["check_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        return runner

    return build


def _run_cli(cli, argv, stats, check=None):
    """``cli.main(argv)`` in this process with the hooked runner build;
    returns the printed summary."""
    import io
    buf = io.StringIO()
    real = cli._build_runner
    cli._build_runner = _hooked_build(cli, stats, check)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    finally:
        cli._build_runner = real
    print(buf.getvalue().strip()[-1500:])
    if rc != 0:
        raise AssertionError(f"CLI {argv[0]} exited with {rc}")
    return json.loads(buf.getvalue())


def _check_cli_tree(out, dataset, shot, sample, ranks):
    """Every stage's artifacts: stage 1's background and category map,
    stage 2's all-shots JSON, stage 3's rank PNGs at SIZE and the
    manifest, stage 4's hires and final PNGs, result JSON and the
    collected finals."""
    from PIL import Image
    from domainrag_tpu_torch.core.manifest import Manifest
    lam = out / "lamainpaint" / dataset / f"{shot}_shot"
    if not (lam / f"{sample}.jpg").exists() \
            or not (lam / "category_mapping.json").exists():
        raise AssertionError("stage 1 artifacts missing")
    with open(out / "retrieval_results" /
              "all_shots_retrieval_results.json") as f:
        rr = json.load(f)
    (entry,) = [e for entries in rr[dataset][f"{shot}_shot"].values()
                for e in entries]
    if entry["sample_id"] != sample or len(entry["similar_images"]) < ranks:
        raise AssertionError(f"stage 2 JSON: {entry['sample_id']}, "
                             f"{len(entry['similar_images'])} refs")
    (run,) = (out / "result" / f"{dataset}_{shot}shot_retrieval").iterdir()
    if Manifest(str(run / "manifest.json")).entry(sample).get("status") \
            != "done":
        raise AssertionError("stage 3 manifest: sample not done")
    for r in range(1, ranks + 1):
        arr = np.asarray(Image.open(run / sample /
                                    f"generated_image_rank{r}.png"))
        if arr.shape != (SIZE, SIZE, 3):
            raise AssertionError(f"stage 3 rank {r}: {arr.shape}")
    op = out / "outpaint_hires" / "process_0" / dataset / f"{shot}_shot"
    if Manifest(str(op / "manifest.json")).entry(sample).get("status") \
            != "done" or not (op / f"outpaint_results_{shot}shot.json") \
            .exists():
        raise AssertionError("stage 4 manifest or result JSON")
    for r in range(1, ranks + 1):
        for part, size in (("hires_result", FILL_SIZE),
                           ("final_result", SIZE)):
            arr = np.asarray(Image.open(op / sample /
                                        f"{sample}_{part}_rank{r}.png"))
            if arr.shape[:2] != (size, size):
                raise AssertionError(f"stage 4 {part} {r}: {arr.shape}")
    finals = list((out / "final_results" / "process_0" / f"{shot}_shot"
                   / dataset).glob("*_final_result*.png"))
    if len(finals) != ranks:
        raise AssertionError(f"{len(finals)} collected finals")
    return run


def phase_cli(dev):
    """The CLI from a checkpoint tree on disk, at full width and depth: the
    tree written (``_write_checkpoints``), then
    ``cli.main(["pipeline", "--checkpoints", ...])`` in this process over a
    synthetic UODD 1-shot set and a corpus of CLI_CORPUS JPEGs, the loaded
    trees held to the drawn ones before the stages run, the launch counts
    read just after; then ``generate --w8a8 --int8_qk`` from the same
    tree. The tree is deleted when the phase ends, pass or fail."""
    import gc
    import shutil
    import torch
    from domainrag_tpu_torch.cli import main as cli
    from domainrag_tpu_torch.core.config import DATASET_PARAMS
    from domainrag_tpu_torch.models import common
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.ops import topk as tk

    dataset, shot, sample = "UODD", 1, "uodd_0"
    strength = DATASET_PARAMS[dataset].strength
    passes3 = CLI_STEPS * CLI_RANKS                  # max_rank_batch 1
    passes4 = int(CLI_STEPS * strength) * CLI_RANKS
    root = OUT / "cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    print(f"[{CARD}] CLI phase: free disk under {OUT}: "
          f"{shutil.disk_usage(root).free / 1e9:.2f} GB; cuts: {CLI_STEPS} "
          f"steps (default 50; stage 4 x strength {strength} = "
          f"{int(CLI_STEPS * strength)} denoise steps), {CLI_CORPUS} corpus "
          f"JPEGs; {CLI_RANKS} ranks and backgrounds, full width and depth")
    try:
        ckpt = root / "checkpoints"
        recipes, sizes = _write_checkpoints(ckpt, dev)
        _uodd_dataset(root / "datasets" / dataset, sample, shot)
        corpus = root / "coco"
        corpus.mkdir()
        rng = np.random.default_rng(9)
        for i in range(CLI_CORPUS):
            _jpeg(rng, corpus / f"{i:012d}.jpg", 640, 480)
        common_args = ["--checkpoints", str(ckpt), "--datasets", dataset,
                       "--shots", str(shot), "--datasets_dir",
                       str(root / "datasets"), "--corpus",
                       f"coco={corpus}", "--steps", str(CLI_STEPS),
                       "--size", str(SIZE), "--max_rank_batch", "1"]
        gc.collect()
        torch.cuda.empty_cache()
        print(f"card before the load: {torch.cuda.memory_allocated() / 1e9:.2f}"
              f" GB allocated")

        # --- pipeline: stages 1 -> 4 ---------------------------------------
        stats = {}
        _reset_counts(mma)
        tk.topk_ip_fused.launches = 0
        fp.generate.nonfinite_images = fp.fill_batch.nonfinite_images = 0
        out = root / "output"
        summary = _run_cli(cli, ["pipeline"] + common_args
                           + ["--output_dir", str(out)], stats,
                           check=lambda r: _check_runner(r, recipes, dev))
        torch.cuda.synchronize()
        run_peak = torch.cuda.max_memory_allocated()
        d, s = mma.mmdit_double_attention, mma.mmdit_single_attention
        counts = {"one-pass": (d.launches, s.launches),
                  "multi-pass": (d.mp_launches, s.mp_launches)}
        want = {"one-pass": (fm.FLUX_DEV.depth_double * passes3,
                             fm.FLUX_DEV.depth_single * passes3),
                "multi-pass": (fm.FLUX_DEV.depth_double * passes4,
                               fm.FLUX_DEV.depth_single * passes4)}
        depth = f"{fm.FLUX_DEV.depth_double} / {fm.FLUX_DEV.depth_single}"
        print(f"launches on the CLI path: B1/B2 {counts['one-pass']} "
              f"(expected {want['one-pass']} = {depth} x {passes3} "
              f"forwards), B3 double/single {counts['multi-pass']} (expected"
              f" {want['multi-pass']} = {depth} x {passes4}), B5/B6 "
              f"{_flash_counts()}, B4/B7 {_i8_counts(mma)}, B8 "
              f"{tk.topk_ip_fused.launches} (expected all 0)")
        if counts != want or any(_flash_counts()) or any(_i8_counts(mma)) \
                or tk.topk_ip_fused.launches:
            raise AssertionError("CLI path: kernel launch counts differ")
        if fp.generate.nonfinite_images or fp.fill_batch.nonfinite_images:
            raise AssertionError("CLI path: images not finite")
        _check_cli_tree(out, dataset, shot, sample, CLI_RANKS)
        timings = summary["timings"]
        stages = {k: round(v["total_s"], 3) for k, v in timings.items()
                  if k.startswith("stage/")}
        if set(stages) != {"stage/inpaint", "stage/retrieve",
                           "stage/generate", "stage/compose"}:
            raise AssertionError(f"summary timings: {sorted(timings)}")
        total = sum(sizes.values())
        spans = stats["spans"]
        print(f"[{CARD}] CLI pipeline from {total / 1e9:.2f} GB of "
              f"safetensors: {stats['checked']} converted leaves equal the "
              f"drawn weights ({stats['check_s']:.1f} s to check), the "
              f"bundles share the VAE/T5/CLIP/SigLIP/Redux tensors; load "
              f"{stats['load_s']:.1f} s ({total / stats['load_s'] / 1e9:.2f}"
              f" GB/s), per subtree s (GB/s): "
              f"{ {k[5:]: (round(v, 2), round(sizes[k[5:]] / v / 1e9, 2)) for k, v in spans.items()} }; "
              f"host RSS {stats['rss_before'] / 1e9:.2f} GB before the load,"
              f" peak {stats['rss_peak'] / 1e9:.2f} GB during it (getrusage "
              f"maxrss of the process so far {stats['maxrss'] / 1e9:.2f} GB);"
              f" card after the load {stats['device'] / 1e9:.2f} GB "
              f"allocated (peak {stats['device_peak'] / 1e9:.2f} GB), peak "
              f"during the stages {run_peak / 1e9:.2f} GB; stage seconds "
              f"{stages}; stage 3 {stages['stage/generate'] / CLI_RANKS:.3f}"
              f" s per image ({CLI_STEPS} steps, {SIZE} px), stage 4 "
              f"{stages['stage/compose'] / CLI_RANKS:.3f} s per image "
              f"({int(CLI_STEPS * strength)} denoise steps, {FILL_SIZE} px)")
        gc.collect()
        torch.cuda.empty_cache()

        # --- generate --w8a8 --int8_qk --------------------------------------
        out8 = root / "output_int8"
        for sub in ("lamainpaint", "retrieval_results"):
            shutil.copytree(out / sub, out8 / sub)
        shutil.rmtree(out)
        stats8 = {}
        _reset_counts(mma)
        fp.generate.nonfinite_images = 0
        try:
            summary8 = _run_cli(cli, ["generate"] + common_args
                                + ["--output_dir", str(out8), "--w8a8",
                                   "--int8_qk"], stats8)
        finally:
            common.set_int8_activations(False)
            mma.set_int8_qk(False)
        _read_i8_counts(mma, {}, "one-pass", fm.FLUX_DEV, passes3, S_TXT,
                        (SIZE // 16) ** 2)
        if summary8 != {f"{dataset}/{shot}": {
                "processed": 1, "failed": 0, "skipped": 0, "fallback": 0}} \
                or fp.generate.nonfinite_images:
            raise AssertionError(f"CLI generate --w8a8: {summary8}")
        (run,) = (out8 / "result" / f"{dataset}_{shot}shot_retrieval") \
            .iterdir()
        if len(list((run / sample).glob("generated_image_rank*.png"))) \
                != CLI_RANKS:
            raise AssertionError("CLI generate --w8a8: rank PNGs")
        gen = stats8["timer"].totals["stage/generate"]
        print(f"[{CARD}] CLI generate --w8a8 --int8_qk: load + quantize "
              f"{stats8['load_s']:.1f} s, card after it "
              f"{stats8['device'] / 1e9:.2f} GB (peak "
              f"{stats8['device_peak'] / 1e9:.2f} GB), host RSS peak "
              f"{stats8['rss_peak'] / 1e9:.2f} GB; stage 3 {gen:.3f} s, "
              f"{gen / CLI_RANKS:.3f} s per image ({CLI_STEPS} steps, "
              f"{SIZE} px)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
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


def _trainer_counts(mma):
    """(B1, B2, B3, B5, B6 bf16, B6 f32) launches."""
    d, s = mma.mmdit_double_attention, mma.mmdit_single_attention
    return (d.launches, s.launches, d.mp_launches + s.mp_launches,
            *_flash_counts())


def _trainer_want(blocks, steps=1):
    """``_trainer_counts`` of ``steps`` train steps with remat over
    ``blocks`` blocks, for a batch of any dtype: a bf16 batch computes in
    f32, as JAX's flow_match_loss promotes it, so every block runs the
    unfused composition, B5 f32 in its forward and in its remat recompute
    and B6 f32 in its backward, and no fused or bf16 attention kernel."""
    return (0, 0, 0, 2 * blocks * steps, 0, blocks * steps)


@contextlib.contextmanager
def _compute_dtypes():
    """The set of dtypes that ``flux.apply`` computes in (its x_t's) while
    the context is open: the trainer's compute dtype."""
    from domainrag_tpu_torch.models.flux import model as fm
    seen, real = set(), fm.apply

    def spy(params, img_tokens, *args, **kw):
        seen.add(img_tokens.dtype)
        return real(params, img_tokens, *args, **kw)
    fm.apply = spy
    try:
        yield seen
    finally:
        fm.apply = real


def _f32_compute(what, seen, counts, want):
    """Raises unless the trainer computed in f32 only (``seen``, from
    ``_compute_dtypes``) and launched ``want``."""
    import torch
    if seen != {torch.float32}:
        raise AssertionError(f"{what}: computed in {sorted(map(str, seen))}"
                             ", not float32 alone")
    if counts != want:
        raise AssertionError(f"{what}: kernel launch counts {counts} differ "
                             f"from {want}")


def phase_small_trainer(dev):
    """A head_dim-128 toy MMDiT (hidden 256, one double and one single
    block) at 128 px: three ``train_step``s on the card and on the CPU
    from the same weights, batches and keys (``fit``'s chain from
    PRNGKey(21): t and eps drawn where the step runs, the card's within
    ``PRNG_ULP`` of the CPU's), once with bf16 batches and once with f32
    batches, both computed in f32 (B5/B6 f32 only). Also the first step's
    gradients, card vs CPU."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.train import flow_match

    cfg = _train_cfg_small()
    tcfg = flow_match.TrainConfig(learning_rate=1e-4)
    steps, grid, s_txt = 3, 8, 32
    rng = np.random.default_rng(21)
    cpu = torch.device("cpu")
    base = fm.init(prng.PRNGKey(21), cfg)
    ids = (torch.as_tensor(fm.make_image_ids(grid, grid)),
           torch.as_tensor(fm.make_text_ids(s_txt)))
    data = [{"x0": rng.standard_normal((2, grid * grid, 64)),
             "txt": rng.standard_normal((2, s_txt, cfg.text_dim)),
             "pooled": rng.standard_normal((2, cfg.pooled_dim))}
            for _ in range(steps)]
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
            key, keys = prng.PRNGKey(21, device=where), []
            for _ in data:
                key, sub = prng.split(key)
                keys.append(sub)
            loss = flow_match.flow_match_loss(params, batches[0], keys[0],
                                              cfg, tcfg)
            grads = torch.autograd.grad(loss, flow_match.leaves(params))
            grad0 = torch.cat([gr.float().reshape(-1).cpu() for gr in grads])
            _reset_counts(mma)
            losses = []
            with _compute_dtypes() as seen:
                for b, k in zip(batches, keys):
                    params, opt, l_ = step(params, opt, b, k)
                    losses.append(l_.item())
            runs.append((losses, grad0, _leaves_cat(params),
                         _trainer_counts(mma), seen))
        (l_card, g_card, p_card, counts, seen), (l_cpu, g_cpu, p_cpu, _,
                                                 _) = runs
        p0 = _leaves_cat(base)
        d_card, d_cpu = p_card - p0, p_cpu - p0
        grad_rel = ((g_card - g_cpu).norm() / g_cpu.norm()).item()
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
        upd_rel = ((d_card - d_cpu).norm() / d_cpu.norm()).item()
        upd_max = (d_card - d_cpu).abs().max().item()
        want = _trainer_want(2, steps)
        print(f"small trainer (batch dtype {dtype}, compute dtype "
              f"{sorted(map(str, seen))}, {steps} steps, 128 px, head_dim "
              f"128): losses card {[round(x, 6) for x in l_card]} CPU "
              f"{[round(x, 6) for x in l_cpu]} (max rel {loss_rel:.3e}), "
              f"first-step grads rel_norm {grad_rel:.3e}, param updates "
              f"rel_norm {upd_rel:.3e} max abs {upd_max:.3e} (lr "
              f"{tcfg.learning_rate}); launches B1/B2/B3/B5/B6/B6 f32 "
              f"{counts} (expected {want})")
        _f32_compute(f"small trainer ({dtype})", seen, counts, want)
        lim = SMALL_TRAIN
        if not (all(np.isfinite(l_card)) and loss_rel < lim[0]
                and grad_rel < lim[1] and upd_rel < lim[2]):
            raise AssertionError(f"small trainer ({dtype}): card and CPU "
                                 "disagree")


# card vs CPU limits of the small trainer: (loss rel, first-step grads
# rel norm, param updates rel norm), about 5x what was measured on the
# H100 with f32 batches. Both batch dtypes compute in f32: summation order
# only, then Adam (g/(|g|+eps) ~ sign g) amplifies it for near-zero
# gradients.
SMALL_TRAIN = (1e-6, 1e-5, 5e-4)


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
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import model as fm
    cfg = dataclasses.replace(fm.FLUX_DEV, depth_double=TRAIN_DEPTH[0],
                              depth_single=TRAIN_DEPTH[1])
    params = fm.init(prng.PRNGKey(5, device=dev), cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
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


def _train_step_twins(dev, cfg, params, batch):
    """JAX's ``train_step`` and ``make_train_step``'s step, one step each
    from the same params and key (the params put back from a copy on
    the card between them; one optimizer state alive at a time): both run
    ``flow_match._step`` on the same kernels, and B6 adds dq in a fixed
    order, so the losses and every updated leaf must be torch.equal. The
    bf16 batch computes in f32: two steps' launches are counted."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.train import flow_match
    t_all = time.perf_counter()
    tcfg = flow_match.TrainConfig(remat=True)
    key = prng.PRNGKey(29, device=dev)
    start = [p.detach().clone() for p in flow_match.leaves(params)]
    optimizer = flow_match.make_optimizer(tcfg)
    opt = optimizer.init(params)
    torch.cuda.synchronize()
    _reset_counts(mma)
    t0 = time.perf_counter()
    with _compute_dtypes() as seen:
        _, opt, loss_a = flow_match.train_step(params, opt, batch, key, cfg,
                                               tcfg, optimizer)
    torch.cuda.synchronize()
    secs_a = time.perf_counter() - t0
    after_a = [p.detach().clone() for p in flow_match.leaves(params)]
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    with torch.no_grad():
        for p, s in zip(flow_match.leaves(params), start):
            p.copy_(s)
    step, params, opt = flow_match.make_train_step(cfg, tcfg, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _compute_dtypes() as seen_b:
        _, opt, loss_b = step(params, opt, batch, key)
    torch.cuda.synchronize()
    secs_b = time.perf_counter() - t0
    seen |= seen_b
    counts = _trainer_counts(mma)
    want = _trainer_want(cfg.depth_double + cfg.depth_single, 2)
    differ = num = den = 0
    moved = False
    for p, s, a in zip(flow_match.leaves(params), start, after_a):
        b = p.detach()
        moved = moved or not torch.equal(b, s)
        if not torch.equal(a, b):
            differ += 1
            num += (a - b).double().square().sum().item()
        den += (b - s).double().square().sum().item()
    del opt, start, after_a
    gc.collect()
    torch.cuda.empty_cache()
    rel_update = (num / max(den, 1e-300)) ** 0.5
    print(f"train_step vs make_train_step's step (same params and key): "
          f"loss {loss_a.item():.6f} / {loss_b.item():.6f} (torch.equal: "
          f"{torch.equal(loss_a, loss_b)}), {differ} of "
          f"{len(flow_match.leaves(params))} updated leaves differ "
          f"(update relative norm {rel_update:.3e}; torch.equal required); "
          f"one step each from a fresh optimizer state {secs_a:.3f} s / "
          f"{secs_b:.3f} s, the check {time.perf_counter() - t_all:.1f} s "
          f"in all ({CARD}); batch dtype {batch['x0'].dtype}, compute dtype "
          f"{sorted(map(str, seen))}, launches B1/B2/B3/B5/B6/B6 f32 "
          f"{counts} (expected {want})")
    _f32_compute("train_step and the step", seen, counts, want)
    if not torch.equal(loss_a, loss_b):
        raise AssertionError("train_step: the loss differs from the step's")
    if differ or not moved:
        raise AssertionError("train_step: the update differs from the "
                             "step's (or moved nothing)")


def phase_train(dev, rows):
    """The trainer at FLUX.1-dev width cut in depth: ``fit`` with remat
    for TRAIN_STEPS steps on synthetic bf16 batches (batch 2, 1024 px =
    4096 image tokens, 512 T5 tokens), computed in f32 as JAX's
    flow_match_loss promotes them, one checkpoint at the end under OUT,
    restored; the launch counts per step, which the f32 rows take."""
    import shutil
    import torch
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.train import checkpoint as ckpt
    from domainrag_tpu_torch.train import flow_match, loop

    print(f"trainer cuts: depth {TRAIN_DEPTH[0]} double + {TRAIN_DEPTH[1]} "
          f"single blocks (FLUX.1-dev has 19 + 38), {TRAIN_STEPS} steps, "
          f"batch {TRAIN_B}, {TRAIN_GRID * 16} px ({TRAIN_GRID ** 2} image "
          f"tokens) + {TRAIN_TXT} T5 tokens, synthetic bf16 batches "
          f"(computed in f32)")
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
    with _compute_dtypes() as seen:
        params, losses = loop.fit(
            params, cfg, batches(), TRAIN_STEPS,
            flow_match.TrainConfig(remat=True), checkpoint_dir=str(root),
            checkpoint_every=1000, seed=0, log_every=1, timer=spans)
    torch.cuda.synchronize()
    counts = _trainer_counts(mma)
    want = _trainer_want(cfg.depth_double + cfg.depth_single, TRAIN_STEPS)
    print(f"launches on the path (batch dtype bfloat16, compute dtype "
          f"{sorted(map(str, seen))}): B1 {counts[0]}, B2 {counts[1]}, B3 "
          f"{counts[2]}, B5 {counts[3]}, B6 bf16 {counts[4]}, B6 f32 "
          f"{counts[5]} (expected {want})")
    _f32_compute("trainer", seen, counts, want)
    _flash_launches(rows, counts[3:])
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
    _train_step_twins(dev, cfg, params, next(batches()))
    return cfg, params, batches


def phase_profile_train(dev, cfg, params, batches):
    """One full-width train step (the phase_train model and batch) under
    torch.profiler, device time grouped (full table in
    OUT/profile_train.txt), beside the wall time of the same step
    untraced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.train import flow_match

    step, params, opt = flow_match.make_train_step(
        cfg, flow_match.TrainConfig(remat=True), params)
    it = batches()
    g = prng.PRNGKey(9, device=dev)
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
        elif re.search(r"FwdRows|fwd_f32_kernel|split_kernel", name):
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
    if PARENT:
        _parent_step_turns("bf16-batch train step",
                           lambda: step(params, opt, batch, g))


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


def phase_train_f32(dev, cfg, params, batches):
    """One full-width ``fit`` step (the phase_train model) on f32 batches,
    the dtype ``latent_batches_from_images`` yields: the same computation
    as a bf16 batch's step (both f32: every block runs the unfused
    composition, B5 f32 in its forward and in its remat recompute and B6
    f32 in its backward). The counts are set to 0 just before and read
    just after. With ``--parent``, four steady steps follow, timed in
    turns with the parent's B6 in two."""
    import torch
    from domainrag_tpu_torch.core import prng
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
    with _compute_dtypes() as seen:
        params, losses = loop.fit(params, cfg, f32, 1,
                                  flow_match.TrainConfig(remat=True), seed=1,
                                  log_every=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _trainer_counts(mma)
    want = _trainer_want(cfg.depth_double + cfg.depth_single)
    print(f"launches on the path (f32 trainer, one step; batch dtype "
          f"float32, compute dtype {sorted(map(str, seen))}): B1 "
          f"{counts[0]}, B2 {counts[1]}, B3 {counts[2]}, B5 {counts[3]}, B6 "
          f"bf16 {counts[4]}, B6 f32 {counts[5]} (expected {want})")
    _f32_compute("f32 trainer", seen, counts, want)
    moved = (probe.detach() - before).abs().max().item()
    if len(losses) != 1 or not np.isfinite(losses[0]) or not moved > 0:
        raise AssertionError(f"f32 trainer: loss {losses}, max |dw| {moved}")
    print(f"f32 trainer: loss {losses[0]:.5f}, params moved (max |dw| "
          f"{moved:.3e} on one leaf), {secs:.3f} s for the step (the first, "
          f"with the optimizer's state allocated), max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not PARENT:
        return
    # steady f32 steps, in turns with the parent's B6
    step, params, opt = flow_match.make_train_step(
        cfg, flow_match.TrainConfig(remat=True), params)
    g = prng.PRNGKey(5, device=dev)
    batch = next(f32)
    step(params, opt, batch, g)                 # the moments are allocated
    _parent_step_turns("f32 train step",
                       lambda: step(params, opt, batch, g))


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
    """The parent commit's B8 (PARENT's csrc, behind this commit's wrapper:
    its C interface is unchanged) on the same inputs: returns a call that
    launches it and gives (scores, indices)."""
    from domainrag_tpu_torch.ops import topk as tk
    return _parent_call(tk, "topk", lambda: tk._launch(q, bank, k))


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


# card vs CPU limits of the run-time draws (core/prng.py): integers, keys
# and uniforms torch.equal; f32 normals within PRNG_ULP ulp and PRNG_ABS
# (the card's log1p may differ from the CPU's in the last bits); bf16
# normals torch.equal (2e-6 is below a bf16 ulp; each of the 128 bf16
# uniforms' f32 erf_inv lies at least 555 f32 ulp from a bf16 tie).
PRNG_ULP, PRNG_ABS = 8, 2e-6


def _f32_ulps(a, b):
    """The largest distance of two f32 tensors in ulps."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs().max().item() if a.numel() else 0


def phase_prng(dev):
    """The run-time draws (``core.prng``, JAX's threefry2x32) on the card
    against the same draws on the CPU, at the main path's shapes: the
    stage-4 noise at 2048 px (``pipeline._noise``, 1 x 16384 x 64 f32), the
    trainer's t and eps at 2 x 4608 x 64 in bf16 and f32
    (``flow_match._draw_t_eps``), a chain of 16 splits (``fit``'s key
    walk) and the loader's picks (``choice`` without and with
    replacement). Each draw's time on the card (CUDA events) beside the
    CPU's (one call, host clock)."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.train import flow_match

    cpu = torch.device("cpu")
    tcfg = flow_match.TrainConfig()

    def chain(where):
        key, subs = prng.PRNGKey(0, device=where), []
        for _ in range(16):
            key, sub = prng.split(key)
            subs.append(sub)
        return torch.stack(subs)

    def t_eps(dtype):
        def draw(where):
            x0 = torch.zeros((TRAIN_B, S_TRAIN, 64), dtype=dtype,
                             device=where)
            return flow_match._draw_t_eps(prng.PRNGKey(0, device=where), x0,
                                          tcfg)
        return draw

    def pick(n, k, replace):
        def draw(where):
            sub = prng.split(prng.PRNGKey(0, device=where))[1]
            return prng.choice(sub, n, (k,), replace=replace)
        return draw

    draws = [
        ("stage-4 noise 2048 px (seed 0)", "normal",
         lambda where: fp._noise(SimpleNamespace(device=where), [0],
                                 (FILL_SIZE // 16) ** 2, 64)),
        ("trainer t, eps bf16", "t_eps", t_eps(torch.bfloat16)),
        ("trainer t, eps f32", "t_eps", t_eps(torch.float32)),
        ("split chain x16", "exact", chain),
        ("choice 2 of 200, no replacement", "exact", pick(200, 2, False)),
        ("choice 4096 of 5000, no replacement", "exact",
         pick(5000, 4096, False)),
        ("choice 8 of 3, replacement", "exact", pick(3, 8, True)),
    ]
    report = []
    for name, kind, fn in draws:
        got = fn(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fn(cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        ms = _ms(lambda: fn(dev), 10)
        pairs = list(zip(got, want)) if kind == "t_eps" else [(got, want)]
        ulp = err = 0.0
        for g, w in pairs:
            g = g.cpu()
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"prng {name}: {g.dtype} {tuple(g.shape)}"
                                     f" on the card, {w.dtype} "
                                     f"{tuple(w.shape)} on the CPU")
            if kind == "exact" or g.dtype == torch.bfloat16:
                ok = torch.equal(g, w)
            else:
                ulp = max(ulp, _f32_ulps(g, w))
                err = max(err, (g - w).abs().max().item())
                ok = ulp <= PRNG_ULP and err <= PRNG_ABS
            if not ok:
                raise AssertionError(
                    f"prng {name}: the card's draw differs from the CPU's "
                    f"(max {ulp} ulp, {err:.3e} abs)")
        shapes = [tuple(g.shape) for g, _ in pairs]
        print(f"prng {name}: {shapes} card {ms:.3f} ms, CPU {cpu_ms:.1f} ms;"
              f" card vs CPU max {ulp:.0f} f32 ulp, {err:.3e} abs "
              f"(integers, uniforms and bf16 torch.equal; {CARD})")
        report.append({"draw": name, "shapes": shapes, "ms": ms,
                       "cpu_ms": cpu_ms, "max_ulp": ulp, "max_abs": err})
    print("prng draws: " + json.dumps(report, separators=(",", ":")))


# the random inits on the card against the CPU: every f32 leaf within
# INIT_ULP ulp (a leaf is a normal times its scale)
INIT_ULP = 3


def phase_init_draws(dev):
    """The random inits (``models.common._draw`` through ``core.prng``) at
    full width on the card against the same keys' CPU draws: the first
    double block and the first single block of the FLUX.1-dev MMDiT of
    ``full_bundle(PRNGKey(0))`` (kept in f32 here) and its T5-XXL
    embedding, from the keys the inits split for them. Every leaf within
    ``INIT_ULP`` f32 ulp; each tree's card and CPU seconds."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import common, t5
    from domainrag_tpu_torch.models.flux import model as fm

    cpu = torch.device("cpu")
    cfg, t5_cfg = fm.FLUX_DEV, t5.T5_XXL

    def keys(where):
        bundle = prng.split(prng.PRNGKey(0, device=where), 6)
        flux = prng.split(bundle[0], 8 + cfg.depth_double + cfg.depth_single)
        embed = prng.split(bundle[2], t5_cfg.layers * 3 + 2)[0]
        return flux[8], flux[8 + cfg.depth_double], embed

    trees = [
        ("double block 0", lambda k: fm._double_block_init(k[0], cfg)),
        ("single block 0", lambda k: fm._single_block_init(k[1], cfg)),
        ("T5-XXL embed", lambda k: {"embed": common.normal_init(
            k[2], (t5_cfg.vocab_size, t5_cfg.d_model), 1.0)}),
    ]
    report = []
    for name, draw in trees:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = draw(keys(dev))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = draw(keys(cpu))
        cpu_s = time.perf_counter() - t0
        paths = _flat_paths(got)
        n = ulp = 0
        for (path, g), (_, w) in zip(paths, _flat_paths(want)):
            g = g.cpu()
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"init {name} {path}: {g.dtype} "
                                     f"{tuple(g.shape)} on the card, "
                                     f"{w.dtype} {tuple(w.shape)} on the CPU")
            ulp = max(ulp, _f32_ulps(g, w))
            n += g.numel()
        if ulp > INIT_ULP:
            raise AssertionError(f"init {name}: the card's tree is {ulp} "
                                 f"ulp from the CPU's (bar {INIT_ULP})")
        print(f"init draw {name}: {len(paths)} leaves, {n / 1e6:.1f} M "
              f"elements; card {card_s:.3f} s ({n / card_s / 1e9:.3f}e9 "
              f"elements/s), CPU {cpu_s:.1f} s; card vs CPU max {ulp} f32 "
              f"ulp ({CARD})")
        report.append({"tree": name, "elements": n, "card_s": card_s,
                       "cpu_s": cpu_s, "max_ulp": ulp})
        del got, want
    torch.cuda.empty_cache()
    print("init draws: " + json.dumps(report, separators=(",", ":")))


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


# ---------------------------------------------------------------------------
# scale-out (parallel/, ops/ring_attention.py): one NCCL rank on the card,
# and the per-rank bodies at the per-rank shapes of a 4-card mesh
# ---------------------------------------------------------------------------

SP_TOKENS = 31866         # the 2800 px fill's joint sequence
MESH_RANKS = 4            # the per-rank shapes of a 4-card mesh
# TP against the unsharded block: in bf16 each rank's row-sharded partial
# is rounded to bf16 before the sum (as an all-reduce of bf16 tensors
# sums): n roundings of up to 2^-8 of a partial (partials up to ~4 in
# magnitude: up to ~6e-2 at n = 4 on an element near 0), one or two bf16
# ulps (2^-7 relative) elsewhere, and the whole within 1e-2 in relative
# norm, which a rank that drops a head or adds the bias twice misses by
# far (measured at the tiny width on the CPU: 2.1e-3 to 4.0e-3).
TP_BAR = (6.4e-2, 3.2e-2, 1e-2)


def _init_group():
    """A one-process NCCL group (``tcp://localhost``, a free port): one
    rank per card, since NCCL refuses several ranks on one card. The group
    answers all_reduce, all_gather, broadcast and barrier on card tensors;
    a failed start raises."""
    import socket
    import torch
    import torch.distributed as dist
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mesh_mod.initialize_distributed(f"tcp://localhost:{port}", 1, 0,
                                    device="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the card's group is {dist.get_backend()}")
    x = torch.arange(4.0, device="cuda")
    dist.all_reduce(x)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    dist.broadcast(x, 0)
    dist.barrier()
    if not torch.equal(parts[0], torch.arange(4.0, device="cuda")):
        raise AssertionError("the NCCL group's all_gather disagrees")
    print(f"scale-out: NCCL group of world size 1 at localhost:{port} "
          "(all_reduce, all_gather, broadcast, barrier on card tensors)")


class _ThreadMesh:
    """One axis of ``n`` ranks as ``n`` threads on the one card, with the
    collectives of ``parallel.mesh.Mesh`` that the per-rank bodies call:
    every rank deposits its tensor at a barrier and the sum (in rank
    order, in the tensor's dtype, as a ring all-reduce sums), max or
    concatenation is computed from all of them. One thread runs at a time
    (a lock handed over at each collective), so the kernels' launch
    counts add as in ``n`` processes."""

    def __init__(self, axis, n):
        import threading
        self.shape = {axis: n}
        self._n = n
        self._barrier = threading.Barrier(n, timeout=600)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._slots = [None] * n

    def index(self, axis):
        return self._local.rank

    def _exchange(self, x):
        self._slots[self._local.rank] = x
        self._lock.release()
        self._barrier.wait()
        self._lock.acquire()
        parts = list(self._slots)
        self._lock.release()
        self._barrier.wait()      # nobody deposits again before all read
        self._lock.acquire()
        return parts

    def all_reduce(self, x, axis, op="sum"):
        import torch
        parts = self._exchange(x)
        out = parts[0]
        for part in parts[1:]:
            out = out + part if op == "sum" else torch.maximum(out, part)
        return out

    def all_gather(self, x, axis, dim=0):
        import torch
        return torch.cat(self._exchange(x), dim=dim)

    def run(self, fn, grad=False):
        """fn(rank) on every rank; their results in rank order. With
        ``grad`` each rank may differentiate: its backward runs on its own
        thread (``set_multithreading_enabled(False)``), since one device
        thread serving every rank's graph would wait in one rank's
        collective for the others."""
        import threading
        import torch
        results, errors = [None] * self._n, []
        device = torch.cuda.current_device()

        def body(rank):
            with self._lock:
                self._local.rank = rank
                try:
                    # the card's context current on this thread before a
                    # kernel library's own runtime launches from it
                    torch.cuda.set_device(device)
                    torch.cuda.synchronize(device)
                    mode = (torch.autograd.set_multithreading_enabled(False)
                            if grad else torch.inference_mode())
                    with mode:
                        results[rank] = fn(rank)
                except BaseException as e:     # noqa: BLE001
                    errors.append(e)
                    self._barrier.abort()
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self._n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


class _RankAlone:
    """What one rank of an ``axis`` of ``n`` ranks sees of the mesh, with
    collectives that return their input: times rank ``rank``'s own body
    (its kernels and the torch ops around them) with no other rank, no
    thread hand-over and no transfer in it."""

    def __init__(self, axis, n, rank):
        self.shape = {axis: n}
        self._rank = rank

    def index(self, axis):
        return self._rank

    def all_reduce(self, x, axis, op="sum"):
        return x

    def all_gather(self, x, axis, dim=0):
        return x

    def reduce_scatter(self, x, axis, dim=0):
        piece = x.shape[dim] // self.shape[axis]
        return x.narrow(dim, self._rank * piece, piece).contiguous()


class _RingAlone(_RankAlone):
    """Rank ``rank`` of a ring axis of ``n`` alone: the gather puts its
    block in its place among zeros, the sums return their input. The
    ranks' outputs and gradients, each computed so, add up to the ring's
    over ``n`` ranks."""

    def all_gather(self, x, axis, dim=0):
        import torch
        parts = [torch.zeros_like(x)] * self.shape[axis]
        parts[self._rank] = x
        return torch.cat(parts, dim=dim)


def _stage3_mesh(bundle, cfg, rr, lama_dir):
    """Stage 3's ``process_dataset`` over a one-rank mesh of the NCCL group
    (``generate_samples_dp``: a sample's ranks in one denoise) and without
    one, the ranks batched as the mesh batches them: the same file names
    and byte-equal rank PNGs."""
    import torch
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.stages import generate as gen

    stage = gen.GenerateStage(bundle, dataclasses.replace(
        cfg, max_rank_batch=None))
    runs = {}
    for tag, kw in (("one", {}), ("mesh", {"mesh": mesh_mod.create_mesh()})):
        out = OUT / f"stage3_{tag}"
        shutil.rmtree(out, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counters = gen.process_dataset(stage, "DIOR", SHOTS, rr, lama_dir,
                                       str(out), run_name="run", worker_id=0,
                                       num_workers=BATCH_WORKERS, **kw)
        torch.cuda.synchronize()
        if counters != {"processed": 2, "failed": 0, "skipped": 0,
                        "fallback": 0}:
            raise AssertionError(f"stage 3 {tag} counters {counters}")
        base = out / "result" / f"DIOR_{SHOTS}shot_retrieval" / "run"
        runs[tag] = (base, time.perf_counter() - t0, sorted(
            p.relative_to(base) for p in base.rglob("*") if p.is_file()))
    (one, one_s, one_files), (mesh, mesh_s, mesh_files) = (runs["one"],
                                                           runs["mesh"])
    if mesh_files != one_files:
        raise AssertionError(f"stage 3 over a mesh wrote {mesh_files}, "
                             f"without one {one_files}")
    pngs = [p for p in one_files if p.name.startswith("generated_image")]
    for rel in pngs:
        if (one / rel).read_bytes() != (mesh / rel).read_bytes():
            raise AssertionError(f"stage 3 over a mesh: {rel} differs")
    print(f"scale-out stage 3: process_dataset(mesh=create_mesh()) on the "
          f"NCCL group, 2 samples x {RANKS} ranks x {STEPS} steps at {SIZE} "
          f"px: {len(mesh_files)} files as without a mesh, {len(pngs)} rank "
          f"PNGs byte-equal; {mesh_s:.3f} s against {one_s:.3f} s ({CARD})")
    shutil.rmtree(OUT / "stage3_one")
    shutil.rmtree(OUT / "stage3_mesh")


def _scale_out_ring(dev, rows):
    """The SP ring of the 2800 px fill on a 4-card mesh, every rank's body
    in turn: the joint sequence padded to 4 blocks, each rank's query
    block folded with the 4 K/V blocks in ring order through
    ``ring_attention.ring_step`` (B5 with the block's ``kv_valid``, then
    ``_merge_partials``), held against the plain dense attention; B5
    launches 16 times and B3 never. Then ``ring_attention`` itself over
    the group's one-rank mesh (one block: one B5 launch)."""
    import torch
    import torch.nn.functional as F
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.ops import ring_attention as ring
    from domainrag_tpu_torch.parallel import mesh as mesh_mod

    g = torch.Generator(device=dev)
    g.manual_seed(41)
    n = MESH_RANKS
    s_pad = -(-SP_TOKENS // n) * n
    block = s_pad // n
    q, k, v = (torch.randn((1, HEADS, SP_TOKENS, HD), generator=g,
                           device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    qb, kb, vb = ([y[:, :, i * block:(i + 1) * block].contiguous()
                   for i in range(n)]
                  for y in (F.pad(x, (0, 0, 0, s_pad - SP_TOKENS))
                            for x in (q, k, v)))
    kv_valid = [min(max(SP_TOKENS - i * block, 0), block) for i in range(n)]
    _reset_counts(mma)
    outs = []
    for rank in range(n):
        out = torch.zeros(qb[rank].shape, dtype=torch.float32, device=dev)
        lse = torch.full(qb[rank].shape[:-1] + (1,), ring.NEG_INF,
                         dtype=torch.float32, device=dev)
        for step in range(n):
            owner = (rank + step) % n
            out, lse = ring.ring_step(qb[rank], kb[owner], vb[owner], out,
                                      lse, kv_valid[owner])
        outs.append(out.to(torch.bfloat16))
    torch.cuda.synchronize()
    launches = attn.flash_attention.launches
    mp = (mma.mmdit_double_attention.mp_launches
          + mma.mmdit_single_attention.mp_launches)
    if launches != n * n or mp:
        raise AssertionError(f"the ring launched B5 {launches} times "
                             f"(want {n * n}) and B3 {mp} times (want 0)")
    got = torch.cat(outs, dim=2)[:, :, :SP_TOKENS]
    want, _ = attn.flash_forward_reference(q, k, v)
    _check(f"ring of {n} B5 blocks, {SP_TOKENS} tokens", got, want)
    del got, want, outs

    last = n - 1
    blk = (qb[0], kb[last], vb[last])
    o, lse = attn.flash_attention_lse(*blk, kv_valid=kv_valid[last])
    ro, rlse = attn.flash_forward_reference(*blk, False, kv_valid[last])
    torch.cuda.synchronize()
    name = f"flash_fwd_bf16_ring_block_s{block}_kv{kv_valid[last]}"
    max_abs = _check(name, o, ro)
    if (lse[..., 0] - rlse).abs().max().item() > LSE_ATOL:
        raise AssertionError(f"{name}: lse disagrees")
    kvv = kv_valid[last]
    rows[name] = _flash_row(
        name, "ops/attention.py:110", max_abs,
        _ms(lambda: attn.flash_attention_lse(*blk, kv_valid=kvv), 20),
        _ms(lambda: attn.flash_forward_reference(*blk, False, kvv), 2, 1),
        _ms(lambda: F.scaled_dot_product_attention(
            blk[0], blk[1][:, :, :kvv], blk[2][:, :, :kvv]), 20),
        _flash_bound(4, (1, HEADS, block, kvv, HD), False))
    rows[name]["launches"] = launches
    zero = torch.zeros(qb[0].shape, dtype=torch.float32, device=dev)
    step_ms = _ms(lambda: ring.ring_step(*blk, zero, zero[..., :1],
                                         kvv), 20)
    print(f"scale-out SP ring: B5 launches {launches}, B3 {mp}; per rank "
          f"{n} B5 blocks of {block} q x {block} "
          f"keys (the last kv_valid {kvv}), {rows[name]['ms']:.3f} ms per "
          f"block, {step_ms:.3f} ms per ring step with the merge, ~"
          f"{n * step_ms:.3f} ms per rank and layer (every rank holds "
          f"K/V whole: the blocks are local slices, no transfer) ({CARD})")
    del qb, kb, vb, blk, o, ro

    short = (1, HEADS, S_TXT + (SIZE // 16) ** 2, HD)
    q, k, v = (torch.randn(short, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    before = attn.flash_attention.launches
    got = ring.ring_attention_padded(q, k, v, mesh_mod.create_mesh())
    if attn.flash_attention.launches - before != 1:
        raise AssertionError("ring_attention over one rank is one B5 call")
    _check(f"ring_attention on the group's mesh, {short[2]} tokens", got,
           attn.flash_forward_reference(q, k, v)[0])
    del q, k, v, got
    torch.cuda.empty_cache()


def _scale_out_topk(dev, rows):
    """Stage 2's bank over 4 ranks: each rank's shard (44,572 rows, the
    last with 1 pad row) searched by B8 in ``sharded_topk``, the
    candidates gathered and merged: the indices and scores
    ``torch.equal`` to ``topk_ip`` on the whole bank (integer rows with
    ties); B8 launches 4 times."""
    import torch
    from domainrag_tpu_torch.ops import topk as tk
    from domainrag_tpu_torch.parallel import collectives

    g = torch.Generator(device=dev)
    g.manual_seed(43)
    q, bank = _int_bank(g, dev, TOPK_Q, TOPK_N, TOPK_D)
    tm = _ThreadMesh("data", MESH_RANKS)
    padded, n_valid = collectives.pad_bank_for_mesh(bank.cpu().numpy(), tm)
    shards = {}

    def rank(r):
        shards[r] = collectives.shard_bank(padded, tm, device=dev)
        return collectives.sharded_topk(q, shards[r], TOPK_K, tm, n_valid,
                                        use_pallas=True)

    tk.topk_ip_fused.launches = 0
    got = tm.run(rank)
    launches = tk.topk_ip_fused.launches
    want = tk.topk_ip(q, bank, TOPK_K)
    torch.cuda.synchronize()
    if launches != MESH_RANKS or not all(
            torch.equal(s, want[0]) and torch.equal(i, want[1])
            for s, i in got):
        raise AssertionError(f"sharded B8: {launches} launches, indices "
                             "or scores not those of topk_ip")
    shard = shards[0]
    n_rows = shard.shape[0]
    name = f"topk_ip_fused_shard_{n_rows}"
    rows[name] = {
        "name": name, "route": "cuda",
        "source": "domainrag_tpu_torch/csrc/topk.cu",
        "replaces": "domainrag_tpu/ops/topk.py:183", "launches": launches,
        "max_abs_err": (tk.topk_ip_fused(q, shard, TOPK_K)[0]
                        - tk.reference_topk_ip_fused(q, shard, TOPK_K)[0]
                        ).abs().max().item(),
        "ms": _ms(lambda: tk.topk_ip_fused(q, shard, TOPK_K), 20),
        "plain_ms": _ms(lambda: tk.reference_topk_ip_fused(q, shard,
                                                           TOPK_K), 5),
        "library_ms": _ms(lambda: torch.topk(torch.matmul(q, shard.T),
                                             TOPK_K, dim=1), 20),
        **_topk_bound(TOPK_Q, n_rows, TOPK_D, TOPK_K)}
    merge_ms = _ms(lambda: tm.run(lambda r: collectives.sharded_topk(
        q, shards[r], TOPK_K, tm, n_valid, use_pallas=True)), 5)
    print(f"scale-out sharded B8: {TOPK_Q} x {TOPK_N} x {TOPK_D} at k "
          f"{TOPK_K} over {MESH_RANKS} shards of {n_rows} rows "
          f"({padded.shape[0] - TOPK_N} pad row): B8 launches {launches}, "
          f"{rows[name]['ms']:.4f} ms per shard (bound "
          f"{rows[name]['bound_ms']:.4f}), the 4 ranks' searches and merges "
          f"in turn {merge_ms:.4f} ms; indices and scores torch.equal to "
          f"topk_ip on the whole bank ({CARD})")
    del q, bank, shards, got, want
    torch.cuda.empty_cache()


def _scale_out_tp(dev):
    """One full-width double block and one single block at 5337 tokens,
    tensor-parallel at n = 2 and 4: every rank's share of the weights
    (``sharding.shard_params``) run in its thread under ``tp_attention``,
    the row-sharded partials summed as the all-reduce sums them; held
    against the unsharded blocks on the same (unfused, B5) attention
    route, in bf16 and under W8A8 (the row's amax all-reduced, f32
    partials). Each rank's body is then timed alone (``_RankAlone``:
    the all-reduces it would wait for are not in the time)."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import common, quant
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.parallel import sharding

    cfg = fm.FLUX_DEV
    k_double, k_single = prng.split(prng.PRNGKey(47, device=dev))
    bf16 = torch.bfloat16
    full = {"double": [fm._double_block_init(k_double, cfg, bf16)],
            "single": [fm._single_block_init(k_single, cfg, bf16)]}
    g = torch.Generator(device=dev)
    g.manual_seed(47)
    s_img = (SIZE // 16) ** 2
    img, txt = (torch.randn((1, s, cfg.hidden), generator=g, device=dev,
                            dtype=torch.bfloat16) for s in (s_img, S_TXT))
    vec = torch.randn((1, cfg.hidden), generator=g, device=dev,
                      dtype=torch.bfloat16)
    cos, sin = _rope_tables(dev)
    x = torch.cat([txt, img], dim=1)

    def blocks(p):
        d = fm._double_block(p["double"][0], img, txt, vec, cos, sin, cfg)
        return torch.cat(d[::-1], dim=1), fm._single_block(
            p["single"][0], x, vec, cos, sin, cfg)

    one = mesh_mod.create_mesh()
    for mode in ("bf16", "w8a8"):
        params = full if mode == "bf16" else quant.quantize_tree(full)
        common.set_int8_activations(mode == "w8a8")
        try:
            with torch.inference_mode(), attn.tp_attention(one):
                ref = blocks(params)
                ref_ms = [_ms(lambda: fm._double_block(
                    params["double"][0], img, txt, vec, cos, sin, cfg), 5),
                    _ms(lambda: fm._single_block(params["single"][0], x, vec,
                                                 cos, sin, cfg), 5)]
            for n in (2, MESH_RANKS):
                tm = _ThreadMesh("model", n)
                local = tm.run(lambda r: sharding.shard_params(params, tm))

                def rank(r, which=None, mesh=tm):
                    with attn.tp_attention(mesh, "model"):
                        if which == "double":
                            return fm._double_block(
                                local[r]["double"][0], img, txt, vec, cos,
                                sin, cfg)
                        if which == "single":
                            return fm._single_block(
                                local[r]["single"][0], x, vec, cos, sin, cfg)
                        return blocks(local[r])

                got = tm.run(rank)
                torch.cuda.synchronize()
                for r in range(1, n):
                    if not all(torch.equal(a, b)
                               for a, b in zip(got[r], got[0])):
                        raise AssertionError(f"TP n={n}: rank {r}'s output "
                                             "differs from rank 0's")
                for what, a, b in zip(("double", "single"), got[0], ref):
                    _check(f"TP n={n} {mode} {what} block, {x.shape[1]} "
                           "tokens, against the unsharded block", a, b,
                           TP_BAR)
                with torch.inference_mode():
                    ms = {w: [_ms(lambda: rank(r, w, _RankAlone("model", n,
                                                                r)), 5)
                              for r in range(n)]
                          for w in ("double", "single")}
                h = cfg.heads // n
                print(f"scale-out TP n={n} {mode}: one rank alone ({h} "
                      f"heads, MLP hidden {cfg.mlp_hidden // n}; the "
                      f"all-reduces not in it), slowest of the {n} ranks: "
                      f"double block {max(ms['double']):.3f} ms, single "
                      f"block {max(ms['single']):.3f} ms (all ranks: "
                      + ", ".join(f"{a:.3f}/{b:.3f}" for a, b in
                                  zip(ms["double"], ms["single"]))
                      + f"); unsharded (unfused, B5) {ref_ms[0]:.3f} / "
                      f"{ref_ms[1]:.3f} ms ({CARD})")
                del local, got
        finally:
            common.set_int8_activations(False)
        del params, ref
        torch.cuda.empty_cache()


def _scale_out_pp(bundle, dev):
    """The full-width MMDiT's blocks as 4 pipeline stages (19 doubles + 1
    zero block = 4 x 5, 38 singles + 2 zero blocks = 4 x 10): the chunks
    run in ring order at 5337 tokens between the embedders and the final
    layer, ``torch.equal`` to ``apply``; then ``pipelined_apply`` over the
    group's one-rank pipe mesh (S = 1), also equal."""
    import torch
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.parallel import pipeline_parallel as pp

    cfg = bundle.flux_cfg
    params = bundle.flux_params
    g = torch.Generator(device=dev)
    g.manual_seed(53)
    grid = SIZE // 16
    img = torch.randn((1, grid * grid, cfg.in_channels), generator=g,
                      device=dev, dtype=torch.bfloat16)
    txt = torch.randn((1, S_TXT, cfg.text_dim), generator=g, device=dev,
                      dtype=torch.bfloat16)
    pooled = torch.randn((1, cfg.pooled_dim), generator=g, device=dev,
                         dtype=torch.bfloat16)
    t = torch.full((1,), 0.5, device=dev)
    guid = torch.full((1,), 3.5, device=dev)
    iid = torch.as_tensor(fm.make_image_ids(grid, grid), device=dev)
    tid = torch.as_tensor(fm.make_text_ids(S_TXT), device=dev)
    args = (img, txt, pooled, t, iid, tid)
    with torch.inference_mode():
        ref = fm.apply(params, *args, cfg, guidance=guid)
        st = pp.prepare_stages(params, MESH_RANKS)
        d, gs = st.per_stage_double, st.per_stage_single
        want = (-(-cfg.depth_double // MESH_RANKS),
                -(-cfg.depth_single // MESH_RANKS))
        if (d, gs) != want or len(st.doubles) != MESH_RANKS * d:
            raise AssertionError(f"{MESH_RANKS} stages of {d} doubles, {gs} "
                                 f"singles (want {want})")
        img_e, txt_e, vec, cos, sin = fm._embed(params, *args, cfg, guid)
        chunks_d = [st.doubles[s * d:(s + 1) * d] for s in range(MESH_RANKS)]
        chunks_s = [st.singles[s * gs:(s + 1) * gs]
                    for s in range(MESH_RANKS)]
        h = torch.cat([txt_e, img_e], dim=1)
        for chunk in chunks_d:
            h = pp.run_doubles(chunk, h, vec, cos, sin, S_TXT, cfg)
        for chunk in chunks_s:
            h = pp.run_singles(chunk, h, vec, cos, sin, cfg)
        out = fm._final(params, h[:, S_TXT:], vec)
        pipe = mesh_mod.Mesh(np.arange(1), ("pipe",))
        one = pp.pipelined_apply(params, pp.prepare_stages(params, 1, pipe),
                                 *args, cfg, pipe, guidance=guid)
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(one, ref)):
            raise AssertionError("the pipeline's chunks (or pipelined_apply "
                                 "on one rank) differ from apply")
        h0 = torch.cat([txt_e, img_e], dim=1)
        ms_d = _ms(lambda: pp.run_doubles(chunks_d[0], h0, vec, cos, sin,
                                          S_TXT, cfg), 5)
        ms_s = _ms(lambda: pp.run_singles(chunks_s[0], h0, vec, cos, sin,
                                          cfg), 5)
        ms_zero = [_ms(lambda: pp.run_doubles(chunks_d[-1][-1:], h0, vec,
                                              cos, sin, S_TXT, cfg), 5),
                   _ms(lambda: pp.run_singles(chunks_s[-1][-1:], h0, vec,
                                              cos, sin, cfg), 5)]
    print(f"scale-out PP S={MESH_RANKS}: chunks of {d} doubles (the last "
          f"with {MESH_RANKS * d - cfg.depth_double} zero block) and {gs} "
          f"singles (the last with {MESH_RANKS * gs - cfg.depth_single}), "
          f"{S_TXT} "
          f"+ {grid * grid} tokens: torch.equal to apply, and "
          f"pipelined_apply over one rank too; a double chunk "
          f"{ms_d:.3f} ms, a single chunk {ms_s:.3f} ms per stage and "
          f"forward; a zero block costs {ms_zero[0]:.3f} / {ms_zero[1]:.3f} "
          f"ms ({CARD})")
    del ref, out, one, st, chunks_d, chunks_s
    torch.cuda.empty_cache()


def phase_scale_out(bundle, dev, rows):
    """The scale-out phase on the one card: ``create_mesh`` over the NCCL
    group, then the per-rank bodies of a 4-card mesh at their full-width
    shapes (the SP ring, sharded B8, TP halves, PP chunks)."""
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    t0 = time.perf_counter()
    mesh = mesh_mod.create_mesh()
    if mesh.shape != {"data": 1, "model": 1}:
        raise AssertionError(f"the group's mesh is {mesh.shape}")
    _scale_out_ring(dev, rows)
    _scale_out_topk(dev, rows)
    _scale_out_tp(dev)
    _scale_out_pp(bundle, dev)
    print(f"scale-out phase: {time.perf_counter() - t0:.1f} s ({CARD})")


# ---------------------------------------------------------------------------
# training over a mesh: fit on the one-rank NCCL mesh, a TP rank, an FSDP
# rank, the ring's gradient; ops/image.py
# ---------------------------------------------------------------------------

TP_CHECK_DEPTH = (1, 1)   # cut of the threaded TP check (2 ranks in turn)
RING_RAGGED = 4500        # a ragged joint sequence: last block kv 1044
# the sharded step's gradients, gathered, against the unsharded step's on
# the same kernels (both unfused: B5/B6 f32, on f32 batches, so that only
# the order of the partial sums differs): GRAD_REL over the whole tree
# and TP_GRAD_LEAF per leaf, which a rank that drops its share of a leaf
# (a missing all-reduce: half of it at n = 2) misses by far. (bf16
# batches round each rank's partial to bf16 first: 6.4e-3 over the tree
# and 1.1e-2 on a qk-norm scale in a CPU rehearsal at a tiny width, too
# near a bar to hold a run to.)
TP_GRAD_LEAF = 5e-2


def _by_path(tree):
    from domainrag_tpu_torch.parallel import sharding
    out = {}
    sharding._map_with_path(lambda names, x: out.setdefault(names, x), tree)
    return out


class _FsdpAlone(_RankAlone):
    """Rank 0 of a data axis of ``n`` for FSDP's step: the gathers return
    ``n`` copies of its shard (the whole leaf's shape), the sums their
    input."""

    def __init__(self, axis, n, rank):
        super().__init__(axis, n, rank)
        self.shape = {axis: n, "model": 1}

    def all_gather(self, x, axis, dim=0):
        import torch
        return torch.cat([x] * self.shape[axis], dim=dim)


def _mesh_fit(dev, rows):
    """``fit(mesh=create_mesh(), fsdp=True)`` on the one-rank NCCL mesh,
    with a checkpoint, against the one-card step (``make_train_step``),
    run twice, from the same params, batches and seed, 2 steps. On one
    rank the three run one step body on the same kernels, and B6 adds dq
    over the kv blocks in a fixed order, so both losses and every leaf
    after the 2 steps must be torch.equal across the three runs (and the
    leaves must have moved). The checkpoint must restore fit's final
    tree, torch.equal. The bf16 batches compute in f32: the six steps'
    launches are counted."""
    import shutil
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    from domainrag_tpu_torch.train import checkpoint as ckpt
    from domainrag_tpu_torch.train import flow_match, loop
    cfg, params, batches = _full_train_setup(dev)
    it = batches()
    data = [next(it) for _ in range(2)]
    tcfg = flow_match.TrainConfig(remat=True)
    start = [p.detach().clone() for p in flow_match.leaves(params)]
    runs = []
    _reset_counts(mma)
    with _compute_dtypes() as seen:
        for _ in range(2):
            step, tree, opt = flow_match.make_train_step(
                cfg, tcfg, _tree(lambda t: t.detach().clone(), params))
            key, losses = prng.PRNGKey(0, device=dev), []
            for b in data:              # fit's key walk from its seed
                key, sub = prng.split(key)
                losses.append(step(tree, opt, b, sub)[2].item())
            runs.append((losses, flow_match.leaves(tree)))
            del opt
        root = OUT / "mesh_ckpt"
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, losses = loop.fit(params, cfg, iter(data), 2, tcfg,
                                 mesh=mesh_mod.create_mesh(), fsdp=True,
                                 checkpoint_dir=str(root), seed=0,
                                 log_every=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = _trainer_counts(mma)
    want_counts = _trainer_want(cfg.depth_double + cfg.depth_single, 6)

    def differ(a, b):
        """The leaves of ``a`` that are not torch.equal to ``b``'s."""
        return sum(not torch.equal(x.detach(), y.detach())
                   for x, y in zip(a, b))

    (want, one), (again, two) = runs
    fit_leaves = flow_match.leaves(final)
    apart = (differ(two, one), differ(fit_leaves, one))
    moved = differ(one, start)
    restored = ckpt.restore_checkpoint(str(root))["params"]
    same = all(torch.equal(x, y.detach().cpu()) for x, y in zip(
        flow_match.leaves(restored), fit_leaves))
    del restored
    shutil.rmtree(root)
    print(f"[{CARD}] fit over the one-rank NCCL mesh (fsdp=True) vs the "
          f"one-card step (two runs), 2 steps from the same params, batches "
          f"and seed: losses {losses} vs {want} and {again}; leaves not "
          f"torch.equal to the first one-card run's: second run {apart[0]}, "
          f"fit {apart[1]} of {len(one)} ({moved} moved from the start); "
          f"checkpoint restores fit's tree: {same}; {secs:.3f} s for fit's 2 "
          "steps and its checkpoint (the first step allocates the "
          f"optimizer's state); bf16 batches, compute dtype "
          f"{sorted(map(str, seen))}, launches B1/B2/B3/B5/B6/B6 f32 over "
          f"the 6 steps {counts} (expected {want_counts})")
    _f32_compute("fit over the one-rank mesh", seen, counts, want_counts)
    if losses != want or again != want or any(apart) or not moved:
        raise AssertionError("fit over the one-rank mesh and the one-card "
                             "step do not repeat one another bit for bit")
    if not same:
        raise AssertionError("fit over the one-rank mesh: its checkpoint "
                             "does not restore its final tree")


def _tp_loss_grads(tree, batch, cfg, tcfg, t, eps, mesh):
    """The flow-matching loss of ``tree`` under ``tp_attention(mesh)`` and
    its gradients (the unfused composition: B5 forward, B6 backward)."""
    import torch
    from domainrag_tpu_torch.ops.attention import tp_attention
    from domainrag_tpu_torch.train import flow_match
    leaves = flow_match.leaves(tree)
    for p in leaves:
        p.requires_grad_(True)
    with tp_attention(mesh):
        loss = flow_match.flow_match_loss(tree, batch, None, cfg, tcfg, t=t,
                                          eps=eps)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    from domainrag_tpu_torch.parallel import sharding
    return loss.detach(), sharding._map_with_path(lambda _, x: next(it),
                                                  tree)


def _mesh_tp(dev, rows):
    """A TP rank's train step. Correctness: at 2 ranks (threads, the
    collectives of ``_ThreadMesh``) at full width cut to 1 + 1 blocks,
    the gathered gradients against the unsharded step's on the same
    kernels. Timing: rank 0 of 4 (6 of 24 heads) alone at the trainer's
    cut, forward + backward with remat on a bf16 batch (computed in f32),
    and its exact B5/B6 counts."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.parallel import sharding
    from domainrag_tpu_torch.train import flow_match
    tcfg = flow_match.TrainConfig(remat=True)
    cfg = dataclasses.replace(fm.FLUX_DEV, depth_double=TP_CHECK_DEPTH[0],
                              depth_single=TP_CHECK_DEPTH[1])
    params = fm.init(prng.PRNGKey(31, device=dev), cfg)
    _, _, batches = _full_train_setup(dev)
    batch = next(batches())
    f32 = {k: v.float() if k in ("x0", "txt", "pooled") else v
           for k, v in batch.items()}
    t, eps = flow_match._draw_t_eps(prng.PRNGKey(31, device=dev), f32["x0"],
                                    tcfg)
    loss1, want = _tp_loss_grads(params, f32, cfg, tcfg, t, eps,
                                 _RankAlone("model", 1, 0))
    want = _by_path(want)
    tm = _ThreadMesh("model", 2)

    def body(rank):
        local = sharding.shard_params(params, tm)
        loss, grads = _tp_loss_grads(local, f32, cfg, tcfg, t, eps, tm)
        return loss, sharding.unshard_params(grads, params, tm)

    results = tm.run(body, grad=True)
    got = _by_path(results[0][1])
    num = sum((got[k].float() - w.float()).square().sum() for k, w in
              want.items())
    den = sum(w.float().square().sum() for w in want.values())
    whole = (num / den).sqrt().item()
    worst = max((((got[k].float() - w.float()).norm()
                  / w.float().norm().clamp_min(1e-30)).item(), k)
                for k, w in want.items())
    print(f"[{CARD}] TP train step, 2 ranks in threads at full width cut "
          f"to {TP_CHECK_DEPTH} blocks, f32 batch {TRAIN_B} x "
          f"{S_TRAIN} tokens: losses {results[0][0].item():.6f} / "
          f"{results[1][0].item():.6f} vs unsharded {loss1.item():.6f}; "
          f"gathered gradients rel_norm {whole:.3e} (tol {GRAD_REL}), "
          f"worst leaf {worst[0]:.3e} at {'/'.join(worst[1])} (tol "
          f"{TP_GRAD_LEAF})")
    if not (whole < GRAD_REL and worst[0] < TP_GRAD_LEAF) or abs(
            results[0][0].item() - loss1.item()) > 1e-2 * abs(loss1.item()):
        raise AssertionError("TP train step: the sharded gradients differ")
    del params, want, got, results
    torch.cuda.empty_cache()
    # rank 0 of 4 alone at the trainer's cut
    cfg, params, _ = _full_train_setup(dev)
    alone = _RankAlone("model", MESH_RANKS, 0)
    local = sharding.shard_params(params, alone)
    heads = local["double"][0]["img_qkv"]["w"].shape[1] // (3 * HD)

    def fwd_bwd():
        return _tp_loss_grads(local, batch, cfg, tcfg, t, eps, alone)

    _reset_counts(mma)
    with _compute_dtypes() as seen:
        fwd_bwd()
    torch.cuda.synchronize()
    counts = _trainer_counts(mma)
    want_counts = _trainer_want(cfg.depth_double + cfg.depth_single)
    ms = _ms(fwd_bwd, 10, 2)
    print(f"[{CARD}] TP rank 0 of {MESH_RANKS} ({heads} of {HEADS} heads) "
          f"alone, trainer cut {TRAIN_DEPTH}, bf16 batch {TRAIN_B} x "
          f"{S_TRAIN} tokens, compute dtype {sorted(map(str, seen))}, "
          f"remat: forward + backward {ms:.1f} ms; launches "
          f"B1/B2/B3/B5/B6/B6 f32 {counts} (expected {want_counts})")
    _f32_compute("TP rank", seen, counts, want_counts)
    _flash_tp_rows(dev, rows, heads, counts)
    del params, local
    torch.cuda.empty_cache()


def _flash_tp_rows(dev, rows, heads, counts):
    """B5 and B6 at a TP rank's attention shape (2, 6, 4608, 128), in f32
    (the rank's train step, which takes ``counts``, its
    ``_trainer_counts``) and in bf16 (held, on no train step): against the
    plain versions, every B6 call twice torch.equal, with the kernel,
    plain and SDPA times."""
    import torch
    import torch.nn.functional as F
    from domainrag_tpu_torch.ops import attention as attn
    g = torch.Generator(device=dev)
    g.manual_seed(32)
    shape = (TRAIN_B, heads, S_TRAIN, S_TRAIN, HD)
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        tag = "f32" if f32 else "bf16"
        q, k, v, do = (torch.randn((TRAIN_B, heads, S_TRAIN, HD),
                                   generator=g, device=dev).to(dtype)
                       for _ in range(4))
        out, lse = attn._kernel_forward(q, k, v, False, None)
        want, want_lse = attn.flash_forward_reference(q, k, v)
        name = f"flash_fwd_{tag}_tp_rank_h{heads}_s{S_TRAIN}"
        err = (_check_grad(name, out, want, True) if f32
               else _check(name, out, want))
        if (lse - want_lse).abs().max().item() > LSE_ATOL:
            raise AssertionError(f"{name}: lse disagrees")
        rows[name] = _flash_row(
            name, "ops/attention.py:110", err,
            _ms(lambda: attn._kernel_forward(q, k, v, False, None), 20),
            _ms(lambda: attn.flash_forward_reference(q, k, v), 3, 1),
            _ms(lambda: F.scaled_dot_product_attention(q, k, v), 20),
            _flash_bound(24, shape, f32, 4, PEAK_BF16) if f32
            else _flash_bound(4, shape, f32))
        rows[name]["launches"] = counts[3] if f32 else 0
        buf = attn.backward_buffers(q, k, v, want, want_lse, do, False)
        name = f"flash_bwd_{tag}_tp_rank_h{heads}_s{S_TRAIN}"

        def b6():
            attn.launch_backward(buf)
            return buf.dq, buf.dk, buf.dv
        got = _b6_repeats(name, b6)
        ref = attn.flash_backward_reference(q, k, v, want, want_lse, do)
        errs = [_check_grad(f"{name} d{nm}", a.reshape(
            q.shape[:3] + (-1,))[..., :HD], b, f32)
            for nm, a, b in zip("qkv", got, ref)]
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves)
        rows[name] = _flash_row(
            name, "ops/attention.py:296,336", max(errs),
            _ms(lambda: attn.launch_backward(buf), 10),
            _ms(lambda: attn.flash_backward_reference(q, k, v, want,
                                                      want_lse, do), 3, 1),
            _ms(lambda: torch.autograd.grad(sdpa, leaves, do,
                                            retain_graph=True), 10),
            _flash_bound(30, shape, f32, 8, PEAK_TF32) if f32
            else _flash_bound(10, shape, f32, 8))
        rows[name]["launches"] = counts[5] if f32 else counts[4]
        if PARENT:
            _parent_b6(name, buf, lambda: attn.launch_backward(buf), 10)
        del q, k, v, do, out, want, buf, got, ref, leaves, sdpa
        torch.cuda.empty_cache()


def _mesh_fsdp(dev, rows):
    """Rank 0 of an FSDP data axis of 4 at the trainer's cut, alone (the
    gathers stand in): the bytes of its params, gradients and AdamW state
    against the whole tree's, its step's time, and the launches of its
    first step on a bf16 batch (computed in f32)."""
    import torch
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.train import flow_match
    cfg, params, batches = _full_train_setup(dev)
    whole = sum(t.numel() * t.element_size()
                for t in flow_match.leaves(params))
    b0 = next(batches())
    batch = {k: torch.cat([v] * MESH_RANKS) if v.dim() > 2 or k == "pooled"
             else v for k, v in b0.items()}
    mesh = _FsdpAlone("data", MESH_RANKS, 0)
    step, local, opt, _ = flow_match.make_sharded_train_step(
        mesh, cfg, flow_match.TrainConfig(remat=True), params, fsdp=True)
    g = prng.PRNGKey(33, device=dev)
    _reset_counts(mma)
    with _compute_dtypes() as seen:
        step(local, opt, batch, g)               # the moments are allocated
    torch.cuda.synchronize()
    counts = _trainer_counts(mma)
    want = _trainer_want(cfg.depth_double + cfg.depth_single)
    ms = _ms(lambda: step(local, opt, batch, g), 2, 0)
    mine = sum(t.numel() * t.element_size()
               for t in flow_match.leaves(local))
    state = sum(v.numel() * v.element_size() for st in opt.state.values()
                for v in st.values() if torch.is_tensor(v) and v.dim())
    print(f"[{CARD}] FSDP rank 0 of {MESH_RANKS} alone (stand-in gathers), "
          f"trainer cut {TRAIN_DEPTH}, bf16 batch {TRAIN_B} of "
          f"{TRAIN_B * MESH_RANKS}: params {mine / 1e9:.3f} GB of "
          f"{whole / 1e9:.3f} GB ({mine / whole:.3f}), grads "
          f"{mine / 1e9:.3f} GB, AdamW state {state / 1e9:.3f} GB of "
          f"{2 * whole / 1e9:.3f} GB; step {ms:.1f} ms; compute dtype "
          f"{sorted(map(str, seen))}, launches B1/B2/B3/B5/B6/B6 f32 "
          f"{counts} (expected {want})")
    _f32_compute("FSDP rank", seen, counts, want)
    if not (mine < whole and state <= 2 * mine + 1e6):
        raise AssertionError("FSDP rank: its share is not a share")
    del params, local, opt
    torch.cuda.empty_cache()


def _mesh_ring(dev, rows):
    """The ring's gradient at the trainer's sequence over 4 ranks, in f32
    (the trainer's compute dtype, which a bf16 batch takes too) and in
    bf16: on one block (2 x 24 x 1152 x 1152 x 128) and a ragged one, B5
    against its plain version and B6 with the LSE's gradient against its
    plain version, twice torch.equal; then ``ring_attention``
    differentiated by autograd (``_Ring``'s backward on autograd's device
    thread) on each of 4 ranks in turn, summed, on the whole and on a
    ragged sequence, and on the one-rank mesh of the NCCL group, against
    f32 dense attention and its autograd, with exact B5/B6 counts."""
    import torch
    import torch.nn.functional as F
    from domainrag_tpu_torch.ops import attention as attn
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.ops import ring_attention as ring
    from domainrag_tpu_torch.parallel import mesh as mesh_mod
    g = torch.Generator(device=dev)
    g.manual_seed(34)
    n, blk = MESH_RANKS, S_TRAIN // MESH_RANKS
    ragged = RING_RAGGED - (n - 1) * blk
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        tag = "f32" if f32 else "bf16"
        q, k, v, do = (torch.randn((TRAIN_B, HEADS, S_TRAIN, HD),
                                   generator=g, device=dev).to(dtype)
                       for _ in range(4))
        shape = (TRAIN_B, HEADS, blk, blk, HD)
        for kv_valid in (blk, ragged):
            qb, kb, vb, dob = (x[:, :, :blk].contiguous()
                               for x in (q, k, v, do))
            out, lse = attn._kernel_forward(qb, kb, vb, False, kv_valid)
            want_out, want_lse = attn.flash_forward_reference(
                qb, kb, vb, False, kv_valid)
            tag_fwd = f"flash_fwd_{tag}_ring_block_s{blk}_kv{kv_valid}"
            if f32:
                _check_grad(tag_fwd, out, want_out, True)
            else:
                _check(tag_fwd, out, want_out)
            if (lse - want_lse).abs().max().item() > LSE_ATOL:
                raise AssertionError(f"{tag_fwd}: lse disagrees")
            dlse = torch.randn(lse.shape, generator=g, device=dev)
            args = (qb, kb, vb, out, lse, dob, False, kv_valid, dlse)
            name = f"flash_bwd_{tag}_ring_block_s{blk}_kv{kv_valid}"
            _poison(kb)
            got = _b6_repeats(name, lambda: attn._kernel_backward(*args))
            want = attn.flash_backward_reference(*args)
            errs = [_check_grad(f"{name} d{nm}", a, b, f32)
                    for nm, a, b in zip("qkv", got, want)]
            leaves = [x.detach().requires_grad_() for x in (qb, kb, vb)]
            sdpa = F.scaled_dot_product_attention(*leaves)
            bshape = shape[:3] + (kv_valid, HD)
            rows[name] = _flash_row(
                name, "ops/attention.py:296,336", max(errs),
                _ms(lambda: attn._kernel_backward(*args), 20),
                _ms(lambda: attn.flash_backward_reference(*args), 3, 1),
                _ms(lambda: torch.autograd.grad(sdpa, leaves, dob,
                                                retain_graph=True), 20),
                _flash_bound(30, bshape, f32, 8, PEAK_TF32) if f32
                else _flash_bound(10, bshape, f32, 8))
            if PARENT:
                buf = attn.backward_buffers(*args)
                _parent_b6(name, buf, lambda: attn.launch_backward(buf), 20)
                del buf
            del out, lse, want_out, want_lse, got, want, leaves, sdpa
        # the entry point, differentiated: every rank of 4 in turn (a mesh
        # stand-in of its index: their outputs and gradients add up to the
        # ring's), on the whole sequence and on a ragged one, then the
        # one-rank mesh of the NCCL group; B6 counted per (Sq, Skv,
        # kv_valid)
        _reset_counts(mma)
        rels = []
        for s_valid in (S_TRAIN, RING_RAGGED):
            xs = [x[:, :, :s_valid] for x in (q, k, v, do)]
            got = [0.0] * 4
            for i in range(n):
                leaves = [x.detach().requires_grad_() for x in xs[:3]]
                # zero-padded to S_TRAIN: the last block holds `ragged` keys
                out = ring.ring_attention(
                    *(F.pad(x, (0, 0, 0, S_TRAIN - s_valid))
                      for x in leaves),
                    _RingAlone("data", n, i),
                    seq_valid=s_valid)[:, :, :s_valid]
                part = (out,) + torch.autograd.grad(out, leaves, xs[3])
                got = [a + b.float() for a, b in zip(got, part)]
                del out, part, leaves
            rels.append(_ring_rels(got, xs, attn))
            del got
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = ring.ring_attention(*leaves, mesh_mod.create_mesh())
        got = (out,) + torch.autograd.grad(out, leaves, do)
        rels.append(_ring_rels(got, (q, k, v, do), attn))
        del out, got, leaves
        torch.cuda.synchronize()
        counts = _flash_counts()
        by_shape = dict(attn.flash_attention.bwd_launches_by_shape)
        # per rank of n: B5 n in the forward and n in the backward's
        # recompute, B6 n (the kernel of the dtype); the ragged sequence's
        # block n - 1 holds `ragged` keys
        want_shape = {(blk, blk, blk): n * n + n * (n - 1),
                      (blk, blk, ragged): n, (S_TRAIN, S_TRAIN, S_TRAIN): 1}
        b6 = 2 * n * n + 1
        want = (2 * 2 * n * n + 2, 0 if f32 else b6, b6 if f32 else 0)
        for kv in (blk, ragged):
            rows[f"flash_bwd_{tag}_ring_block_s{blk}_kv{kv}"]["launches"] = \
                by_shape.get((blk, blk, kv), 0)
        worst = max(max(r) for r in rels)
        tol = F32_REL if f32 else GRAD_REL
        print(f"[{CARD}] ring gradient through ring_attention: {n} ranks in "
              f"turn over {TRAIN_B} x {HEADS} x {S_TRAIN} x {HD} {tag}, {n} "
              f"ranks over the ragged {RING_RAGGED}, the one-rank NCCL "
              f"mesh: out/dq/dk/dv rel_norm "
              + "; ".join(", ".join(f"{x:.3e}" for x in r) for r in rels)
              + f" (tol {tol}) against autograd of f32 dense attention; "
              f"B5/B6 bf16/B6 f32 {counts} (expected {want}); B6 by (Sq, "
              f"Skv, kv_valid) {by_shape} (expected {want_shape})")
        if worst >= tol or counts != want or by_shape != want_shape:
            raise AssertionError(f"the ring's gradient ({tag}) differs")
        del q, k, v, do
        torch.cuda.empty_cache()


def _ring_rels(got, xs, attn):
    """The relative norm distance of the ring's (out, dq, dk, dv) to f32
    dense attention's and its autograd on the same q, k, v, dout."""
    import torch
    leaves = [x.detach().float().requires_grad_() for x in xs[:3]]
    dense = attn.attention_reference(*leaves)
    want = (dense.detach(),) + torch.autograd.grad(dense, leaves,
                                                   xs[3].float())
    return [((a.float() - b).norm() / b.norm()).item()
            for a, b in zip(got, want)]


def _mesh_image(dev, rows):
    """``ops/image.py`` on the card against the CPU: the masks equal, the
    resizes within 1e-5 (f32)."""
    import torch
    from domainrag_tpu_torch.ops import image
    g = torch.Generator().manual_seed(35)
    boxes = torch.tensor([[10, 20, 300, 400], [-5, -5, 64, 64],
                          [900, 700, 300, 300], [0, 0, 0, 5]],
                         dtype=torch.float32)
    for n_valid in (None, 2):
        cpu = image.boxes_mask(800, 1024, boxes, n_valid, 255.0)
        card = image.boxes_mask(800, 1024, boxes.to(dev), n_valid, 255.0)
        if not torch.equal(card.cpu(), cpu):
            raise AssertionError("boxes_mask: card and CPU differ")
    img = torch.rand((2, 256, 384, 3), generator=g)
    worst = 0.0
    for fn in (image.resize_bicubic, image.resize_bilinear):
        for hw in ((512, 768), (97, 131)):
            err = (fn(img.to(dev), *hw).cpu() - fn(img, *hw)).abs().max()
            worst = max(worst, err.item())
    print(f"[{CARD}] ops/image.py: boxes_mask equal on card and CPU; "
          f"resizes (bicubic, bilinear; up and down) max_abs {worst:.2e} "
          "(tol 1e-5)")
    if worst > 1e-5:
        raise AssertionError("ops/image.py resizes: card and CPU differ")


def phase_train_mesh(dev, rows):
    """Training over a mesh on the one card (the phase after the
    trainer's, with the card to itself): fit on the one-rank NCCL mesh,
    a TP rank, an FSDP rank, the ring's gradient, and ``ops/image.py``."""
    t0 = time.perf_counter()
    for part in (_mesh_fit, _mesh_tp, _mesh_fsdp, _mesh_ring, _mesh_image):
        t1 = time.perf_counter()
        part(dev, rows)
        print(f"train-mesh {part.__name__}: {time.perf_counter() - t1:.1f} s")
    print(f"[{CARD}] train-mesh phase: {time.perf_counter() - t0:.1f} s")


STAGE_ROOT = OUT / "stages"   # stages 1 -> 2 -> 3 share this tree
LAMA_SIZE = 256           # the card-vs-CPU check of lama.apply
# lama.apply card vs CPU in f32 (TF32 off; cuFFT against pocketfft, cuDNN
# against oneDNN convolutions): max abs error on the [0, 1] output
LAMA_BAR = 1e-4


def _lama_bound_ms(cfg, h, w, n_params):
    """The least time of one ``lama.apply`` at (h, w) in f32: every conv
    multiply-add (2 FLOP) and the FFTs' 5 N log2 N per transform at the
    f32 FMA peak, or its weights and input/output bytes once (the convs
    dominate by far). Returns (bound ms, GFLOP)."""
    def split(c, r):
        return c - int(c * r), int(c * r)

    def ffc(c_in, c_out, k, r_in, r_out, px):
        (il, ig), (ol, og) = split(c_in, r_in), split(c_out, r_out)
        macs = k * k * px * (il * ol + il * og + ig * ol)
        fft = 0.0
        if ig and og:
            mid = og // 2
            half = px // 2 + px ** 0.5             # rfft2 output bins
            macs += px * (ig * mid + mid * og) + half * 4 * mid * mid
            fft = 2 * 5 * px * math.log2(px) * mid / 2
        return 2 * macs + fft

    px = h * w
    flop = ffc(cfg.in_channels, cfg.ngf, 7, 0, 0, px)
    for i in range(cfg.n_downsampling):
        px //= 4
        flop += ffc(cfg.ngf * 2 ** i, cfg.ngf * 2 ** (i + 1), 3, 0,
                    cfg.global_ratio if i == cfg.n_downsampling - 1
                    else 0, px)
    feat = cfg.bottleneck
    flop += 2 * cfg.n_blocks * ffc(feat, feat, 3, cfg.global_ratio,
                                   cfg.global_ratio, px)
    for i in range(cfg.n_downsampling):       # transposed: per input pixel
        c_in = cfg.ngf * 2 ** (cfg.n_downsampling - i)
        flop += 2 * 9 * c_in * (c_in // 2) * px
        px *= 4
    flop += 2 * 49 * cfg.ngf * cfg.out_channels * px
    nbytes = 4.0 * (n_params + h * w * (4 + 3))
    return max(flop / PEAK_F32, nbytes / PEAK_BYTES) * 1e3, flop / 1e9


def _lama_dataset(rng, ds_dir):
    """A DIOR 10-shot COCO dataset: 20 classes x 10 images at 800x800,
    1-3 boxes each, the first box of an image in its class (the category
    stage 1's sidecar records). Returns {sample_id: class}."""
    from domainrag_tpu_torch.core.coco import write_coco
    (ds_dir / "train").mkdir(parents=True)
    images, anns, mapping = [], [], {}
    for c, cls in enumerate(DIOR_CLASSES):
        for s in range(SHOTS):
            i = c * SHOTS + s
            sid = f"{i:05d}"
            mapping[sid] = cls
            images.append({"id": i + 1, "file_name": f"{sid}.jpg",
                           "width": 800, "height": 800})
            _jpeg(rng, ds_dir / "train" / f"{sid}.jpg", 800, 800)
            for b in range(int(rng.integers(1, 4))):
                w, h = (int(v) for v in rng.integers(40, 240, 2))
                x, y = (int(v) for v in rng.integers(0, 800 - 40, 2))
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "category_id": c + 1 if b == 0 else
                             int(rng.integers(1, 21)),
                             "bbox": [x, y, w, h]})
    write_coco(str(ds_dir / "annotations" / f"{SHOTS}_shot.json"), images,
               anns, [{"id": c + 1, "name": n}
                      for c, n in enumerate(DIOR_CLASSES)])
    return mapping


def phase_inpaint(dev):
    """Stage 1 at big-lama width: ``BIG_LAMA`` (18 FFC blocks, ngf 64)
    drawn on the card; ``lama.apply`` on one 256x256 image on the card and
    on the CPU from the same weights, within LAMA_BAR (both also against
    an f64 run on the card, beside a TF32 run); then ``process_dataset``
    on a synthetic DIOR 10-shot dataset (200 images at 800x800, 20
    classes, 1-3 boxes each) into ``STAGE_ROOT/lamainpaint``: the file
    tree, the manifest (all done) and ``category_mapping.json`` checked,
    seconds per image and the load / mask / lama / save spans. Returns
    ({sample_id: inpainted path}, {sample_id: class}) for stage 2."""
    import shutil
    import torch
    from PIL import Image
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import lama
    from domainrag_tpu_torch.stages import inpaint

    shutil.rmtree(STAGE_ROOT, ignore_errors=True)
    cfg = lama.BIG_LAMA
    params = lama.init(prng.PRNGKey(0, device=dev), cfg)
    n_params = sum(t.numel() for t in _leaves(params))
    cpu_params = _tree(lambda t: t.cpu(), params)
    rng = np.random.default_rng(11)
    img = torch.from_numpy(rng.random((1, LAMA_SIZE, LAMA_SIZE, 3),
                                      np.float32))
    mask = torch.zeros((1, LAMA_SIZE, LAMA_SIZE, 1))
    mask[:, 40:120, 64:200] = 1.0
    mask[:, 180:230, 20:90] = 1.0
    img_d, mask_d = img.to(dev), mask.to(dev)
    with torch.inference_mode():
        card = lama.apply(params, img_d, mask_d, cfg).cpu()
        t0 = time.perf_counter()
        want = lama.apply(cpu_params, img, mask, cfg)
        cpu_s = time.perf_counter() - t0
        err = (card - want).abs().max().item()
        # where the error comes from: both f32 runs against an f64 run on
        # the card, and a TF32 run (which the bar must catch)
        f64 = lama.apply(_tree(lambda t: t.double(), params),
                         img_d.double(), mask_d.double(), cfg).cpu()
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = lama.apply(params, img_d, mask_d, cfg).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = False
        vs64 = [(x.double() - f64).abs().max().item()
                for x in (card, want, tf32)]
        ms256 = _ms(lambda: lama.apply(params, img_d, mask_d, cfg), 5)
        big = torch.rand((1, 800, 800, 3), device=dev)
        big_mask = torch.zeros((1, 800, 800, 1), device=dev)
        big_mask[:, 100:400, 200:500] = 1.0
        ms800 = _ms(lambda: lama.apply(params, big, big_mask, cfg), 5)
    bound800, gflop800 = _lama_bound_ms(cfg, 800, 800, n_params)
    bound256, _ = _lama_bound_ms(cfg, LAMA_SIZE, LAMA_SIZE, n_params)
    print(f"stage 1 model: BIG_LAMA ({cfg.n_blocks} FFC blocks, ngf "
          f"{cfg.ngf}), {n_params / 1e6:.2f} M f32 params; lama.apply "
          f"{LAMA_SIZE}x{LAMA_SIZE} card vs CPU max abs {err:.3e} (bar "
          f"{LAMA_BAR:.0e}; CPU {cpu_s:.2f} s); against f64 on the card: "
          f"card f32 {vs64[0]:.3e}, CPU f32 {vs64[1]:.3e}, card TF32 "
          f"{vs64[2]:.3e}; card {ms256:.3f} ms at {LAMA_SIZE} px (bound "
          f"{bound256:.3f}), {ms800:.3f} ms at 800 px (bound "
          f"{bound800:.3f}: {gflop800:.1f} GFLOP at the f32 FMA peak) "
          f"({CARD})")
    if not (torch.isfinite(card).all() and err <= LAMA_BAR):
        raise AssertionError(f"stage 1: lama.apply card vs CPU {err:.3e}")
    del cpu_params, big, big_mask, img_d, mask_d

    t0 = time.perf_counter()
    datasets = STAGE_ROOT / "datasets"
    mapping = _lama_dataset(rng, datasets / "DIOR")
    print(f"stage 1 data: DIOR {SHOTS}-shot, {len(mapping)} JPEGs 800x800 "
          f"in {time.perf_counter() - t0:.1f} s")
    runner = inpaint.LamaRunner(params, cfg, device=dev)
    timer = StepTimer(sync=torch.cuda.synchronize)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = inpaint.process_dataset("DIOR", SHOTS, runner, str(datasets),
                                  str(STAGE_ROOT), timer=timer)
    stage_s = time.perf_counter() - t0
    n = len(mapping)
    if out != {"processed": n, "skipped": 0, "failed": 0}:
        raise AssertionError(f"stage 1 counters {out}")
    shot_dir = STAGE_ROOT / "lamainpaint" / "DIOR" / f"{SHOTS}_shot"
    names = sorted(p.name for p in shot_dir.iterdir())
    if names != sorted([f"{sid}.jpg" for sid in mapping]
                       + ["category_mapping.json", "manifest.json"]):
        raise AssertionError(f"stage 1 file tree: {names[:5]} ...")
    with open(shot_dir / "category_mapping.json") as f:
        if json.load(f) != mapping:
            raise AssertionError("stage 1 category_mapping.json")
    with open(shot_dir / "manifest.json") as f:
        records = json.load(f)["samples"]
    if sorted(records, key=int) != [str(i + 1) for i in range(n)] or any(
            r["status"] != "done" for r in records.values()):
        raise AssertionError("stage 1 manifest: not all done")
    queries = {sid: str(shot_dir / f"{sid}.jpg") for sid in sorted(mapping)}
    for sid in list(queries)[:3]:
        with Image.open(queries[sid]) as im:
            if im.size != (800, 800) or im.mode != "RGB":
                raise AssertionError(f"stage 1 output {im.size} {im.mode}")
    spans = {k: round(v, 3) for k, v in timer.totals.items()}
    print(f"stage 1 (DIOR {SHOTS}-shot, {n} images 800x800, BIG_LAMA f32 on "
          f"the card): process_dataset {stage_s:.3f} s = "
          f"{stage_s / n:.4f} s per image; spans {spans} s = "
          f"{ {k: round(v / n, 4) for k, v in timer.totals.items()} } s per "
          f"image; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({CARD})")
    shutil.rmtree(datasets)          # stage 2 reads only the output
    del runner, params
    gc.collect()
    torch.cuda.empty_cache()
    return queries, mapping


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


def _native_topk(qfeats, bank, plain):
    """The host top-k (``native.topk_ip_native``, C++ on every core) on
    the stage-2 bank at k TOPK_K against ``topk_ip``'s k + 1 best on the
    card (``plain``), and its host seconds."""
    import torch
    from domainrag_tpu_torch.native import build as native
    host = bank.features.cpu().numpy()
    t0 = time.perf_counter()
    scores, idx = native.topk_ip_native(qfeats, host, TOPK_K)
    host_s = time.perf_counter() - t0
    dev = plain[0].device
    _topk_close("topk_ip_native (host) vs topk_ip", (
        torch.from_numpy(scores).to(dev),
        torch.from_numpy(idx).to(dev, plain[1].dtype)), plain, TOPK_K)
    print(f"host top-k (native, {TOPK_Q} x {TOPK_N} x {TOPK_D}, k {TOPK_K}, "
          f"{len(os.sched_getaffinity(0))} cores): {host_s:.3f} s ({CARD})")


def _topk_jax_name(qt, bank):
    """``topk_ip_pallas``, the JAX package's name for B8, on the stage's
    queries and bank at k TOPK_K: torch.equal to ``topk_ip_fused``, and
    B8's launch counter moves by exactly one for it."""
    import torch
    from domainrag_tpu_torch.ops import topk as tk
    before = tk.topk_ip_fused.launches
    got = tk.topk_ip_pallas(qt, bank, TOPK_K)
    moved = tk.topk_ip_fused.launches - before
    want = tk.topk_ip_fused(qt, bank, TOPK_K)
    if moved != 1:
        raise AssertionError(f"topk_ip_pallas moved B8's counter by {moved}")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("topk_ip_pallas differs from topk_ip_fused")
    print(f"topk_ip_pallas (the JAX name of B8): torch.equal to "
          f"topk_ip_fused at {qt.shape[0]} x {bank.shape[0]} x "
          f"{bank.shape[1]}, k {TOPK_K}; B8's counter moved by {moved}")


def phase_retrieval(dev, rows, stage1):
    """Stage 2 at full width: a random CLIP ViT-B/32 (224 px, patch 32,
    12 x 768, 12 heads, proj 512) and ResNet-50 stem drawn on the card;
    512 corpus JPEGs (640x480) through the feature cache, the bank filled
    to COCO train2017 + miniImageNet size with random unit rows whose
    paths cycle over the JPEGs; ``run_retrieval`` on stage 1's DIOR
    10-shot output (``stage1``: its 200 inpainted 800x800 queries and
    ``category_mapping.json``, 20 classes) with the default
    RetrievalConfig (top-100, re-rank 100, grids on). Then
    ``first_stage_topk(use_pallas=True)`` (B8, one launch) against the
    default route on the same query features. The corpus, the queries
    and ``all_shots_retrieval_results.json`` stay for the stage-3 batch
    phase."""
    import torch
    from domainrag_tpu_torch.core import imaging
    from domainrag_tpu_torch.core.config import RetrievalConfig
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.models import clip, resnet_stem
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.native import build as native
    from domainrag_tpu_torch.ops import topk as tk
    from domainrag_tpu_torch.stages import encoders, retrieve

    root = STAGE_ROOT
    corpus_dir = root / "coco" / "train2017"
    corpus_dir.mkdir(parents=True)
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    corpus = []
    for i in range(CORPUS_IMAGES):
        corpus.append(str(corpus_dir / f"{i:012d}.jpg"))
        _jpeg(rng, corpus[-1], 640, 480)
    queries, mapping = stage1
    with open(Path(next(iter(queries.values()))).parent
              / "category_mapping.json") as f:
        if json.load(f) != mapping:
            raise AssertionError("stage 2: the sidecar is not stage 1's")
    print(f"retrieval data: {CORPUS_IMAGES} corpus JPEGs 640x480 in "
          f"{time.perf_counter() - t0:.1f} s; {len(queries)} DIOR queries "
          f"800x800 from stage 1 ({CARD})")

    k_clip, k_stem = prng.split(prng.PRNGKey(0, device=dev))
    vit_b32 = clip.ClipVisionConfig()      # the defaults are ViT-B/32's
    clip_p = clip.init_vision(k_clip, vit_b32)
    stem_p = resnet_stem.init(k_stem)
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
    served = dict(imaging.resize_counts)
    t0 = time.perf_counter()
    out = retrieve.run_retrieval(["DIOR"], [SHOTS], bank, clip_enc,
                                 style_enc, str(root / "lamainpaint"),
                                 results, RetrievalConfig(), timer=timer)
    stage_s = time.perf_counter() - t0
    served = {k: imaging.resize_counts[k] - v for k, v in served.items()}
    print(f"stage 2 resizes (CLIP and style preprocess): {served} "
          f"(native library {native.library_path().name})")
    if served["pil"] or not served["native"]:
        raise AssertionError("stage 2's resizes were not served by the "
                             "native resampler")
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
    _native_topk(qfeats, bank, plain)
    _topk_jax_name(qt, bank.features)
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
    for pattern in ("*_visual.jpg", f"DIOR_{SHOTS}_shot_*_*_retrieval_"
                                    "results.json"):
        for path in sorted(Path(results).glob(pattern))[2:]:
            path.unlink()        # checked; keeps OUT small
    del bank, clip_p, stem_p, clip_enc, style_enc, qt, plain
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    global PARENT, CARD
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: its B1-B8 "
                         "(B7 aside) are built and timed beside this "
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
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    dev = device_mod.resolve("cuda")
    t0 = time.perf_counter()
    phase_build()
    rows = phase_kernels(dev)
    rows.update(phase_adaln(dev))
    rows.update(phase_mp_kernels(dev))
    rows.update(phase_flash_kernels(dev))
    rows.update(phase_int8_gemm(dev))
    rows.update(phase_int8_attention(dev))
    rows.update(phase_topk_kernel(dev))
    phase_prng(dev)
    phase_init_draws(dev)
    stage1 = phase_inpaint(dev)
    phase_retrieval(dev, rows, stage1)
    phase_small_slice(dev)
    phase_small_fill(dev)
    phase_small_caches(dev)
    phase_small_int8(dev)
    bundle, sample, backgrounds, bf16_step = phase_slice(dev, rows)
    phase_slice_repeat(bundle, sample)
    _init_group()
    phase_generate_batch(bundle, sample)
    phase_scale_out(bundle, dev, rows)
    phase_profile(bundle, SIZE, "profile.txt")
    cached = phase_slice_caches(bundle, sample, backgrounds, bf16_step)
    phase_fid(backgrounds, cached, dev)
    shutil.rmtree(Path(cached[0]).parent)
    phase_slice_int8(bundle, sample, rows, backgrounds, bf16_step)
    phase_profile_int8(bundle, SIZE, "profile_int8.txt", rows, 3)
    del bundle                 # two ~46 GB bundles do not fit 80 GB
    gc.collect()
    torch.cuda.empty_cache()
    bundle, root, hires, fill_step = phase_compose(dev, rows, backgrounds)
    phase_profile(bundle, FILL_SIZE, "profile_fill.txt")
    phase_compose_caches(bundle, root, backgrounds, hires, fill_step)
    phase_compose_int8(bundle, root, backgrounds, rows, hires, fill_step)
    phase_profile_int8(bundle, FILL_SIZE, "profile_fill_int8.txt", rows, 4)
    del bundle                 # the trainer needs the card to itself
    gc.collect()
    torch.cuda.empty_cache()
    phase_long_serving(dev, rows)
    phase_cli(dev)
    phase_small_trainer(dev)
    cfg, params, batches = phase_train(dev, rows)
    phase_profile_train(dev, cfg, params, batches)
    phase_train_f32(dev, cfg, params, batches)
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_mesh(dev, rows)
    import torch.distributed as dist
    dist.destroy_process_group()
    print(f"full_bundle draws through core.prng ({CARD}): "
          + json.dumps(DRAWS, separators=(",", ":")))
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

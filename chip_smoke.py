#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (domainrag_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. build every CUDA kernel of the stage-3 path from ``csrc/`` (one ``nvcc``
   per source, started together) and print the compiler's register report;
3. each kernel at its full-width main-path shape (B = 1, 24 heads x 128,
   1241 text + 4096 image tokens, single-block rows 21504 wide) against
   its plain PyTorch version, with its time, the plain version's, one
   PyTorch library call's (SDPA on pre-normed q/k/v, a yardstick only)
   and the least time the card could take (``bound_ms``);
4. the slice on a small input: a head_dim-128 toy bundle generates on the
   card (kernels) and on the CPU (plain versions) from the same weights
   and noise, and the images must agree;
5. the slice at full width: a random FLUX.1-dev bundle (MMDiT, T5-XXL,
   CLIP-L, SigLIP so400m, Redux, VAE; ~46 GB) drawn on the card, and
   ``GenerateStage.generate_sample`` on a synthetic sample at 1024x1024,
   cut to 4 denoise steps (stage default 50) and 2 ranks (default 5),
   denoised one rank at a time. It checks the written PNGs, that the
   image was finite before quantisation, and that every kernel ran 19 or
   38 times per step per rank chunk;
6. one full-width denoise step (batch 1, 1024 px) under
   ``torch.profiler``, its device time grouped into the attention
   kernels, the GEMMs and the rest (full table in
   ``chiprun_out/chip_smoke/profile.txt``).

Then a ``{"kernels": [...]}`` line and, last, the device line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"
STEPS = 4                 # cut: the stage default is 50
RANKS = 2                 # cut: the stage default is 5 retrieval ranks
MAX_RANK_BATCH = 1        # ranks denoised one at a time
SIZE = 1024               # the stage default resolution
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


def _ms(fn, reps: int) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
    import torch
    for _ in range(2):
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
    from domainrag_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    log = path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")


def _rope_tables(dev):
    import torch
    from domainrag_tpu_torch.models.flux import model as fm
    grid = SIZE // 16
    ids = np.concatenate([fm.make_text_ids(S_TXT),
                          fm.make_image_ids(grid, grid)])
    return fm.rope_cos_sin(torch.as_tensor(ids, device=dev),
                           fm.FLUX_DEV.axes_dim, fm.FLUX_DEV.theta)


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
         lambda: mma.reference_double(
             txt, img, *w(tn), *w(inorm), cos, sin, HEADS, HD),
         lambda: mma.prenormed_double(txt, img, *w(tn), *w(inorm), cos, sin,
                                      HEADS, HD)),
        ("mmdit_seq_attention", "ops/mmdit_attention.py:328",
         lambda: mma.mmdit_single_attention(proj, sn, cos, sin, HEADS, HD),
         lambda: mma.reference_single(proj, *w(sn), cos, sin, HEADS, HD),
         lambda: mma.prenormed_single(proj, *w(sn), cos, sin, HEADS, HD)),
    ]
    # the work: two S x S x 128 products per head; the bytes: q/k/v lanes
    # read once, the output written once, the f32 RoPE tables read once
    flops = 4.0 * HEADS * s_tot * s_tot * HD
    nbytes = 4 * s_tot * hd * 2 + 2 * s_tot * (HD // 2) * 4
    bound_ops, bound_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    rows = {}
    for name, replaces, kernel, plain, prenormed in cases:
        got, want = (torch.cat(x, 1) if isinstance(x, tuple) else x
                     for x in (kernel(), plain()))
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        max_abs = err.max().item()
        rel = max_abs / max(want.float().abs().max().item(), 1e-30)
        rel_norm = (err.norm() / want.float().norm()).item()
        ok = (bool((err <= ATOL + RTOL * want.float().abs()).all())
              and rel_norm < REL_NORM)
        del got, want, err
        q, k, v = prenormed()
        rows[name] = {
            "name": name, "route": "cuda",
            "source": "domainrag_tpu_torch/csrc/mmdit_attention.cu",
            "replaces": f"domainrag_tpu/{replaces}",
            "launches": 0, "max_abs_err": max_abs,
            "ms": _ms(kernel, 20), "plain_ms": _ms(plain, 5),
            "bound_ms": max(bound_ops, bound_bytes),
            "bound_by": "operations" if bound_ops >= bound_bytes else "bytes",
            "library_ms": _ms(
                lambda: F.scaled_dot_product_attention(q, k, v), 20),
        }
        del q, k, v
        print(f"kernel {name}: max_abs_err {max_abs:.3e} rel {rel:.3e} "
              f"rel_norm {rel_norm:.3e} (tol {ATOL} + {RTOL}*|ref|, norm "
              f"{REL_NORM}) ms {rows[name]['ms']:.3f} "
              f"plain_ms {rows[name]['plain_ms']:.3f} library_ms "
              f"{rows[name]['library_ms']:.3f} bound_ms "
              f"{rows[name]['bound_ms']:.3f} ({rows[name]['bound_by']})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
    return rows


def _small_bundle(dev):
    """A toy bundle whose MMDiT has head_dim 128 (the kernels' width)."""
    import torch
    from domainrag_tpu_torch.models.flux import pipeline as fp
    cfgs = fp.tiny_configs()
    cfgs["flux_cfg"] = dataclasses.replace(
        cfgs["flux_cfg"], hidden=256, heads=2, head_dim=128, depth_double=2,
        depth_single=2, axes_dim=(16, 56, 56))
    return fp._random_bundle(cfgs, 7, torch.device("cpu"), torch.bfloat16,
                             torch.bfloat16, **fp.tiny_tokenizers(cfgs))


def phase_small_slice(dev):
    """Small input: the same bundle and noise through the kernels on the
    card and through the plain versions on the CPU."""
    import torch
    from domainrag_tpu_torch.models.flux import pipeline as fp
    cpu = _small_bundle(dev)
    card = dataclasses.replace(
        cpu, device=dev,
        **{f.name: _tree(lambda t: t.to(dev), getattr(cpu, f.name))
           for f in dataclasses.fields(cpu) if f.name.endswith("_params")})
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


def phase_slice(dev, rows):
    import torch
    from PIL import Image
    from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                                 GenerateConfig, ReduxConfig)
    from domainrag_tpu_torch.core.log import StepTimer
    from domainrag_tpu_torch.models.flux import pipeline as fp
    from domainrag_tpu_torch.ops import mmdit_attention as mma
    from domainrag_tpu_torch.stages.generate import GenerateStage

    print(f"slice cuts: {STEPS} denoise steps (stage default 50), {RANKS} "
          f"ranks (stage default 5), max_rank_batch {MAX_RANK_BATCH}, "
          f"{SIZE}x{SIZE}")
    t0 = time.perf_counter()
    bundle = fp.full_bundle(seed=0)
    torch.cuda.synchronize()
    weight_bytes = sum(_bytes(getattr(bundle, f.name))
                       for f in dataclasses.fields(bundle)
                       if f.name.endswith("_params"))
    print(f"full-width bundle: {weight_bytes / 1e9:.2f} GB of weights drawn "
          f"on the card in {time.perf_counter() - t0:.1f} s")

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

    torch.cuda.reset_peak_memory_stats()
    mma.mmdit_double_attention.launches = 0
    mma.mmdit_single_attention.launches = 0
    fp.generate.nonfinite_images = 0
    timer = StepTimer(sync=torch.cuda.synchronize)
    paths = GenerateStage(bundle, cfg).generate_sample(
        "sample0", target, refs, str(OUT / "sample0"), timer=timer)
    torch.cuda.synchronize()
    launches = {"mmdit_joint_attention": mma.mmdit_double_attention.launches,
                "mmdit_seq_attention": mma.mmdit_single_attention.launches}
    chunks = math.ceil(RANKS / MAX_RANK_BATCH)
    depth = bundle.flux_cfg                 # 19 double + 38 single blocks
    expected = {"mmdit_joint_attention": depth.depth_double * STEPS * chunks,
                "mmdit_seq_attention": depth.depth_single * STEPS * chunks}
    print(f"launches on the main path: {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError("kernel launch counts differ from the path")
    for name, n in launches.items():
        rows[name]["launches"] = n

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
    print(f"slice: {len(paths)} PNGs uint8 {SIZE}x{SIZE}x3, finite before "
          f"quantisation; prior {mean['prior']:.3f} s, {mean['step']:.3f} s "
          f"per denoise step (mean of {timer.counts['step']}, batch "
          f"{MAX_RANK_BATCH}), decode {mean['decode']:.3f} s per image, "
          f"stage spans { {k: round(v, 3) for k, v in timer.totals.items()} }"
          f", max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return bundle


def phase_profile(bundle):
    """One full-width denoise step (batch 1, 1024 px, random latents and
    conditioning) under torch.profiler: device time per kernel, grouped,
    beside the wall time of the same step untraced."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from domainrag_tpu_torch.models.flux import model as fm

    dev, cfg, dt = bundle.device, bundle.flux_cfg, bundle.compute_dtype
    grid = SIZE // 16
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
    groups = {"attention (csrc)": 0.0, "GEMM (cuBLAS)": 0.0, "other": 0.0}
    for ms, _, name in kernels:
        if "flash_kernel" in name or "norm_rope_kernel" in name:
            groups["attention (csrc)"] += ms
        elif re.search(r"gemm|nvjet|cutlass|xmma|cublas", name, re.I):
            groups["GEMM (cuBLAS)"] += ms
        else:
            groups["other"] += ms
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "profile.txt").write_text("".join(
        f"{ms:10.3f} ms {n:6d}x  {name}\n" for ms, n, name in kernels))
    print(f"profile: one denoise step, device time {total:.3f} ms "
          f"(untraced wall {wall_ms:.3f} ms), {sum(n for _, n, _ in kernels)}"
          f" device events; "
          + ", ".join(f"{k} {v:.3f} ms ({100 * v / total:.1f}%)"
                      for k, v in groups.items()))
    for ms, n, name in kernels[:8]:
        print(f"  {ms:9.3f} ms {n:5d}x  {name[:100]}")


def main() -> int:
    import torch
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
    phase_build()
    rows = phase_kernels(dev)
    phase_small_slice(dev)
    phase_profile(phase_slice(dev, rows))
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

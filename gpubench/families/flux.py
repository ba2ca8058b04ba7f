"""The FLUX family: FLUX.1-dev and FLUX.1-Fill-dev through the port's
stage 3 (``GenerateStage.generate_sample``) and stage 4
(``ComposeStage.process_sample``). The adapter's functions are those
``gpubench.families`` names.

The weights are made from the seed in the published checkpoints' layout
(``gpubench.weights``) and handed to the program's own loader,
``models.convert.load_flux_bundle``, in place of the files it would map.
While the window's first sample runs, thin wrappers around eight of the
program's functions copy what they are given and what they return at the
steps the check samples; the program's arithmetic is untouched, and the
copies' seconds are counted.

The comparison that decides ``correct`` (each number a relative L2 gap,
the worst over what was compared):

- ``prior_gap``: the Redux prior's embeddings and pooled vector, from the
  sample's image files and prompt;
- ``encode_gap`` (Fill): the conditioning tokens (masked-image latents
  and the packed mask, tiled encode) and the noised initial latents,
  from the sample's original image and boxes, with the program's own
  noise draw;
- ``gemm_gap``: at the sampled step, for one sampled row drawn from the
  seed, the two linears of a single block drawn from the seed and the
  output projection, each from the program's own input to it at a
  sample of token rows drawn from the seed, and the forward's output
  held to the projection's exactly at those rows;
- ``attn_gap``: that block's attention, in that row, from the program's
  own q, k, v;
- ``velocity_gap``: the MMDiT's velocity at the sampled step in every
  sampled row, from the program's latents and conditioning at that step
  (the reference follows the program step by step; the prior and the
  conditioning that this skips are compared above);
- ``euler_gap``: the Euler update at the sampled steps, from the
  program's latents and velocity: float32 arithmetic, rounded to the
  stream's dtype, is exact, so its limit is 0.

The serving modes a traffic file may name are the CLI's: ``w8a8``
(``--w8a8``: the MMDiT quantized by ``_quantize_in_place``, int8
activations at every quantized linear), ``int8_qk`` (``--int8_qk``) and
``int8_pv`` (int8 P.V as well). Under ``w8a8`` the MMDiT's control is the
reference with int4 operands; else with float8 operands.

The counts are frozen copies, so that a later change to the program
cannot move the yardstick: ``forward_flops`` of the port's
``eval/flops.py`` (one multiply-add is 2 FLOPs; attention is
4 * S^2 * hidden per block; norms, nonlinearities and RoPE left out),
``forward_gemms`` every linear of a forward at its own shape.

The layout derivation (``config_file``) reads the port's inits and export
layouts; its output is frozen as data in ``gpubench/configs/<name>.json``
(``python -m gpubench.tools.derive_layout <name>``). Every random draw
of the inits is replaced by a constant tensor expanded to its shape,
carrying minus its standard deviation, so a full-width derivation
allocates next to nothing; constant leaves (norm scales, biases) keep
their values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import re
from typing import Dict, List, Tuple

import numpy as np
import torch
from PIL import Image

from .. import harness
from .. import weights as wmod
from ..check import rel_gap, row_gaps
from ..counts import flops
from ..harness import Cell
from ..reference import flux as rflux
from ..reference import prior as rprior
from ..reference import vae as rvae
from ..reference.ops import precision

MODES = ("w8a8", "int8_qk", "int8_pv")


def _fill(cell: Cell) -> bool:
    """Stage 4 (FLUX.1-Fill-dev), else stage 3."""
    return cell.traffic["stage"] == "compose"


# ---------------------------------------------------------------------------
# inputs made from the seed
# ---------------------------------------------------------------------------

def _image(rng: np.random.Generator, w: int, h: int):
    """A smooth random colour field (an 8 x 8 field resized bicubically)
    with fine noise, as a PIL image."""
    coarse = Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8))
    img = np.asarray(coarse.resize((w, h), Image.BICUBIC), np.int16)
    img = img + rng.integers(-12, 13, img.shape, dtype=np.int16)
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def _save(img, path: str) -> str:
    img.save(path, compress_level=1)
    return path


def make_samples(cell: Cell, seed: int, root: str, n: int) -> List[dict]:
    """``n`` samples of the cell's traffic, as PNG files the stage reads
    (written on a few threads: PNG filtering dominates)."""
    from concurrent.futures import ThreadPoolExecutor
    t = cell.traffic
    rng = np.random.default_rng(seed)
    jobs, out = [], []
    for i in range(n):
        d = os.path.join(root, f"sample{i}")
        os.makedirs(d, exist_ok=True)
        px = t["image_px"]

        def image(name, size):
            path = os.path.join(d, name)
            jobs.append((_image(rng, size, size), path))
            return path
        if not _fill(cell):
            out.append({"id": f"s{i}", "dir": d,
                        "target": image("target.png", px),
                        "refs": [{"rank": r + 1, "similarity": 1.0 - 0.1 * r,
                                  "image_path": image(f"ref{r + 1}.png", px)}
                                 for r in range(t["batch"])]})
        else:
            out.append({"id": f"s{i}", "dir": d, "bboxes": t["bboxes"],
                        "original": image("original.png", px),
                        "backgrounds": [
                            image(f"generated_image_rank{r + 1}.png",
                                  t["background_px"])
                            for r in range(t["batch"])]})
    with ThreadPoolExecutor(max_workers=6) as pool:
        list(pool.map(lambda job: _save(*job), jobs))
    return out


# ---------------------------------------------------------------------------
# the program under test
# ---------------------------------------------------------------------------

_SUBDIR = {"transformer": None, "vae": "vae", "t5": "t5",
           "clip_text": "clip-text", "siglip": "siglip", "redux": "redux"}


def port_configs(config: dict) -> dict:
    """The program's model configs of the sizes the file states."""
    from domainrag_tpu_torch.models import clip, redux, siglip, t5
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import vae

    def kw(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}
    s = config["sizes"]
    return {"flux": fm.FluxConfig(**kw(s["transformer"])),
            "vae": vae.VaeConfig(**kw(s["vae"])),
            "t5": t5.T5Config(**kw(s["t5"])),
            "clip_text": clip.ClipTextConfig(**kw(s["clip_text"])),
            "siglip": siglip.SiglipVisionConfig(**kw(s["siglip"])),
            "redux": redux.ReduxEncoderConfig(**kw(s["redux"])),
            "t5_max_len": config["t5_max_len"]}


def build_bundle(cell: Cell, seed: int, device: str = "cuda"):
    """The bundle as ``--checkpoints`` builds it, from published-layout
    tensors made on the device; under the mode ``w8a8`` its MMDiT
    quantized as ``--w8a8`` quantizes it."""
    from domainrag_tpu_torch.core import text as text_util
    from domainrag_tpu_torch.models import convert
    comps = wmod.components(cell.config, seed, device)
    mmdit = "flux-fill" if _fill(cell) else "flux-dev"
    by_dir = {(_SUBDIR[k] or mmdit): c for k, c in comps.items()}

    def no_tokenizer_files(path):
        raise FileNotFoundError(f"no tokenizer files under {path}")

    saved = convert.load_safetensors_dir, text_util.load_hf_tokenizers
    convert.load_safetensors_dir = lambda path, lazy=True: by_dir[
        os.path.basename(path)]
    text_util.load_hf_tokenizers = no_tokenizer_files
    try:
        bundle = convert.load_flux_bundle(
            "checkpoints", fill=_fill(cell),
            compute_dtype=wmod.DTYPES[cell.config["served_dtype"]
                                      ["transformer"]],
            configs=port_configs(cell.config), device=device)
    finally:
        convert.load_safetensors_dir, text_util.load_hf_tokenizers = saved
        for c in comps.values():
            c.release()
    if "w8a8" in cell.modes:
        from domainrag_tpu_torch.cli.main import _quantize_in_place
        _quantize_in_place(bundle.flux_params)
    return bundle


@contextlib.contextmanager
def serving_modes(cell: Cell):
    """The cell's serving switches for the block, set as the CLI sets
    ``--w8a8`` (int8 activations) and ``--int8_qk`` before it builds the
    bundle, with ``int8_pv`` beside them; all three off after it."""
    from domainrag_tpu_torch.models import common
    from domainrag_tpu_torch.ops import mmdit_attention
    unknown = set(cell.modes) - set(MODES)
    if unknown:
        raise ValueError(f"{cell.name}: unknown serving modes "
                         f"{sorted(unknown)}; the FLUX family's are {MODES}")
    common.set_int8_activations("w8a8" in cell.modes)
    mmdit_attention.set_int8_qk("int8_qk" in cell.modes)
    mmdit_attention.set_int8_pv("int8_pv" in cell.modes)
    try:
        yield
    finally:
        common.set_int8_activations(False)
        mmdit_attention.set_int8_qk(False)
        mmdit_attention.set_int8_pv(False)


def make_stage(cell: Cell, bundle):
    t = cell.traffic
    if not _fill(cell):
        from domainrag_tpu_torch.core.config import (FluxSamplingConfig,
                                                     GenerateConfig,
                                                     ReduxConfig)
        from domainrag_tpu_torch.stages.generate import GenerateStage
        r = t["redux"]
        cfg = GenerateConfig(
            sampling=FluxSamplingConfig(
                num_steps=t["steps"], guidance_scale=t["guidance"],
                height=t["size"], width=t["size"], seed=t["noise_seed"]),
            redux=ReduxConfig(ref_image_scale=r["image_scales"][0],
                              target_image_scale=r["image_scales"][1],
                              ref_text_scale=r["text_scales"][0],
                              target_text_scale=r["text_scales"][1],
                              prompt=r["prompt"]),
            top_ranks=t["batch"], max_rank_batch=None)
        return GenerateStage(bundle, cfg)
    from domainrag_tpu_torch.core.config import (ComposeConfig,
                                                 DatasetParams,
                                                 ResolutionPolicy)
    from domainrag_tpu_torch.stages.compose import ComposeStage
    params = DatasetParams(strength=t["strength"], guidance_scale=t["guidance"],
                           image_prompt_scale=t["image_prompt_scale"],
                           upscale_dimension=t["upscale_dimension"],
                           redux_prompt=t["prompt"])
    cfg = ComposeConfig(
        resolution=ResolutionPolicy(max_dimension=t["max_dimension"]),
        num_steps=t["steps"], max_rank_batch=None,
        dataset_params={t["dataset"]: params},
        hires_threshold_px=t["hires_threshold_px"])
    return ComposeStage(bundle, cfg)


def run_sample(cell: Cell, stage, sample: dict, out_dir: str, timer):
    """One sample through the stage's entry point."""
    if not _fill(cell):
        return stage.generate_sample(sample["id"], sample["target"],
                                     sample["refs"],
                                     os.path.join(out_dir, sample["id"]),
                                     timer=timer)
    t = cell.traffic
    original = Image.open(sample["original"]).convert("RGB")
    return stage.process_sample(
        t["dataset"], t["shot"], sample["id"], original,
        [tuple(b) for b in sample["bboxes"]],
        ["object"] * len(sample["bboxes"]), sample["backgrounds"],
        os.path.join(out_dir, sample["id"]), timer=timer)


# ---------------------------------------------------------------------------
# what the check reads: copies taken at the sampled steps
# ---------------------------------------------------------------------------

class Recorder(harness.Recorder):
    """Wraps the prior, the Fill conditioning, the MMDiT forward and the
    Euler update of the program while the window's first sample runs,
    keeping host copies of their inputs and outputs at ``steps``. Inside
    those steps' forwards it also keeps, for the row ``op_row`` (one of
    ``rows``; the first by default), what the single block ``block``'s
    two linears and the output layer's projection were given and gave,
    at ``tokens`` token rows of each call drawn from ``token_seed`` (all
    where None), and the block's attention's q, k, v and output."""

    def __init__(self, steps, rows=(), block=0, op_row=None, tokens=None,
                 token_seed=0):
        super().__init__()
        self.steps = set(steps)
        self.rows = torch.tensor(sorted(rows), dtype=torch.long)
        self.block = block
        self.op_row = int(self.rows[0]) if op_row is None else op_row
        self.tokens = tokens
        self._rng = random.Random(token_seed)
        self.prior = None
        self.fill_cond = None
        self.model: Dict[int, dict] = {}
        self.euler: Dict[int, dict] = {}
        self.layers: Dict[int, dict] = {}
        self._n_model = self._n_euler = self._n_single = 0
        self._active = None              # the step whose forward runs
        self._probe = None               # the sampled block's params
        self._final = None               # the model's, in its output layer

    def _token_rows(self, n: int) -> torch.Tensor:
        if self.tokens is None or self.tokens >= n:
            return torch.arange(n)
        return torch.tensor(sorted(self._rng.sample(range(n), self.tokens)))

    def _keep(self, name, idx=None, cols=None, **tensors):
        """Host copies of row ``op_row`` of each (B, S, C) tensor, as (1,
        S', C'): at the token rows ``idx`` alone where given, its first
        ``cols`` columns where given. The device holds no copy larger
        than ``idx``'s rows or a chunk of 1024 tokens: the window
        measures its peak."""
        rec = self.layers.setdefault(self._active, {}).setdefault(name, {})
        for k, v in tensors.items():
            row = v[self.op_row]
            if idx is not None:
                row = row.index_select(0, idx.to(row.device))
            if cols is None:
                rec[k] = self._host(row)[None]
            else:
                rec[k] = torch.cat([
                    self._host(row[i:i + 1024, :cols])
                    for i in range(0, row.shape[0], 1024)])[None]
        if idx is not None:
            rec["idx"] = idx

    def patches(self) -> list:
        from domainrag_tpu_torch.models.flux import model as fm
        from domainrag_tpu_torch.models.flux import pipeline as fp
        from domainrag_tpu_torch.models.flux import scheduler

        def prior(real):
            def wrapped(*a, **k):
                out = real(*a, **k)
                if self.prior is None:
                    self.prior = tuple(self._host(t) for t in out)
                return out
            return wrapped

        def cond(real):
            def wrapped(vae_params, image, mask, noise, sigma0, *a, **k):
                out = real(vae_params, image, mask, noise, sigma0, *a, **k)
                if self.fill_cond is None:
                    self.fill_cond = dict(
                        noise=self._host(noise), sigma0=float(sigma0),
                        latents=self._host(out[0]), cond=self._host(out[1]))
                return out
            return wrapped

        def model(real):
            def wrapped(params, inp, embeds, pooled, timestep, img_ids,
                        txt_ids, cfg, guidance=None, **k):
                i = self._n_model
                self._n_model += 1
                self._active = i if i in self.steps else None
                self._n_single = 0
                try:
                    out = real(params, inp, embeds, pooled, timestep,
                               img_ids, txt_ids, cfg, guidance=guidance, **k)
                finally:
                    self._active = None
                if i in self.steps:
                    h = self._host
                    self.model[i] = dict(
                        inp=h(inp), embeds=h(embeds), pooled=h(pooled),
                        timestep=h(timestep), guidance=h(guidance),
                        out=h(out))
                return out
            return wrapped

        def euler(real):
            def wrapped(x, v, sigma, sigma_next):
                out = real(x, v, sigma, sigma_next)
                i = self._n_euler
                self._n_euler += 1
                if i in self.steps:
                    h = self._host
                    self.euler[i] = dict(x=h(x), v=h(v), sigma=h(sigma),
                                         sigma_next=h(sigma_next),
                                         out=h(out))
                return out
            return wrapped

        def single(real):
            def wrapped(p, x, vec, cos, sin, cfg):
                if self._active is not None \
                        and self._n_single == self.block:
                    self._probe = p
                try:
                    return real(p, x, vec, cos, sin, cfg)
                finally:
                    self._probe = None
                    self._n_single += self._active is not None
            return wrapped

        def linear(real):
            def wrapped(p, x):
                y = real(p, x)
                for name, probe in (("linear1", self._probe),
                                    ("linear2", self._probe),
                                    ("final_proj", self._final)):
                    if probe is not None and p is probe[name]:
                        self._keep(name, self._token_rows(x.shape[1]),
                                   x=x, y=y)
                return y
            return wrapped

        def attention(real):
            def wrapped(proj, qknorm, cos, sin, heads, head_dim):
                out = real(proj, qknorm, cos, sin, heads, head_dim)
                if self._probe is not None:
                    self._keep("attention", out=out)
                    self._keep("attention", cols=3 * heads * head_dim,
                               qkv=proj)
                return out
            return wrapped

        def final(real):
            def wrapped(params, img, vec):
                if self._active is not None:
                    self._final = params
                try:
                    return real(params, img, vec)
                finally:
                    self._final = None
            return wrapped

        return [(fp, "redux_prior_pairs_indexed", prior),
                (fp, "_fill_conditioning", cond),
                (fm, "apply", model),
                (fm, "_single_block", single),
                (fm, "linear", linear),
                (fm, "mmdit_single_attention", attention),
                (fm, "_final", final),
                (scheduler, "euler_step", euler)]


def check_steps(cell: Cell, seed: int) -> List[int]:
    """The denoise steps the check compares: drawn from the seed among
    those every window completes."""
    t = cell.traffic
    rng = random.Random(seed ^ 0x5EED)
    return sorted(rng.sample(range(t["check_steps_below"]),
                             t["check_steps"]))


def check_rows(cell: Cell, seed: int) -> List[int]:
    """The batch rows (images) the check compares, drawn from the seed."""
    rng = random.Random(seed ^ 0xC0FFEE)
    return sorted(rng.sample(range(cell.batch), cell.traffic["check_rows"]))


def check_block(cell: Cell, seed: int) -> int:
    """The single block whose linears and attention the check compares,
    drawn from the seed."""
    tc = cell.config["sizes"]["transformer"]
    return random.Random(seed ^ 0xB10C).randrange(tc["depth_single"])


def recorder(cell: Cell, seed: int) -> Recorder:
    rows = check_rows(cell, seed)
    return Recorder(check_steps(cell, seed), rows, check_block(cell, seed),
                    op_row=random.Random(seed ^ 0x0B5).choice(rows),
                    tokens=cell.traffic["check_tokens"],
                    token_seed=seed ^ 0x70C)


def failed(rec: Recorder) -> int:
    """The sampled forwards whose velocity holds a value not finite."""
    return sum(int(not torch.isfinite(m["out"].float()).all().item())
               for m in rec.model.values())


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def prior_reference(cell, comps, sample):
    """The sample's Redux prior worked out from its files."""
    t, sizes = cell.traffic, cell.config["sizes"]
    if not _fill(cell):
        paths = [r["image_path"] for r in sample["refs"]] + [sample["target"]]
        k = len(sample["refs"])
        pair_idx = np.stack([np.arange(k), np.full(k, k)], axis=1)
        r = t["redux"]
        return rprior.prior(comps, sizes, paths, pair_idx, r["prompt"],
                            r["image_scales"], r["text_scales"],
                            cell.config["t5_max_len"])
    paths = sample["backgrounds"]
    return rprior.prior(comps, sizes, paths,
                        np.arange(len(paths))[:, None], t["prompt"],
                        [t["image_prompt_scale"]], [1.0],
                        cell.config["t5_max_len"])


def fill_inputs(cell, sample):
    """The stage's 2048 px image and repaint mask, worked out again from
    the original file and boxes: the resolution policy's bicubic upscale
    to the dataset's minimum side, boxes scaled by int truncation, the
    keep mask 0 inside each box (inclusive of its far edge, clamped)."""
    t = cell.traffic
    orig = Image.open(sample["original"]).convert("RGB")
    w, h = orig.size
    up = t["upscale_dimension"] / min(w, h)
    nw, nh = (max(int(w * up) // 16 * 16, 64), max(int(h * up) // 16 * 16, 64))
    img = orig.resize((int(w * up), int(h * up)), Image.BICUBIC)
    if img.size != (nw, nh):
        img = img.resize((nw, nh), Image.BICUBIC)
    sx, sy = nw / w, nh / h
    keep = np.full((nh, nw), 255, np.uint8)
    for (x, y, bw, bh) in sample["bboxes"]:
        x, y, bw, bh = int(x * sx), int(y * sy), int(bw * sx), int(bh * sy)
        x0, y0 = max(0, min(x, nw - 1)), max(0, min(y, nh - 1))
        x1 = min(int(max(0, min(x + bw, nw))), nw - 1)
        y1 = min(int(max(0, min(y + bh, nh))), nh - 1)
        if x1 >= x0 and y1 >= y0:
            keep[y0:y1 + 1, x0:x1 + 1] = 0
    pixels = np.asarray(img, np.float32) / 127.5 - 1.0
    return pixels, (keep.astype(np.float32) / 255.0 > 0.5)


def encode_reference(cell, comps, sample, rec, dev):
    """(conditioning tokens (1, S, 4C + f^2 4), noised initial latents
    (B, S, 4C)) worked out from the original file and boxes, with the
    program's noise draw and first sigma."""
    sizes = cell.config["sizes"]["vae"]
    pixels, repaint = fill_inputs(cell, sample)
    image = torch.as_tensor(pixels, device=dev)[None]
    mask = torch.as_tensor(repaint, device=dev, dtype=torch.float32)[None]
    vae = comps["vae"]
    masked = rvae.pack(rvae.encode_tiled(vae, sizes,
                                         image * (1.0 - mask[..., None])))
    latents = rvae.pack(rvae.encode_tiled(vae, sizes, image))
    vae.release()
    f = 2 ** (len(sizes["block_out"]) - 1)
    cond = torch.cat([masked, rvae.pack_mask(mask, f)], dim=-1)
    s0 = rec.fill_cond["sigma0"]
    noise = rec.fill_cond["noise"].to(dev).float()
    return cond, s0 * noise + (1.0 - s0) * latents


def _encode_gap(rec, cond, x0, dev) -> float:
    fc = rec.fill_cond
    gaps = []
    for r in range(fc["cond"].shape[0]):
        gaps.append(rel_gap(fc["cond"][r:r + 1].to(dev), cond))
        gaps.append(rel_gap(fc["latents"][r:r + 1].to(dev), x0[r:r + 1]))
    return max(gaps)


def _velocity(cell, comps, rec, rows, dev) -> float:
    t = cell.traffic
    grid = t["latent_grid"]
    tcfg = cell.config["sizes"]["transformer"]
    gaps = []
    for i, m in sorted(rec.model.items()):
        sel = torch.tensor(rows)
        v = rflux.forward(comps["transformer"], tcfg, m["inp"][sel].to(dev),
                          m["embeds"][sel].to(dev), m["pooled"][sel].to(dev),
                          m["timestep"][sel].to(dev),
                          m["guidance"][sel].to(dev), grid, grid)
        for j, r in enumerate(rows):
            gaps.append(rel_gap(m["out"][r:r + 1].to(dev), v[j:j + 1]))
    comps["transformer"].release()
    return max(gaps)


def _op_inputs(cell, rec, i, dev):
    """The sampled single block's recorded linears and attention at step
    ``i``, and the RoPE tables of its sequence."""
    tcfg = cell.config["sizes"]["transformer"]
    grid = cell.traffic["latent_grid"]
    lay = {name: {k: v.to(dev) for k, v in d.items()}
           for name, d in rec.layers[i].items()}
    qkv = lay["attention"]["qkv"]
    cos, sin = rflux.rope(tcfg, qkv.shape[1] - grid * grid, grid, grid, dev)
    return lay, qkv, cos, sin


def _ops(cell, comps, rec, dev) -> Dict[str, float]:
    """From the program's own inputs to them: the sampled single block's
    two linears and the output projection, and the forward's output held
    to that projection's exactly (``gemm_gap``); the block's attention
    (``attn_gap``)."""
    tcfg = cell.config["sizes"]["transformer"]
    w = comps["transformer"]
    gemm, attn, output = [], [], []
    for i, m in rec.model.items():
        lay, qkv, cos, sin = _op_inputs(cell, rec, i, dev)
        l1, l2 = lay["linear1"], lay["linear2"]
        gemm += row_gaps(l1["y"], rflux.single_linear1(w, rec.block,
                                                       l1["x"]))
        gemm += row_gaps(l2["y"], rflux.single_linear2(w, rec.block,
                                                       l2["x"]))
        attn += row_gaps(lay["attention"]["out"], rflux.single_attention(
            w, tcfg, rec.block, qkv, cos, sin))
        fp = lay["final_proj"]
        gemm += row_gaps(fp["y"], rflux.final_proj(w, fp["x"]))
        output += row_gaps(
            m["out"][rec.op_row:rec.op_row + 1, fp["idx"].cpu()].to(dev),
            fp["y"])
    w.release()
    return {"gemm_gap": max(gemm + output), "attn_gap": max(attn)}


def _mmdit_control(cell, comps, rec, dev) -> Dict[str, float]:
    """The MMDiT's control: the reference with every product's operands
    one precision below the program's in its place (float8 for the
    bfloat16 MMDiT; int4 per token and per channel for the int8 one,
    ``w8a8``), against the reference in float32: the velocity of the
    sampled rows, the sampled block's two linears and attention, from
    the program's inputs."""
    low = "int4" if "w8a8" in cell.modes else "fp8"
    grid = cell.traffic["latent_grid"]
    tcfg = cell.config["sizes"]["transformer"]
    w = comps["transformer"]
    out = {"velocity_gap": [], "gemm_gap": [], "attn_gap": []}
    for i, m in rec.model.items():
        m = {k: v.index_select(0, rec.rows).to(dev) if torch.is_tensor(v)
             and v.dim() else v for k, v in m.items()}
        lay, qkv, cos, sin = _op_inputs(cell, rec, i, dev)
        got = {}
        for mode in ("f32", low):
            with precision(mode):
                got[mode] = (
                    rflux.forward(w, tcfg, m["inp"], m["embeds"], m["pooled"],
                                  m["timestep"], m["guidance"], grid, grid),
                    rflux.single_linear1(w, rec.block, lay["linear1"]["x"]),
                    rflux.single_linear2(w, rec.block, lay["linear2"]["x"]),
                    rflux.single_attention(w, tcfg, rec.block, qkv, cos,
                                           sin))
        (v32, a32, b32, t32), (v8, a8, b8, t8) = got["f32"], got[low]
        out["velocity_gap"] += row_gaps(v8, v32)
        out["gemm_gap"] += row_gaps(a8, a32) + row_gaps(b8, b32)
        out["attn_gap"] += row_gaps(t8, t32)
    w.release()
    return {k: max(v) for k, v in out.items()}


def euler_reference(x, v, sigma, sigma_next, dtype):
    """The flow-matching Euler update in float32, rounded to ``dtype``."""
    return (x.float() + (sigma_next - sigma) * v.float()).to(dtype)


def _euler(rec, dev) -> float:
    gaps = []
    for e in rec.euler.values():
        want = euler_reference(e["x"].to(dev), e["v"].to(dev),
                               e["sigma"].to(dev), e["sigma_next"].to(dev),
                               e["out"].dtype)
        gaps.append(rel_gap(e["out"].to(dev), want))
    return max(gaps)


def _euler_bf16(e, dev):
    """The same update computed in bfloat16 throughout."""
    dt = (e["sigma_next"] - e["sigma"]).to(dev).to(torch.bfloat16)
    return (e["x"].to(dev).to(torch.bfloat16)
            + dt * e["v"].to(dev).to(torch.bfloat16))


def compare(cell, seed: int, sample: dict, rec, dev="cuda"
            ) -> Dict[str, float]:
    """The cell's numbers: the program against the float32 reference
    (every number is computed and logged; the cell's limits say which
    decide ``correct``)."""
    if set(rec.model) != set(rec.euler) or not rec.model:
        raise RuntimeError("the window did not reach the sampled steps")
    comps = wmod.components(cell.config, seed, dev)
    out = {}
    with torch.inference_mode(), precision("f32"):
        embeds, pooled = prior_reference(cell, comps, sample)
        got_e, got_p = rec.prior
        out["prior_gap"] = max(rel_gap(got_e.to(dev), embeds),
                               rel_gap(got_p.to(dev), pooled))
        del embeds, pooled
        if _fill(cell):
            cond, x0 = encode_reference(cell, comps, sample, rec, dev)
            out["encode_gap"] = _encode_gap(rec, cond, x0, dev)
            del cond, x0
        out.update(_ops(cell, comps, rec, dev))
        out["velocity_gap"] = _velocity(cell, comps, rec, rec.rows.tolist(),
                                        dev)
        out["euler_gap"] = _euler(rec, dev)
    return out


def control(cell, seed: int, sample: dict, rec, dev="cuda"
            ) -> Dict[str, float]:
    """The controls' readings: the reference put in the program's place
    one precision below the configuration's (the float32 prior in TF32,
    the bfloat16 encode with float8 operands, the MMDiT as
    ``_mmdit_control`` says, the float32 Euler update in bfloat16),
    against the float32 reference. The program's own int8 path is a
    second control of the bfloat16 MMDiT (``control.py --int8``)."""
    comps = wmod.components(cell.config, seed, dev)
    out = {}
    with torch.inference_mode():
        with precision("f32"):
            e32, p32 = prior_reference(cell, comps, sample)
        with precision("tf32"):
            e, p = prior_reference(cell, comps, sample)
        out["prior_gap"] = max(rel_gap(e, e32), rel_gap(p, p32))
        del e32, p32, e, p
        if _fill(cell):
            with precision("f32"):
                c32, x32 = encode_reference(cell, comps, sample, rec, dev)
            with precision("fp8"):
                c8, x8 = encode_reference(cell, comps, sample, rec, dev)
            out["encode_gap"] = max(rel_gap(c8, c32), rel_gap(x8, x32))
        out.update(_mmdit_control(cell, comps, rec, dev))
        out["euler_gap"] = max(
            rel_gap(_euler_bf16(e, dev), euler_reference(
                e["x"].to(dev), e["v"].to(dev), e["sigma"].to(dev),
                e["sigma_next"].to(dev), e["out"].dtype))
            for e in rec.euler.values())
    return out


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

def forward_flops(cfg: Dict, s_img: int, s_txt: int,
                  batch: int = 1) -> Dict[str, float]:
    """FLOPs of one MMDiT forward by part, and their ``total``."""
    h = cfg["hidden"]
    m = h * cfg["mlp_ratio"]
    s = s_img + s_txt
    stream_params = h * 3 * h + h * h + 2 * h * m
    d_stream = 2 * stream_params * (s_img + s_txt)
    d_attn = 4 * s * s * h
    d_mod = 2 * (2 * h * 6 * h)
    sgl_params = h * (3 * h + m) + (h + m) * h
    s_stream = 2 * sgl_params * s
    s_attn = 4 * s * s * h
    s_mod = 2 * (h * 3 * h)
    emb = 2 * (cfg["in_channels"] * h * s_img
               + cfg["text_dim"] * h * s_txt
               + h * cfg["out_channels"] * s_img
               + (cfg["time_embed_dim"] * h + h * h) * 2
               + cfg["pooled_dim"] * h + h * h
               + h * 2 * h)
    parts = {
        "double_stream": batch * d_stream * cfg["depth_double"],
        "double_attn": batch * d_attn * cfg["depth_double"],
        "double_mod": batch * d_mod * cfg["depth_double"],
        "single_stream": batch * s_stream * cfg["depth_single"],
        "single_attn": batch * s_attn * cfg["depth_single"],
        "single_mod": batch * s_mod * cfg["depth_single"],
        "embedders": batch * emb,
    }
    parts["total"] = sum(parts.values())
    return parts


def forward_gemms(cfg: Dict, s_img: int, s_txt: int,
                  batch: int) -> List[Tuple[int, int, int, int]]:
    """Every linear of one forward as (M, K, N, calls). The conditioning
    vector's linears run one sample at a time (M = 1, ``batch`` calls)."""
    h = cfg["hidden"]
    m = h * cfg["mlp_ratio"]
    s = s_img + s_txt
    td = cfg["time_embed_dim"]
    vec = [(td, h), (h, h), (cfg["pooled_dim"], h), (h, h)]
    if cfg["guidance_embed"]:
        vec += [(td, h), (h, h)]
    g = [(batch * s_img, cfg["in_channels"], h, 1),
         (batch * s_txt, cfg["text_dim"], h, 1),
         (batch * s_img, h, cfg["out_channels"], 1)]
    g += [(1, k, n, batch) for k, n in vec + [(h, 2 * h)]]
    for _ in range(cfg["depth_double"]):
        g += [(1, h, 6 * h, 2 * batch)]
        for rows in (batch * s_img, batch * s_txt):
            g += [(rows, h, 3 * h, 1), (rows, h, h, 1), (rows, h, m, 1),
                  (rows, m, h, 1)]
    for _ in range(cfg["depth_single"]):
        g += [(1, h, 3 * h, batch), (batch * s, h, 3 * h + m, 1),
              (batch * s, h + m, h, 1)]
    return g


def attention_calls(cfg: Dict) -> int:
    """Fused attention calls of one forward: one per block."""
    return cfg["depth_double"] + cfg["depth_single"]


def counts(cell: Cell) -> dict:
    """One forward's counts at the cell's batch and token counts."""
    tc = cell.config["sizes"]["transformer"]
    t = cell.traffic
    b, s_img, s_txt = cell.batch, t["s_img"], t["s_txt"]
    f = forward_flops(tc, s_img, s_txt, b)
    pv = "int8_pv" in cell.modes
    half_attn = (f["double_attn"] + f["single_attn"]) // 2
    return {
        "forward_flops": f["total"],
        "gemms": forward_gemms(tc, s_img, s_txt, b),
        "attention_s": flops.attention_bound_s(b, s_img + s_txt, tc["heads"],
                                               tc["head_dim"]),
        "attention_calls": attention_calls(tc),
        "i8_attention_s": flops.i8_attention_bound_s(
            b, s_img + s_txt, pv, tc["heads"], tc["head_dim"]),
        "i8_forward_s": (f["total"] - half_attn) / flops.PEAK_INT8
        + half_attn / (flops.PEAK_INT8 if pv else flops.PEAK_BF16),
    }


# ---------------------------------------------------------------------------
# the layout derivation
# ---------------------------------------------------------------------------

# the first dotted part that carries a layer index closes a group
_GROUP = re.compile(r"^(.*?\.\d+)\.")
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


@contextlib.contextmanager
def _marked_draws():
    """Every ``models.common._draw`` returns a zero-stride tensor holding
    -std, in the dtype the init stores."""
    from domainrag_tpu_torch.models import common

    def draw(key, shape, std, dtype, draw_dtype=torch.float32, oihw=False):
        x = torch.full((1,) * len(shape), -float(std), dtype=dtype)
        x = x.expand(shape)
        return x.permute(3, 2, 0, 1) if oihw else x

    real = common._draw
    common._draw = draw
    try:
        yield
    finally:
        common._draw = real


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["w"].t()
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["scale"]
    sd[f"{prefix}.bias"] = p["bias"]


def _layers(sd, prefix, blocks):
    for i, b in enumerate(blocks):
        pre = f"{prefix}.encoder.layers.{i}"
        _ln(sd, f"{pre}.layer_norm1", b["ln1"])
        for k, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                        ("o", "out_proj")):
            _lin(sd, f"{pre}.self_attn.{name}", b["attn"][k])
        _ln(sd, f"{pre}.layer_norm2", b["ln2"])
        _lin(sd, f"{pre}.mlp.fc1", b["fc1"])
        _lin(sd, f"{pre}.mlp.fc2", b["fc2"])


def _patch(patch_w, patch):
    return patch_w.reshape(patch, patch, 3, -1).permute(3, 2, 0, 1)


def hf_t5(p):
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
    return sd


def hf_clip_text(p):
    sd = {"text_model.embeddings.token_embedding.weight": p["tok_emb"],
          "text_model.embeddings.position_embedding.weight": p["pos_emb"],
          "text_projection.weight": p["proj"].t()}
    _ln(sd, "text_model.final_layer_norm", p["ln_final"])
    _layers(sd, "text_model", p["blocks"])
    return sd


def hf_siglip(p, patch):
    v = "vision_model"
    sd = {f"{v}.embeddings.patch_embedding.weight": _patch(p["patch_w"], patch),
          f"{v}.embeddings.patch_embedding.bias": p["patch_b"],
          f"{v}.embeddings.position_embedding.weight": p["pos_emb"]}
    _ln(sd, f"{v}.post_layernorm", p["post_ln"])
    _layers(sd, v, p["blocks"])
    return sd


def hf_redux(p):
    sd = {}
    _lin(sd, "redux_up", p["up"])
    _lin(sd, "redux_down", p["down"])
    return sd


def layout_configs(fill: bool, tiny: bool):
    """The port's configs of one deployment: full width, or the tiny
    bundle's (``pipeline.tiny_configs``)."""
    from domainrag_tpu_torch.models import clip, redux, siglip, t5
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import pipeline, vae
    if tiny:
        c = pipeline.tiny_configs(fill)
        return dict(transformer=c["flux_cfg"], vae=c["vae_cfg"],
                    t5=c["t5_cfg"], clip_text=c["clip_text_cfg"],
                    siglip=c["siglip_cfg"], redux=c["redux_cfg"])
    return dict(transformer=fm.FLUX_FILL_DEV if fill else fm.FLUX_DEV,
                vae=vae.FLUX_VAE, t5=t5.T5_XXL,
                clip_text=clip.ClipTextConfig(),
                siglip=siglip.SIGLIP_SO400M, redux=redux.REDUX_DEV)


def published_state(component: str, cfg, dtype: torch.dtype) -> dict:
    """One component's published-layout tensors with marked draws."""
    from domainrag_tpu_torch.core import prng
    from domainrag_tpu_torch.models import clip, redux, siglip, t5
    from domainrag_tpu_torch.models.export_diffusers import (
        export_flux_to_diffusers, export_vae_to_diffusers)
    from domainrag_tpu_torch.models.flux import model as fm
    from domainrag_tpu_torch.models.flux import vae
    key = prng.PRNGKey(0, device="cpu")
    with _marked_draws():
        if component == "transformer":
            return export_flux_to_diffusers(fm.init(key, cfg, dtype=dtype),
                                            cfg)
        if component == "vae":
            return export_vae_to_diffusers(vae.init(key, cfg))
        if component == "t5":
            return hf_t5(t5.init(key, cfg))
        if component == "clip_text":
            return hf_clip_text(clip.init_text(key, cfg))
        if component == "siglip":
            return hf_siglip(siglip.init(key, cfg), cfg.patch_size)
        if component == "redux":
            return hf_redux(redux.init(key, cfg))
    raise ValueError(component)


def _entry(key: str, t: torch.Tensor) -> list:
    if all(st == 0 for st, n in zip(t.stride(), t.shape) if n > 1):
        lo = hi = float(t[(0,) * t.dim()])     # an expanded draw
    else:
        lo, hi = float(t.min()), float(t.max())
    if lo != hi:
        raise ValueError(f"{key}: neither a marked draw nor a constant")
    if lo < 0.0:           # a marked draw: the constants are 0 and 1
        return [key, list(t.shape), _DTYPE_NAMES[t.dtype], "normal", -lo]
    return [key, list(t.shape), _DTYPE_NAMES[t.dtype], "const", lo]


def group_of(key: str) -> str:
    m = _GROUP.match(key)
    return m.group(1) if m else "_top"


def layout(component: str, cfg, dtype: torch.dtype) -> dict:
    """{group: [[key, shape, dtype, "normal"|"const", std|value], ...]},
    keys in the export's order within each group."""
    groups: dict = {}
    for key, t in published_state(component, cfg, dtype).items():
        groups.setdefault(group_of(key), []).append(_entry(key, t))
    return groups


# the dtype each component is served in (the port's bundles)
SERVED = {"transformer": torch.bfloat16, "vae": torch.float32,
          "t5": torch.float32, "clip_text": torch.float32,
          "siglip": torch.float32, "redux": torch.float32}


def derive(fill: bool, tiny: bool = False) -> dict:
    cfgs = layout_configs(fill, tiny)
    return {name: layout(name, cfgs[name], SERVED[name]) for name in SERVED}


def port_sizes(fill: bool, tiny: bool = False) -> dict:
    """The port's config dataclasses as plain dicts."""
    return {k: dataclasses.asdict(v)
            for k, v in layout_configs(fill, tiny).items()}


# the published configs each file restates (diffusers / transformers
# config.json of the checkpoints the layout is named after)
_PUBLISHED_TOWERS = {
    "vae": {"source": "black-forest-labs/FLUX.1-dev vae/config.json",
            "latent_channels": 16, "block_out_channels": [128, 256, 512, 512],
            "layers_per_block": 2, "norm_num_groups": 32,
            "scaling_factor": 0.3611, "shift_factor": 0.1159},
    "t5": {"source": "google/t5-v1_1-xxl encoder (FLUX.1-dev text_encoder_2)",
           "d_model": 4096, "d_kv": 64, "d_ff": 10240, "num_layers": 24,
           "num_heads": 64, "relative_attention_num_buckets": 32,
           "relative_attention_max_distance": 128, "vocab_size": 32128,
           "feed_forward_proj": "gated-gelu", "max_sequence_length": 512},
    "clip_text": {"source": "openai/clip-vit-large-patch14 text tower "
                            "(FLUX.1-dev text_encoder)",
                  "hidden_size": 768, "intermediate_size": 3072,
                  "num_hidden_layers": 12, "num_attention_heads": 12,
                  "max_position_embeddings": 77, "vocab_size": 49408,
                  "hidden_act": "quick_gelu"},
    "siglip": {"source": "google/siglip-so400m-patch14-384 vision tower "
                         "(FLUX.1-Redux-dev image_encoder)",
               "hidden_size": 1152, "intermediate_size": 4304,
               "num_hidden_layers": 27, "num_attention_heads": 16,
               "image_size": 384, "patch_size": 14},
    "redux": {"source": "black-forest-labs/FLUX.1-Redux-dev "
                        "image_embedder/config.json",
              "redux_dim": 1152, "txt_in_features": 4096},
}
_PUBLISHED_MMDIT = {
    "flux-dev": {"source": "black-forest-labs/FLUX.1-dev "
                           "transformer/config.json",
                 "attention_head_dim": 128, "axes_dims_rope": [16, 56, 56],
                 "guidance_embeds": True, "in_channels": 64,
                 "joint_attention_dim": 4096, "num_attention_heads": 24,
                 "num_layers": 19, "num_single_layers": 38, "patch_size": 1,
                 "pooled_projection_dim": 768},
    "flux-fill-dev": {"source": "black-forest-labs/FLUX.1-Fill-dev "
                                "transformer/config.json",
                      "attention_head_dim": 128,
                      "axes_dims_rope": [16, 56, 56], "guidance_embeds": True,
                      "in_channels": 384, "out_channels": 64,
                      "joint_attention_dim": 4096, "num_attention_heads": 24,
                      "num_layers": 19, "num_single_layers": 38,
                      "patch_size": 1, "pooled_projection_dim": 768},
}


def config_file(name: str) -> dict:
    """The whole configuration file of ``name``."""
    fill = name == "flux-fill-dev"
    return {
        "name": name,
        "source": "https://huggingface.co/black-forest-labs/"
                  + ("FLUX.1-Fill-dev" if fill else "FLUX.1-dev"),
        "reduced": [],
        "published": dict(transformer=_PUBLISHED_MMDIT[name],
                          **_PUBLISHED_TOWERS),
        "served_dtype": {k: _DTYPE_NAMES[v] for k, v in SERVED.items()},
        "sizes": port_sizes(fill),
        "t5_max_len": 512,
        "layout": derive(fill),
    }


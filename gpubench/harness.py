"""Set-up, warm-up and the measured window of one cell, driven through the
stages' own entry points: ``GenerateStage.generate_sample`` (stage 3)
and ``ComposeStage.process_sample`` (stage 4).

The weights are made from the seed in the published checkpoints' layout
(``gpubench.weights``) and handed to the program's own loader,
``models.convert.load_flux_bundle``, in place of the files it would map.
The stage gets a timer that synchronises the device at each of its
spans, records every span, and closes the window at the first denoise
step that ends after the deadline. While the window's first sample runs,
thin wrappers around four of the program's functions copy what they are
given and what they return at the steps the check samples; the program's
arithmetic is untouched, and the copies' seconds are counted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import weights as wmod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class WindowClosed(Exception):
    """Raised by the timer at the first step that ends past the deadline."""


def load_json(*parts) -> dict:
    with open(os.path.join(ROOT, "gpubench", *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict          # gpubench/cells/<name>.json
    config: dict        # gpubench/configs/<config>.json
    traffic: dict       # gpubench/traffic/<traffic>.json

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        spec = load_json("cells", f"{name}.json")
        conf = next(c for c in bench["configs"]
                    if c["name"] == entry["config"])
        with open(os.path.join(ROOT, conf["file"])) as f:
            config = json.load(f)
        return cls(name, spec, config,
                   load_json("traffic", f"{entry['traffic']}.json"))

    @property
    def fill(self) -> bool:
        return self.traffic["stage"] == "compose"

    @property
    def batch(self) -> int:
        return self.traffic["batch"]


class BenchTimer:
    """The stages' ``timer``: every span synchronised and recorded; the
    window closes at the first ``step`` that ends at or past
    ``deadline`` (or after ``max_steps``, for the warm-up)."""

    def __init__(self, deadline: float = float("inf"),
                 max_steps: Optional[int] = None, annotate: bool = False,
                 device: str = "cuda"):
        self.deadline, self.max_steps = deadline, max_steps
        self.cuda = torch.device(device).type == "cuda"
        self.annotate = annotate
        self.spans: List[tuple] = []      # (name, start, end)
        self.steps = 0

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        with ctx:
            yield
            self.sync()
        t1 = time.perf_counter()
        self.spans.append((name, t0, t1))
        if name == "step":
            self.steps += 1
            if t1 >= self.deadline or self.steps == self.max_steps:
                raise WindowClosed


# ---------------------------------------------------------------------------
# inputs made from the seed
# ---------------------------------------------------------------------------

def _image(rng: np.random.Generator, w: int, h: int):
    """A smooth random colour field (an 8 x 8 field resized bicubically)
    with fine noise, as a PIL image."""
    from PIL import Image
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
        if not cell.fill:
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


def build_bundle(cell: Cell, seed: int, w8a8: bool, device: str = "cuda"):
    """The bundle as ``--checkpoints`` builds it, from published-layout
    tensors made on the device; with ``w8a8`` quantized as ``--w8a8``
    quantizes it (the int8 control)."""
    from domainrag_tpu_torch.core import text as text_util
    from domainrag_tpu_torch.models import convert
    comps = wmod.components(cell.config, seed, device)
    mmdit = "flux-fill" if cell.fill else "flux-dev"
    by_dir = {(_SUBDIR[k] or mmdit): c for k, c in comps.items()}

    def no_tokenizer_files(path):
        raise FileNotFoundError(f"no tokenizer files under {path}")

    saved = convert.load_safetensors_dir, text_util.load_hf_tokenizers
    convert.load_safetensors_dir = lambda path, lazy=True: by_dir[
        os.path.basename(path)]
    text_util.load_hf_tokenizers = no_tokenizer_files
    try:
        bundle = convert.load_flux_bundle(
            "checkpoints", fill=cell.fill,
            compute_dtype=wmod.DTYPES[cell.config["served_dtype"]
                                      ["transformer"]],
            configs=port_configs(cell.config), device=device)
    finally:
        convert.load_safetensors_dir, text_util.load_hf_tokenizers = saved
        for c in comps.values():
            c.release()
    if w8a8:
        from domainrag_tpu_torch.cli.main import _quantize_in_place
        _quantize_in_place(bundle.flux_params)
    return bundle


@contextlib.contextmanager
def int8_modes(on: bool):
    """The program's int8 path for the block: ``--w8a8 --int8_qk`` and
    int8 P.V (the int8 control)."""
    from domainrag_tpu_torch.models import common
    from domainrag_tpu_torch.ops import mmdit_attention
    common.set_int8_activations(on)
    mmdit_attention.set_int8_qk(on)
    mmdit_attention.set_int8_pv(on)
    try:
        yield
    finally:
        common.set_int8_activations(False)
        mmdit_attention.set_int8_qk(False)
        mmdit_attention.set_int8_pv(False)


def make_stage(cell: Cell, bundle):
    t = cell.traffic
    if not cell.fill:
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
    from PIL import Image
    if not cell.fill:
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

class Recorder:
    """Wraps the prior, the Fill conditioning, the MMDiT forward and the
    Euler update of the program while the window's first sample runs,
    keeping host copies of their inputs and outputs at ``steps``. Inside
    those steps' forwards it also keeps, for the row ``op_row`` (one of
    ``rows``; the first by default), what the single block ``block``'s
    two linears and the output layer's projection were given and gave,
    at ``tokens`` token rows of each call drawn from ``token_seed`` (all
    where None), and the block's attention's q, k, v and output. The
    copies' seconds are counted in ``seconds``: the device is drained
    before each, so they are the copies' own."""

    def __init__(self, steps, rows=(), block=0, op_row=None, tokens=None,
                 token_seed=0):
        self.steps = set(steps)
        self.rows = torch.tensor(sorted(rows), dtype=torch.long)
        self.block = block
        self.op_row = int(self.rows[0]) if op_row is None else op_row
        self.tokens = tokens
        self._rng = random.Random(token_seed)
        self.seconds = 0.0
        self.prior = None
        self.fill_cond = None
        self.model: Dict[int, dict] = {}
        self.euler: Dict[int, dict] = {}
        self.layers: Dict[int, dict] = {}
        self._n_model = self._n_euler = self._n_single = 0
        self._active = None              # the step whose forward runs
        self._probe = None               # the sampled block's params
        self._final = None               # the model's, in its output layer
        self._saved = []

    def _host(self, x):
        if not torch.is_tensor(x):
            return x
        if x.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = x.detach().to("cpu", copy=True)
        self.seconds += time.perf_counter() - t0
        return out

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

    def _patch(self, module, name, wrapper):
        real = getattr(module, name)
        self._saved.append((module, name, real))
        setattr(module, name, wrapper(real))

    def __enter__(self):
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

        self._patch(fp, "redux_prior_pairs_indexed", prior)
        self._patch(fp, "_fill_conditioning", cond)
        self._patch(fm, "apply", model)
        self._patch(fm, "_single_block", single)
        self._patch(fm, "linear", linear)
        self._patch(fm, "mmdit_single_attention", attention)
        self._patch(fm, "_final", final)
        self._patch(scheduler, "euler_step", euler)
        return self

    def __exit__(self, *exc):
        for module, name, real in reversed(self._saved):
            setattr(module, name, real)
        self._saved = []


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


def free_program():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

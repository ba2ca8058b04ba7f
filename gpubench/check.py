"""The comparison that decides ``correct``: what the window's first sample
produced, against the float32 reference, after the program is freed.

Numbers (each a relative L2 gap, the worst over what was compared):

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
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from PIL import Image

from . import weights as wmod
from .reference import flux as rflux
from .reference import prior as rprior
from .reference import vae as rvae
from .reference.ops import precision


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def row_gaps(got: torch.Tensor, want: torch.Tensor) -> list:
    return [rel_gap(got[r:r + 1], want[r:r + 1]) for r in range(got.shape[0])]


def prior_reference(cell, comps, sample):
    """The sample's Redux prior worked out from its files."""
    t, sizes = cell.traffic, cell.config["sizes"]
    if not cell.fill:
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
    in float8 in the program's place, against the reference in float32:
    the velocity of the sampled rows, the sampled block's two linears and
    attention, from the program's inputs."""
    grid = cell.traffic["latent_grid"]
    tcfg = cell.config["sizes"]["transformer"]
    w = comps["transformer"]
    out = {"velocity_gap": [], "gemm_gap": [], "attn_gap": []}
    for i, m in rec.model.items():
        m = {k: v.index_select(0, rec.rows).to(dev) if torch.is_tensor(v)
             and v.dim() else v for k, v in m.items()}
        lay, qkv, cos, sin = _op_inputs(cell, rec, i, dev)
        got = {}
        for mode in ("f32", "fp8"):
            with precision(mode):
                got[mode] = (
                    rflux.forward(w, tcfg, m["inp"], m["embeds"], m["pooled"],
                                  m["timestep"], m["guidance"], grid, grid),
                    rflux.single_linear1(w, rec.block, lay["linear1"]["x"]),
                    rflux.single_linear2(w, rec.block, lay["linear2"]["x"]),
                    rflux.single_attention(w, tcfg, rec.block, qkv, cos,
                                           sin))
        (v32, a32, b32, t32), (v8, a8, b8, t8) = got["f32"], got["fp8"]
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
        if cell.fill:
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
    the bfloat16 encode and MMDiT with float8 operands, the float32 Euler
    update in bfloat16), against the float32 reference. The program's
    own int8 path is a second control of the MMDiT (``control.py``)."""
    comps = wmod.components(cell.config, seed, dev)
    out = {}
    with torch.inference_mode():
        with precision("f32"):
            e32, p32 = prior_reference(cell, comps, sample)
        with precision("tf32"):
            e, p = prior_reference(cell, comps, sample)
        out["prior_gap"] = max(rel_gap(e, e32), rel_gap(p, p32))
        del e32, p32, e, p
        if cell.fill:
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

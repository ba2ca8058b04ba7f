"""A cell at the tiny bundles' widths, for the CPU tests: the same files'
structure and the same path as the real cells, on the CPU, the MMDiT in
float32 so the reference can be held tight."""

from __future__ import annotations

import copy
import json
import os

from gpubench import harness
from gpubench.families import flux

ROOT = harness.ROOT


def tiny_config(fill: bool) -> dict:
    return {"name": "tiny-fill" if fill else "tiny-dev",
            "served_dtype": {k: "float32" for k in flux.SERVED},
            "sizes": flux.port_sizes(fill, tiny=True),
            "t5_max_len": 16,
            "layout": flux.derive(fill, tiny=True)}


def tiny_traffic(fill: bool) -> dict:
    name = "uodd2048" if fill else "gen1024"
    with open(os.path.join(ROOT, "gpubench", "traffic", f"{name}.json")) as f:
        t = json.load(f)
    t = copy.deepcopy(t)
    t.update(samples=1, warm_steps=1, image_px=40, s_txt=16 + 16,
             check_steps_below=2, check_steps=1)
    if fill:
        t.update(upscale_dimension=64, background_px=32, s_img=256,
                 latent_grid=16, hires_threshold_px=64 * 64,
                 bboxes=[[4, 6, 9, 7], [22, 20, 6, 8]], steps=10,
                 steps_per_image=4)
    else:
        t.update(size=32, s_img=64, latent_grid=8, steps=4,
                 steps_per_image=4)
    return t


def tiny_cell(fill: bool, limits=None) -> harness.Cell:
    spec = {"limits": limits or {}}
    return harness.Cell("tiny-fill" if fill else "tiny-gen", spec,
                        tiny_config(fill), tiny_traffic(fill))

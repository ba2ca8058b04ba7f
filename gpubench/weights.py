"""Weights in the published checkpoints' key layout, made from a seed.

A configuration file freezes each component's keys as groups (one group
per layer index, ``_top`` for the rest), each key with its shape, dtype
and draw: ``normal`` (a standard normal times the recorded std) or
``const``. A group is drawn on the device by one generator seeded from
(seed, component, group), in one flat draw per dtype, so any group can be
drawn again alone, in the same bits, by the reference after the window.

Imports nothing of the program.
"""

from __future__ import annotations

import hashlib
from collections.abc import Mapping
from typing import Dict, Iterator

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def group_seed(seed: int, component: str, group: str) -> int:
    h = hashlib.blake2b(f"{seed}:{component}:{group}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def draw_group(entries: list, seed: int, component: str, group: str,
               device) -> Dict[str, torch.Tensor]:
    """Every tensor of one group, in the dtypes the layout records."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, component, group))
    out: Dict[str, torch.Tensor] = {}
    normals: Dict[str, list] = {}
    for key, shape, dtype, kind, value in entries:
        if kind == "normal":
            normals.setdefault(dtype, []).append((key, shape, value))
        else:
            out[key] = torch.full(shape, value, dtype=DTYPES[dtype],
                                  device=device)
    for dtype in sorted(normals):
        items = normals[dtype]
        sizes = [_numel(shape) for _, shape, _ in items]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=DTYPES[dtype])
        for (key, shape, std), part in zip(items, flat.split(sizes)):
            out[key] = part.view(shape).mul_(std)
    return {key: out[key] for key, *_ in entries}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class Component(Mapping):
    """One component's published state dict, drawn group by group as its
    keys are read (the one group last read is kept), as the port's
    ``load_safetensors_dir`` maps a file tensor by tensor."""

    def __init__(self, layout: dict, seed: int, name: str, device):
        self.layout, self.seed, self.name = layout, seed, name
        self.device = torch.device(device)
        self._group_of = {e[0]: g for g, entries in layout.items()
                          for e in entries}
        self._cached = (None, {})

    def group(self, group: str) -> Dict[str, torch.Tensor]:
        if self._cached[0] != group:
            self._cached = (None, {})
            self._cached = (group, draw_group(
                self.layout[group], self.seed, self.name, group,
                self.device))
        return self._cached[1]

    def release(self) -> None:
        self._cached = (None, {})

    def __getitem__(self, key: str) -> torch.Tensor:
        return self.group(self._group_of[key])[key]

    def __contains__(self, key) -> bool:
        return key in self._group_of

    def __iter__(self) -> Iterator[str]:
        return iter(self._group_of)

    def __len__(self) -> int:
        return len(self._group_of)


def component_seed_name(config: dict, component: str) -> str:
    """The towers and the VAE are one draw for both deployments; each
    MMDiT is its own."""
    if component == "transformer":
        return f"{config['name']}/transformer"
    return component


def components(config: dict, seed: int, device) -> Dict[str, Component]:
    return {name: Component(layout, seed, component_seed_name(config, name),
                            device)
            for name, layout in config["layout"].items()}

"""Carry the JAX package's weights and configs into the port.

:func:`params` takes a parameter tree as nested dicts and lists of numpy
arrays (``jax.tree.map(np.asarray, params)`` of any ``init`` that
``tiny_bundle`` builds: ``flux.init``, ``vae.init``, ``t5.init``,
``clip.init_text``, ``siglip.init``, ``redux.init``; the retrieval
trees of ``clip.init_vision`` and ``resnet_stem.init``; and
``lama.init``) and returns the
same tree of torch tensors: same keys, linear weights kept in their
``(in, out)`` layout (the vision tower's 2-D ``patch_w``, ``class_emb``,
``pos_emb``, ``proj`` and the batchnorm statistics go across as they
are), every quantized weight ``w_q`` turned once from the JAX package's
``(in, out)`` into the port's K-major ``(out, in)`` (:mod:`models.quant`),
and every 4-D conv kernel turned once from JAX's HWIO into torch's
OIHW (the stem's ``conv1``, the VAE's and LaMa's convs). That holds for
the transposed convs too: the LaMa tree's ``up[i]["conv"]["w"]``, HWIO
(kh, kw, c_in, c_out) for ``lax.conv_transpose``, comes out (c_out, c_in,
kh, kw), unflipped, which is the layout
:func:`models.common.conv2d_transpose` takes (``lama.init`` draws it so).
:func:`config` rebuilds a config dataclass of the port from the JAX
package's by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .core import device as device_mod


def _tensor(x, dev: torch.device, k_major: bool = False) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.ndim == 4:                        # conv kernel: HWIO -> OIHW
        arr = arr.transpose(3, 2, 0, 1)
    if k_major:                              # quantized (in, out) -> (out, in)
        arr = arr.T
    return torch.from_numpy(np.array(arr, order="C")).to(dev)


def _convert(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _tensor(v, dev, k_major=True) if k == "w_q"
                else _convert(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, dev) for v in tree)
    return _tensor(tree, dev)


def params(tree: Any, device=None) -> Any:
    """numpy parameter tree -> torch tree on ``device`` (the card unless
    ``device="cpu"``), dtypes kept."""
    return _convert(tree, device_mod.resolve(device))


def config(jax_cfg: Any, port_cls: type) -> Any:
    """A port config dataclass with the values of the JAX one's fields."""
    return port_cls(**{f.name: getattr(jax_cfg, f.name)
                       for f in dataclasses.fields(port_cls)})

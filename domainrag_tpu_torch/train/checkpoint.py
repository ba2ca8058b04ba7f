"""Model/optimizer checkpoints (port of ``domainrag_tpu/train/checkpoint.py``).

Same layout as the JAX package: ``{directory}/step_{n}`` per step, holding
a payload of ``{"params": tree}`` and, when given, ``"opt_state"``. The
JAX package writes it with Orbax; the port has no Orbax and writes the
payload with ``torch.save`` into ``step_{n}/payload.pt`` (tensors moved
to the host first, the optimizer state as its ``state_dict``). Reading
the JAX package's Orbax checkpoints is out of scope.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

PAYLOAD = "payload.pt"


def _host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _like(tree: Any, template: Any) -> Any:
    """``tree`` with each tensor moved to its template leaf's device and
    dtype (the template may be a tree of tensors or of any leaves with
    ``device``/``dtype``)."""
    if isinstance(template, dict):
        return {k: _like(v, template[k]) if k in template else v
                for k, v in tree.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(a, b) for a, b in zip(tree, template))
    if isinstance(tree, torch.Tensor) and hasattr(template, "device"):
        return tree.to(device=template.device, dtype=template.dtype)
    return tree


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None) -> str:
    """Write params (+ the optimizer's ``state_dict``) under
    ``{directory}/step_{step}``."""
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    payload = {"params": _host(params)}
    if opt_state is not None:
        payload["opt_state"] = _host(opt_state.state_dict())
    tmp = os.path.join(path, PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, PAYLOAD))
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None,
                       template: Any = None) -> Any:
    """Restore the payload (host tensors); ``template`` (a tree shaped like
    the payload) places each tensor on its leaf's device and dtype."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(os.path.abspath(directory), f"step_{step}", PAYLOAD)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if template is not None:
        return _like(payload, template)
    return payload

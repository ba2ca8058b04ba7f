"""Sharded retrieval search (port of ``domainrag_tpu/parallel/collectives.py``):
bank rows sharded over a mesh axis, a top-k per shard, an all-gather of
the k candidates and an exact global merge.

Each rank scans only N/d bank rows, B8 (``ops.topk.topk_ip_fused``) on
its shard on the card where ``use_pallas`` asks for it, else
``ops.topk.topk_ip``, as the JAX package's ``use_pallas`` selects. The
merge moves d*k candidates (tiny), never the score matrix.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import device as device_mod
from ..ops import topk as topk_ops


def pad_bank_for_mesh(bank: np.ndarray, mesh, axis: str = "data"
                      ) -> Tuple[np.ndarray, int]:
    """Zero-pad bank rows to a multiple of the axis size. Returns
    (padded_bank, n_valid); pass ``n_valid`` to :func:`sharded_topk`,
    which masks pad rows out of the merge."""
    n, d = bank.shape
    d_axis = mesh.shape[axis]
    n_pad = (n + d_axis - 1) // d_axis * d_axis
    if n_pad == n:
        return np.asarray(bank, np.float32), n
    pad = np.zeros((n_pad - n, d), np.float32)
    return np.concatenate([np.asarray(bank, np.float32), pad], 0), n


def sharded_topk(queries: torch.Tensor, bank: torch.Tensor, k: int, mesh,
                 n_valid: int, axis: str = "data",
                 use_pallas: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries (Q, D), the same on every rank; ``bank`` this rank's shard
    of the padded bank (:func:`shard_bank`). Returns (Q, k) scores and
    GLOBAL int32 indices on every rank, in the single-device order (score
    desc, index asc). Shard indices are offset by the rank's first row,
    and pad rows (index >= ``n_valid``) enter the merge as (NEG_INF,
    2**31 - 1)."""
    shard_rows = bank.shape[0]
    k = min(k, n_valid)
    kk = min(k, shard_rows)
    q = queries.to(device=bank.device, dtype=torch.float32)
    fn = topk_ops.topk_ip_fused if (
        use_pallas and bank.device.type != "cpu") else topk_ops.topk_ip
    s, i = fn(q, bank, kk)
    i = i + mesh.index(axis) * shard_rows
    valid = i < n_valid
    s = torch.where(valid, s, torch.full_like(s, topk_ops.NEG_INF))
    i = torch.where(valid, i, torch.full_like(i, topk_ops.INT_MAX))
    # candidates of every shard, (Q, d * kk) in the axis's order
    s_all = mesh.all_gather(s, axis, dim=1)
    i_all = mesh.all_gather(i, axis, dim=1)
    # exact global merge, (score desc, index asc): a stable sort by index,
    # then a stable sort by score
    i_all, perm = torch.sort(i_all, dim=1, stable=True)
    s_all = torch.gather(s_all, 1, perm)
    s_all, perm = torch.sort(s_all, dim=1, descending=True, stable=True)
    return s_all[:, :k], torch.gather(i_all, 1, perm[:, :k])


def shard_bank(bank: np.ndarray, mesh, axis: str = "data", *,
               device=None) -> torch.Tensor:
    """This rank's rows of a padded bank (:func:`pad_bank_for_mesh`) as an
    f32 tensor on ``device`` (the card by default)."""
    n = bank.shape[0]
    d_axis = mesh.shape[axis]
    assert n % d_axis == 0, "use pad_bank_for_mesh first"
    rows = n // d_axis
    i = mesh.index(axis)
    part = np.ascontiguousarray(bank[i * rows:(i + 1) * rows], np.float32)
    return torch.from_numpy(part).to(device_mod.resolve(device))

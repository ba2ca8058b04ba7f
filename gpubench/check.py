"""The arithmetic every family's comparison shares. What a cell compares,
and against which reference, is its family's (``families/<family>.py``
``compare`` and ``control``); a number decides ``correct`` where the
cell file gives it a limit, and passes at or under it."""

from __future__ import annotations

import torch


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def row_gaps(got: torch.Tensor, want: torch.Tensor) -> list:
    return [rel_gap(got[r:r + 1], want[r:r + 1]) for r in range(got.shape[0])]

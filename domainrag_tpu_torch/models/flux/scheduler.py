"""Flow-match Euler scheduler (port of
``domainrag_tpu/models/flux/scheduler.py``).

diffusers ``FlowMatchEulerDiscreteScheduler`` as ``FluxPipeline`` drives
it: base sigma grid ``linspace(1, 1/steps, steps)`` plus a terminal 0,
flux-dev dynamic shifting (``mu`` from the image token count), Euler
update ``x += (sigma_next - sigma) * v`` in f32, the fill's forward
noising ``scale_noise``, and :func:`denoise`, the plain Euler loop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch


def calculate_shift(image_seq_len: int,
                    base_seq_len: int = 256, max_seq_len: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.15
                    ) -> float:
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def time_shift(mu: float, sigma_exponent: float, sigmas: np.ndarray
               ) -> np.ndarray:
    return math.exp(mu) / (math.exp(mu) +
                           (1.0 / sigmas - 1.0) ** sigma_exponent)


@dataclasses.dataclass(frozen=True)
class FlowSchedule:
    """Sigma table with terminal 0: ``sigmas[i] -> sigmas[i+1]`` per step."""

    sigmas: np.ndarray            # (num_steps + 1,), descending, last = 0
    start_index: int = 0          # strength trim offset

    @property
    def num_steps(self) -> int:
        return len(self.sigmas) - 1

    @property
    def timesteps(self) -> np.ndarray:
        """Model conditioning values: sigma (the embedder multiplies by
        1000)."""
        return self.sigmas[:-1]

    @property
    def start_sigma(self) -> float:
        return float(self.sigmas[0])


def make_schedule(num_steps: int,
                  image_seq_len: Optional[int] = None,
                  use_dynamic_shifting: bool = True,
                  base_shift: float = 0.5, max_shift: float = 1.15,
                  shift: float = 3.0,
                  strength: float = 1.0,
                  num_train_timesteps: int = 1000) -> FlowSchedule:
    """The (possibly strength-trimmed) sigma table, float32.
    ``num_train_timesteps`` is accepted and not read, as in the JAX
    package (the time embedder scales sigma by 1000 itself)."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    if use_dynamic_shifting:
        if image_seq_len is None:
            raise ValueError("dynamic shifting needs image_seq_len")
        mu = calculate_shift(image_seq_len, base_shift=base_shift,
                             max_shift=max_shift)
        sigmas = time_shift(mu, 1.0, sigmas)
    else:
        sigmas = shift * sigmas / (1.0 + (shift - 1.0) * sigmas)
    sigmas = np.append(sigmas, 0.0).astype(np.float32)
    init_steps = min(int(num_steps * strength), num_steps)
    t_start = max(num_steps - init_steps, 0)
    return FlowSchedule(sigmas=sigmas[t_start:], start_index=t_start)


def scale_noise(sample: torch.Tensor, noise: torch.Tensor,
                sigma: torch.Tensor) -> torch.Tensor:
    """Forward noising at sigma (diffusers ``scale_noise``), in f32: the
    JAX package's f32 ``sigma`` promotes bf16 operands, while a 0-d torch
    tensor would not, so both are widened here. Callers cast back."""
    return sigma * noise.float() + (1.0 - sigma) * sample.float()


def euler_step(x: torch.Tensor, velocity: torch.Tensor,
               sigma: torch.Tensor, sigma_next: torch.Tensor
               ) -> torch.Tensor:
    """f32 state update whatever the model's dtype, cast back to x's.
    ``sigma``/``sigma_next`` are f32 scalar tensors, so the step size is
    an f32 difference as in the JAX loop."""
    return (x.float() + (sigma_next - sigma) * velocity.float()).to(x.dtype)


def denoise(model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
            latents: torch.Tensor, schedule: FlowSchedule) -> torch.Tensor:
    """The full Euler loop: ``model_fn(latents, sigma)`` returns the
    velocity, and each step is :func:`euler_step` from ``sigmas[i]`` to
    ``sigmas[i + 1]`` (f32 scalar tensors on the latents' device)."""
    sigmas = torch.as_tensor(schedule.sigmas, dtype=torch.float32,
                             device=latents.device)
    x = latents
    for i in range(schedule.num_steps):
        x = euler_step(x, model_fn(x, sigmas[i]), sigmas[i], sigmas[i + 1])
    return x

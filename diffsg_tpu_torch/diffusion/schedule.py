"""Diffusion noise schedules and derived coefficient tables.

Counterpart of ``diffsg_tpu/diffusion/schedule.py``. Coefficients are
computed in float64 with NumPy and cast to float32 tensors once, on the
device, as the reference DDPM registers its buffers.

Quirks kept on purpose, for checkpoint parity: the cosine schedule clips
betas at **0.84**, and ``remove_noise_coeff = beta_t / sqrt(1 - alpha_bar_t)``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def cosine_beta_schedule(T: int, s: float = 0.008, beta_clip: float = 0.84) -> np.ndarray:
    """Nichol–Dhariwal cosine schedule over ``T`` steps, clipped at 0.84.

    Returns ``betas`` of shape ``(T,)`` as float64 NumPy.
    """
    t = np.arange(T + 1, dtype=np.float64)
    f = np.cos((t / T + s) / (1 + s) * np.pi / 2) ** 2
    alphas_bar = f / f[0]
    betas = 1.0 - alphas_bar[1:] / alphas_bar[:-1]
    return np.minimum(betas, beta_clip)


class Schedule(NamedTuple):
    """Precomputed diffusion coefficients, float32 tensors of shape ``(T,)``."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    reciprocal_sqrt_alphas: torch.Tensor
    remove_noise_coeff: torch.Tensor
    sqrt_betas: torch.Tensor

    @property
    def T(self) -> int:
        return self.betas.shape[0]


def schedule_from_betas(betas: np.ndarray, device: DeviceLike = "cuda") -> Schedule:
    """Build the full coefficient table from ``betas`` (float64 math, one
    cast to float32 on ``device``)."""
    dev = resolve_device(device)
    betas = np.asarray(betas, dtype=np.float64)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    return Schedule(
        betas=f32(betas),
        alphas=f32(alphas),
        alphas_cumprod=f32(alphas_cumprod),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        reciprocal_sqrt_alphas=f32(np.sqrt(1.0 / alphas)),
        remove_noise_coeff=f32(betas / np.sqrt(1.0 - alphas_cumprod)),
        sqrt_betas=f32(np.sqrt(betas)),
    )


def cosine_schedule(T: int, s: float = 0.008, beta_clip: float = 0.84,
                    device: DeviceLike = "cuda") -> Schedule:
    """Cosine betas -> the full :class:`Schedule` on ``device`` (the
    trainer's schedule)."""
    return schedule_from_betas(cosine_beta_schedule(T, s=s, beta_clip=beta_clip), device=device)

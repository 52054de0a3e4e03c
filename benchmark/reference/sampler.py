"""DiffSG's classifier-free-guidance samplers and decoders, in plain PyTorch.

Several requests are solved in one call: ``seg`` gives each row its
request, and every batch-global statistic (the early-step
re-standardization, the MSR decoder's min and max) is taken per request,
over that request's rows only, as a server that pads a request to a bucket
and masks the pad must give.

The published method, as the served program states it:

* CFG: ``eps = (1 + omega) eps(y, t, c) - omega eps(y, t, 0)``.
* DDPM over all T steps: ``y <- (y - beta_t / sqrt(1 - abar_t) eps) /
  sqrt(alpha_t) + (1 - abar_{t-1}) / (1 - abar_t) z`` with ``z = 0`` for
  t <= 1, and the first 4 steps re-standardize ``y`` by its mean and
  unbiased variance.
* DDIM with eta 0 over ``n`` respaced steps: ``y0 = (y - sqrt(1 - a_t) eps)
  / sqrt(a_t)``, ``y <- sqrt(a_prev) y0 + sqrt(1 - a_prev) eps``; the first
  ``clamp(n // 5, 1, 4)`` steps re-standardize.
* The time is shown to the net as ``t / T``, at batch 1.
* A net that predicts x0 or v (``config["sampler"]["parameterization"]``,
  ``"eps"`` where absent) has its CFG-combined output turned into epsilon
  before the step: x0: ``eps = (y - sqrt(abar_t) x0) / sqrt(1 - abar_t)``;
  v: ``eps = sqrt(1 - abar_t) y + sqrt(abar_t) v``.

A task module (``benchmark.reference.<task>``) gives ``conditions`` and
``decode(y, seg, n_seg, task_config)``. It may also give ``embed(cond,
task_config)``, the condition the net reads made from the request's (a
multi-task face's ``[one-hot | payload | 0s]``: the unconditional pass
zeroes the whole embedded row), and ``decode_with_x(y, X, seg, n_seg,
task_config)``, a decoder that also reads the requests' conditions, which
``solve`` then calls in place of ``decode``.
"""

from __future__ import annotations

import importlib
from typing import Dict, Sequence

import numpy as np
import torch

from .unet import UNet1D


class Coefficients:
    """The schedule's tables, from the float64 betas, as float32 on ``device``."""

    def __init__(self, betas: np.ndarray, device: torch.device):
        betas = np.asarray(betas, np.float64)
        alphas = 1.0 - betas
        abar = np.cumprod(alphas)
        abar_prev = np.concatenate([[abar[0]], abar[:-1]])
        self.T = len(betas)
        self.abar = abar

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        self.remove_noise = f32(betas / np.sqrt(1.0 - abar))
        self.rsqrt_alpha = f32(np.sqrt(1.0 / alphas))
        self.noise_coeff = f32((1.0 - abar_prev) / (1.0 - abar))
        self.sqrt_abar = f32(np.sqrt(abar))
        self.sqrt_1m_abar = f32(np.sqrt(1.0 - abar))

    def to_eps(self, out: torch.Tensor, y: torch.Tensor, i: int, parameterization: str
               ) -> torch.Tensor:
        """The net's output ``out`` at timestep ``i`` as epsilon."""
        if parameterization == "eps":
            return out
        if parameterization == "x0":
            return (y - self.sqrt_abar[i] * out) / self.sqrt_1m_abar[i]
        if parameterization == "v":
            return self.sqrt_1m_abar[i] * y + self.sqrt_abar[i] * out
        raise ValueError(f"unknown parameterization {parameterization!r}")


def segment_standardize(y: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """``y`` (R, D) with each request's rows shifted by their mean and divided
    by the square root of their unbiased variance (over all of its R_k x D
    values)."""
    D = y.shape[1]
    count = torch.zeros(n_seg, dtype=torch.float64, device=y.device).index_add_(
        0, seg, torch.full((y.shape[0],), float(D), dtype=torch.float64, device=y.device))
    total = torch.zeros(n_seg, dtype=torch.float64, device=y.device).index_add_(
        0, seg, y.double().sum(dim=1))
    mean = (total / count).to(y.dtype)
    dev2 = ((y - mean[seg][:, None]) ** 2).double().sum(dim=1)
    var = torch.zeros(n_seg, dtype=torch.float64, device=y.device).index_add_(0, seg, dev2)
    var = (var / (count - 1.0)).to(y.dtype)
    return (y - mean[seg][:, None]) / torch.sqrt(var)[seg][:, None]


def segment_min_max_scale(Y: torch.Tensor, seg: torch.Tensor, n_seg: int) -> torch.Tensor:
    """``Y`` (R, D) under its request's min-max scaling, taken over all of
    the request's rows and columns."""
    big = torch.finfo(Y.dtype).max
    mn = torch.full((n_seg,), big, dtype=Y.dtype, device=Y.device).scatter_reduce(
        0, seg, Y.min(dim=1).values, "amin")
    mx = torch.full((n_seg,), -big, dtype=Y.dtype, device=Y.device).scatter_reduce(
        0, seg, Y.max(dim=1).values, "amax")
    return (Y - mn[seg][:, None]) / (mx - mn)[seg][:, None]


def cfg_eps(net: UNet1D, y: torch.Tensor, t_norm: torch.Tensor, cond: torch.Tensor,
            omega: float) -> torch.Tensor:
    e_cond = net(y, t_norm, cond)
    if omega == 0.0:
        return e_cond
    e_uncond = net(y, t_norm, torch.zeros_like(cond))
    return (1.0 + omega) * e_cond - omega * e_uncond


def ddpm(net: UNet1D, co: Coefficients, cond: torch.Tensor, omega: float,
         noise: torch.Tensor, seg: torch.Tensor, n_seg: int, renorm_steps: int = 4,
         parameterization: str = "eps") -> torch.Tensor:
    """Ancestral CFG sampling over all T steps. ``noise`` (R, T + 1, D):
    column 0 is y_T, column s + 1 the z of the s-th step (t = T - 1 - s)."""
    T = co.T
    y = noise[:, 0]
    for s, i in enumerate(range(T - 1, -1, -1)):
        t_norm = torch.full((1,), float(i), dtype=torch.float32, device=y.device) / T
        eps = co.to_eps(cfg_eps(net, y, t_norm, cond, omega), y, i, parameterization)
        y = (y - co.remove_noise[i] * eps) * co.rsqrt_alpha[i]
        if i > 1:
            y = y + co.noise_coeff[i] * noise[:, s + 1]
        if s < renorm_steps:
            y = segment_standardize(y, seg, n_seg)
    return y


def respaced(T: int, n: int) -> np.ndarray:
    """``n`` timesteps evenly spaced over [0, T - 1], rounded, descending."""
    return np.unique(np.linspace(0, T - 1, n).round().astype(int))[::-1]


def ddim(net: UNet1D, co: Coefficients, cond: torch.Tensor, omega: float, n_steps: int,
         noise: torch.Tensor, seg: torch.Tensor, n_seg: int,
         parameterization: str = "eps") -> torch.Tensor:
    """Deterministic (eta 0) DDIM over the respaced steps; ``noise`` (R, 1, D)
    is y_T."""
    steps = respaced(co.T, n_steps)
    renorm = max(1, min(4, len(steps) // 5))
    y = noise[:, 0]
    for k, step in enumerate(steps):
        a_t = float(np.float32(co.abar[step]))
        a_prev = float(np.float32(co.abar[steps[k + 1]])) if k + 1 < len(steps) else 1.0
        t_norm = torch.full((1,), float(step), dtype=torch.float32, device=y.device) / co.T
        eps = co.to_eps(cfg_eps(net, y, t_norm, cond, omega), y, step, parameterization)
        y0 = (y - np.sqrt(1.0 - a_t) * eps) / np.sqrt(a_t)
        y = np.sqrt(a_prev) * y0 + np.sqrt(1.0 - a_prev) * eps
        if k < renorm:
            y = segment_standardize(y, seg, n_seg)
    return y


def simplex_project(Y: torch.Tensor, total: float) -> torch.Tensor:
    """Each row's Euclidean projection onto {p >= 0, sum p = total}."""
    D = Y.shape[1]
    s = torch.sort(Y, dim=1, descending=True).values
    tau_k = (torch.cumsum(s, dim=1) - total) / torch.arange(1, D + 1, dtype=Y.dtype,
                                                            device=Y.device)
    rho = (s > tau_k).sum(dim=1) - 1
    return torch.clamp(Y - torch.gather(tau_k, 1, rho[:, None]), min=0.0)


def solve(net: UNet1D, co: Coefficients, config: Dict, conds: Sequence[np.ndarray],
          noises: Sequence[torch.Tensor]) -> np.ndarray:
    """Solve several requests in one batch: ``conds[k]`` (n_k, C) normalized
    conditions, ``noises[k]`` the request's noise as the sampler reads it.
    Returns the decoded solutions of all requests, stacked in order."""
    dev = noises[0].device
    seg = torch.cat([torch.full((len(c),), k, dtype=torch.long, device=dev)
                     for k, c in enumerate(conds)])
    cond = torch.as_tensor(np.concatenate(conds), dtype=torch.float32, device=dev)
    noise = torch.cat(list(noises))
    task = importlib.import_module(f"benchmark.reference.{config['task']}")
    task_config, s = config["task_config"], config["sampler"]
    net_cond = task.embed(cond, task_config) if hasattr(task, "embed") else cond
    param = s.get("parameterization", "eps")
    if s["kind"] == "ddpm":
        y = ddpm(net, co, net_cond, s["omega"], noise, seg, len(conds), parameterization=param)
    else:
        y = ddim(net, co, net_cond, s["omega"], s["n_steps"], noise, seg, len(conds),
                 parameterization=param)
    if hasattr(task, "decode_with_x"):
        return task.decode_with_x(y, cond, seg, len(conds), task_config).cpu().numpy()
    return task.decode(y, seg, len(conds), task_config).cpu().numpy()

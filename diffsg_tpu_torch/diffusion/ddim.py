"""CFG-guided DDIM over a respaced sub-sequence of the trained timesteps.

Counterpart of ``diffsg_tpu/diffusion/ddim.py``. It uses the CFG fold and
the batch-1 time of :func:`diffusion.ddpm.cfg_sample`; the early-step batch
re-standardization runs on the leading steps of the respaced trajectory,
``clamp(n // 5, 1, 4)`` of them unless ``renorm_steps`` says otherwise.
``eta = 0`` is deterministic given ``init_noise``.

The sampler runs in ``cond``'s type, as the JAX one does: with bfloat16
conditions (and a bfloat16 ``init_noise`` and denoiser) the state, the
coefficients, the time and the re-standardization are all bfloat16, as in
the JAX package's production row (``bench.py:_production_row``). It moves
no data from the host inside its loop, so it can be captured in a CUDA
graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import obs
from .ddpm import ApplyFn, Omega, cfg_net, masked_mean_var
from .schedule import Schedule


def respaced_steps(T: int, n_steps: int) -> np.ndarray:
    """Evenly spaced timestep sub-sequence, descending (t = T-1 ... 0)."""
    return np.unique(np.linspace(0, T - 1, n_steps).round().astype(int))[::-1]


@torch.no_grad()
def ddim_sample(
    apply_fn: ApplyFn,
    sched: Schedule,
    cond: torch.Tensor,
    omega: Omega,
    data_dim: int,
    generator: Optional[torch.Generator] = None,
    n_steps: Optional[int] = None,
    eta: float = 0.0,
    init_noise: Optional[torch.Tensor] = None,
    renorm_steps: Optional[int] = None,
    valid_mask: Optional[torch.Tensor] = None,
    parameterization: str = "eps",
    skip_uncond: bool = False,
    step_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DDIM reverse sampler; returns ``y_0`` (B, data_dim).

    Args:
      apply_fn, sched, cond, omega, data_dim, valid_mask, parameterization,
        skip_uncond: as for :func:`diffusion.ddpm.cfg_sample`.
      generator: draws ``init_noise`` when it is not given, and the per-step
        noise when ``eta > 0``.
      n_steps: length of the respaced sub-sequence (default: all T steps).
      eta: 0 is deterministic; 1 gives DDPM-like noise on the sub-sequence.
      init_noise: optional (B, D) y_T.
      renorm_steps: leading steps with batch re-standardization (default
        ``clamp(n // 5, 1, 4)`` for n respaced steps).
      step_noise: optional (n, B, D) per-step noise for ``eta > 0``, entry i
        at the i-th respaced step; drawn from ``generator`` when not given.
    """
    if parameterization not in ("eps", "x0", "v"):
        raise ValueError(f"unknown parameterization {parameterization!r}")
    B, T = cond.shape[0], sched.T
    dtype, dev = cond.dtype, cond.device
    steps = respaced_steps(T, n_steps or T)
    n = len(steps)
    if renorm_steps is None:
        renorm_steps = max(1, min(4, n // 5))
    # alpha_bar at each step and at its successor in the sub-sequence,
    # indexed by Python ints: no index tensor goes to the device.
    abar = sched.alphas_cumprod
    a_t = [abar[int(s)].to(dtype) for s in steps]
    a_prev = [abar[int(s)].to(dtype) for s in steps[1:]] + [torch.ones((), dtype=dtype,
                                                                       device=dev)]

    if init_noise is None or (eta > 0 and step_noise is None):
        if generator is None:
            raise ValueError("ddim_sample needs a generator when init_noise is not "
                             "given, or eta > 0 and step_noise is not given")
    if init_noise is None:
        init_noise = torch.randn((B, data_dim), generator=generator, dtype=dtype, device=dev)

    net_cfg = cfg_net(apply_fn, cond, omega, skip_uncond)
    y = init_noise
    for i, step in enumerate(steps):
        at, ap = a_t[i], a_prev[i]
        t_norm = torch.full((1,), int(step), dtype=dtype, device=dev) / T
        eps = net_cfg(y, t_norm, (int(step), T))
        if parameterization == "x0":
            eps = (y - torch.sqrt(at) * eps) / torch.sqrt(1.0 - at)
        elif parameterization == "v":
            eps = torch.sqrt(1.0 - at) * y + torch.sqrt(at) * eps
        if parameterization != "eps":
            obs.count("x0_steps", 1, y)
        # Predict y0, then step to the next alpha_bar of the sub-sequence.
        y0_pred = (y - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        sigma = eta * torch.sqrt((1.0 - ap) / (1.0 - at)) * torch.sqrt(1.0 - at / ap)
        dir_coeff = torch.sqrt(torch.clamp(1.0 - ap - sigma ** 2, min=0.0))
        y = torch.sqrt(ap) * y0_pred + dir_coeff * eps
        if eta > 0:
            z = step_noise[i] if step_noise is not None else torch.randn(
                (B, data_dim), generator=generator, dtype=dtype, device=dev)
            y = y + sigma * z
        if i < renorm_steps:
            mean, var = masked_mean_var(y, valid_mask)
            y = (y - mean) / torch.sqrt(var)
    return y

"""The legacy (pre-CFG) sampler and its Dirichlet noise.

Counterpart of ``diffsg_tpu/diffusion/legacy.py``: the reference's older
``DiffusionOpt`` path (``ddpm_opt/diffusion.py:129-385``), kept for
capability parity and for reproducing the earlier experiments. The shipped
CFG path does not use it; it is held to the JAX package, not tuned.

* :func:`dirichlet_noise`: rows ~ Dirichlet(alpha), summing to a target
  (optionally shifted so that entries may be negative);
* :func:`legacy_denoise_step`: the ``custom_denoise`` update with its 4x
  noise-removal coefficient and the MSR clamp;
* :func:`legacy_sample`: the reverse loop, Dirichlet init summing to 1, a
  min-max renormalization of the whole tensor after every step, and an
  optional per-step objective record.

``torch.distributions.Dirichlet`` takes no generator, so the Dirichlet rows
are drawn by a seeded ``numpy.random.Generator`` (``Generator.dirichlet``)
on the host and moved to the device. The draws can also be injected
(``init``, ``step_noise``), which the tests use to feed both packages the
same numbers.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .schedule import Schedule


def dirichlet_noise(rng: np.random.Generator, shape: Tuple[int, int], target_sum: float,
                    alpha: float = 1.0, enable_neg: bool = True,
                    device: DeviceLike = "cuda") -> torch.Tensor:
    """Rows ~ Dirichlet(alpha * 1) from ``rng``, float32 on ``device``, made
    to sum to ``target_sum``: ``enable_neg`` shifts them (``d - 1/size +
    target/size``, entries may be negative), else they are scaled by
    ``target_sum`` (non-negative). Reference ``diffusion.py:47-80``."""
    n, size = shape
    d = torch.as_tensor(rng.dirichlet(np.full(size, alpha), n), dtype=torch.float32,
                        device=resolve_device(device))
    if enable_neg:
        return d - 1.0 / size + target_sum / size
    return d * target_sum


def legacy_denoise_step(sched: Schedule, y_t: torch.Tensor, eps_hat: torch.Tensor, step: int,
                        noise: torch.Tensor, task: str = "CONV_CO",
                        noise_removal_scale: float = 4.0) -> torch.Tensor:
    """``custom_denoise`` (``diffusion.py:302-322``): the posterior step with
    a 4x noise-removal coefficient; MSR (``task="MAX SUM RATE"``) also
    clamps to (0, 1]."""
    prev = max(step - 1, 0)
    y = ((y_t - noise_removal_scale * sched.remove_noise_coeff[step] * eps_hat)
         * sched.reciprocal_sqrt_alphas[step]
         + (1.0 - sched.alphas_cumprod[prev]) / (1.0 - sched.alphas_cumprod[step]) * noise)
    if task == "MAX SUM RATE":
        y = torch.where(y > 1, torch.ones_like(y), y)
        y = torch.where(y < 0, torch.full_like(y, 0.00001), y)
    return y


@torch.no_grad()
def legacy_sample(apply_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
                  sched: Schedule, cond: torch.Tensor, data_dim: int,
                  rng: Optional[np.random.Generator] = None, task: str = "CONV_CO",
                  record_objective: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                  init: Optional[torch.Tensor] = None,
                  step_noise: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The legacy reverse loop (``diffusion.py:324-385``) on ``cond``'s
    device.

    ``apply_fn(y_t, t, cond)`` -> eps_hat, with integer (unnormalized)
    timesteps ``t`` (B,), as the legacy model took them. After each step the
    whole tensor is min-max renormalized to [0, 1]. The step noise is
    row-wise Dirichlet(3) summing to 0, and zero at the last step.

    ``init`` (B, D) and ``step_noise`` (T, B, D; entry s at step i = T-1-s,
    the last ignored) replace the draws; those not given come from ``rng``
    (the init first, then one array a step). Returns ``(y_0, records)``,
    ``records`` the per-step ``record_objective(y_t)`` where given.
    """
    B, T, dev = cond.shape[0], sched.T, cond.device
    if (init is None or step_noise is None) and rng is None:
        raise ValueError("legacy_sample needs rng when init or step_noise is not given")
    y_t = (dirichlet_noise(rng, (B, data_dim), 1.0, enable_neg=False, device=dev)
           if init is None else init.to(dev))
    records = []
    for s, i in enumerate(range(T - 1, -1, -1)):
        t = torch.full((B,), i, dtype=cond.dtype, device=dev)
        eps_hat = apply_fn(y_t, t, cond)
        if i == 0:
            noise = torch.zeros_like(y_t)
        elif step_noise is not None:
            noise = step_noise[s].to(dev)
        else:
            noise = dirichlet_noise(rng, (B, data_dim), 0.0, alpha=3.0, device=dev)
        y_t = legacy_denoise_step(sched, y_t, eps_hat, i, noise, task)
        y_t = (y_t - y_t.min()) / (y_t.max() - y_t.min())
        if record_objective is not None:
            records.append(record_objective(y_t))
    return y_t, records

"""Step-wise debug objective evaluators (``ddpm_opt/diffusion.py:86-127``).

Counterpart of ``diffsg_tpu/ops/debug_eval.py``: quick objective estimates
of intermediate denoising states, for the legacy sampler's objective record
and debug harnesses, with the reference's hard-coded CO scaler constants.
"""

from __future__ import annotations

from typing import Tuple

import torch

# The inverse-scale constants of the reference's "new de-abnormal" CO
# dataset (``diffusion.py:96``).
CO_DEBUG_SCALER_MAX = 9.99927554792418
CO_DEBUG_SCALER_MIN = 0.0015867173453851023


def step_cost_calc(y0: torch.Tensor, x0: torch.Tensor,
                   lambda0: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Debug CO objective (``diffusion.py:86-112``): softmax-decode y,
    threshold the offload decision at 0.1, inverse-scale x with the
    hard-coded constants (adding ``+ max`` where ``+ min`` was meant, as the
    reference does) and return ``(cost, decoded y)``."""
    y = torch.softmax(y0, dim=1) + 1e-5
    x = x0 * (CO_DEBUG_SCALER_MAX - CO_DEBUG_SCALER_MIN) + CO_DEBUG_SCALER_MAX
    D = (y > 0.1).to(y.dtype)
    local = x[:, 0::3]
    transition = x[:, 1::3]
    execution = x[:, 2::3]
    cost = torch.sum((1 - D) * local + D * (transition + execution / y), dim=1)
    return lambda0 * cost, y


def step_sum_rate(p0: torch.Tensor, g0: torch.Tensor,
                  W: float = 10.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Debug MSR objective (``diffusion.py:114-127``): scale the powers by 10,
    renormalize each row to sum to W exactly, return ``(rate, powers)``."""
    p = p0 * 10.0
    p_sum = torch.sum(p, dim=1, keepdim=True)
    p = p - p / p_sum * (p_sum - W)
    r = torch.sum(torch.log2(1.0 + p * g0[:, : p.shape[1]]), dim=1)
    return r, p

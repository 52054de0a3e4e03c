"""Waterfilling: the exact feasible optimum of the MSR task.

maximize sum_i log2(1 + p_i g_i)  s.t.  sum p = W, p >= 0
has the closed form p_i = max(mu - 1/g_i, 0), with the water level mu set so
the powers sum to W. Counterpart of ``diffsg_tpu/baselines/waterfilling.py``;
it is the yardstick the port's MSR solutions are scored against.
"""

from __future__ import annotations

import torch


def waterfilling(g: torch.Tensor, W: float) -> torch.Tensor:
    """Optimal feasible power allocation. g: (B, M) channel gains > 0."""
    inv = 1.0 / g
    inv_sorted, _ = torch.sort(inv, dim=1)                   # ascending
    csum = torch.cumsum(inv_sorted, dim=1)
    k = torch.arange(1, g.shape[1] + 1, dtype=g.dtype, device=g.device)[None, :]
    mu_k = (W + csum) / k                  # water level if k channels are active
    k_star = (mu_k > inv_sorted).sum(dim=1) - 1              # largest valid k
    mu = torch.gather(mu_k, 1, k_star[:, None])
    return torch.clamp(mu - inv, min=0.0)

"""Objective evaluators. Counterpart of ``diffsg_tpu/ops/objectives.py``.

Each is plain differentiable tensor code: refinement (``ops/refine.py``)
and objective guidance (``cfg_sample(guidance_fn=...)``) take their
gradients with ``torch.autograd``.
"""

from __future__ import annotations

import torch

def co_cost(X: torch.Tensor, Y: torch.Tensor, decision_threshold: float = 0.1) -> torch.Tensor:
    """Overall offloading cost per sample; X (B, 3N) derived features,
    interleaved per node as [local, offload transition, ideal offload
    execution]; Y (B, N) resource shares -> (B,).

    The offload decision is D = (Y > 0.1). Shares of local nodes are zeroed
    and the residual ``1 - sum Y`` is spread equally over the offloaded
    nodes; an all-local row divides by 1e-5 instead of 0, and local nodes
    get the share 1e-5 (multiplied by D = 0). The cost is
    ``sum_i (1 - D_i) local_i + D_i (transition_i + execution_i / Y_i)``.
    """
    D = (Y > decision_threshold).to(Y.dtype)
    Yz = Y * D
    Y_sum = Yz.sum(dim=1)
    D_sum = D.sum(dim=1)
    D_sum = torch.where(D_sum == 0, torch.full_like(D_sum, 1e-5), D_sum)
    Y_diff = ((1.0 - Y_sum) / D_sum)[:, None]
    Yr = torch.where(D == 1, Yz + Y_diff, torch.full_like(Yz, 1e-5))
    local, transition, execution = X[:, 0::3], X[:, 1::3], X[:, 2::3]
    return ((1.0 - D) * local + D * (transition + execution / Yr)).sum(dim=1)


# NU channel model (the JAX package's ``ops/objectives.py`` constants).
NU_SIGMA_SQ = 110.0
NU_RHO_0 = 60.0
NU_UAV_H = 150.0


def msr_sum_rate(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-sample rate ``sum_m log2(1 + p_m * g_m)``; p, g (B, M) -> (B,)."""
    return torch.log2(1.0 + p * g).sum(dim=1)


def nu_channel_gains(uav_xy: torch.Tensor, user_xy: torch.Tensor) -> torch.Tensor:
    """h_j = sqrt(rho0 / (H^2 + ||q_user_j - q_uav||^2)); uav_xy (B, 2),
    user_xy (B, 2K) interleaved [x1, y1, x2, y2, ...] -> (B, K)."""
    dx = user_xy[:, 0::2] - uav_xy[:, 0:1]
    dy = user_xy[:, 1::2] - uav_xy[:, 1:2]
    return torch.sqrt(NU_RHO_0 / (NU_UAV_H ** 2 + dx ** 2 + dy ** 2))


def nu_rate(Y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """NOMA sum rate with SIC decoding by descending channel gain.

    Y (B, 2+K) decoded [uav_x, uav_y, P_1..P_K]; X (B, 2K) user coordinates
    (both unnormalized) -> (B,). The strongest user has SINR
    ``P h^2 / sigma^2``; the user at SIC position k > 0 has
    ``P / (sum of the powers before it + sigma^2 / h^2)``.
    """
    P = Y[:, 2:]
    h = nu_channel_gains(Y[:, :2], X)
    order = torch.argsort(-h, dim=1, stable=True)
    h_sorted = torch.gather(h, 1, order)
    P_sorted = torch.gather(P, 1, order)
    interference = torch.cumsum(P_sorted, dim=1) - P_sorted   # exclusive prefix sum
    sinr_strong = P_sorted * h_sorted ** 2 / NU_SIGMA_SQ
    sinr_rest = P_sorted / (interference + NU_SIGMA_SQ / h_sorted ** 2)
    k_pos = torch.arange(P.shape[1], device=P.device)[None, :]
    sinr = torch.where(k_pos == 0, sinr_strong, sinr_rest)
    return torch.log2(1.0 + sinr).sum(dim=1)

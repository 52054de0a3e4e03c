"""The experimental loss zoo (``utils/loss_function.py`` in the reference).

Counterpart of ``diffsg_tpu/ops/losses.py``. The shipped CFG training path
uses none of them (it is epsilon-MSE); they record the earlier constrained
experiments: classification-augmented CO losses, a VAE loss, a Lagrangian
diffusion loss on the implied ``y_{t-1}`` and direct objective losses. All
are plain tensor code, differentiable under autograd.
"""

from __future__ import annotations

from typing import Sequence

import torch


def class_loss(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    """MSE + XOR decision-classification loss + sum constraint
    (``loss_function.py:4-19``)."""
    mse = torch.mean((y_true - y_pred) ** 2, dim=-1)
    true_d = (y_true >= 0.1).to(torch.int32)
    pred_d = (y_pred >= 0.1).to(torch.int32)
    cls = torch.sum(true_d ^ pred_d, dim=-1) * 0.01
    sum_constraint = (torch.sum(y_pred, dim=-1) - torch.sum(y_true, dim=-1)) ** 2
    return torch.sum(mse + cls + sum_constraint, dim=0)


def custom_loss(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """MSE + sum constraint (``loss_function.py:21-31``)."""
    mse = torch.mean((y_true - y_pred) ** 2, dim=-1)
    sum_constraint = (torch.sum(y_pred, dim=-1) - torch.sum(y_true, dim=-1)) ** 2
    return torch.sum(mse + sum_constraint)


def vae_loss(y, y_hat, mean, logvar, kld_weight: float) -> torch.Tensor:
    """Reconstruction + KLD (``loss_function.py:33-42``)."""
    rec = torch.mean((y_hat - y) ** 2)
    kld = torch.mean(-0.5 * torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar), dim=1))
    return rec + kld * kld_weight


def convention_co_opt_loss(y0: torch.Tensor, x0: torch.Tensor,
                           lambda0: float = 1.0) -> torch.Tensor:
    """Direct CO objective loss on standardized, softmaxed allocations with
    the exp(y - 0.1) soft decision (``loss_function.py:131-175``); the
    standard deviation is the unbiased one, as ``torch.std``'s."""
    y = 0.5 * (y0 - torch.mean(y0)) / torch.std(y0) + 0.5
    y = torch.softmax(y, dim=1)
    local = x0[:, 0::3]
    transition = x0[:, 1::3]
    execution = x0[:, 2::3]
    soft_d = torch.exp(y - 0.1)
    cost = torch.sum(soft_d * local + soft_d * (transition + execution / y), dim=1)
    return torch.sum(lambda0 * cost)


def sum_rate_loss(p0: torch.Tensor, g0: torch.Tensor, W: float = 10.0) -> torch.Tensor:
    """Constraint + no-zero + negative-rate loss (``loss_function.py:177-204``)."""
    p = (p0 - torch.min(p0)) / (torch.max(p0) - torch.min(p0)) * (W - 0.1) + 0.1
    constrain = (torch.sum(p, dim=1) - W) ** 2
    no_zero = torch.sum(1.0 / torch.exp(p))
    r = torch.sum(torch.log2(1.0 + p * g0[:, : p.shape[1]]), dim=1)
    return torch.sum(constrain) + no_zero + torch.sum(-r)


def diffusion_opt_loss(estimated_noise: torch.Tensor, noise: torch.Tensor, y_t: torch.Tensor,
                       x0: torch.Tensor, alphas: torch.Tensor, t: torch.Tensor,
                       lambdas: Sequence[float] = (0.001, 0.05, 0.05, 0.05, 0.1)
                       ) -> torch.Tensor:
    """Epsilon-MSE + a Lagrangian optimization loss on the implied y_{t-1}
    (``loss_function.py:44-129``), for the legacy 7-feature CO format
    ``[s, c, w, theta, f_l, h, alpha] x N + [F_t, kappa, P_t, P_I, B, N0]``.
    ``alphas`` (T,), ``t`` (B,) integers."""
    pre_loss = torch.mean((estimated_noise - noise) ** 2)

    acp = torch.cumprod(alphas, dim=0)
    a_t = acp[t][:, None]
    a_t1 = acp[torch.clamp(t - 1, min=0)][:, None]
    alpha_t = alphas[t][:, None]
    y_t1 = ((y_t - (1.0 - alpha_t) / torch.sqrt(1.0 - a_t1) * estimated_noise)
            / torch.sqrt(alpha_t) + (1.0 - a_t1) / (1.0 - a_t) * noise)

    F_t, kappa, P_t, P_I = x0[0, -6], x0[0, -5], x0[0, -4], x0[0, -3]
    B, N0 = x0[0, -2], x0[0, -1]
    feat = x0[:, :-6]
    s, c, w = feat[:, 0::7], feat[:, 1::7], feat[:, 2::7]
    theta, f_l, h, alpha = feat[:, 3::7], feat[:, 4::7], feat[:, 5::7], feat[:, 6::7]

    sinr = P_t * h ** 2 / (N0 + torch.sum(P_t * h ** 2))
    r_u = B * torch.log2(1 + sinr)
    beta = 1.0 - alpha

    def total_cost(y, D):
        tau = torch.where(D == 1, alpha * (s / r_u + c / (F_t * y) + w / r_u),
                          alpha * c / f_l)
        eps = torch.where(D == 1, beta * (P_t * s / r_u + P_I * c / (F_t * y) + P_t * w / r_u),
                          beta * kappa * f_l ** 2 * c)
        return torch.sum(tau + eps, dim=1)

    D_t = (y_t > 0.05).to(y_t.dtype)
    D_t1 = (y_t1 > 0.05).to(y_t.dtype)
    cost_diff = torch.clamp(total_cost(y_t1, D_t1) - total_cost(y_t, D_t), min=0.0)

    delays = torch.where(D_t1 == 1, s / r_u + c / (F_t * y_t1) + w / r_u, c / f_l)
    g2 = torch.sum(torch.clamp(delays - theta, min=0.0), dim=1)
    g3 = torch.sum(torch.clamp(y_t1 - 1.0, min=0.0), dim=1)
    g4 = torch.sum(torch.clamp(-y_t1, min=0.0), dim=1)
    g5 = torch.clamp(torch.sum(y_t1, dim=1) - 1.0, min=0.0)

    opt = (lambdas[0] * cost_diff + lambdas[1] * g2 + lambdas[2] * g3
           + lambdas[3] * g4 + lambdas[4] * g5)
    return 0.5 * torch.sum(pre_loss) + 0.5 * torch.sum(opt)

"""Gradient-descent baseline: the reference's hand-derived gradient
iterations, batched over rows.

Counterpart of ``diffsg_tpu/baselines/gd.py`` (reference ``baselines/GD.py``).
Each solver is a plain loop of tensor ops over a fixed iteration count, on
the device of its input; the whole batch moves together. Per task:

* CO (``GD.py:12-59``): the joint decision and allocation vector of size
  2N with its penalty terms, 100 steps of 0.1, then a min-max of the
  allocation block per row (the reference's post-hoc projection).
* MSR (``GD.py:62-97``): ascent on the powers with the barrier
  ``1 / (sum p - 1)^2``, 100 steps of 1e-3, then the residual spread
  equally so that every row sums to W.
* NU (``GD.py:100-157``): the hand-derived K = 3 gradient, 100 steps of
  0.1, the powers rescaled to sum P_sum. The reference feeds the
  loader-NORMALIZED coordinates (in [0, 1]) to a gradient whose UAV starts
  at (width/2, height/2) in metres; pass ``coords_norm`` so. Its two index
  slips are kept as well: the ``coords[:, 2i+1]`` term of ``gx`` and the
  ``d_total**2`` of both (``GD.py:107, 109``).
"""

from __future__ import annotations

import math

import torch

LOG2 = math.log(2.0)


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """Each row's sum as a left fold of its columns, (B, n) -> (B, 1): one
    order of additions on every device. The CO iteration amplifies a
    rounding difference to O(1) in its answer, so the card's answer equals
    the CPU's only if every op rounds alike."""
    acc = t[:, 0:1]
    for j in range(1, t.shape[1]):
        acc = acc + t[:, j:j + 1]
    return acc


def _co_gradient(x: torch.Tensor, y: torch.Tensor, node_num: int, lambda1: float,
                 lambda2: float) -> torch.Tensor:
    """Reference ``co_gradient`` (GD.py:12-21): y holds [D_1..D_N, R_1..R_N]."""
    D, R = y[:, :node_num], y[:, node_num:]
    local, transition, execution = x[:, 0::3], x[:, 1::3], x[:, 2::3]
    gD = -local + transition + execution / R + (1 - 2 * D) * lambda1
    gR = -execution / (R ** 2) * D + (_row_sum(R) * 2 - 1) * lambda2
    return torch.cat([gD, gR], dim=1)


@torch.no_grad()
def co_gd_solve(X_unnorm: torch.Tensor, node_num: int = 3, iterations: int = 100,
                step: float = 0.1, lambda1: float = 1.0, lambda2: float = 1.0) -> torch.Tensor:
    """CO features (B, 3N), unnormalized -> allocation shares (B, N),
    min-max normalized per row (GD.py:43-45)."""
    B = X_unnorm.shape[0]
    y = torch.ones((B, 2 * node_num), dtype=X_unnorm.dtype, device=X_unnorm.device)
    y[:, node_num:] = 1.0 / node_num
    for _ in range(iterations):
        y = y - step * _co_gradient(X_unnorm, y, node_num, lambda1, lambda2)
    R = y[:, node_num:]
    mn = R.min(dim=1, keepdim=True).values
    mx = R.max(dim=1, keepdim=True).values
    return (R - mn) / (mx - mn)


def _msr_gradient(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Reference ``msr_gradient`` (GD.py:62-70)."""
    barrier = 1.0 / ((_row_sum(p) - 1.0) ** 2)
    return g / ((g * p + 1.0) * LOG2) - barrier


@torch.no_grad()
def msr_gd_solve(g_unnorm: torch.Tensor, W: float, iterations: int = 100,
                 step: float = 1e-3) -> torch.Tensor:
    """Gains (B, M), unnormalized -> powers (B, M): gradient ascent, then the
    residual redistribution to sum exactly W (GD.py:72-87)."""
    M = g_unnorm.shape[1]
    p = torch.full_like(g_unnorm, W / M)
    for _ in range(iterations):
        p = p + step * _msr_gradient(g_unnorm, p)
    return p + (W - _row_sum(p)) / M


def _nu_gradient(y: torch.Tensor, coords: torch.Tensor, P_sum: float) -> torch.Tensor:
    """Reference ``nu_gradient`` (GD.py:100-117), K = 3 hard-coded as there
    (the distance terms d1, d2, d3 and 22500 = H^2)."""
    d_sq = [(y[:, 0] - coords[:, 2 * i]) ** 2 + (y[:, 1] - coords[:, 2 * i + 1]) ** 2
            for i in range(3)]
    d_total = d_sq[0] + d_sq[1] + d_sq[2]
    barrier = 1 / ((_row_sum(y[:, 2:])[:, 0] - P_sum) ** 2)
    gx = torch.zeros_like(y[:, 0])
    gy = torch.zeros_like(y[:, 1])
    gp = []
    for i in range(3):
        tmp = 6 + 11 / 6 * (22500 + d_sq[i])
        common = y[:, 2 + i] * 11 / 3 / (tmp ** 2) / (1 + y[:, 2 + i] / tmp) / LOG2
        gx = gx - common * (y[:, 0] - coords[:, 2 * i]) \
            + 2 * (coords[:, 2 * i + 1] - y[:, 0]) / (d_total ** 2)
        gy = gy - common * (y[:, 1] - coords[:, 2 * i + 1]) \
            + 2 * (coords[:, 2 * i + 1] - y[:, 1]) / (d_total ** 2)
        gp.append(-1 / tmp / (1 + y[:, 2 + i] / tmp) / LOG2 + barrier)
    return torch.stack([gx, gy] + gp, dim=1)


@torch.no_grad()
def nu_gd_solve(coords_norm: torch.Tensor, P_sum: float = 18.0, width: float = 400.0,
                height: float = 400.0, iterations: int = 100, step: float = 0.1) -> torch.Tensor:
    """Loader-normalized user coordinates (B, 6), as the reference passes
    them (GD.py:123, 131) -> (B, 5) [uav_x, uav_y, P1..P3], the powers
    rescaled to sum P_sum (GD.py:120-145)."""
    B, K = coords_norm.shape[0], 3
    y = torch.full((B, 2 + K), P_sum / K - 0.01, dtype=coords_norm.dtype,
                   device=coords_norm.device)
    y[:, 0] = width / 2
    y[:, 1] = height / 2
    for _ in range(iterations):
        y = y + step * _nu_gradient(y, coords_norm, P_sum)
    P = y[:, 2:]
    P = P / _row_sum(P) * P_sum
    return torch.cat([y[:, :2], P], dim=1)

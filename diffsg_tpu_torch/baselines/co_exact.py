"""Exact continuous CO oracle and the decodes built on its closed form.

Counterpart of ``diffsg_tpu/baselines/co_exact.py``. For a fixed offload
decision D, the CO cost ``sum_i (1-D_i) local_i + D_i (trans_i + exec_i /
y_i)`` subject to ``sum_{i in D} y_i = 1, y >= 0`` is least at
``y_i = sqrt(exec_i) / sum_{j in D} sqrt(exec_j)``. Enumerating the 2^N
decisions with that allocation gives the exact continuous optimum
(:func:`co_exact_solve`), the yardstick CO solutions are scored against.

The decodes keep the sampler's discrete decision (or its ranking of the
nodes) and take the continuous allocation from the closed form. All are
strictly per row, so bucket padding cannot move a real row, and none copies
data from the host, so they can be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from ..ops.decoders import _by_column, co_decode


def co_optimal_allocation(execution: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Closed-form optimal shares for decision D; execution, D (B, N)."""
    w = torch.sqrt(execution) * D
    denom = w.sum(dim=1, keepdim=True)
    return torch.where(D > 0, w / torch.clamp(denom, min=1e-30), torch.zeros_like(w))


def _decision_cost(local, trans, execution, D, Y):
    return ((1 - D) * local + D * (trans + execution / torch.clamp(Y, min=1e-30))).sum(dim=1)


def co_exact_solve(X_unnorm: torch.Tensor) -> torch.Tensor:
    """Exact continuous optimum over all 2^N decisions; X (B, 3N) derived
    features -> optimal shares (B, N), a zeros row where all-local wins."""
    B, N = X_unnorm.shape[0], X_unnorm.shape[1] // 3
    local, trans, execution = X_unnorm[:, 0::3], X_unnorm[:, 1::3], X_unnorm[:, 2::3]
    best_cost = local.sum(dim=1)                       # decision 0: all local
    best_Y = torch.zeros((B, N), dtype=X_unnorm.dtype, device=X_unnorm.device)
    ones = torch.ones((B, 1), dtype=X_unnorm.dtype, device=X_unnorm.device)
    for did in range(1, 2 ** N):
        D = torch.cat([ones * float((did >> j) & 1) for j in range(N)], dim=1)
        Y = co_optimal_allocation(execution, D)
        cost = _decision_cost(local, trans, execution, D, Y)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_Y = torch.where(better[:, None], Y, best_Y)
    return best_Y


def co_soft_cost(Y_raw: torch.Tensor, X_unnorm: torch.Tensor, tau: float = 0.05,
                 threshold: float = 0.1, logit_temp: float = 3.0) -> torch.Tensor:
    """Differentiable relaxation of the CO cost at the analytic optimum,
    for objective guidance (``cfg_sample(guidance_fn=...)``) -> (B,).

    With the closed-form allocation the cost of decision D collapses to
    ``sum_i (1-D_i) local_i + D_i trans_i + S**2``, ``S = sum_j D_j
    sqrt(exec_j)``; D is relaxed to ``sigmoid((softmax(z) - threshold) /
    tau)`` over the row's logits standardized to ``logit_temp`` scale
    (``std`` with ddof 0, as ``jnp.std``), so the relaxation reads the
    row's ordering at any raw scale.
    """
    z = Y_raw - Y_raw.mean(dim=1, keepdim=True)
    z = z / (z.std(dim=1, keepdim=True, unbiased=False) + 1e-6) * logit_temp
    D = torch.sigmoid((torch.softmax(z, dim=1) - threshold) / tau)
    local, trans, execution = X_unnorm[:, 0::3], X_unnorm[:, 1::3], X_unnorm[:, 2::3]
    S = (D * torch.sqrt(execution)).sum(dim=1)
    return ((1.0 - D) * local + D * trans).sum(dim=1) + S ** 2


def co_ranked_decode(Y_raw: torch.Tensor, X_unnorm: torch.Tensor) -> torch.Tensor:
    """Ranked-decision decode: the row's node ordering (descending, ties in
    index order, as JAX's stable ``argsort``) selects among the N+1 nested
    top-k offload sets; each is costed with the closed-form allocation and
    the cheapest wins (k = 0, all local, a zeros row)."""
    n = Y_raw.shape[1]
    order = torch.argsort(-Y_raw, dim=1, stable=True)
    local, trans, execution = X_unnorm[:, 0::3], X_unnorm[:, 1::3], X_unnorm[:, 2::3]
    best_cost = local.sum(dim=1)
    best_Y = torch.zeros_like(Y_raw)
    for k in range(1, n + 1):
        D = torch.zeros_like(Y_raw).scatter(1, order[:, :k], 1.0)
        Y = co_optimal_allocation(execution, D)
        cost = _decision_cost(local, trans, execution, D, Y)
        better = cost < best_cost
        best_cost = torch.where(better, cost, best_cost)
        best_Y = torch.where(better[:, None], Y, best_Y)
    return best_Y


def co_direct_decode(Y_raw: torch.Tensor, X_unnorm: torch.Tensor, y_scale: float = 1.0,
                     y_shift: Union[float, Sequence[float]] = 0.0,
                     threshold: float = 0.1) -> torch.Tensor:
    """Decision read off the unscaled sample (training targets were
    ``y_scale * (shares - y_shift)``, ``y_shift`` scalar or (N,)), allocation
    from the closed form; an all-local decision gives the zeros row."""
    shift = np.broadcast_to(np.asarray(y_shift, np.float32), (Y_raw.shape[1],))
    yd = _by_column(Y_raw / y_scale, torch.add, shift)
    D = (yd > threshold).to(Y_raw.dtype)
    return co_optimal_allocation(X_unnorm[:, 2::3], D)


def co_analytic_decode(Y_raw: torch.Tensor, X_unnorm: torch.Tensor,
                       threshold: float = 0.1) -> torch.Tensor:
    """Decision from the softmax decode (``co_decode > threshold``),
    allocation from the closed form; rows ``co_decode`` sends all-local
    stay zeros."""
    dec = co_decode(Y_raw)
    D = (dec > threshold).to(Y_raw.dtype)
    Y = co_optimal_allocation(X_unnorm[:, 2::3], D)
    all_local = (dec == 0.0).all(dim=1, keepdim=True)
    return torch.where(all_local, torch.zeros_like(Y), Y)

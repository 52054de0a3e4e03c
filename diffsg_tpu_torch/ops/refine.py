"""Projected-gradient solution refinement: diffusion plus local search.

Counterpart of ``diffsg_tpu/ops/refine.py``. The decoded sampler output
seeds ``iters`` steps of projected gradient ascent (or descent) on the
exact task objective, each step followed by the task's Euclidean
feasibility projection:

* each row's step is its gradient normalized to unit L2 length (in the
  ``precond`` metric where given), so one step size serves objectives whose
  gradients differ by orders of magnitude;
* each row keeps its own step length: an improving step is accepted and
  grows it by ``grow``, a failed one is rejected (the row stays) and
  shrinks it by ``shrink``;
* only improving steps are taken, so the result is never worse than the
  projected input under the objective.

``iters`` is a Python loop and every decision is a ``torch.where``: the
refinement never synchronizes with the host and copies nothing from it, so
it can run inside a captured CUDA graph, after the decode.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .decoders import _by_column

Precond = Union[None, Sequence[float], np.ndarray, torch.Tensor]


def _scaler(precond: Precond, Y: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """``g -> precond * g``. A tensor (D,) or (B, D) multiplies as it is; a
    host (D,) vector multiplies column by column as Python numbers, so that
    nothing is copied from the host."""
    if isinstance(precond, torch.Tensor):
        if precond.device != Y.device:
            raise ValueError(f"precond is on {precond.device}, the solutions on {Y.device}")
        s = precond.to(Y.dtype)
        s = s[None, :] if s.dim() == 1 else s
        return lambda g: s * g
    values = np.asarray(precond, np.float64).reshape(-1).tolist()
    if len(values) != Y.shape[1]:
        raise ValueError(f"precond has {len(values)} entries for {Y.shape[1]} columns")
    return lambda g: _by_column(g, torch.mul, values)


def projected_refine(
    objective_fn: Callable[[torch.Tensor], torch.Tensor],
    project_fn: Callable[[torch.Tensor], torch.Tensor],
    Y0: torch.Tensor,
    iters: int,
    step: float,
    grow: float = 1.3,
    shrink: float = 0.5,
    higher_is_better: bool = True,
    precond: Precond = None,
) -> torch.Tensor:
    """Refine feasible solutions ``Y0`` (B, D) by projected gradient steps.

    ``objective_fn(Y) -> (B,)`` is row-separable, so the gradient of its sum
    is the batch of per-row gradients; ``project_fn`` is the Euclidean
    projection onto the feasible set. ``step`` is each row's first step
    length. ``precond`` (D,) or (B, D) takes the step in ``z = Y / precond``
    coordinates (normalized there, mapped back), for solution vectors that
    mix units; None is plain L2.

    Returns the best post-projection iterate per row. The objective's
    inputs must be tensors autograd can record (not inference tensors):
    ``tasks.base.refine_solutions`` takes care of that.
    """
    if iters <= 0:
        return Y0
    sign = 1.0 if higher_is_better else -1.0
    scale = None if precond is None else _scaler(precond, Y0)

    def grad_fn(Y: torch.Tensor) -> torch.Tensor:
        with torch.enable_grad():
            Yg = Y.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(objective_fn(Yg).sum(), Yg)
        return g

    with torch.no_grad():
        Y = project_fn(Y0)
        s = objective_fn(Y)
        st = torch.full((Y.shape[0], 1), step, dtype=Y.dtype, device=Y.device)
        for _ in range(iters):
            g = grad_fn(Y)
            if scale is None:
                d = g / (torch.linalg.norm(g, dim=1, keepdim=True) + 1e-12)
            else:
                gz = scale(g)                                     # the gradient in z
                d = scale(gz) / (torch.linalg.norm(gz, dim=1, keepdim=True) + 1e-12)
            Y_try = project_fn(Y + sign * st * d)
            s_try = objective_fn(Y_try)
            ok = s_try > s if higher_is_better else s_try < s
            Y = torch.where(ok[:, None], Y_try, Y)
            s = torch.where(ok, s_try, s)
            st = torch.where(ok[:, None], st * grow, st * shrink)
    return Y


def random_starts(starts: Union[int, torch.Tensor], project_fn: Callable[[torch.Tensor],
                  torch.Tensor], box: torch.Tensor, shape: Sequence[int], seed: int,
                  device: torch.device) -> list:
    """Feasible random starts for solutions whose first two columns are a
    position in ``box`` ((2,) or (B, 2)): unit-uniform draws of ``shape``
    (B, D), the position scaled to the box, each start projected. ``starts``
    is their number, drawn one after another from a ``torch.Generator``
    seeded by ``seed`` on ``device``, or the unit draws themselves, a tensor
    (n, B, D)."""
    if isinstance(starts, torch.Tensor):
        units = [u.to(device=device, dtype=torch.float32) for u in starts]
    else:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        units = [torch.rand(tuple(shape), generator=gen, device=device) for _ in range(starts)]
    return [project_fn(torch.cat([u[:, :2] * box, u[:, 2:]], dim=1)) for u in units]


def best_of_starts(refine_fn: Callable[[torch.Tensor], torch.Tensor],
                   objective_fn: Callable[[torch.Tensor], torch.Tensor], starts: Sequence,
                   best: torch.Tensor):
    """Per row, the highest-``objective_fn`` of ``best`` and each start
    refined by ``refine_fn``, in order (a later start replaces the best
    only where it is strictly higher). Returns (Y, objective)."""
    best_r = objective_fn(best)
    for Y0 in starts:
        Yi = refine_fn(Y0)
        ri = objective_fn(Yi)
        take = ri > best_r
        best = torch.where(take[:, None], Yi, best)
        best_r = torch.where(take, ri, best_r)
    return best, best_r

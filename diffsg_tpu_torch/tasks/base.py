"""The task interface as the serving path sees it.

Counterpart of the part of ``diffsg_tpu/tasks/base.py`` that serving reads:
``Task``, ``refine_solutions`` and ``select_best``. ``tasks.msr``,
``tasks.co`` and ``tasks.nu`` provide the instances.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.unet1d import UNet1D
from ..ops.refine import projected_refine


@dataclasses.dataclass(frozen=True)
class Task:
    """One network-optimization problem.

    ``decode(Y_raw, config, valid_mask=None)``: raw sampler output ->
    feasible solutions. ``objective(Y_dec, X_unnorm, config)``: per-sample
    objective. ``unnormalize_x`` / ``unnormalize_y``: loader-scaled
    conditions / labels -> physical units. ``higher_is_better``: rate
    maximization (MSR, NU) or cost minimization. ``decode_with_x(Y_raw,
    X_unnorm, config, valid_mask=None)``: an optional decoder that also sees
    the unnormalized conditions; where given, the sampling paths use it in
    place of ``decode``.

    ``extra_metrics(Y_dec, Y_true, pred, true, config)``: optional
    task-specific metrics (numpy in, floats out). ``project(Y_dec,
    X_unnorm, config)``: an optional Euclidean feasibility projection in
    physical units (the identity on feasible points); where given,
    :func:`refine_solutions` can polish the decoded solutions, with a first
    step of ``refine_step`` and per-column step scales
    ``refine_precond(config)`` (D,) where given. CO leaves ``project``
    unset: given the decision, its allocation is already the closed-form
    optimum.
    """

    name: str
    build_model: Callable[[Dict], UNet1D]
    decode: Callable[..., torch.Tensor]
    objective: Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]
    unnormalize_x: Callable[[np.ndarray, Dict], np.ndarray]
    unnormalize_y: Callable[[np.ndarray, Dict], np.ndarray]
    data_dim: Callable[[Dict], int]
    cond_dim: Callable[[Dict], int]
    higher_is_better: bool = True
    default_omega: float = 500.0
    decode_with_x: Optional[Callable[..., torch.Tensor]] = None
    extra_metrics: Optional[Callable[..., Dict[str, float]]] = None
    project: Optional[Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]] = None
    refine_step: float = 0.1
    refine_precond: Optional[Callable[[Dict], np.ndarray]] = None


def refine_solutions(task: Task, Y_dec: torch.Tensor, X_unnorm: torch.Tensor, config: Dict,
                     iters: int, step: Optional[float] = None) -> torch.Tensor:
    """Polish decoded solutions with ``iters`` projected-gradient steps on
    the exact task objective (``ops.refine.projected_refine``); ``step``
    defaults to the task's ``refine_step``. Strictly per row, with no host
    synchronization: it can be captured in a CUDA graph. Raises ValueError
    for a task without a feasibility projection (CO)."""
    if task.project is None:
        raise ValueError(
            f"task {task.name!r} has no feasibility projection; projected-gradient "
            "refinement is unsupported (CO's continuous allocation is already "
            "closed-form optimal given the decision)")
    precond = None if task.refine_precond is None else task.refine_precond(config)
    # Outside inference mode, on copies: autograd must be able to record
    # the objective, and it cannot save inference tensors.
    with torch.inference_mode(False):
        Y, X = Y_dec.clone(), X_unnorm.clone()
        return projected_refine(
            lambda y: task.objective(y, X, config), lambda y: task.project(y, X, config),
            Y, iters, task.refine_step if step is None else step,
            higher_is_better=task.higher_is_better, precond=precond)


def select_best(decs: torch.Tensor, scores: torch.Tensor, higher_is_better: bool) -> torch.Tensor:
    """Pick the best candidate per sample: decs (n, B, D), scores (n, B) ->
    (B, D). Ties go to the first candidate, as ``argmax`` / ``argmin`` do."""
    pick = torch.argmax(scores, dim=0) if higher_is_better else torch.argmin(scores, dim=0)
    index = pick[None, :, None].expand(1, *decs.shape[1:])
    return torch.gather(decs, 0, index)[0]

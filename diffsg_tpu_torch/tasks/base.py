"""The task interface as the serving path sees it.

Counterpart of the part of ``diffsg_tpu/tasks/base.py`` that serving reads:
``Task`` and ``select_best``. ``tasks.msr`` and ``tasks.nu`` provide the
instances.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.unet1d import UNet1D


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


def select_best(decs: torch.Tensor, scores: torch.Tensor, higher_is_better: bool) -> torch.Tensor:
    """Pick the best candidate per sample: decs (n, B, D), scores (n, B) ->
    (B, D). Ties go to the first candidate, as ``argmax`` / ``argmin`` do."""
    pick = torch.argmax(scores, dim=0) if higher_is_better else torch.argmin(scores, dim=0)
    index = pick[None, :, None].expand(1, *decs.shape[1:])
    return torch.gather(decs, 0, index)[0]

"""The task interface as the serving path sees it.

Counterpart of the part of ``diffsg_tpu/tasks/base.py::Task`` that serving
reads; ``tasks.msr`` and ``tasks.nu`` provide the instances.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..models.unet1d import UNet1D


@dataclasses.dataclass(frozen=True)
class Task:
    """One network-optimization problem.

    ``decode(Y_raw, config, valid_mask=None)``: raw sampler output ->
    feasible solutions. ``objective(Y_dec, X_unnorm, config)``: per-sample
    objective. ``unnormalize_x``: loader-scaled conditions -> physical units.
    ``higher_is_better``: rate maximization (MSR, NU) or cost minimization.
    """

    name: str
    build_model: Callable[[Dict], UNet1D]
    decode: Callable[..., torch.Tensor]
    objective: Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]
    unnormalize_x: Callable[[np.ndarray, Dict], np.ndarray]
    data_dim: Callable[[Dict], int]
    cond_dim: Callable[[Dict], int]
    higher_is_better: bool = True
    default_omega: float = 500.0

"""MSR task: Maximum Sum Rate power allocation over M channels.

Counterpart of ``diffsg_tpu/tasks/msr.py`` (the ``msr`` task) with the part
of ``tasks/base.py::Task`` that serving reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from ..models.unet1d import UNet1D, unet_msr
from ..ops.decoders import msr_decode
from ..ops.objectives import msr_sum_rate


@dataclasses.dataclass(frozen=True)
class Task:
    """One network-optimization problem as the serving path sees it.

    ``decode(Y_raw, config, valid_mask=None)``: raw sampler output ->
    feasible solutions. ``objective(Y_dec, X_unnorm, config)``: per-sample
    objective. ``unnormalize_x``: loader-scaled conditions -> physical units.
    """

    name: str
    build_model: Callable[[Dict], UNet1D]
    decode: Callable[..., torch.Tensor]
    objective: Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]
    unnormalize_x: Callable[[np.ndarray, Dict], np.ndarray]
    data_dim: Callable[[Dict], int]
    default_omega: float = 500.0


def _decode(Y_raw, config, valid_mask=None):
    return config["W"] * msr_decode(Y_raw, valid_mask)


def _objective(Y_dec, X_unnorm, config):
    return msr_sum_rate(Y_dec, X_unnorm)


def _unnorm_x(X, config):
    mn, mx = config["scaler_min"], config["scaler_max"]
    return X * (mx - mn) + mn


def _build_model(cfg):
    return unet_msr(cfg["M"], cfg.get("proj_dim", 128),
                    tuple(cfg.get("dims", (64, 32, 16, 8))))


MSR = Task(
    name="msr",
    build_model=_build_model,
    decode=_decode,
    objective=_objective,
    unnormalize_x=_unnorm_x,
    data_dim=lambda cfg: cfg["M"],
    default_omega=500.0,
)

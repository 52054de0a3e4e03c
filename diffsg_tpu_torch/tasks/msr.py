"""MSR task: Maximum Sum Rate power allocation over M channels.

Counterpart of ``diffsg_tpu/tasks/msr.py`` (the ``msr`` task). ``Task``
lives in ``tasks/base.py`` and is re-exported here.
"""

from __future__ import annotations

from ..models.unet1d import unet_msr
from ..ops.decoders import msr_decode
from ..ops.objectives import msr_sum_rate
from .base import Task

__all__ = ["MSR", "Task"]


def _decode(Y_raw, config, valid_mask=None):
    return config["W"] * msr_decode(Y_raw, valid_mask)


def _objective(Y_dec, X_unnorm, config):
    return msr_sum_rate(Y_dec, X_unnorm)


def _unnorm_x(X, config):
    mn, mx = config["scaler_min"], config["scaler_max"]
    return X * (mx - mn) + mn


def _unnorm_y(Y, config):
    return Y  # MSR labels are stored unscaled


def _build_model(cfg):
    return unet_msr(cfg["M"], cfg.get("proj_dim", 128),
                    tuple(cfg.get("dims", (64, 32, 16, 8))))


MSR = Task(
    name="msr",
    build_model=_build_model,
    decode=_decode,
    objective=_objective,
    unnormalize_x=_unnorm_x,
    unnormalize_y=_unnorm_y,
    data_dim=lambda cfg: cfg["M"],
    cond_dim=lambda cfg: cfg["M"],
    higher_is_better=True,
    default_omega=500.0,
)

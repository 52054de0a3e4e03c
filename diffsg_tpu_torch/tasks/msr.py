"""MSR task: Maximum Sum Rate power allocation over M channels.

Counterpart of ``diffsg_tpu/tasks/msr.py`` (``msr``, ``msr_temp``,
``msr_wf``, ``msr_budget``). ``Task`` lives in ``tasks/base.py`` and is
re-exported here. The variants are ``dataclasses.replace`` of ``MSR``, so
they inherit its feasibility projection and ``refine_step``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..data.loaders import load_msr, load_msr_budget
from ..models.unet1d import unet_msr
from ..ops.decoders import masked_min_max, msr_decode, msr_simplex_project
from ..ops.objectives import msr_sum_rate
from ..train.trainer import TrainConfig
from .base import Task, select_best

__all__ = ["MSR", "MSR_BUDGET", "MSR_TEMP", "MSR_WF", "Task"]

#: Softmax temperatures of ``msr_temp``; t = 1 is the reference decoder.
MSR_DECODE_TEMPS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0)
#: Scales of ``msr_wf``'s simplex-projection candidates.
MSR_PROJ_SCALES = (0.75, 1.0, 1.5, 2.0, 3.0)


def _decode(Y_raw, config, valid_mask=None):
    return config["W"] * msr_decode(Y_raw, valid_mask)


def _objective(Y_dec, X_unnorm, config):
    return msr_sum_rate(Y_dec, X_unnorm)


def _unnorm_x(X, config):
    mn, mx = config["scaler_min"], config["scaler_max"]
    return X * (mx - mn) + mn


def _unnorm_y(Y, config):
    return Y  # MSR labels are stored unscaled


def _decode_temp_selected(Y_raw, X_unnorm, config, valid_mask=None):
    """Decode at every temperature of ``MSR_DECODE_TEMPS`` (the batch-global
    min-max, over the valid rows under buckets, then a per-row softmax of
    ``t * Y``) and keep each row's best rate; ties go to the lower
    temperature. Counts its candidate rows in ``obs``'s
    ``decode_candidates``."""
    W = config["W"]
    obs.count("decode_candidates", len(MSR_DECODE_TEMPS) * Y_raw.shape[0], Y_raw)
    mn, mx = masked_min_max(Y_raw, valid_mask)
    Yn = (Y_raw - mn) / (mx - mn)
    ps = torch.stack([W * torch.softmax(t * Yn, dim=1) for t in MSR_DECODE_TEMPS])
    rates = torch.stack([msr_sum_rate(p, X_unnorm) for p in ps])
    return select_best(ps, rates, True)


def _decode_proj_selected(Y_raw, X_unnorm, config, valid_mask=None):
    """The simplex projections ``proj(a * Y / y_scale)`` over the scales of
    ``MSR_PROJ_SCALES`` and the temperature family; each row keeps its best
    rate (the projection where it is strictly better). For
    waterfilling-labeled, scale-normalized checkpoints: at a = 1 the
    projection is the identity on feasible labels."""
    W = config["W"]
    y_scale = config.get("y_scale", 1.0)
    obs.count("decode_candidates", len(MSR_PROJ_SCALES) * Y_raw.shape[0], Y_raw)
    ps = torch.stack([msr_simplex_project(a * Y_raw / y_scale, W) for a in MSR_PROJ_SCALES])
    rates = torch.stack([msr_sum_rate(p, X_unnorm) for p in ps])
    proj, r_proj = select_best(ps, rates, True), rates.max(dim=0).values
    soft = _decode_temp_selected(Y_raw, X_unnorm, config, valid_mask)
    r_soft = msr_sum_rate(soft, X_unnorm)
    return torch.where((r_proj > r_soft)[:, None], proj, soft)


def _project(Y_dec, X_unnorm, config):
    """Powers onto {p >= 0, sum p = W}: the sum rate is concave there, so
    projected ascent converges toward waterfilling."""
    return msr_simplex_project(Y_dec, config["W"])


def _project_budget(Y_dec, X_unnorm, config):
    # Each row's own budget, from the unnormalized condition's column M.
    M = config["M"]
    return msr_simplex_project(Y_dec, X_unnorm[:, M:M + 1])


def _build_model(cfg):
    return unet_msr(cfg["M"], cfg.get("proj_dim", 128),
                    tuple(cfg.get("dims", (64, 32, 16, 8))))


MSR = Task(
    name="msr",
    build_model=_build_model,
    load=load_msr,
    decode=_decode,
    objective=_objective,
    unnormalize_x=_unnorm_x,
    unnormalize_y=_unnorm_y,
    data_dim=lambda cfg: cfg["M"],
    cond_dim=lambda cfg: cfg["M"],
    train_config=TrainConfig(epochs=200, lr=5e-3, milestones=(100, 150)),
    higher_is_better=True,
    default_omega=500.0,
    project=_project,
    refine_step=0.25,
)

#: MSR with the temperature-selected decode.
MSR_TEMP = dataclasses.replace(MSR, name="msr_temp", decode_with_x=_decode_temp_selected)

#: MSR with the projection and temperature families, for
#: waterfilling-labeled checkpoints.
MSR_WF = dataclasses.replace(MSR, name="msr_wf", decode_with_x=_decode_proj_selected)


def _unnorm_x_budget(X, config):
    X = np.array(X, dtype=float)
    M = config["M"]
    mn, mx = config["scaler_min"], config["scaler_max"]
    X[:, :M] = X[:, :M] * (mx - mn) + mn
    X[:, M] *= config.get("w_ref", 10.0)  # budget feature -> watts
    return X


def _objective_budget(Y_dec, X_unnorm, config):
    # The trailing W column is conditioning only; the rate sees the gains.
    return msr_sum_rate(Y_dec, X_unnorm[:, :config["M"]])


def _decode_wf_budget(Y_raw, X_unnorm, config, valid_mask=None):
    return _decode_proj_selected(Y_raw, X_unnorm[:, :config["M"]], config, valid_mask)


#: MSR conditioned on the power budget (condition column ``W / w_ref``):
#: one model for any budget. The decode projects onto ``config["W"]``, as
#: the JAX package's does; refinement projects each row onto its own budget.
MSR_BUDGET = dataclasses.replace(
    MSR, name="msr_budget",
    build_model=lambda cfg: unet_msr(cfg["M"], cfg.get("proj_dim", 128),
                                     tuple(cfg.get("dims", (64, 32, 16, 8))), cond_extra=1),
    load=load_msr_budget,
    decode_with_x=_decode_wf_budget,
    objective=_objective_budget,
    unnormalize_x=_unnorm_x_budget,
    cond_dim=lambda cfg: cfg["M"] + 1,
    default_omega=1.0,
    project=_project_budget,
)

"""NU task: NOMA-UAV placement and power allocation over K users.

Counterpart of ``diffsg_tpu/tasks/nu.py`` (``nu``, ``nu_direct``,
``nu_budget``, ``nu_geo``). A solution is (uav_x, uav_y, P_1..P_K); the
condition is the K users' interleaved coordinates, loader-scaled to [0, 1],
followed by the budget ``P / p_ref`` (``nu_budget``) or by the budget and
the field's geometry ``W / w_ref, H / h_ref`` (``nu_geo``). The
unnormalizations are numpy, on the host, before the sampling program.

Per-row budgets and boxes are read from the unnormalized condition, a
device tensor of the program; the constant ones are applied as Python
numbers, so no task function copies data from the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.loaders import load_nu, load_nu_budget, load_nu_geo
from ..models.unet1d import unet_nu
from ..ops.decoders import _by_column, msr_simplex_project, nu_decode, nu_direct_decode
from ..ops.objectives import nu_rate
from ..train.trainer import TrainConfig
from .base import Task


def _decode(Y_raw, config, valid_mask=None):
    return nu_decode(Y_raw, config["width"], config["height"], config["P_sum"], valid_mask)


def _decode_direct(Y_raw, config, valid_mask=None):
    # Strictly per row: padding rows cannot shift real ones, no mask needed.
    return nu_direct_decode(Y_raw, config["width"], config["height"], config["P_sum"],
                            config.get("y_scale", 1.0),
                            np.asarray(config.get("y_shift", 0.0), np.float32))


def _objective(Y_dec, X_unnorm, config):
    return nu_rate(Y_dec, X_unnorm)


def _unnorm_x(X, config):
    X = np.array(X, dtype=float)
    X[:, 0::2] *= config["width"]
    X[:, 1::2] *= config["height"]
    return X


def _unnorm_y(Y, config):
    Y = np.array(Y, dtype=float)
    Y[:, 0] *= config["width"]
    Y[:, 1] *= config["height"]
    Y[:, 2:] *= config["P_sum"]
    return Y


def _clip_to_area(xy, config):
    return _by_column(torch.clamp(xy, min=0.0), torch.clamp_max,
                      (config["width"], config["height"]))


def _project(Y_dec, X_unnorm, config):
    """UAV position clipped into the area, powers projected onto
    {p >= 0, sum p = P_sum}."""
    P = msr_simplex_project(Y_dec[:, 2:], config["P_sum"])
    return torch.cat([_clip_to_area(Y_dec[:, :2], config), P], dim=1)


def _refine_precond(config):
    """Step scales for the mixed-units solution: coordinates move about 2%
    of the area per unit step, powers about 2% of the budget (the reference
    budget ``p_ref`` where ``P_sum`` is per row)."""
    p = config.get("P_sum") or config.get("p_ref", 18.0)
    return np.asarray([config["width"] * 0.02, config["height"] * 0.02]
                      + [p * 0.02] * config["K"], np.float32)


def _project_budget(Y_dec, X_unnorm, config):
    """``nu_budget``: each row's powers onto its own simplex, of the budget
    in the unnormalized condition's column 2K (mW)."""
    K = config["K"]
    P = msr_simplex_project(Y_dec[:, 2:], X_unnorm[:, 2 * K:2 * K + 1])
    return torch.cat([_clip_to_area(Y_dec[:, :2], config), P], dim=1)


NU = Task(
    name="nu",
    build_model=lambda cfg: unet_nu(cfg["K"]),
    load=load_nu,
    decode=_decode,
    objective=_objective,
    unnormalize_x=_unnorm_x,
    unnormalize_y=_unnorm_y,
    data_dim=lambda cfg: 2 + cfg["K"],
    cond_dim=lambda cfg: 2 * cfg["K"],
    train_config=TrainConfig(epochs=200, lr=4e-3, milestones=(80, 200)),
    higher_is_better=True,
    default_omega=500.0,
    project=_project,
    refine_step=1.0,
    refine_precond=_refine_precond,
)

#: NU with the per-row decode of scale-normalized (``y_scale``/``y_shift``)
#: checkpoints, served at small omega.
NU_DIRECT = dataclasses.replace(NU, name="nu_direct", decode=_decode_direct,
                                default_omega=1.0)


def _unnorm_x_budget(X, config):
    X = np.array(X, dtype=float)
    K = config["K"]
    X[:, 0:2 * K:2] *= config["width"]
    X[:, 1:2 * K:2] *= config["height"]
    X[:, 2 * K] *= config.get("p_ref", 18.0)  # budget feature -> mW
    return X


def _objective_budget(Y_dec, X_unnorm, config):
    # The trailing budget column is conditioning only; the rate sees coords.
    return nu_rate(Y_dec, X_unnorm[:, :2 * config["K"]])


#: NU conditioned on the power budget (condition column ``P_sum / p_ref``):
#: one model for any budget. It decodes with ``nu_direct``'s per-row decode
#: onto ``config["P_sum"]``, as the JAX package does; refinement projects
#: each row onto its own budget.
NU_BUDGET = dataclasses.replace(
    NU, name="nu_budget",
    build_model=lambda cfg: unet_nu(cfg["K"], cond_extra=1),
    load=load_nu_budget,
    decode=_decode_direct,
    objective=_objective_budget,
    unnormalize_x=_unnorm_x_budget,
    cond_dim=lambda cfg: 2 * cfg["K"] + 1,
    default_omega=0.125,
    project=_project_budget,
)


def _unnorm_x_geo(X, config):
    """Condition layout [qx / W_row, qy / H_row interleaved (2K), P / p_ref,
    W / w_ref, H / h_ref]: the trailing physical features first, then the
    coordinates by the row's own geometry."""
    X = np.array(X, dtype=float)
    K = config["K"]
    P = X[:, 2 * K] * config.get("p_ref", 18.0)
    W = X[:, 2 * K + 1] * config.get("w_ref", 400.0)
    H = X[:, 2 * K + 2] * config.get("h_ref", 400.0)
    X[:, 0:2 * K:2] *= W[:, None]
    X[:, 1:2 * K:2] *= H[:, None]
    X[:, 2 * K], X[:, 2 * K + 1], X[:, 2 * K + 2] = P, W, H
    return X


def _decode_geo(Y_raw, X_unnorm, config, valid_mask=None):
    """Strictly per-row decode with the row's own budget and geometry (from
    the unnormalized condition): invert the training scale and shift, clip
    the UAV into the row's W x H box, project the powers onto the row's
    budget simplex. ``valid_mask`` is taken and unused: no row reads
    another. (The JAX package's ``_decode_geo`` has no such argument, so
    its bucketed Solver raises TypeError for ``nu_geo``.)"""
    K = config["K"]
    shift = np.broadcast_to(np.asarray(config.get("y_shift", 0.0), np.float32),
                            (Y_raw.shape[1],))
    yd = _by_column(Y_raw / config.get("y_scale", 1.0), torch.add, shift)
    WH = X_unnorm[:, 2 * K + 1:2 * K + 3]
    xy = torch.clamp(yd[:, :2], 0.0, 1.0) * WH
    P = msr_simplex_project(yd[:, 2:], 1.0) * X_unnorm[:, 2 * K:2 * K + 1]
    return torch.cat([xy, P], dim=1)


def _objective_geo(Y_dec, X_unnorm, config):
    return nu_rate(Y_dec, X_unnorm[:, :2 * config["K"]])


def _project_geo(Y_dec, X_unnorm, config):
    """The row's own box and budget simplex, both from the unnormalized
    condition."""
    K = config["K"]
    WH = X_unnorm[:, 2 * K + 1:2 * K + 3]
    xy = torch.minimum(torch.clamp(Y_dec[:, :2], min=0.0), WH)
    P = msr_simplex_project(Y_dec[:, 2:], X_unnorm[:, 2 * K:2 * K + 1])
    return torch.cat([xy, P], dim=1)


def _load_nu_geo(dataset_path, width=400.0, height=400.0, P_sum=None):
    # The default references (p_ref, w_ref, h_ref), as the JAX package's.
    return load_nu_geo(dataset_path, width, height, P_sum)


#: The universal NU solver: the condition carries the budget and the
#: field's geometry, so one model serves any budget on any rectangle. Its
#: decode and projection are strictly per row: mixed-geometry batches are
#: fine. ``proj_dim`` and ``dims`` come from the checkpoint's config.
NU_GEO = dataclasses.replace(
    NU, name="nu_geo",
    build_model=lambda cfg: unet_nu(cfg["K"], cond_extra=3, proj_dim=cfg.get("proj_dim", 32),
                                    dims=tuple(cfg.get("dims", (32, 16, 8)))),
    load=_load_nu_geo,
    decode=_decode_direct,            # the sampling paths use decode_with_x
    decode_with_x=_decode_geo,
    objective=_objective_geo,
    unnormalize_x=_unnorm_x_geo,
    cond_dim=lambda cfg: 2 * cfg["K"] + 3,
    default_omega=0.5,
    project=_project_geo,
)

"""NU task: NOMA-UAV placement and power allocation over K users.

Counterpart of ``diffsg_tpu/tasks/nu.py`` (the ``nu`` and ``nu_direct``
tasks). A solution is (uav_x, uav_y, P_1..P_K); the condition is the K users'
interleaved coordinates, loader-scaled to [0, 1].
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..models.unet1d import unet_nu
from ..ops.decoders import nu_decode, nu_direct_decode
from ..ops.objectives import nu_rate
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


NU = Task(
    name="nu",
    build_model=lambda cfg: unet_nu(cfg["K"]),
    decode=_decode,
    objective=_objective,
    unnormalize_x=_unnorm_x,
    unnormalize_y=_unnorm_y,
    data_dim=lambda cfg: 2 + cfg["K"],
    cond_dim=lambda cfg: 2 * cfg["K"],
    higher_is_better=True,
    default_omega=500.0,
)

#: NU with the per-row decode of scale-normalized (``y_scale``/``y_shift``)
#: checkpoints, served at small omega.
NU_DIRECT = dataclasses.replace(NU, name="nu_direct", decode=_decode_direct,
                                default_omega=1.0)

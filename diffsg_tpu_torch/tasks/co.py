"""CO task: computation offloading (MEC resource allocation) over N nodes.

Counterpart of ``diffsg_tpu/tasks/co.py`` (``co``, ``co_analytic``,
``co_direct``, ``co_ranked``). A solution is the resource share of each
node, 0 for a node that computes locally; the condition is the 3N derived
per-node features [local cost, offload transition cost, ideal offload
execution cost], loader-scaled to [0, 1] by one global min and max. CO
minimizes cost. Every CO decode is strictly per row, so it needs no
validity mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..baselines.co_exact import co_analytic_decode, co_direct_decode, co_ranked_decode
from ..data.loaders import load_co
from ..models.unet1d import unet_co
from ..ops.decoders import co_decode
from ..ops.objectives import co_cost
from ..train.trainer import TrainConfig
from .base import Task


def _decode(Y_raw, config, valid_mask=None):
    return co_decode(Y_raw)


def _objective(Y_dec, X_unnorm, config):
    return co_cost(X_unnorm, Y_dec)


def _unnorm_x(X, config):
    mn, mx = config["scaler_min"], config["scaler_max"]
    return X * (mx - mn) + mn


def _unnorm_y(Y, config):
    return Y


def decision_class(Y: np.ndarray, threshold: float = 0.1) -> np.ndarray:
    """The offload decision (share > ``threshold``) of each row as one
    integer, node 0 the most significant bit."""
    D = (np.asarray(Y) > threshold).astype(int)
    weights = 2 ** np.arange(D.shape[1] - 1, -1, -1)
    return D @ weights


def _extra_metrics(Y_dec, Y_true, pred_cost, true_cost, config):
    """"Terrible" rows (cost over 1.2 x the label's and above 10) and the
    share of rows whose decision equals the label's."""
    pred_cost, true_cost = np.asarray(pred_cost), np.asarray(true_cost)
    terrible = (pred_cost / true_cost > 1.2) & (pred_cost > 10.0)
    acc = decision_class(Y_dec) == decision_class(Y_true)
    return {"terrible_count": float(terrible.sum()), "decision_accuracy": float(acc.mean())}


def _decode_analytic(Y_raw, X_unnorm, config, valid_mask=None):
    return co_analytic_decode(Y_raw, X_unnorm)


def _decode_direct(Y_raw, X_unnorm, config, valid_mask=None):
    return co_direct_decode(Y_raw, X_unnorm, config.get("y_scale", 1.0),
                            config.get("y_shift", 0.0))


def _decode_ranked(Y_raw, X_unnorm, config, valid_mask=None):
    return co_ranked_decode(Y_raw, X_unnorm)


CO = Task(
    name="co",
    build_model=lambda cfg: unet_co(cfg["node_num"]),
    load=load_co,
    decode=_decode,
    objective=_objective,
    unnormalize_x=_unnorm_x,
    unnormalize_y=_unnorm_y,
    data_dim=lambda cfg: cfg["node_num"],
    cond_dim=lambda cfg: 3 * cfg["node_num"],
    train_config=TrainConfig(epochs=200, lr=5e-3, milestones=(15, 80, 150)),
    higher_is_better=False,
    default_omega=500.0,
    extra_metrics=_extra_metrics,
)

#: The sampler's decision with the closed-form allocation.
CO_ANALYTIC = dataclasses.replace(CO, name="co_analytic", decode_with_x=_decode_analytic)

#: For checkpoints trained on the (scaled) shares themselves: the decision
#: thresholded on the unscaled sample, the allocation closed-form; served
#: at small omega.
CO_DIRECT = dataclasses.replace(CO, name="co_direct", decode_with_x=_decode_direct,
                                default_omega=1.0)

#: The sampled row's node ordering picks among the N+1 nested top-k offload
#: sets, each costed closed-form; served at omega 5000.
CO_RANKED = dataclasses.replace(CO, name="co_ranked", decode_with_x=_decode_ranked,
                                default_omega=5000.0)

"""EMA shadow parameters.

Counterpart of ``diffsg_tpu/train/ema.py`` (the reference's
``ExponentialMovingAverage``, a torch ``AveragedModel`` with
``ema = decay * ema + (1 - decay) * param``): the **first** update copies the
parameters, as ``AveragedModel`` initializes its average on the first call;
later updates apply the exponential rule. ``n_averaged`` is carried so that
checkpoints round-trip.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class EmaState(NamedTuple):
    #: state-dict name -> tensor, as ``module.state_dict()`` names them
    params: Dict[str, torch.Tensor]
    n_averaged: int


def ema_init(params: Dict[str, torch.Tensor]) -> EmaState:
    """A copy of ``params`` that no later in-place update of theirs reaches."""
    return EmaState({k: v.detach().clone() for k, v in params.items()}, 0)


def ema_update(state: EmaState, params: Dict[str, torch.Tensor], decay: float) -> EmaState:
    if state.n_averaged == 0:
        new = {k: params[k].detach().clone() for k in state.params}
    else:
        new = {k: decay * avg + (1.0 - decay) * params[k].detach()
               for k, avg in state.params.items()}
    return EmaState(new, state.n_averaged + 1)

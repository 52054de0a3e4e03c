"""Numerical-condition augmentation (the ``condition_C`` capability).

Counterpart of ``diffsg_tpu/tasks/condition.py``: each function appends the
objective value of the decoded state to the condition vector, for a UNet
built with ``cond_dim + 1``. The reference's quirks are kept as the JAX
package keeps them:

* MSR and CO invert the loader scaling as ``(x - min) * (max - min) + min``
  (the reference's expression, not the inverse of the scaling);
* MSR normalizes y by the min and max of the whole batch tensor;
* CO's decision is ``softmax(y) + 1e-6 > 0.1`` and the cost is divided by 10;
* NU decodes the powers from y and uses the user coordinates as given,
  where the reference softmaxes a zeroed buffer and scales a zeroed copy.
"""

from __future__ import annotations

import torch

from ..ops.decoders import nu_decode
from ..ops.objectives import nu_rate


def condition_c_msr(y: torch.Tensor, x: torch.Tensor, scaler_min: float,
                    scaler_max: float) -> torch.Tensor:
    """Append the total rate of the min-max and softmax decoded y."""
    y_norm = torch.softmax((y - y.min()) / (y.max() - y.min()), dim=1)
    x_src = (x - scaler_min) * (scaler_max - scaler_min) + scaler_min
    total_rate = torch.log2(1 + x_src * y_norm).sum(dim=1, keepdim=True)
    return torch.cat([x, total_rate], dim=1)


def condition_c_co(y: torch.Tensor, x: torch.Tensor, scaler_min: float,
                   scaler_max: float) -> torch.Tensor:
    """Append the total cost / 10 of the softmax-decoded y."""
    y_norm = torch.softmax(y, dim=1) + 1e-6
    D = (y_norm > 0.1).to(y.dtype)
    x_src = (x - scaler_min) * (scaler_max - scaler_min) + scaler_min
    local, transition, execution = x_src[:, 0::3], x_src[:, 1::3], x_src[:, 2::3]
    cost = ((1 - D) * local + D * (transition + execution / y_norm)).sum(dim=1, keepdim=True)
    return torch.cat([x, cost / 10.0], dim=1)


def condition_c_nu(y: torch.Tensor, x: torch.Tensor, width: float, height: float,
                   P_sum: float) -> torch.Tensor:
    """Append the NOMA rate of the ``nu_decode``-decoded y."""
    rates = nu_rate(nu_decode(y, width, height, P_sum), x)[:, None]
    return torch.cat([x, rates], dim=1)

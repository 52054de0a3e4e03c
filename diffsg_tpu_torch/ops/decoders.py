"""Solution decoders: raw sampler output -> feasible solutions.

Counterpart of ``diffsg_tpu/ops/decoders.py``. The MSR decoder and
``nu_decode`` normalize by the min and max of the **whole batch tensor**,
not per row, as the published method does; ``valid_mask`` (B, 1) restricts
those reductions to real rows, and under an active mesh they reduce over
dp. ``co_decode`` and ``nu_direct_decode`` are strictly per row.

Per-column constants (the area, ``y_shift``) are applied as Python numbers,
one column at a time, so that no decoder copies data from the host: a
decode can then be captured in a CUDA graph.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import all_reduce_min, current_mesh


def _by_column(Y: torch.Tensor, fn, values: Sequence[float]) -> torch.Tensor:
    """``fn(Y[:, j], values[j])`` for every column j, as one (B, len) tensor."""
    return torch.cat([fn(Y[:, j:j + 1], float(v)) for j, v in enumerate(values)], dim=1)


def masked_min_max(Y: torch.Tensor, valid_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global min and max over the rows where ``valid_mask`` > 0 (None:
    every row). Under an active mesh (``parallel.mesh``) ``Y`` is the rank's
    shard, and the min and the max are taken over dp (one MIN all-reduce of
    ``(min, -max)``)."""
    if valid_mask is None:
        mn, mx = Y.min(), Y.max()
    else:
        big = torch.finfo(Y.dtype).max
        keep = valid_mask > 0
        mn = torch.where(keep, Y, torch.full_like(Y, big)).min()
        mx = torch.where(keep, Y, torch.full_like(Y, -big)).max()
    mesh = current_mesh()
    if mesh is not None:
        mn, neg_mx = all_reduce_min(torch.stack([mn, -mx]), mesh).unbind()
        mx = -neg_mx
    return mn, mx


def msr_decode(Y: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-global min-max, then a per-row softmax. Powers are
    ``W * msr_decode(Y)`` (applied by the task)."""
    mn, mx = masked_min_max(Y, valid_mask)
    return torch.softmax((Y - mn) / (mx - mn), dim=1)


def msr_simplex_project(Y: torch.Tensor, W: Union[float, torch.Tensor]) -> torch.Tensor:
    """Euclidean projection of each row onto {p >= 0, sum p = W}: sort
    descending, tau = (cumsum of the k largest - W) / k for the largest
    valid k. ``W`` is a scalar or a (B, 1) per-row budget."""
    D = Y.shape[1]
    s = torch.sort(Y, dim=1, descending=True).values
    csum = torch.cumsum(s, dim=1)
    k = torch.arange(1, D + 1, dtype=Y.dtype, device=Y.device)[None, :]
    tau_k = (csum - W) / k
    rho = (s > tau_k).sum(dim=1) - 1
    tau = torch.gather(tau_k, 1, rho[:, None])
    return torch.clamp(Y - tau, min=0.0)


def co_decode(Y: torch.Tensor) -> torch.Tensor:
    """Per-row softmax; rows that lie entirely below -10 decode to all zeros
    (the "process everything locally" sentinel)."""
    dec = torch.softmax(Y, dim=1)
    all_local = (Y < -10.0).all(dim=1, keepdim=True)
    return torch.where(all_local, torch.zeros_like(dec), dec)


def nu_direct_decode(Y: torch.Tensor, width: float, height: float, P_sum: float,
                     y_scale: float = 1.0,
                     y_shift: Union[float, Sequence[float], torch.Tensor] = 0.0) -> torch.Tensor:
    """Per-row NU decode for scale-normalized training: unscale (targets
    were ``y_scale * (labels - y_shift)``, ``y_shift`` scalar or (D,)), clip
    the UAV position into the area and project the power split onto the
    simplex of sum ``P_sum``."""
    if isinstance(y_shift, torch.Tensor):
        y_shift = y_shift.tolist()
    shift = np.broadcast_to(np.asarray(y_shift, np.float32), (Y.shape[1],))
    yd = _by_column(Y / y_scale, torch.add, shift)
    xy = _by_column(torch.clamp(yd[:, :2], 0.0, 1.0), torch.mul, (width, height))
    P = msr_simplex_project(yd[:, 2:], 1.0) * P_sum
    return torch.cat([xy, P], dim=1)


def nu_decode(Y: torch.Tensor, width: float, height: float, P_sum: float,
              valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """UAV coordinates: min-max over the whole (B, 2) coordinate slice,
    scaled to the area; powers: per-row softmax times ``P_sum``."""
    xy = Y[:, :2]
    mn, mx = masked_min_max(xy, valid_mask)
    xy = _by_column((xy - mn) / (mx - mn), torch.mul, (width, height))
    P = torch.softmax(Y[:, 2:], dim=1) * P_sum
    return torch.cat([xy, P], dim=1)

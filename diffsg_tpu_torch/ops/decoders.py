"""Solution decoders: raw sampler output -> feasible solutions.

Counterpart of ``diffsg_tpu/ops/decoders.py`` (MSR). The MSR decoder
normalizes by the min and max of the **whole batch tensor**, not per row, as
the published method does; ``valid_mask`` (B, 1) restricts those reductions
to real rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def masked_min_max(Y: torch.Tensor, valid_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global min and max over the rows where ``valid_mask`` > 0."""
    big = torch.finfo(Y.dtype).max
    keep = valid_mask > 0
    mn = torch.where(keep, Y, torch.full_like(Y, big)).min()
    mx = torch.where(keep, Y, torch.full_like(Y, -big)).max()
    return mn, mx


def msr_decode(Y: torch.Tensor, valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-global min-max, then a per-row softmax. Powers are
    ``W * msr_decode(Y)`` (applied by the task)."""
    if valid_mask is None:
        mn, mx = Y.min(), Y.max()
    else:
        mn, mx = masked_min_max(Y, valid_mask)
    return torch.softmax((Y - mn) / (mx - mn), dim=1)

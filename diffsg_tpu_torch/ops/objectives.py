"""Objective evaluators. Counterpart of ``diffsg_tpu/ops/objectives.py`` (MSR)."""

from __future__ import annotations

import torch


def msr_sum_rate(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Per-sample rate ``sum_m log2(1 + p_m * g_m)``; p, g (B, M) -> (B,)."""
    return torch.log2(1.0 + p * g).sum(dim=1)

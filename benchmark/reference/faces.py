"""The condition of a multi-task face, in plain PyTorch.

One shared net answers several tasks. It reads the condition ``[one-hot
(n_slots) | payload (payload_dim)]``: the one-hot names the task's slot
among the checkpoint's ``slots``, and the payload holds the task's own
condition, zero-padded to ``payload_dim``. The unconditional pass of CFG
zeroes the whole row, one-hot included. A face's task module takes
``slots`` and ``payload_dim`` from its ``task_config``, which the run
checks against the checkpoint's.
"""

from __future__ import annotations

from typing import Dict

import torch


def embed(cond: torch.Tensor, slot: str, task: Dict) -> torch.Tensor:
    """(R, c) conditions of the task at ``slot`` -> (R, n_slots + payload_dim)."""
    slots, payload = list(task["slots"]), int(task["payload_dim"])
    if cond.shape[1] > payload:
        raise ValueError(f"condition {cond.shape[1]} wider than the payload {payload}")
    out = torch.zeros((cond.shape[0], len(slots) + payload), dtype=cond.dtype, device=cond.device)
    out[:, slots.index(slot)] = 1.0
    out[:, len(slots):len(slots) + cond.shape[1]] = cond
    return out

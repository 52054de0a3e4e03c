"""Per-step decode and layout of a captured denoise trajectory.

Counterpart of ``diffsg_tpu/utils/trace.py``: ``cfg_sample(...,
record_trace=True)`` returns a ``SampleTrace`` of (T, B, D) tensors, and
this module decodes it as the reference's trajectory scripts do:

* MSR: the first 3 recorded steps with a plain row softmax, later steps
  with the full decoder (``msr_decode``, without the W scale);
* CO: every step with ``co_decode``;
* NU: every step with ``nu_decode``;
* layout: one row per sample, ``T * D`` wide, step-major blocks
  ``[step0 dims..., step1 dims..., ...]``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..diffusion.ddpm import SampleTrace
from ..ops.decoders import co_decode, msr_decode, nu_decode


def _rows(arr: torch.Tensor) -> np.ndarray:
    """(T, B, D) -> (B, T*D), step-major."""
    arr = arr.detach().cpu().numpy()
    return arr.transpose(1, 0, 2).reshape(arr.shape[1], -1)


def decode_trace(task_name: str, trace: SampleTrace, config: Dict) -> np.ndarray:
    """Per-step decode of a captured trajectory -> (B, T*D) array."""
    ys = trace.ys
    if task_name == "msr":
        decoded = [torch.softmax(ys[i], dim=1) if i <= 2 else msr_decode(ys[i])
                   for i in range(ys.shape[0])]
    elif task_name == "nu":
        decoded = [nu_decode(ys[i], config["width"], config["height"], config["P_sum"])
                   for i in range(ys.shape[0])]
    elif task_name == "co":
        decoded = [co_decode(ys[i]) for i in range(ys.shape[0])]
    else:
        raise ValueError(f"unknown task {task_name!r}")
    return _rows(torch.stack(decoded))


def eps_trace(trace: SampleTrace) -> np.ndarray:
    """(B, T*D) layout of the CFG-combined epsilons."""
    return _rows(trace.eps)

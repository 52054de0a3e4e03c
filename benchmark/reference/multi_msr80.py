"""MSR-80c as a face of a multi-task net: powers over M = 80 channels under
the budget W, the condition ``[gains (M) | W / w_ref]`` at slot ``msr80``.

The conditions are the M gains, uniform on [0, 1) once scaled by the data
set's min-max, and the budget column ``W / w_ref``, the budget the decoder
projects onto. The decoder crops the net's canvas to M columns and keeps,
row by row, the best sum rate at the unnormalized gains of two families:
the simplex projections of ``a * Y / y_scale`` onto sum W, and the
softmaxes of ``t * Yn`` times W, where ``Yn`` is ``Y`` under its request's
min-max; a row takes its best projection only where it is strictly better.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import faces
from .sampler import segment_min_max_scale, simplex_project

SLOT = "msr80"
PROJ_SCALES = (0.75, 1.0, 1.5, 2.0, 3.0)
TEMPERATURES = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0)


def conditions(rng: np.random.Generator, n: int, task: Dict) -> np.ndarray:
    """(n, M + 1): scaled gains uniform on [0, 1), then ``W / w_ref``."""
    X = np.empty((n, task["M"] + 1), np.float32)
    X[:, :-1] = rng.random((n, task["M"]), dtype=np.float32)
    X[:, -1] = task["W"] / task["w_ref"]
    return X


def embed(cond: torch.Tensor, task: Dict) -> torch.Tensor:
    return faces.embed(cond, SLOT, task)


def sum_rate(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return torch.log2(1.0 + p * g).sum(dim=1)


def best(cands: torch.Tensor, g: torch.Tensor) -> tuple:
    """Each row's candidate of highest sum rate, ties to the lower index,
    and that rate; ``cands`` (k, R, M)."""
    rates = torch.stack([sum_rate(p, g) for p in cands])
    pick = torch.argmax(rates, dim=0)
    rows = torch.arange(cands.shape[1], device=cands.device)
    return cands[pick, rows], rates[pick, rows]


def decode_with_x(Y: torch.Tensor, X: torch.Tensor, seg: torch.Tensor, n_seg: int,
                  task: Dict) -> torch.Tensor:
    """Powers (R, M) from the canvas ``Y`` (R, D >= M) and the scaled
    conditions ``X`` (R, M + 1)."""
    M, W = task["M"], task["W"]
    Y = Y[:, :M]
    lo, hi = task["scaler_min"], task["scaler_max"]
    g = (X[:, :M].double() * (hi - lo) + lo).float()
    proj, r_proj = best(torch.stack([simplex_project(a * Y / task["y_scale"], W)
                                     for a in PROJ_SCALES]), g)
    Yn = segment_min_max_scale(Y, seg, n_seg)
    soft, r_soft = best(torch.stack([W * torch.softmax(t * Yn, dim=1) for t in TEMPERATURES]), g)
    return torch.where((r_proj > r_soft)[:, None], proj, soft)

"""MSR: powers over M channels that maximise the sum rate under a budget W.

The conditions are the M channel gains, drawn uniform over the data set's
range, which the checkpoint's min-max scaling maps onto [0, 1)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .sampler import segment_min_max_scale


def conditions(rng: np.random.Generator, n: int, task: Dict) -> np.ndarray:
    """(n, M) scaled gains, uniform on [0, 1)."""
    return rng.random((n, task["M"]), dtype=np.float32)


def decode(Y: torch.Tensor, seg: torch.Tensor, n_seg: int, task: Dict) -> torch.Tensor:
    """Powers: the request's global min-max scaling (over all its rows and
    columns), then a per-row softmax times the budget W."""
    return task["W"] * torch.softmax(segment_min_max_scale(Y, seg, n_seg), dim=1)


def align(served: np.ndarray, ref: np.ndarray) -> tuple:
    """The reference's answer to one request at the served answer's
    request-wide scale, and that scale's ratio to the reference's.

    The min-max scaling makes each row's centred log-powers ``log p - mean
    log p`` equal ``(y - mean y) / (max - min)``, the one scale shared by the
    whole request and set by its extreme entry. Where float32 rounding moves
    the extreme row elsewhere, every row's centred logits scale by one
    factor ``k``; ``k`` is the median over rows of the least-squares ratio
    of the served row's to the reference's, and the reference's rows are
    rescaled by it, so a row compares as wrong only for what is wrong in
    the row itself. ``k`` is returned, to be reported."""
    la = np.log(np.maximum(served, 1e-30))
    lb = np.log(np.maximum(ref, 1e-30))
    la -= la.mean(axis=1, keepdims=True)
    lb -= lb.mean(axis=1, keepdims=True)
    den = (lb * lb).sum(axis=1)
    use = den > 1e-12
    k = float(np.median((la * lb).sum(axis=1)[use] / den[use])) if use.any() else 1.0
    z = k * lb
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return ref.sum(axis=1, keepdims=True) * e / e.sum(axis=1, keepdims=True), k

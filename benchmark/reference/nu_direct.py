"""NU: the position of a UAV and its power split over K NOMA users.

The conditions are the users' coordinates, one user in each of K distinct
quadrants of the field at whole metres, as the data set draws them, scaled
by the field's width and height."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .sampler import simplex_project


def conditions(rng: np.random.Generator, n: int, task: Dict) -> np.ndarray:
    """(n, 2K) interleaved (x, y) of K users, each in its own random quadrant."""
    K, W, H = task["K"], int(task["width"]), int(task["height"])
    quad = np.argsort(rng.random((n, 4)), axis=1)[:, :K]
    x_lo, y_lo = W // 2 * (quad % 2) + 1, H // 2 * (quad // 2) + 1
    x = x_lo + rng.integers(0, W // 2, size=(n, K))
    y = y_lo + rng.integers(0, H // 2, size=(n, K))
    xy = np.empty((n, 2 * K), np.float32)
    xy[:, 0::2], xy[:, 1::2] = x / W, y / H
    return xy


def decode(Y: torch.Tensor, seg: torch.Tensor, n_seg: int, task: Dict) -> torch.Tensor:
    """Per row: undo the training scale and shift, clip the UAV into the
    field, project the K powers onto the simplex of sum P_sum."""
    yd = Y / task["y_scale"] + torch.as_tensor(np.float32(task["y_shift"]), device=Y.device)
    area = torch.tensor([task["width"], task["height"]], dtype=Y.dtype, device=Y.device)
    xy = torch.clamp(yd[:, :2], 0.0, 1.0) * area
    return torch.cat([xy, simplex_project(yd[:, 2:], 1.0) * task["P_sum"]], dim=1)

"""Whether the served answers are right: the plain reference, recomputed.

The reference (``benchmark.reference``) reads the checkpoint file itself and
is handed the same conditions; it draws each request's noise as the
Solver's documented contract says (a generator on the device seeded with
the request's seed, ``normal_`` over (n, columns, D): DDPM's T + 1 columns,
y_T then each step's z; DDIM's one). Every number compared is a gap between
the served answer and the reference's, per column in units of the
configuration's ``answer_scale``:

* ``max_gap``: the largest over every compared row and column;
* ``mean_gap``: the mean over every row and column;
* ``req_med_gap``: the largest over the compared requests of the median
  over each request's rows of the row's largest gap: every request is
  seen, and one wrong in half its rows or more fails;
* ``rows_q99_gap``: the 99th percentile of the rows' gaps over every
  compared row: a fault in more than about a hundredth of the rows fails;
* ``scale_gap``: reported, not held: how far each request's scale moved
  (MSR, below).

MSR's omega 500 multiplies each step's rounding about a thousandfold, so a
few rows in a thousand end elsewhere in any two float32 computations, and
where such a row holds the request's extreme entry, the decoder's
request-wide min-max rescales every answer of that request. The row
numbers therefore compare each row with the reference's at the served
request's scale (``benchmark.reference.msr.align``); ``max_gap`` and
``mean_gap``, which the few rows set, hold NU alone.

Each number held has a limit of its own in ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import hashlib
import importlib
import pathlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..reference import sampler
from ..reference.unet import MatMul, UNet1D, load_arrays

#: Rows the reference runs at once (CFG's two passes are two forwards).
REFERENCE_ROWS = 1 << 19


def checkpoint_sha256(ckpt_dir: str) -> str:
    return hashlib.sha256(pathlib.Path(ckpt_dir, "arrays.npz").read_bytes()).hexdigest()


def noise_columns(config: Dict) -> int:
    s = config["sampler"]
    return s["T"] + 1 if s["kind"] == "ddpm" else 1


def request_noise(seed: int, rows: int, config: Dict, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (rows, noise_columns(config), config["model"]["input_dim"])
    return torch.empty(shape, dtype=torch.float32, device=device).normal_(generator=gen)


class Reference:
    """The reference of one configuration on ``device``; ``matmul`` is the
    product its Denses use (the control passes a lower precision)."""

    def __init__(self, config: Dict, device: torch.device, matmul: MatMul = torch.matmul):
        params, betas = load_arrays(config["checkpoint"])
        m = config["model"]
        self.net = UNet1D(params, m["dims"], m["n_blocks"], device, matmul)
        self.co = sampler.Coefficients(betas, device)
        self.config, self.device = config, device

    def answers(self, requests: Sequence) -> List[np.ndarray]:
        """The reference's answers to ``requests`` (each with ``X`` and
        ``noise_seed``), several requests to a batch."""
        out: List[np.ndarray] = []
        group: list = []

        def flush():
            if group:
                res = sampler.solve(self.net, self.co, self.config, [r.X for r in group],
                                    [request_noise(r.noise_seed, len(r.X), self.config,
                                                   self.device) for r in group])
                out.extend(np.split(res, np.cumsum([len(r.X) for r in group])[:-1]))
                group.clear()

        for r in requests:
            if group and sum(len(g.X) for g in group) + len(r.X) > REFERENCE_ROWS:
                flush()
            group.append(r)
        flush()
        return out


def gaps(config: Dict, served: Sequence[np.ndarray], reference: Sequence[np.ndarray]
         ) -> Dict[str, float]:
    """The gaps of the served answers against the reference's (NaN where a
    served answer is not finite). A row's gap is its largest over the
    columns; the row numbers compare against the reference aligned to each
    request's scale where the task's module has ``align``."""
    scale = np.asarray(config["answer_scale"], np.float64)
    served = [np.asarray(a, np.float64) for a in served]
    reference = [np.asarray(b, np.float64) for b in reference]
    d = np.concatenate([np.abs(a - b) / scale for a, b in zip(served, reference)] or [[np.nan]])
    if not np.isfinite(d).all():
        return dict.fromkeys(("max_gap", "mean_gap", "req_med_gap", "rows_q99_gap", "scale_gap"),
                             float("nan"))
    task = importlib.import_module(f"benchmark.reference.{config['task']}")
    align = getattr(task, "align", lambda a, b: (b, 1.0))
    rows, ks = [], []
    for a, b in zip(served, reference):
        b, k = align(a, b)
        rows.append((np.abs(a - b) / scale).max(axis=1))
        ks.append(abs(k - 1.0))
    return {"max_gap": float(d.max()), "mean_gap": float(d.mean()),
            "req_med_gap": float(max(np.median(r) for r in rows)),
            "rows_q99_gap": float(np.percentile(np.concatenate(rows), 99)),
            "scale_gap": float(max(ks))}


def sample(done: Sequence, k: int, seed: int) -> List:
    """``k`` answered requests drawn from the seed, the largest among them."""
    ok = [d for d in done if d.ok]
    if len(ok) <= k:
        return list(ok)
    largest = max(range(len(ok)), key=lambda i: ok[i].rows)
    rest = [i for i in range(len(ok)) if i != largest]
    pick = np.random.default_rng([seed % 2 ** 64, 11]).choice(rest, k - 1, replace=False)
    return [ok[i] for i in sorted([largest, *pick.tolist()])]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN never is)."""
    return all(numbers[k] <= limits[k] for k in limits)

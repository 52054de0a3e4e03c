"""Serving latency and throughput table: p50/p99 blocking latency per batch
size and sampler, and pipelined (queued) throughput.

Counterpart of the JAX package's ``tools/serving_latency.py``, with its
flags and JSON keys; ``--cpu`` runs on the CPU (the default is the CUDA
card). The ``serve.Solver`` has one bucket per ``--sizes`` entry, so on the
card every request replays its bucket's CUDA graph; each (sampler, size) is
warmed (captured) first, untimed. The blocking rows time ``solve`` (the
result copied to the host) ``--repeats`` times; the pipelined rows issue
``--depth`` ``solve(..., _block=False)`` requests before they copy any
result, as a request queue does, so the host's work overlaps the card's.

    python -m diffsg_tpu_torch.tools.serving_latency --ckpt ckpts/ddpm_nu_3u_aug32_s8c \\
        --task nu_direct --sizes 1 512 32768 --samplers ddim:3 --repeats 10
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..serve import Solver
from ._cli import add_device_args, device_from_args


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="ckpts/ddpm_nu_3u_aug32_s8c")
    ap.add_argument("--task", default="nu_direct")
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 64, 512, 4096, 32768])
    ap.add_argument("--samplers", nargs="+", default=["ddpm:20", "ddim:3"],
                    help="sampler:steps pairs")
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--depth", type=int, default=8,
                    help="queue depth for the pipelined-throughput rows")
    ap.add_argument("--omega", type=float, default=None)
    add_device_args(ap)
    return ap.parse_args(argv)


def make_solver(ckpt: str, task: str, sizes, device: DeviceLike = "cuda",
                backend: str = "fused") -> Solver:
    """The Solver the table measures: one bucket per size, on ``backend``
    (the Solver's own default, ``fused``)."""
    return Solver.from_checkpoint(ckpt, task=task, device=device, backend=backend,
                                  buckets=sorted(set(sizes)))


def _sync(solver: Solver) -> None:
    if solver.device.type == "cuda":
        torch.cuda.synchronize(solver.device)


def latency_row(solver: Solver, X: np.ndarray, sampler: str, n_steps: Optional[int],
                omega, repeats: int, depth: int) -> Tuple[Dict, List[np.ndarray]]:
    """One table row for the batch ``X``, and the pipelined requests'
    results (seeds 1000 .. 1000 + depth - 1), in order."""
    # DDPM runs all T steps: the JAX Solver ignores its n_steps, the port's
    # refuses it.
    kw = dict(omega=omega, sampler=sampler, n_steps=n_steps if sampler == "ddim" else None)
    solver.solve(X, **kw)   # warm: on a card, captures the bucket's graph
    lats = []
    for r in range(repeats):
        t0 = time.perf_counter()
        solver.solve(X, seed=r, **kw)
        lats.append(time.perf_counter() - t0)
    lats = np.sort(lats)
    p50 = float(np.percentile(lats, 50) * 1e3)
    p99 = float(np.percentile(lats, 99) * 1e3)
    _sync(solver)
    t0 = time.perf_counter()
    pend = [solver.solve(X, seed=1000 + i, _block=False, **kw) for i in range(depth)]
    piped_out = [p.cpu().numpy() for p in pend]
    piped = time.perf_counter() - t0
    B = X.shape[0]
    row = {"sampler": f"{sampler}-{n_steps or int(solver.sched.T)}", "batch": B,
           "p50_ms": round(p50, 2), "p99_ms": round(p99, 2),
           "blocking_sol_s": round(B / (p50 / 1e3)),
           "pipelined_sol_s": round(depth * B / piped), "depth": depth}
    return row, piped_out


def table(solver: Solver, sizes, samplers, repeats: int, depth: int, omega=None):
    """Every (sampler, size) row, printed as it is measured, as (row, the
    batch's conditions, its pipelined results). Conditions uniform in
    [0.05, 0.95] from ``np.random.default_rng(0)``, drawn row after row."""
    C = solver.task.cond_dim(solver.config)
    rng = np.random.default_rng(0)
    out = []
    for spec in samplers:
        sampler, _, steps = spec.partition(":")
        n_steps = int(steps) if steps else None
        for B in sizes:
            X = rng.uniform(0.05, 0.95, (B, C)).astype(np.float32)
            row, piped = latency_row(solver, X, sampler, n_steps, omega, repeats, depth)
            print(json.dumps(row), flush=True)
            out.append((row, X, piped))
    return out


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args = parse_args(argv)
    dev = device_from_args(args)
    solver = make_solver(args.ckpt, args.task, args.sizes, dev)
    return [row for row, _, _ in table(solver, args.sizes, args.samplers, args.repeats,
                                       args.depth, args.omega)]


if __name__ == "__main__":
    main()

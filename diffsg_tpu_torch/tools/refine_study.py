"""Seed-value study for hybrid refinement (``ops.refine``) on NU: is the
diffusion seed worth anything once a projected-gradient refiner runs, or
would random multi-start reach the same basins?

Counterpart of the JAX package's ``tools/refine_study.py``, with its flags
and its one JSON line; ``--cpu`` runs on the CPU (the default is the CUDA
card). On the test split of ``--dataset`` (ratios against its labels), at
``--iters`` and at 4 x ``--iters``: a random single start refined
(``random1``), the best of ``--starts`` random starts (``random{N}``), and
the ``nu_budget`` checkpoint's single draw refined (``diffusion``), plus the
unrefined draw (``diffusion_it0``). Every arm uses the task's projection,
preconditioner and step. Random starts: unit-uniform draws (B, 2+K) per
start from one ``torch.Generator`` seeded by ``--seed`` (start 0 is
``random1``'s), the same draws at both iteration counts.

    python -m diffsg_tpu_torch.tools.refine_study --iters 50 --starts 32 \\
        --dataset build/datasets/3u_budget9-36_2000samples.csv
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops.refine import best_of_starts, projected_refine, random_starts
from ..tasks import TASKS, merge_ckpt_config, sample_solutions
from ..utils import load_checkpoint
from ._cli import add_device_args, device_from_args, reference_csv


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--starts", type=int, default=32)
    ap.add_argument("--ckpt", default="ckpts/ddpm_nu_budget")
    ap.add_argument("--dataset", default=reference_csv("3u_18mW_10000samples.csv"))
    ap.add_argument("--omega", type=float, default=0.06)
    ap.add_argument("--seed", type=int, default=0)
    add_device_args(ap)
    return ap.parse_args(argv)


def study(ckpt: str, dataset: str, iters: int, starts, omega: float, seed: int = 0,
          device: DeviceLike = "cuda") -> Dict:
    """The study's line. ``starts``: the number of random starts, or their
    unit-uniform draws as a tensor (n, B, 2+K)."""
    dev = resolve_device(device)
    task = TASKS["nu_budget"]
    data = task.load(dataset)
    ck = load_checkpoint(ckpt, device=dev)
    merge_ckpt_config(data.config, ck.get("metadata"))
    cfg = data.config
    Xu = torch.as_tensor(np.asarray(task.unnormalize_x(data.X_test, cfg), np.float32),
                         device=dev)
    Y_true = task.unnormalize_y(data.Y_test, cfg)
    true_sum = float(task.objective(torch.as_tensor(np.asarray(Y_true, np.float32), device=dev),
                                    Xu, cfg).sum())
    B, K = Xu.shape[0], cfg["K"]

    def obj(Y):
        return task.objective(Y, Xu, cfg)

    def proj(Y):
        return task.project(Y, Xu, cfg)

    precond = task.refine_precond(cfg) if task.refine_precond else None

    def refine(Y0, n):
        return projected_refine(obj, proj, Y0, n, task.refine_step,
                                higher_is_better=task.higher_is_better, precond=precond)

    def ratio(Y):
        return float(obj(Y).sum()) / true_sum

    box = torch.tensor([cfg["width"], cfg["height"]], dtype=torch.float32, device=dev)
    starts_Y = random_starts(starts, proj, box, (B, 2 + K), seed, dev)

    out = {"iters": iters, "starts": len(starts_Y), "dataset": dataset, "n": B, "labels": 1.0}
    Yd, _ = sample_solutions(task, ck["params"], ck["sched"], data.X_test, cfg, omega=omega,
                             seed=seed)
    Yd = torch.as_tensor(Yd, device=dev)
    for n in (iters, 4 * iters):
        Y1 = refine(starts_Y[0], n)
        out[f"random1_it{n}"] = ratio(Y1)
        best, _ = best_of_starts(lambda Y: refine(Y, n), obj, starts_Y[1:], Y1)
        out[f"random{len(starts_Y)}_it{n}"] = ratio(best)
        out[f"diffusion_it{n}"] = ratio(refine(Yd, n))
        if n == iters:
            out["diffusion_it0"] = ratio(Yd)
    return out


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    dev = device_from_args(args)
    out = study(args.ckpt, args.dataset, args.iters, args.starts, args.omega, args.seed, dev)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

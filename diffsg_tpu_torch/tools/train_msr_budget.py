"""Train the W-conditioned MSR DDPM (``msr_budget``) and evaluate it.

Counterpart of the JAX package's ``tools/train_msr_budget.py``, with its
flags; ``--cpu`` runs on the CPU, and the default is the CUDA card. The
condition carries ``W / w_ref``, so one model serves any power budget. The
rows are made in memory: gains U(0.5, 2.5), a per-row W from a grid that
leaves out the eval budgets 10 and 20, exact waterfilling labels, centered
per row by W_row / M (the ``msr_wf`` decode's simplex projection is
invariant to a per-row shift) and scaled by ``--y-scale``.

    python -m diffsg_tpu_torch.tools.train_msr_budget --out build/ddpm_msr_budget
    python -m diffsg_tpu_torch.tools.train_msr_budget --channels 80 --w-max 45 \\
        --w-step 2.5 --exclude-budgets 20 40 --y-scale 8 --proj-dim 256 \\
        --dims 256 128 64 32 --indist datasets/80c_20w_wf_10000samples.csv \\
        --ood datasets/80c_40w_wf_2000samples_ood.csv --out build/ddpm_msr_80c_budget
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np

from ._cli import add_device_args, reference_csv


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples", type=int, default=100000)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--w-min", type=float, default=5.0)
    ap.add_argument("--w-max", type=float, default=25.0)
    ap.add_argument("--w-step", type=float, default=1.0)
    ap.add_argument("--exclude-budgets", type=float, nargs="*", default=[10.0, 20.0])
    ap.add_argument("--indist", default=reference_csv("3c_10w_10000samples.csv"))
    ap.add_argument("--ood", default=reference_csv("3c_20w_2000samples_ood.csv"))
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--milestones", type=int, nargs="+", default=None)
    ap.add_argument("--y-scale", type=float, default=3.0)
    ap.add_argument("--proj-dim", type=int, default=None,
                    help="UNet proj width (default 128, the msr_budget task's)")
    ap.add_argument("--dims", type=int, nargs="+", default=None,
                    help="UNet stage widths (default 64 32 16 8)")
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--omegas", type=float, nargs="+", default=[0.5, 1.0, 2.0])
    ap.add_argument("--out", default="ckpts/ddpm_msr_budget")
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    from ..data.datasets import value_grid, wf_budget_rows
    from ..data.loaders import MSR_W_REF
    from ..tasks import TASKS
    from ._cli import device_from_args, ensure_inputs, overrides, print_evals, train_and_save

    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS["msr_budget"]
    M = args.channels
    grid = value_grid(args.w_min, args.w_max, args.w_step, args.exclude_budgets)
    X, Y_t, scaler_min, scaler_max = wf_budget_rows(np.random.default_rng(args.seed),
                                                    args.samples, M, grid, args.y_scale)
    print(f"train rows: {args.samples} over {len(grid)} budgets {grid[0]}..{grid[-1]} W "
          f"(excluded: {args.exclude_budgets})")
    cfg_d = {"M": M, "W": MSR_W_REF, "w_ref": MSR_W_REF, "scaler_min": scaler_min,
             "scaler_max": scaler_max, "y_scale": args.y_scale}
    if args.proj_dim:
        cfg_d["proj_dim"] = args.proj_dim
    if args.dims:
        cfg_d["dims"] = tuple(args.dims)
    model = task.build_model(cfg_d)
    cfg = dataclasses.replace(task.train_config, **overrides(
        epochs=args.epochs, lr=args.lr, seed=args.seed, grad_clip=args.grad_clip,
        milestones=tuple(args.milestones) if args.milestones else None))
    params, sched = train_and_save(args.out, model, X, Y_t, cfg, dev, {
        "task": "msr_budget", "budgets": [float(w) for w in grid],
        "config": dataclasses.asdict(cfg), "dataset_config": cfg_d})

    ensure_inputs([args.indist, args.ood])
    for name, path in (("in-dist", args.indist), ("ood", args.ood)):
        d = task.load(path)
        d.config["y_scale"] = args.y_scale
        for k in ("proj_dim", "dims"):
            if k in cfg_d:
                d.config[k] = cfg_d[k]
        print_evals(task, params, sched, d, args.omegas, split=name)


if __name__ == "__main__":
    main()

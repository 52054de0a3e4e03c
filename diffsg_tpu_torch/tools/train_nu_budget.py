"""Train the budget-conditioned NU DDPM (``nu_budget``) and evaluate it.

Counterpart of the JAX package's ``tools/train_nu_budget.py``, with its
flags; ``--cpu`` runs on the CPU, and the default is the CUDA card. The
condition carries ``P_sum / p_ref``, so one model serves any budget. The
rows: a multi-budget oracle CSV (``make_datasets nu-budget``, 13 columns,
a budget per row) and, unless ``--no-indist``, the training split of the
18 mW reference CSV with its budget appended; rigid-motion augmented
(rate- and budget-invariant), normalized per row (coordinates by the
field, powers by the row's budget), centered per column unless
``--no-center``, and scaled by ``--y-scale``.

    python -m diffsg_tpu_torch.tools.make_datasets nu-budget \\
        --out datasets/3u_budget9-36_10000samples.csv
    python -m diffsg_tpu_torch.tools.train_nu_budget --out build/ddpm_nu_budget
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ._cli import add_device_args, read_rows, reference_csv


def load_budget_rows(csv_path: str, width: float = 400.0, height: float = 400.0) -> np.ndarray:
    """The 13-column multi-budget CSV as raw rows (the augmenter takes raw
    coordinates; the budget column rides along)."""
    return read_rows(csv_path, 13)


def normalize_rows(raw: np.ndarray, width: float, height: float,
                   p_ref: float) -> Tuple[np.ndarray, np.ndarray]:
    """Raw 13-column rows -> (X with the budget feature, Y normalized per
    row)."""
    P_row = raw[:, 12:13]
    X = raw[:, :6].astype(float).copy()
    X[:, 0::2] /= width
    X[:, 1::2] /= height
    X = np.concatenate([X, P_row / p_ref], axis=1)
    Y = raw[:, 6:11].astype(float).copy()
    Y[:, 0] /= width
    Y[:, 1] /= height
    Y[:, 2:] /= P_row
    return X, Y


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget-dataset", default="datasets/3u_budget9-36_10000samples.csv")
    ap.add_argument("--indist", default=reference_csv("3u_18mW_10000samples.csv"))
    ap.add_argument("--ood", default=reference_csv("3u_30mW_1000samples_ood.csv"))
    ap.add_argument("--times", type=int, default=16,
                    help="rigid-motion augmentation copies per base row")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--milestones", type=int, nargs="+", default=None)
    ap.add_argument("--out", default="ckpts/ddpm_nu_budget")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--omegas", type=float, nargs="+", default=[0.06, 0.125, 0.25, 0.5])
    ap.add_argument("--y-scale", type=float, default=8.0)
    ap.add_argument("--no-center", dest="center", action="store_false")
    ap.add_argument("--no-indist", dest="use_indist", action="store_false",
                    help="train on the multi-budget set only (no 18 mW rows)")
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--parameterization", choices=["eps", "x0", "v"], default="eps",
                    help="the denoiser's target (eps: the reference's)")
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    from ..data.generators import nu_dataset_extension
    from ..data.loaders import NU_P_REF, TRAIN_RATIO
    from ..tasks import CKPT_CONFIG_KEYS, TASKS
    from ._cli import device_from_args, overrides, print_evals, train_and_save

    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS["nu_budget"]
    w, h, p_ref = 400.0, 400.0, NU_P_REF

    parts = [load_budget_rows(args.budget_dataset, w, h)]
    if args.use_indist:
        raw_i = read_rows(args.indist, 12)
        raw_i = raw_i[: int(raw_i.shape[0] * TRAIN_RATIO)]     # the training split
        parts.append(np.concatenate([raw_i, np.full((raw_i.shape[0], 1), 18.0)], axis=1))
    base = np.concatenate(parts)
    rows = np.concatenate([base, nu_dataset_extension(base, times=args.times, seed=args.seed)])
    X, Y = normalize_rows(rows, w, h, p_ref)
    budgets = sorted(set(np.round(rows[:, 12], 3)))
    print(f"train rows: {X.shape[0]} ({base.shape[0]} base x{args.times + 1}; "
          f"{len(budgets)} budgets {budgets[0]}..{budgets[-1]} mW)")

    cfg_d = {"K": 3, "P_sum": 18.0, "width": w, "height": h, "p_ref": p_ref}
    model = task.build_model(cfg_d)
    cfg = dataclasses.replace(task.train_config, parameterization=args.parameterization,
                              **overrides(epochs=args.epochs, lr=args.lr, seed=args.seed,
                                          grad_clip=args.grad_clip,
                                          milestones=tuple(args.milestones)
                                          if args.milestones else None))
    y_shift = Y.mean(axis=0) if args.center else np.zeros(Y.shape[1])
    dataset_config = dict(cfg_d)
    if args.y_scale != 1.0:
        dataset_config["y_scale"] = args.y_scale
    if args.center:
        dataset_config["y_shift"] = [float(v) for v in y_shift]
    if args.parameterization != "eps":
        dataset_config["parameterization"] = args.parameterization
    params, sched = train_and_save(args.out, model, X, (Y - y_shift) * args.y_scale, cfg, dev, {
        "task": "nu_budget", "budget_dataset": args.budget_dataset,
        "augmented_times": args.times, "config": dataclasses.asdict(cfg),
        "dataset_config": dataset_config})

    for name, path in (("in-dist", args.indist), ("ood", args.ood)):
        d = task.load(path)
        d.config.update({k: dataset_config[k] for k in CKPT_CONFIG_KEYS if k in dataset_config})
        print_evals(task, params, sched, d, args.omegas, split=name)


if __name__ == "__main__":
    main()

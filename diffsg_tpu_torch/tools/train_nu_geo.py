"""Train the universal NU DDPM (``nu_geo``: budget- and field-conditioned)
and evaluate it.

Counterpart of the JAX package's ``tools/train_nu_geo.py``, with its flags;
``--cpu`` runs on the CPU, and the default is the CUDA card. The condition
carries ``[P_sum / 18, W / 400, H / 400]``, and the rows mix fields and
budgets (``make_datasets nu-geo``, 15 columns; 400 m and 18 and 30 mW left
out), so one checkpoint serves any budget on any rectangle. Coordinates and
labels are normalized by each row's own field and budget, centered per
column, scaled by ``--y-scale``; the rigid-motion augmentation runs per
(W, H) group, so that every motion stays inside its row's field.

    python -m diffsg_tpu_torch.tools.make_datasets nu-geo \\
        --out datasets/3u_geo200-600_10000samples.csv
    python -m diffsg_tpu_torch.tools.train_nu_geo --out build/ddpm_nu_geo
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ._cli import add_device_args, read_rows, reference_csv


def load_geo_rows(csv_path: str) -> np.ndarray:
    """The 15-column mixed-geometry CSV as raw rows (the augmenter takes raw
    coordinates; the P_sum, W and H columns ride along)."""
    return read_rows(csv_path, 15)


def normalize_rows_geo(raw: np.ndarray, p_ref: float = 18.0, w_ref: float = 400.0,
                       h_ref: float = 400.0) -> Tuple[np.ndarray, np.ndarray]:
    """Raw 15-column rows -> (X with the [P / p_ref, W / w_ref, H / h_ref]
    features, Y normalized by the row's own field and budget)."""
    P_row, W_row, H_row = raw[:, 12:13], raw[:, 13:14], raw[:, 14:15]
    X = raw[:, :6].astype(float).copy()
    X[:, 0::2] /= W_row
    X[:, 1::2] /= H_row
    X = np.concatenate([X, P_row / p_ref, W_row / w_ref, H_row / h_ref], axis=1)
    Y = raw[:, 6:11].astype(float).copy()
    Y[:, 0:1] /= W_row
    Y[:, 1:2] /= H_row
    Y[:, 2:] /= P_row
    return X, Y


def assemble_training_rows(geo_paths: Sequence[str], budget_path: Optional[str] = None,
                           indist_path: Optional[str] = None, train_ratio: float = 0.7,
                           budget_repeat: int = 1, ref_repeat: int = 1) -> np.ndarray:
    """The training rows in the 15-column layout ``[q x 6, L x 2, P x 3,
    rate, P_sum, W, H]``: the mixed-geometry CSVs as they are; the 13-column
    multi-budget CSV (``budget_path``) at W = H = 400, tiled
    ``budget_repeat`` times; the first ``train_ratio`` of the 12-column
    reference split (``indist_path``) at P = 18, W = H = 400, tiled
    ``ref_repeat`` times."""
    parts = [load_geo_rows(p) for p in geo_paths]
    if budget_path:
        raw_b = read_rows(budget_path, 13)
        part = np.concatenate([raw_b, np.full((raw_b.shape[0], 2), 400.0)], axis=1)
        parts.append(np.tile(part, (budget_repeat, 1)))
    if indist_path:
        raw_i = read_rows(indist_path, 12)
        raw_i = raw_i[: int(raw_i.shape[0] * train_ratio)]
        part = np.concatenate([raw_i, np.tile([18.0, 400.0, 400.0], (raw_i.shape[0], 1))], axis=1)
        parts.append(np.tile(part, (ref_repeat, 1)))
    return np.concatenate(parts)


def augment_geo(raw: np.ndarray, times: int, seed: int) -> np.ndarray:
    """Rigid-motion augmentation per (W, H) group, with that group's field:
    widths in ascending order, then heights, each group seeded by ``seed``."""
    from ..data.generators import nu_dataset_extension

    if times <= 0:
        return np.zeros((0, raw.shape[1]))
    parts = []
    for w in np.unique(raw[:, 13]):
        for h in np.unique(raw[:, 14]):
            sel = raw[(raw[:, 13] == w) & (raw[:, 14] == h)]
            if sel.shape[0]:
                parts.append(nu_dataset_extension(sel, times=times, seed=seed, width=int(w),
                                                  height=int(h)))
    return np.concatenate(parts)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geo-dataset", nargs="+",
                    default=["datasets/3u_geo200-600_10000samples.csv"],
                    help="one or more 15-column mixed-geometry CSVs (concatenated)")
    ap.add_argument("--budget-dataset", default=None,
                    help="a 13-column multi-budget CSV, folded in at W = H = 400")
    ap.add_argument("--with-ref-indist", action="store_true",
                    help="also fold in the 18 mW reference training split at P = 18, "
                         "W = H = 400")
    ap.add_argument("--indist", default=reference_csv("3u_18mW_10000samples.csv"))
    ap.add_argument("--ood", default=reference_csv("3u_30mW_1000samples_ood.csv"))
    ap.add_argument("--times", type=int, default=28,
                    help="rigid-motion augmentation copies per base row")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--milestones", type=int, nargs="+", default=None)
    ap.add_argument("--out", default="ckpts/ddpm_nu_geo")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--omegas", type=float, nargs="+", default=[0.06, 0.125, 0.25, 0.5])
    ap.add_argument("--y-scale", type=float, default=8.0)
    ap.add_argument("--no-center", dest="center", action="store_false")
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--proj-dim", type=int, default=None,
                    help="denoiser width (default: the NU net's 32)")
    ap.add_argument("--dims", type=int, nargs="+", default=None,
                    help="denoiser stage widths, e.g. 64 32 16")
    ap.add_argument("--ref-repeat", type=int, default=1,
                    help="repeat factor for the --with-ref-indist rows")
    ap.add_argument("--budget-repeat", type=int, default=1,
                    help="repeat factor for the --budget-dataset rows")
    ap.add_argument("--init-from", default=None,
                    help="start from this nu_geo checkpoint's weights; its proj_dim, dims, "
                         "y_shift and y_scale are kept")
    ap.add_argument("--warmup-epoch", type=int, default=None,
                    help="the EMA warm-up epochs (0 for fine-tunes)")
    ap.add_argument("--parameterization", choices=["eps", "x0", "v"], default=None,
                    help="the denoiser's target (default eps; with --init-from, the donor's)")
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    from ..data.loaders import NU_P_REF, TRAIN_RATIO
    from ..tasks import CKPT_CONFIG_KEYS, TASKS
    from ..utils import load_checkpoint
    from ._cli import device_from_args, overrides, print_evals, train_and_save

    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS["nu_geo"]
    p_ref, w_ref, h_ref = NU_P_REF, 400.0, 400.0

    base = assemble_training_rows(
        args.geo_dataset, budget_path=args.budget_dataset,
        indist_path=args.indist if args.with_ref_indist else None, train_ratio=TRAIN_RATIO,
        budget_repeat=args.budget_repeat, ref_repeat=args.ref_repeat)
    rows = np.concatenate([base, augment_geo(base, times=args.times, seed=args.seed)])
    X, Y = normalize_rows_geo(rows, p_ref, w_ref, h_ref)
    print(f"train rows: {X.shape[0]} ({base.shape[0]} base x{args.times + 1}; "
          f"{len(np.unique(rows[:, 13]))} widths x {len(np.unique(rows[:, 14]))} heights x "
          f"{len(np.unique(rows[:, 12]))} budgets)")

    cfg_d = {"K": 3, "P_sum": 18.0, "width": w_ref, "height": h_ref, "p_ref": p_ref,
             "w_ref": w_ref, "h_ref": h_ref}
    init_params, d_cfg = None, {}
    if args.init_from:
        donor = load_checkpoint(args.init_from, device="cpu")
        init_params = donor["params"]
        d_cfg = donor["metadata"].get("dataset_config", {})
        for k in ("proj_dim", "dims"):
            if k in d_cfg:
                cfg_d[k] = tuple(d_cfg[k]) if k == "dims" else d_cfg[k]
        donor_param = d_cfg.get("parameterization", "eps")
        if args.parameterization is None:
            args.parameterization = donor_param
        elif args.parameterization != donor_param:
            print(f"WARNING: fine-tuning a {donor_param!r} donor under a "
                  f"{args.parameterization!r} loss (explicit override)")
    if args.parameterization is None:
        args.parameterization = "eps"
    if args.proj_dim is not None:
        cfg_d["proj_dim"] = args.proj_dim
    if args.dims is not None:
        cfg_d["dims"] = tuple(args.dims)
    model = task.build_model(cfg_d)
    cfg = dataclasses.replace(task.train_config, parameterization=args.parameterization,
                              **overrides(epochs=args.epochs, lr=args.lr, seed=args.seed,
                                          grad_clip=args.grad_clip,
                                          warmup_epoch=args.warmup_epoch,
                                          milestones=tuple(args.milestones)
                                          if args.milestones else None))
    if args.init_from and "y_shift" in d_cfg:
        # A fine-tune keeps the donor's output normalization: the warm
        # weights' target space.
        y_shift = np.asarray(d_cfg["y_shift"])
        args.y_scale = float(d_cfg.get("y_scale", args.y_scale))
    else:
        y_shift = Y.mean(axis=0) if args.center else np.zeros(Y.shape[1])
    dataset_config = dict(cfg_d)
    if args.y_scale != 1.0:
        dataset_config["y_scale"] = args.y_scale
    if args.center:
        dataset_config["y_shift"] = [float(v) for v in y_shift]
    if args.parameterization != "eps":
        dataset_config["parameterization"] = args.parameterization
    params, sched = train_and_save(args.out, model, X, (Y - y_shift) * args.y_scale, cfg, dev, {
        "task": "nu_geo", "init_from": args.init_from, "geo_dataset": args.geo_dataset,
        "budget_dataset": args.budget_dataset, "with_ref_indist": args.with_ref_indist,
        "augmented_times": args.times, "config": dataclasses.asdict(cfg),
        "dataset_config": dataset_config}, init_params=init_params)

    for name, path in (("in-dist", args.indist), ("ood", args.ood)):
        d = task.load(path)
        d.config.update({k: dataset_config[k] for k in CKPT_CONFIG_KEYS if k in dataset_config})
        print_evals(task, params, sched, d, args.omegas, split=name)


if __name__ == "__main__":
    main()

"""Train the NU DDPM on rigid-motion-augmented rows and evaluate it.

Counterpart of the JAX package's ``tools/train_nu_augmented.py``, with its
flags; ``--cpu`` runs on the CPU, and the default is the CUDA card. The
training split of ``--dataset`` gains ``--times`` copies of its rows,
translated or flipped and rotated (the rate is invariant); the test splits
stay as they are. With ``--y-scale`` or ``--center`` the labels are
centered and scaled and the evaluation takes the ``nu_direct`` decode,
which inverts both.

    python -m diffsg_tpu_torch.tools.train_nu_augmented \\
        --dataset reference/datasets/3u_18mW_10000samples.csv --times 32 \\
        --y-scale 8 --center --out build/ddpm_nu_3u_aug
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional

import numpy as np

from ._cli import add_device_args, read_rows, reference_csv


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default=reference_csv("3u_18mW_10000samples.csv"))
    ap.add_argument("--ood", default=reference_csv("3u_30mW_1000samples_ood.csv"))
    ap.add_argument("--times", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--out", default="ckpts/ddpm_nu_3u_aug")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--omegas", type=float, nargs="+", default=[500.0, 2000.0])
    ap.add_argument("--y-scale", type=float, default=1.0,
                    help="train on y_scale * labels and evaluate with the nu_direct decode")
    ap.add_argument("--center", action="store_true",
                    help="subtract the training labels' per-column mean before --y-scale; "
                         "the nu_direct decode adds it back (config['y_shift'])")
    ap.add_argument("--grad-clip", type=float, default=None)
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    from ..data import load_nu
    from ..data.generators import nu_dataset_extension
    from ..tasks import NU, NU_DIRECT
    from ._cli import device_from_args, print_evals, train_and_save

    args = parse_args(argv)
    dev = device_from_args(args)
    td = load_nu(args.dataset)
    cfg_d = td.config
    P, w, h = cfg_d["P_sum"], cfg_d["width"], cfg_d["height"]

    # The raw rows of the training split, augmented.
    raw = read_rows(args.dataset, 12)
    n_train = td.X_train.shape[0]
    ext = nu_dataset_extension(raw[:n_train], times=args.times, seed=args.seed)
    raw_train = np.concatenate([raw[:n_train], ext])

    X = raw_train[:, :6].astype(float).copy()
    Y = raw_train[:, 6:11].astype(float).copy()
    X[:, 0::2] /= w
    X[:, 1::2] /= h
    Y[:, 0] /= w
    Y[:, 1] /= h
    Y[:, 2:] /= P
    print(f"augmented train set: {X.shape[0]} rows")

    model = NU.build_model(cfg_d)
    cfg = dataclasses.replace(NU.train_config, epochs=args.epochs, seed=args.seed,
                              grad_clip=args.grad_clip)
    y_shift = Y.mean(axis=0) if args.center else np.zeros(Y.shape[1])
    dataset_config = dict(cfg_d)
    if args.y_scale != 1.0:
        dataset_config["y_scale"] = args.y_scale
    if args.center:
        dataset_config["y_shift"] = [float(v) for v in y_shift]
    params, sched = train_and_save(args.out, model, X, (Y - y_shift) * args.y_scale, cfg, dev,
                                   {"augmented_times": args.times,
                                    "dataset_config": dataset_config}, log_every=50)

    # Centered labels take the shift-inverting nu_direct decode even at
    # y_scale 1 (the legacy batch-global decode is not shift-invariant).
    task = NU_DIRECT if (args.y_scale != 1.0 or args.center) else NU
    for name, path in (("in-dist", args.dataset), ("ood", args.ood)):
        d = task.load(path)
        if args.y_scale != 1.0:
            d.config["y_scale"] = args.y_scale
        if args.center:
            d.config["y_shift"] = dataset_config["y_shift"]
        print_evals(task, params, sched, d, args.omegas, split=name)


if __name__ == "__main__":
    main()

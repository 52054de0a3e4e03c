"""Make the DiffSG datasets: CO, MSR and NU oracle CSVs.

Counterpart of the JAX package's ``tools/make_datasets.py``, with its
subcommands, flags and recipes; the files are byte for byte the ones that
tool writes from the same arguments. The rows come from
``data/datasets.py``, on the host (NumPy and the native oracles of
``native/``, built by ``g++``); a flag left out takes that module's default.

    python -m diffsg_tpu_torch.tools.make_datasets co --samples 50000 \\
        --out datasets/3nodes_50000samples_new.csv
    python -m diffsg_tpu_torch.tools.make_datasets msr --samples 10000 --channels 80 \\
        --power 20 --labels wf --out datasets/80c_20w_wf_10000samples.csv
    python -m diffsg_tpu_torch.tools.make_datasets nu --samples 1000 --power 18 \\
        --out datasets/3u_18mW_1000samples.csv
    python -m diffsg_tpu_torch.tools.make_datasets nu-budget \\
        --out datasets/3u_budget9-36_10000samples.csv
    python -m diffsg_tpu_torch.tools.make_datasets nu-geo \\
        --out datasets/3u_geo200-600_10000samples.csv
"""

from __future__ import annotations

import argparse
import logging
import pathlib
import time
from typing import List, Optional

from ..data.datasets import make_rows, write_csv


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="task", required=True)

    co = sub.add_parser("co", argument_default=argparse.SUPPRESS)
    co.add_argument("--samples", type=int)
    co.add_argument("--nodes", type=int)
    co.add_argument("--step", type=float)
    co.add_argument("--seed", type=int)
    co.add_argument("--out", required=True)

    msr = sub.add_parser("msr", argument_default=argparse.SUPPRESS)
    msr.add_argument("--samples", type=int)
    msr.add_argument("--channels", type=int)
    msr.add_argument("--power", type=float)
    msr.add_argument("--gmin", type=float)
    msr.add_argument("--gmax", type=float)
    msr.add_argument("--seed", type=int)
    msr.add_argument("--labels", choices=["lrh", "wf"],
                     help="lrh = the reference's gradient-ascent labels; wf = exact feasible "
                          "waterfilling labels (the same gains for the same seed)")
    msr.add_argument("--out", required=True)

    nu = sub.add_parser("nu", argument_default=argparse.SUPPRESS)
    nu.add_argument("--samples", type=int)
    nu.add_argument("--power", type=float)
    nu.add_argument("--width", type=float)
    nu.add_argument("--height", type=float)
    nu.add_argument("--grid-step", type=float)
    nu.add_argument("--seed", type=int)
    nu.add_argument("--native", action="store_true")
    nu.add_argument("--no-native", dest="native", action="store_false")
    nu.add_argument("--legacy-sinr", action="store_true")
    nu.add_argument("--out", required=True)

    # Multi-budget NU training set: a per-sample budget from a grid, stored
    # as a 13th column [q x 6, L x 2, P x 3, rate, P_sum]. The eval budgets
    # 18 and 30 are left out of the grid by default.
    nub = sub.add_parser("nu-budget", argument_default=argparse.SUPPRESS)
    nub.add_argument("--samples", type=int)
    nub.add_argument("--budget-min", type=float)
    nub.add_argument("--budget-max", type=float)
    nub.add_argument("--budget-step", type=float)
    nub.add_argument("--exclude-budgets", type=float, nargs="*")
    nub.add_argument("--grid-step", type=float)
    nub.add_argument("--seed", type=int)
    nub.add_argument("--out", required=True)

    # Mixed-geometry and mixed-budget NU training set for nu_geo: a
    # per-sample field (W, H) and budget, stored as trailing columns [q x 6,
    # L x 2, P x 3, rate, P_sum, W, H]. 400 m and the budgets 18 and 30 are
    # left out by default.
    nug = sub.add_parser("nu-geo", argument_default=argparse.SUPPRESS)
    nug.add_argument("--samples", type=int)
    nug.add_argument("--geom-min", type=float)
    nug.add_argument("--geom-max", type=float)
    nug.add_argument("--geom-step", type=float)
    nug.add_argument("--exclude-geoms", type=float, nargs="*")
    nug.add_argument("--budget-min", type=float)
    nug.add_argument("--budget-max", type=float)
    nug.add_argument("--budget-step", type=float)
    nug.add_argument("--exclude-budgets", type=float, nargs="*")
    nug.add_argument("--grid-step", type=float)
    nug.add_argument("--focus-frac", type=float,
                     help="share of the samples drawn from the focus geometry range, "
                          "interleaved at random (the rest uniform over the full grid)")
    nug.add_argument("--focus-geom-min", type=float)
    nug.add_argument("--focus-geom-max", type=float)
    nug.add_argument("--focus-geom-step", type=float,
                     help="geometry grid step inside the focus range (default: --geom-step)")
    nug.add_argument("--seed", type=int)
    nug.add_argument("--out", required=True)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> pathlib.Path:
    """Write the CSV that ``argv`` asks for; return its path."""
    kw = vars(parse_args(argv))
    kind, out = kw.pop("task"), kw.pop("out")
    t0 = time.time()
    rows = make_rows(kind, **kw)
    out = write_csv(out, rows)
    print(f"wrote {out} ({len(rows)} samples) in {time.time() - t0:.1f}s")
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="  %(message)s")
    main()

"""Convert a 12-col NU CSV (``[q x 6, L x 2, P x 3, rate]``, fixed-budget
generator output) into the 15-col mixed-geometry layout ``train_nu_geo``
consumes, by appending the generating ``[P_sum, W, H]`` as trailing
columns.

Counterpart of the JAX package's ``tools/nu12_to_geo15.py``, with its flags
and checks (``--cpu`` is accepted as by the port's other CLIs: the
conversion uses no device). It reads with NumPy (``np.loadtxt``, correctly
rounded) and writes as ``pandas.DataFrame.to_csv(header=False,
index=False)`` does: each float64 as Python's shortest ``repr``, NaN as an
empty field.

    python -m diffsg_tpu_torch.tools.nu12_to_geo15 --inp datasets/3u_18mW_fresh4000.csv \\
        --power 18 --width 400 --height 400 --out datasets/3u_18mW400_fresh4000_geo.csv
"""

from __future__ import annotations

import argparse
import math
from typing import List, Optional

import numpy as np

from ..data.loaders import _read_csv


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inp", required=True)
    ap.add_argument("--power", type=float, required=True)
    ap.add_argument("--width", type=float, default=400.0)
    ap.add_argument("--height", type=float, default=400.0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="accepted as by the port's other CLIs; the conversion runs on the host "
                         "either way")
    return ap.parse_args(argv)


def _field(v: float) -> str:
    return "" if math.isnan(v) else repr(v)


def write_rows(path: str, rows: np.ndarray) -> None:
    """``rows`` as ``to_csv(header=False, index=False)`` writes a float64
    frame."""
    with open(path, "w", newline="") as f:
        for r in rows.tolist():
            f.write(",".join(_field(v) for v in r) + "\n")


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    raw = _read_csv(args.inp)
    assert raw.shape[1] == 12, f"expected 12 cols, got {raw.shape[1]}"
    # The claimed config must match the CSV's generating config: a wrong
    # --power/--width/--height mislabels every row's conditioning and its
    # per-row normalization downstream.
    x_max, y_max = raw[:, 0:6:2].max(), raw[:, 1:6:2].max()
    p_max = raw[:, 8:11].sum(axis=1).max()
    assert x_max <= args.width * 1.001, \
        f"user x-coords reach {x_max:.1f} > claimed width {args.width}"
    assert y_max <= args.height * 1.001, \
        f"user y-coords reach {y_max:.1f} > claimed height {args.height}"
    assert p_max <= args.power * 1.001, \
        f"row power sums reach {p_max:.3f} > claimed budget {args.power}"
    tail = np.tile([args.power, args.width, args.height], (raw.shape[0], 1))
    out = np.concatenate([raw, tail], axis=1)
    write_rows(args.out, out)
    print(f"wrote {args.out} ({out.shape[0]} rows, 15 cols)")
    return out


if __name__ == "__main__":
    main()

"""Evaluate a ``nu_geo`` (universal NU) checkpoint over the five headline
configurations: one JSON line per (config, omega), then each config's best
omega.

Counterpart of the JAX package's ``tools/eval_nu_geo.py``, with its flags;
``--cpu`` runs on the CPU (the default is the CUDA card). The two 400x400
configurations read the reference repository's datasets
(``_cli.reference_csv``) and are skipped, with one line on stderr, when
those are absent; the three unseen-geometry sets are made in ``datasets/``
where missing.

    python -m diffsg_tpu_torch.tools.eval_nu_geo --ckpt ckpts/ddpm_nu_geo --omegas 0.06 0.25
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from ..data import ensure_datasets
from ..tasks import TASKS, evaluate, merge_ckpt_config
from ..utils import load_checkpoint, tree_from_state
from ._cli import add_device_args, device_from_args
from .headline import (CSV200, CSV480, CSV600, GEO200, GEO480, GEO600, NU18, NU30, csv_path,
                       limit_data)

#: (label, csv, reference file?, load kwargs): geometry and budget for the
#: generated sets; the reference CSVs carry theirs in the loader defaults.
CONFIGS = [
    ("18mW 400x400 (reference test split)", NU18, True, {}),
    ("30mW 400x400 (reference OOD split)", NU30, True, {}),
    ("21mW 480x360", CSV480, False, GEO480),
    ("33mW 600x600", CSV600, False, GEO600),
    ("12mW 200x200", CSV200, False, GEO200),
]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="ckpts/ddpm_nu_geo")
    ap.add_argument("--omegas", type=float, nargs="+", default=[0.06, 0.125, 0.25, 0.5])
    ap.add_argument("--limit", type=int, default=None,
                    help="cap eval rows per config (full split by default)")
    ap.add_argument("--ema", action="store_true",
                    help="evaluate the checkpoint's EMA weights instead of the raw params")
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Print and return the JSON lines."""
    args = parse_args(argv)
    dev = device_from_args(args)
    ensure_datasets([csv for _, csv, ref, _ in CONFIGS if not ref])
    task = TASKS["nu_geo"]
    ck = load_checkpoint(args.ckpt, device=dev, training=args.ema)
    params = tree_from_state(ck["ema"].params) if args.ema else ck["params"]
    out = []
    for label, csv, ref, kw in CONFIGS:
        path = csv_path(csv, ref)
        if ref and not os.path.exists(path):
            print(f"eval_nu_geo: skipped {label!r}: the reference dataset {path} is absent",
                  file=sys.stderr, flush=True)
            continue
        d = task.load(path, **kw)
        merge_ckpt_config(d.config, ck.get("metadata"))
        limit_data(d, args.limit)
        best = None
        for om in args.omegas:
            m = evaluate(task, params, ck["sched"], d, omega=om)
            out.append({"config": label, "omega": om, **m})
            print(json.dumps(out[-1]), flush=True)
            if best is None or m["less_ratio"] > best[1]:
                best = (om, m["less_ratio"])
        out.append({"config": label, "best_omega": best[0], "best_less_ratio": best[1]})
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()

"""Dump per-sample denoise trajectories to CSV.

Counterpart of the JAX package's ``tools/dump_trajectory.py``, with its
flags; ``--cpu`` runs on the CPU (the default is the CUDA card). The test
split is sampled with ``tasks.sample_solutions(..., record_trace=True)``,
every step of each batch's trajectory decoded (``utils.trace.decode_trace``)
and the rows written header-less, one per sample, T * D wide.

    python -m diffsg_tpu_torch.tools.dump_trajectory --task co --ckpt ckpts/ddpm_co \\
        --dataset datasets/3nodes_50000samples_new.csv --out build/co_denoise_path.csv \\
        --limit 512
"""

from __future__ import annotations

import argparse
import pathlib
from typing import List, Optional

import numpy as np

from ..tasks import TASKS, sample_solutions
from ..utils import load_checkpoint
from ..utils.trace import decode_trace
from ._cli import add_device_args, device_from_args


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=["msr", "co", "nu"], required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--omega", type=float, default=500.0)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Write the trajectories; return the rows written."""
    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS[args.task]
    data = task.load(args.dataset)
    ck = load_checkpoint(args.ckpt, device=dev)
    X = data.X_test[:args.limit] if args.limit else data.X_test
    _, traces = sample_solutions(task, ck["params"], ck["sched"], X, data.config,
                                 omega=args.omega, seed=args.seed, record_trace=True)
    rows = np.concatenate([decode_trace(args.task, t, data.config) for t in traces])
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savetxt(out, rows, delimiter=",")
    print(f"Trajectory generating finished, {rows.shape[0]} samples stored "
          f"({rows.shape[1]} cols) -> {out}")
    return rows


if __name__ == "__main__":
    main()

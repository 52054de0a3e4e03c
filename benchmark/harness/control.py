"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set from.

For each seed, the requests a run of the cell would compare (the seed's
own conditions and noise, at the cell's sizes) are served by the program
through the same Solver, buckets and graphs as the timed path, and
answered by the reference in float32 (what a run compares with) and, in
place of the program, by the reference with every product's operands
rounded to TF32 (``tf32``: the control, the nearest precision below the
configuration's float32), to bfloat16 (``bf16``), or summed in float64
(``f64sum``: a witness of float32 rounding alone). One line of JSON a
seed:

    python -m benchmark.harness.control --workload msr3c_t100.batch8k --seeds 1,2,3

The program's gaps are the lower readings, the control's the upper ones.
"""

from __future__ import annotations

import argparse
import json
import sys
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from . import correct
from . import traffic as gen
from ..reference.unet import round_mantissa, tf32_matmul

VARIANTS = {
    "tf32": tf32_matmul,
    "bf16": lambda a, b: torch.matmul(round_mantissa(a, 7), round_mantissa(b, 7)),
    # float32 operands, products summed in float64: a second float32
    # reference that rounds differently, a witness of how far float32
    # rounding alone moves the answers.
    "f64sum": lambda a, b: torch.matmul(a.double(), b.double()).float(),
}


def checked_requests(cell_traffic: Dict, seed: int, conditions, seconds: float) -> List:
    """The requests a run of this seed compares: in a closed loop the first
    ``check_requests``; in an open loop a sample of the window's schedule
    drawn as ``correct.sample`` draws it."""
    k = cell_traffic["check_requests"]
    if cell_traffic["loop"] == "closed":
        pool = gen.closed_pool(cell_traffic, seed, conditions)
        it = gen.closed_requests(cell_traffic, seed, pool)
        return [next(it) for _ in range(k)]
    window, _ = gen.open_schedule(cell_traffic, seconds, seed, conditions,
                                  cell_traffic["profile_requests"])
    answered = [SimpleNamespace(index=r.index, rows=r.rows, ok=True) for r in window]
    return [window[d.index] for d in correct.sample(answered, k, seed)]


def readings(workload: str, seeds: List[int], seconds: float, device: torch.device,
             overrides: Optional[Dict] = None, variants=("tf32",)) -> List[Dict]:
    """Per seed: the program's gaps and each variant's, against the float32
    reference."""
    from ..run import build_server, load_cell

    c = load_cell(workload, overrides)
    _, serve, conditions = build_server(c, device)
    refs = {"program": correct.Reference(c.config, device)}
    refs.update({v: correct.Reference(c.config, device, VARIANTS[v]) for v in variants})
    out = []
    for seed in seeds:
        reqs = checked_requests(c.traffic, seed, conditions, seconds)
        served = [serve(r) for r in reqs]
        ref = refs["program"].answers(reqs)
        line = {"workload": workload, "seed": seed, "requests": len(reqs),
                "rows": int(sum(len(r.X) for r in reqs)),
                "program": correct.gaps(c.config, served, ref)}
        for v in variants:
            line[v] = correct.gaps(c.config, refs[v].answers(reqs), ref)
        out.append(line)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0, help="the window the schedule fills")
    ap.add_argument("--variants", default="tf32,bf16,f64sum")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    variants = tuple(v for v in args.variants.split(",") if v)
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds,
                         torch.device("cuda", 0), variants=variants):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

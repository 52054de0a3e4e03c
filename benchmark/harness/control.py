"""The readings that the limits of ``benchmark/limits/<cell>.json`` are set from.

For each seed, the requests a run of the cell would compare (the seed's
own conditions and noise, at the cell's sizes) are served by the program
through the same Solver, buckets and graphs as the timed path, and
answered by the reference in float32 (what a run compares with) and, in
place of the program, by the reference with every product's operands
rounded to TF32 (``tf32``: the control, the nearest precision below the
configuration's float32), to bfloat16 (``bf16``), or summed in float64
(``f64sum``: a witness of float32 rounding alone). One line of JSON a
seed, with the host-clock time of each request the program served; last a
line with the card's peak memory while the program ran:

    python -m benchmark.harness.control --workload msr3c_t100.batch8k --seeds 1,2,3

A configuration that has no cell yet is read the same way, as a closed loop
of one bucket of ``--rows`` rows, one request compared a seed:

    python -m benchmark.harness.control --config FILE --rows 16384 --seeds 1,2,3

The program's gaps are the lower readings, the control's the upper ones.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import pathlib
import sys
import time
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


def config_cell(config: Dict, rows: int) -> SimpleNamespace:
    """A configuration that has no cell yet, served as a closed loop of one
    bucket of ``rows`` rows; a seed compares its first request."""
    traffic = {"loop": "closed", "rows": rows, "buckets": [rows], "pool": 1,
               "profile_requests": 1, "check_requests": 1}
    return SimpleNamespace(cell={"name": config["name"]}, config=config, traffic=traffic,
                           task=importlib.import_module(f"benchmark.reference.{config['task']}"))


def readings(c: SimpleNamespace, seeds: List[int], seconds: float, device: torch.device,
             variants=("tf32",)) -> List[Dict]:
    """Per seed of the loaded cell ``c``: the program's gaps and each
    variant's, against the float32 reference, and the program's service
    times; last the card's peak memory while the program ran. The program
    serves every seed first; the references run once it is freed."""
    from ..run import build_server, warm_up

    solver, serve, conditions = build_server(c, device)
    warm_up(solver, serve, conditions, c.config, c.traffic, seeds[0], device)
    reqs, served, ms = {}, {}, {}
    for seed in seeds:
        reqs[seed] = checked_requests(c.traffic, seed, conditions, seconds)
        served[seed], ms[seed] = [], []
        for r in reqs[seed]:
            t = time.perf_counter()
            served[seed].append(serve(r))
            ms[seed].append(1e3 * (time.perf_counter() - t))
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else None
    del solver, serve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    refs = {"program": correct.Reference(c.config, device)}
    refs.update({v: correct.Reference(c.config, device, VARIANTS[v]) for v in variants})
    name = c.cell["name"]
    out = []
    for seed in seeds:
        ref = refs["program"].answers(reqs[seed])
        line = {"workload": name, "seed": seed, "requests": len(reqs[seed]),
                "rows": int(sum(len(r.X) for r in reqs[seed])), "service_ms": ms[seed],
                "program": correct.gaps(c.config, served[seed], ref)}
        for v in variants:
            line[v] = correct.gaps(c.config, refs[v].answers(reqs[seed]), ref)
        out.append(line)
    out.append({"workload": name, "memory_peak_bytes": peak})
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from ..run import RunError, forbidden_modules, load_cell, load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload")
    which.add_argument("--config", help="a configuration file that has no cell yet")
    ap.add_argument("--rows", type=int, help="with --config: the rows of its one bucket")
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=10.0, help="the window the schedule fills")
    ap.add_argument("--variants", default="tf32,bf16,f64sum")
    args = ap.parse_args(argv)
    if args.config and not args.rows:
        ap.error("--config needs --rows")
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    try:
        c = (load_cell(args.workload) if args.workload
             else config_cell(load_config(pathlib.Path(args.config)), args.rows))
        lines = readings(c, [int(s) for s in args.seeds.split(",")], args.seconds,
                         torch.device("cuda", 0), tuple(v for v in args.variants.split(",") if v))
    except (RunError, OSError) as e:
        print(f"control: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"control: JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 2
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

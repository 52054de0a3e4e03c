"""The knee sweep of an open-loop cell: the highest rate served without a
growing backlog, from which the traffic file's fixed ``rate_per_s`` is set.

One process sets up the cell's Solver and graphs once, then serves the
cell's open loop at each rate for ``--seconds`` (the seed's schedule at
that rate) and prints one JSON line a rate: completed requests a second,
p50 and p95 latency from the due time, the backlog at the window's close
(requests due but not yet started) and how fast the queue wait grew over
the window (ms of wait per s, a least-squares slope).

    python -m benchmark.harness.knee --workload nu3u_ddim3.online --rates 200,400,600
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import numpy as np
import torch

from . import loops
from . import traffic as gen


def sweep(workload: str, rates: List[float], seconds: float, seed: int,
          device: torch.device) -> List[dict]:
    from ..run import build_server, load_cell, warm_up

    c = load_cell(workload)
    solver, serve, conditions = build_server(c, device)
    warm_up(solver, serve, conditions, c.config, c.traffic, seed, device)
    out = []
    for rate in rates:
        traffic = {**c.traffic, "rate_per_s": rate}
        window, _ = gen.open_schedule(traffic, seconds, seed, conditions,
                                      traffic["profile_requests"])
        done, window_s = loops.open_loop(serve, window, seconds, keep=False)
        t0 = done[0].due - window[0].due
        lat = np.array([1e3 * (d.end - d.due) for d in done])
        due = np.array([d.due - t0 for d in done])
        wait = np.array([1e3 * (d.start - d.due) for d in done])
        out.append({"workload": workload, "rate_per_s": rate, "requests": len(done),
                    "completed_per_s": sum(d.ok for d in done) / window_s,
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p95_ms": float(np.percentile(lat, 95)),
                    "backlog_at_close": int(sum(d.start - t0 > seconds for d in done)),
                    "wait_growth_ms_per_s": float(np.polyfit(due, wait, 1)[0]),
                    "service_ms_p50": float(np.median([1e3 * (d.end - d.start) for d in done]))})
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("knee: no CUDA card", file=sys.stderr)
        return 2
    for line in sweep(args.workload, [float(r) for r in args.rates.split(",")], args.seconds,
                      args.seed, torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

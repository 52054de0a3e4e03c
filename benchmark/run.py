"""Run one cell of the benchmark of ``diffsg_tpu_torch`` on the CUDA card.

    python -m benchmark.run --workload msr3c_t100.batch8k --seed 7 --seconds 10 --trace 0

from the root of a checkout. The cell (``workloads`` of ``BENCHMARK.json``)
names a configuration (``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``); each metric is read by
``benchmark/metrics/<name>.py``, and the cell's limits on the compared
numbers are ``benchmark/limits/<cell>.json``. Set-up builds the Solver from
the configuration's checkpoint and captures the CUDA graphs of the traffic's
buckets; then the loop serves for ``--seconds``. With ``--trace 1`` a
bounded span of further requests runs under ``torch.profiler`` and the
per-layer metrics are printed in place of the end-to-end ones. Once the
window has closed and the program is freed, a sample of the answers is
compared with the plain reference (``benchmark.reference``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the same numbers end standard error. Without a card, with fewer cards than
the cell asks for, without the program, or with JAX loaded, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
_CACHE = ROOT / "build" / "benchmark_cache"
# Every build and kernel cache at a fixed path inside the checkout. The
# port's nvcc build is already there (build/diffsg_tpu_torch).
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[_var] = str(_CACHE / _sub)
os.environ["USE_FLAX"] = "0"
_T_MODULE = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import types  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from .harness import correct, loops, trace  # noqa: E402
from .harness import traffic as gen  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "diffsg_tpu")


class RunError(RuntimeError):
    """A run that must print no result."""


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        start = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return uptime - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _T_MODULE


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_reader(name: str):
    """The reader of metric ``name``: ``benchmark/metrics/<name>.py``'s
    ``read``, else, for a quantity split by the end-to-end metric its cells
    report (``device_idle_pct.batch``), the reader of the name before the
    last dot (``device_idle_pct.py``)."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '__')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (``diffsg_tpu_torch`` is not ``diffsg_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_info(device: torch.device) -> Dict:
    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    try:
        q = subprocess.run(["nvidia-smi", f"--id={device.index or 0}",
                            "--query-gpu=power.limit,clocks.max.sm,clocks.sm,temperature.gpu",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=30)
        limit, top, clock, temp = (float(v) for v in q.stdout.strip().split(","))
        info.update(power_limit_w=limit, sm_clock_max_mhz=top, sm_clock_mhz=clock,
                    temperature_c=temp)
    except (OSError, ValueError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def check_program(solver, config: Dict) -> None:
    """The Solver runs what the configuration states: task, widths, number
    of parameters, sampler, schedule length and prediction, dataset
    constants. A multi-task face's model holds the checkpoint's net as
    ``inner``, whose widths are the ones checked."""
    m = config["model"]
    net = getattr(solver.model, "inner", solver.model)
    try:
        got = {"input_dim": net.input_dim, "proj_dim": net.proj_dim, "cond_dim": net.cond_dim,
               "dims": list(net.dims), "n_blocks": net.n_blocks,
               "parameters": sum(p.numel() for p in net.parameters())}
    except AttributeError as e:
        raise RunError(f"the Solver's net {type(net).__name__} has no widths to check: {e}") from e
    if got != m:
        raise RunError(f"the checkpoint's net is {got}, the configuration states {m}")
    if solver.sched.T != config["sampler"]["T"]:
        raise RunError(f"the checkpoint's schedule has T={solver.sched.T}")
    stated = config["sampler"].get("parameterization", "eps")
    served = solver.config.get("parameterization", "eps")
    if served != stated:
        raise RunError(f"the checkpoint's net predicts {served!r}, the configuration states "
                       f"{stated!r}")
    for k, v in config["task_config"].items():
        if solver.config.get(k) != v:
            raise RunError(f"the checkpoint's {k} is {solver.config.get(k)!r}, the "
                           f"configuration states {v!r}")


def solve_kwargs(config: Dict) -> Dict:
    s = config["sampler"]
    kw = {"omega": s["omega"], "sampler": s["kind"]}
    if s["kind"] == "ddim":
        kw["n_steps"] = s["n_steps"]
    return kw


def load_config(path: pathlib.Path) -> Dict:
    """A configuration file, its checkpoint found in the checkout and held
    to the file's SHA-256."""
    config = load_json(path)
    config["checkpoint"] = str(ROOT / config["checkpoint"])
    if correct.checkpoint_sha256(config["checkpoint"]) != config["checkpoint_sha256"]:
        raise RunError(f"{config['checkpoint']} is not the configuration's checkpoint")
    return config


def load_cell(workload: str, overrides: Optional[Dict] = None) -> types.SimpleNamespace:
    """The cell's entry, configuration, traffic (``overrides`` replaces
    traffic parameters: the CPU tests shrink a cell with it), limits and
    the reference's task module, found by their names."""
    spec = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    config = load_config(BENCH / "configs" / f"{cell['config']}.json")
    return types.SimpleNamespace(
        spec=spec, cell=cell, config=config,
        traffic={**load_json(BENCH / "traffic" / f"{cell['traffic']}.json"), **(overrides or {})},
        limits=load_json(BENCH / "limits" / f"{workload}.json")["limits"],
        task=importlib.import_module(f"benchmark.reference.{config['task']}"))


def build_server(c: types.SimpleNamespace, device: torch.device) -> tuple:
    """The system under test, a Solver with the traffic's buckets; returns
    (solver, serve(request) -> answer on the host, conditions(rng, n))."""
    try:
        from diffsg_tpu_torch.serve import Solver
    except ImportError as e:
        raise RunError(f"the program is missing: {e}") from e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = c.config
    solver = Solver.from_checkpoint(config["checkpoint"], task=config["task"], device=device,
                                    backend=config["backend"], buckets=c.traffic["buckets"])
    check_program(solver, config)
    kw = solve_kwargs(config)

    def serve(r: gen.Request) -> np.ndarray:
        return solver.solve(r.X, seed=r.noise_seed, **kw)

    def conditions(rng, n):
        return c.task.conditions(rng, n, config["task_config"])

    return solver, serve, conditions


def warm_up(solver, serve, conditions, config: Dict, traffic: Dict, seed: int,
            device: torch.device) -> None:
    """Capture the graph of every bucket, then replay each once on real rows."""
    solver.warmup(sizes=traffic["buckets"], configs=[solve_kwargs(config)])
    warm = np.random.default_rng([seed % 2 ** 64, 5])
    for b in traffic["buckets"]:
        serve(gen.Request(-1, b, 0.0, conditions(warm, b), 0))
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: torch.device,
             overrides: Optional[Dict] = None) -> Dict:
    """One run of a cell; returns the result line's object."""
    c = load_cell(workload, overrides)
    spec, cell, config, traffic, limits = c.spec, c.cell, c.config, c.traffic, c.limits

    # -- set-up: the program, its graphs, the cell's inputs ------------------------
    solver, serve, conditions = build_server(c, device)
    n_profile = traffic["profile_requests"]
    if traffic["loop"] == "closed":
        pool = gen.closed_pool(traffic, seed, conditions)
        requests = gen.closed_requests(traffic, seed, pool)
        by_index = lambda i: gen.Request(i, traffic["rows"], 0.0, pool[i % len(pool)],  # noqa: E731
                                         gen.noise_seed(seed, i))
    else:
        window, profiled = gen.open_schedule(traffic, seconds, seed, conditions, n_profile)
        by_index = lambda i: window[i]  # noqa: E731
    warm_up(solver, serve, conditions, config, traffic, seed, device)
    gc.collect()
    gc.freeze()
    setup_s = process_age_s()

    # -- the window ---------------------------------------------------------------
    if traffic["loop"] == "closed":
        done, window_s = loops.closed_loop(serve, requests, seconds)
    else:
        done, window_s = loops.open_loop(serve, window, seconds)
    summary, breakdown = None, None
    if traced:
        def traced_span(span):
            if traffic["loop"] == "closed":
                return loops.closed_loop(serve, requests, 0, False, span, n_profile)
            return loops.open_loop(serve, profiled, 0, False, span)

        _, summary = trace.profile(traced_span, device)
        breakdown = {"device_ops": trace.top({k: v[1] for k, v in summary.device_ops.items()}),
                     "idle_gaps": trace.top(summary.idle_gaps)}
    gc.unfreeze()
    dev_info = card_info(device)
    if summary is not None:
        dev_info.update(busy_s=summary.busy_s, window_s=summary.window_s)

    # -- the answers against the reference, once the program is freed ----------------
    del solver, serve
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = correct.sample(done, traffic["check_requests"], seed)
    ref = correct.Reference(config, device).answers([by_index(d.index) for d in checked])
    numbers = correct.gaps(config, [d.answer for d in checked], ref)
    failed = sum(not d.ok for d in done)
    numbers["failed"], numbers["checked"] = failed, len(checked)
    limits = {**limits, "failed": 0}
    numbers_ok = correct.verdict(numbers, limits) and len(checked) > 0

    found = forbidden_modules()
    if found:
        raise RunError(f"JAX or the JAX package is loaded: {', '.join(found)}")

    record = types.SimpleNamespace(
        cell=cell, config=config, traffic=traffic, setup_s=setup_s, window_s=window_s,
        done=[d._replace(answer=None) for d in done], profile=summary)
    metrics = {}
    for m in spec["per_layer" if traced else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = load_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(numbers_ok), "attempted": len(done), "failed": failed,
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # A number that is not finite prints as null (strict JSON has no NaN).
    out["checks"] = {k: [numbers[k] if np.isfinite(numbers[k]) else None, limits[k]]
                     for k in limits}
    out["_log"] = run_log(done, window_s, traffic, numbers, setup_s)
    return out


def run_log(done, window_s: float, traffic: Dict, numbers: Dict, setup_s: float) -> List[str]:
    """The run's counts, for standard error."""
    ok = [d for d in done if d.ok]
    lines = [f"requests sent {len(done)} completed {len(ok)} failed {len(done) - len(ok)} "
             f"rows {sum(d.rows for d in ok)} window_s {window_s:.6f} setup_s {setup_s:.6f}"]
    for b in traffic["buckets"]:
        ms = [1e3 * (d.end - d.start) for d in ok
              if b == min((x for x in traffic["buckets"] if x >= d.rows), default=None)]
        if ms:
            lines.append(f"bucket {b} requests {len(ms)} service_ms p50 {np.median(ms):.6f} "
                         f"mean {np.mean(ms):.6f} max {max(ms):.6f}")
    if traffic["loop"] == "open" and done:
        late = loops.generator_lateness_s(done)
        wait = [d.start - d.due for d in done]
        lines.append(f"generator late_ms p50 {1e3 * np.median(late):.6f} max "
                     f"{1e3 * max(late):.6f} over {len(late)} sends to an idle server; "
                     f"queue wait_ms p50 {1e3 * np.median(wait):.6f} max {1e3 * max(wait):.6f}")
    lines.append(f"compared {numbers['checked']} requests with the reference; scale_gap "
                 f"{numbers['scale_gap']!r}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark on the CUDA card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        spec = load_json(ROOT / "BENCHMARK.json")
        cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
        if cell is None:
            raise RunError(f"no workload {args.workload!r} in BENCHMARK.json")
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"the cell needs {cell['chips']} CUDA card(s); "
                           f"{torch.cuda.device_count()} available")
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0))
    except (RunError, OSError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    emit(out)
    return 0


def emit(out: Dict) -> None:
    """The run's counts and then each compared number with its limit on
    standard error; the result as the last line of standard output."""
    for line in out.pop("_log"):
        print(line, file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())

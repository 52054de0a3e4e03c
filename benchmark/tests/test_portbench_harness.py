"""The harness: its import graph, the traffic generator, the open loop's
latency, the result line, and the card-only end-to-end run."""

import io
import json
import pathlib
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import loops
from benchmark.harness import traffic as gen

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]

#: Each cell shrunk to a size the CPU runs in seconds.
SMALL = {
    "msr3c_t100.batch8k": dict(rows=8, buckets=[8], pool=2, check_requests=1, profile_requests=1),
    "nu3u_ddim3.batch512k": dict(rows=64, buckets=[64], pool=2, check_requests=2,
                                 profile_requests=2),
    "nu3u_ddim3.online": dict(rate_per_s=30.0, rows_max=40, buckets=[8, 64], check_requests=6,
                              profile_requests=3),
    "msr3c_t100.online": dict(rate_per_s=4.0, rows_max=64, buckets=[8, 64], check_requests=6,
                              profile_requests=1),
}
SEED = 2 ** 31 + 12345


def small_run(cell, traced=False, seconds=0.5, device="cpu"):
    return run.run_cell(cell, SEED, seconds, traced, torch.device(device), SMALL[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_import_guard(cell):
    """A whole small run of the cell loads neither JAX nor the JAX package,
    compared by whole top-level names (``diffsg_tpu_torch`` begins with
    ``diffsg_tpu``)."""
    code = (f"import sys, json, torch; from benchmark import run; "
            f"run.run_cell({cell!r}, 7, 0.3, False, torch.device('cpu'), {SMALL[cell]!r}); "
            f"print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "diffsg_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "diffsg_tpu"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffsg_tpu_torchx", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "diffsg_tpu.serve", sys)
    assert run.forbidden_modules() == ["diffsg_tpu.serve"]


def conditions(rng, n):
    return rng.random((n, 3), dtype=np.float32)


def test_open_schedule_repeats_per_seed():
    t = json.loads((ROOT / "benchmark" / "traffic" / "online_msr3c.json").read_text())
    a, pa = gen.open_schedule(t, 10.0, 99, conditions, 5)
    b, pb = gen.open_schedule(t, 10.0, 99, conditions, 5)
    for x, y in zip(a + pa, b + pb):
        assert (x.index, x.rows, x.due, x.noise_seed) == (y.index, y.rows, y.due, y.noise_seed)
        assert np.array_equal(x.X, y.X)
    c, pc = gen.open_schedule(t, 10.0, 2 ** 32 + 3, conditions, 5)
    # Another seed: the same sizes at the same times, other conditions and noise.
    assert [(r.rows, r.due) for r in c + pc] == [(r.rows, r.due) for r in a + pa]
    assert a[-1].due < 10.0 and len(pa) == 5 and pa[0].index == len(a)
    assert not np.array_equal(c[0].X, a[0].X) and c[0].noise_seed != a[0].noise_seed
    assert all(t["rows_min"] <= r.rows <= t["rows_max"] for r in a)


def test_closed_requests_repeat_per_seed():
    t = {"rows": 16, "pool": 3}
    pa, pb = gen.closed_pool(t, 5, conditions), gen.closed_pool(t, 5, conditions)
    assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
    ra = gen.closed_requests(t, 5, pa)
    first = [next(ra) for _ in range(4)]
    assert np.array_equal(first[3].X, pa[0])
    assert len({r.noise_seed for r in first}) == 4
    assert first[1].noise_seed == gen.noise_seed(5, 1) < 2 ** 63
    assert not np.array_equal(gen.closed_pool(t, 6, conditions)[0], pa[0])


def test_open_loop_latency_from_due_time():
    """A stall of the first request delays the second, which was due 10 ms
    in: its latency counts from when it was due, not from when it started."""
    reqs = [gen.Request(0, 1, 0.0, None, 0), gen.Request(1, 1, 0.01, None, 1)]

    def serve(r):
        time.sleep(0.1 if r.index == 0 else 0.001)
        return np.zeros(1)

    done, _ = loops.open_loop(serve, reqs, 0.05)
    second = done[1]
    assert second.start - second.due > 0.08            # it queued behind the stall
    assert second.end - second.due > 0.08 + 0.001
    assert loops.generator_lateness_s(done) == [pytest.approx(done[0].start - done[0].due)]


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    out = small_run("nu3u_ddim3.online", traced)
    buf, err = io.StringIO(), io.StringIO()
    with redirect_stdout(buf), redirect_stderr(err):
        run.emit(out)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    names = {m["name"] for m in SPEC["per_layer" if traced else "end_to_end"]
             if "nu3u_ddim3.online" in m.get("workloads", CELLS)}
    # On the CPU no device operation is traced, so the trace's metrics are silent.
    expect = names - ({"kernels_per_request.online", "device_idle_pct.online"} if traced else set())
    assert set(line["metrics"]) == expect
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == {"max_gap", "mean_gap", "failed"}
    assert err.getvalue().strip().splitlines()[-1].startswith("check failed 0 limit 0")


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    # Past the card's check too: the run needs the program's checkpoint.
    alone = subprocess.run([sys.executable, "-c", "import torch; from benchmark import run; "
                            f"run.run_cell({CELLS[0]!r}, 1, 0.1, False, torch.device('cpu'))"],
                           cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert alone.returncode != 0 and "ckpts/ddpm_msr_3c_T100" in alone.stderr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_small_cell_on_card(card, cell):
    out = run.run_cell(cell, SEED, 0.5, True, card, SMALL[cell])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0

"""The benchmark's ``multi80_proj256`` configuration on the CPU: the
``multi_msr80`` face of a net of ``ckpts/ddpm_multi_80``'s layout (5 slots,
payload 81, an 80-wide canvas, x0 prediction, DDPM T 20) on seeded random
weights, served by the port's ``Solver`` on the ``fused`` backend's
prepared path (the condition prologue with the face's ``pad_cond``; on the
CPU the kernel's plain version) and on ``plain``, against the benchmark's
plain reference (``benchmark.reference``); the counters that the cell's
traced requests read (``x0_steps``, ``decode_candidates``); and the
readers of its two new per-layer metrics on hand-built run records.
"""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import control, correct
from benchmark.harness import traffic as gen
from benchmark.harness.trace import TraceSummary
from benchmark.metrics import counts
from benchmark.reference import multi_msr80
from benchmark.reference.unet import load_arrays
import diffsg_tpu_torch.diffusion.ddpm as ddpm_mod
import diffsg_tpu_torch.serve as serve_mod
import diffsg_tpu_torch.tasks.multi as multi_mod
from diffsg_tpu_torch import obs
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks.multi import unet_multi
from diffsg_tpu_torch.utils.checkpoint import save_checkpoint
from diffsg_tpu_torch.utils.params import params_to_jax

CPU = torch.device("cpu")
CONFIG = json.loads((run.BENCH / "configs" / "multi80_proj256.json").read_text())
CELL = "multi80_proj256.batch16k"
SLOTS = CONFIG["task_config"]["slots"]
#: The two sizes: a small net, and the published widths, whose up path
#: has the six 512 -> 256 blocks of the kernel's widest class.
WIDTHS = {"proj32": (32, (32, 16)), "proj256": (256, (256, 128, 64, 32))}
#: The largest gap to the reference (in units of the 10 W budget) on sound
#: float32 arithmetic. The port and the reference run the same float32
#: operations but not in the same order (the CFG fold, the hoisted
#: projections, the masked statistics, the decoders' batch reductions), so
#: answers differ by rounding, which the x0-to-epsilon conversion amplifies
#: by up to 1 / sqrt(1 - abar) in the last steps. These sizes read 1e-8 to
#: 4e-8; the bound is the one the committed net is held to
#: (benchmark/tests/test_portbench_faces.py), where a row whose best
#: candidate flips on a near-tie of sum rates would read far more: such a
#: flip needs a larger batch than these.
MAX_GAP = 2e-5
#: The largest median over a request's rows of the row's gap: sound float32
#: reads at most 9e-9 here, products with TF32 operands 3.5e-6 and more,
#: so 2e-7 lies some 20x from each.
REQ_MED_GAP = 2e-7


def random_checkpoint(path, proj, dims, seed=0):
    """A checkpoint of the ``ddpm_multi_80`` layout with seeded random
    weights (LayerNorm scales and biases drawn too), the committed net's
    schedule (T 20) and metadata keys."""
    torch.manual_seed(seed)
    net = unet_multi(proj, dims, canvas_dim=80, payload_dim=81, n_slots=len(SLOTS))
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(0.1 * torch.randn_like(p))
    _, betas = load_arrays(str(run.ROOT / CONFIG["checkpoint"]))
    sched = types.SimpleNamespace(betas=torch.as_tensor(betas))
    md = json.loads((run.ROOT / CONFIG["checkpoint"] / "metadata.json").read_text())
    arch = {**md["arch"], "proj_dim": proj, "dims": list(dims)}
    save_checkpoint(str(path), params_to_jax(net), sched=sched,
                    metadata={"task": "multi", "arch": arch, "config": md["config"],
                              "subtask_configs": md["subtask_configs"]})
    cfg = {**CONFIG, "checkpoint": str(path),
           "model": {**CONFIG["model"], "proj_dim": proj, "dims": list(dims),
                     "parameters": sum(p.numel() for p in net.parameters())}}
    return cfg


@pytest.fixture(scope="module", params=list(WIDTHS))
def face(request, tmp_path_factory):
    proj, dims = WIDTHS[request.param]
    cfg = random_checkpoint(tmp_path_factory.mktemp(request.param), proj, dims)
    solvers = {b: Solver.from_checkpoint(cfg["checkpoint"], task="multi_msr80", device="cpu",
                                         backend=b, buckets=(8, 16))
               for b in ("fused", "plain")}
    return request.param, cfg, solvers


def requests(cfg, sizes, seed=3):
    rng = np.random.default_rng(seed)
    return [gen.Request(k, n, 0.0, multi_msr80.conditions(rng, n, cfg["task_config"]),
                        2 ** 40 + k) for k, n in enumerate(sizes)]


def sizes_of(name):
    # The published widths on 8 rows; the small net on three requests in
    # one reference batch, bucketed on the program's side.
    return (8,) if name == "proj256" else (5, 16, 1)


def test_program_agrees_with_the_reference(face):
    """Both backends against the reference: x0 prediction, the face's
    condition, the 11-candidate decoder; the Solver states the widths."""
    name, cfg, solvers = face
    reqs = requests(cfg, sizes_of(name))
    ref = correct.Reference(cfg, CPU).answers(reqs)
    for backend, solver in solvers.items():
        run.check_program(solver, cfg)
        served = [solver.solve(r.X, seed=r.noise_seed, omega=cfg["sampler"]["omega"])
                  for r in reqs]
        assert [a.shape for a in served] == [(n, 80) for n in sizes_of(name)]
        g = correct.gaps(cfg, served, ref)
        assert g["max_gap"] < MAX_GAP and g["req_med_gap"] < REQ_MED_GAP, (backend, g)
        for a in served:
            assert (a >= 0).all() and np.allclose(a.sum(axis=1), 10.0, rtol=1e-5)


def test_fused_prepared_path_runs_pad_cond(face, monkeypatch):
    """The fused Solver takes the prepared path, its prologue fed the
    face's padded ``[one-hot | payload]`` condition."""
    _, cfg, solvers = face
    solver = solvers["fused"]
    seen = []
    real = solver._apply.pad_cond
    monkeypatch.setattr(solver._apply, "pad_cond", lambda c: seen.append(c.shape) or real(c))
    before = obs.counters()["hoisted_steps"]
    solver.solve(requests(cfg, (3,))[0].X, seed=1, omega=0.5)
    assert obs.counters()["hoisted_steps"] - before == 20
    assert seen == [(2 * 8, 81)]     # once a request, on the CFG fold of the 8-row bucket


def test_tf32_fails_the_tolerance(face):
    """The reference with every product's operands rounded to TF32, in the
    program's place, fails ``REQ_MED_GAP``: the comparison sees the
    precision below the configuration's float32."""
    name, cfg, _ = face
    reqs = requests(cfg, sizes_of(name))
    ref = correct.Reference(cfg, CPU).answers(reqs)
    tf32 = correct.Reference(cfg, CPU, control.VARIANTS["tf32"]).answers(reqs)
    g = correct.gaps(cfg, tf32, ref)
    assert g["req_med_gap"] > 10 * REQ_MED_GAP, g


def test_counters_x0_steps_and_decode_candidates(face):
    """A request of the x0 face counts T steps turned into epsilon and 11
    candidates (5 projections, 6 temperatures) for every bucket row."""
    _, cfg, solvers = face
    before = obs.counters()
    solvers["fused"].solve(requests(cfg, (5,))[0].X, seed=2, omega=0.5)
    solvers["plain"].solve(requests(cfg, (16,))[0].X, seed=2, omega=0.5, best_of=2)
    d = {k: obs.counters()[k] - before[k] for k in before}
    assert d["x0_steps"] == 20 + 2 * 20
    assert d["decode_candidates"] == 11 * 8 + 2 * 11 * 16


def test_eps_net_counts_no_x0_step():
    solver = Solver.from_checkpoint(str(run.ROOT / "ckpts" / "ddpm_msr_3c_T100"), task="msr",
                                    device="cpu", backend="fused")
    before = obs.counters()
    solver.solve(np.random.default_rng(0).random((4, 3), dtype=np.float32))
    d = {k: obs.counters()[k] - before[k] for k in before}
    assert d["x0_steps"] == 0 and d["decode_candidates"] == 0 and d["hoisted_steps"] == 100


def test_the_configuration_states_the_committed_net():
    """The file's widths, parameters, prediction and task constants are the
    committed checkpoint's, and the cell serves one bucket of 16,384 rows."""
    c = run.load_config(run.BENCH / "configs" / "multi80_proj256.json")
    solver = Solver.from_checkpoint(c["checkpoint"], task=c["task"], device="cpu",
                                    backend=c["backend"])
    run.check_program(solver, c)
    assert counts.param_count(c["model"]) == c["model"]["parameters"] == 9444464
    cell = run.load_cell(CELL)
    assert cell.traffic["rows"] == 16384 and cell.traffic["buckets"] == [16384]
    assert set(cell.limits) == {"req_med_gap", "rows_q99_gap", "mean_gap"}


# -- the cell itself, shrunk to a size the CPU runs in seconds ----------------------

SMALL = dict(rows=8, buckets=[8], pool=1, check_requests=1, profile_requests=1)
SEED = 2 ** 31 + 23


def step_unchanged(monkeypatch):
    """The middle sampler step returns its state unchanged."""
    real = ddpm_mod._reverse_step

    def step(sched, y_t, i, *a, **k):
        return y_t if i == sched.T // 2 else real(sched, y_t, i, *a, **k)
    monkeypatch.setattr(ddpm_mod, "_reverse_step", step)


def x0_read_as_eps(monkeypatch):
    """The sampler takes the net's x0 output for epsilon."""
    real = serve_mod.cfg_sample
    monkeypatch.setattr(serve_mod, "cfg_sample",
                        lambda *a, **k: real(*a, **{**k, "parameterization": "eps"}))


def wrong_slot(monkeypatch):
    """The face's condition names the MSR-3c slot (0) in place of msr80's."""
    real = multi_mod._CondAdapter.pad_cond

    def pad_cond(self, cond):
        out = real(self, cond)
        out[:, :self.n_slots] = 0.0
        out[:, 0] = 1.0
        return out
    monkeypatch.setattr(multi_mod._CondAdapter, "pad_cond", pad_cond)


def answer_altered(monkeypatch):
    """Each request's first answer has its columns rolled."""
    real = serve_mod.Solver.solve

    def solve(self, X, *a, **k):
        out = real(self, X, *a, **k)
        out[0] = np.roll(out[0], 1)
        return out
    monkeypatch.setattr(serve_mod.Solver, "solve", solve)


#: A fault of the batch statistics (the re-standardization over half the
#: batch, as the other cells are checked for) moves this net's answers by
#: 8e-7 W at most, and leaving the re-standardization out by 5.6e-6 W: the
#: x0 sampler's last step returns the net's x0 estimate, which hardly reads
#: the early state. So it is no fault this cell can show; the two faults of
#: its own path (the x0 conversion, the face's slot) are.
FAULTS = {"sound": None, "step_unchanged": step_unchanged, "x0_read_as_eps": x0_read_as_eps,
          "wrong_slot": wrong_slot, "answer_altered": answer_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_small_cell_is_correct_unless_broken(monkeypatch, fault):
    """A sound run of the cell reads ``correct`` with the committed net and
    the cell's limits; each fault underneath the timed path turns it false.
    The test process has JAX loaded (``tests/conftest.py``), so the run's
    guard against it is lifted here; ``test_cell_loads_no_jax`` checks it."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    if FAULTS[fault]:
        FAULTS[fault](monkeypatch)
    out = run.run_cell(CELL, SEED, 0.2, False, CPU, SMALL)
    assert out["correct"] is (fault == "sound"), out["checks"]
    assert out["failed"] == 0 and set(out["checks"]) == {"req_med_gap", "rows_q99_gap",
                                                         "mean_gap", "failed"}


def test_control_fails_a_limit_where_the_program_passes():
    limits = run.load_cell(CELL).limits
    c = run.load_cell(CELL, SMALL)
    for line in control.readings(c, [SEED, 3], 10.0, CPU)[:-1]:
        assert all(line["program"][k] <= limits[k] for k in limits), line
        assert any(line["tf32"][k] > limits[k] for k in limits), line


def test_cell_loads_no_jax():
    """A small run of the cell in a fresh process loads neither JAX nor the
    JAX package."""
    code = (f"import sys, json, torch; from benchmark import run; "
            f"run.run_cell({CELL!r}, 7, 0.2, False, torch.device('cpu'), {SMALL!r}); "
            f"print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "diffsg_tpu_torch" in top and not top & set(run.FORBIDDEN)


# -- the readers of the cell's new per-layer metrics ---------------------------------

MS = 1_000_000


def wait_span(rid, t0, attrs):
    return [obs.Span("solve", t0 * MS, (t0 + 300) * MS, rid, 0, rid, {"rows": 8, "bucket": 8}),
            obs.Span("solve.wait", (t0 + 10) * MS, (t0 + 290) * MS, rid + 1, rid, rid, attrs)]


RING = (wait_span(100, 0, {"device_sample_ms": 250.0, "device_decode_ms": 9.0})
        + wait_span(110, 400, {"device_sample_ms": 240.0, "device_decode_ms": 1.5})
        + wait_span(120, 800, {"device_sample_ms": 241.0, "device_decode_ms": 2.5})
        + wait_span(130, 1200, {"device_sample_ms": 242.0, "device_decode_ms": 1.0}))


def traced(ops=None, requests=3):
    profile = TraceSummary(1.0, 0.9, ops or {}, 0, {}, requests)
    return types.SimpleNamespace(profile=profile, config=CONFIG,
                                 traffic={"rows": 16384}, done=[])


def test_decode_ms_median_of_the_traced_requests(monkeypatch):
    monkeypatch.setattr(obs, "spans", lambda: RING)
    read = run.load_reader("decode_ms.batch")
    assert read(traced()) == pytest.approx(1.5)
    assert read(traced(requests=2)) == pytest.approx(1.75)
    assert read(types.SimpleNamespace(profile=None)) is None
    # A program whose waits carry no device times (the parent's): silent.
    bare = [s._replace(attrs={}) if s.name == "solve.wait" else s for s in RING]
    monkeypatch.setattr(obs, "spans", lambda: bare)
    assert read(traced()) is None
    monkeypatch.setattr(obs, "spans", lambda: [])
    assert read(traced()) is None


def test_resblock256_roofline_reads_the_256_class_alone():
    """The bound of the ten blocks of output 256 at 2 x 16,384 rows, once a
    step for 3 requests of T 20, over the time of the kernels of that class
    only, however the trace spells their template arguments."""
    read = run.load_reader("resblock256_roofline")
    blocks = [l for l in counts.layers(CONFIG["model"]) if l.kind == "block" and l.dout == 256]
    assert sorted((l.din, l.shortcut) for l in blocks) == [(256, False)] * 4 + [(512, True)] * 6
    work = [counts.resblock_work(l, 2 * 16384) for l in blocks]
    bound = max(sum(w[0] for w in work) / counts.PEAK_F32_FLOPS,
                sum(w[1] for w in work) / counts.PEAK_HBM_BYTES)
    ops = {"void (anonymous namespace)::resblock_wide<32, 256>((anonymous namespace)::A)":
           (600, 0.3),
           "void__anonymous_namespace_::resblock_wide_32__256___anonymous_na": (600, 0.2),
           "void (anonymous namespace)::resblock_wide<32, 128>((anonymous namespace)::A)":
           (180, 0.05),
           "void (anonymous namespace)::resblock_narrow<8>((anonymous namespace)::A)": (240, 0.01),
           "void at::native::elementwise_kernel<128, 2>": (9000, 0.04)}
    assert read(traced(ops)) == pytest.approx(100.0 * 3 * 20 * bound / 0.5)
    assert read(traced({k: v for k, v in ops.items() if "256" not in k})) is None
    assert read(types.SimpleNamespace(profile=None)) is None

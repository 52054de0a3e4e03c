"""The program's spans and counters (``diffsg_tpu_torch.obs``): the span tree
of ``Solver.solve``, recording off by default and on under the profiler, the
shared clock, the ring's bound, the set-up spans.

The file imports no JAX; its card tests run on a machine with only PyTorch
and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_obs.py
"""

import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from diffsg_tpu_torch import obs
from diffsg_tpu_torch.ops import _build
from diffsg_tpu_torch.serve import Solver, device_ms

REPO = pathlib.Path(__file__).resolve().parent.parent
torch.set_num_threads(1)

REQUEST_SPANS = {"solve", *obs.PARENT}
#: (checkpoint, task, backend, solve keywords): the two served configurations.
NETS = {
    "msr": ("ddpm_msr_3c_T100", "msr", "fused", {}),
    "nu": ("ddpm_nu_3u_aug32_s8c", "nu_direct", "mega",
           {"omega": 0.125, "sampler": "ddim", "n_steps": 3}),
}


@pytest.fixture(autouse=True)
def fresh():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


@pytest.fixture(scope="module")
def solvers():
    return {k: Solver.from_checkpoint(str(REPO / "ckpts" / ck), task=task, device="cpu",
                                      backend=backend, buckets=[8, 64])
            for k, (ck, task, backend, _) in NETS.items()}


def conditions(solver, n, seed=0):
    return np.random.default_rng(seed).random((n, solver._C), dtype=np.float32)


def by_request():
    out = {}
    for s in obs.spans():
        if s.request:
            out.setdefault(s.request, {})[s.name] = s
    return out


def check_tree(spans):
    """Every child inside its parent, one request id, siblings apart."""
    ids = {s.id: s for s in spans.values()}
    root = spans["solve"]
    assert root.parent == 0 and root.request == root.id
    for name, parent in obs.PARENT.items():
        if name in spans:
            s, p = spans[name], spans[parent]
            assert s.parent == p.id and s.request == root.id and ids[s.parent] is p
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, name
    for parent in {*obs.PARENT.values()}:
        kids = sorted((s for n, s in spans.items() if obs.PARENT.get(n) == parent),
                      key=lambda s: s.start_ns)
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:])), parent


@pytest.mark.parametrize("net", list(NETS))
def test_solve_span_tree(solvers, net):
    """With ``obs.enable()`` one ``solve`` leaves its tree: the root with its
    rows, bucket and path, and on the CPU every child but ``solve.wait``;
    the root's children cover it, end to end, but for the close."""
    solver, kw = solvers[net], NETS[net][3]
    obs.enable()
    out = solver.solve(conditions(solver, 5), seed=3, **kw)
    (spans,) = by_request().values()
    assert set(spans) == REQUEST_SPANS - {"solve.wait"}
    check_tree(spans)
    assert spans["solve"].attrs == {"rows": 5, "bucket": 8, "path": "eager"}
    assert spans["solve.copy"].attrs == {"bytes": out.nbytes}
    # cond, cond_unnorm and the mask of 8 rows, and one omega.
    C = solver._C
    assert spans["stage.copy"].attrs == {"bytes": 4 * (8 * (2 * C + 1) + 1)}
    kids = [spans[n] for n in ("solve.stage", "solve.launch", "solve.copy")]
    root = spans["solve"]
    assert kids[0].start_ns == root.start_ns
    assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))
    assert sum(k.end_ns - k.start_ns for k in kids) >= 0.95 * (root.end_ns - root.start_ns)


def test_off_by_default_counters_advance(solvers):
    """Off, nothing is recorded, and the counters still count requests, real
    rows and the bucket rows the program computed (the pad)."""
    solver, kw = solvers["nu"], NETS["nu"][3]
    before = obs.counters()
    a = solver.solve(conditions(solver, 5), **kw)
    b = solver.solve(conditions(solver, 20), **kw)
    after = obs.counters()
    assert obs.spans() == [s for s in obs.spans() if s.request == 0]
    d = {k: after[k] - before[k] for k in after}
    assert d["requests"] == 2 and d["rows"] == 25 and d["bucket_rows"] == 8 + 64
    assert d["eager"] == 2 and d["replays"] == 0 and d["captures"] == 0
    assert d["hoisted_steps"] == 0      # mega: no prepared path
    assert d["bytes_out"] == a.nbytes + b.nbytes
    assert d["bytes_in"] == 4 * ((8 + 64) * (2 * solver._C + 1) + 2)
    assert 100.0 * (d["bucket_rows"] - d["rows"]) / d["bucket_rows"] == pytest.approx(
        100.0 * 47 / 72)
    assert d["resblock_launches"] == 0 and d["mega_launches"] == 0   # the CPU: no kernel
    assert {"resblock_launches", "mega_launches"} <= obs.captured().keys()


def test_eager_fused_solves_count_hoisted_steps(solvers):
    """On the CPU's eager path each MSR request (fused, DDPM T=100) runs its
    100 denoiser steps on the prepared path, whatever its bucket."""
    solver = solvers["msr"]
    before = obs.counters()
    for n in (3, 40):
        solver.solve(conditions(solver, n))
    d = {k: obs.counters()[k] - before[k] for k in before}
    assert d["hoisted_steps"] == 2 * solver.sched.T == 200
    assert d["eager"] == 2 and d["replays"] == 0


def test_profiler_turns_recording_on(solvers):
    """Under ``torch.profiler`` the spans are recorded without ``enable``,
    and none of them is an event of the profiler's trace."""
    solver, kw = solvers["nu"], NETS["nu"][3]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.solve(conditions(solver, 3), **kw)
    solver.solve(conditions(solver, 3), **kw)
    (spans,) = by_request().values()
    assert set(spans) == REQUEST_SPANS - {"solve.wait"}
    names = {e.name for e in prof.events()}
    assert names and not names & REQUEST_SPANS


def test_root_span_on_the_profilers_clock(solvers):
    """The root span lies where a profiler mark around the same call lies,
    on the profiler's own stamps (``trace_start_ns`` + the event's us): inside
    it, and near both its ends (the median of three calls, after a first
    mark that pays the profiler's own first-call cost)."""
    solver, kw = solvers["nu"], NETS["nu"][3]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        for seed in range(3):
            with record_function("bench.request"):
                solver.solve(conditions(solver, 7, seed), seed=seed, **kw)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    marks = sorted((e for e in prof.events() if e.name == "bench.request"),
                   key=lambda e: e.time_range.start)
    roots = [r["solve"] for r in by_request().values()]
    assert len(marks) == len(roots) == 3
    starts = [root.start_ns - (t0 + 1000 * m.time_range.start) for m, root in zip(marks, roots)]
    ends = [t0 + 1000 * m.time_range.end - root.end_ns for m, root in zip(marks, roots)]
    assert min(starts) > -1e5 and min(ends) > -1e5
    assert np.median(starts) < 2e6 and np.median(ends) < 2e6


def test_ring_stays_bounded():
    """The ring keeps the newest ``RING`` request spans, whole requests
    closing last, and ``clear`` empties it."""
    for _ in range(obs.RING // 4 + 10):
        tr = obs.Request()
        tr.span("stage.host", tr.start_ns)
        t = tr.span("solve.stage", tr.start_ns)
        tr.span("solve.launch", t)
        tr.close()
    kept = [s for s in obs.spans() if s.request]
    assert len(kept) == obs.RING
    assert kept[-1].name == "solve.launch" and kept[-4].name == "solve"
    obs.clear()
    assert not [s for s in obs.spans() if s.request]


def test_load_and_warmup_setup_spans():
    """``from_checkpoint`` leaves ``load`` with its two children, whatever
    recording says; ``warmup`` on the CPU captures nothing."""
    mark = max((s.id for s in obs.spans()), default=0)
    solver = Solver.from_checkpoint(str(REPO / "ckpts" / "ddpm_nu_3u_aug32_s8c"),
                                    task="nu_direct", device="cpu", backend="mega",
                                    buckets=[8])
    solver.warmup(configs=[NETS["nu"][3]])
    new = [s for s in obs.spans() if s.request == 0 and s.id > mark]
    assert [s.name for s in new] == ["load.checkpoint", "load.model", "load"]
    load = new[-1]
    assert all(s.parent == load.id and load.start_ns <= s.start_ns <= s.end_ns <= load.end_ns
               for s in new[:2])
    assert new[0].attrs == {"cuda_init": False}
    assert load.attrs["path"].endswith("ddpm_nu_3u_aug32_s8c")
    assert not [s for s in obs.spans() if s.request]   # warmup recorded no request


def test_unblocked_and_chunked_solves_end_at_launch(solvers):
    """``_block=False`` and each ``solve_chunked`` chunk leave a root whose
    last child is ``solve.launch``: no wait and no copy span."""
    solver, kw = solvers["nu"], NETS["nu"][3]
    obs.enable()
    solver.solve(conditions(solver, 4), _block=False, **kw)
    before = obs.counters()["bytes_out"]
    out = solver.solve_chunked(conditions(solver, 20), chunk_size=8, **kw)
    assert obs.counters()["bytes_out"] == before + out.nbytes
    reqs = list(by_request().values())
    assert [r["solve"].attrs["rows"] for r in reqs] == [4, 8, 8, 4]
    for spans in reqs:
        assert set(spans) == REQUEST_SPANS - {"solve.wait", "solve.copy"}
        check_tree(spans)
        assert spans["solve.launch"].end_ns <= spans["solve"].end_ns


def test_kernel_library_spans(monkeypatch, tmp_path):
    """``_build.library`` records its build (with the compiler's report) and
    its load as set-up spans, in place of the build globals it had."""
    assert not hasattr(_build, "BUILD_SECONDS") and not hasattr(_build, "BUILD_LOG")

    def compile_(sources, so, tag, attrs):
        so.write_bytes(b"")
        attrs["log"] = "ptxas info    : Used 64 registers"

    monkeypatch.setattr(_build, "_LIB", None)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    lib = _build.library()
    assert lib[0] == "lib" and _build.library() is lib
    build, load = [s for s in obs.spans() if s.name.startswith("kernels.")][-2:]
    assert (build.name, load.name) == ("kernels.build", "kernels.load")
    assert build.attrs == {"log": "ptxas info    : Used 64 registers"}
    assert build.end_ns <= load.start_ns and build.request == load.request == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph path and the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_load_span(card):
    _build.library()
    assert [s for s in obs.spans() if s.name == "kernels.load"]


@pytest.mark.cuda
@pytest.mark.parametrize("net", list(NETS))
def test_cuda_graph_path_spans(card, net):
    """On the card the first call of a bucket captures (set-up spans
    ``capture`` with its two children) and the next replays; both leave
    ``solve.wait``; the counters count one capture and two replays."""
    ck, task, backend, kw = NETS[net]
    solver = Solver.from_checkpoint(str(REPO / "ckpts" / ck), task=task, backend=backend,
                                    buckets=[8])
    mark = max((s.id for s in obs.spans()), default=0)
    before = obs.counters()
    obs.enable()
    for seed in range(2):
        solver.solve(conditions(solver, 5, seed), seed=seed, **kw)
    after = obs.counters()
    assert (after["captures"] - before["captures"], after["replays"] - before["replays"]) == (1, 2)
    reqs = list(by_request().values())
    assert [r["solve"].attrs["path"] for r in reqs] == ["capture", "graph"]
    for spans in reqs:
        assert set(spans) == REQUEST_SPANS
        check_tree(spans)
    setup = {s.name: s for s in obs.spans() if s.request == 0 and s.id > mark}
    assert {"capture", "capture.eager", "capture.graph"} <= set(setup)
    cap = setup["capture"]
    assert cap.attrs == {"bucket": 8, "sampler": kw.get("sampler", "ddpm")}
    assert setup["capture.eager"].parent == setup["capture.graph"].parent == cap.id
    launch = reqs[0]["solve.launch"]
    assert launch.start_ns <= cap.start_ns <= cap.end_ns <= launch.end_ns


@pytest.mark.cuda
def test_cuda_graph_hoisted_steps(card):
    """The fused backend's prepared path on the graph path: an MSR Solver
    (buckets 8 and 64) answers bit for bit as one whose apply_fn hides
    ``prepare`` (the per-call forward in the graphs); after warm-up each
    request adds its 2,700 resblock launches and 100 hoisted steps. An NU
    Solver (mega) adds no hoisted step."""
    ck, task, backend, kw = NETS["msr"]
    solver = Solver.from_checkpoint(str(REPO / "ckpts" / ck), task=task, backend=backend,
                                    buckets=[8, 64])
    per_call = Solver.from_checkpoint(str(REPO / "ckpts" / ck), task=task, backend=backend,
                                      buckets=[8, 64])
    fused = per_call._apply
    per_call._apply = lambda y, t, c, m: fused(y, t, c, m)
    for s in (solver, per_call):
        s.warmup()
    sizes = (5, 8, 40, 64)
    before = obs.counters()
    got = [solver.solve(conditions(solver, n, n), seed=n) for n in sizes]
    after = obs.counters()
    want = [per_call.solve(conditions(solver, n, n), seed=n) for n in sizes]
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert after["replays"] - before["replays"] == len(sizes)
    assert after["resblock_launches"] - before["resblock_launches"] == 2700 * len(sizes)
    assert after["hoisted_steps"] - before["hoisted_steps"] == 100 * len(sizes)
    assert after["captures"] == before["captures"]

    ck, task, backend, kw = NETS["nu"]
    nu = Solver.from_checkpoint(str(REPO / "ckpts" / ck), task=task, backend=backend,
                                buckets=[8, 64])
    before = obs.counters()
    for n in (5, 40):
        nu.solve(conditions(nu, n), **kw)
    after = obs.counters()
    assert after["hoisted_steps"] == before["hoisted_steps"]
    assert after["mega_launches"] - before["mega_launches"] == 2 * 2 * 3


@pytest.mark.cuda
def test_cuda_device_times_from_timing_events(card):
    """The proj-256 multi-task face (fused, x0, T 20) on a 4,096-row bucket:
    while obs records, ``solve.wait`` carries ``device_sample_ms`` and
    ``device_decode_ms`` from the timing events, graphed and eager, and the
    graphed answers equal the eager ones bit for bit. The events of one
    replay agree within 5% with the profiler's device span of that replay
    (sampling and decode), and of its last operations, as many as the
    decode runs alone (decode)."""
    rows, kw = 4096, {"omega": 0.5}
    ck = str(REPO / "ckpts" / "ddpm_multi_80")
    graphed, eager = (Solver.from_checkpoint(ck, task="multi_msr80", backend="fused",
                                             buckets=[rows], graphs=g) for g in (True, False))
    graphed.warmup(configs=[kw])
    X = conditions(graphed, rows, 7)
    before = obs.counters()
    obs.enable()
    got = graphed.solve(X, seed=11, **kw)
    want = eager.solve(X, seed=11, **kw)
    after = obs.counters()
    assert np.array_equal(got, want)
    assert after["x0_steps"] - before["x0_steps"] == 2 * 20
    assert after["decode_candidates"] - before["decode_candidates"] == 2 * 11 * rows
    reqs = list(by_request().values())
    assert [r["solve"].attrs["path"] for r in reqs] == ["graph", "eager"]
    for r in reqs:
        a = r["solve.wait"].attrs
        assert 0 < a["device_decode_ms"] < a["device_sample_ms"], a

    (g,) = graphed._graphs.values()
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    ops = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == cuda)
    y0 = torch.randn((rows, 80), device=card)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CUDA]) as alone:
        graphed.task.decode_with_x(y0, g.inputs.cond_unnorm, graphed.config,
                                   valid_mask=g.inputs.valid)
        torch.cuda.synchronize()
    n_decode = sum(e.device_type == cuda for e in alone.events())
    dev = device_ms(g.marks)
    span_ms = (ops[-1][1] - ops[0][0]) / 1e3
    decode_ms = (ops[-1][1] - ops[-n_decode][0]) / 1e3
    print(f"device times, events against trace: {dev}, span {span_ms} ms, "
          f"decode {decode_ms} ms over its last {n_decode} of {len(ops)} operations")
    total = dev["device_sample_ms"] + dev["device_decode_ms"]
    assert abs(total - span_ms) <= 0.05 * span_ms
    assert abs(dev["device_decode_ms"] - decode_ms) <= 0.05 * decode_ms

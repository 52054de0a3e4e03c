"""The readers of the program's spans (``benchmark/metrics/program_spans.py``
and the serve and set-up metrics): their values on hand-built span records,
their silence without the program's spans, and a traced CPU run of each
online cell that prints every one of them."""

import json
import sys
import types

import pytest
import torch

import diffsg_tpu_torch
from benchmark import run
from benchmark.tests.test_portbench_harness import SEED, SMALL
from diffsg_tpu_torch import obs

SPAN_METRICS = [m for m in json.loads((run.ROOT / "BENCHMARK.json").read_text())["per_layer"]
                if m["name"].split(".")[0] in ("stage_ms", "launch_ms", "copy_ms", "pad_rows_pct",
                                               "capture_s", "load_s")]
MS = 1_000_000


def request(rid, t0, stage, launch, copy, rows, bucket):
    """A solve call's root and its three top children, ``t0`` in ms."""
    t = [t0 * MS, (t0 + stage) * MS, (t0 + stage + launch) * MS,
         (t0 + stage + launch + copy) * MS]
    return [obs.Span("solve", t[0], t[3], rid, 0, rid,
                     {"rows": rows, "bucket": bucket, "path": "graph"}),
            obs.Span("solve.stage", t[0], t[1], rid + 1, rid, rid, {}),
            obs.Span("solve.launch", t[1], t[2], rid + 2, rid, rid, {}),
            obs.Span("solve.copy", t[2], t[3], rid + 3, rid, rid, {"bytes": 4 * rows})]


def setup_span(name, sid, start_s, end_s, parent=0):
    return obs.Span(name, int(start_s * 1e9), int(end_s * 1e9), sid, parent, 0, {})


SETUP = [
    # An earlier Solver's set-up: not this run's.
    setup_span("load", 1, 0.0, 9.0), setup_span("capture", 2, 9.0, 19.0),
    # The run's: a load, a capture holding the nvcc build, a plain capture.
    setup_span("load", 3, 100.0, 102.5), setup_span("capture.eager", 5, 103.0, 150.0, 4),
    setup_span("kernels.build", 6, 103.5, 148.0, 5), setup_span("kernels.load", 7, 148.0, 148.5, 5),
    setup_span("capture", 4, 103.0, 151.0), setup_span("capture", 8, 151.0, 152.25),
]
RING = (request(1000, 0, 5, 50, 50, 1, 8)          # before the traced span
        + request(1010, 200, 1, 10, 2, 5, 8) + request(1020, 300, 3, 30, 4, 60, 64)
        + request(1030, 400, 2, 20, 3, 200, 512))


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(obs, "spans", lambda: SETUP + RING)


def traced_run(requests=3):
    return types.SimpleNamespace(profile=types.SimpleNamespace(requests=requests))


@pytest.mark.parametrize("name, want", [("stage_ms.online", 2.0), ("stage_ms.batch", 2.0),
                                        ("launch_ms.online", 20.0), ("copy_ms.batch", 3.0)])
def test_median_of_the_traced_requests(spans, name, want):
    """Medians over the last ``profile.requests`` requests only."""
    assert run.load_reader(name)(traced_run()) == pytest.approx(want)
    assert run.load_reader(name)(traced_run(requests=2)) == pytest.approx(
        {"stage": 2.5, "launch": 25.0, "copy": 3.5}[name.split("_")[0]])


def test_pad_rows_pct(spans):
    # (8 - 5) + (64 - 60) + (512 - 200) rows of pad in 8 + 64 + 512 computed.
    assert run.load_reader("pad_rows_pct.online")(traced_run()) == pytest.approx(
        100.0 * 319 / 584)


def test_setup_readers(spans):
    """The run's set-up is its last load and what follows: one load of
    2.5 s; two captures of 48 s and 1.25 s, less the 44.5 s build inside."""
    assert run.load_reader("load_s")(traced_run()) == pytest.approx(2.5)
    assert run.load_reader("capture_s")(traced_run()) == pytest.approx(48 + 1.25 - 44.5)


def test_capture_s_reads_zero_without_captures(monkeypatch):
    monkeypatch.setattr(obs, "spans", lambda: SETUP[2:3])
    assert run.load_reader("capture_s")(traced_run()) == 0.0


def test_silent_without_the_programs_spans(monkeypatch):
    """No profile (an untraced run), no spans, or a program without ``obs``
    (the parent of the commit that added it): every reader returns None."""
    monkeypatch.setattr(obs, "spans", lambda: SETUP + RING)
    for m in SPAN_METRICS:
        if m["name"] not in ("capture_s", "load_s"):
            assert run.load_reader(m["name"])(types.SimpleNamespace(profile=None)) is None
    monkeypatch.setattr(obs, "spans", lambda: [])
    assert all(run.load_reader(m["name"])(traced_run()) is None for m in SPAN_METRICS)
    monkeypatch.delattr(diffsg_tpu_torch, "obs")
    monkeypatch.setitem(sys.modules, "diffsg_tpu_torch.obs", None)
    assert all(run.load_reader(m["name"])(traced_run()) is None for m in SPAN_METRICS)


@pytest.mark.parametrize("cell", ["nu3u_ddim3.online", "msr3c_t100.online"])
def test_traced_online_cell_prints_every_span_metric(cell):
    out = run.run_cell(cell, SEED, 0.5, True, torch.device("cpu"), SMALL[cell])
    want = {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}
    assert want == {"stage_ms.online", "launch_ms.online", "copy_ms.online",
                    "pad_rows_pct.online", "capture_s", "load_s"}
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert want <= set(got)
    assert all(got[k] > 0 for k in want - {"capture_s"}) and got["capture_s"] == 0.0
    assert got["pad_rows_pct.online"] < 100.0

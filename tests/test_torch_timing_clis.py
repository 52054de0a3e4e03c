"""The port's timing CLIs (``diffsg_tpu_torch/tools/profile_sampler.py``,
``serving_latency.py`` and ``latency_probe.py``) against the JAX package's,
at a tiny size with ``--cpu``: their JSON lines' keys equal the JAX CLIs',
``profile_sampler`` writes a Chrome trace that parses as JSON, and the
pipelined requests (``Solver.solve(_block=False)``) return what blocking
ones do. Also the flags of every CLI of this slice against its JAX twin's."""

import argparse
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from diffsg_tpu_torch.data.datasets import make_rows, write_csv
from diffsg_tpu_torch.tools import latency_probe, profile_sampler, serving_latency

import tools.latency_probe as jax_latency_probe
import tools.serving_latency as jax_serving_latency

from test_torch_report_clis import _json_lines, _run_jax_cli

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = REPO / "ckpts"
CLIS = ["headline", "eval_nu_geo", "co_guided", "profile_sampler", "serving_latency",
        "latency_probe", "dump_trajectory", "refine_labels", "refine_study", "nu12_to_geo15"]
# What the port's flags deliberately do otherwise: --cpu on every CLI (the
# card is the default), and defaults that name the reference repository's
# datasets (``_cli.reference_csv``) or a directory outside the checkout.
ADDED = {"--cpu"}
DEFAULTS = {("profile_sampler", "--out"): "build/diffsg_trace",
            ("refine_labels", "--indist-in"): "reference/datasets/3u_18mW_10000samples.csv",
            ("refine_study", "--dataset"): "reference/datasets/3u_18mW_10000samples.csv"}


class _Parsed(Exception):
    pass


def _flags(call, monkeypatch):
    """{option: (default, choices, nargs, required, type)} of the parser
    ``call`` builds, caught at its ``parse_args``."""
    seen = []

    def grab(self, *a, **k):
        seen.append(self)
        raise _Parsed
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            call()
    return {a.option_strings[0]: (a.default, None if a.choices is None else list(a.choices),
                                  a.nargs, a.required, getattr(a.type, "__name__", None))
            for a in seen[0]._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name", CLIS)
def test_cli_flags_match_jax(name, monkeypatch):
    jax_cli = importlib.import_module(f"tools.{name}")
    port = importlib.import_module(f"diffsg_tpu_torch.tools.{name}")
    want = _flags(jax_cli.main, monkeypatch)
    got = _flags(lambda: port.parse_args([]), monkeypatch)
    assert set(got) - set(want) <= ADDED and set(want) <= set(got)
    for flag, spec in want.items():
        if (name, flag) in DEFAULTS:
            assert got[flag] == (DEFAULTS[name, flag], *spec[1:]), flag
        else:
            assert got[flag] == spec, flag


def test_serving_latency_rows_match_jax_keys(monkeypatch, tmp_path, capsys):
    argv = ["--sizes", "3", "--samplers", "ddim:2", "ddpm:20", "--repeats", "2",
            "--depth", "2", "--ckpt", str(CKPTS / "ddpm_nu_3u_aug32_s8c"), "--cpu"]
    capsys.readouterr()
    _run_jax_cli(jax_serving_latency, argv, monkeypatch, tmp_path)
    want = _json_lines(capsys.readouterr().out)
    got = serving_latency.main(argv)
    assert _json_lines(capsys.readouterr().out) == got
    assert [r.keys() for r in got] == [r.keys() for r in want] and len(got) == 2
    for g, w in zip(got, want):
        assert (g["sampler"], g["batch"], g["depth"]) == (w["sampler"], w["batch"], w["depth"])


def test_pipelined_requests_equal_blocking_ones():
    """``solve(_block=False)`` hands back the (n, D) solutions as a tensor,
    equal to the blocking call's; ``latency_row``'s pipelined results equal
    blocking solves of their seeds."""
    solver = serving_latency.make_solver(str(CKPTS / "ddpm_nu_3u_aug32_s8c"), "nu_direct",
                                         [4, 6], device="cpu")
    X = np.random.default_rng(1).uniform(0.05, 0.95, (3, 6)).astype(np.float32)
    kw = dict(sampler="ddim", n_steps=3)
    out = solver.solve(X, seed=5, _block=False, **kw)
    assert isinstance(out, torch.Tensor) and out.shape == (3, 5)
    np.testing.assert_array_equal(out.numpy(), solver.solve(X, seed=5, **kw))
    row, piped = serving_latency.latency_row(solver, X, "ddim", 3, None, 2, 3)
    assert row["sampler"] == "ddim-3" and row["batch"] == 3 and len(piped) == 3
    for i, p in enumerate(piped):
        np.testing.assert_array_equal(p, solver.solve(X, seed=1000 + i, **kw))


def test_latency_probe_matches_jax_keys(monkeypatch, tmp_path, capsys):
    csv = tmp_path / "3nodes_300samples.csv"
    write_csv(csv, make_rows("co", samples=300))
    argv = ["--task", "co", "--ckpt", str(CKPTS / "ddpm_co"), "--dataset", str(csv),
            "--repeats", "2", "--batch", "8", "--omega", "5", "--cpu"]
    capsys.readouterr()
    _run_jax_cli(jax_latency_probe, argv, monkeypatch, tmp_path)
    (want,) = _json_lines(capsys.readouterr().out)
    got = latency_probe.main(argv)
    assert got.keys() == want.keys()
    assert {k: got[k] for k in ("task", "omega", "T", "batch")} == {
        k: want[k] for k in ("task", "omega", "T", "batch")}
    assert got["device"] == "cpu" and got["single_sample_ms"] > 0


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_profile_sampler_writes_a_chrome_trace(backend, tmp_path, capsys):
    out = tmp_path / "trace"
    res = profile_sampler.main(["--task", "co", "--T", "3", "--batch", "8", "--omega", "5",
                                "--backend", backend, "--out", str(out), "--cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"trace written to {out / 'trace.json'}"
    top = json.loads(lines[1])
    assert top["backend"] == profile_sampler.BACKENDS[backend]
    trace = json.loads((out / "trace.json").read_text())
    assert trace["traceEvents"]
    ops = top["top_device_ops"]
    assert 0 < len(ops) <= profile_sampler.TOP and ops == res["ops"][:len(ops)]
    assert all(o.keys() == {"name", "count", "total_ms"} for o in ops)
    assert [o["total_ms"] for o in ops] == sorted((o["total_ms"] for o in ops), reverse=True)
    names = {o["name"] for o in res["ops"]}
    assert "aten::addmm" in names or "aten::mm" in names


NO_CARD_ARGV = {"headline": ["--tasks", "co"], "eval_nu_geo": [], "co_guided": [],
                "profile_sampler": [], "serving_latency": [],
                "latency_probe": ["--task", "msr", "--ckpt", "x", "--dataset", "y"],
                "dump_trajectory": ["--task", "co", "--ckpt", "x", "--dataset", "y", "--out", "z"],
                "refine_labels": [], "refine_study": []}


@pytest.mark.parametrize("name", sorted(NO_CARD_ARGV))
def test_cli_raises_without_a_card(name):
    """Without ``--cpu`` a CLI runs on the card, and without one it raises
    before it reads anything: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card rule cannot be shown here")
    port = importlib.import_module(f"diffsg_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main(NO_CARD_ARGV[name])

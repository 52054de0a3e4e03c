"""The plain reference and the program check on a multi-task face that
predicts x0: the ``multi_msr80`` face of ``ckpts/ddpm_multi_80`` (proj 256,
condition ``[one-hot (5) | payload (81)]``, an 80-wide canvas, DDPM T 20),
on the CPU against the port's ``plain`` backend. The configuration is
local to these tests: the face has no cell."""

import json
import pathlib
import types

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import control, correct
from benchmark.harness import traffic as gen
from benchmark.reference import multi_msr80, sampler
from benchmark.reference.unet import load_arrays

from diffsg_tpu_torch.serve import Solver

ROOT = pathlib.Path(__file__).resolve().parents[2]
CKPT = ROOT / "ckpts" / "ddpm_multi_80"
CPU = torch.device("cpu")


def face_config():
    md = json.loads((CKPT / "metadata.json").read_text())
    sub, arch = md["subtask_configs"]["msr80"], md["arch"]
    return {
        "name": "multi80_msr80", "task": "multi_msr80", "checkpoint": str(CKPT),
        "model": {"input_dim": 80, "proj_dim": 256, "cond_dim": 86, "dims": [256, 128, 64, 32],
                  "n_blocks": 2, "parameters": 9444464},
        "task_config": {"M": 80, "W": 10.0, "w_ref": 10.0, "scaler_min": sub["scaler_min"],
                        "scaler_max": sub["scaler_max"], "y_scale": 8.0,
                        "slots": arch["slots"], "payload_dim": 81},
        "sampler": {"kind": "ddpm", "T": 20, "omega": 1.0, "parameterization": "x0"},
        "answer_scale": [10.0] * 80, "backend": "plain",
    }


@pytest.fixture(scope="module")
def face():
    c = face_config()
    return c, Solver.from_checkpoint(c["checkpoint"], task=c["task"], device="cpu",
                                     backend="plain", buckets=(8, 16))


@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
def test_reference_agrees_with_plain_on_the_face(face, kind):
    """Several requests to one reference batch, bucketed on the program's
    side; DDPM over T 20 and DDIM over 3 respaced steps, both from x0."""
    c, solver = face
    c = {**c, "sampler": {**c["sampler"], "kind": kind, "n_steps": 3}}
    kw = {"sampler": kind, "n_steps": 3} if kind == "ddim" else {}
    rng = np.random.default_rng(3)
    reqs = [gen.Request(k, n, 0.0, multi_msr80.conditions(rng, n, c["task_config"]), 1000 + k)
            for k, n in enumerate((5, 16, 1))]
    served = [solver.solve(r.X, seed=r.noise_seed, omega=c["sampler"]["omega"], **kw)
              for r in reqs]
    ref = correct.Reference(c, CPU).answers(reqs)
    assert [a.shape for a in ref] == [a.shape for a in served] == [(5, 80), (16, 80), (1, 80)]
    g = correct.gaps(c, served, ref)
    assert g["max_gap"] < 2e-5, g
    # Feasible powers on the budget W.
    for a in ref:
        assert (a >= 0).all() and np.allclose(a.sum(axis=1), 10.0, rtol=1e-5)
    alone = correct.Reference(c, CPU).answers(reqs[1:2])[0]
    np.testing.assert_allclose(alone, ref[1], rtol=0, atol=1e-4)


def test_embed_writes_the_shared_layout():
    c = face_config()["task_config"]
    X = multi_msr80.conditions(np.random.default_rng(0), 4, c)
    assert X.shape == (4, 81) and (X[:, -1] == 1.0).all()
    e = multi_msr80.embed(torch.as_tensor(X), c)
    assert e.shape == (4, 86)
    assert (e[:, :5] == torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0])).all()
    assert torch.equal(e[:, 5:], torch.as_tensor(X))


def test_prediction_round_trip():
    """x0 and v made from a known epsilon give it back; eps passes through."""
    _, betas = load_arrays(str(CKPT))
    co = sampler.Coefficients(betas, CPU)
    g = torch.Generator().manual_seed(0)
    x0, eps = torch.randn(6, 80, generator=g), torch.randn(6, 80, generator=g)
    for i in (0, 7, co.T - 1):
        a, s = co.sqrt_abar[i], co.sqrt_1m_abar[i]
        y = a * x0 + s * eps
        torch.testing.assert_close(co.to_eps(x0, y, i, "x0"), eps, rtol=0, atol=1e-4)
        torch.testing.assert_close(co.to_eps(a * eps - s * x0, y, i, "v"), eps, rtol=0,
                                   atol=1e-5)
        assert co.to_eps(eps, y, i, "eps") is eps
    with pytest.raises(ValueError):
        co.to_eps(eps, eps, 0, "score")


def test_check_program_reads_the_face(face):
    c, solver = face
    run.check_program(solver, c)
    wrong = {**c, "sampler": {**c["sampler"], "parameterization": "eps"}}
    with pytest.raises(run.RunError, match="predicts 'x0'"):
        run.check_program(solver, wrong)
    bare = types.SimpleNamespace(model=torch.nn.Linear(2, 2), sched=solver.sched,
                                 config=solver.config)
    with pytest.raises(run.RunError, match="no widths"):
        run.check_program(bare, c)


def test_control_reads_the_face():
    """A configuration without a cell, read as one bucket: the program's
    gaps and the TF32 control's on every seed, each request's service
    time, and last the peak memory (none off the card)."""
    lines = control.readings(control.config_cell(face_config(), 8), [5, 6], 10.0, CPU)
    assert [line.get("seed") for line in lines] == [5, 6, None]
    for line in lines[:2]:
        assert line["rows"] == 8 and len(line["service_ms"]) == 1
        assert line["program"]["req_med_gap"] < 1e-5 < line["tf32"]["req_med_gap"], line
    assert lines[2] == {"workload": "multi80_msr80", "memory_peak_bytes": None}

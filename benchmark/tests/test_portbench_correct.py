"""``correct`` comes out false when the timed path is broken underneath, and
the control (the reference in TF32 put in the program's place) reads above
the cell's limits: small runs on the CPU, with the card's check skipped.

The faults a cell can have: a sampler step that returns its state
unchanged; the batch statistics taken over half of the batch; an answer
altered where it is produced. Every cell runs on one chip, so there is no
exchange between chips to leave out.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import diffsg_tpu_torch.diffusion.ddim as ddim_mod
import diffsg_tpu_torch.diffusion.ddpm as ddpm_mod
import diffsg_tpu_torch.serve as serve_mod
from benchmark import run
from benchmark.harness import control

from test_portbench_harness import SEED, SMALL, small_run

ROOT = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def step_unchanged(monkeypatch, cell):
    """The middle sampler step returns its state unchanged (DDIM: the middle
    of its three steps is dropped, and the step after reads its input)."""
    if cell.startswith("msr3c"):
        real = ddpm_mod._reverse_step

        def step(sched, y_t, i, *a, **k):
            return y_t if i == sched.T // 2 else real(sched, y_t, i, *a, **k)
        monkeypatch.setattr(ddpm_mod, "_reverse_step", step)
    else:
        real = ddim_mod.respaced_steps
        monkeypatch.setattr(ddim_mod, "respaced_steps",
                            lambda T, n: np.delete(real(T, n), len(real(T, n)) // 2))


def half_batch(monkeypatch, cell):
    """The re-standardization's mean and variance over the first half of the
    batch only."""
    real = ddpm_mod.masked_mean_var

    def half(y, valid_mask=None):
        h = y.shape[0] // 2
        return real(y[:h], None if valid_mask is None else valid_mask[:h])
    monkeypatch.setattr(ddpm_mod, "masked_mean_var", half)
    monkeypatch.setattr(ddim_mod, "masked_mean_var", half)


def answer_altered(monkeypatch, cell):
    """Each request's first answer has its columns rolled."""
    real = serve_mod.Solver.solve

    def solve(self, X, *a, **k):
        out = real(self, X, *a, **k)
        out[0] = np.roll(out[0], 1)
        return out
    monkeypatch.setattr(serve_mod.Solver, "solve", solve)


FAULTS = {"step_unchanged": step_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = small_run(cell)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch, cell)
    out = small_run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_limit(cell):
    """The TF32 control fails at least one of the cell's limits on three
    seeds, where the program passes all of them."""
    limits = run.load_json(ROOT / "benchmark" / "limits" / f"{cell}.json")["limits"]
    c = run.load_cell(cell, SMALL[cell])
    for line in control.readings(c, [SEED, 3, 4], 10.0, torch.device("cpu"))[:-1]:
        assert all(line["program"][k] <= limits[k] for k in limits), line
        assert any(line["tf32"][k] > limits[k] for k in limits), line

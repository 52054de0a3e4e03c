"""The benchmark's plain reference against the port's ``plain`` backend, on
the CPU at small batches, on both checkpoints: bucketed requests (a pad
and its mask) and several requests solved in one reference batch."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark.harness import correct
from benchmark.harness import traffic as gen

from diffsg_tpu_torch.serve import Solver

ROOT = pathlib.Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def config(name):
    c = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    c["checkpoint"] = str(ROOT / c["checkpoint"])
    return c


@pytest.mark.parametrize("name, sizes, buckets", [
    ("msr3c_t100", (5, 16, 1), (8, 16)),
    ("nu3u_ddim3", (3, 40, 64, 1), (8, 64)),
])
def test_reference_agrees_with_plain(name, sizes, buckets):
    c = config(name)
    task = __import__(f"benchmark.reference.{c['task']}", fromlist=["conditions"])
    s = c["sampler"]
    kw = {"omega": s["omega"], "sampler": s["kind"]}
    if s["kind"] == "ddim":
        kw["n_steps"] = s["n_steps"]
    solver = Solver.from_checkpoint(c["checkpoint"], task=c["task"], device="cpu",
                                    backend="plain", buckets=buckets)
    rng = np.random.default_rng(3)
    reqs = [gen.Request(k, n, 0.0, task.conditions(rng, n, c["task_config"]), 1000 + k)
            for k, n in enumerate(sizes)]
    served = [solver.solve(r.X, seed=r.noise_seed, **kw) for r in reqs]
    ref = correct.Reference(c, CPU).answers(reqs)
    assert [a.shape for a in ref] == [a.shape for a in served]
    g = correct.gaps(c, served, ref)
    assert g["max_gap"] < 2e-5, g
    # One request alone gives what it gives in a batch of several.
    alone = correct.Reference(c, CPU).answers(reqs[1:2])[0]
    np.testing.assert_allclose(alone, ref[1], rtol=0, atol=1e-5 * max(c["answer_scale"]))


def test_noise_is_the_solvers():
    """The reference draws a request's noise as the Solver documents it:
    changing the seed changes the answer, the same seed repeats it."""
    c = config("nu3u_ddim3")
    a = correct.request_noise(5, 4, c, CPU)
    assert torch.equal(a, correct.request_noise(5, 4, c, CPU))
    assert not torch.equal(a, correct.request_noise(6, 4, c, CPU))
    assert a.shape == (4, 1, 5)
    assert correct.request_noise(5, 2, config("msr3c_t100"), CPU).shape == (2, 101, 3)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys, torch; from benchmark.harness import correct, traffic; "
            "import benchmark.reference.msr, benchmark.reference.nu_direct, "
            "benchmark.reference.multi_msr80; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('diffsg_tpu_torch', 'diffsg_tpu', 'jax', 'jaxlib', 'flax')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

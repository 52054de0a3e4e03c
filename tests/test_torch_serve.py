"""The port's serving entry point on the CPU, its device rule, its launch
counter, and the rule that it imports nothing of JAX."""

import ast
import pathlib
import re

import numpy as np
import pytest
import torch

from diffsg_tpu_torch import obs
from diffsg_tpu_torch.diffusion import ddim_sample
from diffsg_tpu_torch.models import unet_apply_fn
from diffsg_tpu_torch.serve import Solver

REPO = pathlib.Path(__file__).resolve().parent.parent

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPT = REPO / "ckpts" / "ddpm_msr_3c_T100"


@pytest.fixture(scope="module")
def solver():
    return Solver.from_checkpoint(str(CKPT), task="msr", device="cpu")


def _conditions(B, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (B, 3)).astype(np.float32)


def test_solve_is_feasible_and_seed_deterministic(solver):
    X = _conditions(16)
    W = solver.config["W"]
    before = obs.counters()["resblock_launches"]
    P = solver.solve(X, seed=3)
    assert obs.counters()["resblock_launches"] == before  # the CPU path launches no kernel
    assert P.shape == (16, 3) and np.isfinite(P).all() and (P >= 0).all()
    np.testing.assert_allclose(P.sum(axis=1), W, rtol=0, atol=1e-4 * W)
    np.testing.assert_array_equal(solver.solve(X, seed=3), P)
    assert not np.array_equal(solver.solve(X, seed=4), P)


def test_plain_and_fused_backends_agree(solver):
    plain = Solver.from_checkpoint(str(CKPT), task="msr", device="cpu", backend="plain")
    X = _conditions(16, seed=1)
    # omega=0: no guidance to amplify the two forwards' reassociation.
    np.testing.assert_allclose(plain.solve(X, omega=0.0), solver.solve(X, omega=0.0),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("option", ["mesh"])
def test_unported_solve_options_raise(solver, option):
    """As in the JAX package: ``solve`` takes no mesh (a Solver is meshed at
    construction), and the constructor's mesh must be a ``parallel.Mesh``."""
    with pytest.raises(TypeError, match=option):
        solver.solve(_conditions(4), **{option: 2})
    with pytest.raises(TypeError, match=f"{option} must be a parallel.Mesh"):
        Solver(solver.task, solver.model, solver.sched, solver.config, **{option: 2})


def _feasible(P, W):
    assert np.isfinite(P).all() and (P >= 0).all()
    np.testing.assert_allclose(P.sum(axis=1), W, rtol=0, atol=1e-4 * W)


@pytest.mark.parametrize("option", ["sampler", "n_steps"])
def test_ddim_solve_options(solver, option):
    X = _conditions(16, seed=5)
    W = solver.config["W"]
    if option == "sampler":
        # DDIM over all T steps: ddim_sample on y_T drawn from the seed.
        P = solver.solve(X, omega=0.0, sampler="ddim", seed=3)
        init = torch.randn((16, 3), generator=torch.Generator().manual_seed(3))
        y0 = ddim_sample(unet_apply_fn(solver.model, "fused"), solver.sched,
                         torch.from_numpy(X), 0.0, 3, init_noise=init, skip_uncond=True)
        np.testing.assert_array_equal(P, solver.task.decode(y0, solver.config).numpy())
        _feasible(P, W)
        with pytest.raises(ValueError, match="unknown sampler"):
            solver.solve(X, sampler="euler")
    else:
        P5 = solver.solve(X, sampler="ddim", n_steps=5, seed=1)
        _feasible(P5, W)
        assert not np.array_equal(P5, solver.solve(X, sampler="ddim", n_steps=10, seed=1))
        with pytest.raises(ValueError, match="DDIM options"):
            solver.solve(X, n_steps=5)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card rule cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Solver.from_checkpoint(str(CKPT), task="msr")


_FORBIDDEN = re.compile(r"^(jax|flax|optax|diffsg_tpu|pandas|orbax|tensorstore|zstandard)(\.|$)")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "diffsg_tpu_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_port_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _FORBIDDEN.match(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"

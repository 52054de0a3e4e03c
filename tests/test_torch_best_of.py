"""Best-of-N on the CPU: ``select_best`` against the JAX package's, and the
Solver's best-of with omega mixtures against its single draw."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsg_tpu.tasks.base import select_best as jax_select_best
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import select_best

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NU_CFG = {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0}


@pytest.mark.parametrize("higher_is_better", [True, False])
@pytest.mark.parametrize("n,B,D,ties", [(4, 64, 5, False), (3, 17, 3, True), (1, 8, 2, False)])
def test_select_best_matches_jax(higher_is_better, n, B, D, ties):
    rng = np.random.default_rng(n * 100 + B)
    decs = rng.normal(size=(n, B, D)).astype(np.float32)
    scores = rng.normal(size=(n, B)).astype(np.float32)
    if ties:   # equal best scores: the first candidate wins on both sides
        scores = np.round(scores).astype(np.float32)
    ref = np.asarray(jax_select_best(jnp.asarray(decs), jnp.asarray(scores), higher_is_better))
    got = select_best(torch.from_numpy(decs), torch.from_numpy(scores), higher_is_better)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.fixture(scope="module")
def nu():
    solver = Solver.from_checkpoint(str(REPO / "ckpts" / "ddpm_nu_3u"), task="nu", device="cpu",
                                    dataset_config=NU_CFG, buckets=(32,))
    d = np.load(REPO / "tests" / "fixtures" / "nu_data_head.npz")
    X = np.concatenate([d["X_test_head"], d["X_train_head"]]).astype(np.float32)
    return solver, X, torch.from_numpy(solver.task.unnormalize_x(X, NU_CFG).astype(np.float32))


@pytest.mark.parametrize("sampler", [{}, {"sampler": "ddim", "n_steps": 10}])
def test_best_of_beats_the_single_draw_row_by_row(nu, sampler):
    """Candidate 0 is the best_of=1 draw, so every row's rate is at least
    its rate; an omega mixture is deterministic per seed."""
    solver, X, users = nu

    def rate(Y):
        return solver.task.objective(torch.from_numpy(Y), users, solver.config).numpy()

    one = solver.solve(X, omega=500.0, seed=2, **sampler)
    four = solver.solve(X, omega=500.0, best_of=4, seed=2, **sampler)
    assert four.shape == one.shape
    assert (rate(four) >= rate(one)).all()
    assert rate(four).sum() > rate(one).sum()
    mix = [150.0, 500.0, 2000.0, 5000.0]
    mixed = solver.solve(X, omega=mix, best_of=4, seed=5, **sampler)
    np.testing.assert_array_equal(mixed, solver.solve(X, omega=mix, best_of=4, seed=5, **sampler))
    assert (rate(mixed) >= rate(solver.solve(X, omega=150.0, seed=5, **sampler))).all()
    np.testing.assert_allclose(mixed[:, 2:].sum(1), 18.0, rtol=1e-4)
    assert not np.array_equal(mixed, solver.solve(X, omega=mix, best_of=4, seed=6, **sampler))

"""The port's NU decoders, objective and serving path against the JAX
package and the committed fixtures."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsg_tpu.ops.decoders import msr_simplex_project as jax_simplex
from diffsg_tpu.ops.decoders import nu_decode as jax_nu_decode
from diffsg_tpu.ops.decoders import nu_direct_decode as jax_nu_direct_decode
from diffsg_tpu.ops.objectives import nu_rate as jax_nu_rate
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu_torch.ops import (msr_simplex_project, nu_channel_gains, nu_decode,
                                  nu_direct_decode, nu_rate)
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import TASKS

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
NU_CKPT = REPO / "ckpts" / "ddpm_nu_3u_aug32_s8c"
Y_SHIFT = np.array([0.47, 0.47, 0.33, 0.33, 0.33], np.float32)


def test_nu_rate_matches_fixture_and_jax():
    fx = np.load(FIXTURES / "objectives.npz")
    Y, X = fx["nu_Y"].astype(np.float32), fx["nu_X"].astype(np.float32)
    got = nu_rate(torch.from_numpy(Y), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, fx["nu_rate"], rtol=1e-5)   # tests/test_core_numerics.py
    np.testing.assert_allclose(got, np.asarray(jax_nu_rate(jnp.asarray(Y), jnp.asarray(X))),
                               rtol=1e-6)


def test_nu_rate_sic_order_on_ties_and_random_rows():
    rng = np.random.default_rng(0)
    Y = np.concatenate([rng.uniform(0, 400, (64, 2)), rng.uniform(0, 18, (64, 3))], 1)
    X = rng.uniform(0, 400, (64, 6))
    X[:8, 2:4] = X[:8, 0:2]          # two users in one place: equal gains
    Y, X = Y.astype(np.float32), X.astype(np.float32)
    got = nu_rate(torch.from_numpy(Y), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_nu_rate(jnp.asarray(Y), jnp.asarray(X))),
                               rtol=1e-6)
    h = nu_channel_gains(torch.from_numpy(Y[:, :2]), torch.from_numpy(X)).numpy()
    assert h.shape == (64, 3) and (h > 0).all()


def test_nu_decode_matches_fixture_and_jax():
    fx = np.load(FIXTURES / "decoders.npz")
    y = fx["y_nu_raw"].astype(np.float32)
    got = nu_decode(torch.from_numpy(y), 400, 400, 18.0).numpy()
    np.testing.assert_allclose(got, fx["nu_dec"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(jax_nu_decode(jnp.asarray(y), 400, 400, 18.0)),
                               rtol=0, atol=1e-4)
    valid = (np.arange(32) < 20).astype(np.float32)[:, None]
    got = nu_decode(torch.from_numpy(y), 400, 400, 18.0, torch.from_numpy(valid)).numpy()
    ref = np.asarray(jax_nu_decode(jnp.asarray(y), 400, 400, 18.0, jnp.asarray(valid)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("y_shift", [0.0, Y_SHIFT])
def test_nu_direct_decode_matches_jax(y_shift):
    y = np.random.default_rng(1).normal(0, 4, (64, 5)).astype(np.float32)
    got = nu_direct_decode(torch.from_numpy(y), 400, 400, 18.0, 8.0, y_shift).numpy()
    ref = np.asarray(jax_nu_direct_decode(jnp.asarray(y), 400, 400, 18.0, 8.0, y_shift))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert (got[:, :2] >= 0).all() and (got[:, :2] <= 400).all() and (got[:, 2:] >= 0).all()
    np.testing.assert_allclose(got[:, 2:].sum(1), 18.0, rtol=1e-5)


def test_msr_simplex_project_matches_jax():
    rng = np.random.default_rng(2)
    y = rng.normal(0, 2, (128, 4)).astype(np.float32)
    for W in (1.0, 10.0):
        got = msr_simplex_project(torch.from_numpy(y), W).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_simplex(jnp.asarray(y), W)),
                                   rtol=0, atol=1e-6)
        assert (got >= 0).all()
        np.testing.assert_allclose(got.sum(1), W, rtol=1e-5)
    # Feasible rows project to themselves.
    p = rng.dirichlet(np.ones(4), 16).astype(np.float32)
    np.testing.assert_allclose(msr_simplex_project(torch.from_numpy(p), 1.0).numpy(), p,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["nu", "nu_direct"])
def test_nu_tasks_match_jax(name):
    cfg = {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0, "y_scale": 8.0,
           "y_shift": list(map(float, Y_SHIFT))}
    task, jtask = TASKS[name], JAX_TASKS[name]
    assert (task.data_dim(cfg), task.cond_dim(cfg)) == (jtask.data_dim(cfg), jtask.cond_dim(cfg))
    assert task.default_omega == jtask.default_omega
    assert task.higher_is_better == jtask.higher_is_better
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (16, 6)).astype(np.float32)
    np.testing.assert_allclose(task.unnormalize_x(X, cfg), jtask.unnormalize_x(X, cfg))
    y = rng.normal(0, 3, (16, 5)).astype(np.float32)
    np.testing.assert_allclose(task.decode(torch.from_numpy(y), cfg).numpy(),
                               np.asarray(jtask.decode(jnp.asarray(y), cfg)), rtol=0, atol=1e-4)
    assert sum(p.numel() for p in task.build_model(cfg).parameters()) == 148_749


@pytest.fixture(scope="module")
def nu_solver():
    return Solver.from_checkpoint(str(NU_CKPT), task="nu_direct", device="cpu", backend="mega")


def test_nu_direct_ddim3_solve_is_feasible_and_seed_deterministic(nu_solver):
    X = np.random.default_rng(4).uniform(0, 1, (64, 6)).astype(np.float32)
    S = nu_solver.solve(X, omega=0.125, sampler="ddim", n_steps=3, seed=1)
    assert S.shape == (64, 5) and np.isfinite(S).all()
    assert (S[:, :2] >= 0).all() and (S[:, :2] <= 400).all() and (S[:, 2:] >= 0).all()
    np.testing.assert_allclose(S[:, 2:].sum(1), 18.0, rtol=0, atol=1e-4 * 18.0)
    np.testing.assert_array_equal(nu_solver.solve(X, omega=0.125, sampler="ddim", n_steps=3,
                                                  seed=1), S)
    assert not np.array_equal(nu_solver.solve(X, omega=0.125, sampler="ddim", n_steps=3,
                                              seed=2), S)
    rate = nu_rate(torch.from_numpy(S),
                   torch.tensor(nu_solver.task.unnormalize_x(X, nu_solver.config),
                                dtype=torch.float32))
    assert torch.isfinite(rate).all() and (rate > 0).all()


def test_nu_vs_jax_constant():
    """The JAX package's mean rate on chip_smoke.py's nu_vs_jax inputs is the
    constant the script holds the card to; the port's plain path on the CPU
    gives it too."""
    import importlib.util

    import jax

    from diffsg_tpu.diffusion import ddim_sample as jax_ddim_sample
    from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
    from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
    from diffsg_tpu_torch.diffusion import ddim_sample
    from diffsg_tpu_torch.models import unet_apply_fn

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (4096, 6)).astype(np.float32)
    init = rng.normal(size=(4096, 5)).astype(np.float32)
    jck = jax_load_checkpoint(str(NU_CKPT))
    cfg = jck["metadata"]["dataset_config"]
    jtask = JAX_TASKS["nu_direct"]
    jy0 = jax.jit(lambda c, i: jax_ddim_sample(
        jax_apply_fn(jtask.build_model(cfg), "xla"), jck["params"], jck["sched"], c, 0.125, 5,
        n_steps=3, init_noise=i)[0])(X, init)
    users = np.asarray(jtask.unnormalize_x(X, cfg), np.float32)
    jrate = float(jnp.mean(jax_nu_rate(jtask.decode(jy0, cfg), jnp.asarray(users))))
    assert jrate == pytest.approx(chip_smoke.NU_JAX_MEAN_RATE, rel=1e-6)

    solver = Solver.from_checkpoint(str(NU_CKPT), task="nu_direct", device="cpu",
                                    backend="plain")
    y0 = ddim_sample(unet_apply_fn(solver.model, "plain"), solver.sched, torch.from_numpy(X),
                     0.125, 5, n_steps=3, init_noise=torch.from_numpy(init))
    rate = float(nu_rate(solver.task.decode(y0, solver.config), torch.from_numpy(users)).mean())
    assert rate == pytest.approx(chip_smoke.NU_JAX_MEAN_RATE, rel=1e-3)

"""Projected-gradient refinement against the JAX package's: the step rule
(per-row normalized, per-row precond, grow and shrink, rejection), the
monotone guarantee row by row, ``refine_solutions``, the Solver's
``refine_iters`` against the JAX package's program on the same noise, with
buckets, and the refined quality constants of ``chip_smoke.py``."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.ops import msr_sum_rate as jax_sum_rate
from diffsg_tpu.ops.decoders import msr_simplex_project as jax_simplex
from diffsg_tpu.ops.refine import projected_refine as jax_projected_refine
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks.base import refine_solutions as jax_refine_solutions
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.ops import msr_simplex_project, msr_sum_rate
from diffsg_tpu_torch.ops.refine import projected_refine
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import TASKS, refine_solutions

from test_torch_tasks import NU_CFG, check_vs_jax_constant

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
MSR20 = REPO / "ckpts" / "ddpm_msr_3c"       # T = 20, no recorded dataset config
# The 3-channel, 10 W dataset's, as ckpts/ddpm_msr_3c_T100 records them.
MSR_CFG = {"M": 3, "W": 10.0, "scaler_min": 0.5002832180599799,
           "scaler_max": 2.4999902577156714}


def _msr_problem(B, seed):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.5, 2.5, (B, 3)).astype(np.float32)
    p = (10.0 * rng.dirichlet(np.ones(3), B)).astype(np.float32)
    return p, g


def _both_msr(p, g, iters, **kw):
    jref = np.asarray(jax_projected_refine(
        lambda Y: jax_sum_rate(Y, jnp.asarray(g)), lambda Y: jax_simplex(Y, 10.0),
        jnp.asarray(p), iters, 0.25, **kw))
    tg = torch.from_numpy(g)
    got = projected_refine(lambda Y: msr_sum_rate(Y, tg), lambda Y: msr_simplex_project(Y, 10.0),
                           torch.from_numpy(p), iters, 0.25, **kw).numpy()
    return got, jref


def _rate(p, g):
    return np.log2(1 + p * g).sum(1)


@pytest.mark.parametrize("iters", [1, 3, 40])
def test_projected_refine_matches_jax_on_msr(iters):
    p, g = _msr_problem(256, seed=0)
    got, ref = _both_msr(p, g, iters)
    if iters <= 3:
        # Few steps: every accept/reject decision is far from a tie, so the
        # iterates agree elementwise (f32 projections, 1e-5 of W).
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    else:
        # After 40 steps a row whose trial ties its incumbent to the last
        # bit may accept on one side and reject on the other; the rows then
        # part by up to a step. Hold the mean objective instead.
        assert abs(_rate(got, g).mean() - _rate(ref, g).mean()) <= 1e-5
    assert (got >= 0).all()
    np.testing.assert_allclose(got.sum(1), 10.0, rtol=1e-5)
    # Never worse than the start, row by row.
    assert (_rate(got, g) >= _rate(p, g) - 1e-6).all()
    assert _rate(got, g).mean() > _rate(p, g).mean()


def test_projected_refine_minimizes_and_returns_early():
    p, g = _msr_problem(64, seed=1)
    got, ref = _both_msr(p, g, 5, higher_is_better=False, grow=1.5, shrink=0.25)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert (_rate(got, g) <= _rate(p, g) + 1e-6).all()
    Y0 = torch.from_numpy(p)
    assert projected_refine(None, None, Y0, 0, 0.25) is Y0


def _nu_geo_problem(B, seed):
    task = TASKS["nu_geo"]
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (B, 9)).astype(np.float32)
    X[:, 6] = rng.uniform(0.5, 2.0, B)
    X[:, 7:] = rng.choice([0.5, 1.0, 1.5], (B, 1))
    Xu = np.asarray(task.unnormalize_x(X, NU_CFG), np.float32)
    Y = task.decode_with_x(torch.from_numpy(rng.normal(0, 2, (B, 5)).astype(np.float32)),
                           torch.from_numpy(Xu), NU_CFG).numpy()
    # Per-row precond (B, D): 2% of each row's own field and budget.
    pre = np.concatenate([0.02 * Xu[:, 7:9], np.repeat(0.02 * Xu[:, 6:7], 3, 1)], 1)
    return Xu, Y, pre.astype(np.float32)


@pytest.mark.parametrize("iters", [2, 30])
def test_projected_refine_matches_jax_on_nu_geo_with_per_row_precond(iters):
    task, jt = TASKS["nu_geo"], JAX_TASKS["nu_geo"]
    Xu, Y, pre = _nu_geo_problem(256, seed=2)
    ref = np.asarray(jax_projected_refine(
        lambda y: jt.objective(y, jnp.asarray(Xu), NU_CFG),
        lambda y: jt.project(y, jnp.asarray(Xu), NU_CFG), jnp.asarray(Y), iters, 1.0,
        precond=jnp.asarray(pre)))
    tX = torch.from_numpy(Xu)
    got = projected_refine(lambda y: task.objective(y, tX, NU_CFG),
                           lambda y: task.project(y, tX, NU_CFG), torch.from_numpy(Y), iters, 1.0,
                           precond=torch.from_numpy(pre)).numpy()
    rate = task.objective(torch.from_numpy(got), tX, NU_CFG).numpy()
    jrate = np.asarray(jt.objective(jnp.asarray(ref), jnp.asarray(Xu), NU_CFG))
    start = task.objective(task.project(torch.from_numpy(Y), tX, NU_CFG), tX, NU_CFG).numpy()
    if iters == 2:
        # Positions in meters on fields of up to 600 m, powers in mW.
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    else:
        # Accept/reject near-ties (see the MSR case): the mean rate.
        assert abs(rate.mean() - jrate.mean()) <= 1e-4 * jrate.mean()
    assert (rate >= start * (1 - 1e-6)).all()
    assert (got[:, :2] >= 0).all() and (got[:, :2] <= Xu[:, 7:9] * (1 + 1e-6)).all()
    np.testing.assert_allclose(got[:, 2:].sum(1), Xu[:, 6], rtol=1e-5)


@pytest.mark.parametrize("name", ["msr", "msr_budget", "nu", "nu_budget", "nu_geo"])
def test_refine_solutions_is_monotone_row_by_row_and_matches_jax(name):
    """The task's own projection, step and precond; each refined row is at
    least as good as its projected start."""
    task, jt = TASKS[name], JAX_TASKS[name]
    rng = np.random.default_rng(3)
    B = 128
    if name.startswith("msr"):
        cfg = dict(MSR_CFG, w_ref=10.0)
        X = rng.uniform(0, 1, (B, task.cond_dim(cfg))).astype(np.float32)
        Y = (10.0 * rng.dirichlet(np.ones(3), B)).astype(np.float32)
    else:
        cfg = NU_CFG
        X = rng.uniform(0, 1, (B, task.cond_dim(cfg))).astype(np.float32)
        X[:, 6:] = rng.uniform(0.5, 1.5, (B, X.shape[1] - 6))
        Y = np.concatenate([rng.uniform(0, 400, (B, 2)), rng.uniform(0, 6, (B, 3))],
                           1).astype(np.float32)
    Xu = np.asarray(task.unnormalize_x(X, cfg), np.float32)
    tX = torch.from_numpy(Xu)
    start = task.objective(task.project(torch.from_numpy(Y), tX, cfg), tX, cfg).numpy()
    with torch.inference_mode():       # as the Solver runs it
        got = refine_solutions(task, torch.from_numpy(Y), tX, cfg, 25)
    assert not got.is_inference()
    score = task.objective(got, tX, cfg).numpy()
    assert (score >= start - 1e-6 * np.abs(start)).all()
    ref = np.asarray(jax_refine_solutions(jt, jnp.asarray(Y), jnp.asarray(Xu), cfg, 25))
    jscore = np.asarray(jt.objective(jnp.asarray(ref), jnp.asarray(Xu), cfg))
    # Accept/reject near-ties make rows part: the mean objective.
    assert abs(score.mean() - jscore.mean()) <= 1e-5 * abs(jscore.mean())


def test_refine_solutions_raises_for_tasks_without_a_projection():
    for name in ("co", "co_analytic", "co_direct", "co_ranked"):
        with pytest.raises(ValueError, match="no feasibility projection"):
            refine_solutions(TASKS[name], torch.zeros(4, 3), torch.zeros(4, 9), {}, 3)


def _solver_noise(seed, n, T, D):
    gen = torch.Generator().manual_seed(seed)
    flat = torch.zeros((n, T + 1, D)).normal_(generator=gen).numpy()
    return flat[:, 0], flat[:, 1:].transpose(1, 0, 2)


def test_solver_refine_iters_matches_jax_and_bucket_invariance():
    """``Solver(refine_iters=20)`` on ``ckpts/ddpm_msr_3c`` (T=20), omega 0,
    against the JAX package's program on the Solver's noise (sampler,
    decode, then ``refine_solutions``); bucket 32 against no bucket on the
    same 24 real rows; refining never loses to the unrefined decode."""
    solver = Solver.from_checkpoint(str(MSR20), task="msr", device="cpu", backend="mega",
                                    dataset_config=MSR_CFG, refine_iters=20)
    cfg = solver.config
    X = np.random.default_rng(4).uniform(0, 1, (24, 3)).astype(np.float32)
    got = solver.solve(X, omega=0.0, seed=2)
    plain = Solver(solver.task, solver.model, solver.sched, cfg, backend="mega").solve(
        X, omega=0.0, seed=2)
    bucketed = Solver(solver.task, solver.model, solver.sched, cfg, backend="mega",
                      buckets=(32,), refine_iters=20).solve(X, omega=0.0, seed=2)
    jck = jax_load_checkpoint(str(MSR20))
    jt = JAX_TASKS["msr"]
    init, steps = _solver_noise(2, 24, 20, 3)
    cu = jnp.asarray(jt.unnormalize_x(X, cfg), jnp.float32)
    ref = np.asarray(jax.jit(lambda c, i, s: jax_refine_solutions(
        jt, jt.decode(jax_cfg_sample(jax_apply_fn(jt.build_model(cfg), "xla"), jck["params"],
                                     jck["sched"], c, 0.0, 3, init_noise=i, step_noise=s,
                                     skip_uncond=True)[0], cfg), cu, cfg, 20))(X, init, steps))
    g = np.asarray(cu)
    for other in (ref, bucketed):
        # Refinement's near-ties (see above): held by the mean rate; the
        # decodes it starts from agree to 1e-4.
        assert abs(_rate(got, g).mean() - _rate(other, g).mean()) <= 1e-5 * _rate(got, g).mean()
    assert (_rate(got, g) >= _rate(plain, g) - 1e-5).all()
    assert _rate(got, g).mean() > _rate(plain, g).mean()
    np.testing.assert_allclose(got.sum(1), 10.0, rtol=1e-5)
    assert [p.refine_iters for p in solver.programs] == [20]


def test_solver_refines_nu_geo_in_a_bucket():
    """``nu_geo`` serves in a bucket (its decode takes the mask and ignores
    it), refined, on rows of three geometries."""
    solver = Solver.from_checkpoint(str(REPO / "ckpts" / "ddpm_nu_geo_x0f"), task="nu_geo",
                                    device="cpu", backend="mega", buckets=(64,), refine_iters=10)
    X = np.random.default_rng(5).uniform(0, 1, (40, 9)).astype(np.float32)
    X[:, 6] = 1.0
    X[:, 7:] = np.repeat(np.array([0.5, 1.0, 1.5])[np.arange(40) % 3, None], 2, 1)
    S = solver.solve(X, sampler="ddim", n_steps=3, seed=1)
    unrefined = Solver(solver.task, solver.model, solver.sched, solver.config, backend="mega",
                       buckets=(64,)).solve(X, sampler="ddim", n_steps=3, seed=1)
    Xu = torch.tensor(solver.task.unnormalize_x(X, solver.config), dtype=torch.float32)
    box = Xu[:, 7:9].numpy()
    assert (S[:, :2] >= 0).all() and (S[:, :2] <= box * (1 + 1e-6)).all()
    np.testing.assert_allclose(S[:, 2:].sum(1), 18.0, rtol=1e-5)
    rate = solver.task.objective(torch.from_numpy(S), Xu, solver.config).numpy()
    base = solver.task.objective(torch.from_numpy(unrefined), Xu, solver.config).numpy()
    assert (rate >= base * (1 - 1e-6)).all() and rate.mean() > base.mean()


@pytest.mark.parametrize("name", ["msr_temp", "msr_refine", "nu_geo_refine"])
def test_refine_vs_jax_constants(name):
    """MSR-3c T=100 at omega 500 decoded by ``msr_temp`` and, on the same
    draws, by ``msr`` then 50 refinement steps; ``nu_geo`` DDIM-3 then 50
    steps. Held by the mean quality."""
    q0, port = check_vs_jax_constant(name)
    if name.startswith("msr"):
        assert (q0 <= 1 + 1e-5).all() and (port <= 1 + 1e-5).all()

"""The port's bucketed serving on the CPU against the JAX package's:
``suggest_buckets``, bucket invariance, the masked sampler and decoder,
``warmup(configs)``, ``solve_chunked`` and ``decode_with_x``."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.ops import nu_decode as jax_nu_decode, nu_rate as jax_nu_rate
from diffsg_tpu.serve import Solver as JaxSolver, suggest_buckets as jax_suggest_buckets
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.diffusion import cfg_sample
from diffsg_tpu_torch.models import unet_apply_fn
from diffsg_tpu_torch.ops import msr_decode, nu_decode, nu_rate
from diffsg_tpu_torch.serve import Solver, suggest_buckets
from diffsg_tpu_torch.tasks import TASKS

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NU = REPO / "ckpts" / "ddpm_nu_3u"
MSR = REPO / "ckpts" / "ddpm_msr_3c_T100"
NU_CFG = {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0}


def _nu_rows():
    """The 16 real NU conditions of the repo's fixture (test and train heads
    of the reference's 3-user, 18 mW data, loader-scaled)."""
    d = np.load(REPO / "tests" / "fixtures" / "nu_data_head.npz")
    return np.concatenate([d["X_test_head"], d["X_train_head"]]).astype(np.float32)


def _nu_solver(buckets=None, **kw):
    return Solver.from_checkpoint(str(NU), task="nu", device="cpu", dataset_config=NU_CFG,
                                  buckets=buckets, **kw)


@pytest.mark.parametrize("sizes,kw", [
    ([30, 60, 100, 500, 510, 520], {"max_buckets": 4}),
    (list(np.random.default_rng(0).integers(1, 5000, 200)), {}),
    (list(np.random.default_rng(1).integers(1, 300, 50)), {"max_buckets": 3, "align": 32}),
    (list(np.random.default_rng(2).integers(1, 9000, 1000)), {"max_buckets": 6, "dp": 48}),
    ([7], {}),
    ([], {}),
])
def test_suggest_buckets_matches_jax(sizes, kw):
    assert suggest_buckets(sizes, **kw) == jax_suggest_buckets(sizes, **kw)
    if sizes == [30, 60, 100, 500, 510, 520]:
        assert suggest_buckets(sizes, **kw) == [128, 512, 576]      # the docstring's


def _violation(a, b):
    """How far |a - b| exceeds JAX's bucket tolerance (rtol 1e-3, atol 1e-2;
    tests/test_serve.py::test_bucket_boundary_invariance); <= 0 passes."""
    return float(np.max(np.abs(a - b) - (1e-2 + 1e-3 * np.abs(b))))


def test_bucket_invariance_matches_jax():
    """Buckets (32,), (128,) and none on ckpts/ddpm_nu_3u (task nu, omega
    500), DDPM and DDIM-10, over seeds 0-9 on the same 16 real rows as the
    JAX package's own Solver."""
    X = _nu_rows()
    s32, s128, s_none = _nu_solver((32,)), _nu_solver((128,)), _nu_solver()
    jck = jax_load_checkpoint(str(NU))
    j32, j_none = (JaxSolver(JAX_TASKS["nu"], jck["params"], jck["sched"], NU_CFG, buckets=b)
                   for b in ((32,), None))
    port_ok = jax_ok = 0
    for seed in range(10):
        y32, y128, y_none = (s.solve(X, seed=seed) for s in (s32, s128, s_none))
        # Pad rows cannot move real ones: bucket 32 and bucket 128 agree
        # bit for bit (the masked sums only add zeros).
        np.testing.assert_array_equal(y32, y128)
        ddim = {"sampler": "ddim", "n_steps": 10}
        d32 = s32.solve(X, seed=seed, **ddim)
        np.testing.assert_array_equal(d32, s128.solve(X, seed=seed, **ddim))
        np.testing.assert_allclose(d32, s_none.solve(X, seed=seed, **ddim), rtol=1e-3, atol=1e-2)
        # Masked against unmasked statistics differ in their last bits, and
        # 20 steps of omega-500 guidance amplify that row by row; on these
        # rows JAX's own bucketed and unbucketed answers stay within its
        # tolerance on 8 of the 10 seeds (measured: seeds 5 and 8 exceed it
        # by 0.033 and 0.149 of 400-scale outputs), the port's on 8 (seeds 5
        # and 7, by 0.016 and 0.031). Hold the port to JAX's count.
        port_ok += _violation(y32, y_none) <= 0
        jax_ok += _violation(j32.solve(X, seed=seed), j_none.solve(X, seed=seed)) <= 0
    assert jax_ok == 8, jax_ok
    assert port_ok >= jax_ok, (port_ok, jax_ok)


def _nu_both():
    jck = jax_load_checkpoint(str(NU))
    solver = _nu_solver()
    return jck, solver


@pytest.mark.parametrize("omega", [0.0, 500.0])
def test_masked_sampler_and_decoder_match_jax(omega):
    """``cfg_sample(valid_mask=...)`` and the masked ``nu_decode`` against
    JAX's on the same injected noise: B = 1,024 rows of which 1,000 are
    real, the pad repeating the last condition. Elementwise at omega 0; at
    omega 500 guidance amplifies reassociation row by row (ROADMAP Queue 3,
    item 3), so there by the mean rate over the real rows."""
    jck, solver = _nu_both()
    B, n, T = 1024, 1000, solver.sched.T
    rng = np.random.default_rng(11)
    cond = rng.uniform(0, 1, (B, 6)).astype(np.float32)
    cond[n:] = cond[n - 1]
    init = rng.normal(size=(B, 5)).astype(np.float32)
    steps = rng.normal(size=(T, B, 5)).astype(np.float32)
    init[n:], steps[:, n:] = 0.0, 0.0
    valid = (np.arange(B) < n).astype(np.float32)[:, None]
    japply = jax_apply_fn(JAX_TASKS["nu"].build_model(NU_CFG), "xla")
    jy0 = jax.jit(lambda c, i, s, v: jax_cfg_sample(
        japply, jck["params"], jck["sched"], c, omega, 5, init_noise=i, step_noise=s,
        valid_mask=v)[0])(cond, init, steps, valid)
    jdec = np.asarray(jax_nu_decode(jy0, 400.0, 400.0, 18.0, valid_mask=jnp.asarray(valid)))
    with torch.no_grad():
        ty0 = cfg_sample(unet_apply_fn(solver.model, "fused"), solver.sched,
                         torch.from_numpy(cond), omega, 5, init_noise=torch.from_numpy(init),
                         step_noise=torch.from_numpy(steps), valid_mask=torch.from_numpy(valid))
        tdec = nu_decode(ty0, 400.0, 400.0, 18.0, valid_mask=torch.from_numpy(valid)).numpy()
    users = JAX_TASKS["nu"].unnormalize_x(cond, NU_CFG).astype(np.float32)
    if omega == 0.0:
        # f32 through 20 steps, reassociated: 1e-5 of y0's magnitude, as
        # tests/test_torch_sampler.py holds the MSR sampler; decoded
        # positions to 1e-3 of the 400 m side.
        jy0 = np.asarray(jy0)
        np.testing.assert_allclose(ty0.numpy(), jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())
        np.testing.assert_allclose(tdec[:n], jdec[:n], rtol=0, atol=0.4)
    jrate = float(np.mean(np.asarray(jax_nu_rate(jnp.asarray(jdec), jnp.asarray(users)))[:n]))
    trate = float(nu_rate(torch.from_numpy(tdec), torch.from_numpy(users))[:n].mean())
    assert trate == pytest.approx(jrate, rel=1e-3)


def test_warmup_reaches_every_bucket_and_config():
    solver = _nu_solver((8, 16))
    configs = [{}, {"best_of": 2, "omega": [0.0, 500.0]}, {"sampler": "ddim", "n_steps": 3},
               {"omega": 0.0, "sampler": "ddim", "n_steps": 3, "eta": 1.0}]
    solver.warmup(configs=configs)
    assert len(solver.programs) == 2 * len(configs)
    assert {p.bucket for p in solver.programs} == {8, 16}
    warmed = set(solver.programs)
    X = _nu_rows()
    for cfg in configs:                      # serving hits only warmed programs
        solver.solve(X[:5], **cfg)
        solver.solve(X[:13], **cfg)
    assert solver.programs == warmed
    solver.warmup(sizes=(4, 40))   # 4 pads to bucket 8; 40 is above every bucket
    assert len(solver.programs) == len(warmed) + 1


def test_solve_chunked_matches_serial_solves():
    X = np.concatenate([_nu_rows()] * 5)     # 80 rows: chunks of 32, 32, 16
    for solver in (_nu_solver((32,)), _nu_solver()):
        serial = np.concatenate([solver.solve(X[i:i + 32], omega=500.0, seed=3 + j)
                                 for j, i in enumerate(range(0, 80, 32))])
        np.testing.assert_array_equal(solver.solve_chunked(X, 32, seed=3, omega=500.0), serial)


def test_decode_with_x_sees_the_unnormalized_padded_conditions():
    msr = Solver.from_checkpoint(str(MSR), task="msr", device="cpu", buckets=(16,))
    seen = {}

    def decode_with_x(Y, X_unnorm, config, valid_mask=None):
        seen.update(Y=Y.clone(), X=X_unnorm.clone(), valid=valid_mask.clone())
        return config["W"] * msr_decode(Y, valid_mask)

    custom = Solver(dataclasses.replace(TASKS["msr"], decode_with_x=decode_with_x), msr.model,
                    msr.sched, msr.config, buckets=(16,))
    X = np.random.default_rng(2).uniform(0, 1, (11, 3)).astype(np.float32)
    P = custom.solve(X, omega=0.0, seed=4)
    Xp = np.concatenate([X, np.repeat(X[-1:], 5, axis=0)])
    np.testing.assert_array_equal(seen["X"].numpy(),
                                  TASKS["msr"].unnormalize_x(Xp, msr.config).astype(np.float32))
    np.testing.assert_array_equal(seen["valid"].numpy()[:, 0], np.arange(16) < 11)
    assert seen["Y"].shape == (16, 3)
    np.testing.assert_array_equal(P, msr.solve(X, omega=0.0, seed=4))

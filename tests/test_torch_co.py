"""The port's CO task family against the JAX package's: ``co_decode``,
``co_cost``, the closed-form oracle and decodes of ``baselines/co_exact.py``,
the ``unet_co`` net (``n_blocks=3``) on ``ckpts/ddpm_co`` through every
forward, the four CO tasks, a CPU ``Solver`` on the JAX package's program
with the same noise, objective guidance with ``co_soft_cost``, and the CO
quality constants of ``chip_smoke.py``."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.baselines import co_exact as jax_co_exact
from diffsg_tpu.data.loaders import load_co as jax_load_co
from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.ops import co_cost as jax_co_cost, co_decode as jax_co_decode
from diffsg_tpu.ops.pallas_mega import unet_forward_mega as jax_mega
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks.co import decision_class as jax_decision_class
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.baselines import co_exact
from diffsg_tpu_torch.diffusion import cfg_sample
from diffsg_tpu_torch.models import unet_apply_fn, unet_co
from diffsg_tpu_torch.ops import co_cost, co_decode, mega
from diffsg_tpu_torch.ops.mega import unet_forward_mega_reference
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import TASKS
from diffsg_tpu_torch.tasks.co import decision_class
from diffsg_tpu_torch.utils import params_from_jax

from test_torch_tasks import check_vs_jax_constant, chip_smoke

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
CO_CKPT = REPO / "ckpts" / "ddpm_co"
CFG = chip_smoke.CO_CONFIG


def _rows(B, seed):
    """Derived features (B, 9) in physical units, and raw samples (B, 3)
    with exact ties, all-below-minus-10 rows and saturated rows."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.01, 8.0, (B, 9)).astype(np.float32)
    Y = rng.normal(0, 3, (B, 3)).astype(np.float32)
    Y[:6] = np.round(Y[:6])                   # integer rows: ties
    Y[6:10, 2] = Y[6:10, 0]                   # a tie of nodes 0 and 2
    Y[10:12] = -20.0 + rng.normal(0, 1, (2, 3))   # all local
    Y[12:16] *= 400.0                         # omega-5000 magnitudes
    return X, Y


def test_co_fixture_is_the_jax_loaders_test_split():
    td = jax_load_co(str(REPO / "datasets" / "3nodes_50000samples_new.csv"))
    X, Y = chip_smoke.co_rows()
    assert X.shape == (4096, 9) and Y.shape == (4096, 3)
    np.testing.assert_array_equal(X, td.X_test[:4096].astype(np.float32))
    np.testing.assert_array_equal(Y, td.Y_test[:4096].astype(np.float32))
    assert {k: td.config[k] for k in CFG} == CFG


def test_co_decode_and_cost_match_fixtures_and_jax():
    fx = np.load(FIXTURES / "decoders.npz")
    y = fx["y_raw"].astype(np.float32)
    got = co_decode(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, fx["co_dec"], rtol=1e-5, atol=1e-7)   # test_core_numerics
    X, Y = _rows(64, seed=0)
    got = co_decode(torch.from_numpy(Y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_co_decode(jnp.asarray(Y))), rtol=0, atol=1e-7)
    assert (got[10:12] == 0).all() and (got[16:].sum(1) > 0.99).all()
    fx = np.load(FIXTURES / "objectives.npz")
    cost = co_cost(torch.from_numpy(fx["co_X"].astype(np.float32)),
                   torch.from_numpy(fx["co_Y"].astype(np.float32))).numpy()
    np.testing.assert_allclose(cost, fx["co_cost"], rtol=1e-5)
    dec = np.abs(Y) / np.abs(Y).sum(1, keepdims=True)
    dec[:4] = 0.0                                          # all-local rows
    dec[4:8, 1] = 0.05                                     # below the 0.1 decision
    tX, tY = torch.from_numpy(X), torch.from_numpy(dec.astype(np.float32)).requires_grad_(True)
    cost = co_cost(tX, tY)
    np.testing.assert_allclose(cost.detach().numpy(),
                               np.asarray(jax_co_cost(jnp.asarray(X), jnp.asarray(dec))),
                               rtol=1e-6)
    # The gradient refinement and guidance take.
    (g,) = torch.autograd.grad(cost.sum(), tY)
    jg = np.asarray(jax.grad(lambda d: jnp.sum(jax_co_cost(jnp.asarray(X), d)))(
        jnp.asarray(dec, jnp.float32)))
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("fn", ["co_optimal_allocation", "co_exact_solve", "co_soft_cost",
                                "co_ranked_decode", "co_direct_decode", "co_analytic_decode"])
def test_co_exact_functions_match_jax(fn):
    X, Y = _rows(96, seed=1)
    tX, tY = torch.from_numpy(X), torch.from_numpy(Y)
    jX, jY = jnp.asarray(X), jnp.asarray(Y)
    if fn == "co_optimal_allocation":
        D = (Y > 0).astype(np.float32)
        got = co_exact.co_optimal_allocation(tX[:, 2::3], torch.from_numpy(D)).numpy()
        ref = jax_co_exact.co_optimal_allocation(jX[:, 2::3], jnp.asarray(D))
    elif fn == "co_exact_solve":
        got, ref = co_exact.co_exact_solve(tX).numpy(), jax_co_exact.co_exact_solve(jX)
        # No decision beats the oracle's.
        for did in range(8):
            D = np.array([(did >> j) & 1 for j in range(3)], np.float32)[None].repeat(96, 0)
            alloc = co_exact.co_optimal_allocation(tX[:, 2::3], torch.from_numpy(D))
            assert (co_cost(tX, torch.from_numpy(got)) <= co_cost(tX, alloc) + 1e-4).all()
    elif fn == "co_soft_cost":
        tY.requires_grad_(True)
        cost = co_exact.co_soft_cost(tY, tX)
        (g,) = torch.autograd.grad(cost.sum(), tY)
        jg = np.asarray(jax.grad(lambda y: jnp.sum(jax_co_exact.co_soft_cost(y, jX)))(jY))
        np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
        got, ref = cost.detach().numpy(), jax_co_exact.co_soft_cost(jY, jX)
    elif fn == "co_ranked_decode":
        got, ref = co_exact.co_ranked_decode(tY, tX).numpy(), jax_co_exact.co_ranked_decode(jY, jX)
        # Ties rank in index order, as JAX's stable argsort does: rows
        # 0-9 hold ties, and each decodes as JAX's.
        tied = np.array([len(set(r)) < 3 for r in Y[:10]])
        assert tied.sum() >= 4
    elif fn == "co_direct_decode":
        got = co_exact.co_direct_decode(tY, tX, 2.0, [0.1, 0.0, -0.1]).numpy()
        ref = jax_co_exact.co_direct_decode(jY, jX, 2.0, np.asarray([0.1, 0.0, -0.1], np.float32))
        np.testing.assert_allclose(co_exact.co_direct_decode(tY, tX).numpy(),
                                   np.asarray(jax_co_exact.co_direct_decode(jY, jX)), atol=1e-6)
    else:
        got, ref = co_exact.co_analytic_decode(tY, tX).numpy(), \
            jax_co_exact.co_analytic_decode(jY, jX)
        assert (got[10:12] == 0).all()
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    if fn != "co_soft_cost":
        # Shares: zeros (all local) or a split of 1 over the offloaded nodes.
        sums = got.sum(1)
        assert (got >= 0).all() and np.all((sums == 0) | (np.abs(sums - 1) <= 1e-5))


def test_unet_co_on_ddpm_co_every_forward_matches_flax_and_jax_mega():
    """``ckpts/ddpm_co`` loads strictly into ``unet_co(3)``: 37 residual
    blocks a forward and 20 skips. Plain, CPU-fused and the mega reference
    against flax, and the mega reference against JAX's mega kernel in
    interpret mode, B = 96 in 32-row tiles."""
    jck = jax_load_checkpoint(str(CO_CKPT))
    model = unet_co(3)
    model.load_state_dict(params_from_jax(jck["params"]), strict=True)
    jmodel = JAX_TASKS["co"].build_model(CFG)
    assert model.n_blocks == 3 and model.cond_dim == 9
    assert sum(p.numel() for p in model.parameters()) == 774_059
    n_blocks = model.down_kinds.count("block") + 2 + model.up_kinds.count("block")
    assert n_blocks == 37
    packed = mega.pack_params(model, torch.float32, torch.device("cpu"))
    assert int((packed.table[:, mega.K_FLAGS] & mega.F_PUSH != 0).sum()) == 20
    assert int((packed.table[:, mega.K_FLAGS] & mega.F_CONCAT != 0).sum()) == 20
    rng = np.random.default_rng(2)
    B = 96
    y = rng.normal(size=(B, 3)).astype(np.float32)
    t = np.array([0.45], np.float32)
    c = rng.uniform(size=(B, 9)).astype(np.float32)
    m = np.concatenate([np.zeros((B // 2, 1)), np.ones((B // 2, 1))]).astype(np.float32)
    flax_out = np.asarray(jmodel.apply({"params": jck["params"]}, y, np.broadcast_to(t, (B,)), c, m))
    jmega = np.asarray(jax_mega(jck["params"], jmodel, y, t, c, m, tile_rows=32, interpret=True))
    ins = [torch.from_numpy(a) for a in (y, t, c, m)]
    with torch.no_grad():
        outs = {"plain": model(*ins), "fused": unet_apply_fn(model, "fused")(*ins),
                "mega": unet_apply_fn(model, "mega")(*ins),
                "mega_reference": unet_forward_mega_reference(model, *ins)}
    scale = np.abs(flax_out).max()
    for name, out in outs.items():
        # The forward tolerance of test_torch_unet.py: 1e-4 of the output's magnitude.
        np.testing.assert_allclose(out.numpy(), flax_out, rtol=0, atol=1e-4 * scale, err_msg=name)
    np.testing.assert_allclose(outs["mega_reference"].numpy(), jmega, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["co", "co_analytic", "co_direct", "co_ranked"])
def test_co_task_decodes_match_jax(name):
    task, jt = TASKS[name], JAX_TASKS[name]
    cfg = dict(CFG, y_scale=2.0)
    assert (task.data_dim(cfg), task.cond_dim(cfg)) == (jt.data_dim(cfg), jt.cond_dim(cfg)) == (3, 9)
    assert task.higher_is_better is False and task.default_omega == jt.default_omega
    Xn = chip_smoke.co_rows()[0][:64]
    X = np.asarray(task.unnormalize_x(Xn, cfg), np.float32)
    np.testing.assert_array_equal(X, np.asarray(jt.unnormalize_x(Xn, cfg), np.float32))
    Y = _rows(64, seed=3)[1]
    tY, tX = torch.from_numpy(Y), torch.from_numpy(X)
    if task.decode_with_x is None:
        got, ref = task.decode(tY, cfg), jt.decode(jnp.asarray(Y), cfg)
    else:
        got = task.decode_with_x(tY, tX, cfg, valid_mask=torch.ones(64, 1))
        ref = jt.decode_with_x(jnp.asarray(Y), jnp.asarray(X), cfg)
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    pred = task.objective(torch.from_numpy(got), tX, cfg).numpy()
    np.testing.assert_allclose(pred, np.asarray(jt.objective(jnp.asarray(got), jnp.asarray(X), cfg)),
                               rtol=1e-6)
    true = task.objective(co_exact.co_exact_solve(tX), tX, cfg).numpy()
    Y_true = co_exact.co_exact_solve(tX).numpy()
    metrics = task.extra_metrics(got, Y_true, pred, true, cfg)
    assert metrics == jt.extra_metrics(got, Y_true, pred, true, cfg)
    np.testing.assert_array_equal(decision_class(got), jax_decision_class(got))


def _solver_noise(seed, n, T, D):
    """The noise ``Solver.solve(seed=seed)`` draws for n rows, one candidate."""
    gen = torch.Generator().manual_seed(seed)
    flat = torch.zeros((n, T + 1, D)).normal_(generator=gen).numpy()
    return flat[:, 0], flat[:, 1:].transpose(1, 0, 2)


def test_co_solvers_at_omega0_match_jax_on_their_noise():
    """A CPU Solver for co, co_ranked and co_direct on ``ckpts/ddpm_co`` at
    omega 0, elementwise against the JAX package's program (the sampler on
    the same noise, then the task's decode). Bucketed (32) equals
    unbucketed: CO decodes are per row."""
    Xn = chip_smoke.co_rows()[0][100:124]
    jck = jax_load_checkpoint(str(CO_CKPT))
    init, steps = _solver_noise(5, 24, 20, 3)
    jy0 = jax.jit(lambda c, i, s: jax_cfg_sample(
        jax_apply_fn(JAX_TASKS["co"].build_model(CFG), "xla"), jck["params"], jck["sched"], c,
        0.0, 3, init_noise=i, step_noise=s, skip_uncond=True)[0])(Xn, init, steps)
    for name in ("co", "co_ranked", "co_direct"):
        jt = JAX_TASKS[name]
        cu = jnp.asarray(jt.unnormalize_x(Xn, CFG), jnp.float32)
        ref = np.asarray(jt.decode_with_x(jy0, cu, CFG) if jt.decode_with_x else jt.decode(jy0, CFG))
        solver = Solver.from_checkpoint(str(CO_CKPT), task=name, device="cpu", backend="mega",
                                        dataset_config=CFG)
        got = solver.solve(Xn, omega=0.0, seed=5)
        # y0 agrees to ~1e-5 (f32, reassociated); shares to 1e-4.
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4, err_msg=name)
        bucketed = Solver(solver.task, solver.model, solver.sched, solver.config, backend="mega",
                          buckets=(32,))
        np.testing.assert_allclose(bucketed.solve(Xn, omega=0.0, seed=5), got, rtol=0, atol=1e-6)
        with pytest.raises(ValueError, match="no feasibility projection"):
            Solver(solver.task, solver.model, solver.sched, solver.config,
                   refine_iters=2).solve(Xn[:4])


@pytest.mark.parametrize("name", ["co", "co_ranked", "co_direct"])
def test_co_vs_jax_constants(name):
    """``co_ranked`` at omega 5000 (and ``co`` at 500) is held by the mean
    cost ratio to ``co_exact_solve``: row by row, guidance amplifies the
    last bits of two f32 forwards."""
    q0, port = check_vs_jax_constant(name)
    assert (q0 >= 1 - 1e-5).all() and (port >= 1 - 1e-5).all()


@pytest.mark.parametrize("relative,scale", [(False, 0.05), (True, 0.5)])
def test_co_soft_cost_guidance_matches_jax(relative, scale):
    """``cfg_sample(guidance_fn=co_soft_cost)`` on ``ckpts/ddpm_co``, omega
    0, the same injected noise, as ``tools/co_guided.py`` drives JAX's."""
    jck = jax_load_checkpoint(str(CO_CKPT))
    model = unet_co(3)
    model.load_state_dict(params_from_jax(jck["params"]), strict=True)
    sched = Solver.from_checkpoint(str(CO_CKPT), task="co", device="cpu",
                                   dataset_config=CFG).sched
    Xn = chip_smoke.co_rows()[0][:32]
    cu = np.asarray(TASKS["co"].unnormalize_x(Xn, CFG), np.float32)
    init, steps = chip_smoke.seeded_noise(7, 32, 20, 3)
    jy0 = np.asarray(jax.jit(lambda c, x, i, s: jax_cfg_sample(
        jax_apply_fn(JAX_TASKS["co"].build_model(CFG), "xla"), jck["params"], jck["sched"], c,
        0.0, 3, init_noise=i, step_noise=s,
        guidance_fn=lambda x0: jax_co_exact.co_soft_cost(x0, x), guidance_scale=scale,
        guidance_relative=relative)[0])(Xn, cu, init, steps))
    tcu = torch.from_numpy(cu)
    y0 = cfg_sample(unet_apply_fn(model, "fused"), sched, torch.from_numpy(Xn), 0.0, 3,
                    init_noise=torch.from_numpy(init), step_noise=torch.from_numpy(steps),
                    guidance_fn=lambda x0: co_exact.co_soft_cost(x0, tcu),
                    guidance_scale=scale, guidance_relative=relative).numpy()
    plain = cfg_sample(unet_apply_fn(model, "fused"), sched, torch.from_numpy(Xn), 0.0, 3,
                       init_noise=torch.from_numpy(init), step_noise=torch.from_numpy(steps)).numpy()
    # f32 through 20 steps, reassociated: 1e-4 of y0's magnitude.
    np.testing.assert_allclose(y0, jy0, rtol=0, atol=1e-4 * np.abs(jy0).max())
    # The guidance moved the samples.
    assert np.abs(y0 - plain).max() > 100 * 1e-4 * np.abs(jy0).max()

"""The port's MSR and NU task variants against the JAX package's: the
``msr_temp``, ``msr_wf`` and ``msr_budget`` decodes (with and without a
validity mask), the ``nu_budget`` and ``nu_geo`` decodes, projections,
preconditioner and unnormalizations, ``tasks/condition.py``, the
conditioned checkpoints' forwards and x0 DDIM, ``TASKS``, and the quality
constants ``chip_smoke.py`` holds the card to.

``jax_quality`` here is the JAX side of every constant of
``chip_smoke.JAX_QUALITY``; ``tests/test_torch_co.py`` and
``test_torch_refine.py`` use it too."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.baselines import waterfilling as jax_waterfilling
from diffsg_tpu.baselines.co_exact import co_exact_solve as jax_co_exact_solve
from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample, ddim_sample as jax_ddim_sample
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks import condition as jax_condition
from diffsg_tpu.tasks.multi import merge_multi_config as jax_merge_multi_config
from diffsg_tpu.tasks.base import refine_solutions as jax_refine_solutions
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.diffusion import ddim_sample
from diffsg_tpu_torch.models import unet_apply_fn
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import TASKS
from diffsg_tpu_torch.tasks import condition

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = REPO / "ckpts"
Y_SHIFT = [0.46, 0.46, 0.33, 0.33, 0.33]
MSR_CFG = {"M": 3, "W": 10.0, "w_ref": 10.0, "scaler_min": 0.5, "scaler_max": 2.5, "y_scale": 3.0}
NU_CFG = {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0, "p_ref": 18.0,
          "w_ref": 400.0, "h_ref": 400.0, "y_scale": 8.0, "y_shift": Y_SHIFT}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip_smoke = _chip_smoke()


_DRAWS = {}


def _jax_draw_fn(ckpt, model, sampler, sched, D, param, skip):
    """One jitted sampler per net architecture and sampler: params, the
    schedule (DDPM's; JAX's DDIM reads its schedule on the host) and omega
    are arguments, so DDPM checkpoints of one architecture share a
    compile."""
    # A multi-task face's adapter is keyed by its net and its slot.
    arch = ((repr(model.inner), model.slot_idx, model.payload_dim) if hasattr(model, "inner")
            else repr(model))
    if sampler == "ddpm":
        key = (arch, sampler, sched.T, D, param, skip)
        if key not in _DRAWS:
            apply = jax_apply_fn(model, "xla")
            _DRAWS[key] = jax.jit(lambda p, sch, c, w, i, s: jax_cfg_sample(
                apply, p, sch, c, w, D, init_noise=i, step_noise=s, parameterization=param,
                skip_uncond=skip)[0])
        return _DRAWS[key]
    key = (ckpt, sampler, param, skip)
    if key not in _DRAWS:
        apply = jax_apply_fn(model, "xla")
        _DRAWS[key] = jax.jit(lambda p, sch, c, w, i, s: jax_ddim_sample(
            apply, p, sched, c, w, D, n_steps=sampler[1], init_noise=i,
            parameterization=param, skip_uncond=skip)[0])
    return _DRAWS[key]


def jax_config(metadata, task_name, config):
    """The config ``diffsg_tpu.serve.Solver.from_checkpoint`` builds: the
    recorded dataset config, for a multi-task face its subtask's config and
    the shared architecture, then ``config``."""
    cfg = dict(metadata.get("dataset_config") or {})
    if task_name.startswith("multi_") and "subtask_configs" in metadata:
        slot = task_name.split("_", 1)[1]
        cfg.update(metadata["subtask_configs"].get(slot) or {})
        jax_merge_multi_config(cfg, metadata, slot)
    cfg.update(config)
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_y0(ckpt, task_name, config_items, sampler, omega, rows, seed):
    jck = jax_load_checkpoint(str(CKPTS / ckpt))
    cfg = jax_config(jck["metadata"], task_name, dict(config_items))
    jt = JAX_TASKS[task_name]
    X = chip_smoke.quality_rows(rows)
    D, T = jt.data_dim(cfg), jck["sched"].T
    init, steps = chip_smoke.seeded_noise(seed, X.shape[0], T if sampler == "ddpm" else 0, D)
    model = jt.build_model(cfg)
    draw = _jax_draw_fn(ckpt, model, sampler, jck["sched"], D, cfg.get("parameterization", "eps"),
                        omega == 0.0)
    y0 = draw(jck["params"], jck["sched"], X, jnp.float32(omega), init, steps)
    return np.asarray(y0), cfg


def jax_quality(name, seed):
    """The JAX package's per-row quality on ``chip_smoke.QUALITY_SPECS[name]``
    with the noise of ``seed`` (flax forward), as ``port_quality`` reckons
    it: CO cost over co_exact_solve's, MSR rate over waterfilling's at the
    row's budget, NU rate."""
    spec = chip_smoke.QUALITY_SPECS[name]
    y0, cfg = _jax_y0(spec["ckpt"], spec["task"], tuple(sorted((spec.get("config") or {}).items())),
                      spec.get("sampler", "ddpm"), spec["omega"], spec["rows"], seed)
    jt = JAX_TASKS[spec["task"]]
    cu = jnp.asarray(jt.unnormalize_x(chip_smoke.quality_rows(spec["rows"]), cfg), jnp.float32)
    y0 = jnp.asarray(y0)
    dec = jt.decode_with_x(y0, cu, cfg) if jt.decode_with_x is not None else jt.decode(y0, cfg)
    if spec.get("refine"):
        dec = jax.jit(lambda Y, Xu: jax_refine_solutions(jt, Y, Xu, cfg, spec["refine"]))(dec, cu)
    score = jt.objective(dec, cu, cfg)
    kind = spec["rows"][0]
    if kind == "co":
        score = score / jt.objective(jax_co_exact_solve(cu), cu, cfg)
    elif kind == "msr":
        score = score / jt.objective(jax_waterfilling(cu[:, :cfg["M"]], cfg["W"]), cu, cfg)
    return np.asarray(score, np.float64)


def check_vs_jax_constant(name):
    """JAX's seed-0 mean is ``chip_smoke.JAX_QUALITY[name]``'s constant, its
    tolerance is 4 standard errors of the difference of JAX's seed-0 and
    seed-1 means (at least 1e-6 of the mean), and the port's plain forward
    on the CPU, on seed 0's noise, lands within
    ``chip_smoke.SAME_NOISE_SHARE`` of it."""
    mean, tol = chip_smoke.JAX_QUALITY[name]
    q0, q1 = jax_quality(name, 0), jax_quality(name, 1)
    assert q0.mean() == pytest.approx(mean, rel=1e-6)
    spread = 4 * np.std(q1 - q0, ddof=1) / np.sqrt(q0.size)
    assert tol == pytest.approx(max(spread, 1e-6 * abs(mean)), rel=1e-3)
    port = chip_smoke.port_quality(name, 0, device="cpu", backend="plain")[0]
    assert port.shape == q0.shape and np.isfinite(port).all()
    assert abs(port.mean() - mean) <= chip_smoke.SAME_NOISE_SHARE * tol, (port.mean(), mean, tol)
    return q0, port


def test_tasks_has_every_non_multi_name():
    names = {"msr", "msr_temp", "msr_wf", "msr_budget", "co", "co_analytic", "co_direct",
             "co_ranked", "nu", "nu_direct", "nu_budget", "nu_geo"}
    assert {n for n in TASKS if not n.startswith("multi")} == names
    assert names == {n for n in JAX_TASKS if not n.startswith("multi")}
    for name, task in TASKS.items():
        jt = JAX_TASKS[name]
        assert task.name == name
        assert task.higher_is_better == jt.higher_is_better
        assert task.default_omega == jt.default_omega
        assert (task.project is None) == (jt.project is None)
        assert task.refine_step == jt.refine_step
        assert (task.refine_precond is None) == (jt.refine_precond is None)
        assert (task.decode_with_x is None) == (jt.decode_with_x is None)
        assert (task.extra_metrics is None) == (jt.extra_metrics is None)


def _msr_inputs(B, C, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.1, 1, (B, C)).astype(np.float32)
    if C > 3:
        X[:, 3] = rng.uniform(0.5, 2.5, B)
    return X, rng.normal(0, 3, (B, 3)).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["msr_temp", "msr_wf", "msr_budget"])
def test_msr_variant_decodes_match_jax(name, masked):
    task, jt = TASKS[name], JAX_TASKS[name]
    C = task.cond_dim(MSR_CFG)
    assert C == jt.cond_dim(MSR_CFG) and task.data_dim(MSR_CFG) == jt.data_dim(MSR_CFG) == 3
    X, Y = _msr_inputs(48, C, seed=len(name) + masked)
    Xu = np.asarray(task.unnormalize_x(X, MSR_CFG), np.float32)
    np.testing.assert_array_equal(Xu, np.asarray(jt.unnormalize_x(X, MSR_CFG), np.float32))
    if masked:
        # Pad rows far outside the real ones: only the mask keeps them out.
        Y[40:] = 50.0
    valid = (np.arange(48) < 40).astype(np.float32)[:, None]
    kw, jkw = ({"valid_mask": torch.from_numpy(valid)}, {"valid_mask": jnp.asarray(valid)}) \
        if masked else ({}, {})
    got = task.decode_with_x(torch.from_numpy(Y), torch.from_numpy(Xu), MSR_CFG, **kw).numpy()
    ref = np.asarray(jt.decode_with_x(jnp.asarray(Y), jnp.asarray(Xu), MSR_CFG, **jkw))
    # Softmax and sort-based projections of the same f32 values: to 1e-6 of W.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert (got >= 0).all()
    np.testing.assert_allclose(got.sum(1), MSR_CFG["W"], rtol=1e-5)
    obj = task.objective(torch.from_numpy(got), torch.from_numpy(Xu), MSR_CFG).numpy()
    np.testing.assert_allclose(obj, np.asarray(jt.objective(jnp.asarray(got), jnp.asarray(Xu),
                                                            MSR_CFG)), rtol=1e-6)
    if masked and name == "msr_temp":
        # The real rows equal a decode of the real rows alone.
        alone = task.decode_with_x(torch.from_numpy(Y[:40]), torch.from_numpy(Xu[:40]),
                                   MSR_CFG).numpy()
        np.testing.assert_allclose(got[:40], alone, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["msr", "msr_budget"])
def test_msr_projections_match_jax(name):
    task, jt = TASKS[name], JAX_TASKS[name]
    X, Y = _msr_inputs(64, task.cond_dim(MSR_CFG), seed=7)
    Xu = np.asarray(task.unnormalize_x(X, MSR_CFG), np.float32)
    got = task.project(torch.from_numpy(Y), torch.from_numpy(Xu), MSR_CFG).numpy()
    ref = np.asarray(jt.project(jnp.asarray(Y), jnp.asarray(Xu), MSR_CFG))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    W = Xu[:, 3] if name == "msr_budget" else MSR_CFG["W"]
    np.testing.assert_allclose(got.sum(1), W, rtol=1e-5)
    assert task.refine_step == 0.25


def _nu_inputs(name, B, seed):
    rng = np.random.default_rng(seed)
    C = TASKS[name].cond_dim(NU_CFG)
    X = rng.uniform(0, 1, (B, C)).astype(np.float32)
    X[:, 6] = rng.uniform(0.5, 2.0, B)                    # budget / p_ref
    if name == "nu_geo":
        X[:, 7:] = rng.choice([0.5, 1.0, 1.2, 1.5], (B, 2))  # W / w_ref, H / h_ref
    return X, rng.normal(0, 3, (B, 5)).astype(np.float32)


@pytest.mark.parametrize("name", ["nu_budget", "nu_geo"])
def test_nu_conditioned_tasks_match_jax(name):
    """Unnormalization, decode, objective, projection and preconditioner."""
    task, jt = TASKS[name], JAX_TASKS[name]
    assert task.cond_dim(NU_CFG) == jt.cond_dim(NU_CFG)
    X, Y = _nu_inputs(name, 64, seed=3)
    Xu = np.asarray(task.unnormalize_x(X, NU_CFG), np.float32)
    np.testing.assert_array_equal(Xu, np.asarray(jt.unnormalize_x(X, NU_CFG), np.float32))
    tY, tX = torch.from_numpy(Y), torch.from_numpy(Xu)
    if name == "nu_geo":
        got = task.decode_with_x(tY, tX, NU_CFG).numpy()
        ref = np.asarray(jt.decode_with_x(jnp.asarray(Y), jnp.asarray(Xu), NU_CFG))
        # Per row: a mask changes nothing (the JAX function takes none).
        masked = task.decode_with_x(tY, tX, NU_CFG, valid_mask=torch.ones(64, 1)).numpy()
        np.testing.assert_array_equal(masked, got)
        box, budget = Xu[:, 7:9], Xu[:, 6]
    else:
        got = task.decode(tY, NU_CFG).numpy()
        ref = np.asarray(jt.decode(jnp.asarray(Y), NU_CFG))
        box, budget = np.array([[400.0, 400.0]]), NU_CFG["P_sum"]
    # Positions on fields of up to 600 m, powers of up to 36 mW: 1e-4 of them.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert (got[:, :2] >= 0).all() and (got[:, :2] <= box * (1 + 1e-6)).all()
    np.testing.assert_allclose(got[:, 2:].sum(1), budget, rtol=1e-5)
    obj = task.objective(torch.from_numpy(ref), tX, NU_CFG).numpy()
    np.testing.assert_allclose(obj, np.asarray(jt.objective(jnp.asarray(ref), jnp.asarray(Xu),
                                                            NU_CFG)), rtol=1e-5)
    Yp = ref + np.random.default_rng(4).normal(0, 50, ref.shape).astype(np.float32)
    proj = task.project(torch.from_numpy(Yp), tX, NU_CFG).numpy()
    np.testing.assert_allclose(proj, np.asarray(jt.project(jnp.asarray(Yp), jnp.asarray(Xu),
                                                           NU_CFG)), rtol=0, atol=1e-4)
    row_budget = Xu[:, 6]
    np.testing.assert_allclose(proj[:, 2:].sum(1), row_budget, rtol=1e-5)
    np.testing.assert_array_equal(task.refine_precond(NU_CFG), jt.refine_precond(NU_CFG))
    assert task.refine_step == jt.refine_step == 1.0


def test_nu_direct_inherits_projection_and_precond():
    nu, nd = TASKS["nu"], TASKS["nu_direct"]
    assert nd.project is nu.project and nd.refine_precond is nu.refine_precond
    assert nd.refine_step == nu.refine_step == 1.0
    cfg = {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 300.0}
    np.testing.assert_array_equal(nd.refine_precond(cfg), JAX_TASKS["nu_direct"].refine_precond(cfg))
    Y = np.random.default_rng(5).normal(200, 300, (32, 5)).astype(np.float32)
    got = nd.project(torch.from_numpy(Y), None, cfg).numpy()
    np.testing.assert_allclose(got, np.asarray(JAX_TASKS["nu_direct"].project(jnp.asarray(Y), None,
                                                                              cfg)), atol=1e-4)


@pytest.mark.parametrize("kind", ["msr", "co", "nu"])
def test_condition_c_matches_jax(kind):
    rng = np.random.default_rng(6)
    if kind == "nu":
        y, x = rng.normal(0, 2, (32, 5)), rng.uniform(0, 400, (32, 6))
        args = (400.0, 400.0, 18.0)
    else:
        y, x = rng.normal(0, 2, (32, 3)), rng.uniform(0, 1, (32, 3 if kind == "msr" else 9))
        args = (0.5, 2.5)
    y, x = y.astype(np.float32), x.astype(np.float32)
    got = getattr(condition, f"condition_c_{kind}")(torch.from_numpy(y), torch.from_numpy(x),
                                                     *args).numpy()
    ref = np.asarray(getattr(jax_condition, f"condition_c_{kind}")(jnp.asarray(y), jnp.asarray(x),
                                                                   *args))
    assert got.shape == (32, x.shape[1] + 1)
    np.testing.assert_array_equal(got[:, :-1], x)
    np.testing.assert_allclose(got[:, -1], ref[:, -1], rtol=1e-5)


@pytest.mark.parametrize("ckpt,task,C", [("ddpm_msr_budget", "msr_budget", 4),
                                         ("ddpm_nu_geo_x0f", "nu_geo", 9)])
def test_conditioned_checkpoint_forward_and_x0_ddim_match_jax(ckpt, task, C):
    """Strict loads; the fused forward against flax; DDIM-3 with the
    checkpoint's parameterization, omega 0, on the same y_T."""
    solver = Solver.from_checkpoint(str(CKPTS / ckpt), task=task, device="cpu")
    jck = jax_load_checkpoint(str(CKPTS / ckpt))
    cfg = dict(jck["metadata"]["dataset_config"])
    jmodel = JAX_TASKS[task].build_model(cfg)
    assert solver.model.cond_dim == C
    D = solver.task.data_dim(solver.config)
    rng = np.random.default_rng(8)
    B = 32
    y = rng.normal(size=(B, D)).astype(np.float32)
    c = rng.uniform(0.3, 1, (B, C)).astype(np.float32)
    m = np.concatenate([np.zeros((B // 2, 1)), np.ones((B // 2, 1))]).astype(np.float32)
    t = np.full((B,), 0.4, np.float32)
    ref = np.asarray(jmodel.apply({"params": jck["params"]}, y, t, c, m))
    with torch.no_grad():
        got = unet_apply_fn(solver.model, "fused")(*[torch.from_numpy(a) for a in
                                                     (y, t[:1], c, m)]).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    param = cfg.get("parameterization", "eps")
    jy0 = jax.jit(lambda cc, i: jax_ddim_sample(jax_apply_fn(jmodel, "xla"), jck["params"],
                                                jck["sched"], cc, 0.0, D, n_steps=3,
                                                init_noise=i, parameterization=param,
                                                skip_uncond=True)[0])(c, y)
    ty0 = ddim_sample(unet_apply_fn(solver.model, "mega"), solver.sched, torch.from_numpy(c), 0.0,
                      D, n_steps=3, init_noise=torch.from_numpy(y), parameterization=param,
                      skip_uncond=True).numpy()
    jy0 = np.asarray(jy0)
    # f32 through 3 steps at omega 0: 1e-5 of y0's magnitude.
    np.testing.assert_allclose(ty0, jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())


@pytest.mark.parametrize("name", ["msr_wf", "msr_budget_5", "msr_budget_25", "nu_budget",
                                  "nu_geo"])
def test_task_vs_jax_constants(name):
    q0, port = check_vs_jax_constant(name)
    if name.startswith("msr"):
        assert (q0 <= 1 + 1e-5).all() and (port <= 1 + 1e-5).all()

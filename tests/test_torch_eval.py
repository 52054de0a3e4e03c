"""The port's eval loop (``tasks.base``: ``sample_solutions``,
``sample_best_of_n``, ``objective_metrics``, ``evaluate``) against the JAX
package's, on the multi-task checkpoints and the repository's data.

The loop is held elementwise by feeding the port's own torch noise, drawn
in the order its docstring states, to the JAX sampler and decode batch by
batch; ``evaluate`` with its own noise is held to the JAX package's
constants (``chip_smoke.EVAL_JAX``), which the card is held to as well.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample, ddim_sample as jax_ddim_sample
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks.base import _make_draw as jax_make_draw
from diffsg_tpu.tasks.base import objective_metrics as jax_objective_metrics
from diffsg_tpu.tasks.base import sample_best_of_n as jax_sample_best_of_n
from diffsg_tpu.tasks.base import sample_solutions as jax_sample_solutions
from diffsg_tpu.tasks.base import select_best as jax_select_best
from diffsg_tpu.tasks.co import decision_class as jax_decision_class
from diffsg_tpu.tasks.multi import merge_multi_config as jax_merge_multi_config
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.data import ensure_datasets
from diffsg_tpu_torch.tasks import (TASKS, evaluate, merge_multi_config, objective_metrics,
                                    sample_best_of_n, sample_solutions)
from diffsg_tpu_torch.utils import load_checkpoint

from test_torch_tasks import chip_smoke

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = REPO / "ckpts"


def eval_spec(name):
    """``chip_smoke.EVAL_SPECS[name]``, or the zoo's ``EVAL_ZOO_SPECS[name]``."""
    return {**chip_smoke.EVAL_SPECS, **chip_smoke.EVAL_ZOO_SPECS}[name]


@functools.lru_cache(maxsize=None)
def _port_data(name):
    """The port's loader and the port's checkpoint for eval spec ``name``."""
    spec = eval_spec(name)
    ck = load_checkpoint(str(CKPTS / spec["ckpt"]), device="cpu")
    task = TASKS[spec["task"]]
    data = task.load(str(ensure_datasets([spec["csv"]])[spec["csv"]]), **spec.get("load_kw", {}))
    merge_multi_config(data.config, ck["metadata"], spec["task"].split("_", 1)[1])
    return task, ck, data


def _jax_draws(face, ckpt, cfg, X, noise_batches, omega, sampler="ddpm", n_steps=None):
    """The JAX package's sampler and decode on the port's noise, batch by
    batch: noise (b, columns, D) row-major, column 0 y_T, then the z's."""
    jck = jax_load_checkpoint(str(CKPTS / ckpt))
    jt = JAX_TASKS[face]
    model = jt.build_model(cfg)
    D, param, skip = jt.data_dim(cfg), cfg.get("parameterization", "eps"), omega == 0.0

    def apply(p, y, t, c, m):
        return model.apply({"params": p}, y, t, c, m)

    @jax.jit
    def run(c, cu, noise):
        if sampler == "ddim":
            y0 = jax_ddim_sample(apply, jck["params"], jck["sched"], c, omega, D, n_steps=n_steps,
                                 init_noise=noise[:, 0], parameterization=param,
                                 skip_uncond=skip)[0]
        else:
            y0 = jax_cfg_sample(apply, jck["params"], jck["sched"], c, omega, D,
                                init_noise=noise[:, 0],
                                step_noise=jnp.transpose(noise[:, 1:], (1, 0, 2)),
                                parameterization=param, skip_uncond=skip)[0]
        return jt.decode_with_x(y0, cu, cfg)

    Xu = jt.unnormalize_x(X, cfg)
    outs, i = [], 0
    for noise in noise_batches:
        b = noise.shape[0]
        outs.append(np.asarray(run(X[i:i + b].astype(np.float32),
                                   Xu[i:i + b].astype(np.float32), noise)))
        i += b
    return np.concatenate(outs)


def _port_noise(N, batch_size, columns, D, seed):
    """The noise ``sample_solutions`` draws on the CPU: one generator seeded
    by ``seed``, one (b, columns, D) draw a batch."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((min(batch_size, N - i), columns, D), generator=gen).numpy()
            for i in range(0, N, batch_size)]


# (eval spec, rows, batch size, omega, the share of rows that may part, the
# tolerance on the others relative to the solutions' magnitude). At omega 0
# every row agrees to float32 rounding through the 20 steps; at omega 500
# guidance multiplies a last-bit difference of the two forwards by 1,000,
# and on CO 7 of 600 rows take another offload decision (1.2%).
ELEMENTWISE = [("multi_co", 600, 256, 0.0, 0.0, 1e-6),
               ("multi_nu_geo_480x360", 300, 128, 0.0, 0.0, 1e-5),
               ("multi_co", 600, 256, 500.0, 0.02, 1e-6)]


@pytest.mark.parametrize("name,rows,batch,omega,part,atol", ELEMENTWISE)
def test_sample_solutions_matches_jax_with_the_same_noise(name, rows, batch, omega, part, atol):
    """Batch by batch at ``batch`` rows, with a last partial batch."""
    assert rows % batch
    task, ck, data = _port_data(name)
    spec = chip_smoke.EVAL_SPECS[name]
    X = data.X_test[:rows]
    cfg = data.config
    got, traces = sample_solutions(task, ck["params"], ck["sched"], X, cfg, omega, batch, seed=3,
                                   backend="plain")
    assert traces is None and got.shape[0] == rows
    noise = _port_noise(rows, batch, ck["sched"].T + 1, task.data_dim(cfg), seed=3)
    ref = _jax_draws(spec["task"], spec["ckpt"], cfg, X, noise, omega)
    scale = max(float(np.abs(ref).max()), 1.0)
    off = np.abs(got - ref).max(axis=1) > atol * scale
    assert off.mean() <= part, (int(off.sum()), rows)
    np.testing.assert_allclose(got[~off], ref[~off], rtol=0, atol=atol * scale)


def test_sample_solutions_ddim_and_trace():
    """DDIM draws one column (y_T); ``record_trace`` returns each DDPM
    batch's trajectory, whose last state decodes to the batch's solutions."""
    task, ck, data = _port_data("multi_nu_geo_600x600")
    X, cfg = data.X_test[:100], data.config
    got, _ = sample_solutions(task, ck["params"], ck["sched"], X, cfg, 0.0, 64, seed=1,
                              sampler="ddim", n_steps=5, backend="plain")
    noise = _port_noise(100, 64, 1, 5, seed=1)
    ref = _jax_draws("multi_nu_geo", "ddpm_multi_geo", cfg, X, noise, 0.0, "ddim", 5)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())

    dec, traces = sample_solutions(task, ck["params"], ck["sched"], X, cfg, 0.0, 64, seed=1,
                                   record_trace=True, backend="plain")
    plain, _ = sample_solutions(task, ck["params"], ck["sched"], X, cfg, 0.0, 64, seed=1,
                                backend="plain")
    np.testing.assert_array_equal(dec, plain)
    assert [t.ys.shape for t in traces] == [(20, 64, 5), (20, 36, 5)]
    Xu = torch.tensor(task.unnormalize_x(X[64:], cfg), dtype=torch.float32)
    last = task.decode_with_x(torch.from_numpy(traces[1].ys[-1]), Xu, cfg).numpy()
    np.testing.assert_array_equal(last, dec[64:])
    assert sample_solutions(task, ck["params"], ck["sched"], X, cfg, 0.0, 64, record_trace=True,
                            sampler="ddim", n_steps=5, backend="plain")[1] == [None, None]


@pytest.mark.parametrize("name", ["multi_co", "multi_nu_geo_480x360"])
def test_objective_metrics_match_jax(name):
    """The same predictions through both packages' metric blocks: NumPy
    float32 sums of per-row objectives that agree to float32 rounding."""
    task, _, data = _port_data(name)
    jt = JAX_TASKS[chip_smoke.EVAL_SPECS[name]["task"]]
    rng = np.random.default_rng(5)
    Y = task.unnormalize_y(data.Y_test, data.config)
    Y = np.abs(Y * rng.uniform(0.8, 1.2, Y.shape)).astype(np.float32)
    got = objective_metrics(task, data, Y, device="cpu")
    ref = jax_objective_metrics(jt, data, Y)
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    ratio = "less_ratio" if task.higher_is_better else "exceeded_ratio"
    assert ratio in got


def test_sample_best_of_n_beats_its_first_candidate():
    """One batch (150 rows): candidate 0 is ``sample_solutions``' draw of
    the same seed, so every row of best-of-4 is at least as good; against
    the JAX package's best-of-4 with its own noise, by the mean rate."""
    task, ck, data = _port_data("multi_nu_geo_200x200")
    X, cfg = data.X_test, data.config
    best = sample_best_of_n(task, ck["params"], ck["sched"], X, cfg, n=4, omega=0.0, seed=2,
                            backend="plain")
    one, _ = sample_solutions(task, ck["params"], ck["sched"], X, cfg, 0.0, seed=2,
                              backend="plain")
    Xu = torch.tensor(task.unnormalize_x(X, cfg), dtype=torch.float32)

    def rate(Y):
        return task.objective(torch.from_numpy(np.asarray(Y, np.float32)), Xu, cfg).numpy()

    assert (rate(best) >= rate(one)).all() and rate(best).sum() > rate(one).sum()
    mix = sample_best_of_n(task, ck["params"], ck["sched"], X, cfg, omega=[0.0, 0.5], seed=2,
                           backend="plain")
    assert mix.shape == best.shape
    np.testing.assert_array_equal(mix, sample_best_of_n(task, ck["params"], ck["sched"], X, cfg,
                                                        omega=[0.0, 0.5], seed=2,
                                                        backend="plain"))
    jck = jax_load_checkpoint(str(CKPTS / "ddpm_multi_geo"))
    jbest = jax_sample_best_of_n(JAX_TASKS["multi_nu_geo"], jck["params"], jck["sched"], X, cfg,
                                 n=4, omega=0.0, seed=2)
    mean, tol = chip_smoke.EVAL_JAX["multi_nu_geo_200x200_best_of_4"]["avg_diff"]
    assert abs(rate(best).mean() - rate(jbest).mean()) <= 2 * tol


def test_evaluate_refines_and_reports_every_metric():
    task, ck, data = _port_data("multi_nu_geo_600x600")
    kw = dict(omega=0.0, seed=4, backend="plain")
    base = evaluate(task, ck["params"], ck["sched"], data, **kw)
    refined = evaluate(task, ck["params"], ck["sched"], data, refine_iters=20, **kw)
    assert set(base) == {"less_ratio", "avg_diff", "n_samples"} and base["n_samples"] == 150
    assert refined["less_ratio"] >= base["less_ratio"]
    co_task, co_ck, co_data = _port_data("multi_co")
    with pytest.raises(ValueError, match="no feasibility projection"):
        evaluate(co_task, co_ck["params"], co_ck["sched"], co_data, refine_iters=1,
                 backend="plain")


@functools.lru_cache(maxsize=None)
def _jax_eval_program(name):
    """The JAX package's data (its own loader), config and one compiled
    program per spec: ``run(cond, cond_unnorm, key)`` is the body of its
    ``sample_solutions`` (or ``sample_best_of_n``) for one batch, compiled
    once so that many seeds cost no recompile. ``jax_eval_draws`` feeds it
    the keys those functions derive from a seed."""
    spec = eval_spec(name)
    jck = jax_load_checkpoint(str(CKPTS / spec["ckpt"]))
    jt = JAX_TASKS[spec["task"]]
    data = jt.load(str(ensure_datasets([spec["csv"]])[spec["csv"]]), **spec.get("load_kw", {}))
    jax_merge_multi_config(data.config, jck["metadata"], spec["task"].split("_", 1)[1])
    cfg, omega, n = data.config, spec["omega"], spec.get("best_of", 1)
    model = jt.build_model(cfg)
    draw = jax_make_draw(lambda p, y, t, c, m: model.apply({"params": p}, y, t, c, m),
                         jck["params"], jck["sched"], jt.data_dim(cfg), "ddpm", None,
                         cfg.get("parameterization", "eps"), skip_uncond=omega == 0.0)

    @jax.jit
    def run(cond, cond_unnorm, key):
        if n == 1:
            return jt.decode_with_x(draw(cond, jnp.float32(omega), key)[0], cond_unnorm, cfg)

        def one(k, w):
            dec = jt.decode_with_x(draw(cond, w, k)[0], cond_unnorm, cfg)
            return dec, jt.objective(dec, cond_unnorm, cfg)

        decs, scores = jax.vmap(one)(jax.random.split(key, n), jnp.full((n,), omega))
        return jax_select_best(decs, scores, jt.higher_is_better)

    return jt, jck, data, run


def jax_eval_draws(name, seeds, rows=None):
    """The JAX package's solutions on EVAL_SPECS[name] for each seed (the
    first ``rows`` test rows where given): batches of 512, each with the
    next key of ``jax.random.split(PRNGKey(seed))``, as its eval loop."""
    jt, _, data, run = _jax_eval_program(name)
    X = data.X_test[:rows]
    Xu = jt.unnormalize_x(X, data.config)
    out = []
    for seed in seeds:
        key, parts = jax.random.PRNGKey(seed), []
        for i in range(0, X.shape[0], 512):
            key, k = jax.random.split(key)
            parts.append(np.asarray(run(jnp.asarray(X[i:i + 512], jnp.float32),
                                        jnp.asarray(Xu[i:i + 512], jnp.float32), k)))
        out.append(np.concatenate(parts))
    return out


def jax_eval_rows(name, seeds):
    """Per metric of ``evaluate``, each row's contribution for each seed, a
    (seeds, rows) array: the rows of a seed sum to its metric."""
    jt, _, data, _ = _jax_eval_program(name)
    cfg = data.config
    Xu = jnp.asarray(jt.unnormalize_x(data.X_test, cfg), jnp.float32)
    Y_true = jt.unnormalize_y(data.Y_test, cfg)
    true = np.asarray(jt.objective(jnp.asarray(Y_true, jnp.float32), Xu, cfg))
    n = len(true)
    rows = {}
    for Y in jax_eval_draws(name, seeds):
        pred = np.asarray(jt.objective(jnp.asarray(Y, jnp.float32), Xu, cfg))
        r = {("less_ratio" if jt.higher_is_better else "exceeded_ratio"): pred / true.sum(),
             "avg_diff": (pred - true) / n}
        if jt.extra_metrics is not None:
            r["decision_accuracy"] = (jax_decision_class(Y) == jax_decision_class(Y_true)) / n
            r["terrible_count"] = ((pred / true > 1.2) & (pred > 10.0)).astype(np.float64)
        for k, v in r.items():
            rows.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in rows.items()}


def jax_eval_constants(name):
    """EVAL_JAX[name]'s numbers: per metric the mean over the spec's JAX
    seeds 0..K-1 and 4 standard errors of one draw's deviation from that
    mean, sqrt(1 + 1/K) times the square root of the rows' summed
    seed-to-seed variances (at least 1e-6 of the mean; one row for a
    count)."""
    K = eval_spec(name)["seeds"]
    out = {}
    for k, r in jax_eval_rows(name, range(K)).items():
        mean = float(r.sum(axis=1).mean())
        spread = 4 * np.sqrt(1 + 1 / K) * np.sqrt(r.var(axis=0, ddof=1).sum())
        out[k] = (mean, float(max(spread, 1.0 if k == "terrible_count" else 1e-6 * abs(mean))))
    return out


@pytest.mark.parametrize("name,rows", [("multi_co", 1100), ("multi_nu_geo_200x200", None),
                                       ("multi_nu_geo_200x200_best_of_4", None)])
def test_jax_eval_program_is_the_jax_eval_loop(name, rows):
    """The compiled program behind the constants draws what the JAX
    package's own loop draws, bit for bit (three batches on CO)."""
    jt, jck, data, _ = _jax_eval_program(name)
    spec = chip_smoke.EVAL_SPECS[name]
    X = data.X_test[:rows]
    if spec.get("best_of", 1) > 1:
        ref = jax_sample_best_of_n(jt, jck["params"], jck["sched"], X, data.config,
                                   n=spec["best_of"], omega=spec["omega"], seed=3)
    else:
        ref, _ = jax_sample_solutions(jt, jck["params"], jck["sched"], X, data.config,
                                      spec["omega"], 512, 3)
    np.testing.assert_array_equal(jax_eval_draws(name, [3], rows)[0], ref)


@pytest.mark.parametrize("name", list(chip_smoke.EVAL_SPECS))
def test_evaluate_vs_jax_constants(name):
    """EVAL_JAX[name] is ``jax_eval_constants(name)``; the port's evaluate
    on the CPU, with its own noise, lands within its tolerance."""
    want = chip_smoke.EVAL_JAX[name]
    got_jax = jax_eval_constants(name)
    assert set(want) == set(got_jax)
    for k, (mean, tol) in want.items():
        assert mean == pytest.approx(got_jax[k][0], rel=1e-6, abs=1e-12), k
        assert tol == pytest.approx(got_jax[k][1], rel=1e-3), k
    task, ck, data = _port_data(name)
    spec = chip_smoke.EVAL_SPECS[name]
    got = evaluate(task, ck["params"], ck["sched"], data, omega=spec["omega"], seed=0,
                   best_of=spec.get("best_of", 1), backend="plain")
    assert got["n_samples"] == data.X_test.shape[0]
    for k, (mean, tol) in want.items():
        assert abs(got[k] - mean) <= tol, (k, got[k], mean, tol)

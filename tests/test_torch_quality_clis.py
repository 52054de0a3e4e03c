"""The port's quality CLIs (``diffsg_tpu_torch/tools/headline.py``,
``eval_nu_geo.py`` and ``co_guided.py``) against the JAX package's
``tools/`` CLIs.

* The call plan: each CLI's ``main`` runs with ``evaluate``,
  ``load_checkpoint``, the task loaders and ``ensure_datasets`` replaced by
  recorders (``monkeypatch``; neither CLI is edited), for every ``--tasks``
  group, all of them and ``--fast``. The plans (row, task, checkpoint, CSV,
  load and evaluate keywords, the merged config, the rows after ``--limit``)
  are equal, but for the rows that read the reference repository's
  datasets: with those absent the port skips them, on stderr, without
  loading their checkpoints; with them present (a directory of empty files
  here) the plans are equal row for row.
* One real row through both CLIs on a cut split (``--fast --tasks co
  --limit 128``), held by the mean: the difference of the two packages'
  draws within 4 standard errors of a difference of two JAX draws.
* ``co_guided``: the guided draw elementwise against the JAX sampler on the
  same injected noise at omega 0; the CLI's lines' keys equal the JAX
  CLI's.
* The constants ``chip_smoke.py``'s ``headline`` phase holds the card to
  (``HEADLINE_JAX``, ``CO_GUIDED_JAX``), computed from the JAX package and
  held against the port on the CPU (marked slow).
"""

import dataclasses
import functools
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diffsg_tpu.tasks as jax_tasks_pkg
import diffsg_tpu.utils as jax_utils_pkg
from diffsg_tpu.baselines import co_analytic_decode as jax_co_analytic_decode
from diffsg_tpu.baselines import co_soft_cost as jax_co_soft_cost
from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks.base import _make_draw as jax_make_draw
from diffsg_tpu.tasks.base import merge_ckpt_config as jax_merge_ckpt_config
from diffsg_tpu.tasks.base import refine_solutions as jax_refine_solutions
from diffsg_tpu.tasks.base import sample_best_of_n as jax_sample_best_of_n
from diffsg_tpu.tasks.base import sample_solutions as jax_sample_solutions
from diffsg_tpu.tasks.base import select_best as jax_select_best
from diffsg_tpu.tasks.co import decision_class as jax_decision_class
from diffsg_tpu.tasks.multi import merge_multi_config as jax_merge_multi_config
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
import diffsg_tpu_torch.tools._cli as port_cli
from diffsg_tpu_torch.models import unet_apply_fn
from diffsg_tpu_torch.tasks import TASKS, loaded_model
from diffsg_tpu_torch.tools import co_guided, eval_nu_geo, headline
from diffsg_tpu_torch.utils import load_checkpoint

import tools.co_guided as jax_co_guided
import tools.eval_nu_geo as jax_eval_nu_geo
import tools.headline as jax_headline
import tools.make_datasets as jax_make_datasets

from test_torch_report_clis import _json_lines, _run_jax_cli
from test_torch_tasks import chip_smoke

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = REPO / "ckpts"
JAX_REF = jax_headline.REF


# -- the call plan --------------------------------------------------------------------------


class Recorder:
    """Stand-ins for a package's ``load_checkpoint``, task loaders,
    ``evaluate`` and ``ensure_datasets``: each call is recorded, the
    loaders hand out 2,000 placeholder test rows and a config naming the
    file, the checkpoints their real metadata."""

    def __init__(self, ref_prefix):
        self.ref_prefix = ref_prefix
        self.calls, self.loaded, self.ensured = [], [], []

    def load_checkpoint(self, path, **kw):
        path = pathlib.Path(path)
        self.loaded.append(path.name)
        meta = json.loads((CKPTS / path.name / "metadata.json").read_text())
        return {"params": path.name, "sched": "sched", "metadata": meta,
                "ema": types.SimpleNamespace(params={})}

    def loader(self, task_name):
        def load(path, **kw):
            path = str(path)
            X = np.zeros((2000, 1), np.float32)
            return types.SimpleNamespace(
                X_test=X, Y_test=X, R_test=X,
                config={"csv": pathlib.Path(path).name, "ref": path.startswith(self.ref_prefix),
                        "loader": task_name, **kw})
        return load

    def evaluate(self, task, params, sched, data, **kw):
        kw = {k: (list(map(float, v)) if isinstance(v, (list, tuple)) else v)
              for k, v in kw.items()}
        self.calls.append({"task": task.name, "ckpt": params, "config": dict(data.config),
                           "rows": int(data.X_test.shape[0]), "eval": kw})
        return {"less_ratio": 1.0}

    def ensure_datasets(self, names=None, **kw):
        self.ensured.append(names)


def _jax_plan(module, argv, monkeypatch, tmp_path, capsys):
    rec = Recorder(JAX_REF)
    with monkeypatch.context() as m:
        m.setattr(jax_tasks_pkg, "evaluate", rec.evaluate)
        m.setattr(jax_utils_pkg, "load_checkpoint", rec.load_checkpoint)
        m.setattr(jax_make_datasets, "ensure_datasets", rec.ensure_datasets)
        for name, t in JAX_TASKS.items():
            m.setitem(JAX_TASKS, name, dataclasses.replace(t, load=rec.loader(name)))
        capsys.readouterr()
        _run_jax_cli(module, argv, m, tmp_path)
    return rec, _json_lines(capsys.readouterr().out)


def _port_plan(module, argv, monkeypatch, capsys, ref_dir=None):
    ref_prefix = str(ref_dir) if ref_dir else port_cli.REFERENCE_DATASETS
    rec = Recorder(ref_prefix)
    with monkeypatch.context() as m:
        if ref_dir is not None:
            m.setattr(port_cli, "REFERENCE_DATASETS", str(ref_dir))
        m.setattr(module, "evaluate", rec.evaluate)
        m.setattr(module, "load_checkpoint", rec.load_checkpoint)
        m.setattr(module, "ensure_datasets", rec.ensure_datasets)
        for name, t in TASKS.items():
            m.setitem(TASKS, name, dataclasses.replace(t, load=rec.loader(name)))
        capsys.readouterr()
        module.main(argv + ["--cpu"])
    cap = capsys.readouterr()
    return rec, _json_lines(cap.out), cap.err


HEADLINE_ARGVS = [["--tasks", g] for g in headline.TASK_GROUPS] + [
    [], ["--fast"], ["--tasks", "msr", "co", "nu", "hybrid", "--limit", "1024"],
    ["--tasks", "co", "multi", "--fast", "--limit", "64"]]


@pytest.fixture(scope="module")
def reference_dir(tmp_path_factory):
    """Empty stand-ins for every reference dataset the two CLIs name."""
    root = tmp_path_factory.mktemp("reference")
    for r in headline.plan(headline.TASK_GROUPS):
        if r.ref:
            (root / r.csv).touch()
    return root


@pytest.mark.parametrize("argv", HEADLINE_ARGVS, ids=lambda a: " ".join(a) or "default")
def test_headline_call_plan_matches_jax(argv, reference_dir, monkeypatch, tmp_path, capsys):
    jrec, jlines = _jax_plan(jax_headline, argv, monkeypatch, tmp_path, capsys)
    assert jrec.ensured == [None]          # the JAX CLI makes every known dataset
    jplan = [(l["row"], c) for l, c in zip(jlines, jrec.calls, strict=True)]

    # The reference absent: its rows skipped, on stderr, their checkpoints unread.
    prec, plines, err = _port_plan(headline, argv, monkeypatch, capsys,
                                   ref_dir=tmp_path / "no_reference")
    pplan = [(l["row"], c) for l, c in zip(plines, prec.calls, strict=True)]
    local = [(n, c) for n, c in jplan if not c["config"]["ref"]]
    assert pplan == local
    skipped = [n for n, c in jplan if c["config"]["ref"]]
    assert [l for l in err.splitlines() if l.startswith("headline: skipped")] == [
        f"headline: skipped {n!r}: the reference dataset "
        f"{tmp_path / 'no_reference' / c['config']['csv']} is absent"
        for n, c in jplan if c["config"]["ref"]]
    assert prec.loaded == [c["ckpt"] for _, c in local]
    assert prec.ensured == [sorted({c["config"]["csv"] for _, c in local})]
    assert len(jplan) == len(local) + len(skipped)

    # The reference present: the same plan, row for row.
    prec, plines, err = _port_plan(headline, argv, monkeypatch, capsys, ref_dir=reference_dir)
    assert [(l["row"], c) for l, c in zip(plines, prec.calls, strict=True)] == jplan
    assert err == ""


@pytest.mark.parametrize("argv", [[], ["--omegas", "0.06", "0.25", "--limit", "100"],
                                  ["--ckpt", "ckpts/ddpm_nu_geo_x0f", "--omegas", "0.0",
                                   "--ema"]])
def test_eval_nu_geo_call_plan_matches_jax(argv, reference_dir, monkeypatch, tmp_path, capsys):
    jrec, jlines = _jax_plan(jax_eval_nu_geo, argv, monkeypatch, tmp_path, capsys)
    made = [c for _, c, ref, _ in eval_nu_geo.CONFIGS if not ref]
    assert jrec.ensured == [made]
    prec, plines, err = _port_plan(eval_nu_geo, argv, monkeypatch, capsys,
                                   ref_dir=tmp_path / "no_reference")
    local = [c for c in jrec.calls if not c["config"]["ref"]]
    assert prec.calls == local and prec.ensured == [made]
    assert plines == [l for l in jlines if not l["config"].startswith(("18mW", "30mW"))]
    assert err.count("eval_nu_geo: skipped") == 2
    prec, plines, _ = _port_plan(eval_nu_geo, argv, monkeypatch, capsys, ref_dir=reference_dir)
    assert prec.calls == jrec.calls and plines == jlines


def test_eval_nu_geo_ema_evaluates_the_ema_weights(monkeypatch, capsys):
    """``--ema`` hands evaluate the checkpoint's EMA tree (the flax
    layout), not its raw params."""
    seen = []
    monkeypatch.setattr(eval_nu_geo, "evaluate",
                        lambda task, params, sched, data, **kw: seen.append(params) or
                        {"less_ratio": 1.0})
    eval_nu_geo.main(["--ckpt", str(CKPTS / "ddpm_nu_geo_x0f"), "--omegas", "0.0", "--limit",
                      "4", "--ema", "--cpu"])
    jck = jax_load_checkpoint(str(CKPTS / "ddpm_nu_geo_x0f"))
    want = jax.tree_util.tree_leaves(jck["ema"].params)
    raw = jax.tree_util.tree_leaves(jck["params"])
    got = jax.tree_util.tree_leaves(seen[0])
    assert len(seen) == 3 and len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert any(not np.array_equal(g, np.asarray(r)) for g, r in zip(got, raw))


def test_headline_real_row_matches_jax_by_the_mean(monkeypatch, tmp_path, capsys):
    """``--fast --tasks co --limit 128`` (one row: CO x0 ranked, omega 1)
    through both CLIs end to end, each with its own noise: equal keys and
    row count, and each metric's difference within 4 standard errors of a
    difference of two JAX draws (the rows' seed-to-seed variances from a
    second JAX draw, seed 1)."""
    argv = ["--fast", "--tasks", "co", "--limit", "128"]
    monkeypatch.setattr(jax_make_datasets, "ensure_datasets", lambda *a, **k: None)
    capsys.readouterr()
    _run_jax_cli(jax_headline, argv, monkeypatch, tmp_path)
    (jrow,) = _json_lines(capsys.readouterr().out)
    (prow,) = headline.main(argv + ["--cpu"])
    assert prow.keys() == jrow.keys() and prow["row"] == jrow["row"] == "co x0 ranked single-draw"
    assert prow["n_samples"] == jrow["n_samples"] == 128.0
    row = {r.name: r for r in headline.plan(["co"])}[prow["row"]]
    spread, _ = jax_headline_rows(row, 128, [0, 1])
    for k, r in spread.items():
        tol = 4 * np.sqrt(2 * r.var(axis=0, ddof=1).sum())
        tol = max(tol, 1.0 if k == "terrible_count" else 1e-6 * abs(jrow[k]))
        assert abs(prow[k] - jrow[k]) <= tol, (k, prow[k], jrow[k], tol)


# -- co_guided --------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _co_aux():
    task = TASKS["co_analytic"]
    data = task.load(str(REPO / "datasets" / "3nodes_50000samples_new.csv"))
    ck = load_checkpoint(str(CKPTS / "ddpm_co_aux"), device="cpu")
    jck = jax_load_checkpoint(str(CKPTS / "ddpm_co_aux"))
    return task, data, ck, jck


@pytest.mark.parametrize("gscale,relative", [(3.0, False), (0.3, True)])
def test_co_guided_draw_matches_jax_with_the_same_noise(gscale, relative):
    """At omega 0 the guided draw (plain forward, the soft-cost gradient at
    each x0 estimate, the analytic decode) equals the JAX sampler's on the
    same noise to float32 rounding."""
    task, data, ck, jck = _co_aux()
    X = data.X_test[:96].astype(np.float32)
    Xu = np.asarray(task.unnormalize_x(X, data.config), np.float32)
    D, T = task.data_dim(data.config), ck["sched"].T
    noise = np.random.default_rng(4).standard_normal((96, T + 1, D)).astype(np.float32)
    apply_fn = unet_apply_fn(loaded_model(task, ck["params"], data.config, "cpu"), "plain")
    with torch.no_grad():
        got = co_guided.guided_draw(apply_fn, ck["sched"], torch.from_numpy(X),
                                    torch.from_numpy(Xu), 0.0, gscale, 0.05, relative,
                                    torch.from_numpy(noise)).numpy()
    model = JAX_TASKS["co_analytic"].build_model(data.config)

    @jax.jit
    def run(c, cu, init, steps):
        y0, _ = jax_cfg_sample(lambda p, y, t, c_, m: model.apply({"params": p}, y, t, c_, m),
                               jck["params"], jck["sched"], c, 0.0, D, init_noise=init,
                               step_noise=steps,
                               guidance_fn=lambda x0: jax_co_soft_cost(x0, cu, tau=0.05),
                               guidance_scale=gscale, guidance_relative=relative)
        return jax_co_analytic_decode(y0, cu)

    ref = np.asarray(run(jnp.asarray(X), jnp.asarray(Xu), jnp.asarray(noise[:, 0]),
                         jnp.asarray(noise[:, 1:].transpose(1, 0, 2))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_co_guided_lines_match_jax_keys(monkeypatch, tmp_path, capsys):
    argv = ["--limit", "64", "--scales", "0", "0.3", "--omegas", "5000", "500"]
    capsys.readouterr()
    _run_jax_cli(jax_co_guided, argv, monkeypatch, tmp_path)
    jlines = _json_lines(capsys.readouterr().out)
    rows = co_guided.main(argv + ["--cpu"])
    plines = _json_lines(capsys.readouterr().out)
    assert [l.keys() for l in plines] == [l.keys() for l in jlines] and len(plines) == 4
    for p, j, r in zip(plines, jlines, rows):
        assert (p["tau"], p["omega"], p["gscale"]) == (j["tau"], j["omega"], j["gscale"])
        assert p["acc"] == round(r["acc"], 4) and r.keys() == {"tau", "omega", "gscale",
                                                                 *p.keys()}


# -- the JAX constants behind chip_smoke's headline phase ----------------------------------


def headline_row(name):
    """The port's plan row ``name`` and its ``--limit`` in chip_smoke's
    headline runs (None for the multi-task run, on whole splits)."""
    multi = {r.name: r for r in headline.plan(["multi"])}
    if name in multi:
        return multi[name], None
    rows = {r.name: r for r in headline.plan(["msr", "co", "nu", "hybrid"])}
    return rows[name], chip_smoke.HEADLINE_LIMIT


ALL_ROWS = {r.name: r for r in headline.plan(headline.TASK_GROUPS)}


def _jax_headline_program(row, limit):
    return _jax_headline_program_of(row.name, limit)


@functools.lru_cache(maxsize=None)
def _jax_headline_program_of(name, limit):
    """The JAX package's data (its loader, its config merge) and one
    compiled program for the row: ``run(cond, cond_unnorm, key)`` is the
    body of its ``sample_solutions`` (or ``sample_best_of_n``) for one
    batch; ``refine`` its ``evaluate``'s refinement, or None."""
    row = ALL_ROWS[name]
    jt = JAX_TASKS[row.task]
    jck = jax_load_checkpoint(str(CKPTS / row.ckpt))
    path = str(REPO / "datasets" / row.csv)
    data = jt.load(path, **row.load_kw)
    if limit:
        data.X_test, data.Y_test = data.X_test[:limit], data.Y_test[:limit]
        if data.R_test is not None:
            data.R_test = data.R_test[:limit]
    if row.slot is None:
        jax_merge_ckpt_config(data.config, jck.get("metadata"))
    else:
        jax_merge_multi_config(data.config, jck["metadata"], row.slot)
    cfg = data.config
    omega, n = row.eval_kw["omega"], row.eval_kw.get("best_of", 1)
    omegas = (np.full(n, omega, np.float32) if np.isscalar(omega)
              else np.asarray(omega, np.float32))
    model = jt.build_model(cfg)
    draw = jax_make_draw(lambda p, y, t, c, m: model.apply({"params": p}, y, t, c, m),
                         jck["params"], jck["sched"], jt.data_dim(cfg), "ddpm", None,
                         cfg.get("parameterization", "eps"),
                         skip_uncond=bool(np.all(omegas == 0.0)))

    def decode(y0, cu):
        if jt.decode_with_x is not None:
            return jt.decode_with_x(y0, cu, cfg)
        return jt.decode(y0, cfg)

    @jax.jit
    def run(cond, cond_unnorm, key):
        if n == 1:
            return decode(draw(cond, jnp.float32(omega), key)[0], cond_unnorm)

        def one(k, w):
            dec = decode(draw(cond, w, k)[0], cond_unnorm)
            return dec, jt.objective(dec, cond_unnorm, cfg)

        decs, scores = jax.vmap(one)(jax.random.split(key, n), jnp.asarray(omegas))
        return jax_select_best(decs, scores, jt.higher_is_better)

    iters = row.eval_kw.get("refine_iters", 0)
    refine = None if not iters else jax.jit(
        lambda Y, X: jax_refine_solutions(jt, Y, X, cfg, iters, None))
    return jt, jck, data, run, refine


def jax_headline_draws(row, limit, seeds):
    """The JAX package's evaluated solutions for each seed: batches of 512,
    each with the next key of ``jax.random.split(PRNGKey(seed))``, then the
    row's refinement, as its ``evaluate``."""
    jt, _, data, run, refine = _jax_headline_program(row, limit)
    Xu = np.asarray(jt.unnormalize_x(data.X_test, data.config), np.float32)
    out = []
    for seed in seeds:
        key, parts = jax.random.PRNGKey(seed), []
        for i in range(0, data.X_test.shape[0], 512):
            key, k = jax.random.split(key)
            parts.append(np.asarray(run(jnp.asarray(data.X_test[i:i + 512], jnp.float32),
                                        jnp.asarray(Xu[i:i + 512]), k)))
        Y = np.concatenate(parts)
        if refine is not None:
            Y = np.asarray(refine(jnp.asarray(Y, jnp.float32), jnp.asarray(Xu)))
        out.append(Y)
    return out


def _row_contributions(jt, Y, Y_true, pred, true):
    """Per metric of ``evaluate``, each row's contribution: the rows sum to
    the metric."""
    n = len(true)
    r = {("less_ratio" if jt.higher_is_better else "exceeded_ratio"): pred / true.sum(),
         "avg_diff": (pred - true) / n}
    if jt.extra_metrics is not None:
        r["decision_accuracy"] = (jax_decision_class(Y) == jax_decision_class(Y_true)) / n
        r["terrible_count"] = ((pred / true > 1.2) & (pred > 10.0)).astype(np.float64)
    return r


def jax_headline_rows(row, limit, seeds):
    """Per metric, (seeds, rows) contributions of the JAX package's draws,
    and the labels' mean objective."""
    jt, _, data, _, _ = _jax_headline_program(row, limit)
    cfg = data.config
    Xu = jnp.asarray(jt.unnormalize_x(data.X_test, cfg), jnp.float32)
    Y_true = jt.unnormalize_y(data.Y_test, cfg)
    true = np.asarray(jt.objective(jnp.asarray(Y_true, jnp.float32), Xu, cfg))
    rows = {}
    for Y in jax_headline_draws(row, limit, seeds):
        pred = np.asarray(jt.objective(jnp.asarray(Y, jnp.float32), Xu, cfg))
        for k, v in _row_contributions(jt, Y, Y_true, pred, true).items():
            rows.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in rows.items()}, float(true.mean())


def constants_from_rows(rows, objective_mean):
    """Per metric: the mean over the K draws and 4 standard errors of one
    draw's deviation from it, sqrt(1 + 1/K) times the square root of the
    rows' summed seed-to-seed variances, as ``EVAL_JAX``; at least 1e-6 of
    the mean (one row for a count), and for ``avg_diff`` at least 1e-6 of
    the labels' mean objective: the ratio's floor in its units, where
    float32 rounding of the objectives dominates (refined MSR rows)."""
    out = {}
    for k, r in rows.items():
        K = r.shape[0]
        mean = float(r.sum(axis=1).mean())
        spread = 4 * np.sqrt(1 + 1 / K) * np.sqrt(r.var(axis=0, ddof=1).sum())
        floor = {"terrible_count": 1.0, "avg_diff": 1e-6 * abs(objective_mean)}.get(
            k, 1e-6 * abs(mean))
        out[k] = (mean, float(max(spread, floor)))
    return out


def jax_headline_constants(name):
    row, limit = headline_row(name)
    return constants_from_rows(*jax_headline_rows(row, limit,
                                                  range(chip_smoke.HEADLINE_SEEDS[name])))


@pytest.mark.slow
@pytest.mark.parametrize("name", ["co x0 ranked bo8 mix", "hybrid msr_80c OOD 40w +refine50",
                                  "nu geo universal x0f (200x200 12mW)"])
def test_jax_headline_program_is_the_jax_eval_loop(name):
    """The compiled program behind the constants draws what the JAX
    package's own loop (and refinement) draws, bit for bit."""
    row, limit = headline_row(name)
    jt, jck, data, _, _ = _jax_headline_program(row, limit)
    kw = row.eval_kw
    if kw.get("best_of", 1) > 1:
        ref = jax_sample_best_of_n(jt, jck["params"], jck["sched"], data.X_test, data.config,
                                   n=kw["best_of"], omega=kw["omega"], seed=3)
    else:
        ref, _ = jax_sample_solutions(jt, jck["params"], jck["sched"], data.X_test,
                                      data.config, kw["omega"], 512, 3)
    if kw.get("refine_iters"):
        Xu = jnp.asarray(jt.unnormalize_x(data.X_test, data.config), jnp.float32)
        ref = np.asarray(jax.jit(lambda Y, X: jax_refine_solutions(
            jt, Y, X, data.config, kw["refine_iters"], None))(jnp.asarray(ref), Xu))
    np.testing.assert_array_equal(jax_headline_draws(row, limit, [3])[0], ref)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(chip_smoke.HEADLINE_SEEDS))
def test_headline_vs_jax_constants(name):
    """HEADLINE_JAX[name] is ``jax_headline_constants(name)``; the port's
    row (``headline.run_row`` on the CPU, its own noise) lands within its
    tolerance."""
    want = chip_smoke.HEADLINE_JAX[name]
    got_jax = jax_headline_constants(name)
    assert set(want) == set(got_jax)
    for k, (mean, tol) in want.items():
        assert mean == pytest.approx(got_jax[k][0], rel=1e-6, abs=1e-12), k
        assert tol == pytest.approx(got_jax[k][1], rel=1e-3), k
    row, limit = headline_row(name)
    got = headline.run_row(row, limit, torch.device("cpu"))
    for k, (mean, tol) in want.items():
        assert abs(got[k] - mean) <= tol, (k, got[k], mean, tol)


def jax_co_guided_rows(gscale, seeds, limit=1024, omega=5000.0, tau=0.05):
    """Per metric, (seeds, rows) contributions of the JAX CLI's guided
    program (its ``run``: the guided sampler and the analytic decode, 512
    rows a chunk, a key split per chunk) on the first ``limit`` CO rows
    (None: the whole test split)."""
    jt = JAX_TASKS["co_analytic"]
    data = jt.load(str(REPO / "datasets" / "3nodes_50000samples_new.csv"))
    jck = jax_load_checkpoint(str(CKPTS / "ddpm_co_aux"))
    jax_merge_ckpt_config(data.config, jck.get("metadata"))
    X, Yl = data.X_test[:limit], data.Y_test[:limit]
    cfg = data.config
    model = jt.build_model(cfg)
    D = jt.data_dim(cfg)
    Xu = np.asarray(jt.unnormalize_x(X, cfg), np.float32)

    @jax.jit
    def run(cond, cu, key, omega_, gscale_):
        y0, _ = jax_cfg_sample(lambda p, y, t, c, m: model.apply({"params": p}, y, t, c, m),
                               jck["params"], jck["sched"], cond, omega_, D, key=key,
                               guidance_fn=lambda x0: jax_co_soft_cost(x0, cu, tau=tau),
                               guidance_scale=gscale_, guidance_relative=False)
        return jax_co_analytic_decode(y0, cu)

    Y_true = jt.unnormalize_y(Yl, cfg)
    true = np.asarray(jt.objective(jnp.asarray(Y_true, jnp.float32), jnp.asarray(Xu), cfg))
    rows = {}
    for seed in seeds:
        key, parts = jax.random.PRNGKey(seed), []
        for i in range(0, X.shape[0], 512):
            key, k = jax.random.split(key)
            parts.append(np.asarray(run(jnp.asarray(X[i:i + 512], jnp.float32),
                                        jnp.asarray(Xu[i:i + 512]), k, jnp.float32(omega),
                                        jnp.float32(gscale))))
        Y = np.concatenate(parts)
        pred = np.asarray(jt.objective(jnp.asarray(Y), jnp.asarray(Xu), cfg))
        n = len(true)
        for k, v in {"acc": (jax_decision_class(Y) == jax_decision_class(Yl)) / n,
                     "exceeded_ratio": pred / true.sum(),
                     "avg_diff": (pred - true) / n}.items():
            rows.setdefault(k, []).append(v)
    return {k: np.stack(v) for k, v in rows.items()}, float(true.mean())


def _co_guided_argv(argv):
    """A CO_GUIDED_RUNS entry with its checkpoint and dataset under the
    repository."""
    return [str(REPO / a) if a.startswith(("ckpts/", "datasets/")) else a for a in argv]


def test_co_guided_constants_show_the_tilt():
    """At omega 0 the guided row's constants lie more than twice both
    tolerances apart from the unguided row's: a port whose guidance did
    nothing fails the guided row, and two rows that each land within their
    constant lie further apart than both tolerances, as chip_smoke's
    headline phase checks. At omega 5,000 the tilt moves nothing."""
    off, on = chip_smoke.CO_GUIDED_JAX[(0.0, 0.0)], chip_smoke.CO_GUIDED_JAX[(0.0, 3.0)]
    for k in ("exceeded_ratio", "avg_diff"):
        assert abs(on[k][0] - off[k][0]) > 2 * (on[k][1] + off[k][1]), k
    assert chip_smoke.CO_GUIDED_JAX[(5000.0, 0.0)] == chip_smoke.CO_GUIDED_JAX[(5000.0, 0.3)]
    runs = [co_guided.parse_args(argv) for argv in chip_smoke.CO_GUIDED_RUNS]
    assert sorted(chip_smoke.CO_GUIDED_JAX) == sorted(
        (w, g) for a in runs for w in a.omegas for g in a.scales)


@pytest.mark.slow
def test_co_guided_vs_jax_constants(monkeypatch, tmp_path, capsys):
    """CO_GUIDED_JAX is the JAX guided program's constants per (omega,
    scale) of each CO_GUIDED_RUNS run, and that program is the JAX CLI's
    (its seed-0 lines, rounded, are the program's seed-0 metrics); the
    port's CLI lands within them."""
    for argv in map(_co_guided_argv, chip_smoke.CO_GUIDED_RUNS):
        args = co_guided.parse_args(argv)
        rows = {}
        for omega in args.omegas:
            for gs in args.scales:
                r, objective_mean = jax_co_guided_rows(gs, range(chip_smoke.CO_GUIDED_SEEDS),
                                                       limit=args.limit or None, omega=omega)
                got_jax = constants_from_rows(r, objective_mean)
                want = chip_smoke.CO_GUIDED_JAX[(omega, gs)]
                assert set(want) == set(got_jax)
                for k, (mean, tol) in want.items():
                    assert mean == pytest.approx(got_jax[k][0], rel=1e-6, abs=1e-12), k
                    assert tol == pytest.approx(got_jax[k][1], rel=1e-3), k
                rows[(omega, gs)] = {k: float(v[0].sum()) for k, v in r.items()}
        capsys.readouterr()
        _run_jax_cli(jax_co_guided, argv, monkeypatch, tmp_path)
        for line in _json_lines(capsys.readouterr().out):
            for k, v in rows[(line["omega"], line["gscale"])].items():  # rounded to 4 or 5 digits
                assert abs(line[k] - v) <= (1e-4 if k == "acc" else 1e-5), (k, line[k], v)
        for line in co_guided.main(argv + ["--cpu"]):
            for k, (mean, tol) in chip_smoke.CO_GUIDED_JAX[(line["omega"],
                                                            line["gscale"])].items():
                assert abs(line[k] - mean) <= tol, (k, line[k], mean, tol)

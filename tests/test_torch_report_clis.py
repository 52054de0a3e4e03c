"""The port's comparison CLIs (``diffsg_tpu_torch/tools/train_baselines.py``,
``report.py`` and ``fewstep.py``) against the JAX package's ``tools/`` CLIs,
through ``main(argv)``, on 200-400-row CSVs that the port's ``make_rows``
writes here (the JAX package's bytes).

* ``train_baselines``: the port's CLI trains for two epochs on the CPU; the
  JAX CLI then runs on the same arguments with its ``train_mtfnn`` /
  ``train_ppo`` replaced by a recorder that returns the port's trained
  parameters. Held: the rows, labels and config each hands to training
  (the float64 rows within 1e-12: the JAX package parses CSVs with
  pandas), PPO's transforms (1e-6) and rewards (their reciprocals, the objective
  gap plus eps, within 1e-5) on the same actions, the
  printed metric rows (1e-5), the metadata, and the port's checkpoint in the
  JAX package's ``load_checkpoint`` (its forward within 1e-6).
* ``report``: the baseline rows (GD, MTFNN and PPO from the shipped
  ``ckpts/retrain_*``, a trained npz directory and a reference ``.pt``
  written here) equal the JAX CLI's within 1e-5. The JAX CLI's baseline
  rows are run op by op (``jax.disable_jit``), whose GD rounds as the port's
  does (see tests/test_torch_baselines.py). The DDPM rows are held by their
  keys and types only: ``evaluate`` is held in tests/test_torch_eval.py.
* ``fewstep``: its rows' keys and types equal the JAX CLI's; its DDIM-3 row
  on one batch equals ``report``'s DDIM-3 row (the same noise, drawn in
  the same layout).

Also the constants ``chip_smoke.py`` holds the card to in its
``baselines`` and ``report`` phases (``test_chip_smoke_baseline_constants``,
``test_chip_smoke_report_constants``; marked slow).
"""

import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diffsg_tpu.baselines as jb
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
import diffsg_tpu_torch.baselines as pb
from diffsg_tpu_torch.data.datasets import make_rows, write_csv as write_rows
from diffsg_tpu_torch.tools import fewstep, report, train_baselines
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax

import tools.fewstep as jax_fewstep
import tools.report as jax_report
import tools.train_baselines as jax_train_baselines

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = REPO / "ckpts"
INPUTS = {"3c_10w_400samples.csv": ("msr", dict(samples=400)),
          "3nodes_400samples.csv": ("co", dict(samples=400)),
          "3u_18mW_200samples.csv": ("nu", dict(samples=200, grid_step=8.0))}
FAMILY_CSV = {"msr": "3c_10w_400samples.csv", "co": "3nodes_400samples.csv",
              "nu": "3u_18mW_200samples.csv"}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    for name, (kind, kw) in INPUTS.items():
        write_rows(root / name, make_rows(kind, **kw))
    return lambda name: str(root / name)


def _json_lines(text):
    return [json.loads(l) for l in text.splitlines() if l.startswith("{")]


def _run_jax_cli(module, argv, monkeypatch, tmp_path):
    """A JAX CLI's ``main()`` on ``argv``, its compilation cache pointed
    into ``tmp_path`` and restored after."""
    real_update = jax.config.update

    def update(key, value):
        real_update(key, str(tmp_path / "jax_cache") if key == "jax_compilation_cache_dir"
                    else value)
    cache_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jax.config, "update", update)
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    try:
        module.main()
    finally:
        real_update("jax_compilation_cache_dir", cache_dir)


def _close(a, b, rel):
    """Two JSON rows with the same keys; floats within ``rel``."""
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    for k in a:
        if k == "elapsed_s":
            continue
        if isinstance(a[k], float) or isinstance(b[k], float):
            assert math.isclose(a[k], b[k], rel_tol=rel, abs_tol=1e-12), (k, a[k], b[k])
        else:
            assert a[k] == b[k], (k, a[k], b[k])


# -- train_baselines -----------------------------------------------------------------------


@pytest.mark.parametrize("algo,task", [("mtfnn", "co"), ("mtfnn", "msr"), ("mtfnn", "nu"),
                                       ("ppo", "co"), ("ppo", "msr"), ("ppo", "nu")])
def test_train_baselines_matches_jax_cli(algo, task, inputs, tmp_path, monkeypatch, capsys):
    csv = inputs(FAMILY_CSV[task])
    seen = {}
    train_name = f"train_{algo}"
    real_train = getattr(pb, train_name)

    def spy(*args, **kw):
        seen["port"] = args
        return real_train(*args, **kw)
    monkeypatch.setattr(pb, train_name, spy)
    port_out = str(tmp_path / "port")
    train_baselines.main([algo, "--task", task, "--dataset", csv, "--out", port_out,
                          "--epochs", "2", "--cpu"])
    port_row = [r for r in _json_lines(capsys.readouterr().out) if "algo" in r][-1]
    params = load_checkpoint(port_out, device="cpu")["params"]

    def recorder(*args, **kw):
        seen["jax"] = args
        return params if algo == "mtfnn" else (params, {})
    monkeypatch.setattr(jb, train_name, recorder)
    jax_out = str(tmp_path / "jax")
    _run_jax_cli(jax_train_baselines, [algo, "--task", task, "--dataset", csv, "--out", jax_out,
                                       "--epochs", "2", "--cpu"], monkeypatch, tmp_path)
    jax_row = _json_lines(capsys.readouterr().out)[-1]

    # What each CLI hands to training: rows, labels, config (and PPO's env).
    p, j = seen["port"], seen["jax"]
    for a, b in zip(p[1:3], j[1:3]):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=1e-12, atol=1e-15)
    p_cfg, j_cfg = (p[3], j[3]) if algo == "mtfnn" else (p[5], j[5])
    assert dataclasses.asdict(p_cfg) == {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
                                         for k, v in dataclasses.asdict(j_cfg).items()}
    if algo == "ppo":
        _, X, Y, env_fn, transform = p[:5]
        j_env, j_transform = j[3], j[4]
        rng = np.random.default_rng(0)
        act = rng.normal(size=(64, np.asarray(Y).shape[1])).astype(np.float32)
        x, y = (np.asarray(a[:64], np.float32) for a in (X, Y))
        dec = transform(torch.from_numpy(act))
        np.testing.assert_allclose(dec.numpy(), np.asarray(j_transform(jnp.asarray(act))),
                                   rtol=1e-6, atol=1e-6)
        # A reward is 1 / (|objective gap| + eps): held by its reciprocal,
        # since the gap cancels two objectives' rounding.
        np.testing.assert_allclose(
            1 / env_fn(torch.from_numpy(x), dec, torch.from_numpy(y)).numpy(),
            1 / np.asarray(j_env(jnp.asarray(x), jnp.asarray(dec.numpy()), jnp.asarray(y))),
            rtol=0, atol=1e-5)
    _close(jax_row, port_row, 1e-5)
    for d in (port_out, jax_out):
        assert (pathlib.Path(d) / "arrays.npz").exists()
    assert (json.loads((pathlib.Path(port_out) / "metadata.json").read_text())
            == json.loads((pathlib.Path(jax_out) / "metadata.json").read_text()))

    # The port's checkpoint in the JAX package's load_checkpoint.
    jparams = jax_load_checkpoint(port_out)["params"]
    if algo == "mtfnn":
        jm = {"co": jb.mtfnn_co_model, "msr": jb.mtfnn_msr_model, "nu": jb.mtfnn_nu_model}[task]()
        pm = {"co": pb.mtfnn_co_model, "msr": pb.mtfnn_msr_model, "nu": pb.mtfnn_nu_model}[task]()
    else:
        state = params_from_jax(params)
        s, a = state["actor.0.kernel"].shape[0], state["actor.6.kernel"].shape[1]
        jm, pm = jb.PPOAgent(s, a), pb.PPOAgent(s, a)
    pm.load_state_dict(params_from_jax(params), strict=True)
    X = np.asarray(seen["port"][1][:32], np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(X))
    want = jm.apply({"params": jparams}, jnp.asarray(X))
    for g, w in zip(got if algo == "ppo" else [got], want if algo == "ppo" else [want]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


# -- report ----------------------------------------------------------------------------------


def _reference_mtfnn_pt(path):
    """A reference-layout MTFNN-MSR ``.pt`` (nn.Linear lin1..lin4, 3-8-16-8-3)."""
    torch.manual_seed(3)
    m = torch.nn.Module()
    for i, (a, b) in enumerate(zip((3, 8, 16, 8), (8, 16, 8, 3))):
        m.add_module(f"lin{i + 1}", torch.nn.Linear(a, b))
    torch.save(m.state_dict(), path)
    return str(path)


@pytest.fixture(scope="module")
def ppo_msr_dir(inputs, tmp_path_factory):
    """An npz PPO-MSR checkpoint the port's CLI trained (one epoch)."""
    out = str(tmp_path_factory.mktemp("ppo_msr") / "ck")
    train_baselines.main(["ppo", "--task", "msr", "--dataset", inputs(FAMILY_CSV["msr"]),
                          "--out", out, "--epochs", "1", "--cpu"])
    return out


def _report_cases(d, tmp_path, ppo_msr_dir):
    """(port task, JAX task, ckpt, sampler arguments, baseline arguments)."""
    return {
        "co": ("co_ranked", "co", "ddpm_co_x0", ["--omegas", "1"],
               ["--baselines", "gd", "mtfnn", "ppo", "--mtfnn-ckpt",
                str(CKPTS / "retrain_mtfnn_co"), "--ppo-ckpt", str(CKPTS / "retrain_ppo_co")]),
        "msr": ("msr", "msr", "ddpm_msr_3c_T100", ["--omegas", "500"],
                ["--baselines", "gd", "mtfnn", "ppo",
                 "--mtfnn-ckpt", _reference_mtfnn_pt(tmp_path / "mtfnn_msr.pt"),
                 "--ppo-ckpt", ppo_msr_dir]),
        "nu": ("nu_direct", "nu_direct", "ddpm_nu_3u_aug32_s8c",
               ["--omegas", "0.125", "--sampler", "ddim", "--n-steps", "3"],
               ["--baselines", "gd", "mtfnn", "ppo", "--mtfnn-ckpt",
                str(CKPTS / "retrain_mtfnn_nu"), "--ppo-ckpt", str(CKPTS / "retrain_ppo_nu")]),
    }


DDPM_KEYS = {"solver", "task", "dataset", "omega", "n_steps", "refine", "best_of", "n_samples",
             "avg_diff", "elapsed_s"}


@pytest.mark.parametrize("fam", ["co", "msr", "nu"])
def test_report_baseline_rows_match_jax_cli(fam, inputs, tmp_path, monkeypatch, capsys,
                                            ppo_msr_dir):
    csv = inputs(FAMILY_CSV[fam])
    task, jax_task, ckpt, sampler, baselines = _report_cases(inputs, tmp_path,
                                                             ppo_msr_dir)[fam]
    out = tmp_path / "port.jsonl"
    report.main(["--task", task, "--datasets", csv, "--ckpt", str(CKPTS / ckpt), *sampler,
                 *baselines, "--out", str(out), "--cpu", "--backend", "plain"])
    printed = _json_lines(capsys.readouterr().out)
    rows = [json.loads(l) for l in out.read_text().splitlines()]
    first = "ddim" if "--sampler" in sampler else "ddpm"
    assert printed == rows and [r["solver"] for r in rows] == [first, "gd", "mtfnn", "ppo"]
    with jax.disable_jit():
        _run_jax_cli(jax_report, ["--task", jax_task, "--datasets", csv, *baselines, "--cpu"],
                     monkeypatch, tmp_path)
    jax_rows = _json_lines(capsys.readouterr().out)
    assert [r["solver"] for r in jax_rows] == ["gd", "mtfnn", "ppo"]
    for p_row, j_row in zip(rows[1:], jax_rows):
        j_row["task"] = task
        _close(j_row, p_row, 1e-5)

    ddpm = rows[0]
    metric = "exceeded_ratio" if fam == "co" else "less_ratio"
    extra = {"decision_accuracy", "terrible_count"} if fam == "co" else set()
    assert set(ddpm) == DDPM_KEYS | {metric} | extra
    assert ddpm["n_samples"] == {"co": 120.0, "msr": 120.0, "nu": 60.0}[fam]
    assert all(np.isfinite(ddpm[k]) for k in extra | {metric, "avg_diff"})
    if fam == "nu":     # the JAX DDPM row of the cheapest case, for its keys and types
        _run_jax_cli(jax_report, ["--task", jax_task, "--datasets", csv, "--ckpt",
                                  str(CKPTS / ckpt), *sampler, "--cpu"], monkeypatch, tmp_path)
        (j_ddpm,) = _json_lines(capsys.readouterr().out)
        assert j_ddpm.keys() == ddpm.keys()
        assert {k: type(v) for k, v in j_ddpm.items()} == {k: type(v) for k, v in ddpm.items()}


def test_report_needs_baseline_checkpoints(inputs):
    with pytest.raises(SystemExit, match="requires --ppo-ckpt"):
        report.main(["--task", "co", "--datasets", inputs(FAMILY_CSV["co"]), "--baselines",
                     "ppo", "--cpu"])


# -- fewstep ---------------------------------------------------------------------------------


def test_fewstep_rows_match_jax_cli_and_report(inputs, tmp_path, monkeypatch, capsys):
    csv = inputs(FAMILY_CSV["nu"])
    argv = ["--task", "nu_direct", "--ckpt", str(CKPTS / "ddpm_nu_3u_aug32_s8c"),
            "--datasets", csv, "--omega", "0.125", "--steps", "3", "--cpu"]
    fewstep.main(argv + ["--backend", "mega"])
    rows = _json_lines(capsys.readouterr().out)
    assert [(r["sampler"], r["steps"]) for r in rows] == [("ddpm", 20), ("ddim", 3)]
    _run_jax_cli(jax_fewstep, argv, monkeypatch, tmp_path)
    jax_rows = _json_lines(capsys.readouterr().out)
    for p_row, j_row in zip(rows, jax_rows):
        assert p_row.keys() == j_row.keys()
        assert {k: type(v) for k, v in p_row.items()} == {k: type(v) for k, v in j_row.items()}
    report.main(["--task", "nu_direct", "--datasets", csv, "--ckpt",
                 str(CKPTS / "ddpm_nu_3u_aug32_s8c"), "--omegas", "0.125", "--sampler", "ddim",
                 "--n-steps", "3", "--cpu"])
    (rep,) = _json_lines(capsys.readouterr().out)
    for k in ("less_ratio", "avg_diff"):
        assert rows[1][k] == rep[k], k


def test_fewstep_co_extra_metrics(inputs, capsys):
    """CO's extra metrics (decision accuracy, terrible rows) in every row."""
    fewstep.main(["--task", "co_ranked", "--ckpt", str(CKPTS / "ddpm_co_x0"), "--datasets",
                  inputs(FAMILY_CSV["co"]), "--omega", "1", "--steps", "3", "--limit", "64",
                  "--no-ddpm-row", "--cpu"])
    (row,) = _json_lines(capsys.readouterr().out)
    assert {"exceeded_ratio", "avg_diff", "decision_accuracy", "terrible_count"} <= set(row)
    assert row["steps"] == 3 and row["omega"] == 1.0


# -- the constants of chip_smoke.py's baselines and report phases -----------------------------


def _chip_smoke():
    from test_torch_tasks import chip_smoke

    return chip_smoke


def baseline_jax_constants():
    """chip_smoke.BASELINE_JAX: the JAX package's metrics of each shipped
    checkpoint (tools/report.py's run_mtfnn / run_ppo) and of GD (run_gd, op
    by op) on BASELINE_DATA's test splits."""
    from diffsg_tpu.tasks import TASKS as JAX_TASKS
    from diffsg_tpu.tasks.base import objective_metrics as jax_objective_metrics

    cs = _chip_smoke()
    paths = cs.baseline_splits()
    out = {}
    for (algo, fam), name in cs.BASELINE_CKPTS.items():
        jt = JAX_TASKS[fam]
        data = jt.load(paths[fam])
        Y = getattr(jax_report, f"run_{algo}")(fam, data, jt, str(CKPTS / name))
        out[name] = jax_objective_metrics(jt, data, np.asarray(Y))
    for fam in ("co", "msr", "nu"):
        jt = JAX_TASKS[fam]
        data = jt.load(paths[fam])
        with jax.disable_jit():
            Y = jax_report.run_gd(fam, data, jt)
        out[f"gd_{fam}"] = jax_objective_metrics(jt, data, np.asarray(Y))
    return out


def _jax_report_program(fam):
    """The JAX package's data and config for REPORT_SPECS[fam] and one
    compiled program ``run(cond, cond_unnorm, key)``: the body of its
    ``sample_solutions`` for one batch, compiled once for every seed."""
    from diffsg_tpu.tasks import TASKS as JAX_TASKS
    from diffsg_tpu.tasks.base import _make_draw, merge_ckpt_config

    cs = _chip_smoke()
    spec = cs.REPORT_SPECS[fam]
    jck = jax_load_checkpoint(str(CKPTS / spec["ckpt"]))
    jt = JAX_TASKS[spec["task"]]
    data = jt.load(cs.baseline_splits()[fam])
    merge_ckpt_config(data.config, jck["metadata"])
    cfg, argv = data.config, spec["argv"]
    omega = float(argv[argv.index("--omegas") + 1])
    sampler = argv[argv.index("--sampler") + 1] if "--sampler" in argv else "ddpm"
    n_steps = int(argv[argv.index("--n-steps") + 1]) if "--n-steps" in argv else None
    model = jt.build_model(cfg)
    draw = _make_draw(lambda p, y, t, c, m: model.apply({"params": p}, y, t, c, m),
                      jck["params"], jck["sched"], jt.data_dim(cfg), sampler, n_steps,
                      cfg.get("parameterization", "eps"), skip_uncond=omega == 0.0)

    @jax.jit
    def run(cond, cond_unnorm, key, omega_):      # omega traced, as sample_solutions has it
        y0 = draw(cond, omega_, key)[0]
        if jt.decode_with_x is not None:
            return jt.decode_with_x(y0, cond_unnorm, cfg)
        return jt.decode(y0, cfg)

    kw = dict(omega=omega, sampler=sampler, n_steps=n_steps)
    return jt, jck, data, kw, lambda c, cu, k: run(c, cu, k, jnp.float32(omega))


def jax_report_draws(fam, seeds, rows=None):
    """The JAX package's solutions on REPORT_SPECS[fam] per seed: batches of
    512, each with the next key of ``split(PRNGKey(seed))``, as its loop."""
    jt, _, data, _, run = _jax_report_program(fam)
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


def report_jax_constants(fam):
    """chip_smoke.REPORT_JAX[fam]: per metric of ``evaluate`` the mean over
    the spec's JAX seeds 0..K-1 and 4 standard errors of one draw's
    deviation from it, sqrt(1 + 1/K) times the square root of the summed
    seed-to-seed variances of each 512-row batch's contribution (at least
    1e-6 of the mean; one row for a count). Batches draw from independent
    keys, but the MSR decoder's batch-global min-max ties a batch's rows
    together, so the batch, not the row, is the unit of the variance."""
    from diffsg_tpu.tasks.co import decision_class

    jt, _, data, _, _ = _jax_report_program(fam)
    K = _chip_smoke().REPORT_SPECS[fam]["seeds"]
    cfg = data.config
    Xu = jnp.asarray(jt.unnormalize_x(data.X_test, cfg), jnp.float32)
    Y_true = jt.unnormalize_y(data.Y_test, cfg)
    true = np.asarray(jt.objective(jnp.asarray(Y_true, jnp.float32), Xu, cfg))
    n, rows = len(true), {}
    for Y in jax_report_draws(fam, range(K)):
        pred = np.asarray(jt.objective(jnp.asarray(Y, jnp.float32), Xu, cfg))
        r = {("less_ratio" if jt.higher_is_better else "exceeded_ratio"): pred / true.sum(),
             "avg_diff": (pred - true) / n}
        if jt.extra_metrics is not None:
            r["decision_accuracy"] = (decision_class(Y) == decision_class(Y_true)) / n
            r["terrible_count"] = ((pred / true > 1.2) & (pred > 10.0)).astype(np.float64)
        for k, v in r.items():
            rows.setdefault(k, []).append(v)
    out = {}
    for k, v in rows.items():
        r = np.stack(v)
        batches = np.add.reduceat(r, np.arange(0, n, 512), axis=1)
        mean = float(r.sum(axis=1).mean())
        spread = 4 * np.sqrt(1 + 1 / K) * np.sqrt(batches.var(axis=0, ddof=1).sum())
        out[k] = (mean, float(max(spread, 1.0 if k == "terrible_count" else 1e-6 * abs(mean))))
    return out


@pytest.mark.slow
def test_chip_smoke_baseline_constants():
    """BASELINE_JAX is ``baseline_jax_constants()``; the port on the CPU
    lands within BASELINE_RTOL of each."""
    cs = _chip_smoke()
    got = baseline_jax_constants()
    assert set(got) == set(cs.BASELINE_JAX)
    for name, metrics in cs.BASELINE_JAX.items():
        for k, v in metrics.items():
            assert v == pytest.approx(got[name][k], rel=1e-7), (name, k)
    from diffsg_tpu_torch.tasks import TASKS, objective_metrics

    paths, dev = cs.baseline_splits(), torch.device("cpu")
    for (algo, fam), name in cs.BASELINE_CKPTS.items():
        data = TASKS[fam].load(paths[fam])
        Y = getattr(report, f"run_{algo}")(fam, data, str(CKPTS / name), dev)
        m = objective_metrics(TASKS[fam], data, Y, device=dev)
        for k, v in cs.BASELINE_JAX[name].items():
            assert abs(m[k] - v) <= cs.BASELINE_RTOL * abs(v), (name, k, m[k], v)
    for fam in ("co", "msr", "nu"):
        data = TASKS[fam].load(paths[fam])
        m = objective_metrics(TASKS[fam], data, report.run_gd(fam, data, TASKS[fam], dev),
                              device=dev)
        for k, v in cs.BASELINE_JAX[f"gd_{fam}"].items():
            assert abs(m[k] - v) <= cs.BASELINE_RTOL * abs(v), (fam, k, m[k], v)


@pytest.mark.slow
@pytest.mark.parametrize("fam", ["co", "msr", "nu"])
def test_chip_smoke_report_constants(fam):
    """REPORT_JAX[fam] is ``report_jax_constants(fam)``; the compiled
    program draws what the JAX package's own ``sample_solutions`` draws;
    the port's ``evaluate`` on the CPU (plain) lands within each tolerance."""
    from diffsg_tpu.tasks.base import sample_solutions as jax_sample_solutions
    from diffsg_tpu_torch.tasks import TASKS, evaluate, merge_ckpt_config

    cs = _chip_smoke()
    want = cs.REPORT_JAX[fam]
    got = report_jax_constants(fam)
    assert set(want) == set(got)
    for k, (mean, tol) in want.items():
        assert mean == pytest.approx(got[k][0], rel=1e-6, abs=1e-12), k
        assert tol == pytest.approx(got[k][1], rel=1e-3), k
    jt, jck, jdata, kw, _ = _jax_report_program(fam)
    ref, _ = jax_sample_solutions(jt, jck["params"], jck["sched"], jdata.X_test[:1100],
                                  jdata.config, kw["omega"], 512, 3, sampler=kw["sampler"],
                                  n_steps=kw["n_steps"])
    np.testing.assert_array_equal(jax_report_draws(fam, [3], 1100)[0], ref)

    spec = cs.REPORT_SPECS[fam]
    ck = load_checkpoint(str(CKPTS / spec["ckpt"]), device="cpu")
    task = TASKS[spec["task"]]
    data = task.load(cs.baseline_splits()[fam])
    merge_ckpt_config(data.config, ck["metadata"])
    m = evaluate(task, ck["params"], ck["sched"], data, omega=kw["omega"], seed=0,
                 sampler=kw["sampler"], n_steps=kw["n_steps"], backend="plain")
    for k, (mean, tol) in want.items():
        assert abs(m[k] - mean) <= tol, (k, m[k], mean, tol)

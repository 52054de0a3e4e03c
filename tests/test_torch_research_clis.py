"""The port's research CLIs (``diffsg_tpu_torch/tools/dump_trajectory.py``,
``refine_labels.py``, ``refine_study.py`` and ``nu12_to_geo15.py``) against
the JAX package's ``tools/`` CLIs, on small CSVs that the port's
``make_rows`` writes here (the JAX package's bytes).

* ``dump_trajectory``: the port's rows equal the JAX sampler's trajectory,
  decoded by the JAX package's ``decode_trace``, on the port's noise at
  omega 0; the last step's block is ``sample_solutions``' decode.
* ``refine_labels``: with no random start and no model seed the refinement
  is deterministic, and the port CLI's CSV equals the JAX CLI's to 1e-5
  relative on the 13-, 12- and 15-column formats; with random starts,
  ``refine_rows`` takes the JAX CLI's own draws (``jax.random.uniform``
  recorded while it runs) and lands on its labels; the JAX package's
  contract tests (``tests/test_refine_labels.py``) hold for the port.
* ``refine_study``: on the JAX CLI's recorded draws its random arms equal
  the JAX CLI's; the diffusion arms are the port's own draw, so only their
  keys are held; the best of the starts is never below start 0.
* ``nu12_to_geo15``: the port's bytes equal the JAX CLI's when pandas
  parses the input correctly rounded (``float_precision="round_trip"``);
  its default parser puts some values 1 ulp off, and only those fields
  differ. The SHA-256 constant ``chip_smoke.py`` holds the card's output to
  is computed here (marked slow).
"""

import hashlib
import pathlib
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample
from diffsg_tpu.ops.objectives import nu_rate as jax_nu_rate
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu.utils.trace import decode_trace as jax_decode_trace
from diffsg_tpu_torch.data.datasets import make_rows, write_csv
from diffsg_tpu_torch.tasks import TASKS, sample_solutions
from diffsg_tpu_torch.tools import dump_trajectory, nu12_to_geo15, refine_labels, refine_study
from diffsg_tpu_torch.utils import load_checkpoint

import tools.nu12_to_geo15 as jax_nu12_to_geo15
import tools.refine_labels as jax_refine_labels
import tools.refine_study as jax_refine_study

from test_torch_report_clis import _json_lines, _run_jax_cli
from test_torch_tasks import chip_smoke

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = REPO / "ckpts"
INPUTS = {"3nodes_300samples.csv": ("co", dict(samples=300)),
          "3u_18mW_200samples.csv": ("nu", dict(samples=200, grid_step=8.0)),
          "3u_budget9-36_120samples.csv": ("nu-budget", dict(samples=120, grid_step=8.0)),
          "3u_geo_60samples.csv": ("nu-geo", dict(samples=60, grid_step=8.0))}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    for name, (kind, kw) in INPUTS.items():
        write_csv(root / name, make_rows(kind, **kw))
    return lambda name: str(root / name)


class UniformRecorder:
    """``jax.random.uniform`` that keeps every draw it hands out."""

    def __init__(self):
        self.real, self.draws = jax.random.uniform, []

    def __call__(self, *a, **k):
        out = self.real(*a, **k)
        self.draws.append(np.asarray(out))
        return out

    def starts(self):
        """The draws as the port's unit starts (n, B, 2+K): each start's
        position draw, then its power draw."""
        return torch.from_numpy(np.stack([np.concatenate(self.draws[i:i + 2], axis=1)
                                          for i in range(0, len(self.draws), 2)]))


# -- dump_trajectory ---------------------------------------------------------------------


def test_dump_trajectory_matches_jax_with_the_same_noise(inputs, tmp_path, capsys):
    """CO at omega 0, 60 rows: the port CLI's file against the JAX sampler
    on the port's noise (``sample_solutions``' draw: one (60, T+1, D)
    normal from ``torch.Generator(seed)``), each step decoded by the JAX
    package's ``decode_trace``."""
    csv, out = inputs("3nodes_300samples.csv"), tmp_path / "co_path.csv"
    rows = dump_trajectory.main(["--task", "co", "--ckpt", str(CKPTS / "ddpm_co"), "--dataset",
                                 csv, "--out", str(out), "--limit", "60", "--omega", "0",
                                 "--seed", "3", "--cpu"])
    assert capsys.readouterr().out.startswith("Trajectory generating finished, 60 samples")
    np.testing.assert_array_equal(np.loadtxt(out, delimiter=","), rows)
    jt, jck = JAX_TASKS["co"], jax_load_checkpoint(str(CKPTS / "ddpm_co"))
    data = jt.load(csv)
    X = jnp.asarray(data.X_test[:60], jnp.float32)
    T, D = jck["sched"].T, jt.data_dim(data.config)
    noise = torch.randn((60, T + 1, D), generator=torch.Generator().manual_seed(3)).numpy()
    model = jt.build_model(data.config)
    _, trace = jax_cfg_sample(lambda p, y, t, c, m: model.apply({"params": p}, y, t, c, m),
                              jck["params"], jck["sched"], X, 0.0, D,
                              init_noise=jnp.asarray(noise[:, 0]),
                              step_noise=jnp.asarray(noise[:, 1:].transpose(1, 0, 2)),
                              skip_uncond=True, record_trace=True)
    ref = jax_decode_trace("co", jax.tree.map(np.asarray, trace), data.config)
    assert rows.shape == ref.shape == (60, T * D)
    np.testing.assert_allclose(rows, ref, rtol=0, atol=1e-5)
    task = TASKS["co"]
    ck = load_checkpoint(str(CKPTS / "ddpm_co"), device="cpu")
    dec, _ = sample_solutions(task, ck["params"], ck["sched"], data.X_test[:60], data.config,
                              omega=0.0, seed=3)
    np.testing.assert_array_equal(rows[:, -D:], dec)


# -- refine_labels -------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["13", "12", "15"])
def test_refine_labels_deterministic_csv_matches_jax(fmt, inputs, tmp_path, monkeypatch, capsys):
    """``--starts 0 --iters 3`` (no model seed): the port CLI's CSV equals
    the JAX CLI's to 1e-5 relative, but for rows whose accept test ties
    (below), and so do their stats lines."""
    src = {"13": "3u_budget9-36_120samples.csv", "12": "3u_18mW_200samples.csv",
           "15": "3u_geo_60samples.csv"}[fmt]
    outs = {}
    for who in ("jax", "port"):
        dst = tmp_path / f"{who}.csv"
        if fmt == "12":      # the in-dist pair, fixed 18 mW; the budget file first
            argv = ["--budget-in", inputs("3u_budget9-36_120samples.csv"), "--budget-out",
                    str(tmp_path / f"{who}_b.csv"), "--indist-in", inputs(src),
                    "--indist-out", str(dst)]
        else:
            argv = ["--budget-in", inputs(src), "--budget-out", str(dst), "--skip-indist"]
        argv += ["--iters", "3", "--starts", "0", "--cpu"]
        capsys.readouterr()
        if who == "jax":
            _run_jax_cli(jax_refine_labels, argv, monkeypatch, tmp_path)
            stats = _json_lines(capsys.readouterr().out)
        else:
            stats = refine_labels.main(argv)
        outs[who] = (np.loadtxt(dst, delimiter=","), stats)
    (got, pstats), (want, jstats) = outs["port"], outs["jax"]
    # The rates agree on every row. A label may part where the two packages'
    # objectives tie to float32 rounding at a step's accept test (one row of
    # the 15-column set, at a rate equal to the last bit): such a row keeps
    # an equally good label, so its rate is held to one float32 ulp.
    np.testing.assert_allclose(got[:, 11], want[:, 11], rtol=1e-5, atol=0)
    part = ~np.isclose(got, want, rtol=1e-5, atol=0).all(axis=1)
    assert part.mean() <= 0.02, np.nonzero(part)
    ulp = np.spacing(np.abs(want[part, 11]).astype(np.float32))
    assert (np.abs(got[part, 11] - want[part, 11]) <= ulp).all()
    raw = np.loadtxt(inputs(src), delimiter=",")
    keep = [c for c in range(raw.shape[1]) if c not in range(6, 12)]
    np.testing.assert_array_equal(got[:, keep], raw[:, keep])
    for p, j in zip(pstats, jstats, strict=True):
        assert p.keys() == j.keys()
        for k in ("rows", "repaired_rows", "frac_model_basin"):
            assert p[k] == j[k], k
        for k in ("mean_ratio", "min_ratio"):
            assert p[k] == pytest.approx(j[k], rel=1e-5), k


def test_refine_rows_on_the_jax_draws(inputs, monkeypatch):
    """Three random starts, the JAX package's own draws handed to the port:
    the refined labels and rates agree to 1e-5 relative."""
    raw = np.loadtxt(inputs("3u_budget9-36_120samples.csv"), delimiter=",")[:48]
    coords, Y0, P = raw[:, :6], raw[:, 6:11], raw[:, 12]
    rec = UniformRecorder()
    monkeypatch.setattr(jax.random, "uniform", rec)
    jY, jR, _ = jax_refine_labels.refine_rows(coords, Y0, P, 2, 3, 7, 400.0, 400.0)
    monkeypatch.undo()
    starts = rec.starts()
    assert starts.shape == (3, 48, 5)
    Y, R, frac = refine_labels.refine_rows(coords, Y0, P, 2, starts, 7, 400.0, 400.0,
                                           device="cpu")
    assert frac == 0.0
    np.testing.assert_allclose(Y, jY, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(R, jR, rtol=1e-5)


def _toy_csv(path, rows=12, ncol=13, seed=0):
    """The JAX package's ``tests/test_refine_labels.py`` fixture: uniform
    power splits, far from optimal."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 400, (rows, 6))
    uav = rng.uniform(100, 300, (rows, 2))
    budgets = rng.choice([9.0, 18.0, 27.0], rows)
    P = np.full((rows, 3), 1.0 / 3.0) * budgets[:, None]
    rate = np.asarray(jax_nu_rate(jnp.asarray(np.concatenate([uav, P], axis=1), jnp.float32),
                                  jnp.asarray(coords, jnp.float32)), float)
    cols = [coords, uav, P, rate[:, None]] + ([budgets[:, None]] if ncol == 13 else [])
    np.savetxt(path, np.concatenate(cols, axis=1), delimiter=",", fmt="%.18e")
    return budgets if ncol == 13 else np.full_like(budgets, 18.0)


@pytest.mark.parametrize("ncol", [13, 12])
def test_refine_labels_process_contract(tmp_path, ncol):
    """The JAX package's contract: the conditions and budget pass through,
    the labels are feasible, the rate column is the label's rate, no row
    gets worse and every one improves."""
    src, dst = tmp_path / "src.csv", tmp_path / "dst.csv"
    budgets = _toy_csv(src, ncol=ncol)
    stats = refine_labels.process(str(src), str(dst), iters=40, starts=2, seed=0, width=400.0,
                                  height=400.0, P_fixed=18.0, device="cpu")
    assert stats["rows"] == 12 and stats["frac_improved"] == 1.0 and stats["mean_ratio"] > 1.0
    raw, out = np.loadtxt(src, delimiter=","), np.loadtxt(dst, delimiter=",")
    assert out.shape == raw.shape
    np.testing.assert_array_equal(out[:, :6], raw[:, :6])
    np.testing.assert_array_equal(out[:, 12:], raw[:, 12:])
    assert out[:, 6:8].min() >= 0 and out[:, 6:8].max() <= 400
    assert out[:, 8:11].min() >= -1e-5
    np.testing.assert_allclose(out[:, 8:11].sum(axis=1), budgets, rtol=1e-5)
    r = np.asarray(jax_nu_rate(jnp.asarray(out[:, 6:11], jnp.float32),
                               jnp.asarray(out[:, :6], jnp.float32)), float)
    np.testing.assert_allclose(out[:, 11], r, rtol=1e-4)
    assert np.all(out[:, 11] >= raw[:, 11])


def test_refine_labels_geo_rows_stay_in_their_own_field(inputs, tmp_path):
    src, dst = inputs("3u_geo_60samples.csv"), tmp_path / "dst.csv"
    stats = refine_labels.process(src, str(dst), iters=20, starts=1, seed=0, width=400.0,
                                  height=400.0, P_fixed=None, device="cpu")
    raw, out = np.loadtxt(src, delimiter=","), np.loadtxt(dst, delimiter=",")
    assert stats["rows"] == 60 and stats["mean_ratio"] >= 1.0
    np.testing.assert_array_equal(out[:, 12:], raw[:, 12:])
    assert (out[:, 6] >= 0).all() and (out[:, 6] <= out[:, 13]).all()
    assert (out[:, 7] >= 0).all() and (out[:, 7] <= out[:, 14]).all()
    np.testing.assert_allclose(out[:, 8:11].sum(axis=1), out[:, 12], rtol=1e-5)


def test_refine_rows_model_seed_tie_break():
    """Expert iteration: the model's refined basin is kept when within
    ``tie_eps`` of the multistart best (always, at a tolerance of 1), and
    never when the tolerance is negative."""
    rng = np.random.default_rng(3)
    coords = rng.uniform(0, 400, (8, 6))
    Y0 = np.concatenate([rng.uniform(100, 300, (8, 2)), np.full((8, 3), 6.0)], axis=1)
    P = np.full(8, 18.0)
    model_Y0 = np.concatenate([coords[:, :2], np.full((8, 3), 6.0)], axis=1)
    kw = dict(model_Y0=model_Y0, device="cpu")
    _, R_all, f_all = refine_labels.refine_rows(coords, Y0, P, 10, 2, 0, 400.0, 400.0,
                                                tie_eps=1.0, **kw)
    _, R_none, f_none = refine_labels.refine_rows(coords, Y0, P, 10, 2, 0, 400.0, 400.0,
                                                  tie_eps=-1.0, **kw)
    _, R_base, _ = refine_labels.refine_rows(coords, Y0, P, 10, 2, 0, 400.0, 400.0,
                                             device="cpu")
    assert f_all == 1.0 and f_none == 0.0
    np.testing.assert_array_equal(R_none, R_base)
    assert not np.array_equal(R_all, R_base)


def test_refine_labels_model_seed_draws(inputs, tmp_path):
    """``--model-seed`` on a ``nu_budget`` checkpoint: one draw per budget
    group, feasible, and the stats line counts the model's basin."""
    src = inputs("3u_budget9-36_120samples.csv")
    raw = np.loadtxt(src, delimiter=",")
    draws = refine_labels.model_draws(raw[:, :6], raw[:, 12], str(CKPTS / "ddpm_nu_budget"), 0.5,
                                      400.0, 400.0, seed=0, device="cpu")
    assert draws.shape == (120, 5) and np.isfinite(draws).all()
    np.testing.assert_allclose(draws[:, 2:].sum(axis=1), raw[:, 12], rtol=1e-5)
    stats = refine_labels.main(["--budget-in", src, "--budget-out", str(tmp_path / "o.csv"),
                                "--skip-indist", "--iters", "5", "--starts", "1",
                                "--model-seed", str(CKPTS / "ddpm_nu_budget"), "--cpu"])
    assert 0.0 < stats[0]["frac_model_basin"] <= 1.0 and stats[0]["mean_ratio"] > 1.0


# -- refine_study ----------------------------------------------------------------------------


def test_refine_study_random_arms_match_jax(inputs, tmp_path, monkeypatch, capsys):
    csv = inputs("3u_18mW_200samples.csv")
    argv = ["--iters", "2", "--starts", "3", "--dataset", csv, "--cpu"]
    rec = UniformRecorder()
    monkeypatch.setattr(jax.random, "uniform", rec)
    capsys.readouterr()
    _run_jax_cli(jax_refine_study, argv, monkeypatch, tmp_path)
    monkeypatch.undo()
    (want,) = _json_lines(capsys.readouterr().out)
    starts = rec.starts()[:3]       # the same three starts at both iteration counts
    assert len(rec.draws) == 12 and starts.shape == (3, 60, 5)
    got = refine_study.study(str(CKPTS / "ddpm_nu_budget"), csv, 2, starts, 0.06, device="cpu")
    assert list(got) == list(want)
    for k in ("iters", "starts", "dataset", "n", "labels"):
        assert got[k] == want[k], k
    for k in ("random1_it2", "random3_it2", "random1_it8", "random3_it8"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert got["random3_it2"] >= got["random1_it2"] and got["random3_it8"] >= got["random1_it8"]
    line = refine_study.main(argv)
    assert list(line) == list(want) and line["starts"] == 3


# -- nu12_to_geo15 ----------------------------------------------------------------------------


def _jax_nu12_to_geo15(argv, monkeypatch, tmp_path, round_trip):
    """The JAX CLI; with ``round_trip``, its pandas reader told to parse
    correctly rounded."""
    real = pd.read_csv
    with monkeypatch.context() as m:
        if round_trip:
            m.setattr(jax_nu12_to_geo15.pd, "read_csv",
                      lambda *a, **k: real(*a, float_precision="round_trip", **k))
        m.setattr(sys, "argv", ["prog"] + argv)
        jax_nu12_to_geo15.main()


def test_nu12_to_geo15_writes_the_jax_bytes(inputs, tmp_path, monkeypatch, capsys):
    src = inputs("3u_18mW_200samples.csv")
    args = ["--inp", src, "--power", "18", "--width", "400", "--height", "400", "--out"]
    out = nu12_to_geo15.main(args + [str(tmp_path / "port.csv"), "--cpu"])
    assert out.shape == (200, 15)
    _jax_nu12_to_geo15(args + [str(tmp_path / "exact.csv")], monkeypatch, tmp_path, True)
    _jax_nu12_to_geo15(args + [str(tmp_path / "pandas.csv")], monkeypatch, tmp_path, False)
    port = (tmp_path / "port.csv").read_bytes()
    assert port == (tmp_path / "exact.csv").read_bytes()
    # pandas' default parser: only the fields it reads off differ, by 1 ulp.
    exact = np.loadtxt(src, delimiter=",")
    misread = np.array(pd.read_csv(src, header=None)) != exact
    lines = [l.split(",") for l in port.decode().splitlines()]
    jlines = [l.split(",") for l in (tmp_path / "pandas.csv").read_text().splitlines()]
    for i, (p, j) in enumerate(zip(lines, jlines, strict=True)):
        for c, (a, b) in enumerate(zip(p, j, strict=True)):
            if a != b:
                assert c < 12 and misread[i, c], (i, c)
                assert abs(float(a) - float(b)) <= np.spacing(abs(float(a)))
    assert misread.any()


def test_nu12_to_geo15_checks_the_claimed_config(inputs, tmp_path):
    src = inputs("3u_18mW_200samples.csv")
    for flag, value, what in (("--power", "9", "power sums"), ("--width", "100", "x-coords"),
                              ("--height", "100", "y-coords")):
        args = {"--power": "18", "--width": "400", "--height": "400", flag: value}
        with pytest.raises(AssertionError, match=what):
            nu12_to_geo15.main(["--inp", src, "--out", str(tmp_path / "x.csv")]
                               + [a for kv in args.items() for a in kv])


@pytest.mark.slow
def test_chip_smoke_nu12_to_geo15_constant(tmp_path, monkeypatch):
    """``chip_smoke.NU12_TO_GEO15_SHA256``: the JAX CLI's output (its
    reader correctly rounded) on ``BASELINE_DATA``'s NU set; the port's
    output has the same SHA-256."""
    parts, (kind, kw), _ = chip_smoke.BASELINE_DATA["nu"]
    src = tmp_path / parts[-1]
    write_csv(src, make_rows(kind, **kw))
    args = ["--inp", str(src), "--power", "18", "--width", "400", "--height", "400", "--out"]
    _jax_nu12_to_geo15(args + [str(tmp_path / "jax.csv")], monkeypatch, tmp_path, True)
    nu12_to_geo15.main(args + [str(tmp_path / "port.csv")])
    want = hashlib.sha256((tmp_path / "jax.csv").read_bytes()).hexdigest()
    assert want == chip_smoke.NU12_TO_GEO15_SHA256
    assert hashlib.sha256((tmp_path / "port.csv").read_bytes()).hexdigest() == want

"""The port's data layer (``diffsg_tpu_torch/data``) against the JAX
package's: the loaders on the repository's four CSVs, the fixtures, the
filename parse, the legacy reader, the synthetic task, and the generators
that remake ``datasets/`` (which is not committed).

The port reads CSVs with ``np.loadtxt``, which rounds every decimal
correctly; the JAX package reads them with pandas' default parser, which is
one or two units off in the last place on some values. The tests count
those values; every float32 array the samplers see is equal bit for bit.
"""

import ast
import pathlib

import numpy as np
import pandas as pd
import pytest

from diffsg_tpu.data import generators as jax_generators
from diffsg_tpu.data import loaders as jax_loaders
from diffsg_tpu.data import normalize as jax_normalize
from diffsg_tpu.data import synthetic as jax_synthetic
from diffsg_tpu.data.native import nu_oracle_native as jax_nu_oracle_native
from diffsg_tpu_torch.data import (generators, loaders, normalize, preprocess, synthetic,
                                   ensure_datasets)
from diffsg_tpu_torch.data.native import nu_oracle_native

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures"
CO_CSV = "3nodes_50000samples_new.csv"
# (file, width, height, P_sum): the load_kw of tools/headline.py:390-397.
GEO = [("3u_geo480x360_21mW_1000samples.csv", 480.0, 360.0, 21.0),
       ("3u_geo600x600_33mW_500samples.csv", 600.0, 600.0, 33.0),
       ("3u_geo200x200_12mW_500samples.csv", 200.0, 200.0, 12.0)]
# Values where pandas' default parser and a correctly rounded one differ,
# and by how many units in the last place at most (float64).
PARSE_DIFFS = {CO_CSV: (148_783, 2), GEO[0][0]: (335, 2), GEO[1][0]: (599, 2),
               GEO[2][0]: (613, 1)}


def ulps(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a.view(np.int64) - b.view(np.int64))


@pytest.fixture(scope="module")
def datasets():
    """The four CSVs, remade by the port's generators where missing."""
    return {name: str(p) for name, p in ensure_datasets().items()}


@pytest.mark.parametrize("name", sorted(PARSE_DIFFS))
def test_csv_parse_against_pandas(datasets, name):
    got = loaders._read_csv(datasets[name])
    ref = np.array(pd.read_csv(datasets[name], header=None))
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.float64
    u = ulps(got, ref)
    count, most = PARSE_DIFFS[name]
    assert (int((u > 0).sum()), int(u.max())) == (count, most)
    # The correctly rounded value is Python's own float().
    with open(datasets[name]) as f:
        first = [float(v) for v in f.readline().split(",")]
    np.testing.assert_array_equal(got[0], first)


def scaled_ulps(a, b):
    """max |a - b| in units in the last place of max |b| (float64)."""
    return float(np.abs(a - b).max() / np.spacing(np.abs(b).max()))


def _assert_taskdata_close(got, ref, max_ulps):
    """Every array within ``max_ulps`` units in the last place of its
    largest value (float64) and equal in float32; the same config, its
    floats within 4 ulps."""
    for name in ("X_train", "Y_train", "X_test", "Y_test", "R_test"):
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        assert scaled_ulps(a, b) <= max_ulps[name], (name, scaled_ulps(a, b))
        np.testing.assert_array_equal(a.astype(np.float32), b.astype(np.float32))
    assert got.config.keys() == ref.config.keys()
    for k, v in ref.config.items():
        if isinstance(v, float):
            assert ulps(got.config[k], v) <= 4, k
        else:
            assert got.config[k] == v, k


def test_load_co_against_jax(datasets):
    got, ref = loaders.load_co(datasets[CO_CSV]), jax_loaders.load_co(datasets[CO_CSV])
    # The uplink rate log2(1 + sinr) at small sinr amplifies a 2-ulp parse
    # difference of h: the scaled features differ by up to 93 ulps of 1.
    _assert_taskdata_close(got, ref, {"X_train": 100, "Y_train": 1, "X_test": 100,
                                      "Y_test": 1})
    # The split sizes come from the pre-filter count, so after the filter
    # the first test rows are the last train rows.
    raw = loaders._read_csv(datasets[CO_CSV])[:, :18]
    feats = preprocess.data_preprocess_co(np.concatenate(
        [raw, np.tile(preprocess.CO_COMMON_FEATURES, (raw.shape[0], 1))], axis=1))
    kept = int(np.all(feats < 10.0, axis=1).sum())
    assert got.X_train.shape[0] == 35_000 and got.X_test.shape[0] == 15_000 and kept < 50_000
    overlap = 50_000 - kept
    np.testing.assert_array_equal(got.X_test[:overlap], got.X_train[-overlap:])


@pytest.mark.parametrize("name,w,h,p", GEO)
def test_load_nu_geo_against_jax(datasets, name, w, h, p):
    got = loaders.load_nu_geo(datasets[name], width=w, height=h, P_sum=p)
    ref = jax_loaders.load_nu_geo(datasets[name], width=w, height=h, P_sum=p)
    _assert_taskdata_close(got, ref, {"X_train": 0, "Y_train": 1, "X_test": 0, "Y_test": 1,
                                      "R_test": 2})
    assert got.X_test.shape[1] == 9
    np.testing.assert_array_equal(got.X_test[:, 6:], np.tile([p / 18.0, w / 400.0, h / 400.0],
                                                             (got.X_test.shape[0], 1)))


def _write(path, rows):
    np.savetxt(path, rows, delimiter=",")
    return str(path)


@pytest.mark.parametrize("fn,kw", [("load_msr", {}), ("load_msr_budget", {}),
                                   ("load_nu", {}), ("load_nu_budget", {"p_ref": 9.0}),
                                   ("load_nu_geo", {"width": 300.0, "height": 200.0})])
def test_loaders_against_jax_on_written_csvs(tmp_path, fn, kw):
    """Every loader on a small seeded CSV of its layout, W or P_sum parsed
    from the file name."""
    rng = np.random.default_rng(len(fn))
    if fn.startswith("load_msr"):
        g = rng.uniform(0.5, 2.5, (40, 3))
        rows = np.concatenate([g, rng.uniform(5, 9, (40, 1)), rng.dirichlet(np.ones(3), 40) * 10],
                              axis=1)
        path = _write(tmp_path / "3c_10w_40samples.csv", rows)
    else:
        rows = np.concatenate([rng.integers(1, 400, (40, 8)).astype(float),
                               rng.dirichlet(np.ones(3), 40) * 18, rng.uniform(0, 1e-3, (40, 1))],
                              axis=1)
        path = _write(tmp_path / "3u_18mW_40samples.csv", rows)
    got, ref = getattr(loaders, fn)(path, **kw), getattr(jax_loaders, fn)(path, **kw)
    _assert_taskdata_close(got, ref, {k: 2 for k in ("X_train", "Y_train", "X_test", "Y_test",
                                                     "R_test")})
    assert got.X_train.shape[0] == 28 and got.X_test.shape[0] == 12


def test_nu_loader_matches_fixture_head(tmp_path):
    """``nu_data_head.npz`` holds the heads of the reference's 10,000-row
    18 mW NU split: a CSV with those rows at the split's positions loads
    back to them, in the port and in the JAX package."""
    fx = np.load(FIXTURES / "nu_data_head.npz")
    n_train, n_test, P = int(fx["n_train"]), int(fx["n_test"]), float(fx["P_sum"])
    scale_x = np.tile([400.0, 400.0], 3)
    scale_y = np.array([400.0, 400.0, P, P, P])
    rows = np.zeros((n_train + n_test, 12))
    rows[:, :6], rows[:, 6:11] = 100.0, 1.0
    for start, X, Y in ((0, fx["X_train_head"], fx["Y_train_head"]),
                        (n_train, fx["X_test_head"], fx["Y_test_head"])):
        rows[start:start + 8, :6] = X * scale_x
        rows[start:start + 8, 6:11] = Y * scale_y
    path = _write(tmp_path / "3u_18mW_10000samples.csv", rows)
    got = loaders.load_nu(path)
    assert got.config["K"] == int(fx["K"]) and got.config["P_sum"] == P
    assert (got.X_train.shape[0], got.X_test.shape[0]) == (n_train, n_test)
    for name in ("X_train", "Y_train", "X_test", "Y_test"):
        np.testing.assert_allclose(getattr(got, name)[:8], fx[f"{name}_head"], rtol=1e-12)
    _assert_taskdata_close(got, jax_loaders.load_nu(path), {k: 2 for k in (
        "X_train", "Y_train", "X_test", "Y_test", "R_test")})


@pytest.mark.parametrize("path,suffix,want", [
    ("datasets/3u_30mW_1000samples_ood.csv", "mw", 30.0),
    ("3u_18mW_10000samples.csv", "mw", 18.0),
    ("x/3c_20w_2000samples_ood.csv", "w", 20.0),
    ("3c_10.5W_10samples.csv", "w", 10.5),
    ("3u_geo480x360_21mW_1000samples.csv", "mw", 21.0),
    ("3nodes_50000samples_new.csv", "mw", None),
])
def test_filename_parse(path, suffix, want):
    assert loaders._parse_filename_float(path, suffix) == want
    assert jax_loaders._parse_filename_float(path, suffix) == want


def test_ood_filename_loads(tmp_path):
    rows = np.concatenate([np.full((10, 6), 50.0), np.full((10, 2), 200.0),
                           np.full((10, 3), 10.0), np.full((10, 1), 1e-4)], axis=1)
    td = loaders.load_nu(_write(tmp_path / "3u_30mW_1000samples_ood.csv", rows))
    assert td.config["P_sum"] == 30.0
    np.testing.assert_allclose(td.Y_test[:, 2:], 1 / 3)
    with pytest.raises(ValueError, match="P_sum not given"):
        loaders.load_nu(_write(tmp_path / "3u_users.csv", rows))


def test_preprocess_co_fixture():
    fx = np.load(FIXTURES / "preprocess_co.npz")
    np.testing.assert_allclose(preprocess.data_preprocess_co(fx["raw"]), fx["simplified"],
                               rtol=1e-12)


def test_co_cond_fixture(datasets):
    """``co_cond.npz`` is the first 4,096 test-split rows of the CO CSV
    through the JAX package's ``load_co``, in float32: the port's rows equal
    them bit for bit."""
    fx = np.load(FIXTURES / "co_cond.npz")
    td = loaders.load_co(datasets[CO_CSV])
    np.testing.assert_array_equal(td.X_test[:4096].astype(np.float32), fx["X"])
    np.testing.assert_array_equal(td.Y_test[:4096].astype(np.float32), fx["Y"])


def test_read_dataset_legacy_header_quirk(tmp_path):
    """The reference reads the legacy file with a header line: the first
    data row is dropped, as pandas does in the JAX package."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 5, (31, 21))
    Y = np.concatenate([rng.integers(0, 7, (31, 1)), rng.uniform(0, 1, (31, 3))], axis=1)
    path = _write(tmp_path / "co_legacy.csv", np.concatenate([X, Y], axis=1))
    got = normalize.read_dataset_legacy(path, seed=3)
    ref = jax_normalize.read_dataset_legacy(path, seed=3)
    assert len(got) == len(ref) == 6
    assert got[0].shape[0] + got[1].shape[0] == 30
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert ulps(a, b).max() <= 8
    assert not np.isin(X[0, 0], X[1:, 0])
    unscaled = np.concatenate([got[2], got[4]])
    assert set(unscaled[:, 0]) <= set(Y[1:, 0])


def test_normalizers_match_jax():
    X = np.random.default_rng(2).normal(3, 2, (50, 4))
    np.testing.assert_array_equal(normalize.min_max_norm(X, 0.1, 1.1),
                                  jax_normalize.min_max_norm(X, 0.1, 1.1))
    np.testing.assert_array_equal(normalize.mean_norm(X), jax_normalize.mean_norm(X))


def test_validation_data_gen_matches_jax():
    got, ref = synthetic.validation_data_gen(200, seed=4), jax_synthetic.validation_data_gen(
        200, seed=4)
    for name in ("X_train", "Y_train", "X_test", "Y_test"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert got.config == ref.config
    assert (got.X_train.shape, got.X_test.shape) == ((420, 9), (180, 9))
    # The label picks the block offset by +1.
    blocks = got.X_train.reshape(-1, 3, 3).sum(axis=2)
    np.testing.assert_array_equal(np.argmax(blocks, axis=1), np.argmax(got.Y_train, axis=1))


def test_co_generator_matches_jax():
    got = generators.co_minlp_gen(700, seed=5, batch=256)
    ref, _ = jax_generators.co_minlp_gen(700, seed=5, batch=256)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (700, 22)


def test_nu_generators_match_jax():
    qs = generators.nu_coordinates_gen(np.random.default_rng(6), 12, width=300, height=200)
    np.testing.assert_array_equal(
        qs, jax_generators.nu_coordinates_gen(np.random.default_rng(6), 12, width=300,
                                              height=200))
    kw = dict(P_sum=15.0, grid_step=4.0, width=300.0, height=200.0)
    np.testing.assert_array_equal(nu_oracle_native(qs, **kw), jax_nu_oracle_native(qs, **kw))


def test_ensure_datasets_remakes_the_files_byte_for_byte(tmp_path, datasets):
    """The smallest CSV, remade from its recipe, is the committed recipe's
    file byte for byte."""
    name = GEO[2][0]
    out = ensure_datasets([name], root=str(tmp_path))[name]
    assert out.read_bytes() == pathlib.Path(datasets[name]).read_bytes()


def test_data_layer_imports_no_pandas():
    for path in sorted((REPO / "diffsg_tpu_torch" / "data").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in ("pandas", "jax", "diffsg_tpu")], \
                f"{path.name}:{node.lineno} imports {names}"

"""The port's dataset generators (``diffsg_tpu_torch/data/generators.py``,
``data/native.py``) and its ``make_datasets`` CLI against the JAX
package's: the same seed gives the same rows bit for bit, and every
subcommand writes the same bytes."""

import pathlib

import numpy as np
import pytest

from diffsg_tpu.data import generators as jax_generators
from diffsg_tpu.data.native import co_oracle_native as jax_co_oracle_native
from diffsg_tpu_torch.data import ensure_datasets, generators
from diffsg_tpu_torch.data.datasets import EVAL_DATASETS, KNOWN_DATASETS
from diffsg_tpu_torch.data.native import co_oracle_native
from diffsg_tpu_torch.ops import nu_rate
from diffsg_tpu_torch.tools import make_datasets
from diffsg_tpu_torch.tools.train_nu_geo import augment_geo
from tools import make_datasets as jax_make_datasets
from tools.train_nu_geo import augment_geo as jax_augment_geo

import torch


def _co_features(data):
    """``[s, c, f_local, h, alpha]`` per node from the CO CSV layout."""
    raw = data[:, :18]
    return np.concatenate([raw[:, k::6] for k in range(5)], axis=1)


@pytest.mark.parametrize("legacy_sinr", [False, True])
def test_noma_uav_gen_matches_jax(legacy_sinr):
    got = generators.noma_uav_gen(4, P_sum=18.0, seed=3, grid_step=8, legacy_sinr=legacy_sinr)
    ref = jax_generators.noma_uav_gen(4, P_sum=18.0, seed=3, grid_step=8,
                                      legacy_sinr=legacy_sinr)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (4, 12) and np.isfinite(got).all()


@pytest.mark.parametrize("P_sum,step", [(18.0, 0.1), (30.0, 0.1), (9.0, 0.5)])
def test_nu_feasible_powers_match_jax(P_sum, step):
    got = generators.nu_feasible_powers(P_sum, step)
    np.testing.assert_array_equal(got, jax_generators.nu_feasible_powers(P_sum, step))
    # Triples that spend the budget.
    assert got.shape[1] == 3
    np.testing.assert_allclose(got.sum(axis=1), P_sum, rtol=1e-12)


def test_points_in_triangle_matches_jax():
    rng = np.random.default_rng(0)
    px, py = rng.uniform(0, 400, 500), rng.uniform(0, 400, 500)
    tri = rng.uniform(0, 400, 6)
    np.testing.assert_array_equal(generators._points_in_triangle(px, py, tri),
                                  jax_generators._points_in_triangle(px, py, tri))


def _nu_rows(n, seed):
    """NU rows ``[q, L, P, rate]`` from the NumPy oracle at a coarse grid."""
    return jax_generators.noma_uav_gen(n, P_sum=18.0, seed=seed, grid_step=16)


@pytest.mark.parametrize("times,seed,width,height", [(3, 0, 400, 400), (2, 5, 400, 400)])
def test_nu_dataset_extension_matches_jax(times, seed, width, height):
    """The augmenter draws per row with row-dependent bounds: the same
    rows in the same order, and the rate kept by the rigid motions."""
    src = _nu_rows(6, seed=1)
    got = generators.nu_dataset_extension(src, times=times, seed=seed, width=width,
                                          height=height)
    np.testing.assert_array_equal(got, jax_generators.nu_dataset_extension(
        src, times=times, seed=seed, width=width, height=height))
    assert got.shape == (6 * times, 12)
    np.testing.assert_array_equal(got[:, -1], np.tile(src[:, -1], times))
    rate = nu_rate(torch.tensor(got[:, 6:11], dtype=torch.float64),
                   torch.tensor(got[:, :6], dtype=torch.float64)).numpy()
    np.testing.assert_allclose(rate, got[:, -1], rtol=1e-3)
    assert (got[:, 0:8:2] >= -1.0).all() and (got[:, 0:8:2] <= width + 1.0).all()
    assert (got[:, 1:8:2] >= -1.0).all() and (got[:, 1:8:2] <= height + 1.0).all()


def test_rotate_point_matches_jax():
    for p, c, a in [((3.0, 4.0), (1.0, 1.0), 7), ((100.5, 20.0), (50.0, 60.0), -9)]:
        assert generators.rotate_point(p, c, a) == jax_generators.rotate_point(p, c, a)


def test_augment_geo_matches_jax():
    """Groups in W-then-H order, each seeded alike; every coordinate inside
    its row's own field (1 m of slack: a flip and rotation can push a
    boundary point a hair outside, in the JAX package too)."""
    rng = np.random.default_rng(2)
    n = 30
    raw = np.zeros((n, 15))
    raw[:, 13] = rng.choice([240.0, 520.0, 360.0], n)
    raw[:, 14] = rng.choice([200.0, 600.0], n)
    raw[:, 12] = rng.choice([12.0, 21.0], n)
    raw[:, 0:6:2] = rng.uniform(0.1, 0.6, (n, 3)) * raw[:, 13:14]
    raw[:, 1:6:2] = rng.uniform(0.1, 0.6, (n, 3)) * raw[:, 14:15]
    raw[:, 6] = raw[:, 0:6:2].mean(axis=1)
    raw[:, 7] = raw[:, 1:6:2].mean(axis=1)
    raw[:, 8:11] = 6.0
    raw[:, 11] = 1.0
    got = augment_geo(raw, times=3, seed=4)
    np.testing.assert_array_equal(got, jax_augment_geo(raw, times=3, seed=4))
    assert got.shape == (n * 3, 15)
    assert augment_geo(raw, times=0, seed=4).shape == (0, 15)
    assert (got[:, 0:8:2] <= got[:, 13:14] + 1.0).all()
    assert (got[:, 1:8:2] <= got[:, 14:15] + 1.0).all()
    assert (got[:, 0:8:2] >= -1.0).all() and (got[:, 1:8:2] >= -1.0).all()


@pytest.mark.parametrize("n,seed,batch", [(5, 0, 256), (300, 3, 128)])
def test_co_minlp_gen_7feature_matches_jax(n, seed, batch):
    X, Y = generators.co_minlp_gen_7feature(n, seed=seed, batch=batch)
    Xr, Yr = jax_generators.co_minlp_gen_7feature(n, seed=seed, batch=batch)
    np.testing.assert_array_equal(X, Xr)
    np.testing.assert_array_equal(Y, Yr)
    assert X.shape == (n, 27) and Y.shape == (n, 7)


def test_co_oracle_native_matches_jax_and_numpy():
    """The native CO oracle (built by g++, rows over threads) against the
    JAX package's native build (OpenMP) and its NumPy oracle's labels."""
    data, _ = jax_generators.co_minlp_gen(300, seed=7)
    np.testing.assert_array_equal(generators.co_minlp_gen(300, seed=7), data)
    feats = _co_features(data)
    got = co_oracle_native(feats)
    np.testing.assert_array_equal(got, jax_co_oracle_native(feats))
    np.testing.assert_array_equal(got[:, 0], data[:, 18])
    np.testing.assert_allclose(got[:, 1:], data[:, 19:22], rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        co_oracle_native(feats[:, :14])


# Every subcommand at a small size, with the flags that change its rows.
SUBCOMMANDS = {
    "co": ["co", "--samples", "300", "--seed", "3"],
    "co_step": ["co", "--samples", "40", "--step", "0.05", "--seed", "1"],
    "msr_lrh": ["msr", "--samples", "200", "--channels", "8", "--power", "10", "--seed", "1"],
    "msr_wf": ["msr", "--samples", "200", "--channels", "80", "--power", "20", "--labels",
               "wf"],
    "nu_native": ["nu", "--samples", "20", "--grid-step", "8", "--power", "21", "--width",
                  "480", "--height", "360"],
    "nu_native_legacy": ["nu", "--samples", "6", "--grid-step", "8", "--legacy-sinr"],
    "nu_numpy": ["nu", "--samples", "3", "--grid-step", "8", "--no-native", "--seed", "2"],
    "nu_numpy_legacy": ["nu", "--samples", "3", "--grid-step", "8", "--no-native",
                        "--legacy-sinr"],
    "nu_budget": ["nu-budget", "--samples", "100", "--grid-step", "8", "--budget-step", "3"],
    "nu_geo": ["nu-geo", "--samples", "100", "--grid-step", "8", "--geom-step", "80"],
    "nu_geo_focus": ["nu-geo", "--samples", "100", "--grid-step", "8", "--geom-step", "80",
                     "--focus-frac", "0.4", "--seed", "5"],
    "nu_geo_focus_step": ["nu-geo", "--samples", "100", "--grid-step", "8", "--geom-step",
                          "80", "--focus-frac", "0.5", "--focus-geom-step", "40"],
}


@pytest.mark.parametrize("name", sorted(SUBCOMMANDS))
def test_make_datasets_writes_jax_bytes(tmp_path, name):
    argv = SUBCOMMANDS[name]
    jax_make_datasets.main(argv + ["--out", str(tmp_path / "jax.csv")])
    out = make_datasets.main(argv + ["--out", str(tmp_path / "sub" / "port.csv")])
    assert out == tmp_path / "sub" / "port.csv"
    assert out.read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert [p.name for p in out.parent.iterdir()] == ["port.csv"]    # no temporary left


def test_known_datasets_are_jax_recipes():
    """Each keyword recipe is the JAX package's argv recipe, as the port's
    make_datasets parses it."""
    assert set(KNOWN_DATASETS) == set(jax_make_datasets.KNOWN_DATASETS)
    for name, argv in jax_make_datasets.KNOWN_DATASETS.items():
        kw = vars(make_datasets.parse_args(argv + ["--out", name]))
        kind, _ = kw.pop("task"), kw.pop("out")
        assert KNOWN_DATASETS[name] == (kind, kw), name
    assert set(EVAL_DATASETS) <= set(KNOWN_DATASETS)


@pytest.mark.parametrize("name", ["80c_40w_wf_2000samples_ood.csv",
                                  "8c_20w_wf_2000samples_ood.csv"])
def test_ensure_datasets_writes_the_msr_eval_sets(tmp_path, name):
    """The MSR waterfilling eval sets, remade as the JAX package's
    ensure_datasets makes them."""
    got = ensure_datasets([name], root=str(tmp_path / "port"))[name]
    jax_make_datasets.ensure_datasets([name], root=str(tmp_path / "jax"))
    assert got.read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # A file that exists is kept as it is.
    got.write_text("kept")
    assert ensure_datasets([name], root=str(tmp_path / "port"))[name].read_text() == "kept"

"""Column-wise normalizers and the legacy 7-feature CO dataset reader.

Counterpart of ``diffsg_tpu/data/normalize.py`` (the reference's
``utils/dataset.py:8-24, 53-86``), NumPy on the host, reading the CSV with
NumPy instead of pandas.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def min_max_norm(X: np.ndarray, lower: float = 0.0, upper: float = 1.0) -> np.ndarray:
    """Column-wise min-max into [lower, upper] (``dataset.py:8-15``)."""
    X_min, X_max = np.min(X, axis=0), np.max(X, axis=0)
    return lower + (upper - lower) * (X - X_min) / (X_max - X_min)


def mean_norm(X: np.ndarray) -> np.ndarray:
    """Column-wise standardization (``dataset.py:17-24``)."""
    return (X - np.mean(X, axis=0)) / np.std(X, axis=0)


def read_dataset_legacy(
    filepath: str,
    scaler_lower_bound: float = 0.1,
    scaler_upper_bound: float = 1.1,
    test_size: float = 0.2,
    seed: int = 0,
) -> Tuple[np.ndarray, ...]:
    """Legacy loader for the 7-feature CO format (``dataset.py:53-86``):
    column-wise min-max into [lower, upper], a seeded random split, and the
    label block split into a classification column + regression allocations.

    The reference reads the file with ``pd.read_csv(filepath)``, which takes
    the first line as a header: the first data row is dropped. Kept here
    (``skiprows=1``).

    Returns (X_train, X_test, Y_train_class, Y_train_reg, Y_test_class,
    Y_test_reg).
    """
    data = np.loadtxt(filepath, delimiter=",", dtype=np.float64, skiprows=1, ndmin=2)
    mu_num = (data.shape[1] - 1) // 7
    X = data[:, : -(mu_num + 1)]
    Y = np.atleast_2d(data[:, -(mu_num + 1):])

    X = min_max_norm(X, scaler_lower_bound, scaler_upper_bound)
    rng = np.random.default_rng(seed)
    order = rng.permutation(X.shape[0])
    n_test = int(round(X.shape[0] * test_size))
    test_idx, train_idx = order[:n_test], order[n_test:]

    Y_train, Y_test = Y[train_idx], Y[test_idx]
    return (
        X[train_idx], X[test_idx],
        np.atleast_2d(Y_train[:, 0]).T, Y_train[:, -mu_num:],
        np.atleast_2d(Y_test[:, 0]).T, Y_test[:, -mu_num:],
    )

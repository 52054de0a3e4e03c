"""CSV dataset loaders for the MSR / CO / NU tasks.

Counterpart of ``diffsg_tpu/data/loaders.py``, NumPy on the host, with the
same scaling, splits and configs. The headerless CSVs are read with
``np.loadtxt`` instead of pandas. NumPy rounds every decimal correctly;
pandas' default parser is off by one or two units in the last place on some
values (on ``datasets/3nodes_50000samples_new.csv``, 148,783 of its
1,100,000), so an array here may differ from the JAX package's in those
last bits.

Dataset-level parameters (W, P_sum) are arguments with a filename fallback
that also parses names like ``3u_30mW_1000samples_ood.csv``. Splits follow
the reference: first 70% train, last 30% test, no shuffling
(``classifier_free_MSR.py:163-164,182-183``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .preprocess import CO_COMMON_FEATURES, data_preprocess_co

TRAIN_RATIO, TEST_RATIO = 0.7, 0.3

#: Budget-feature normalizer of budget-conditioned NU models: the in-dist
#: training budget (18 mW), so the appended condition is 1.0 in-dist.
NU_P_REF = 18.0

#: The same for W-conditioned MSR models (in-dist budget 10 W).
MSR_W_REF = 10.0


@dataclass
class TaskData:
    """Loaded + scaled arrays and the task config needed to decode/score."""

    X_train: np.ndarray
    Y_train: np.ndarray
    X_test: np.ndarray
    Y_test: np.ndarray
    config: dict = field(default_factory=dict)
    R_test: Optional[np.ndarray] = None  # NU keeps the oracle rates column


def _read_csv(path: str) -> np.ndarray:
    """A headerless numeric CSV as a float64 (rows, columns) array."""
    return np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)


def _parse_filename_float(path: str, suffix: str) -> Optional[float]:
    """Extract the ``{value}{suffix}`` token from names like ``3c_10w_10000samples.csv``
    or ``3u_30mW_1000samples_ood.csv`` (case-insensitive, any position)."""
    for token in re.split(r"[_/]", path):
        m = re.fullmatch(r"(\d+(?:\.\d+)?)" + suffix, token, flags=re.IGNORECASE)
        if m:
            return float(m.group(1))
    return None


def _split(X: np.ndarray, Y: np.ndarray, n: int, cfg: dict, **extra) -> TaskData:
    """The reference's split: the first ``n * TRAIN_RATIO`` rows train, the
    last ``n * TEST_RATIO`` rows test; ``extra`` arrays take the test rows."""
    tr, te = int(n * TRAIN_RATIO), int(n * TEST_RATIO)
    return TaskData(X_train=X[:tr], Y_train=Y[:tr], X_test=X[-te:], Y_test=Y[-te:],
                    config=cfg, **{k: v[-te:] for k, v in extra.items()})


def _append_condition(td: TaskData, feat: np.ndarray) -> TaskData:
    """Append the (1, k) features ``feat`` to every condition row."""
    td.X_train = np.concatenate([td.X_train, np.repeat(feat, td.X_train.shape[0], axis=0)],
                                axis=1)
    td.X_test = np.concatenate([td.X_test, np.repeat(feat, td.X_test.shape[0], axis=0)], axis=1)
    return td


def load_msr(dataset_path: str, W: Optional[float] = None) -> TaskData:
    """MSR loader (``classifier_free_MSR.py:159-184``).

    CSV columns: ``[g_1..g_M, rate, p_1..p_M]`` (no header). X is the gain
    block, min-max scaled by the **global scalar** min/max of the whole
    matrix; Y is the power block (unscaled).
    """
    src = _read_csv(dataset_path)
    M = (src.shape[1] - 1) // 2
    if W is None:
        W = _parse_filename_float(dataset_path, "w")
        if W is None:
            raise ValueError(f"W not given and not parseable from {dataset_path!r}")
    X, Y = src[:, :M], src[:, -M:]
    scaler_min, scaler_max = float(np.min(X)), float(np.max(X))
    X = (X - scaler_min) / (scaler_max - scaler_min)
    cfg = {"M": M, "W": W, "sfn": 1, "cfn": 0, "cdim": 1,
           "scaler_min": scaler_min, "scaler_max": scaler_max}
    return _split(X, Y, src.shape[0], cfg)


def load_co(dataset_path: str, abnormal_threshold: float = 10.0) -> TaskData:
    """CO loader (``classifier_free_CO.py:158-200``).

    CSV columns: 6 raw features per node, then ``[D_1..D_N, R_1..R_N, cost]``
    -> X = raw block + appended physical constants -> derived 3-per-node
    features; rows with any derived feature >= 10.0 are dropped
    ("de-abnormal", ``:186-190``); global scalar min-max scaling.

    The reference's split quirk is kept: the split sizes come from the
    **pre-filter** row count (``:198-199``), so after filtering train and
    test overlap.
    """
    src = _read_csv(dataset_path)
    node_num = (src.shape[1] - 1) // 7
    X_raw, Y = src[:, : 6 * node_num], src[:, -node_num:]
    X = np.concatenate(
        [X_raw, np.tile(CO_COMMON_FEATURES[None, :], (X_raw.shape[0], 1))], axis=1)
    X = data_preprocess_co(X)

    keep = np.all(X < abnormal_threshold, axis=1)
    X, Y = X[keep], Y[keep]
    scaler_min, scaler_max = float(np.min(X)), float(np.max(X))
    X = (X - scaler_min) / (scaler_max - scaler_min)
    cfg = {"node_num": node_num, "sfn": 3, "cfn": 0, "cdim": 1,
           "scaler_min": scaler_min, "scaler_max": scaler_max}
    return _split(X, Y, src.shape[0], cfg)


def load_nu(dataset_path: str, width: float = 400.0, height: float = 400.0,
            P_sum: Optional[float] = None) -> TaskData:
    """NU loader (``classifier_free_NU.py:184-210``).

    CSV columns: ``[user coords x 2K, uav_x, uav_y, P_1..P_K, rate]``.
    Coordinates normalized by width/height, powers by P_sum.
    """
    src = _read_csv(dataset_path)
    K = (src.shape[1] - 3) // 3
    if P_sum is None:
        P_sum = _parse_filename_float(dataset_path, "mw")
        if P_sum is None:
            raise ValueError(f"P_sum not given and not parseable from {dataset_path!r}")
    X = src[:, : 2 * K].copy()
    Y = src[:, 2 * K : 2 + 3 * K].copy()
    X[:, 0::2] /= width
    X[:, 1::2] /= height
    Y[:, 0] /= width
    Y[:, 1] /= height
    Y[:, 2:] /= P_sum
    cfg = {"K": K, "P_sum": P_sum, "cdim": 1, "width": width, "height": height}
    return _split(X, Y, src.shape[0], cfg, R_test=src[:, -1])


def load_nu_geo(dataset_path: str, width: float = 400.0, height: float = 400.0,
                P_sum: Optional[float] = None, p_ref: float = NU_P_REF, w_ref: float = 400.0,
                h_ref: float = 400.0) -> TaskData:
    """NU loader for the budget- and geometry-conditioned ``nu_geo`` task:
    single-config 12-column CSVs with the condition extended by
    ``[P_sum / p_ref, width / w_ref, height / h_ref]``."""
    td = load_nu(dataset_path, width, height, P_sum)
    _append_condition(td, np.array([[td.config["P_sum"] / p_ref, width / w_ref,
                                     height / h_ref]]))
    td.config.update({"p_ref": p_ref, "w_ref": w_ref, "h_ref": h_ref})
    return td


def load_msr_budget(dataset_path: str, W: Optional[float] = None,
                    w_ref: float = MSR_W_REF) -> TaskData:
    """MSR loader for W-conditioned models (``msr_budget``): single-W CSVs
    with the condition extended by ``W / w_ref``."""
    td = load_msr(dataset_path, W)
    _append_condition(td, np.full((1, 1), td.config["W"] / w_ref))
    td.config["w_ref"] = w_ref
    return td


def load_nu_budget(dataset_path: str, width: float = 400.0, height: float = 400.0,
                   P_sum: Optional[float] = None, p_ref: float = NU_P_REF) -> TaskData:
    """NU loader for budget-conditioned models (``nu_budget``): the scaling
    of :func:`load_nu`, the condition extended by ``P_sum / p_ref``."""
    td = load_nu(dataset_path, width, height, P_sum)
    _append_condition(td, np.full((1, 1), td.config["P_sum"] / p_ref))
    td.config["p_ref"] = p_ref
    return td

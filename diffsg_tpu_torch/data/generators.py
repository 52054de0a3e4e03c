"""The oracle generators that remake the evaluation datasets, and the MSR
label generators.

The part of ``diffsg_tpu/data/generators.py`` that ``datasets/`` and the
MSR training sets need:
``datasets/`` is not committed (its ``.gitignore`` lists every file), so a
fresh checkout remakes the CSVs it reads, and the generation is
deterministic. The CO oracle (``co_minlp_gen``) is NumPy, a copy; the NU
labels come from the native grid-search oracle (``native/nu_oracle.cpp``,
bound in ``data/native.py``), the engine the JAX package's
``tools/make_datasets.py`` uses.

:func:`ensure_datasets` writes the four CSVs of ``EVAL_DATASETS`` with the
recipes of ``tools/make_datasets.py::KNOWN_DATASETS``, byte for byte the
files that tool writes from the same seeds. :func:`sum_rate_gen` (the
reference's LRH labels), :func:`msr_waterfilling_labels` (exact labels) and
:func:`write_msr_csv` make what ``tools/make_datasets.py msr`` writes.
"""

from __future__ import annotations

import pathlib
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

# CO physical constants (dataset_generate.py:159-165 == the loader's).
CO_F_T = 2.5e9
CO_KAPPA = 1e-28
CO_P_T = 0.3
CO_P_I = 0.1
CO_THETA = 1.0
CO_B = 10e5
CO_N0 = 7.96159e-13


def range_random(rng: np.random.Generator, mu, sigma, size, lower=None, upper=None):
    """Truncated normal by rejection resampling (``dataset_generate.py:5-24``)."""
    arr = rng.normal(mu, sigma, size)
    if lower is None or upper is None:
        return arr
    while np.any(arr < lower) or np.any(arr > upper):
        bad = (arr < lower) | (arr > upper)
        arr[bad] = rng.normal(mu, sigma, bad.sum())
    return arr


def resource_allocation_grid(D: np.ndarray, mode: str = "full", step: float = 0.05
                             ) -> np.ndarray:
    """All allocations over the offloaded nodes at the given grid step
    (``dataset_generate.py:26-48``), in the reference's enumeration order
    (digit j advances every len(choices)**j combinations)."""
    N = len(D)
    idx = np.where(D == 1)[0]
    choices = np.arange(step, 1 + step, step)
    k = len(idx)
    if k == 0:
        return np.zeros((1, N))
    n = len(choices) ** k
    arrays = np.zeros((n, N))
    for j, ix in enumerate(idx):
        arrays[:, ix] = choices[(np.arange(n) // (len(choices) ** j)) % len(choices)]
    s = arrays.sum(-1)
    if mode == "full":
        return arrays[np.abs(s - 1) < 10e-6]
    return arrays[s <= 1]


def _co_candidates(node_num: int, step: float) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every (decision, allocation) candidate, in the reference's order
    (decision id 0..2^N-1 outer, grid order inner): D (C, N) int, F (C, N)
    with 1e-5 on the nodes that compute locally, class id (C,)."""
    Ds, Fs, cls = [], [], []
    for did in range(2 ** node_num):
        D = np.array([(did >> j) & 1 for j in range(node_num)], dtype=int)
        grid = (np.zeros((1, node_num)) if did == 0
                else resource_allocation_grid(D, "full", step))
        F = np.where(D > 0, grid, 0.00001)
        Ds.append(np.tile(D, (grid.shape[0], 1)))
        Fs.append(F)
        class_id = int(sum(D[i] * 2 ** (node_num - 1 - i) for i in range(node_num)))
        cls.append(np.full(grid.shape[0], class_id, dtype=int))
    return np.concatenate(Ds), np.concatenate(Fs), np.concatenate(cls)


def co_minlp_gen(sample_num: int, node_num: int = 3, step: float = 0.02, seed: int = 0,
                 tolerable_overwrite: bool = False, batch: int = 512) -> np.ndarray:
    """Exhaustive CO oracle (CONV variant, ``dataset_generate.py:147-245``):
    all (decision, allocation) candidates of a batch of samples scored in
    one broadcast, the cheapest kept. Rows are ``[raw features (6N),
    decision_class, allocations (N)]``, the shipped CSV layout."""
    rng = np.random.default_rng(seed)
    D_all, F_all, cls_all = _co_candidates(node_num, step)

    rows = []
    for start in range(0, sample_num, batch):
        B = min(batch, sample_num - start)
        s = range_random(rng, 2.5e5, 5e4, (B, node_num), 0, 5e5).astype(int).astype(float)
        c = s * 3e3
        f_local = range_random(rng, 5.0e8, 2.0e8, (B, node_num), 0, 1e9).astype(int).astype(float)
        alpha = rng.random((B, node_num))
        beta = 1 - alpha
        h = rng.random((B, node_num))

        sinr = CO_P_T * h**2 / (CO_N0 + np.sum(CO_P_T * h**2, axis=1, keepdims=True))
        r_u = CO_B * np.log2(1 + sinr)
        cost_local = alpha * (c / f_local) + beta * (CO_KAPPA * f_local**2 * c)

        sF = s[:, None, :]
        cF = c[:, None, :]
        ruF = r_u[:, None, :]
        exec_term = cF / (CO_F_T * F_all[None, :, :])
        cost_off = (alpha[:, None, :] * (sF / ruF + exec_term)
                    + beta[:, None, :] * (CO_P_T * sF / ruF + CO_P_I * exec_term))
        total = np.sum((1 - D_all)[None] * cost_local[:, None, :]
                       + D_all[None] * cost_off, axis=2)  # (B, C)
        best = np.argmin(total, axis=1)

        if tolerable_overwrite:
            delays = np.where(D_all[None] > 0, sF / ruF + exec_term, (c / f_local)[:, None, :])
            sat = np.all(delays < CO_THETA, axis=2)
            has_tol = sat.any(axis=1)
            last_tol = sat.shape[1] - 1 - np.argmax(sat[:, ::-1], axis=1)
            best = np.where(has_tol, last_tol, best)

        F_best = np.where(D_all[best] > 0, F_all[best], 0.0)
        raw = np.zeros((B, 6 * node_num))
        raw[:, 0::6], raw[:, 1::6], raw[:, 2::6] = s, c, f_local
        raw[:, 3::6], raw[:, 4::6], raw[:, 5::6] = h, alpha, beta
        rows.append(np.concatenate([raw, cls_all[best][:, None].astype(float), F_best], axis=1))
    return np.concatenate(rows)


def nu_coordinates_gen(rng: np.random.Generator, sample_num: int, K: int = 3,
                       width: int = 400, height: int = 400) -> np.ndarray:
    """One user per random distinct quadrant (``noma_uav_gen.py:10-23``)."""
    qs = np.zeros((sample_num, 2 * K))
    for i in range(sample_num):
        blocks = rng.permutation(4)[:K]
        for j, b in enumerate(blocks):
            qs[i, 2 * j] = rng.integers(width // 2 * (b % 2) + 1,
                                        width // 2 * (1 + b % 2) + 1)
            qs[i, 2 * j + 1] = rng.integers(height // 2 * (b // 2) + 1,
                                            height // 2 * (1 + b // 2) + 1)
    return qs


# --- MSR: LRH gradient-descent label generator ----------------------------------


def _sum_rate_grad(gs, schemes):
    return gs / ((gs * schemes + 1.0) * np.log(2))


def _alpha_calc(grad: np.ndarray) -> np.ndarray:
    """Sum-preserving signed step direction (``dataset_generate.py:257-278``),
    vectorized: walk channels by descending |grad|; assign +-1 until the
    cumulative |grad| reaches half the total, give the pivot the balancing
    fraction, and flip the sign of everything after it."""
    g_abs = np.abs(grad)
    order = np.argsort(-g_abs, axis=1, kind="stable")
    g_sorted = np.take_along_axis(g_abs, order, axis=1)
    sign_sorted = np.where(np.take_along_axis(grad, order, axis=1) > 0, 1.0, -1.0)

    total = g_sorted.sum(axis=1, keepdims=True)
    cum_incl = np.cumsum(g_sorted, axis=1)
    cum_before = cum_incl - g_sorted
    is_pivot_region = cum_incl >= total / 2
    pivot_idx = np.argmax(is_pivot_region, axis=1)[:, None]
    pos = np.arange(grad.shape[1])[None, :]

    alpha_sorted = np.where(pos < pivot_idx, sign_sorted, 0.0)
    pivot_val = (total - g_sorted - 2 * cum_before) / g_sorted * sign_sorted
    alpha_sorted = np.where(pos == pivot_idx, pivot_val, alpha_sorted)
    alpha_sorted = np.where(pos > pivot_idx, -sign_sorted, alpha_sorted)

    alpha = np.zeros_like(grad)
    np.put_along_axis(alpha, order, alpha_sorted, axis=1)
    return alpha


def sum_rate_gen(sample_num: int, M: int = 3, g_range=(0.5, 2.5), W: float = 10.0,
                 seed: int = 0):
    """MSR label generator (``dataset_generate.py:280-313``): sum-preserving
    LRH gradient ascent, 150 iters max, step 0.1 halved every 20 iters.

    Returns (gs (n, M), rates (n,), schemes (n, M)); CSV layout for
    :func:`write_msr_csv` is ``[g..., rate, p...]``.
    """
    rng = np.random.default_rng(seed)
    schemes = np.ones((sample_num, M)) * (W / M)
    gs = rng.uniform(g_range[0], g_range[1], size=(sample_num, M))

    eps, beta, k = 0.001, 0.1, 1
    grad = _sum_rate_grad(gs, schemes)
    while np.any(np.average(np.abs(grad), axis=1) > eps):
        grad = _sum_rate_grad(gs, schemes)
        schemes = schemes + beta * _alpha_calc(grad) * grad
        k += 1
        if k % 20 == 0:
            beta *= 0.5
        if k == 150:
            break
    rates = np.sum(np.log2(1.0 + schemes * gs), axis=1)
    return gs, rates, schemes


def msr_waterfilling_labels(gs: np.ndarray, W: float):
    """Exact feasible MSR labels by NumPy waterfilling (the twin of
    ``baselines/waterfilling.py``). Returns (rates (n,), schemes (n, M))
    with schemes >= 0 and sum W."""
    inv = 1.0 / gs
    inv_sorted = np.sort(inv, axis=1)
    csum = np.cumsum(inv_sorted, axis=1)
    k = np.arange(1, gs.shape[1] + 1, dtype=gs.dtype)[None, :]
    mu_k = (W + csum) / k
    valid = mu_k > inv_sorted
    k_star = valid.sum(axis=1) - 1
    mu = np.take_along_axis(mu_k, k_star[:, None], axis=1)
    schemes = np.maximum(mu - inv, 0.0)
    rates = np.sum(np.log2(1.0 + schemes * gs), axis=1)
    return rates, schemes


def write_msr_csv(path: str, gs, rates, schemes) -> None:
    np.savetxt(path, np.concatenate([gs, rates[:, None], schemes], axis=1),
               delimiter=",")


#: The evaluation CSVs and their recipes (``tools/make_datasets.py``):
#: ("co", samples, seed) or ("nu", samples, P_sum mW, width, height, seed,
#: grid step).
EVAL_DATASETS: Dict[str, tuple] = {
    "3nodes_50000samples_new.csv": ("co", 50000, 0),
    "3u_geo600x600_33mW_500samples.csv": ("nu", 500, 33.0, 600.0, 600.0, 11, 3.0),
    "3u_geo200x200_12mW_500samples.csv": ("nu", 500, 12.0, 200.0, 200.0, 12, 1.0),
    "3u_geo480x360_21mW_1000samples.csv": ("nu", 1000, 21.0, 480.0, 360.0, 7, 2.0),
}


def make_dataset(name: str) -> np.ndarray:
    """The rows of ``EVAL_DATASETS[name]``."""
    recipe = EVAL_DATASETS[name]
    if recipe[0] == "co":
        return co_minlp_gen(recipe[1], seed=recipe[2])
    from .native import nu_oracle_native

    _, n, P_sum, width, height, seed, grid_step = recipe
    qs = nu_coordinates_gen(np.random.default_rng(seed), n, width=int(width),
                            height=int(height))
    sol = nu_oracle_native(qs, P_sum=P_sum, grid_step=grid_step, width=width, height=height)
    return np.concatenate([qs, sol], axis=1)


def ensure_datasets(names: Optional[Iterable[str]] = None,
                    root: Optional[str] = None) -> Dict[str, pathlib.Path]:
    """Write each missing CSV of ``names`` (default: all of
    ``EVAL_DATASETS``) under ``root`` (default: the repository's
    ``datasets/``); return every path."""
    root_dir = pathlib.Path(root) if root else (
        pathlib.Path(__file__).resolve().parent.parent.parent / "datasets")
    paths = {}
    for name in (names or EVAL_DATASETS):
        out = paths[name] = root_dir / name
        if not out.exists():
            root_dir.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(out.name + ".tmp")
            np.savetxt(tmp, make_dataset(name), delimiter=",")
            tmp.replace(out)
    return paths

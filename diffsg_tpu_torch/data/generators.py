"""The oracle dataset generators: CO, MSR and NU, and the NU augmenter.

Counterpart of ``diffsg_tpu/data/generators.py``, copied into the port:
the CO oracles (``co_minlp_gen``, the 7-feature ``co_minlp_gen_7feature``),
the MSR label generators (``sum_rate_gen``, the reference's LRH labels;
``msr_waterfilling_labels``, exact labels; ``write_msr_csv``), the NumPy NU
grid-search oracle (``noma_uav_gen``; the native one is ``data/native.py``)
and the rigid-motion NU augmenter (``nu_dataset_extension``). Each draws
from ``np.random.default_rng(seed)`` in the JAX package's order, so the
same seed gives the same rows bit for bit. The dataset recipes built on
them are ``data/datasets.py``.
"""

from __future__ import annotations

from typing import Tuple

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


def co_minlp_gen_7feature(sample_num: int, node_num: int = 3, step: float = 0.05,
                          seed: int = 0, batch: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """The older 7-feature CO oracle (``dataset_generate.py:50-145``).

    Against the CONV variant: F_t = 7.5e9, a per-node download size w and
    tolerable delay theta, down-link costs, 'part' allocations (sum <= 1) at
    step 0.05, decision ids 0..2^N-2, and the tolerable-delay overwrite on.
    Returns (X (n, 7N+6), Y (n, 2N+1) = [D, F, cost]), the reference's
    layout.
    """
    rng = np.random.default_rng(seed)
    F_t, B = 7.5e9, 10e5

    Ds, Fs = [], []
    for did in range(2 ** node_num - 1):
        D = np.array([(did >> j) & 1 for j in range(node_num)], dtype=int)
        grid = resource_allocation_grid(D, "part", step) if did else np.zeros((1, node_num))
        F = np.where(D > 0, grid, 0.1)
        Ds.append(np.tile(D, (grid.shape[0], 1)))
        Fs.append(F)
    D_all, F_all = np.concatenate(Ds), np.concatenate(Fs)

    X_rows, Y_rows = [], []
    for start in range(0, sample_num, batch):
        Bn = min(batch, sample_num - start)
        s = range_random(rng, 1e5, 4e4, (Bn, node_num), 1e4, 2.5e5).astype(int).astype(float)
        c = s * 3e3
        w = range_random(rng, 1e5, 4e4, (Bn, node_num), 1e4, 2.5e5).astype(int).astype(float)
        theta = range_random(rng, 0.8, 0.15, (Bn, node_num), 0.01, 1.0)
        f_local = range_random(rng, 8e8, 4e8, (Bn, node_num), 0, 1.5e9).astype(int).astype(float)
        alpha = rng.random((Bn, node_num))
        beta = 1 - alpha
        h = rng.random((Bn, node_num))

        sinr = CO_P_T * h**2 / (CO_N0 + np.sum(CO_P_T * h**2, axis=1, keepdims=True))
        r_u = B * np.log2(1 + sinr)
        cost_local = alpha * (c / f_local) + beta * (CO_KAPPA * f_local**2 * c)

        exec_term = c[:, None, :] / (F_t * F_all[None])
        updown = (s + w)[:, None, :] / r_u[:, None, :]
        cost_off = (alpha[:, None, :] * (updown + exec_term)
                    + beta[:, None, :] * (CO_P_T * updown + CO_P_I * exec_term))
        total = np.sum((1 - D_all)[None] * cost_local[:, None, :]
                       + D_all[None] * cost_off, axis=2)
        # The offload delay includes the downlink w / r_d (r_d == r_u),
        # as dataset_generate.py:113,117.
        delays = np.where(D_all[None] > 0, updown + exec_term, (c / f_local)[:, None, :])
        sat = np.all(delays < theta[:, None, :], axis=2)

        best = np.argmin(total, axis=1)
        has_tol = sat.any(axis=1)
        last_tol = sat.shape[1] - 1 - np.argmax(sat[:, ::-1], axis=1)
        pick = np.where(has_tol, last_tol, best)

        F_pick = np.where(D_all[pick] > 0, F_all[pick], 0.0)
        cost_pick = total[np.arange(Bn), pick]

        X = np.zeros((Bn, 7 * node_num + 6))
        for n in range(node_num):
            X[:, 7 * n: 7 * n + 7] = np.stack(
                [s[:, n], c[:, n], w[:, n], theta[:, n], f_local[:, n], h[:, n], alpha[:, n]],
                axis=1)
        X[:, -6:] = [F_t, CO_KAPPA, CO_P_T, CO_P_I, B, CO_N0]
        X_rows.append(X)
        Y_rows.append(np.concatenate([D_all[pick].astype(float), F_pick, cost_pick[:, None]],
                                     axis=1))
    return np.concatenate(X_rows), np.concatenate(Y_rows)


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


# --- NU: the NumPy grid-search oracle and the rigid-motion augmenter ---------------

NU_SIGMA_SQ = 110.0
NU_RHO_0 = 60.0
NU_UAV_H = 150.0


def nu_feasible_powers(P_sum: float, step: float = 0.1) -> np.ndarray:
    """Power triples (ascending) in the SIC order (``noma_uav_gen.py:26-44``):
    columns [smallest, middle, largest]."""
    sols = []
    for i in np.arange(P_sum / 3 + step, P_sum - 2 * step, step):
        for j in np.arange((P_sum - i) / 2 + step, P_sum - i - step, step):
            sols.append([P_sum - i - j, j, i])
    return np.array(sols)


def _points_in_triangle(px, py, tri):
    """Point-in-triangle over arrays of points (``noma_uav_gen.py:47-61``)."""
    ax, ay, bx, by, cx, cy = tri
    d1 = (px - bx) * (ay - by) - (ax - bx) * (py - by)
    d2 = (px - cx) * (by - cy) - (bx - cx) * (py - cy)
    d3 = (px - ax) * (cy - ay) - (cx - ax) * (py - ay)
    has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(has_neg & has_pos)


def noma_uav_gen(sample_num: int, P_sum: float = 18.0, seed: int = 0, K: int = 3,
                 width: int = 400, height: int = 400, grid_step: float = 1,
                 point_chunk: int = 2048, legacy_sinr: bool = False) -> np.ndarray:
    """The NU oracle (``noma_uav_gen.py:64-116``) in NumPy: per sample, every
    grid point inside the users' triangle against every SIC-feasible power
    triple (the strongest channel takes the smallest power), the best kept.
    Rows are ``[q (2K), L (2), P (K), rate]``, the rate in bits.

    ``legacy_sinr=True`` keeps the reference generator's interference term,
    ``position * P_sum`` (``noma_uav_gen.py:102`` indexes solution rows with
    user indices); the default sums the stronger users' powers. The points
    go through the (points x solutions) product ``point_chunk`` at a time.
    """
    rng = np.random.default_rng(seed)
    fs = nu_feasible_powers(P_sum)  # (S, K) ascending: column 0 the smallest
    qs = nu_coordinates_gen(rng, sample_num, K, width, height)

    xs = np.arange(0, width + grid_step, grid_step, dtype=float)
    ys = np.arange(0, height + grid_step, grid_step, dtype=float)
    PX, PY = np.meshgrid(xs, ys)
    PX, PY = PX.ravel(), PY.ravel()

    data = np.zeros((sample_num, 2 * K + 2 + K + 1))
    for i in range(sample_num):
        tri = qs[i]
        inside = _points_in_triangle(PX, PY, tri)
        px, py = PX[inside], PY[inside]
        if px.size == 0:
            # A triangle thinner than the grid step holds no grid point: its
            # centroid, as native/nu_oracle.cpp takes.
            px = np.array([tri[0::2].mean()])
            py = np.array([tri[1::2].mean()])
        best_rate, best = -np.inf, None
        P_pos = fs  # SIC position j takes column j
        if legacy_sinr:
            interference = (np.arange(K)[None, :] * P_sum) * np.ones((fs.shape[0], 1))
        else:
            interference = np.cumsum(P_pos, axis=1) - P_pos  # exclusive prefix
        for s0 in range(0, px.size, point_chunk):
            cx, cy = px[s0: s0 + point_chunk], py[s0: s0 + point_chunk]
            d2 = (cx[:, None] - tri[0::2][None]) ** 2 + (cy[:, None] - tri[1::2][None]) ** 2
            h = np.sqrt(NU_RHO_0 / (NU_UAV_H**2 + d2))  # (P, K)
            order = np.argsort(-h, axis=1)  # SIC order, strongest first
            h_sorted = np.take_along_axis(h, order, axis=1)
            sinr0 = P_pos[None, :, 0] * h_sorted[:, None, 0] ** 2 / NU_SIGMA_SQ
            sinr_rest = P_pos[None, :, 1:] / (
                interference[None, :, 1:] + NU_SIGMA_SQ / h_sorted[:, None, 1:] ** 2)
            rates = np.log2(1 + sinr0) + np.log2(1 + sinr_rest).sum(axis=2)  # (P, S)
            flat = np.argmax(rates)
            p_i, s_i = np.unravel_index(flat, rates.shape)
            if rates[p_i, s_i] > best_rate:
                P_users = np.empty(K)
                P_users[order[p_i]] = P_pos[s_i]     # back to the users' order
                best_rate = rates[p_i, s_i]
                best = np.concatenate([[cx[p_i], cy[p_i]], P_users, [best_rate]])
        data[i, : 2 * K] = tri
        data[i, 2 * K:] = best
    return data


def rotate_point(point, center, angle_degrees):
    a = np.radians(angle_degrees)
    x, y = point
    cx, cy = center
    return (np.cos(a) * (x - cx) - np.sin(a) * (y - cy) + cx,
            np.sin(a) * (x - cx) + np.cos(a) * (y - cy) + cy)


def nu_dataset_extension(src_data: np.ndarray, times: int = 3, seed: int = 0,
                         width: int = 400, height: int = 400,
                         rotation_upper: int = 10) -> np.ndarray:
    """``times`` augmented copies of NU rows, each row translated or flipped
    and rotated about its centroid (``noma_uav_gen.py:131-170``). The rate
    is invariant under these rigid motions, so the label columns ride
    along. One generator draws row by row, copy by copy, as the JAX
    package's draws."""
    rng = np.random.default_rng(seed)
    n, cols = src_data.shape
    out = np.zeros((n * times, cols))
    xi, yi = [0, 2, 4, 6], [1, 3, 5, 7]
    for t in range(times):
        for j in range(n):
            row = src_data[j].copy()
            k = t * n + j
            if rng.integers(2) == 0:  # translate
                x_min, x_max = row[xi[:3]].min(), row[xi[:3]].max()
                y_min, y_max = row[yi[:3]].min(), row[yi[:3]].max()
                # Rotated rows have fractional coordinates: the range is
                # floored as the reference's np.random.randint floors it,
                # and a range below 1 (where the reference raises) moves 0.
                hi_x, hi_y = int(width - x_max), int(height - y_max)
                dx = (rng.integers(hi_x) if hi_x >= 1 else 0) - x_min
                dy = (rng.integers(hi_y) if hi_y >= 1 else 0) - y_min
                row[xi] += dx
                row[yi] += dy
            else:  # flip, then a small rotation about the centroid
                row[xi] = width - row[xi]
                row[yi] = height - row[yi]
                tri = row[[0, 1, 2, 3, 4, 5]].reshape(3, 2)
                centroid = tri.mean(axis=0)
                ang = rng.integers(-rotation_upper, rotation_upper)
                for p in range(3):
                    row[2 * p], row[2 * p + 1] = rotate_point(tri[p], centroid, ang)
                row[6], row[7] = rotate_point((row[6], row[7]), centroid, ang)
            out[k] = row
    return out


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


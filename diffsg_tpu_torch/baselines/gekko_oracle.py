"""GEKKO offline oracle, with an executable SciPy backend.

Counterpart of ``diffsg_tpu/baselines/gekko_oracle.py``, copied: it is
NumPy and SciPy on the host, and no device is involved. The GEKKO
comparator is a per-sample MINLP/NLP solve (~9 s a sample on the authors'
machine, ``baselines/GEKKO.py:192-201``) whose published numbers are the
optimality reference (``PUBLISHED``):

  CO  exceeded ratio 1.005359 @ 8.96 s/sample   (APOPT MINLP)
  MSR-3c less ratio 1.0000000003 @ 8.63 s/sample (IPOPT NLP)
  MSR-8c less ratio 1.0037998 @ 25.02 s/sample
  NU  less ratio 0.485004 @ 9.59 s/sample        (IPOPT + SIC ordering)

The ``*_solve_one`` functions mirror the reference solver settings (APOPT
branch options for CO, ma97 for the NLPs) and need the optional ``gekko``
package; without it they raise ImportError. The ``*_solve_scipy`` twins
solve the SAME formulations with ``scipy.optimize`` (imported when called):

  MSR: SLSQP on the sum-rate NLP (the exact optimum is waterfilling's).
  CO: the exact MINLP, enumerating the 2^N binary decisions with the
      closed-form continuous subproblem (s_i proportional to sqrt(exec_i)).
  NU: multistart SLSQP over the 6 SIC power orderings (the smooth
      equivalent of the reference's ``m.if2`` interference switch).

A reference quirk is kept: ``GEKKO.py:160`` feeds loader-NORMALIZED user
coordinates (0..1) into a formulation whose UAV box is [-200, 600] and
whose channel model expects metres; the published NU less ratio of 0.485
is this mis-scaling, not a solver failure. ``nu_solve_scipy`` on coordinates
in metres reaches ~1.0 of the oracle labels, on normalized ones ~0.5.
"""

from __future__ import annotations

import numpy as np

PUBLISHED = {
    "co": {"exceeded_ratio": 1.005359, "sec_per_sample": 8.96},
    "msr_3c": {"less_ratio": 1.0000000003, "sec_per_sample": 8.63},
    "msr_8c": {"less_ratio": 1.0037998, "sec_per_sample": 25.02},
    "nu": {"less_ratio": 0.485004, "sec_per_sample": 9.59},
}


def _require_gekko():
    try:
        from gekko import GEKKO  # noqa: F401

        return GEKKO
    except ImportError as e:  # pragma: no cover - environment dependent
        raise ImportError(
            "The GEKKO oracle needs the optional 'gekko' package "
            "(pip install gekko). Published oracle numbers are available "
            "as diffsg_tpu_torch.baselines.gekko_oracle.PUBLISHED."
        ) from e


def co_solve_one(x: np.ndarray) -> np.ndarray:
    """MINLP: binary offload decisions + continuous shares for one sample.

    x: (9,) derived CO features for 3 nodes. Returns (3,) allocation shares
    (share * decision, like the reference ``GEKKO.py:14-40``).
    """
    GEKKO = _require_gekko()
    m = GEKKO(remote=False)
    m.options.SOLVER = 1  # APOPT MINLP
    m.solver_options = [
        "minlp_maximum_iterations 500",
        "minlp_max_iter_with_int_sol 10",
        "minlp_as_nlp 0",
        "nlp_maximum_iterations 50",
        "minlp_branch_method 1",
        "minlp_integer_tol 0.05",
        "minlp_gap_tol 0.01",
    ]
    shares = [m.Var(value=v, lb=0, ub=1) for v in (0.3, 0.35, 0.35)]
    decisions = [m.Var(value=0, lb=0, ub=1, integer=True) for _ in range(3)]
    m.Equation(sum(s * d for s, d in zip(shares, decisions)) <= 1)
    cost = 0
    for i, (s, d) in enumerate(zip(shares, decisions)):
        local, trans, execu = x[3 * i], x[3 * i + 1], x[3 * i + 2]
        cost = cost + (1 - d) * local + d * (trans + execu / s)
    m.Obj(cost)
    m.solve(disp=False)
    return np.array([float(s.VALUE[0]) * float(d.VALUE[0])
                     for s, d in zip(shares, decisions)])


def msr_solve_one(g: np.ndarray, W: float) -> np.ndarray:
    """NLP: maximize sum rate subject to sum(p) == W (``GEKKO.py:81-96``)."""
    GEKKO = _require_gekko()
    M = len(g)
    m = GEKKO(remote=False)
    m.options.SOLVER = 3  # IPOPT
    m.solver_options = ["linear_solver ma97"]
    ps = [m.Var(value=W / M, lb=0.01, ub=W - (M - 1) * 0.01) for _ in range(M)]
    m.Equation(m.sum(ps) == W)
    m.Obj(-m.sum([m.log(1 + g[i] * ps[i]) / np.log(2) for i in range(M)]))
    m.solve(disp=False)
    return np.array([float(p.VALUE[0]) for p in ps])


def nu_solve_one(coords: np.ndarray, P_sum: float = 18.0) -> np.ndarray:
    """NLP with SIC ordering constraints for K=3 (``GEKKO.py:126-148``)."""
    GEKKO = _require_gekko()
    x1, y1, x2, y2, x3, y3 = coords
    m = GEKKO(remote=False)
    m.options.SOLVER = 3
    m.solver_options = ["linear_solver ma97"]
    u1 = m.Var(value=200, lb=-200, ub=600)
    u2 = m.Var(value=200, lb=-200, ub=600)
    p = [m.Var(value=P_sum / 3, lb=0.1, ub=P_sum - 0.2) for _ in range(3)]
    h = [
        m.sqrt(60 / (22500 + (u1 - xx) ** 2 + (u2 - yy) ** 2))
        for xx, yy in ((x1, y1), (x2, y2), (x3, y3))
    ]
    # SIC: user i is interfered by users with larger power (weaker channel)
    sinr = []
    for i in range(3):
        interf = sum(m.if2(p[j] - p[i], 1, 0) * p[j] for j in range(3) if j != i)
        sinr.append(p[i] / (interf + 110 / (h[i] ** 2)))
    m.Equation(sum(p) == P_sum)
    m.Equation((h[0] - h[1]) * (p[1] - p[0]) >= 0)
    m.Equation((h[0] - h[2]) * (p[2] - p[0]) >= 0)
    m.Equation((h[2] - h[1]) * (p[1] - p[2]) >= 0)
    m.Obj(-sum(m.log(1 + s) / np.log(2) for s in sinr))
    m.solve(disp=False)
    return np.array([u1.VALUE[0], u2.VALUE[0]] + [pp.VALUE[0] for pp in p],
                    dtype=float)


# ---------------------------------------------------------------------------
# Executable backend: scipy.optimize solves of the same formulations.
# ---------------------------------------------------------------------------

def msr_solve_scipy(g: np.ndarray, W: float) -> np.ndarray:
    """SLSQP solve of the MSR NLP (same bounds/start as ``msr_solve_one``)."""
    from scipy.optimize import minimize

    g = np.asarray(g, float)
    M = len(g)
    ln2 = np.log(2.0)

    def neg_rate(p):
        return -np.sum(np.log1p(g * p)) / ln2

    def grad(p):
        return -(g / (1.0 + g * p)) / ln2

    res = minimize(
        neg_rate, np.full(M, W / M), jac=grad, method="SLSQP",
        bounds=[(0.01, W - (M - 1) * 0.01)] * M,
        constraints=[{"type": "eq", "fun": lambda p: np.sum(p) - W,
                      "jac": lambda p: np.ones(M)}],
        options={"maxiter": 500, "ftol": 1e-14},
    )
    return res.x


def co_solve_scipy(x: np.ndarray) -> np.ndarray:
    """Exact CO MINLP: enumerate the 2^N binary decisions; each continuous
    subproblem (min sum_offloaded exec_i/s_i s.t. sum s <= 1) has the
    closed-form KKT optimum s_i = sqrt(exec_i)/sum_j sqrt(exec_j).

    Returns shares*decisions like the reference (``GEKKO.py:37-40``).
    """
    x = np.asarray(x, float)
    N = len(x) // 3
    local, trans, execu = x[0::3], x[1::3], x[2::3]
    best_cost, best_y = np.sum(local), np.zeros(N)
    for bits in range(1, 2 ** N):
        d = np.array([(bits >> k) & 1 for k in range(N)], float)
        w = np.sqrt(execu) * d
        s = w / w.sum()
        cost = np.sum((1 - d) * local
                      + d * (trans + execu / np.maximum(s, 1e-30)))
        if cost < best_cost:
            best_cost, best_y = cost, s * d
    return best_y


def _nu_neg_rate_factory(coords: np.ndarray, order: np.ndarray):
    """Smooth NU objective for a fixed SIC power ordering.

    ``order`` lists user indices by DESCENDING power; user order[k] is
    interfered by the (smaller) powers of order[k+1:], the smooth version of
    the reference's ``m.if2(p_j - p_i, 1, 0)`` switch (``GEKKO.py:138-140``).
    Channel model: h_i^2 = 60 / (22500 + ||u - x_i||^2), noise-over-gain
    term 110 / h_i^2 (``GEKKO.py:135-140``; ops/objectives.nu_rate).
    """
    users = np.asarray(coords, float).reshape(-1, 2)
    K = users.shape[0]
    ln2 = np.log(2.0)

    def neg_rate(v):
        u, p = v[:2], v[2:]
        d2 = np.sum((u[None, :] - users) ** 2, axis=1)
        noise = 110.0 * (22500.0 + d2) / 60.0        # 110 / h^2
        rate = 0.0
        for k, i in enumerate(order):
            interf = np.sum(p[order[k + 1:]]) if k + 1 < K else 0.0
            rate += np.log1p(p[i] / (interf + noise[i])) / ln2
        return -rate

    return neg_rate


def nu_solve_scipy(coords: np.ndarray, P_sum: float = 18.0,
                   seed: int = 0, n_starts: int = 4) -> np.ndarray:
    """Multistart SLSQP over the 6 SIC orderings (K=3).

    coords must be in PHYSICAL meters for a correct solve; feeding loader-
    normalized 0..1 coordinates reproduces the reference's published 0.485
    behavior (see module docstring).  Returns (u1, u2, p1, p2, p3).
    """
    from itertools import permutations

    from scipy.optimize import minimize

    users = np.asarray(coords, float).reshape(-1, 2)
    K = users.shape[0]
    rng = np.random.default_rng(seed)
    starts = [users.mean(0)] + [u for u in users]
    starts += [rng.uniform(users.min(), users.max(), 2)
               for _ in range(max(0, n_starts - len(starts)))]

    lo, hi = 0.1, P_sum - 0.2
    best_val, best_v = np.inf, None
    for order in permutations(range(K)):
        order = np.array(order)
        neg_rate = _nu_neg_rate_factory(coords, order)
        # power start consistent with the ordering (descending over `order`)
        p0 = np.empty(K)
        p0[order] = np.linspace(1.5, 0.5, K) * (P_sum / K)
        cons = [{"type": "eq", "fun": lambda v: np.sum(v[2:]) - P_sum}]
        # enforce the assumed ordering: p[order[k]] >= p[order[k+1]]
        for k in range(K - 1):
            cons.append({"type": "ineq",
                         "fun": (lambda v, a=order[k], b=order[k + 1]:
                                 v[2 + a] - v[2 + b])})
        # SIC feasibility: stronger channel (closer user) gets less power,
        # i.e. the reference's (h_i - h_j)(p_j - p_i) >= 0 constraints
        for i in range(K):
            for j in range(i + 1, K):
                def sic(v, i=i, j=j):
                    d2i = np.sum((v[:2] - users[i]) ** 2)
                    d2j = np.sum((v[:2] - users[j]) ** 2)
                    # h_i > h_j  <=>  d2i < d2j ; require p_i <= p_j then
                    return (d2j - d2i) * (v[2 + j] - v[2 + i])
                cons.append({"type": "ineq", "fun": sic})
        for u0 in starts:
            v0 = np.concatenate([u0, p0])
            res = minimize(
                neg_rate, v0, method="SLSQP",
                bounds=[(-200.0, 600.0)] * 2 + [(lo, hi)] * K,
                constraints=cons, options={"maxiter": 300, "ftol": 1e-12},
            )
            if res.success and res.fun < best_val:
                best_val, best_v = res.fun, res.x
    if best_v is None:
        raise RuntimeError("nu_solve_scipy: no SLSQP start converged")
    return best_v

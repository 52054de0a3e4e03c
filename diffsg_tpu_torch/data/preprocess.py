"""CO feature engineering: raw physics features -> 3 derived costs per node.

Counterpart of ``diffsg_tpu/data/preprocess.py``, a copy: NumPy, on the
host, of the reference feature engine (``utils/dataset.py:26-51``). Input
layout per node (6 features): ``[s, c, f_local, h, alpha, beta]``,
followed by 7 common physical constants ``[F_t, kappa, P_t, P_I, theta, B,
N0]`` appended by the loader (``classifier_free_CO.py:174-182``).

Output per node (3 features): ``[local_cost, offload_transition_cost,
ideal_offload_execution_cost]``.
"""

from __future__ import annotations

import numpy as np

# Common physical constants of the shipped CO dataset
# (classifier_free_CO.py:174-181; datasets/3nodes_50000samples_new.yaml).
CO_COMMON_FEATURES = np.array(
    [2.5e9, 1e-28, 0.3, 0.1, 1.0, 10e5, 7.96159e-13], dtype=float
)  # [F_t, kappa, P_t, P_I, theta, B, N0]


def data_preprocess_co(X: np.ndarray) -> np.ndarray:
    """Simplify the CO dataset (``utils/dataset.py:26-51``).

    X: (n, 6*node_num + 7). Returns (n, 3*node_num).
    """
    X = np.asarray(X, dtype=float)
    node_num = (X.shape[1] - 7) // 6
    F_t, kappa, P_t, P_I = X[:, -7], X[:, -6], X[:, -5], X[:, -4]
    B, N0 = X[:, -2], X[:, -1]

    s = X[:, 0 : 6 * node_num : 6]
    c = X[:, 1 : 6 * node_num : 6]
    f_local = X[:, 2 : 6 * node_num : 6]
    h = X[:, 3 : 6 * node_num : 6]
    alpha = X[:, 4 : 6 * node_num : 6]

    # uplink rate from SINR; note the reference's interference term includes
    # the node's own signal (sum over all nodes), reproduced as-is.
    sum_P_t_h = np.sum(P_t[:, None] * h**2, axis=1)
    sinr = P_t[:, None] * h**2 / (N0 + sum_P_t_h)[:, None]
    r_u = B[:, None] * np.log2(1.0 + sinr)

    local = alpha * c / f_local + (1.0 - alpha) * kappa[:, None] * f_local**2 * c
    transition = alpha * s / r_u + (1.0 - alpha) * P_t[:, None] * s / r_u
    execution = alpha * c / F_t[:, None] + (1.0 - alpha) * P_I[:, None] * c / F_t[:, None]

    out = np.empty((X.shape[0], 3 * node_num), dtype=float)
    out[:, 0::3] = local
    out[:, 1::3] = transition
    out[:, 2::3] = execution
    return out

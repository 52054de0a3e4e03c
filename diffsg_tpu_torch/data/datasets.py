"""The recipes of the DiffSG dataset CSVs, and the W-conditioned MSR rows.

Counterpart of the row making in the JAX package's
``tools/make_datasets.py``: one function per subcommand (``co``, ``msr``,
``nu``, ``nu-budget``, ``nu-geo``) taking its flags as keywords, with its
defaults; :func:`make_rows` dispatches on the subcommand's name.
``KNOWN_DATASETS`` holds that tool's 13 recipes as keywords, and
:func:`ensure_datasets` writes the missing ones byte for byte as that tool
writes them. ``tools/make_datasets.py`` is the command line over these.

``datasets/`` is not committed (its ``.gitignore`` lists every file), so a
fresh checkout remakes the CSVs it reads; the generation is deterministic.
Everything runs on the host (NumPy and the native oracles of ``native/``).
"""

from __future__ import annotations

import logging
import os
import pathlib
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from .generators import (co_minlp_gen, msr_waterfilling_labels, noma_uav_gen,
                         nu_coordinates_gen, sum_rate_gen)
from .loaders import MSR_W_REF

logger = logging.getLogger(__name__)

_EXCLUDED_BUDGETS = (18.0, 30.0)


def value_grid(lo: float, hi: float, step: float, exclude: Iterable[float] = ()) -> np.ndarray:
    """``lo..hi`` by ``step``, less the values within 1e-9 of one of ``exclude``."""
    g = np.arange(lo, hi + 1e-9, step)
    return np.array([v for v in g if not any(abs(v - e) < 1e-9 for e in exclude)])


def wf_budget_rows(rng: np.random.Generator, n: int, M: int, grid: np.ndarray,
                   y_scale: float) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """The W-conditioned waterfilling MSR rows (the ``msr_budget`` recipe):
    gains U(0.5, 2.5), a per-row budget W from ``grid``, exact waterfilling
    labels, centered per row by W / M and scaled by ``y_scale``. Returns
    (X (n, M + 1) as [min-max scaled gains, W / w_ref], Y (n, M),
    scaler_min, scaler_max)."""
    gs = rng.uniform(0.5, 2.5, size=(n, M))
    Ws = rng.choice(grid, size=n)
    Y = np.zeros_like(gs)
    for w in grid:          # exact waterfilling labels, one batch per budget
        idx = np.nonzero(Ws == w)[0]
        _, Y[idx] = msr_waterfilling_labels(gs[idx], float(w))
    mn, mx = float(gs.min()), float(gs.max())
    X = np.concatenate([(gs - mn) / (mx - mn), Ws[:, None] / MSR_W_REF], axis=1)
    return X, (Y - Ws[:, None] / M) * y_scale, mn, mx


def co_rows(samples: int = 50000, nodes: int = 3, step: float = 0.02,
            seed: int = 0) -> np.ndarray:
    return co_minlp_gen(samples, nodes, step, seed)


def msr_rows(samples: int = 10000, channels: int = 3, power: float = 10.0,
             gmin: float = 0.5, gmax: float = 2.5, seed: int = 0,
             labels: str = "lrh") -> np.ndarray:
    """``[g..., rate, p...]`` rows; ``labels`` "lrh" (the reference's
    gradient-ascent labels) or "wf" (exact waterfilling, the same gains)."""
    if labels == "wf":
        gs = np.random.default_rng(seed).uniform(gmin, gmax, size=(samples, channels))
        rates, schemes = msr_waterfilling_labels(gs, power)
    elif labels == "lrh":
        gs, rates, schemes = sum_rate_gen(samples, channels, (gmin, gmax), power, seed)
    else:
        raise ValueError(f"labels must be 'lrh' or 'wf', got {labels!r}")
    return np.concatenate([gs, rates[:, None], schemes], axis=1)


def nu_rows(samples: int = 1000, power: float = 18.0, width: float = 400.0,
            height: float = 400.0, grid_step: float = 1.0, seed: int = 0,
            native: bool = True, legacy_sinr: bool = False) -> np.ndarray:
    """``[q x 6, L x 2, P x 3, rate]`` rows from the native grid-search
    oracle, or with ``native=False`` from the NumPy one."""
    from .native import nu_oracle_native

    if not native:
        return noma_uav_gen(samples, power, seed, width=int(width), height=int(height),
                            grid_step=grid_step, legacy_sinr=legacy_sinr)
    qs = nu_coordinates_gen(np.random.default_rng(seed), samples, width=int(width),
                            height=int(height))
    sol = nu_oracle_native(qs, P_sum=power, grid_step=grid_step, width=width, height=height,
                           legacy_sinr=legacy_sinr)
    return np.concatenate([qs, sol], axis=1)


def nu_budget_rows(samples: int = 10000, budget_min: float = 9.0, budget_max: float = 36.0,
                   budget_step: float = 1.0,
                   exclude_budgets: Sequence[float] = _EXCLUDED_BUDGETS,
                   grid_step: float = 2.0, seed: int = 0) -> np.ndarray:
    """Multi-budget NU rows: a per-sample budget from a grid that leaves out
    the eval budgets, stored as a 13th column [q x 6, L x 2, P x 3, rate,
    P_sum]."""
    from .native import nu_oracle_native

    grid = value_grid(budget_min, budget_max, budget_step, exclude_budgets)
    rng = np.random.default_rng(seed)
    qs = nu_coordinates_gen(rng, samples)
    budgets = rng.choice(grid, size=samples)
    data = np.zeros((samples, 13))
    data[:, :6] = qs
    data[:, 12] = budgets
    for b in grid:          # one batched native solve per budget
        idx = np.nonzero(budgets == b)[0]
        if idx.size:
            data[idx, 6:12] = nu_oracle_native(qs[idx], P_sum=float(b), grid_step=grid_step)
            logger.info("budget %5.1f mW: %d samples solved", b, idx.size)
    return data


def nu_geo_rows(samples: int = 10000, geom_min: float = 200.0, geom_max: float = 600.0,
                geom_step: float = 40.0, exclude_geoms: Sequence[float] = (400.0,),
                budget_min: float = 9.0, budget_max: float = 36.0, budget_step: float = 3.0,
                exclude_budgets: Sequence[float] = _EXCLUDED_BUDGETS, grid_step: float = 2.0,
                focus_frac: float = 0.0, focus_geom_min: float = 320.0,
                focus_geom_max: float = 480.0, focus_geom_step: Optional[float] = None,
                seed: int = 0) -> np.ndarray:
    """Mixed-geometry, mixed-budget NU rows: a per-sample field (W, H) and
    budget, stored as trailing columns [q x 6, L x 2, P x 3, rate, P_sum, W,
    H]. A share ``focus_frac`` of the fields is drawn from the focus range
    (grid ``focus_geom_step``, default that of the full grid), interleaved
    at random."""
    from .native import nu_oracle_native

    geoms = value_grid(geom_min, geom_max, geom_step, exclude_geoms)
    budgets_grid = value_grid(budget_min, budget_max, budget_step, exclude_budgets)
    rng = np.random.default_rng(seed)
    Ws = rng.choice(geoms, size=samples)
    Hs = rng.choice(geoms, size=samples)
    all_geoms = geoms
    if focus_frac > 0:
        if focus_geom_step is not None:
            focus = value_grid(focus_geom_min, focus_geom_max, focus_geom_step, exclude_geoms)
        else:
            focus = geoms[(geoms >= focus_geom_min - 1e-9) & (geoms <= focus_geom_max + 1e-9)]
        sel = rng.random(samples) < focus_frac
        Ws[sel] = rng.choice(focus, size=int(sel.sum()))
        Hs[sel] = rng.choice(focus, size=int(sel.sum()))
        all_geoms = np.unique(np.concatenate([geoms, focus]))
    Ps = rng.choice(budgets_grid, size=samples)
    data = np.zeros((samples, 15))
    data[:, 12], data[:, 13], data[:, 14] = Ps, Ws, Hs
    n_done = 0
    for w in all_geoms:     # the coordinates need the field: one draw and solve per (W, H)
        for h in all_geoms:
            gsel = np.nonzero((Ws == w) & (Hs == h))[0]
            if not gsel.size:
                continue
            data[gsel, :6] = nu_coordinates_gen(rng, gsel.size, width=int(w), height=int(h))
            for b in budgets_grid:
                idx = gsel[Ps[gsel] == b]
                if idx.size:
                    data[idx, 6:12] = nu_oracle_native(data[idx, :6], P_sum=float(b),
                                                       grid_step=grid_step, width=float(w),
                                                       height=float(h))
            n_done += gsel.size
        logger.info("W=%5.0f: %d/%d solved", w, n_done, samples)
    return data


#: The row makers by ``tools/make_datasets.py`` subcommand.
GENERATORS = {"co": co_rows, "msr": msr_rows, "nu": nu_rows, "nu-budget": nu_budget_rows,
              "nu-geo": nu_geo_rows}


def make_rows(kind: str, **kw: Any) -> np.ndarray:
    """The rows of subcommand ``kind`` of ``tools/make_datasets.py``, its
    flags given as keywords (``grid_step=2`` for ``--grid-step 2``)."""
    return GENERATORS[kind](**kw)


def write_csv(path, rows: np.ndarray) -> pathlib.Path:
    """``rows`` as the CSV that ``np.savetxt`` writes, through a temporary
    file so a cut run leaves none half written."""
    out = pathlib.Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    np.savetxt(tmp, rows, delimiter=",")
    os.replace(tmp, out)
    return out


#: The recipes of the repository's gitignored ``datasets/``: (subcommand,
#: keywords), the JAX package's ``tools/make_datasets.py::KNOWN_DATASETS``.
KNOWN_DATASETS: Dict[str, Tuple[str, Dict[str, Any]]] = {
    "3nodes_50000samples_new.csv": ("co", {"samples": 50000}),
    "80c_20w_10000samples.csv": ("msr", {"samples": 10000, "channels": 80, "power": 20.0}),
    "80c_40w_2000samples_ood.csv": ("msr", {"samples": 2000, "channels": 80, "power": 40.0,
                                            "seed": 1}),
    "80c_20w_wf_10000samples.csv": ("msr", {"samples": 10000, "channels": 80, "power": 20.0,
                                            "labels": "wf"}),
    "80c_40w_wf_2000samples_ood.csv": ("msr", {"samples": 2000, "channels": 80,
                                               "power": 40.0, "seed": 1, "labels": "wf"}),
    "80c_20w_wf_50000samples.csv": ("msr", {"samples": 50000, "channels": 80, "power": 20.0,
                                            "labels": "wf"}),
    "8c_10w_10000samples.csv": ("msr", {"samples": 10000, "channels": 8, "power": 10.0}),
    "8c_10w_wf_10000samples.csv": ("msr", {"samples": 10000, "channels": 8, "power": 10.0,
                                           "labels": "wf"}),
    "8c_20w_2000samples_ood.csv": ("msr", {"samples": 2000, "channels": 8, "power": 20.0,
                                           "seed": 1}),
    "8c_20w_wf_2000samples_ood.csv": ("msr", {"samples": 2000, "channels": 8, "power": 20.0,
                                              "seed": 1, "labels": "wf"}),
    # Unseen-geometry NU eval sets (the 480x360 set at grid step 2: its
    # labels within 0.004% of grid step 1's, at a quarter of the work).
    "3u_geo600x600_33mW_500samples.csv": ("nu", {"samples": 500, "power": 33.0,
                                                 "width": 600.0, "height": 600.0, "seed": 11,
                                                 "grid_step": 3.0}),
    "3u_geo200x200_12mW_500samples.csv": ("nu", {"samples": 500, "power": 12.0,
                                                 "width": 200.0, "height": 200.0,
                                                 "seed": 12}),
    "3u_geo480x360_21mW_1000samples.csv": ("nu", {"samples": 1000, "power": 21.0,
                                                  "width": 480.0, "height": 360.0, "seed": 7,
                                                  "grid_step": 2.0}),
}

#: The CSVs the port's eval paths read: the CO set, the three
#: unseen-geometry NU sets, and the MSR-80c and MSR-8c waterfilling sets with
#: their OOD twins.
EVAL_DATASETS: Tuple[str, ...] = (
    "3nodes_50000samples_new.csv",
    "3u_geo600x600_33mW_500samples.csv",
    "3u_geo200x200_12mW_500samples.csv",
    "3u_geo480x360_21mW_1000samples.csv",
    "80c_20w_wf_10000samples.csv",
    "80c_40w_wf_2000samples_ood.csv",
    "8c_10w_wf_10000samples.csv",
    "8c_20w_wf_2000samples_ood.csv",
)


def ensure_datasets(names: Optional[Iterable[str]] = None,
                    root: Optional[str] = None) -> Dict[str, pathlib.Path]:
    """Write each missing CSV of ``names`` (default: ``EVAL_DATASETS``; any
    name of ``KNOWN_DATASETS``) under ``root`` (default: the repository's
    ``datasets/``); return every path."""
    root_dir = pathlib.Path(root) if root else (
        pathlib.Path(__file__).resolve().parent.parent.parent / "datasets")
    paths = {}
    for name in (names or EVAL_DATASETS):
        out = paths[name] = root_dir / name
        if not out.exists():
            kind, kw = KNOWN_DATASETS[name]
            write_csv(out, make_rows(kind, **kw))
    return paths

"""ctypes bindings of the native oracles: NOMA-UAV grid search and CO
exhaustive search.

Counterpart of ``diffsg_tpu/data/native.py``: ``nu_oracle_native`` over
``native/nu_oracle.cpp`` and ``co_oracle_native`` over
``native/co_oracle.cpp``. Each library is built at first use into
``build/diffsg_tpu_torch/`` under the repository root with the flags of
``native/Makefile`` but ``-fopenmp`` (a compiler may ship without OpenMP's
runtime, as the GPU machine's does); the samples are solved in parallel by
Python threads instead, each on its own rows (a ctypes call releases the
GIL), so every row is the one OpenMP's build gives. A failed build raises:
the NumPy generators in ``data/generators.py`` are the slower way to the
same rows, and nothing switches to them on its own.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
_BUILD = _REPO / "build" / "diffsg_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")
_P = ctypes.POINTER(ctypes.c_double)
#: (source, function, argtypes) per library.
_LIBS = {
    "nu_oracle": ("nu_oracle_solve",
                  [_P, ctypes.c_int64, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                   ctypes.c_double, ctypes.c_double, ctypes.c_int, _P]),
    "co_oracle": ("co_oracle_solve", [_P, ctypes.c_int64, ctypes.c_int, ctypes.c_double, _P]),
}
_LOADED: Dict[str, ctypes.CDLL] = {}


def _library(name: str) -> ctypes.CDLL:
    """``native/<name>.cpp`` built (once) and loaded, its function typed."""
    if name not in _LOADED:
        source, path = _REPO / "native" / f"{name}.cpp", _BUILD / f"lib{name}.so"
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cxx = os.environ.get("CXX", "g++")
            done = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {source.name} ({done.returncode}):\n"
                                   f"{done.stderr}\nThe NumPy generators in "
                                   "diffsg_tpu_torch.data.generators make the same rows.")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = _LIBS[name]
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _LOADED[name] = lib
    return _LOADED[name]


def _solve_rows(solve: Callable[[np.ndarray, np.ndarray], int], inputs: np.ndarray,
                out: np.ndarray, what: str) -> np.ndarray:
    """``solve(inputs[rows], out[rows])`` over blocks of rows on a thread
    pool; raise if a block returns non-zero."""
    # Small blocks, so that rows of uneven cost spread over the threads.
    step = max(1, -(-inputs.shape[0] // (8 * (os.cpu_count() or 1))))
    blocks = [slice(i, i + step) for i in range(0, inputs.shape[0], step)]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        # contiguous row blocks: views, written in place
        rcs = list(pool.map(lambda rows: solve(inputs[rows], out[rows]), blocks))
    if any(rcs):
        raise RuntimeError(f"{what} returned {max(rcs)}")
    return out


def nu_oracle_native(qs: np.ndarray, P_sum: float = 18.0, power_step: float = 0.1,
                     grid_step: float = 1.0, width: float = 400.0, height: float = 400.0,
                     legacy_sinr: bool = False) -> np.ndarray:
    """Solve NU oracle instances: qs (n, 6) user coordinates -> (n, 6)
    ``[uav_x, uav_y, P1..P3, rate]``, as ``generators.noma_uav_gen`` solves
    each sample."""
    qs = np.ascontiguousarray(qs, dtype=np.float64)
    fn = _library("nu_oracle").nu_oracle_solve

    def solve(q, o):
        return fn(q.ctypes.data_as(_P), q.shape[0], P_sum, power_step, grid_step, width, height,
                  int(legacy_sinr), o.ctypes.data_as(_P))

    return _solve_rows(solve, qs, np.zeros((qs.shape[0], 6)), "nu_oracle_solve")


def co_oracle_native(features: np.ndarray, node_num: int = 3, step: float = 0.02) -> np.ndarray:
    """Solve CO oracle instances: features (n, 5N) ``[s (N), c (N),
    f_local (N), h (N), alpha (N)]`` -> (n, 1 + N) ``[decision_class,
    allocations]``, the cheapest candidate as ``generators.co_minlp_gen``
    picks it."""
    features = np.ascontiguousarray(features, dtype=np.float64)
    if features.ndim != 2 or features.shape[1] != 5 * node_num:
        raise ValueError(f"features must be (n, {5 * node_num}), got {features.shape}")
    fn = _library("co_oracle").co_oracle_solve

    def solve(f, o):
        return fn(f.ctypes.data_as(_P), f.shape[0], node_num, step, o.ctypes.data_as(_P))

    return _solve_rows(solve, features, np.zeros((features.shape[0], 1 + node_num)),
                       "co_oracle_solve")

"""ctypes binding of the native NOMA-UAV grid-search oracle.

The part of ``diffsg_tpu/data/native.py`` that remaking the NU datasets
needs: ``nu_oracle_native`` over ``native/nu_oracle.cpp``. The library is
built at first use into ``build/diffsg_tpu_torch/`` under the repository
root with the flags of ``native/Makefile`` but ``-fopenmp`` (a compiler may
ship without OpenMP's runtime, as the GPU machine's does); the samples are
solved in parallel by Python threads instead, each on its own rows (a
ctypes call releases the GIL), so every row is the one OpenMP's build
gives. A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent.parent
_SOURCE = _REPO / "native" / "nu_oracle.cpp"
_LIB_PATH = _REPO / "build" / "diffsg_tpu_torch" / "libnu_oracle.so"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall")
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        if not _LIB_PATH.exists():
            _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
            tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
            cxx = os.environ.get("CXX", "g++")
            done = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                                  capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"{cxx} failed on {_SOURCE.name} ({done.returncode}):\n"
                                   f"{done.stderr}")
            os.replace(tmp, _LIB_PATH)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.nu_oracle_solve.restype = ctypes.c_int
        lib.nu_oracle_solve.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double)]
        _LIB = lib
    return _LIB


def nu_oracle_native(qs: np.ndarray, P_sum: float = 18.0, power_step: float = 0.1,
                     grid_step: float = 1.0, width: float = 400.0, height: float = 400.0,
                     legacy_sinr: bool = False) -> np.ndarray:
    """Solve NU oracle instances: qs (n, 6) user coordinates -> (n, 6)
    ``[uav_x, uav_y, P1..P3, rate]``, as ``generators.noma_uav_gen`` of the
    JAX package solves each sample."""
    qs = np.ascontiguousarray(qs, dtype=np.float64)
    out = np.zeros((qs.shape[0], 6), dtype=np.float64)
    lib = _library()

    def solve(rows: slice) -> int:
        q, o = qs[rows], out[rows]      # contiguous row blocks: views, written in place
        return lib.nu_oracle_solve(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), q.shape[0], P_sum, power_step,
            grid_step, width, height, int(legacy_sinr),
            o.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))

    # Small blocks, so that rows of uneven cost spread over the threads.
    step = max(1, -(-qs.shape[0] // (8 * (os.cpu_count() or 1))))
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        rcs = list(pool.map(solve, [slice(i, i + step) for i in range(0, qs.shape[0], step)]))
    if any(rcs):
        raise RuntimeError(f"nu_oracle_solve returned {max(rcs)}")
    return out

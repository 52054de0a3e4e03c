"""Build the port's CUDA kernels with ``nvcc`` and load them.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``; no PyTorch headers, so the build takes
seconds. The library lands in ``build/diffsg_tpu_torch/`` under the
repository root, named by a hash of the sources and flags, and is built at
first use. The build and the load are the set-up spans ``kernels.build``
(cold checkouts only; attribute ``log``: the compiler's report, ptxas
registers, spills and shared memory) and ``kernels.load`` (``diffsg_tpu_torch.obs``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

from .. import obs

_PKG = pathlib.Path(__file__).resolve().parent.parent
_BUILD_DIR = _PKG.parent / "build" / "diffsg_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source set has no
    library yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted((_PKG / "csrc").glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    so = _BUILD_DIR / f"libdiffsg_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        with obs.setup("kernels.build") as attrs:
            _compile(sources, so, digest.hexdigest()[:16], attrs)
    with obs.setup("kernels.load"):
        _LIB = ctypes.CDLL(str(so))
    return _LIB


def _compile(sources, so: pathlib.Path, tag: str, attrs: dict) -> None:
    """Build ``so`` from ``sources``; the compiler's report goes to
    ``attrs["log"]``."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pid = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{src.stem}_{tag}.{pid}.o") for src in sources]
    tmp = so.with_name(f"{so.name}.{pid}")
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[1] for proc in procs]
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    attrs["log"] = "".join(logs)
    os.replace(tmp, so)  # atomic: concurrent builders never load a partial file

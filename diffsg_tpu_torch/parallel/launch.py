"""Run a function on every rank of a world of spawned processes.

``spawn(target, n, tp, device)`` starts ``n`` processes with
``torch.multiprocessing``'s spawn start method. Each joins the default
process group through a ``file://`` store in a temporary directory
(``mesh.init_process``: NCCL on ``cuda``, gloo on ``cpu``), builds the
``(n // tp, tp)`` mesh, calls ``target(mesh, *args)`` and writes what it
returns beside the store. ``spawn`` returns the ranks' results in rank
order. Process-group set-up and every collective time out after
``timeout_s``, and so does the whole world: a rank that fails or hangs
raises here, and every process is stopped.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import DeviceLike
from .mesh import init_process, make_mesh


def _rank_main(rank: int, world: int, tp: int, device: str, store_dir: str,
               target: Callable[..., Any], args: Sequence[Any], threads: int,
               timeout_s: float) -> None:
    torch.set_num_threads(threads)
    init_process(rank, world, f"file://{os.path.join(store_dir, 'store')}", device, timeout_s)
    try:
        out = target(make_mesh(world, tp, device), *args)
        with open(os.path.join(store_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(target: Callable[..., Any], n: int, tp: int = 1, device: DeviceLike = "cuda",
          args: Sequence[Any] = (), timeout_s: float = 300.0, threads: int = 1,
          store_dir: Optional[str] = None) -> List[Any]:
    """``[target(mesh_r, *args) for r in range(n)]``, each on its own rank.
    ``target`` must be a module-level function (it is pickled by name);
    ``threads`` is each rank's intra-op thread count; ``store_dir`` (made
    if missing) holds the store and the results, else a temporary
    directory. A script that calls it must do so under ``if __name__ ==
    "__main__":``: each spawned rank re-imports the script's main module."""
    if store_dir is None:
        with tempfile.TemporaryDirectory() as d:
            return spawn(target, n, tp, device, args, timeout_s, threads, d)
    os.makedirs(store_dir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(n, tp, str(device), store_dir, target,
                                               tuple(args), threads, timeout_s),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"a world of {n} ranks ran past {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for rank in range(n):
        with open(os.path.join(store_dir, f"result_{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

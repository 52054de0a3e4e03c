"""A training epoch and a meshed solve over an ``n``-rank mesh.

Counterpart of ``__graft_entry__.py::dryrun_multichip``:

    python -m diffsg_tpu_torch.parallel.dryrun N [--cpu]

spawns ``N`` ranks (``parallel.launch.spawn``: NCCL, one card a rank; gloo
processes with ``--cpu``) on a ``(N / tp, tp)`` mesh, ``tp = 2`` when ``N``
is even and above 1. Every rank trains ``unet_msr(3)`` for one epoch at
batch ``8 * dp`` on the seeded data of the JAX dryrun (wide kernels split
over tp), then serves ``ckpts/ddpm_nu_3u_aug32_s8c`` (``nu_direct``, DDPM,
omega 0.125) on a meshed Solver for 50 rows, not a dp multiple; rank 0
holds that answer to a single-process solve (max abs difference below
1e-3, the JAX dryrun's bound) and the summary line is the JAX dryrun's.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict

import numpy as np

from ..device import DeviceLike
from .launch import spawn
from .mesh import Mesh

NU_CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "ckpts", "ddpm_nu_3u_aug32_s8c")
SERVE_BOUND = 1e-3


def _dryrun_rank(mesh: Mesh) -> Dict[str, Any]:
    from ..models import unet_msr
    from ..serve import Solver
    from ..train import TrainConfig, train_ddpm

    batch = 8 * mesh.dp
    N = 4 * batch
    cfg = TrainConfig(epochs=1, batch_size=batch, lr=5e-3, milestones=(100,), T=20,
                      use_ema=True, ema_start=0, ema_update_rate=1, warmup_epoch=-1, seed=0)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    Y = (rng.dirichlet(np.ones(3), N) * 10.0).astype(np.float32)
    logged = []
    train_ddpm(unet_msr(3), X, Y, cfg, log_every=1, log_fn=logged.append, mesh=mesh)
    loss = float(logged[-1].rsplit(" ", 1)[1])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    serve_err = None
    if os.path.isdir(NU_CKPT):
        backend = "plain" if mesh.tp > 1 else "fused"
        Xq = np.random.default_rng(2).uniform(0.05, 0.95, (50, 6)).astype(np.float32)
        meshed = Solver.from_checkpoint(NU_CKPT, task="nu_direct", backend=backend, mesh=mesh)
        y_meshed = meshed.solve(Xq, omega=0.125)
        if mesh.rank == 0:
            single = Solver.from_checkpoint(NU_CKPT, task="nu_direct", backend=backend,
                                            device=mesh.device)
            serve_err = float(np.max(np.abs(single.solve(Xq, omega=0.125) - y_meshed)))
            if not serve_err < SERVE_BOUND:
                raise AssertionError(f"meshed solve mismatch: {serve_err}")
    return {"shape": mesh.shape, "platform": mesh.device.type, "loss": loss,
            "serve_max_abs_err": serve_err}


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda",
                     timeout_s: float = 900.0) -> Dict[str, Any]:
    """Run the dryrun over ``n_devices`` spawned ranks; print the summary
    and return rank 0's result."""
    tp = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    r = spawn(_dryrun_rank, n_devices, tp, device, timeout_s=timeout_s,
              threads=1 if str(device) == "cpu" else 4)[0]
    print(f"dryrun_multichip ok: mesh=({r['shape']}), platform={r['platform']}, "
          f"loss={r['loss']:.5f}, serve_max_abs_err={r['serve_max_abs_err']}", flush=True)
    return r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=1, help="ranks (one card each on cuda)")
    ap.add_argument("--cpu", action="store_true", help="gloo processes on the CPU")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    main()

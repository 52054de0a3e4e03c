"""Few-step serving quality table: DDIM respacing against the T-step DDPM sampler.

Counterpart of the JAX package's ``tools/fewstep.py``, with its flags;
``--cpu`` runs on the CPU (the default is the CUDA card) and ``--backend``
names the ``Solver``'s denoiser forward (``fused``, ``mega`` or ``plain``).
Every row goes through ``serve.Solver``, the production path: one
``solve(seed=i)`` per batch i of ``--batch`` rows, one JSON line per
(dataset, sampler, steps).

    python -m diffsg_tpu_torch.tools.fewstep --task nu_direct \\
        --ckpt ckpts/ddpm_nu_3u_aug32_s8c --datasets build/datasets/3u_18mW_1000samples.csv \\
        --omega 0.125 --steps 3 5 10 20 --backend mega
"""

from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import numpy as np
import torch

from ._cli import add_device_args, device_from_args


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--datasets", nargs="+", required=True)
    ap.add_argument("--omega", type=float, default=None)
    ap.add_argument("--steps", type=int, nargs="+", default=[3, 5, 10, 20])
    ap.add_argument("--best-of", type=int, default=1)
    ap.add_argument("--eta", type=float, default=0.0,
                    help="DDIM stochasticity on the respaced sub-sequence "
                         "(0 = deterministic, 1 = DDPM-like)")
    ap.add_argument("--renorm-steps", type=int, default=None,
                    help="early-step re-standardization count override "
                         "(default: adaptive clamp(n/5, 1, 4))")
    ap.add_argument("--batch", type=int, default=512, help="eval batch (reference protocol: 512)")
    ap.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N test rows (smoke runs)")
    ap.add_argument("--no-ddpm-row", action="store_true",
                    help="skip the full-T ancestral-sampler reference row")
    ap.add_argument("--backend", choices=["plain", "fused", "mega"], default="fused",
                    help="the Solver's denoiser forward")
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    from ..serve import Solver
    from ..tasks import TASKS, merge_ckpt_config, objective_metrics

    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS[args.task]
    omega = task.default_omega if args.omega is None else args.omega

    def run(solver, data, sampler, n_steps):
        outs = []
        t0 = time.time()
        for i, lo in enumerate(range(0, data.X_test.shape[0], args.batch)):
            kw = ({"eta": args.eta, "renorm_steps": args.renorm_steps}
                  if sampler == "ddim" else {})
            outs.append(solver.solve(np.asarray(data.X_test[lo:lo + args.batch]), omega=omega,
                                     best_of=args.best_of, seed=i, sampler=sampler,
                                     n_steps=n_steps, **kw))
        return np.concatenate(outs), time.time() - t0

    for ds in args.datasets:
        data = task.load(ds)
        if args.limit:
            data.X_test = data.X_test[:args.limit]
            data.Y_test = data.Y_test[:args.limit]
        # One Solver per dataset: the DATASET owns the physical config (W,
        # P_sum, the scalers), the CHECKPOINT the training-time keys (y_scale,
        # y_shift), which from_checkpoint keeps where dataset_config lacks them.
        solver = Solver.from_checkpoint(args.ckpt, task=args.task, device=dev,
                                        backend=args.backend, dataset_config=data.config)
        merge_ckpt_config(data.config, {"dataset_config": solver.config})
        rows = [] if args.no_ddpm_row else [("ddpm", None)]
        rows += [("ddim", s) for s in args.steps]
        for sampler, n_steps in rows:
            Y, secs = run(solver, data, sampler, n_steps)
            m = objective_metrics(task, data, Y, device=dev)
            if task.extra_metrics is not None:
                Xu = torch.as_tensor(np.asarray(task.unnormalize_x(data.X_test, data.config),
                                                np.float32), device=dev)
                Yt = task.unnormalize_y(data.Y_test, data.config)
                with torch.inference_mode():
                    pred, true = (task.objective(torch.as_tensor(np.asarray(y, np.float32),
                                                                 device=dev), Xu, data.config)
                                  .cpu().numpy() for y in (Y, Yt))
                m.update(task.extra_metrics(Y, Yt, pred, true, data.config))
            extra = {}
            if sampler == "ddim" and (args.eta or args.renorm_steps is not None):
                extra = {"eta": args.eta, "renorm_steps": args.renorm_steps}
            print(json.dumps({
                "task": args.task, "dataset": ds, "sampler": sampler,
                "steps": n_steps or int(solver.sched.T), "omega": omega,
                "best_of": args.best_of, **extra, "elapsed_s": round(secs, 2), **m}),
                flush=True)


if __name__ == "__main__":
    main()

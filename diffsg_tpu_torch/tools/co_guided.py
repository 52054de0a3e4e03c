"""CO objective-guidance sweep: single-draw quality with cost-gradient
guidance in the sampler (``diffusion.cfg_sample(guidance_fn=...)``).

Counterpart of the JAX package's ``tools/co_guided.py``, with its flags;
``--cpu`` runs on the CPU (the default is the CUDA card). The sampler runs
the module's own forward (``plain``), as the JAX CLI runs ``model.apply``;
each step's x0 estimate is steered down ``baselines.co_soft_cost`` and the
draw decoded by ``co_analytic_decode``, in chunks of 512 rows. Noise: one
``torch.Generator`` seeded by ``--seed`` for each (tau, omega, scale), one
(b, T+1, D) draw a chunk, in ``tasks.sample_solutions``' layout. One JSON
line per (tau, omega, scale): the decision accuracy and the metric block,
rounded as the JAX CLI rounds them.

    python -m diffsg_tpu_torch.tools.co_guided --ckpt ckpts/ddpm_co_aux \\
        --dataset datasets/3nodes_50000samples_new.csv --scales 0 0.3 --limit 1024
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np
import torch

from ..baselines import co_analytic_decode, co_soft_cost
from ..diffusion import cfg_sample
from ..models import unet_apply_fn
from ..tasks import TASKS, loaded_model, merge_ckpt_config, objective_metrics
from ..tasks.co import decision_class
from ..utils import load_checkpoint
from ._cli import add_device_args, device_from_args

CHUNK = 512


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="ckpts/ddpm_co_aux")
    ap.add_argument("--dataset", default="datasets/3nodes_50000samples_new.csv")
    ap.add_argument("--omegas", type=float, nargs="+", default=[5000.0])
    ap.add_argument("--scales", type=float, nargs="+", default=[0.0, 0.1, 0.3, 1.0, 3.0])
    ap.add_argument("--taus", type=float, nargs="+", default=[0.05])
    ap.add_argument("--limit", type=int, default=0,
                    help="evaluate only the first N test rows (0 = all)")
    ap.add_argument("--relative", action="store_true",
                    help="row-normalized gradient scaled by the epsilon RMS "
                         "(guidance_relative; scales ~0.03-1)")
    ap.add_argument("--seed", type=int, default=0)
    add_device_args(ap)
    return ap.parse_args(argv)


def guided_draw(apply_fn, sched, cond: torch.Tensor, cond_unnorm: torch.Tensor, omega: float,
                gscale: float, tau: float, relative: bool, noise: torch.Tensor) -> torch.Tensor:
    """One guided draw of a chunk on ``noise`` (b, T+1, D), row-major
    (column 0 y_T, then the per-step z), decoded by ``co_analytic_decode``."""
    y0 = cfg_sample(apply_fn, sched, cond, omega, noise.shape[2],
                    init_noise=noise[:, 0].contiguous(),
                    step_noise=noise[:, 1:].transpose(0, 1),
                    guidance_fn=lambda x0: co_soft_cost(x0, cond_unnorm, tau=tau),
                    guidance_scale=gscale, guidance_relative=relative)
    return co_analytic_decode(y0, cond_unnorm)


@torch.no_grad()
def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Print one rounded JSON line per (tau, omega, scale); return the
    unrounded rows."""
    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS["co_analytic"]
    data = task.load(args.dataset)
    ck = load_checkpoint(args.ckpt, device=dev)
    merge_ckpt_config(data.config, ck.get("metadata"))
    if args.limit:
        data.X_test = data.X_test[:args.limit]
        data.Y_test = data.Y_test[:args.limit]
    sched = ck["sched"]
    apply_fn = unet_apply_fn(loaded_model(task, ck["params"], data.config, dev), "plain")
    D = task.data_dim(data.config)
    # Not inference tensors: the guidance differentiates a cost closed over them.
    cond = torch.as_tensor(np.asarray(data.X_test, np.float32), device=dev)
    cond_unnorm = torch.as_tensor(
        np.asarray(task.unnormalize_x(data.X_test, data.config), np.float32), device=dev)
    out = []
    for tau in args.taus:
        for omega in args.omegas:
            for gs in args.scales:
                gen = torch.Generator(device=dev).manual_seed(args.seed)
                parts = []
                for i in range(0, cond.shape[0], CHUNK):
                    c, cu = cond[i:i + CHUNK], cond_unnorm[i:i + CHUNK]
                    noise = torch.randn((c.shape[0], sched.T + 1, D), generator=gen, device=dev)
                    parts.append(guided_draw(apply_fn, sched, c, cu, omega, gs, tau,
                                             args.relative, noise).cpu().numpy())
                Y_pred = np.concatenate(parts)
                m = objective_metrics(task, data, Y_pred, device=dev)
                acc = float((decision_class(Y_pred) == decision_class(data.Y_test)).mean())
                out.append({"tau": tau, "omega": omega, "gscale": gs, "acc": acc, **m})
                print(json.dumps({"tau": tau, "omega": omega, "gscale": gs,
                                  "acc": round(acc, 4),
                                  **{k: round(v, 5) for k, v in m.items()}}), flush=True)
    return out


if __name__ == "__main__":
    main()

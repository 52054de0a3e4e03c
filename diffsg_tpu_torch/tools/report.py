"""Gap report: DDPM rows beside the GD, MTFNN and PPO baselines' rows.

Counterpart of the JAX package's ``tools/report.py``, with its flags;
``--cpu`` runs on the CPU (the default is the CUDA card) and ``--backend``
names the denoiser forward of the DDPM rows (``fused``: every residual
block one launch of ``csrc/resblock.cu``; ``mega``: every forward one launch
of ``csrc/mega.cu``; ``plain``), as ``evaluate`` and ``Solver`` take it.

    python -m diffsg_tpu_torch.tools.report --task co_ranked --ckpt ckpts/ddpm_co_x0 \\
        --datasets datasets/3nodes_50000samples_new.csv --omegas 1 \\
        --baselines gd mtfnn ppo --mtfnn-ckpt ckpts/retrain_mtfnn_co \\
        --ppo-ckpt ckpts/retrain_ppo_co --out build/co_report.jsonl

Each row is one JSON line (and a line of ``--out``). ``--mtfnn-ckpt`` and
``--ppo-ckpt`` take a reference ``.pt`` file or an npz checkpoint directory
(``tools/train_baselines.py --out``).
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ._cli import add_device_args, device_from_args

TASK_CHOICES = ["msr", "msr_temp", "msr_wf", "msr_budget", "co", "co_analytic", "co_direct",
                "co_ranked", "nu", "nu_direct", "nu_budget"]


def _family(task_name: str) -> str:
    """The baselines' problem for a DDPM task name: ``msr``, ``co`` or ``nu``
    by its prefix. (The JAX CLI tests for the names ``msr`` and ``co`` alone
    and sends every other task to the NU branch, where ``co_ranked`` raises
    KeyError.)"""
    return task_name.split("_", 1)[0]


def run_gd(task_name: str, data, task, dev: torch.device) -> np.ndarray:
    """GD's solutions of the whole test split, in one batch."""
    from ..baselines import co_gd_solve, msr_gd_solve, nu_gd_solve

    fam = _family(task_name)
    if fam == "nu":
        # the reference feeds the loader-NORMALIZED coordinates (GD.py:131)
        X = torch.as_tensor(np.asarray(data.X_test, np.float32), device=dev)
        return nu_gd_solve(X, P_sum=data.config["P_sum"]).cpu().numpy()
    X = torch.as_tensor(np.asarray(task.unnormalize_x(data.X_test, data.config), np.float32),
                        device=dev)
    if fam == "msr":
        return msr_gd_solve(X, W=data.config["W"]).cpu().numpy()
    return co_gd_solve(X, node_num=data.config["node_num"]).cpu().numpy()


def load_baseline_state(ckpt: str, torch_loader, dev: torch.device) -> Dict[str, torch.Tensor]:
    """A reference torch ``.pt`` file (through ``torch_loader``) or an npz
    checkpoint directory, as a state dict."""
    if pathlib.Path(ckpt).is_dir():
        from ..utils import load_checkpoint, params_from_jax

        return params_from_jax(load_checkpoint(ckpt, device=dev)["params"])
    return torch_loader(ckpt)


def run_mtfnn(task_name: str, data, ckpt: str, dev: torch.device) -> np.ndarray:
    from ..baselines import load_mtfnn_ckpt
    from .train_baselines import mtfnn_recipe

    model, _, unscale, _ = mtfnn_recipe(_family(task_name), data.config)
    model.load_state_dict(load_baseline_state(
        ckpt, lambda p: load_mtfnn_ckpt(p, model.n_layers), dev), strict=True)
    model.to(dev).eval()
    with torch.inference_mode():
        Y = model(torch.as_tensor(np.asarray(data.X_test, np.float32), device=dev))
    return unscale(Y.cpu().numpy())


def run_ppo(task_name: str, data, ckpt: str, dev: torch.device) -> np.ndarray:
    """The mean action of the whole split in one forward and one transform:
    NU's ``nu_decode`` min-max is batch-global, so the split is not chunked."""
    from ..baselines import load_ppo_ckpt, ppo_predict
    from .train_baselines import ppo_recipe

    agent, _, _, _, transform, _ = ppo_recipe(_family(task_name), data.config)
    agent.load_state_dict(load_baseline_state(ckpt, load_ppo_ckpt, dev), strict=True)
    return ppo_predict(agent.to(dev).eval(), data.X_test, transform).cpu().numpy()


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=TASK_CHOICES, required=True)
    ap.add_argument("--sampler", choices=["ddpm", "ddim"], default="ddpm",
                    help="ddim enables few-step respacing via --n-steps")
    ap.add_argument("--n-steps", type=int, default=None,
                    help="DDIM respaced step count (default: full T)")
    ap.add_argument("--datasets", nargs="+", required=True)
    ap.add_argument("--ckpt", default=None, help="DDPM checkpoint dir")
    ap.add_argument("--omegas", type=float, nargs="+", default=[500.0])
    ap.add_argument("--baselines", nargs="*", default=[], choices=["gd", "mtfnn", "ppo"])
    ap.add_argument("--mtfnn-ckpt", default=None)
    ap.add_argument("--ppo-ckpt", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--best-of", type=int, default=1, help="best-of-N candidate selection")
    ap.add_argument("--mix-omegas", type=float, nargs="+", default=None,
                    help="per-candidate guidance mixture for best-of (tiled to --best-of "
                         "candidates); overrides --omegas for the candidate draws")
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="projected-gradient refinement steps on the task objective after "
                         "decoding (tasks.base.refine_solutions)")
    ap.add_argument("--refine-step", type=float, default=None,
                    help="first-step length for --refine-iters (default: the task's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", choices=["plain", "fused", "mega"], default="fused",
                    help="the DDPM rows' denoiser forward")
    add_device_args(ap)
    args = ap.parse_args(argv)
    for name in ("mtfnn", "ppo"):
        if name in args.baselines and not getattr(args, f"{name}_ckpt"):
            sys.exit(f"error: --baselines {name} requires --{name}-ckpt")
    return args


def main(argv: Optional[List[str]] = None) -> None:
    from ..tasks import TASKS, evaluate, merge_ckpt_config, objective_metrics
    from ..utils import load_checkpoint
    from ..utils.metrics import MetricsLogger

    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS[args.task]
    log = MetricsLogger(args.out)
    ck = load_checkpoint(args.ckpt, device=dev) if args.ckpt else None
    for ds in args.datasets:
        data = task.load(ds)
        if ck is not None:
            merge_ckpt_config(data.config, ck.get("metadata"))
            kw = dict(seed=args.seed, sampler=args.sampler, n_steps=args.n_steps,
                      refine_iters=args.refine_iters, refine_step=args.refine_step,
                      backend=args.backend)
            row = {"solver": args.sampler, "task": args.task, "dataset": ds}
            if args.mix_omegas and args.best_of > 1:
                reps = max(args.best_of // len(args.mix_omegas), 1)
                mixture = [w for w in args.mix_omegas for _ in range(reps)]
                m = evaluate(task, ck["params"], ck["sched"], data, omega=mixture,
                             best_of=len(mixture), **kw)
                log.log({**row, "omega": f"mix{args.mix_omegas}", "n_steps": args.n_steps,
                         "refine": args.refine_iters, "best_of": len(mixture), **m})
            else:
                for omega in args.omegas:
                    m = evaluate(task, ck["params"], ck["sched"], data, omega=omega,
                                 best_of=args.best_of, **kw)
                    log.log({**row, "omega": omega, "n_steps": args.n_steps,
                             "refine": args.refine_iters, "best_of": args.best_of, **m})
        for name, run in (("gd", lambda: run_gd(args.task, data, task, dev)),
                          ("mtfnn", lambda: run_mtfnn(args.task, data, args.mtfnn_ckpt, dev)),
                          ("ppo", lambda: run_ppo(args.task, data, args.ppo_ckpt, dev))):
            if name in args.baselines:
                log.log({"solver": name, "task": args.task, "dataset": ds,
                         **objective_metrics(task, data, run(), device=dev)})


if __name__ == "__main__":
    main()

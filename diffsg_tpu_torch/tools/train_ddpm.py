"""Train a CFG-DDPM for one task and evaluate it.

Counterpart of the JAX package's ``tools/train_ddpm.py``, with its flags;
``--cpu`` runs on the CPU, and the default is the CUDA card.

    python -m diffsg_tpu_torch.tools.train_ddpm --task co \\
        --dataset datasets/3nodes_50000samples_new.csv --out build/ddpm_co
    python -m diffsg_tpu_torch.tools.train_ddpm --task msr \\
        --dataset build/datasets/3c_10w_10000samples.csv --out build/ddpm_msr_3c --epochs 200
    python -m diffsg_tpu_torch.tools.train_ddpm --task co \\
        --dataset datasets/3nodes_50000samples_new.csv --out build/eval --eval-only ckpts/ddpm_co

The checkpoint (``diffsg_tpu.npz.v1``, with ``step`` set to the epoch count)
goes to ``--out``, with ``train_log.jsonl`` beside it; ``--checkpoint-every``
writes resumable checkpoints (with the optimizer state) to ``--out``/resume.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import List, Optional

import torch

TASK_CHOICES = ["msr", "msr_temp", "msr_wf", "co", "co_analytic", "co_direct", "co_ranked",
                "nu", "nu_direct", "nu_budget"]
#: Tasks whose decode inverts, or is invariant to, a constant label shift.
SHIFT_AWARE = ("msr_wf", "nu_direct", "nu_budget", "co_direct")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=TASK_CHOICES, required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--omega", type=float, default=None)
    ap.add_argument("--y-scale", type=float, default=1.0,
                    help="train on y_scale * labels; the decoders divide it back out "
                         "(config['y_scale'])")
    ap.add_argument("--y-shift", type=float, default=0.0,
                    help="subtract this from the labels before --y-scale "
                         f"(tasks {', '.join(SHIFT_AWARE)} only)")
    ap.add_argument("--parameterization", choices=["eps", "x0", "v"], default="eps",
                    help="the denoiser's target, kept in the checkpoint's metadata")
    ap.add_argument("--use-ema", action="store_true")
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clip (optax's clip_by_global_norm)")
    ap.add_argument("--milestones", type=int, nargs="+", default=None,
                    help="the epochs of the LR x0.1 drops (default: the task's)")
    ap.add_argument("--T", type=int, default=None, dest="t_steps",
                    help="diffusion steps (default: the task's, 20)")
    ap.add_argument("--proj-dim", type=int, default=None,
                    help="MSR denoiser width, kept in the checkpoint's metadata")
    ap.add_argument("--dims", type=int, nargs="+", default=None,
                    help="MSR denoiser stage widths")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    ap.add_argument("--matmul-precision", choices=["highest", "default"], default="highest",
                    help="'highest' turns both TF32 switches off, for float32 products "
                         "as the JAX package's 'highest'; 'default' leaves PyTorch's")
    ap.add_argument("--eval-only", default=None, help="load this checkpoint and evaluate")
    ap.add_argument("--skip-eval", action="store_true", help="train and save only")
    ap.add_argument("--resume", default=None, help="checkpoint directory to resume from")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save a resumable checkpoint every N epochs")
    args = ap.parse_args(argv)
    if args.y_shift != 0.0 and args.task not in SHIFT_AWARE:
        ap.error(f"--y-shift is only supported for tasks {SHIFT_AWARE}: task {args.task!r}'s "
                 "decode does not invert the shift")
    return args


def main(argv: Optional[List[str]] = None) -> None:
    from ..device import resolve_device
    from ..tasks import TASKS, evaluate, merge_ckpt_config
    from ..train import train_ddpm
    from ..utils import load_checkpoint, save_checkpoint, tree_from_state
    from ..utils.metrics import MetricsLogger

    args = parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    if args.matmul_precision == "highest":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    task = TASKS[args.task]
    data = task.load(args.dataset)
    if args.y_scale != 1.0:
        data.config["y_scale"] = args.y_scale
    if args.y_shift != 0.0:
        data.config["y_shift"] = args.y_shift
    if args.parameterization != "eps":
        data.config["parameterization"] = args.parameterization
    if args.proj_dim:
        data.config["proj_dim"] = args.proj_dim
    if args.dims:
        data.config["dims"] = tuple(args.dims)
    model = task.build_model(data.config)
    log = MetricsLogger(None if args.eval_only else pathlib.Path(args.out) / "train_log.jsonl")

    overrides = {k: v for k, v in
                 [("epochs", args.epochs), ("lr", args.lr), ("seed", args.seed),
                  ("use_ema", args.use_ema or None), ("grad_clip", args.grad_clip),
                  ("parameterization", args.parameterization
                   if args.parameterization != "eps" else None),
                  ("T", args.t_steps),
                  ("milestones", tuple(args.milestones) if args.milestones else None)]
                 if v is not None}
    cfg = dataclasses.replace(task.train_config, **overrides)

    if args.eval_only:
        ck = load_checkpoint(args.eval_only, device=dev)
        params, sched = ck["params"], ck["sched"]
        merge_ckpt_config(data.config, ck.get("metadata"))
    else:
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"training {args.task} on {args.dataset} ({data.X_train.shape[0]} samples, "
              f"device {name})")
        t0 = time.time()
        resume_state = (load_checkpoint(args.resume, device=dev, training=True)
                        if args.resume else None)
        Y_train = ((data.Y_train - args.y_shift) * args.y_scale
                   if (args.y_scale != 1.0 or args.y_shift != 0.0) else data.Y_train)
        params, ema, sched = train_ddpm(
            model, data.X_train, Y_train, cfg,
            log_fn=lambda s: log.log({"event": "train", "msg": s}), log_every=10,
            resume_state=resume_state, checkpoint_every=args.checkpoint_every,
            checkpoint_dir=(str(pathlib.Path(args.out) / "resume")
                            if args.checkpoint_every else None),
            device=dev)
        train_s = time.time() - t0
        dataset_config = {k: (v.item() if hasattr(v, "item") else v)
                          for k, v in data.config.items()}
        save_checkpoint(args.out, params, ema=ema, sched=sched, step=cfg.epochs,
                        metadata={"task": args.task, "dataset": args.dataset,
                                  "config": dataclasses.asdict(cfg),
                                  "dataset_config": dataset_config,
                                  "train_seconds": train_s})
        log.log({"event": "saved", "out": args.out, "train_seconds": train_s})

    if args.skip_eval:
        return
    metrics = evaluate(task, params, sched, data, omega=args.omega)
    print(json.dumps({"task": args.task, "dataset": args.dataset, **metrics}))
    if not args.eval_only and cfg.use_ema:
        ema_metrics = evaluate(task, tree_from_state(ema.params), sched, data, omega=args.omega)
        print(json.dumps({"task": args.task, "params": "ema", **ema_metrics}))


if __name__ == "__main__":
    main()

"""Train the MTFNN or PPO baseline for one task and report its gap metrics.

Counterpart of the JAX package's ``tools/train_baselines.py`` (reference
``baselines/MTFNN.py`` / ``PPO.py`` training entries), with its flags;
``--cpu`` runs on the CPU, and the default is the CUDA card.

    python -m diffsg_tpu_torch.tools.train_baselines mtfnn --task co \\
        --dataset datasets/3nodes_50000samples_new.csv --out build/mtfnn_co
    python -m diffsg_tpu_torch.tools.train_baselines ppo --task nu \\
        --dataset build/datasets/3u_18mW_1000samples.csv --out build/ppo_nu

Recipes (the reference's): MTFNN 50 epochs with the milestone [20] (NU 100
epochs, [20, 60]); PPO MSR 100 epochs [20], CO 200 [20, 100], NU 50 [20]
with the reference's zeroed-state NU reward. The checkpoint goes to
``--out`` in the JAX package's npz layout with its metadata keys (``algo``,
``task``, ``dataset``), and the training log with its ``train_seconds`` to
``--out``/train_log.jsonl.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
from typing import List, Optional

import numpy as np
import torch

from ._cli import add_device_args, device_from_args


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("algo", choices=["mtfnn", "ppo"])
    ap.add_argument("--task", choices=["msr", "co", "nu"], required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    add_device_args(ap)
    return ap.parse_args(argv)


def _nu_unscale(cfg_d):
    """Normalized NU solutions -> the UAV in metres and the powers in mW."""
    def unscale(Y):
        Y = np.array(Y)
        Y[:, 0] *= cfg_d["width"]
        Y[:, 1] *= cfg_d["height"]
        Y[:, 2:] *= cfg_d["P_sum"]
        return Y
    return unscale


def mtfnn_recipe(task: str, cfg_d):
    """(model, the training labels' transform, the predictions' transform to
    physical units, (default epochs, milestones)) of a task (``MTFNN.py``:
    CO/MSR 50 epochs [20], NU 100 epochs [20, 60])."""
    from ..baselines import mtfnn_co_model, mtfnn_msr_model, mtfnn_nu_model

    if task == "msr":           # the softmax head's target: the power shares
        W = cfg_d["W"]
        return mtfnn_msr_model(cfg_d["M"]), lambda Y: Y / W, lambda Y: Y * W, (50, (20,))
    if task == "co":
        return mtfnn_co_model(), lambda Y: Y, lambda Y: Y, (50, (20,))
    # normalized coordinates and powers, the split head
    return mtfnn_nu_model(cfg_d["K"]), lambda Y: Y, _nu_unscale(cfg_d), (100, (20, 60))


def ppo_recipe(task: str, cfg_d):
    """(agent, the training labels' transform, env_fn, the training
    actions' transform, the predictions' transform, (default epochs,
    milestones)) of a task (``PPO.py:89-100, 216-228, 347-361``)."""
    from ..baselines import PPOAgent
    from ..ops import co_cost, nu_decode, nu_rate

    if task == "msr":
        W, mn, mx = cfg_d["W"], cfg_d["scaler_min"], cfg_d["scaler_max"]

        def env_fn(x, act, y):
            g = x * (mx - mn) + mn
            r = torch.log2(1 + act * W * g).sum(dim=1)
            gt = torch.log2(1 + y * W * g).sum(dim=1)
            return 1.0 / (torch.abs(r - gt) + 0.01)

        return (PPOAgent(cfg_d["M"], cfg_d["M"]), lambda Y: Y / W, env_fn,
                lambda a: torch.softmax(a, dim=1), lambda a: torch.softmax(a, dim=1) * W,
                (100, (20,)))
    if task == "co":
        mn, mx = cfg_d["scaler_min"], cfg_d["scaler_max"]

        def env_fn(x, act, y):
            xs = x * (mx - mn) + mn
            return 1.0 / (torch.abs(co_cost(xs, act) - co_cost(xs, y)) + 0.1)

        softmax = lambda a: torch.softmax(a, dim=1)     # noqa: E731
        return (PPOAgent(3 * cfg_d["node_num"], cfg_d["node_num"]), lambda Y: Y, env_fn,
                softmax, softmax, (200, (20, 100)))
    K, P, w, h = cfg_d["K"], cfg_d["P_sum"], cfg_d["width"], cfg_d["height"]

    def env_fn(x, act, y):          # the reference's zeroed state, kept
        real = torch.zeros_like(x)
        return 1.0 / (torch.abs(nu_rate(act, real) - nu_rate(y, real)) + 0.1)

    return (PPOAgent(2 * K, 2 + K), _nu_unscale(cfg_d), env_fn,
            lambda a: nu_decode(torch.softmax(a, dim=1), w, h, P),
            lambda a: nu_decode(a, w, h, P), (50, (20,)))


def main(argv: Optional[List[str]] = None) -> None:
    from ..baselines import MTFNNConfig, PPOConfig, ppo_predict, train_mtfnn, train_ppo
    from ..tasks import TASKS, objective_metrics
    from ..utils import save_checkpoint
    from ..utils.metrics import MetricsLogger

    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS[args.task]
    data = task.load(args.dataset)
    cfg_d = data.config
    log = MetricsLogger(pathlib.Path(args.out) / "train_log.jsonl" if args.out else None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log.log({"event": "start", "algo": args.algo, "task": args.task,
             "rows": int(data.X_train.shape[0]), "device": name})
    log_fn = lambda s: log.log({"event": "train", "msg": s})     # noqa: E731

    t0 = time.time()
    if args.algo == "mtfnn":
        model, labels, unscale, (epochs, milestones) = mtfnn_recipe(args.task, cfg_d)
        cfg = MTFNNConfig(epochs=args.epochs or epochs, milestones=milestones, seed=args.seed)
        params = train_mtfnn(model, data.X_train, labels(data.Y_train), cfg, log_fn=log_fn,
                             device=dev)
        train_s = time.time() - t0
        with torch.inference_mode():
            Y_pred = unscale(model(torch.as_tensor(np.asarray(data.X_test, np.float32),
                                                   device=dev)).cpu().numpy())
    else:
        agent, labels, env_fn, transform, predict_transform, (epochs, milestones) = \
            ppo_recipe(args.task, cfg_d)
        cfg = PPOConfig(epochs=args.epochs or epochs, milestones=milestones, seed=args.seed)
        params, _ = train_ppo(agent, data.X_train, labels(data.Y_train), env_fn, transform,
                              cfg, log_fn=log_fn, device=dev)
        train_s = time.time() - t0
        Y_pred = ppo_predict(agent, data.X_test, predict_transform).cpu().numpy()

    steps = max(data.X_train.shape[0] // min(cfg.batch_size, data.X_train.shape[0]), 1)
    log.log({"event": "trained", "epochs": cfg.epochs, "steps_per_epoch": steps,
             "train_seconds": train_s})
    metrics = objective_metrics(task, data, Y_pred, device=dev)
    print(json.dumps({"algo": args.algo, "task": args.task, **metrics}), flush=True)
    if args.out:
        save_checkpoint(args.out, params,
                        metadata={"algo": args.algo, "task": args.task, "dataset": args.dataset})


if __name__ == "__main__":
    main()

"""Single-sample sampling-latency probe: the mean wall-clock time to sample
one solution (batch 1), and batched throughput for context.

Counterpart of the JAX package's ``tools/latency_probe.py``, with its flags
and JSON keys; ``--cpu`` runs on the CPU (the default is the CUDA card).
The sampler runs the module's own forward (``plain``), as the JAX CLI runs
``model.apply``; each call is waited for before the clock stops.

    python -m diffsg_tpu_torch.tools.latency_probe --task msr --ckpt ckpts/ddpm_msr_3c_T100 \\
        --dataset build/datasets/3c_10w_10000samples.csv
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..diffusion import cfg_sample
from ..models import unet_apply_fn
from ..tasks import TASKS, loaded_model
from ..utils import load_checkpoint
from ._cli import add_device_args, device_from_args


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=["msr", "co", "nu"], required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--omega", type=float, default=500.0)
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--batch", type=int, default=512)
    add_device_args(ap)
    return ap.parse_args(argv)


@torch.inference_mode()
def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    dev = device_from_args(args)
    task = TASKS[args.task]
    data = task.load(args.dataset)
    ck = load_checkpoint(args.ckpt, device=dev)
    apply_fn = unet_apply_fn(loaded_model(task, ck["params"], data.config, dev), "plain")
    D = task.data_dim(data.config)

    def run(cond: torch.Tensor, seed: int) -> None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        cfg_sample(apply_fn, ck["sched"], cond, args.omega, D, generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def cond(n: int) -> torch.Tensor:
        return torch.as_tensor(np.asarray(data.X_test[:n], np.float32), device=dev)

    x1 = cond(1)
    run(x1, 0)   # warm
    t0 = time.perf_counter()
    for i in range(args.repeats):
        run(x1, i)
    single_ms = (time.perf_counter() - t0) * 1000 / args.repeats

    xb = cond(args.batch)
    run(xb, 0)
    t0 = time.perf_counter()
    for i in range(5):
        run(xb, i)
    batch_sps = xb.shape[0] / ((time.perf_counter() - t0) / 5)

    out = {"task": args.task, "omega": args.omega, "T": int(ck["sched"].T),
           "single_sample_ms": round(single_ms, 3),
           "batched_solutions_per_sec": round(batch_sps, 1), "batch": args.batch,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

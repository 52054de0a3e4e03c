"""Profile one warm call of the CFG sampler with ``torch.profiler``.

Counterpart of the JAX package's ``tools/profile_sampler.py``, with its
flags (``--backend xla`` is the port's ``plain`` forward, ``pallas`` its
``fused`` one); ``--cpu`` runs on the CPU (the default is the CUDA card).
The net is the task's UNet1D with ``train.torch_style_init`` weights from a
seeded generator, the schedule ``cosine_schedule(T)``, the conditions
uniform from ``np.random.default_rng(0)``. After one untimed call, a second
runs under ``torch.profiler`` (CPU and CUDA activities); the Chrome trace
goes to ``<out>/trace.json`` (open it in Perfetto or chrome://tracing), and
the device operations that took the most time (name, count, total ms) are
printed as one JSON line.

    python -m diffsg_tpu_torch.tools.profile_sampler --task msr --T 100 --batch 8192 \\
        --backend pallas --out build/diffsg_trace
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..diffusion import cfg_sample, cosine_schedule
from ..models import unet_apply_fn, unet_co, unet_msr, unet_nu
from ..train import torch_style_init
from ._cli import add_device_args, device_from_args

#: The JAX CLI's backend names and the port's forwards they map to.
BACKENDS = {"xla": "plain", "pallas": "fused"}
#: task -> (net, D, C)
NETS = {"msr": (lambda: unet_msr(3), 3, 3), "co": (lambda: unet_co(3), 3, 9),
        "nu": (lambda: unet_nu(3), 5, 6)}
TOP = 10


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", choices=list(NETS), default="msr")
    ap.add_argument("--T", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--omega", type=float, default=500.0)
    ap.add_argument("--out", default="build/diffsg_trace")
    ap.add_argument("--backend", choices=list(BACKENDS), default="xla")
    add_device_args(ap)
    return ap.parse_args(argv)


def device_ops(prof, device: torch.device) -> List[Dict]:
    """The profiled operations that ran on ``device``, by total time: CUDA
    kernels and copies on a card (their device time), operators on the CPU
    (their own CPU time). Each: name, count, total_ms."""
    rows = []
    for e in prof.key_averages():
        if device.type == "cuda":
            on_device = e.device_type == torch.autograd.DeviceType.CUDA
            us = e.self_device_time_total
        else:
            on_device, us = True, e.self_cpu_time_total
        if on_device and us > 0:
            rows.append({"name": e.key, "count": int(e.count), "total_ms": us / 1e3})
    return sorted(rows, key=lambda r: -r["total_ms"])


@torch.inference_mode()
def profile(task: str, T: int, batch: int, omega: float, out: str, backend: str,
            device: DeviceLike = "cuda", seed: int = 0) -> Dict:
    """Profile ``cfg_sample`` on ``backend``'s forward (any
    ``unet_apply_fn`` backend); returns the trace's path and every device
    operation (``device_ops``)."""
    dev = resolve_device(device)
    make, D, C = NETS[task]
    model = make()
    with torch.no_grad():
        torch_style_init(model, torch.Generator().manual_seed(seed))
    apply_fn = unet_apply_fn(model.to(dev).eval(), backend)
    sched = cosine_schedule(T, device=dev)
    cond = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (batch, C)), dtype=torch.float32,
                           device=dev)

    def run(key: int) -> torch.Tensor:
        gen = torch.Generator(device=dev).manual_seed(key)
        return cfg_sample(apply_fn, sched, cond, omega, D, generator=gen)

    run(1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        run(2)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    path = pathlib.Path(out) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return {"trace": str(path), "task": task, "T": T, "batch": batch, "backend": backend,
            "ops": device_ops(prof, dev)}


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    dev = device_from_args(args)
    res = profile(args.task, args.T, args.batch, args.omega, args.out, BACKENDS[args.backend],
                  dev)
    print(f"trace written to {res['trace']}")
    print(json.dumps({"backend": res["backend"], "top_device_ops": res["ops"][:TOP]}),
          flush=True)
    return res


if __name__ == "__main__":
    main()

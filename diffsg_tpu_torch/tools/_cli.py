"""What the port's training CLIs share: the device flags, the reference
repository's dataset paths, the ``datasets/`` files a run reads (made where
missing), ``TrainConfig`` overrides, the timed and logged training run, and
the eval loop's JSON lines."""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

#: The reference DiffSG repository's datasets (its 3-channel MSR, 18 mW and
#: 30 mW NU and CO OOD splits), which the JAX package's CLIs default to and
#: this repository does not hold: ``$DIFFSG_REFERENCE_PATH/datasets``, by
#: default ``reference/datasets`` under the working directory.
REFERENCE_DATASETS = os.path.join(os.environ.get("DIFFSG_REFERENCE_PATH", "reference"),
                                  "datasets")


def reference_csv(name: str) -> str:
    return os.path.join(REFERENCE_DATASETS, name)


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")


def device_from_args(args: argparse.Namespace) -> torch.device:
    """The run's device: the card unless ``--cpu`` (raises without a card).
    Both TF32 switches go off: float32 products, as the JAX CLIs' "highest"
    matmul precision."""
    from ..device import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def ensure_inputs(paths: Iterable[Optional[str]]) -> None:
    """Make each missing file of ``paths`` whose name has a recipe in
    ``data.datasets.KNOWN_DATASETS``, where the path names it (``datasets/``
    is not committed)."""
    from ..data.datasets import KNOWN_DATASETS, ensure_datasets

    for p in paths:
        if p and os.path.basename(p) in KNOWN_DATASETS:
            ensure_datasets([os.path.basename(p)], root=os.path.dirname(p) or ".")


def read_rows(path: str, cols: int) -> np.ndarray:
    """A headerless CSV of ``cols`` columns as float64 rows (``np.loadtxt``,
    as the port's loaders read)."""
    from ..data.loaders import _read_csv

    raw = _read_csv(path)
    if raw.ndim != 2 or raw.shape[1] != cols:
        raise ValueError(f"{path}: expected {cols} columns, got shape {raw.shape}")
    return raw


def overrides(**fields: Any) -> Dict[str, Any]:
    """The ``TrainConfig`` fields that were given (not None)."""
    return {k: v for k, v in fields.items() if v is not None}


def train_and_save(out: str, model, X: np.ndarray, Y: np.ndarray, cfg, dev: torch.device,
                   metadata: Dict[str, Any], init_params=None, log_every: int = 25):
    """``train_ddpm`` on ``dev`` with its log in ``out/train_log.jsonl``,
    then ``save_checkpoint(out, ...)`` with ``step`` the epoch count and
    ``metadata`` plus the run's ``train_seconds``. Returns (params, sched)."""
    from ..train import train_ddpm
    from ..utils import save_checkpoint
    from ..utils.metrics import MetricsLogger

    log = MetricsLogger(pathlib.Path(out) / "train_log.jsonl")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log.log({"event": "start", "rows": int(X.shape[0]), "device": name})
    t0 = time.time()
    params, ema, sched = train_ddpm(model, X, Y, cfg, init_params=init_params,
                                    log_every=log_every,
                                    log_fn=lambda s: log.log({"event": "train", "msg": s}),
                                    device=dev)
    train_s = time.time() - t0
    save_checkpoint(out, params, ema=ema, sched=sched, step=cfg.epochs,
                    metadata={**metadata, "train_seconds": train_s})
    log.log({"event": "saved", "out": out, "train_seconds": train_s})
    return params, sched


def print_evals(task, params, sched, data, omegas, **fields) -> None:
    """``evaluate`` at each omega, one JSON line each."""
    from ..tasks import evaluate

    for om in omegas:
        m = evaluate(task, params, sched, data, omega=om)
        print(json.dumps({**fields, "task": task.name, "omega": om, **m}), flush=True)


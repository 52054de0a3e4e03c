"""Save and load ``diffsg_tpu.npz.v1`` checkpoints.

Counterpart of ``diffsg_tpu/utils/checkpoint.py``. A checkpoint directory
holds ``arrays.npz`` (flat ``params/...``, ``ema/params/...`` and
``ema/n_averaged``, ``opt/...``, ``schedule/betas`` (float64) and ``step``)
and ``metadata.json`` (with ``"format": "diffsg_tpu.npz.v1"``). Keys are flax
paths joined with ``/``; the optimizer state sits under optax's own keys
(``train.trainer.Optimizer.export_state``), so either package resumes the
other's checkpoints. Serving reads the live ``params`` only; the EMA and
optimizer state are loaded when asked for (``training=True``).
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike
from ..diffusion.schedule import Schedule, schedule_from_betas
from ..train.ema import EmaState
from .params import params_from_jax, tree_from_state


def _flatten(tree: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, val in tree.items():
        key = f"{prefix}{name}"
        if isinstance(val, dict):
            out.update(_flatten(val, key + "/"))
        elif isinstance(val, torch.Tensor):
            out[key] = val.detach().cpu().numpy()
        else:
            out[key] = np.asarray(val)
    return out


def save_checkpoint(directory: str, params: Dict[str, Any], ema: Optional[EmaState] = None,
                    opt_state: Optional[Dict[str, Any]] = None, step: int = 0,
                    sched: Optional[Schedule] = None, metadata: Optional[Dict] = None) -> str:
    """Save a training or serving checkpoint; returns the directory.

    ``params`` is the flax tree (``utils.params.params_to_jax``), ``ema``
    an :class:`EmaState` and ``opt_state`` the optimizer state in optax's
    layout (nested dicts of arrays).
    """
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    arrays = _flatten(params, "params/")
    if ema is not None:
        arrays.update(_flatten(tree_from_state(ema.params), "ema/params/"))
        arrays["ema/n_averaged"] = np.asarray(ema.n_averaged, dtype=np.int32)
    if opt_state is not None:
        arrays.update(_flatten(opt_state, "opt/"))
    if sched is not None:
        arrays["schedule/betas"] = sched.betas.detach().cpu().double().numpy()
    arrays["step"] = np.asarray(step)
    np.savez_compressed(d / "arrays.npz", **arrays)

    meta = dict(metadata or {})
    meta["format"] = "diffsg_tpu.npz.v1"
    with open(d / "metadata.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return str(d)


def _unflatten_group(arrays: Dict[str, np.ndarray], prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in arrays.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def load_checkpoint(directory: str, device: DeviceLike = "cuda",
                    training: bool = False) -> Dict[str, Any]:
    """Load a checkpoint directory.

    Returns a dict with ``params`` (the flax tree as nested dicts of NumPy
    arrays; carry it into a model with ``utils.params.params_from_jax``),
    ``step``, ``metadata`` and, when the checkpoint records its betas,
    ``sched`` (a :class:`Schedule` on ``device``). With ``training``, also
    ``ema`` (an :class:`EmaState` of float32 CPU tensors) and
    ``opt_state_raw`` (the ``opt/`` arrays as nested dicts, optax's keys)
    where the checkpoint holds them: what ``train.restore_train_state``
    resumes from.
    """
    d = pathlib.Path(directory)
    with np.load(d / "arrays.npz") as data:
        names = [k for k in data.files
                 if training or k.startswith("params/") or k in ("schedule/betas", "step")]
        arrays = {k: data[k] for k in names}
    meta_path = d / "metadata.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}

    out = {
        "params": _unflatten_group(arrays, "params/"),
        "step": int(arrays.get("step", np.array(0))),
        "metadata": meta,
    }
    if "schedule/betas" in arrays:
        out["sched"] = schedule_from_betas(arrays["schedule/betas"], device=device)
    if any(k.startswith("ema/params/") for k in arrays):
        out["ema"] = EmaState(params_from_jax(_unflatten_group(arrays, "ema/params/")),
                              int(arrays.get("ema/n_averaged", np.array(0))))
    if any(k.startswith("opt/") for k in arrays):
        out["opt_state_raw"] = _unflatten_group(arrays, "opt/")
    return out

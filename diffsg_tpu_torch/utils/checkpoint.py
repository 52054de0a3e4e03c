"""Read-only loader for ``diffsg_tpu.npz.v1`` checkpoints.

Counterpart of ``diffsg_tpu/utils/checkpoint.py::load_checkpoint``. A
checkpoint directory holds ``arrays.npz`` (flat ``params/...``,
``ema/params/...``, ``opt/...``, ``schedule/betas`` (float64) and ``step``)
and ``metadata.json``. Serving reads the live ``params`` only, so EMA and
optimizer state are not loaded.
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Dict

import numpy as np

from ..device import DeviceLike
from ..diffusion.schedule import schedule_from_betas


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


def load_checkpoint(directory: str, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Load a checkpoint directory.

    Returns a dict with ``params`` (the flax tree as nested dicts of NumPy
    arrays; carry it into a model with ``utils.params.params_from_jax``),
    ``step``, ``metadata`` and, when the checkpoint records its betas,
    ``sched`` (a :class:`Schedule` on ``device``).
    """
    d = pathlib.Path(directory)
    with np.load(d / "arrays.npz") as data:
        names = [k for k in data.files
                 if k.startswith("params/") or k in ("schedule/betas", "step")]
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
    return out

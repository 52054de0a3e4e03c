"""Carry a flax parameter tree into the port's modules, and back.

The port's modules keep flax's names and layouts (``models/unet1d.py``):
``Dense`` holds ``kernel`` of shape **(in, out)** and ``bias`` (out,);
``LayerNorm`` holds ``scale`` and ``bias``; submodules are named as in flax
(``down_{i}``, ``up_{i}``, ``middle.res1``, ...). A state-dict key is the
flax path joined with dots, so the mapping is one-to-one and needs no
transposes. The baselines keep flax's names as well: the MTFNN ``MLP``'s
``lin1..linN`` and ``PPOAgent``'s ``critic/{0,2,4,6}``, ``actor/{0,2,4,6}``
and ``log_std`` (1, A).

The (in, out) layout is also the one the fused residual-block kernel
(``csrc/resblock.cu``) reads: element ``W[k, j]`` lies at ``k * out + j``, so
neighbouring threads, which own neighbouring output columns ``j``, read
neighbouring addresses.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a flax params tree (nested dicts of arrays) into a state dict
    of float32 CPU tensors for ``module.load_state_dict(..., strict=True)``."""
    state: Dict[str, torch.Tensor] = {}
    for name, val in tree.items():
        key = f"{prefix}{name}"
        if isinstance(val, dict):
            state.update(params_from_jax(val, key + "."))
        else:
            state[key] = torch.from_numpy(np.array(val, dtype=np.float32))
    return state


def tree_from_state(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`params_from_jax`: a state dict (dotted names)
    -> the flax tree of nested dicts of float32 NumPy arrays."""
    tree: Dict[str, Any] = {}
    for key, val in state.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().to(device="cpu", dtype=torch.float32).numpy().copy()
    return tree


def params_to_jax(module: torch.nn.Module) -> Dict[str, Any]:
    """``module``'s parameters as the flax tree ``save_checkpoint`` and
    ``params_from_jax`` take (float32 NumPy; no transposes, the layouts are
    flax's)."""
    return tree_from_state(module.state_dict())

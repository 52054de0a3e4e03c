"""Multi-task DiffSG: one denoiser that solves MSR, CO and NU.

Counterpart of ``diffsg_tpu/tasks/multi.py``. The solution spaces share one
``canvas_dim``-wide canvas (shorter tasks zero-padded) and the condition
is ``[task one-hot (n_slots) | payload (payload_dim, zero-padded)]``: the
task's identity enters only through the condition. Each face wraps a
specialist task and reuses its loader, decode, objective, metrics and
refinement projection:

* ``build_model`` returns a :class:`_CondAdapter` holding the shared net as
  ``inner``: it writes the one-hot and zero-pads the face's condition into
  the shared one before the net;
* ``data_dim`` is the canvas width, so the reverse chain runs on the whole
  canvas (its pad columns were trained toward zero labels);
* ``decode`` / ``decode_with_x`` crop the sampled canvas to the
  specialist's columns before the specialist's decode.

The faces of one checkpoint share its weights; the per-subtask label
transforms live in its metadata under ``subtask_configs``, and
:func:`merge_multi_config` (or ``serve.Solver.from_checkpoint``) merges
them into a config.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models.unet1d import UNet1D
from .co import CO_RANKED
from .msr import MSR_BUDGET, MSR_WF
from .nu import NU_BUDGET, NU_GEO

#: Shared solution canvas = max task dim (NU's 2+K=5; MSR-3c and CO pad up).
#: Checkpoint-overridable via the ``canvas_dim`` config key (multi-80: 80).
D_UNI = 5
#: Condition payload width = max specialist cond dim (CO's 3N=9);
#: checkpoint-overridable via ``payload_dim`` (multi-80: 81 = gains + W).
PAYLOAD = 9
#: Default one-hot slot order (the first condition columns);
#: checkpoint-overridable via ``slots`` (multi-80 appends "msr80", "msr8").
SLOTS = ("msr", "co", "nu")
COND_UNI = len(SLOTS) + PAYLOAD


def unet_multi(proj_dim: int = 128, dims=(64, 32, 16, 8), canvas_dim: int = D_UNI,
               payload_dim: int = PAYLOAD, n_slots: int = len(SLOTS)) -> UNet1D:
    """The shared denoiser: MSR's architecture over the shared canvas and
    the [one-hot | payload] condition."""
    return UNet1D(input_dim=canvas_dim, proj_dim=proj_dim, cond_dim=n_slots + payload_dim,
                  dims=tuple(dims), is_attn=(False,) * len(dims), middle_attn=False,
                  n_blocks=2)


def embed_cond_np(X: np.ndarray, slot: str, slots=SLOTS,
                  payload_dim: int = PAYLOAD) -> np.ndarray:
    """Host-side condition embedding for training: [one-hot | payload | 0s]."""
    i = tuple(slots).index(slot)
    n, c = X.shape
    assert c <= payload_dim, f"payload {c} exceeds {payload_dim}"
    one = np.zeros((n, len(slots)), X.dtype)
    one[:, i] = 1.0
    return np.concatenate([one, X, np.zeros((n, payload_dim - c), X.dtype)], axis=1)


def embed_y_np(Y: np.ndarray, canvas_dim: int = D_UNI) -> np.ndarray:
    """Host-side label embedding: zero-pad to the shared canvas."""
    n, d = Y.shape
    assert d <= canvas_dim, f"solution dim {d} exceeds {canvas_dim}"
    return np.concatenate([Y, np.zeros((n, canvas_dim - d), Y.dtype)], axis=1)


class _CondAdapter(nn.Module):
    """A face's view of the shared net ``inner``: ``forward(y, t, cond,
    cond_mask)`` pads the face's (B, payload_dim) condition into the shared
    ``[one-hot | payload | 0s]`` layout and runs ``inner``; the CFG mask
    then zeroes the whole padded condition, one-hot included, as in the JAX
    package. The checkpoint's params are ``inner``'s.

    ``models.unet1d_fused.unet_apply_fn`` recognises the adapter and runs
    ``pad_cond`` before the chosen backend's forward of ``inner``.
    """

    def __init__(self, inner: UNet1D, slot_idx: int, payload_dim: int,
                 n_slots: int = len(SLOTS), payload_total: int = PAYLOAD):
        super().__init__()
        if payload_dim > payload_total:
            raise ValueError(f"payload {payload_dim} exceeds {payload_total}")
        self.inner = inner
        self.slot_idx = slot_idx
        self.payload_dim = payload_dim
        self.n_slots = n_slots
        self.payload_total = payload_total

    def pad_cond(self, cond: torch.Tensor) -> torch.Tensor:
        """(B, payload_dim) -> (B, n_slots + payload_total). A zeros tensor
        and two fills on the condition's device: no host copy, so it can be
        captured in a CUDA graph."""
        out = cond.new_zeros((cond.shape[0], self.n_slots + self.payload_total))
        out[:, self.slot_idx] = 1.0
        out[:, self.n_slots:self.n_slots + self.payload_dim] = cond
        return out

    def forward(self, y, t, cond, cond_mask):
        return self.inner(y, t, self.pad_cond(cond), cond_mask)


def _wrap(sub, slot: str, name: Optional[str] = None):
    """The multi-task face of specialist ``sub`` at one-hot ``slot``;
    ``name`` overrides the registry key where one slot has several payload
    layouts (the NU slot's budget and geometry payloads). Canvas width,
    payload width and slot list come from the config (``canvas_dim``,
    ``payload_dim``, ``slots``), defaulting to the 5-wide layout."""

    def build_model(cfg: Dict) -> _CondAdapter:
        slots = tuple(cfg.get("slots", SLOTS))
        payload = int(cfg.get("payload_dim", PAYLOAD))
        inner = unet_multi(cfg.get("proj_dim", 128), tuple(cfg.get("dims", (64, 32, 16, 8))),
                           canvas_dim=int(cfg.get("canvas_dim", D_UNI)), payload_dim=payload,
                           n_slots=len(slots))
        return _CondAdapter(inner, slots.index(slot), sub.cond_dim(cfg), n_slots=len(slots),
                            payload_total=payload)

    # The crop is a view of the canvas: contiguous before the specialist's
    # decode. valid_mask is passed on only when set, as the JAX package does.
    def decode(Y_raw, cfg, valid_mask=None):
        kw = {} if valid_mask is None else {"valid_mask": valid_mask}
        return sub.decode(Y_raw[:, :sub.data_dim(cfg)].contiguous(), cfg, **kw)

    decode_with_x = None
    if sub.decode_with_x is not None:
        def decode_with_x(Y_raw, X_unnorm, cfg, valid_mask=None):
            kw = {} if valid_mask is None else {"valid_mask": valid_mask}
            return sub.decode_with_x(Y_raw[:, :sub.data_dim(cfg)].contiguous(), X_unnorm, cfg,
                                     **kw)

    return dataclasses.replace(
        sub, name=name or f"multi_{slot}", build_model=build_model,
        data_dim=lambda cfg: int(cfg.get("canvas_dim", D_UNI)),
        decode=decode, decode_with_x=decode_with_x)


#: The faces. MSR decodes as ``msr_wf``, CO as ``co_ranked``, NU as
#: ``nu_budget`` (payload ``[coords (2K) | P_sum / p_ref]``).
MULTI_MSR = _wrap(MSR_WF, "msr")
MULTI_CO = _wrap(CO_RANKED, "co")
MULTI_NU = _wrap(NU_BUDGET, "nu")
#: The NU slot with the whole ``nu_geo`` condition ``[coords (2K) | P/p_ref
#: | W/w_ref | H/h_ref]``: any budget on any rectangle. A checkpoint is
#: trained for one NU payload or the other (``subtask_configs["nu_geo"]``
#: or ``["nu"]``). Its decode takes and ignores ``valid_mask`` (the JAX
#: package's takes none, so its bucketed Solver raises for this face).
MULTI_NU_GEO = _wrap(NU_GEO, "nu", name="multi_nu_geo")
#: MSR-80c on the 80-wide canvas, W-conditioned (payload ``[gains (M) |
#: W / w_ref]``), for checkpoints whose ``slots`` include "msr80".
MULTI_MSR80 = _wrap(MSR_BUDGET, "msr80")
#: MSR-8c, the same recipe at M = 8, zero-padded into the condition.
MULTI_MSR8 = _wrap(MSR_BUDGET, "msr8")

MULTI_TASKS = {"multi_msr": MULTI_MSR, "multi_co": MULTI_CO, "multi_nu": MULTI_NU,
               "multi_nu_geo": MULTI_NU_GEO, "multi_msr80": MULTI_MSR80,
               "multi_msr8": MULTI_MSR8}

#: Config keys owned by the multi checkpoint: the shared architecture
#: (metadata ``arch``) and each subtask's label transforms
#: (``subtask_configs[slot]``).
_ARCH_KEYS = ("proj_dim", "dims", "canvas_dim", "payload_dim", "slots")
_LABEL_KEYS = ("y_scale", "y_shift", "parameterization")


def merge_multi_config(config: Dict, metadata: Optional[Dict], slot: str) -> Dict:
    """Copy the multi checkpoint's architecture keys and the ``slot``
    subtask's label-transform keys into a freshly loaded dataset config
    (the multi-task ``tasks.base.merge_ckpt_config``)."""
    md = metadata or {}
    sub_cfg = (md.get("subtask_configs") or {}).get(slot) or {}
    arch = md.get("arch") or {}
    for k in _ARCH_KEYS:
        if k in arch:
            config[k] = arch[k]
    for k in _LABEL_KEYS:
        if k in sub_cfg:
            config[k] = sub_cfg[k]
    return config

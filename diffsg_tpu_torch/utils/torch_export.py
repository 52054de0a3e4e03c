"""Write a reference torch DDPM checkpoint (``.pt``) from the port.

Counterpart of ``diffsg_tpu/utils/torch_export.py`` and the inverse of
``utils/torch_import.py``: a net trained here saves as a ``torch.save``
state dict that loads strictly into the reference DDPM classes
(``classifier_free_*.py``: a DDPM with a ``UNetCF.UNet1D`` model), with the 8
schedule buffers, ``model.*``, ``ema.n_averaged`` and ``ema.module.*``. The
conversion:

* ``Dense.kernel`` (in, out) -> ``nn.Linear.weight`` (out, in): transposed;
* ``LayerNorm.scale`` -> ``nn.LayerNorm.weight``;
* ``down_3.res...`` -> ``down.3.res...`` (a ModuleList index).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..diffusion.schedule import Schedule
from ..train.ema import EmaState
from .params import params_from_jax, tree_from_state

_LIST_MODULES = ("down", "up")
_SCHEDULE_BUFFERS = ("betas", "alphas", "alphas_cumprod", "sqrt_alphas_cumprod",
                     "sqrt_one_minus_alphas_cumprod", "reciprocal_sqrt_alphas",
                     "remove_noise_coeff", "sqrt_betas")


def _torch_path(port_path: str) -> str:
    """``down_3.res.lin1`` -> ``down.3.res.lin1``."""
    parts = []
    for name in port_path.split("."):
        head, _, idx = name.partition("_")
        parts.extend([head, idx] if head in _LIST_MODULES and idx.isdigit() else [name])
    return ".".join(parts)


def unet_params_to_torch(params: Dict[str, Any], prefix: str = "model."
                         ) -> Dict[str, np.ndarray]:
    """A flax UNet1D params tree -> reference state-dict entries (NumPy)."""
    out: Dict[str, np.ndarray] = {}
    for key, val in params_from_jax(params).items():
        path, _, leaf = key.rpartition(".")
        name = f"{prefix}{_torch_path(path)}"
        if leaf == "kernel":
            out[f"{name}.weight"] = val.numpy().T
        elif leaf == "scale":
            out[f"{name}.weight"] = val.numpy()
        elif leaf == "bias":
            out[f"{name}.bias"] = val.numpy()
        else:
            raise ValueError(f"unexpected leaf {leaf!r} in {key!r}")
    return out


def ddpm_to_torch(path: str, params: Dict[str, Any], sched: Schedule,
                  ema: Optional[EmaState] = None) -> str:
    """Write a reference-compatible DDPM checkpoint to ``path``; returns it.
    ``params`` is the flax tree; the EMA defaults to a copy of ``params``
    with ``n_averaged`` 0, as a freshly made ``AveragedModel``."""
    sd: Dict[str, torch.Tensor] = {}
    for name in _SCHEDULE_BUFFERS:
        sd[name] = getattr(sched, name).detach().to(device="cpu", dtype=torch.float32).clone()
    for k, v in unet_params_to_torch(params, "model.").items():
        sd[k] = torch.tensor(v, dtype=torch.float32)
    ema_params = params if ema is None else tree_from_state(ema.params)
    sd["ema.n_averaged"] = torch.tensor(0 if ema is None else int(ema.n_averaged),
                                        dtype=torch.long)
    for k, v in unet_params_to_torch(ema_params, "ema.module.").items():
        sd[k] = torch.tensor(v, dtype=torch.float32)
    torch.save(sd, path)
    return path

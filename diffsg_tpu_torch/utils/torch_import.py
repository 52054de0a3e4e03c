"""Read a reference torch DDPM checkpoint (``.pt``) into the port.

Counterpart of ``diffsg_tpu/utils/torch_import.py::ddpm_from_torch``. The
reference ships ``state_dict`` files holding 8 schedule buffers, the live
net under ``model.*`` and an EMA copy under ``ema.module.*`` (with
``ema.n_averaged``). The conversion:

* ``nn.Linear.weight`` (out, in) -> ``Dense.kernel`` (in, out): transposed;
* ``nn.LayerNorm.weight`` -> ``LayerNorm.scale``;
* ``down.3.res...`` (a ModuleList index) -> ``down_3.res...``.

Files are read with ``torch.load(weights_only=True)``: a checkpoint is data,
never code.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike
from ..diffusion.schedule import Schedule, schedule_from_betas

_LIST_MODULES = ("down", "up")


def _port_key(torch_key: str) -> str:
    """``down.3.res.lin1`` -> ``down_3.res.lin1`` (the port's module path)."""
    tokens, out, i = torch_key.split("."), [], 0
    while i < len(tokens):
        if tokens[i] in _LIST_MODULES and i + 1 < len(tokens) and tokens[i + 1].isdigit():
            out.append(f"{tokens[i]}_{tokens[i + 1]}")
            i += 2
        else:
            out.append(tokens[i])
            i += 1
    return ".".join(out)


def unet_state_from_torch(sd: Dict[str, torch.Tensor], prefix: str = "model."
                          ) -> Dict[str, torch.Tensor]:
    """The UNet1D entries under ``prefix`` as a state dict of float32 CPU
    tensors for ``UNet1D.load_state_dict(..., strict=True)``."""
    state: Dict[str, torch.Tensor] = {}
    for key, val in sd.items():
        if not key.startswith(prefix):
            continue
        path, _, leaf = _port_key(key[len(prefix):]).rpartition(".")
        val = val.detach().to(torch.float32).cpu()
        if leaf == "weight":
            if val.dim() == 2:                       # Linear
                state[f"{path}.kernel"] = val.t().contiguous()
            else:                                    # LayerNorm
                state[f"{path}.scale"] = val.clone()
        elif leaf == "bias":
            state[f"{path}.bias"] = val.clone()
        else:
            raise ValueError(f"unexpected leaf {leaf!r} in {key!r}")
    return state


def ddpm_from_torch(pt_path: str, device: DeviceLike = "cuda"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], Schedule, int]:
    """Load a reference DDPM checkpoint -> (state, ema_state, Schedule on
    ``device``, n_averaged). ``state`` is the live ``model.*`` net, which
    serving reads, as ``Solver.from_torch_checkpoint`` does in the JAX
    package."""
    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    sched = schedule_from_betas(sd["betas"].double().numpy().astype(np.float64), device=device)
    n_averaged = int(sd["ema.n_averaged"]) if "ema.n_averaged" in sd else 0
    return (unet_state_from_torch(sd, "model."), unet_state_from_torch(sd, "ema.module."),
            sched, n_averaged)

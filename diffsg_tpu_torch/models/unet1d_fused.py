"""UNet1D forward with every ResidualBlock through the fused kernel.

Counterpart of ``diffsg_tpu/models/unet1d_pallas.py::unet_forward_pallas``.
It runs the parameters of a :class:`models.unet1d.UNet1D`. The cheap parts
stay in PyTorch as the JAX package left them to XLA: the time MLP (at the
batch of ``t``, 1 in the sampler), the feature projection, the resamples,
the skip concats, the final head, and each block's time and condition
projections ``t_proj = swish(t_emb) @ W_t + b_t`` and
``c_proj = swish(cond * mask) @ W_c + b_c``.

Use ``unet_apply_fn(model, backend="fused")`` for the sampler's
``apply_fn(y, t, cond, cond_mask)``; ``backend="mega"`` runs the whole
forward as one launch of the whole-network kernel (``ops/mega.py``), and
``backend="plain"`` the module's own forward (in bfloat16, the counterpart of
the JAX package's ``xla_bf16`` backend).
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from .unet1d import UNet1D, swish
from ..ops.mega import pack_params, unet_forward_mega
from ..ops.resblock import fused_residual_block, resblock_params_tuple

ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def unet_forward_fused(model: UNet1D, y: torch.Tensor, t: torch.Tensor,
                       cond: torch.Tensor, cond_mask: torch.Tensor) -> torch.Tensor:
    """Full UNet1D forward with fused residual blocks. float32 only, as the
    JAX kernel (``pallas_kernels.py:67`` refuses bfloat16)."""
    for name, a in (("y", y), ("t", t), ("cond", cond), ("cond_mask", cond_mask),
                    ("the weights", model.feature_proj.kernel)):
        if a.dtype != torch.float32:
            raise TypeError(f"the fused backend computes in float32 only; {name} is {a.dtype}")
    st = swish(model.time_emb(t))          # (Bt, 4*proj), shared by every block
    sc = swish(cond * cond_mask)           # (B, cond_dim)

    def run_block(res, x: torch.Tensor) -> torch.Tensor:
        return fused_residual_block(x, res.time_emb(st), res.cond_emb(sc),
                                    *resblock_params_tuple(res))

    x = model.feature_proj(y)
    h = [x]
    for kind, m in zip(model.down_kinds, model.down):
        x = run_block(m.res, x) if kind == "block" else m(x)
        h.append(x)

    x = run_block(model.middle.res1, x)
    x = run_block(model.middle.res2, x)

    for kind, m in zip(model.up_kinds, model.up):
        if kind == "resample":
            x = m(x)
        else:
            x = run_block(m.res, torch.cat([x, h.pop()], dim=1))

    return model.final(swish(model.norm(x)))


def unet_apply_fn(model: UNet1D, backend: str = "fused",
                  compute_dtype: Optional[torch.dtype] = None) -> ApplyFn:
    """``apply_fn(y, t, cond, cond_mask)`` for the sampler.

    backend: "plain" (the module's own forward), "fused" (every residual
    block through ``ops.resblock.fused_residual_block``, float32 only) or
    "mega" (the whole forward through ``ops.mega.unet_forward_mega``; its
    weights are packed once, here, in ``compute_dtype``, else in the model's
    own type).

    ``compute_dtype`` (``torch.bfloat16``) is taken by "mega", which then
    returns float32, and by "plain", which then runs a bfloat16 copy of the
    module (``model`` itself is never cast) on inputs cast to bfloat16 and
    returns bfloat16, as flax does with bfloat16 params and inputs. A
    bfloat16 copy of the model passed as ``model`` gives the same: "mega"
    then follows its inputs' type and returns bfloat16 for bfloat16 inputs.
    "fused" raises on bfloat16, as the JAX kernel does.

    A multi-task face's condition adapter (``tasks.multi._CondAdapter``,
    the module with ``inner`` and ``pad_cond``) runs as ``pad_cond`` and
    then the backend's forward of ``adapter.inner``.
    """
    if hasattr(model, "pad_cond"):
        inner = unet_apply_fn(model.inner, backend, compute_dtype)
        return lambda y, t, c, m: inner(y, t, model.pad_cond(c), m)
    if backend == "mega":
        packed = pack_params(model, compute_dtype)
        return lambda y, t, c, m: unet_forward_mega(model, y, t, c, m, compute_dtype, packed)
    if backend == "plain":
        if compute_dtype is None:
            return model
        if compute_dtype != torch.bfloat16:
            raise TypeError(f"the plain backend computes in float32 or bfloat16, not "
                            f"{compute_dtype}")
        low = copy.deepcopy(model).to(compute_dtype)
        return lambda y, t, c, m: low(y.to(compute_dtype), t.to(compute_dtype),
                                      c.to(compute_dtype), m.to(compute_dtype))
    if backend == "fused":
        if compute_dtype is not None:
            raise TypeError(f"the fused backend computes in float32 only, as the JAX kernel "
                            f"does; compute_dtype {compute_dtype} is taken by 'mega' and 'plain'")
        return lambda y, t, c, m: unet_forward_fused(model, y, t, c, m)
    raise ValueError(f"unknown backend {backend!r}; use 'plain', 'fused' or 'mega'")

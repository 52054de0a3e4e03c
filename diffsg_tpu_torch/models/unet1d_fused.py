"""UNet1D forward with every ResidualBlock through the fused kernel.

Counterpart of ``diffsg_tpu/models/unet1d_pallas.py::unet_forward_pallas``.
It runs the parameters of a :class:`models.unet1d.UNet1D`. The cheap parts
stay in PyTorch as the JAX package left them to XLA: the time MLP (at the
batch of ``t``, 1 in the sampler), the feature projection, the resamples,
the skip concats, the final head, and each block's time and condition
projections ``t_proj = swish(t_emb) @ W_t + b_t`` and
``c_proj = swish(cond * mask) @ W_c + b_c``. Neither projection depends on
the state ``y``: the sampler's prepared path (:class:`FusedApplyFn`)
computes the condition projections once a sampler call and keeps the time
projections of every step in a table.

Use ``unet_apply_fn(model, backend="fused")`` for the sampler's
``apply_fn(y, t, cond, cond_mask)``; ``backend="mega"`` runs the whole
forward as one launch of the whole-network kernel (``ops/mega.py``), and
``backend="plain"`` the module's own forward (in bfloat16, the counterpart of
the JAX package's ``xla_bf16`` backend), and ``backend="pair"`` the
shared-prefix CFG-pair forward (:func:`unet_forward_cfg_pair`, JAX's
``xla_pair``).
"""

from __future__ import annotations

import copy
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import obs
from .unet1d import ResidualBlock, UNet1D, swish
from ..ops.mega import pack_params, unet_forward_mega
from ..ops.resblock import fused_residual_block, resblock_params_tuple
from ..parallel.mesh import sharded_names

ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# projections(k, res) -> (t_proj, c_proj) of the k-th residual block
Projections = Callable[[int, ResidualBlock], Tuple[torch.Tensor, torch.Tensor]]

def _check_fused(model: UNet1D, **inputs: torch.Tensor) -> None:
    """Raise on what the fused kernel does not take: attention nets, as
    ``unet1d_pallas.py:75-78`` does, tp-split weights, and any type but
    float32 (``pallas_kernels.py:67`` refuses bfloat16)."""
    if any(model.is_attn) or model.middle_attn:
        raise NotImplementedError("the fused backend fuses no attention blocks; use the "
                                  "'plain' backend for attention nets (no shipped net has them)")
    if sharded_names(model):
        raise ValueError("the fused kernel takes whole weight matrices, not tp column slices")
    for name, a in (*inputs.items(), ("the weights", model.feature_proj.kernel)):
        if a.dtype != torch.float32:
            raise TypeError(f"the fused backend computes in float32 only; {name} is {a.dtype}")


def _residual_blocks(model: UNet1D) -> List[ResidualBlock]:
    """The net's residual blocks in the order its forward runs them."""
    return ([m.res for kind, m in zip(model.down_kinds, model.down) if kind == "block"]
            + [model.middle.res1, model.middle.res2]
            + [m.res for kind, m in zip(model.up_kinds, model.up) if kind == "block"])


def _forward_blocks(model: UNet1D, y: torch.Tensor, projections: Projections) -> torch.Tensor:
    """The forward with fused residual blocks; block k (in
    :func:`_residual_blocks`' order) takes ``projections(k, res)``, its
    ``(t_proj, c_proj)``."""
    ks = itertools.count()

    def run_block(res, x: torch.Tensor) -> torch.Tensor:
        return fused_residual_block(x, *projections(next(ks), res), *resblock_params_tuple(res))

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


def unet_forward_fused(model: UNet1D, y: torch.Tensor, t: torch.Tensor,
                       cond: torch.Tensor, cond_mask: torch.Tensor) -> torch.Tensor:
    """Full UNet1D forward with fused residual blocks. float32 only, as the
    JAX kernel. Raises on attention nets and on tp-split weights."""
    _check_fused(model, y=y, t=t, cond=cond, cond_mask=cond_mask)
    st = swish(model.time_emb(t))          # (Bt, 4*proj), shared by every block
    sc = swish(cond * cond_mask)           # (B, cond_dim)
    return _forward_blocks(model, y, lambda k, res: (res.time_emb(st), res.cond_emb(sc)))


class FusedApplyFn:
    """The fused backend's ``apply_fn(y, t, cond, cond_mask)``
    (:func:`unet_forward_fused`), with a prepared path for the sampler.

    Within one sampler call the condition and mask are fixed, and a step's
    time depends only on its index. :meth:`prepare` takes the condition
    and mask once, computes every block's condition projection
    ``res.cond_emb(swish(cond * cond_mask))`` (a prologue), and returns
    ``step(y, t_norm, key)``, the forward at one step. ``key`` is the
    step's ``(i, T)``, and ``t_norm`` must be the sampler's
    ``torch.full((1,), i) / T``. The step reads each block's time
    projection ``res.time_emb(swish(model.time_emb(t_norm)))`` from a table
    kept on this object for every ``key`` seen. The entry is computed from
    ``t_norm`` on the step that first meets ``key`` outside a CUDA-graph
    capture, by the same calls as the per-call forward. Inside a capture a
    missing step computes its time inline and is not stored. The
    arithmetic is the per-call forward's, and so are the answers, bit for
    bit.

    The table holds the time weights as they were when this object was
    built, as ``mega``'s packed weights do: ``prepare`` raises ValueError
    once their storage or version counters have changed (storage alone for
    inference tensors, which count no versions). Steps that read the
    prologue and the table are counted in ``obs``'s ``hoisted_steps``
    (inside a capture, for the replays to add).

    ``pad_cond`` (a multi-task face's ``_CondAdapter.pad_cond``) maps the
    condition before either path."""

    def __init__(self, model: UNet1D,
                 pad_cond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.model = model
        self.pad_cond = pad_cond
        self._blocks = _residual_blocks(model)
        self._time_params = [*model.time_emb.parameters(),
                             *(p for res in self._blocks for p in res.time_emb.parameters())]
        self._table: Dict[Tuple[int, int], List[torch.Tensor]] = {}
        self._key = self._weights_key()

    def __call__(self, y, t, cond, cond_mask):
        if self.pad_cond is not None:
            cond = self.pad_cond(cond)
        return unet_forward_fused(self.model, y, t, cond, cond_mask)

    def _weights_key(self) -> tuple:
        # Inference tensors (weights loaded under inference mode) keep no
        # version counter: their storage alone keys them.
        return tuple((p.data_ptr(), 0 if p.is_inference() else p._version)
                     for p in self._time_params)

    def _time_projections(self, t_norm: torch.Tensor) -> List[torch.Tensor]:
        st = swish(self.model.time_emb(t_norm))
        return [res.time_emb(st) for res in self._blocks]

    def prepare(self, cond: torch.Tensor, cond_mask: torch.Tensor
                ) -> Callable[[torch.Tensor, torch.Tensor, Tuple[int, int]], torch.Tensor]:
        """The condition prologue; returns ``step(y, t_norm, key)``."""
        if self._weights_key() != self._key:
            raise ValueError("the time weights changed since this apply function was built; "
                             "build a new one with unet_apply_fn")
        if self.pad_cond is not None:
            cond = self.pad_cond(cond)
        _check_fused(self.model, cond=cond, cond_mask=cond_mask)
        sc = swish(cond * cond_mask)
        c_projs = [res.cond_emb(sc) for res in self._blocks]

        def step(y: torch.Tensor, t_norm: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
            _check_fused(self.model, y=y, t=t_norm)
            t_projs = self._table.get(key)
            if t_projs is None and not _capturing(y):
                t_projs = self._table[key] = self._time_projections(t_norm)
            if t_projs is None:
                st = swish(self.model.time_emb(t_norm))
                return _forward_blocks(self.model, y,
                                       lambda k, res: (res.time_emb(st), c_projs[k]))
            obs.count("hoisted_steps", 1, y)
            return _forward_blocks(self.model, y, lambda k, res: (t_projs[k], c_projs[k]))
        return step


def _capturing(a: torch.Tensor) -> bool:
    return a.is_cuda and torch.cuda.is_current_stream_capturing()


def unet_forward_cfg_pair(model: UNet1D, y: torch.Tensor, t: torch.Tensor,
                          cond: torch.Tensor) -> torch.Tensor:
    """Both CFG halves in one forward, the shared prefix computed once.

    Counterpart of ``diffsg_tpu/models/unet1d_pallas.py:123``
    ``unet_forward_cfg_pair`` (JAX's ``xla_pair`` backend), in plain
    PyTorch. The sampler's fold runs the net on 2B rows whose halves carry
    the same ``y_t`` and differ only in ``cond * cond_mask`` (the
    unconditional half sees 0). So the two halves agree up to the first
    condition injection, inside the first down block: the feature
    projection and that block's norm1, lin1, time add, norm2 and lin2 run
    at B rows and fork there. And ``swish(0) = 0``, so every unconditional
    condition projection is the ``cond_emb`` bias alone: a broadcast add,
    and every condition product runs at B rows.

    ``y`` and ``cond`` are the unfolded (B, ...) inputs; returns the (2B, D)
    output laid out ``[uncond; cond]`` as the folded forward's. Raises on
    attention nets, as JAX's does, and on tp-split weights.
    """
    if any(model.is_attn) or model.middle_attn:
        raise NotImplementedError("cfg_pair does not implement attention")
    if sharded_names(model):
        raise ValueError("the pair forward takes whole weight matrices, not tp column slices")
    st = swish(model.time_emb(t))          # (Bt, 4*proj), batch-constant time
    sc = swish(cond)                       # (B, cond_dim), the conditional half only
    B = y.shape[0]

    def block_pair(res, x2: torch.Tensor) -> torch.Tensor:
        """A residual block on the (2B,) pair state: the condition product
        at B rows, the unconditional half gets the bias."""
        h = res.lin1(swish(res.norm1(x2)))
        h = h + res.time_emb(st)
        h = res.lin2(swish(res.norm2(h)))
        c_cond = torch.matmul(sc, res.cond_emb.kernel)
        h = h + res.cond_emb.bias
        h = torch.cat([h[:B], h[B:] + c_cond], dim=0)
        h = res.lin3(swish(res.norm3(h)))
        if res.shortcut is not None:
            x2 = res.shortcut(x2)
        return h + x2

    x1 = model.feature_proj(y)             # (B, proj), shared
    # The first down block: the shared prefix at B rows, forked at the
    # condition injection.
    res0 = model.down[0].res
    h = res0.lin1(swish(res0.norm1(x1)))
    h = h + res0.time_emb(st)
    h = res0.lin2(swish(res0.norm2(h)))
    h = h + res0.cond_emb.bias
    h2 = torch.cat([h, h + torch.matmul(sc, res0.cond_emb.kernel)], dim=0)
    h2 = res0.lin3(swish(res0.norm3(h2)))
    x2_in = torch.cat([x1, x1], dim=0)
    if res0.shortcut is not None:
        x2_in = res0.shortcut(x2_in)
    x = h2 + x2_in

    h_stack = [torch.cat([x1, x1], dim=0), x]
    for kind, m in zip(model.down_kinds[1:], model.down[1:]):
        x = block_pair(m.res, x) if kind == "block" else m(x)
        h_stack.append(x)

    x = block_pair(model.middle.res1, x)
    x = block_pair(model.middle.res2, x)

    for kind, m in zip(model.up_kinds, model.up):
        if kind == "resample":
            x = m(x)
        else:
            x = block_pair(m.res, torch.cat([x, h_stack.pop()], dim=1))

    return model.final(swish(model.norm(x)))


def _check_fold(y2: torch.Tensor, cond_mask: torch.Tensor) -> int:
    """B, for the sampler's fold: 2B rows, mask 0 on ``[0:B]`` and 1 on
    ``[B:2B]`` (``diffusion.ddpm.cfg_net``). The mask is read outside a
    CUDA-graph capture only (reading it synchronizes with the device)."""
    if y2.shape[0] % 2:
        raise ValueError(f"the pair backend takes the sampler's 2B-row CFG fold, got "
                         f"{y2.shape[0]} rows")
    B = y2.shape[0] // 2
    capturing = y2.is_cuda and torch.cuda.is_current_stream_capturing()
    if not capturing and not bool((cond_mask[:B] == 0).all() & (cond_mask[B:] == 1).all()):
        raise ValueError("the pair backend takes the sampler's CFG fold, [uncond; cond] "
                         "(mask 0 then 1); with skip_uncond use another backend")
    return B


def unet_apply_fn(model: UNet1D, backend: str = "fused",
                  compute_dtype: Optional[torch.dtype] = None) -> ApplyFn:
    """``apply_fn(y, t, cond, cond_mask)`` for the sampler.

    backend: "plain" (the module's own forward), "fused" (every residual
    block through ``ops.resblock.fused_residual_block``, float32 only),
    "mega" (the whole forward through ``ops.mega.unet_forward_mega``; its
    weights are packed once, here, in ``compute_dtype``, else in the model's
    own type) or "pair" (:func:`unet_forward_cfg_pair`, plain PyTorch; only
    for the sampler's folded 2B-row call, whose layout it checks).

    ``compute_dtype`` (``torch.bfloat16``) is taken by "mega", which then
    returns float32, and by "plain", which then runs a bfloat16 copy of the
    module (``model`` itself is never cast) on inputs cast to bfloat16 and
    returns bfloat16, as flax does with bfloat16 params and inputs. A
    bfloat16 copy of the model passed as ``model`` gives the same: "mega"
    then follows its inputs' type and returns bfloat16 for bfloat16 inputs.
    "fused" raises on bfloat16, as the JAX kernel does. Its apply_fn is a
    :class:`FusedApplyFn`, whose ``prepare`` the samplers use to compute the
    step-invariant projections once (``diffusion.ddpm.cfg_net``).

    A multi-task face's condition adapter (``tasks.multi._CondAdapter``,
    the module with ``inner`` and ``pad_cond``) runs as ``pad_cond`` and
    then the backend's forward of ``adapter.inner``.
    """
    if hasattr(model, "pad_cond"):
        inner = unet_apply_fn(model.inner, backend, compute_dtype)
        if isinstance(inner, FusedApplyFn):
            inner.pad_cond = model.pad_cond
            return inner
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
        return FusedApplyFn(model)
    if backend == "pair":
        if compute_dtype is not None:
            raise TypeError(f"the pair backend computes in the model's type; compute_dtype "
                            f"{compute_dtype} is taken by 'mega' and 'plain'")

        def pair(y2, t, c2, m):
            B = _check_fold(y2, m)
            return unet_forward_cfg_pair(model, y2[:B], t, c2[B:])
        return pair
    raise ValueError(f"unknown backend {backend!r}; use 'plain', 'fused', 'mega' or 'pair'")

"""Device mesh over ``torch.distributed``: sharded sampling and training.

Counterpart of ``diffsg_tpu/parallel/mesh.py``. The JAX package lays its
devices out as a ``(dp, tp)`` mesh and lets GSPMD insert the collectives.
Here every process is one device of the mesh, rank ``r`` at dp index
``r // tp`` and tp index ``r % tp``, and the collectives are explicit:

  dp — data parallel over the batch. Each rank holds ``B / dp`` rows. The
       batch-global reductions of the sampler (the early-step
       re-standardization, ``diffusion.ddpm.masked_mean_var``) and of the
       decoders (the global min and max, ``ops.decoders.masked_min_max``)
       become all-reduces over the rank's dp group while a mesh is active
       (``with mesh.active():``), so a meshed answer keeps the
       single-device semantics.
  tp — tensor parallel over hidden width. A ``Dense`` whose kernel
       :func:`shard_params` splits holds its column slice, computes its
       slice of the output and gathers it over the tp group.

A process joins the mesh with :func:`init_process` (NCCL on ``cuda``, gloo
on ``cpu``; NCCL cannot put two ranks on one card) and builds it with
:func:`make_mesh`. The collective helpers are no-ops without a mesh.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

# torch 2.13 renamed all_gather_into_tensor; the card's torch may predate it.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

_ACTIVE: Optional["Mesh"] = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This process's place in a ``(dp, tp)`` mesh: the sizes, its rank and
    its indices on both axes, the process groups of its dp and tp axes
    (``tp_group`` is None at ``tp == 1``) and its device."""

    dp: int
    tp: int
    rank: int
    dp_rank: int
    tp_rank: int
    dp_group: Any
    tp_group: Any
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    @contextlib.contextmanager
    def active(self) -> Iterator["Mesh"]:
        """Within this context the batch-global reductions of the sampler
        and the decoders reduce over the dp group."""
        global _ACTIVE
        prev, _ACTIVE = _ACTIVE, self
        try:
            yield self
        finally:
            _ACTIVE = prev

    def rows(self, n: int) -> slice:
        """The rank's rows of a batch of ``n`` (a dp multiple)."""
        if n % self.dp:
            raise ValueError(f"batch {n} not divisible by dp={self.dp}")
        per = n // self.dp
        return slice(self.dp_rank * per, (self.dp_rank + 1) * per)

    def columns(self, n: int) -> slice:
        """The rank's columns of a width ``n`` split over tp."""
        per = n // self.tp
        return slice(self.tp_rank * per, (self.tp_rank + 1) * per)


def current_mesh() -> Optional[Mesh]:
    """The mesh made active by ``with mesh.active():``, or None."""
    return _ACTIVE


def init_process(rank: int, world: int, init_method: str, device: DeviceLike = "cuda",
                 timeout_s: float = 300.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world``: NCCL with
    ``cuda:<rank>`` on a card, gloo on the CPU. Returns the rank's device.
    Raises when more CUDA ranks are asked for than there are cards."""
    dev = resolve_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            raise RuntimeError(f"{world} CUDA ranks asked for on {cards} card(s): NCCL cannot "
                               "put two ranks on one GPU")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=init_method, world_size=world, rank=rank,
                                timeout=timeout, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method, world_size=world, rank=rank,
                                timeout=timeout)
    return dev


def make_mesh(n_devices: Optional[int] = None, tp: int = 1, device: DeviceLike = "cuda") -> Mesh:
    """Build the ``(n_devices // tp, tp)`` mesh over the initialized default
    process group (``n_devices`` its world size); collective over every
    rank. Each group runs one all-reduce here, so its communicator exists
    before a CUDA graph captures a collective on it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_process)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices % tp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by tp={tp}")
    if n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the whole process group of "
                         f"{world} ranks")
    rank, dp = dist.get_rank(), n_devices // tp
    dev = resolve_device(device)
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise RuntimeError(f"{world} CUDA ranks asked for on {torch.cuda.device_count()} "
                               "card(s): NCCL cannot put two ranks on one GPU")
        dev = torch.device("cuda", rank)
    dp_group = tp_group = None
    for j in range(tp):       # every rank creates every group, in one order
        g = dist.new_group([i * tp + j for i in range(dp)])
        if rank % tp == j:
            dp_group = g
    if tp > 1:
        for i in range(dp):
            g = dist.new_group([i * tp + j for j in range(tp)])
            if rank // tp == i:
                tp_group = g
    mesh = Mesh(dp, tp, rank, rank // tp, rank % tp, dp_group, tp_group, dev)
    for group in (dp_group, tp_group):
        if group is not None:
            dist.all_reduce(torch.zeros(1, device=dev), group=group)
    return mesh


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rank's rows of a batch of ``n``: the leading axis over dp."""
    return mesh.rows(n)


def replicated(mesh: Mesh) -> slice:
    """Every row, on every rank."""
    return slice(None)


def shard_batch(arrays, mesh: Mesh):
    """The rank's rows of each batch-leading array (a tensor, an array, or a
    tuple, list or dict of them)."""
    if isinstance(arrays, dict):
        return {k: shard_batch(v, mesh) for k, v in arrays.items()}
    if isinstance(arrays, (tuple, list)):
        return type(arrays)(shard_batch(a, mesh) for a in arrays)
    return arrays[mesh.rows(arrays.shape[0])]


# -- tensor parallel ----------------------------------------------------------------

def _dense_kernels(model: torch.nn.Module):
    for name, m in model.named_modules():
        if hasattr(m, "kernel") and hasattr(m, "tp"):
            yield name, m


def param_shardings(model: torch.nn.Module, mesh: Mesh, tp_min_width: int = 128
                    ) -> Dict[str, Tuple]:
    """JAX's rule, per parameter name: a 2-D ``kernel`` whose output width is
    at least ``tp_min_width`` and divisible by ``tp`` is split by columns,
    ``(None, "tp")``; everything else (biases among them) is replicated,
    ``()``."""
    out: Dict[str, Tuple] = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        split = (mesh.tp > 1 and leaf == "kernel" and p.dim() == 2
                 and p.shape[1] >= tp_min_width and p.shape[1] % mesh.tp == 0)
        out[name] = (None, "tp") if split else ()
    return out


def shard_module_(model: torch.nn.Module, mesh: Mesh, tp_min_width: int = 128) -> set:
    """Move ``model`` to the mesh's device and split it in place by
    :func:`param_shardings`: a split ``Dense`` keeps its Parameter objects,
    its kernel now holding the rank's columns, and gathers its output over
    tp. Returns the split parameters' names."""
    model.to(mesh.device)
    specs = param_shardings(model, mesh, tp_min_width)
    for name, m in _dense_kernels(model):
        if specs.get(f"{name}.kernel" if name else "kernel") == (None, "tp"):
            with torch.no_grad():
                m.kernel.data = m.kernel.data[:, mesh.columns(m.kernel.shape[1])].contiguous()
            m.tp = mesh
    return sharded_names(model)


def shard_params(model: torch.nn.Module, mesh: Mesh, tp_min_width: int = 128
                 ) -> torch.nn.Module:
    """``model`` placed on the mesh: on the mesh's device, replicated, or a
    copy whose wide kernels are split over tp (``model`` itself is left
    whole)."""
    if any(spec for spec in param_shardings(model, mesh, tp_min_width).values()):
        model = copy.deepcopy(model)
    shard_module_(model, mesh, tp_min_width)
    return model


def sharded_names(model: torch.nn.Module) -> set:
    """The parameter names whose tensors hold a tp column slice."""
    return {f"{name}.kernel" if name else "kernel" for name, m in _dense_kernels(model)
            if m.tp is not None}


def gather_columns_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole ``(..., n * tp)`` tensor from each tp rank's column slice
    (no autograd)."""
    parts = torch.empty((mesh.tp * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    _all_gather(parts, t.contiguous(), group=mesh.tp_group)
    return torch.cat(list(parts.reshape(mesh.tp, *t.shape).unbind(0)), dim=-1)


def unshard_module_(model: torch.nn.Module) -> None:
    """Undo :func:`shard_module_` in place: every split kernel gathered
    whole again; collective over the tp group."""
    for _, m in _dense_kernels(model):
        if m.tp is not None:
            with torch.no_grad():
                m.kernel.data = gather_columns_(m.kernel.data, m.tp)
            m.tp = None


class _GatherColumns(torch.autograd.Function):
    """Forward: every tp rank's column slice, gathered whole. Backward: the
    rank's own columns of the incoming gradient. Every tp rank computes the
    same loss from the gathered output, so the incoming gradient is the same
    on each; summing it over tp (a reduce-scatter, as
    ``torch.distributed.nn.functional.all_gather`` does) would scale the
    kernel's gradient by ``tp``."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return gather_columns_(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        mesh = ctx.mesh
        return grad[..., mesh.columns(grad.shape[-1])].contiguous(), None


class _CopyToTp(torch.autograd.Function):
    """Forward: the identity. Backward: the sum over tp. A split Dense's
    input gradient from its own columns is a partial sum of the whole
    ``grad @ kernel.T``; the tp ranks' partials add up to it."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.tp_group)
        return grad, None


def tp_linear(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, mesh: Mesh
              ) -> torch.Tensor:
    """``x @ kernel + bias`` for a kernel split by columns over tp."""
    part = torch.matmul(_CopyToTp.apply(x, mesh), kernel)
    return _GatherColumns.apply(part, mesh) + bias


# -- collectives (no-ops without a mesh) -------------------------------------------------

def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh] = None, axis: str = "dp"
                   ) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ``axis`` ("dp" or "tp")."""
    return _all_reduce(t, mesh, dist.ReduceOp.SUM, axis)


def all_reduce_min(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    return _all_reduce(t, mesh, dist.ReduceOp.MIN, "dp")


def all_reduce_max(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    return _all_reduce(t, mesh, dist.ReduceOp.MAX, "dp")


def _all_reduce(t, mesh, op, axis):
    if mesh is None:
        return t
    group = mesh.dp_group if axis == "dp" else mesh.tp_group
    if group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_rows(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Every dp rank's rows of ``t``, in dp order: ``(dp * n, ...)``."""
    if mesh is None:
        return t
    out = torch.empty((mesh.dp * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    _all_gather(out, t.contiguous(), group=mesh.dp_group)
    return out


def all_reduce_mean_grads_(params, mesh: Mesh) -> None:
    """Average the ``.grad`` of ``params`` over dp, in place, as one
    flattened all-reduce (nothing at dp == 1)."""
    if mesh.dp == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.dp_group)
    flat /= mesh.dp
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


"""CFG-DDPM trainer.

Counterpart of ``diffsg_tpu/train/trainer.py``. The dataset lives on the
device; each epoch takes ``floor(N/B)`` full batches of a fresh permutation
and runs, per batch, the module's own forward and ``torch.autograd``'s
backward, optax's global-norm clip when asked, and Adam at the MultiStepLR
rate; then the EMA blend, gated as the reference gates it. The loop is eager
PyTorch: the JAX package's ``lax.scan`` over an epoch is not carried over.

The hand-written kernels are forward-only, as the Pallas kernels are (the
JAX package differentiates the flax module, never a kernel), so training
runs the plain module: the ``fused`` and ``mega`` wrappers raise under
autograd.

Reference hyperparameters are the defaults (Adam lr 5e-3, MultiStepLR with
gamma 0.1 at per-task milestones, batch 512, 200 epochs, uncond_prob 0.1,
EMA decay 0.9999 / start 10 / update rate 5 with ``use_ema=False``).

The draws of epoch ``e`` come from a ``torch.Generator`` seeded from
``(cfg.seed, e)``: the permutation, then per step ``t``, the noise and the
condition mask. A resumed run therefore draws what the uninterrupted run
drew. Every draw can also be injected (:class:`EpochDraws`), which the tests
use to replay the JAX package's ``jax.random`` streams.

On a device mesh (``mesh``, ``parallel.mesh``) every rank draws the epoch's
permutation and each global batch's ``t``, noise and condition mask from the
same generator and keeps its dp rows; the local losses' gradients are
averaged over dp, the global-norm clip sees the whole gradient (column
shards summed over tp, replicated tensors counted once), Adam and the EMA
run on every rank alike, and the returned loss is the dp mean. Wide kernels
are split over tp by ``parallel.mesh.shard_params``' rule for the run and
gathered whole again at its end; checkpoints hold the whole parameters and
are written by rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..diffusion.ddpm import ddpm_draws, ddpm_loss
from ..diffusion.schedule import Schedule, cosine_schedule
from ..parallel.mesh import (Mesh, all_reduce_mean_grads_, all_reduce_sum, gather_columns_,
                             shard_module_, sharded_names, unshard_module_)
from ..utils.params import params_from_jax, params_to_jax, tree_from_state
from .ema import EmaState, ema_init, ema_update
from .init import torch_style_init


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Per-task training hyperparameters (reference defaults); the fields,
    defaults and order of the JAX package's ``TrainConfig``.

    ``milestones`` are the epoch indices of the LR x ``lr_gamma`` drops:
    MSR [100, 150], CO [15, 80, 150], NU [80, 200]. ``grad_clip`` is an
    optional global-norm gradient clip (off: the reference's bare Adam).
    ``parameterization`` is the denoiser's target: ``"eps"`` (reference),
    ``"x0"`` or ``"v"``.
    """

    epochs: int = 200
    batch_size: int = 512
    lr: float = 5e-3
    milestones: Sequence[int] = (100, 150)
    lr_gamma: float = 0.1
    T: int = 20
    uncond_prob: float = 0.1
    use_ema: bool = False
    ema_decay: float = 0.9999
    ema_start: int = 10
    ema_update_rate: int = 5
    warmup_epoch: int = 5
    seed: int = 0
    grad_clip: Optional[float] = None
    parameterization: str = "eps"


def multistep_lr(base_lr: float, milestones: Sequence[int], steps_per_epoch: int,
                 gamma: float = 0.1) -> Callable[[int], float]:
    """torch's MultiStepLR as a function of the global step: ``base_lr``
    times ``gamma`` for each milestone epoch reached. Evaluated at the
    update count before an update, it is optax's
    ``piecewise_constant_schedule`` as ``scale_by_schedule`` reads it."""
    boundaries = sorted({int(m) * steps_per_epoch for m in milestones})

    def lr(step: int) -> float:
        value = base_lr
        for b in boundaries:
            if step >= b:
                value *= gamma
        return value

    return lr


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        tp_split: Optional[Sequence[bool]] = None,
                        mesh: Optional[Mesh] = None) -> None:
    """optax's ``clip_by_global_norm``, in place: every gradient becomes
    ``g / norm * max_norm`` when the global norm reaches ``max_norm``, and
    stays as it is below. (``torch.nn.utils.clip_grad_norm_`` divides by
    ``norm + 1e-6`` and so differs.) No host synchronization.

    On a mesh with ``tp > 1``, ``tp_split[i]`` says that ``grads[i]`` is a
    tp column shard: those squares are summed over tp, the replicated ones
    counted once, so the norm is the whole gradient's."""
    if mesh is not None and mesh.tp > 1 and tp_split is not None:
        sq = [torch.sum(g * g) for g in grads]
        zero = grads[0].new_zeros(())
        split = sum((q for q, f in zip(sq, tp_split) if f), zero)
        norm = torch.sqrt(sum((q for q, f in zip(sq, tp_split) if not f), zero)
                          + all_reduce_sum(split, mesh, "tp"))
    else:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """optax's ``adam`` at the MultiStepLR rate, after
    ``clip_by_global_norm`` when ``grad_clip`` is set, on ``torch.optim.Adam``
    (betas 0.9 and 0.999, eps 1e-8: the same update). Each step's rate is
    set explicitly from ``lr``.

    :meth:`export_state` and :meth:`load_state` map Adam's ``step``,
    ``exp_avg`` and ``exp_avg_sq`` to optax's state tree: without a clip
    ``0/.count``, ``0/.mu/<flax path>``, ``0/.nu/<flax path>`` and the
    schedule's ``1/.count``; with one, the same under ``1/`` (the clip's
    state, ``0``, has no leaves).
    """

    lr: Callable[[int], float]
    grad_clip: Optional[float] = None

    def init(self, model: nn.Module) -> torch.optim.Adam:
        return torch.optim.Adam(model.parameters(), lr=self.lr(0), betas=(0.9, 0.999),
                                eps=1e-8)

    def apply(self, adam: torch.optim.Adam, step: int, mesh: Optional[Mesh] = None,
              tp_split: Optional[set] = None) -> None:
        """One update from the gradients in ``.grad``; ``step`` is the
        number of updates before this one. On a mesh, ``tp_split`` holds the
        ids of the parameters that are tp column shards (for the clip)."""
        if self.grad_clip is not None:
            params = [p for g in adam.param_groups for p in g["params"]]
            clip_by_global_norm([p.grad for p in params], self.grad_clip,
                                [id(p) in (tp_split or ()) for p in params], mesh)
        for group in adam.param_groups:
            group["lr"] = self.lr(step)
        adam.step()

    def _adam_key(self) -> Tuple[str, ...]:
        return ("0",) if self.grad_clip is None else ("1", "0")

    def export_state(self, adam: torch.optim.Adam, model: nn.Module, step: int,
                     whole: Callable[[str, torch.Tensor], torch.Tensor] = lambda n, t: t
                     ) -> Dict[str, Any]:
        """Adam's state as optax's state tree (nested dicts of NumPy);
        ``whole(name, tensor)`` gathers a tp-split parameter's state."""
        mu, nu = {}, {}
        for name, p in model.named_parameters():
            st = adam.state.get(p, {})
            mu[name] = whole(name, st["exp_avg"] if st else torch.zeros_like(p))
            nu[name] = whole(name, st["exp_avg_sq"] if st else torch.zeros_like(p))
        count = np.asarray(step, np.int32)
        adam_state = {".count": count, ".mu": tree_from_state(mu), ".nu": tree_from_state(nu)}
        sched_state = {".count": count.copy()}
        if self.grad_clip is None:
            return {"0": adam_state, "1": sched_state}
        return {"1": {"0": adam_state, "1": sched_state}}

    def load_state(self, adam: torch.optim.Adam, model: nn.Module, raw: Dict[str, Any]) -> None:
        """Set Adam's state from optax's state tree (as
        ``load_checkpoint(..., training=True)["opt_state_raw"]`` holds it)."""
        node = raw
        for k in self._adam_key():
            node = node[k]
        count = int(node[".count"])
        mu, nu = params_from_jax(node[".mu"]), params_from_jax(node[".nu"])
        adam.state.clear()
        if count == 0:
            return
        for name, p in model.named_parameters():
            adam.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                             "exp_avg": mu[name].to(p.device),
                             "exp_avg_sq": nu[name].to(p.device)}


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int) -> Optimizer:
    return Optimizer(multistep_lr(cfg.lr, cfg.milestones, steps_per_epoch, cfg.lr_gamma),
                     cfg.grad_clip)


@dataclasses.dataclass
class TrainState:
    """What an epoch updates: the module (trained in place), its Adam, the
    EMA and the global step (updates so far)."""

    model: nn.Module
    adam: torch.optim.Adam
    ema: EmaState
    step: int = 0


class EpochDraws(NamedTuple):
    """Every random draw of one epoch of ``steps`` batches of ``B`` rows:
    ``perm`` (steps * B,) row indices, ``t`` (steps, B) integers in
    ``[0, T)``, ``noise`` (steps, B, D), ``cond_mask`` (steps, B, 1)."""

    perm: torch.Tensor
    t: torch.Tensor
    noise: torch.Tensor
    cond_mask: torch.Tensor


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """The generator of epoch ``epoch``'s draws: a function of the seed and
    the epoch only, so a resumed run draws what the uninterrupted one did."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence((seed, epoch)).generate_state(1)[0]))
    return gen


def train_epoch(state: TrainState, optimizer: Optimizer, sched: Schedule, X: torch.Tensor,
                Y: torch.Tensor, cfg: TrainConfig, epoch: int,
                draws: Optional[EpochDraws] = None, mesh: Optional[Mesh] = None
                ) -> torch.Tensor:
    """One epoch over the device-resident ``X`` (N, C) and ``Y`` (N, D):
    ``floor(N/B)`` full batches of one permutation, ``B = min(batch_size,
    N)``. Updates ``state`` in place; returns the epoch's mean loss (a 0-d
    tensor on the device). ``draws`` replaces every draw of the epoch.

    EMA gating is the reference's: the epoch index comes from the step
    before the update, ``step > ema_start`` and ``step % ema_update_rate ==
    0`` from the step after it.

    On a ``mesh`` every rank holds the whole ``X`` and ``Y`` and the same
    draws (``B`` must be a dp multiple), trains on its dp rows of each
    batch and averages the gradients over dp; the loss returned is the dp
    mean. A tp-split model is split before the call (``train_ddpm`` does).
    """
    n = X.shape[0]
    B = min(cfg.batch_size, n)
    steps = max(n // B, 1)
    dev = X.device
    rows = slice(None) if mesh is None else mesh.rows(B)
    tp_split = None
    if mesh is not None:
        names = sharded_names(state.model)
        tp_split = {id(p) for name, p in state.model.named_parameters() if name in names}
    gen = None
    if draws is None:
        gen = epoch_generator(cfg.seed, epoch, dev)
        perm = torch.randperm(n, generator=gen, device=dev)[: steps * B]
    else:
        perm = draws.perm.to(dev)
    model, adam = state.model, state.adam
    losses = []
    for s in range(steps):
        idx = perm[s * B:(s + 1) * B]
        kw = {} if draws is None else {"t": draws.t[s].to(dev), "noise": draws.noise[s].to(dev),
                                       "cond_mask": draws.cond_mask[s].to(dev)}
        if mesh is not None:
            # The global batch's draws, in ddpm_loss's order; this rank's rows.
            drawn = ddpm_draws(sched.T, (B, Y.shape[1]), cfg.uncond_prob, gen, dev, Y.dtype,
                               **kw)
            kw = {k: v[rows] for k, v in zip(("t", "noise", "cond_mask"), drawn)}
            idx = idx[rows]
        with torch.enable_grad():
            loss = ddpm_loss(model, sched, Y[idx], X[idx], cfg.uncond_prob,
                             cfg.parameterization, generator=gen, **kw)
            adam.zero_grad(set_to_none=True)
            loss.backward()
        if mesh is not None:
            all_reduce_mean_grads_(model.parameters(), mesh)
        optimizer.apply(adam, state.step, mesh, tp_split)
        epoch_idx = state.step // steps
        state.step += 1
        if (cfg.use_ema and epoch_idx > cfg.warmup_epoch and state.step > cfg.ema_start
                and state.step % cfg.ema_update_rate == 0):
            with torch.no_grad():
                state.ema = ema_update(state.ema, dict(model.named_parameters()), cfg.ema_decay)
        losses.append(loss.detach())
    mean = torch.stack(losses).mean()
    return mean if mesh is None else all_reduce_sum(mean, mesh) / mesh.dp


def train_ddpm(
    model: nn.Module,
    X_train: np.ndarray,
    Y_train: np.ndarray,
    cfg: TrainConfig,
    init_params: Optional[Dict[str, Any]] = None,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    resume_state: Optional[Dict[str, Any]] = None,
    checkpoint_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
    draws: Optional[Callable[[int], EpochDraws]] = None,
    mesh: Optional[Mesh] = None,
) -> Tuple[Dict[str, Any], EmaState, Schedule]:
    """A full training run for one task on ``device``. Returns ``(params,
    ema, sched)``: ``params`` the flax tree of NumPy arrays
    (``save_checkpoint`` and ``params_from_jax`` take it), ``ema`` an
    :class:`EmaState` on the device, ``sched`` the cosine schedule.

    ``model`` is moved to ``device`` and trained in place, from
    ``init_params`` (a flax tree) when given, else from
    :func:`torch_style_init` seeded with ``cfg.seed``. ``resume_state`` (from
    ``load_checkpoint(..., training=True)``) continues a run where it
    stopped; ``checkpoint_every`` epochs a resumable checkpoint goes to
    ``checkpoint_dir``. ``draws(epoch)``, where given, supplies each
    epoch's draws. ``X_train`` and ``Y_train`` are cast to the type of the
    model's parameters.

    ``mesh`` trains data-parallel over its dp axis on the mesh's device
    (``device`` is then ignored), every rank with the same arguments; wide
    kernels (``parallel.mesh.param_shardings``' rule) are split over tp for
    the run. The returned params and EMA are whole on every rank,
    checkpoints are written by rank 0.
    """
    from ..utils.checkpoint import save_checkpoint   # it imports this package's EmaState

    dev = mesh.device if mesh is not None else resolve_device(device)
    sched = cosine_schedule(cfg.T, device=dev)
    model.to(dev)
    if init_params is not None:
        model.load_state_dict(params_from_jax(init_params), strict=True)
    else:
        torch_style_init(model, torch.Generator().manual_seed(cfg.seed))

    n = X_train.shape[0]
    optimizer = make_optimizer(cfg, max(n // cfg.batch_size, 1))
    state = TrainState(model, optimizer.init(model), ema_init(dict(model.named_parameters())))
    start_epoch = 0
    if resume_state is not None:
        start_epoch = restore_train_state(resume_state, optimizer, state)
    split = _split_train_state(state, mesh) if mesh is not None else set()

    def whole(name: str, t: torch.Tensor) -> torch.Tensor:
        return gather_columns_(t.detach(), mesh) if name in split else t

    dtype = next(model.parameters()).dtype
    X = torch.as_tensor(np.asarray(X_train), dtype=dtype).to(dev)
    Y = torch.as_tensor(np.asarray(Y_train), dtype=dtype).to(dev)
    for epoch in range(start_epoch, cfg.epochs):
        loss = train_epoch(state, optimizer, sched, X, Y, cfg, epoch,
                           None if draws is None else draws(epoch), mesh)
        if log_every and (epoch % log_every == 0 or epoch == cfg.epochs - 1):
            log_fn(f"epoch {epoch}: loss {float(loss):.6f}")
        if checkpoint_every and checkpoint_dir and (epoch + 1) % checkpoint_every == 0:
            params = tree_from_state({k: whole(k, v) for k, v in model.state_dict().items()})
            ema = EmaState({k: whole(k, v) for k, v in state.ema.params.items()},
                           state.ema.n_averaged)
            opt = optimizer.export_state(state.adam, model, state.step, whole)
            if mesh is None or mesh.rank == 0:
                save_checkpoint(checkpoint_dir, params, ema=ema, opt_state=opt,
                                step=state.step, sched=sched, metadata={"epoch": epoch + 1})
    if split:
        state.ema = EmaState({k: whole(k, v) for k, v in state.ema.params.items()},
                             state.ema.n_averaged)
        unshard_module_(model)
    return params_to_jax(model), state.ema, sched


def _split_train_state(state: TrainState, mesh: Mesh) -> set:
    """Split the model over tp in place (``parallel.mesh.shard_module_``),
    and Adam's state and the EMA of the split kernels alike. Returns the
    split parameters' names."""
    split = shard_module_(state.model, mesh)
    params = dict(state.model.named_parameters())
    ema = dict(state.ema.params)
    for name in split:
        cols = mesh.columns(params[name].shape[1] * mesh.tp)
        for key, val in state.adam.state.get(params[name], {}).items():
            if key != "step":
                state.adam.state[params[name]][key] = val[:, cols].contiguous()
        ema[name] = ema[name][:, cols].contiguous()
    state.ema = EmaState(ema, state.ema.n_averaged)
    return split


def restore_train_state(ck: Dict[str, Any], optimizer: Optimizer, state: TrainState) -> int:
    """Set ``state`` from a checkpoint loaded with ``training=True``: the
    params, the EMA (a copy of the params where the checkpoint has none),
    Adam's state from optax's keys, and the step. Returns the epoch to go on
    from (the metadata's ``epoch``, 0 without one)."""
    model = state.model
    dev = next(model.parameters()).device
    model.load_state_dict(params_from_jax(ck["params"]), strict=True)
    ema = ck.get("ema")
    state.ema = (ema_init(dict(model.named_parameters())) if ema is None else
                 EmaState({k: v.to(dev) for k, v in ema.params.items()}, ema.n_averaged))
    if "opt_state_raw" in ck:
        optimizer.load_state(state.adam, model, ck["opt_state_raw"])
    state.step = int(ck.get("step", 0))
    return int(ck.get("metadata", {}).get("epoch", 0))

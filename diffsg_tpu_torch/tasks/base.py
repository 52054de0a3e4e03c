"""The task interface, the checkpoint config merge and the eval loop.

Counterpart of ``diffsg_tpu/tasks/base.py``: ``Task``, ``CKPT_CONFIG_KEYS``
and ``merge_ckpt_config``, ``refine_solutions``, ``select_best``, and the
eval loop ``sample_solutions``, ``sample_best_of_n``, ``objective_metrics``
and ``evaluate``. ``tasks.msr``, ``tasks.co``, ``tasks.nu`` and
``tasks.multi`` provide the instances.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.loaders import TaskData
from ..device import DeviceLike, resolve_device
from ..diffusion.ddim import ddim_sample
from ..diffusion.ddpm import SampleTrace, cfg_sample
from ..diffusion.schedule import Schedule
from ..models.unet1d_fused import unet_apply_fn
from ..ops.refine import projected_refine
from ..train.trainer import TrainConfig
from ..utils.params import params_from_jax


@dataclasses.dataclass(frozen=True)
class Task:
    """One network-optimization problem.

    ``load(path, ...)``: a dataset CSV -> ``TaskData``.
    ``decode(Y_raw, config, valid_mask=None)``: raw sampler output ->
    feasible solutions. ``objective(Y_dec, X_unnorm, config)``: per-sample
    objective. ``unnormalize_x`` / ``unnormalize_y``: loader-scaled
    conditions / labels -> physical units. ``higher_is_better``: rate
    maximization (MSR, NU) or cost minimization. ``decode_with_x(Y_raw,
    X_unnorm, config, valid_mask=None)``: an optional decoder that also sees
    the unnormalized conditions; where given, the sampling paths use it in
    place of ``decode``.

    ``train_config``: the reference's training hyperparameters for the task
    (``train.train_ddpm`` takes them).

    ``extra_metrics(Y_dec, Y_true, pred, true, config)``: optional
    task-specific metrics (numpy in, floats out). ``project(Y_dec,
    X_unnorm, config)``: an optional Euclidean feasibility projection in
    physical units (the identity on feasible points); where given,
    :func:`refine_solutions` can polish the decoded solutions, with a first
    step of ``refine_step`` and per-column step scales
    ``refine_precond(config)`` (D,) where given. CO leaves ``project``
    unset: given the decision, its allocation is already the closed-form
    optimum.
    """

    name: str
    build_model: Callable[[Dict], torch.nn.Module]
    load: Callable[..., TaskData]
    decode: Callable[..., torch.Tensor]
    objective: Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]
    unnormalize_x: Callable[[np.ndarray, Dict], np.ndarray]
    unnormalize_y: Callable[[np.ndarray, Dict], np.ndarray]
    data_dim: Callable[[Dict], int]
    cond_dim: Callable[[Dict], int]
    train_config: TrainConfig
    higher_is_better: bool = True
    default_omega: float = 500.0
    decode_with_x: Optional[Callable[..., torch.Tensor]] = None
    extra_metrics: Optional[Callable[..., Dict[str, float]]] = None
    project: Optional[Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]] = None
    refine_step: float = 0.1
    refine_precond: Optional[Callable[[Dict], np.ndarray]] = None


#: Dataset-config keys owned by the checkpoint (training-time choices), not
#: the dataset: label transforms and model-architecture overrides.
CKPT_CONFIG_KEYS = ("y_scale", "y_shift", "proj_dim", "dims", "parameterization")


def merge_ckpt_config(config: Dict, metadata: Optional[Dict]) -> Dict:
    """Copy the checkpoint-owned keys of the metadata's ``dataset_config``
    into a freshly loaded dataset config (W, P_sum and the scalers stay the
    dataset's own)."""
    md_cfg = (metadata or {}).get("dataset_config") or {}
    for k in CKPT_CONFIG_KEYS:
        if k in md_cfg:
            config[k] = md_cfg[k]
    return config


def loaded_model(task: Task, params: Dict[str, Any], config: Dict,
                 device: DeviceLike = "cuda") -> torch.nn.Module:
    """``task.build_model(config)`` with the checkpoint's flax ``params``
    loaded strictly (into ``inner`` for a multi-task face's condition
    adapter), in eval mode on ``device``."""
    model = task.build_model(config)
    getattr(model, "inner", model).load_state_dict(params_from_jax(params), strict=True)
    return model.to(resolve_device(device)).eval()


def refine_solutions(task: Task, Y_dec: torch.Tensor, X_unnorm: torch.Tensor, config: Dict,
                     iters: int, step: Optional[float] = None) -> torch.Tensor:
    """Polish decoded solutions with ``iters`` projected-gradient steps on
    the exact task objective (``ops.refine.projected_refine``); ``step``
    defaults to the task's ``refine_step``. Strictly per row, with no host
    synchronization: it can be captured in a CUDA graph. Raises ValueError
    for a task without a feasibility projection (CO)."""
    if task.project is None:
        raise ValueError(
            f"task {task.name!r} has no feasibility projection; projected-gradient "
            "refinement is unsupported (CO's continuous allocation is already "
            "closed-form optimal given the decision)")
    precond = None if task.refine_precond is None else task.refine_precond(config)
    # Outside inference mode, on copies: autograd must be able to record
    # the objective, and it cannot save inference tensors.
    with torch.inference_mode(False):
        Y, X = Y_dec.clone(), X_unnorm.clone()
        return projected_refine(
            lambda y: task.objective(y, X, config), lambda y: task.project(y, X, config),
            Y, iters, task.refine_step if step is None else step,
            higher_is_better=task.higher_is_better, precond=precond)


def select_best(decs: torch.Tensor, scores: torch.Tensor, higher_is_better: bool) -> torch.Tensor:
    """Pick the best candidate per sample: decs (n, B, D), scores (n, B) ->
    (B, D). Ties go to the first candidate, as ``argmax`` / ``argmin`` do."""
    pick = torch.argmax(scores, dim=0) if higher_is_better else torch.argmin(scores, dim=0)
    index = pick[None, :, None].expand(1, *decs.shape[1:])
    return torch.gather(decs, 0, index)[0]


# -- the eval loop ------------------------------------------------------------------


def _noise_columns(sched: Schedule, sampler: str) -> int:
    if sampler == "ddpm":
        return sched.T + 1
    if sampler == "ddim":
        return 1
    raise ValueError(f"unknown sampler {sampler!r}")


def _draw(task: Task, apply_fn, sched: Schedule, cond: torch.Tensor, cond_unnorm: torch.Tensor,
          config: Dict, omega, noise: torch.Tensor, sampler: str, n_steps: Optional[int],
          skip: bool, record_trace: bool = False):
    """One reverse chain over a batch on the given noise ((b, columns, D),
    row-major), decoded: (solutions, SampleTrace or None)."""
    D = task.data_dim(config)
    param = config.get("parameterization", "eps")
    init = noise[:, 0].contiguous()
    trace = None
    if sampler == "ddim":
        y0 = ddim_sample(apply_fn, sched, cond, omega, D, n_steps=n_steps or sched.T,
                         init_noise=init, parameterization=param, skip_uncond=skip)
    else:
        y0 = cfg_sample(apply_fn, sched, cond, omega, D, init_noise=init,
                        step_noise=noise[:, 1:].transpose(0, 1), parameterization=param,
                        skip_uncond=skip, record_trace=record_trace)
        if record_trace:
            y0, trace = y0
    if task.decode_with_x is not None:
        return task.decode_with_x(y0, cond_unnorm, config), trace
    return task.decode(y0, config), trace


def _batches(task: Task, X_test: np.ndarray, config: Dict, batch_size: int,
             dev: torch.device):
    """(cond, cond_unnorm) float32 tensors on ``dev``, batch by batch."""
    X_unnorm = task.unnormalize_x(X_test, config)
    for i in range(0, X_test.shape[0], batch_size):
        yield (torch.as_tensor(np.asarray(X_test[i:i + batch_size], np.float32), device=dev),
               torch.as_tensor(np.asarray(X_unnorm[i:i + batch_size], np.float32), device=dev))


@torch.inference_mode()
def sample_solutions(task: Task, params: Dict[str, Any], sched: Schedule, X_test: np.ndarray,
                     config: Dict, omega: Optional[float] = None, batch_size: int = 512,
                     seed: int = 0, record_trace: bool = False, sampler: str = "ddpm",
                     n_steps: Optional[int] = None, backend: str = "fused"
                     ) -> Tuple[np.ndarray, Optional[List[Optional[SampleTrace]]]]:
    """Sample and decode a test split batch by batch; returns (decoded
    solutions (N, D), per-batch traces or None).

    Runs on the device of ``sched`` (``load_checkpoint(..., device=)``),
    with ``params`` (the checkpoint's flax tree) in ``task.build_model``'s
    net through ``backend``'s forward. Each batch of ``batch_size`` rows is
    sampled and decoded on its own, so the decoders' batch-global
    normalization is the reference's at eval batch 512; a last partial
    batch runs at its own size. ``sampler``: "ddpm" (the CFG ancestral
    sampler over all T steps) or "ddim" (deterministic, ``n_steps``
    respaced steps).

    Noise: one ``torch.Generator`` on that device, seeded by ``seed``; for
    each batch of b rows, in order, one ``torch.randn((b, columns, D))``
    draw, row-major: DDPM columns T + 1 (column 0 y_T, column 1 + s the z of
    reverse step s), DDIM one column (y_T). ``record_trace`` (DDPM) returns
    each batch's ``SampleTrace`` as NumPy arrays; DDIM records none.
    """
    dev = sched.betas.device
    apply_fn = unet_apply_fn(loaded_model(task, params, config, dev), backend)
    omega = task.default_omega if omega is None else omega
    D, cols = task.data_dim(config), _noise_columns(sched, sampler)
    gen = torch.Generator(device=dev).manual_seed(seed)
    outs, traces = [], []
    for cond, cu in _batches(task, X_test, config, batch_size, dev):
        noise = torch.randn((cond.shape[0], cols, D), generator=gen, device=dev)
        dec, trace = _draw(task, apply_fn, sched, cond, cu, config, omega, noise, sampler,
                           n_steps, float(omega) == 0.0, record_trace)
        outs.append(dec.cpu().numpy())
        if record_trace:
            traces.append(None if trace is None else
                          SampleTrace(trace.ys.cpu().numpy(), trace.eps.cpu().numpy()))
    return np.concatenate(outs), (traces if record_trace else None)


def _objectives(task: Task, data: TaskData, Y_pred: np.ndarray, dev: torch.device
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(pred, true) float32 NumPy objectives of the test split, and its
    unnormalized labels."""
    X_unnorm = torch.as_tensor(np.asarray(task.unnormalize_x(data.X_test, data.config),
                                          np.float32), device=dev)
    Y_true = task.unnormalize_y(data.Y_test, data.config)

    def obj(Y):
        Yt = torch.as_tensor(np.asarray(Y, np.float32), device=dev)
        return task.objective(Yt, X_unnorm, data.config).cpu().numpy()

    return obj(Y_pred), obj(Y_true), Y_true


def _ratio_metrics(task: Task, pred: np.ndarray, true: np.ndarray) -> Dict[str, float]:
    # NumPy float32 sums, as the JAX package reckons them.
    name = "less_ratio" if task.higher_is_better else "exceeded_ratio"
    return {name: float(pred.sum() / true.sum()), "avg_diff": float((pred - true).mean())}


@torch.inference_mode()
def objective_metrics(task: Task, data: TaskData, Y_pred: np.ndarray,
                      device: DeviceLike = "cuda") -> Dict[str, float]:
    """The reference's ratio/diff metric block for any solver's predictions
    on ``data``'s test split; the objectives run on ``device``."""
    pred, true, _ = _objectives(task, data, Y_pred, resolve_device(device))
    return _ratio_metrics(task, pred, true)


@torch.inference_mode()
def sample_best_of_n(task: Task, params: Dict[str, Any], sched: Schedule, X_test: np.ndarray,
                     config: Dict, n: int = 8, omega=None, batch_size: int = 512, seed: int = 0,
                     sampler: str = "ddpm", n_steps: Optional[int] = None,
                     backend: str = "fused") -> np.ndarray:
    """Best-of-N: ``n`` reverse chains per condition, the one with the best
    task objective kept per row (ties to the first candidate). ``omega`` a
    scalar, or a list of per-candidate scales (a mixture; it overrides
    ``n``). Device, batching and backend as :func:`sample_solutions`.

    Noise: one ``torch.Generator`` seeded by ``seed``; for each batch, in
    order, candidate by candidate, one ``torch.randn((b, columns, D))``
    draw in :func:`sample_solutions`' layout. Returns (N, D).
    """
    dev = sched.betas.device
    apply_fn = unet_apply_fn(loaded_model(task, params, config, dev), backend)
    omega = task.default_omega if omega is None else omega
    omegas = (np.full(n, omega, np.float32) if np.isscalar(omega)
              else np.asarray(omega, np.float32))
    skip = bool(np.all(omegas == 0.0))
    D, cols = task.data_dim(config), _noise_columns(sched, sampler)
    gen = torch.Generator(device=dev).manual_seed(seed)
    outs = []
    for cond, cu in _batches(task, X_test, config, batch_size, dev):
        decs, scores = [], []
        for w in omegas:
            noise = torch.randn((cond.shape[0], cols, D), generator=gen, device=dev)
            dec, _ = _draw(task, apply_fn, sched, cond, cu, config, float(w), noise, sampler,
                           n_steps, skip)
            decs.append(dec)
            scores.append(task.objective(dec, cu, config))
        outs.append(select_best(torch.stack(decs), torch.stack(scores),
                                task.higher_is_better).cpu().numpy())
    return np.concatenate(outs)


def evaluate(task: Task, params: Dict[str, Any], sched: Schedule, data: TaskData,
             omega: Optional[float] = None, batch_size: int = 512, seed: int = 0,
             best_of: int = 1, sampler: str = "ddpm", n_steps: Optional[int] = None,
             refine_iters: int = 0, refine_step: Optional[float] = None,
             backend: str = "fused") -> Dict[str, float]:
    """The reference's metric block on ``data``'s test split: the objective
    ratio ("less_ratio" for maximization, "exceeded_ratio" for
    minimization: sum of the predicted objective over the labels'), the
    mean difference, the row count and the task's extra metrics.

    Samples with :func:`sample_solutions` (or :func:`sample_best_of_n` for
    ``best_of`` > 1) on the device of ``sched``; ``refine_iters`` > 0 then
    polishes the decoded rows with that many projected-gradient steps
    (:func:`refine_solutions`): a hybrid row, not single-draw parity.
    """
    if best_of > 1:
        Y_dec = sample_best_of_n(task, params, sched, data.X_test, data.config, n=best_of,
                                 omega=omega, batch_size=batch_size, seed=seed, sampler=sampler,
                                 n_steps=n_steps, backend=backend)
    else:
        Y_dec, _ = sample_solutions(task, params, sched, data.X_test, data.config, omega,
                                    batch_size, seed, sampler=sampler, n_steps=n_steps,
                                    backend=backend)
    dev = sched.betas.device
    if refine_iters > 0:
        X_unnorm = torch.as_tensor(np.asarray(task.unnormalize_x(data.X_test, data.config),
                                              np.float32), device=dev)
        Y_dec = refine_solutions(task, torch.as_tensor(Y_dec, device=dev), X_unnorm,
                                 data.config, refine_iters, refine_step).detach().cpu().numpy()
    with torch.inference_mode():
        pred, true, Y_true = _objectives(task, data, Y_dec, dev)
    metrics = {**_ratio_metrics(task, pred, true), "n_samples": float(len(pred))}
    if task.extra_metrics is not None:
        metrics.update(task.extra_metrics(Y_dec, Y_true, pred, true, data.config))
    return metrics

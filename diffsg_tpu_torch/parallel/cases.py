"""Cases that run on every rank of a mesh and return what rank 0 needs to
hold them against an unmeshed run.

Each is ``case(mesh, ...)`` on NumPy inputs that every rank gets whole; it
keeps the rank's rows where the batch is sharded and returns NumPy. They are
run by ``parallel.launch.spawn`` (``run`` runs several in one world), on the
card or in gloo processes on the CPU, and import nothing but the port:
``tests/test_torch_mesh.py`` holds them against the JAX package and the
unmeshed port.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import (Mesh, all_gather_rows, all_reduce_mean_grads_, gather_columns_,
                   param_shardings, shard_module_)


def run(mesh: Mesh, calls: Sequence[Tuple[str, tuple]]) -> List[Any]:
    """``[case(mesh, *args) for case, args in calls]``, cases by name."""
    return [globals()[name](mesh, *args) for name, args in calls]


def _unet(kw: Dict, params: Optional[Dict], device: torch.device):
    from ..models import UNet1D
    from ..utils.params import params_from_jax

    model = UNet1D(**kw)
    if params is not None:
        model.load_state_dict(params_from_jax(params), strict=True)
    return model.to(device)


def _rows(mesh: Mesh, a: np.ndarray, axis: int = 0) -> torch.Tensor:
    index = [slice(None)] * a.ndim
    index[axis] = mesh.rows(a.shape[axis])
    return torch.as_tensor(np.ascontiguousarray(a[tuple(index)]), device=mesh.device)


@torch.no_grad()
def sample(mesh: Mesh, model_kw: Dict, params: Dict, T: int, omega: float, cond: np.ndarray,
           init_noise: np.ndarray, step_noise: np.ndarray) -> np.ndarray:
    """``cfg_sample`` (no mask) on the rank's rows of ``cond`` and of the
    injected noise, the re-standardization over dp; the whole y_0."""
    from ..diffusion import cfg_sample, cosine_schedule

    model = _unet(model_kw, params, mesh.device)
    sched = cosine_schedule(T, device=mesh.device)
    with mesh.active():
        y0 = cfg_sample(model, sched, _rows(mesh, cond), omega, cond.shape[1],
                        init_noise=_rows(mesh, init_noise),
                        step_noise=_rows(mesh, step_noise, axis=1))
    return all_gather_rows(y0, mesh).cpu().numpy()


@torch.no_grad()
def decode(mesh: Mesh, Y: np.ndarray, valid: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    """``msr_decode``, ``nu_decode`` and ``masked_mean_var`` of the rank's
    rows under the mesh: the whole decode and the statistics."""
    from ..diffusion import masked_mean_var
    from ..ops import msr_decode, nu_decode

    y = _rows(mesh, Y)
    v = None if valid is None else _rows(mesh, valid)
    with mesh.active():
        msr = all_gather_rows(msr_decode(y[:, :3], v), mesh)
        nu = all_gather_rows(nu_decode(y, 400.0, 400.0, 18.0, v), mesh)
        mean, var = masked_mean_var(y, v)
    return {"msr": msr.cpu().numpy(), "nu": nu.cpu().numpy(),
            "mean": float(mean), "var": float(var)}


def solve(mesh: Mesh, ckpt: str, task: str, X: np.ndarray, backend: str,
          solve_kw: Dict, buckets: Optional[Sequence[int]] = None) -> Any:
    """A meshed ``Solver``'s answer to ``X``, or the message of the
    ValueError it raises (at construction or at the solve)."""
    from ..serve import Solver

    try:
        solver = Solver.from_checkpoint(ckpt, task=task, backend=backend, mesh=mesh,
                                        buckets=buckets)
        return solver.solve(X, **solve_kw)
    except ValueError as e:
        return f"ValueError: {e}"


def train(mesh: Mesh, model_kw: Dict, X: np.ndarray, Y: np.ndarray, cfg_kw: Dict,
          ckpt_dir: Optional[str], init: Dict, draws: Tuple[np.ndarray, ...]
          ) -> Dict[str, Any]:
    """``train_ddpm`` on the mesh: one epoch, checkpointed to ``ckpt_dir``
    (rank 0 writes), and a fresh run of two epochs; then one epoch from the
    params ``init`` on the injected ``draws`` (``perm``, ``t``, ``noise``,
    ``cond_mask``), in float32 and in float64. Returns the first run's
    params and EMA, both runs' logged losses, the params of the runs on
    injected draws and the names of the split parameters."""
    from ..models import UNet1D
    from ..train import EpochDraws, TrainConfig, train_ddpm

    specs = param_shardings(UNet1D(**model_kw), mesh)
    out: Dict[str, Any] = {"split": sorted(k for k, spec in specs.items() if spec)}
    for epochs in (1, 2):
        logged: List[str] = []
        params, ema, _ = train_ddpm(UNet1D(**model_kw), X, Y,
                                    TrainConfig(epochs=epochs, **cfg_kw), log_every=1,
                                    log_fn=logged.append, mesh=mesh,
                                    checkpoint_every=1 if epochs == 1 else 0,
                                    checkpoint_dir=ckpt_dir)
        out[f"losses_{epochs}"] = [float(m.rsplit(" ", 1)[1]) for m in logged]
        if epochs == 1:
            out["params"] = params
            out["ema"] = {k: v.cpu().numpy() for k, v in ema.params.items()}
    drawn = EpochDraws(*(torch.as_tensor(a) for a in draws))
    for dtype in (torch.float32, torch.float64):
        params, _, _ = train_ddpm(UNet1D(**model_kw).to(dtype), X, Y,
                                  TrainConfig(epochs=1, **cfg_kw), init_params=init,
                                  log_every=0, mesh=mesh, draws=lambda epoch: drawn)
        out[f"injected_{str(dtype).rsplit('.', 1)[1]}"] = params
    return out


def grads(mesh: Mesh, model_kw: Dict, params: Dict, X: np.ndarray, Y: np.ndarray,
          t: np.ndarray, noise: np.ndarray, cond_mask: np.ndarray, max_norm: float) -> Dict[str, Dict[str, np.ndarray]]:
    """One batch's gradients on the mesh: each rank's rows, averaged over
    dp, split kernels gathered whole; then the same after
    ``clip_by_global_norm(max_norm)`` on the shards."""
    from ..diffusion import cosine_schedule, ddpm_loss
    from ..train import clip_by_global_norm

    model = _unet(model_kw, params, mesh.device)
    split = shard_module_(model, mesh)
    sched = cosine_schedule(20, device=mesh.device)
    loss = ddpm_loss(model, sched, _rows(mesh, Y), _rows(mesh, X), t=_rows(mesh, t),
                     noise=_rows(mesh, noise), cond_mask=_rows(mesh, cond_mask))
    loss.backward()
    named = dict(model.named_parameters())
    all_reduce_mean_grads_(named.values(), mesh)

    def whole() -> Dict[str, np.ndarray]:
        return {k: (gather_columns_(p.grad, mesh) if k in split else p.grad).cpu().numpy().copy()
                for k, p in named.items()}

    raw = whole()
    with torch.no_grad():
        clip_by_global_norm([p.grad for p in named.values()], max_norm,
                            [k in split for k in named], mesh)
    return {"raw": raw, "clipped": whole(), "split": sorted(split)}

"""Serving API: a loaded checkpoint that turns conditions into solutions.

Counterpart of ``diffsg_tpu/serve.py::Solver`` on its single-draw path,
with the CFG-DDPM and DDIM samplers. Not ported yet: batch buckets, the
device mesh, best-of-N and refinement.

Example:
    from diffsg_tpu_torch.serve import Solver
    solver = Solver.from_checkpoint("ckpts/ddpm_msr_3c_T100", task="msr")
    P = solver.solve(X)                  # (B, 3) powers, each row sums to W

    nu = Solver.from_checkpoint("ckpts/ddpm_nu_3u_aug32_s8c", task="nu_direct",
                                backend="mega")
    S = nu.solve(X_users, omega=0.125, sampler="ddim", n_steps=3)   # (B, 5)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .diffusion.ddim import ddim_sample
from .diffusion.ddpm import cfg_sample
from .diffusion.schedule import Schedule
from .models.unet1d import UNet1D
from .models.unet1d_fused import unet_apply_fn
from .tasks import TASKS
from .tasks.base import Task
from .utils.checkpoint import load_checkpoint
from .utils.params import params_from_jax


class Solver:
    """A task, a denoiser and its schedule, on one device.

    ``backend`` picks the denoiser forward: "fused" (residual blocks through
    the CUDA kernel), "mega" (the whole forward as one launch of the
    whole-network kernel) or "plain"; on the CPU the kernels' plain
    versions run.
    """

    def __init__(self, task: Task, model: UNet1D, sched: Schedule, config: Dict,
                 backend: str = "fused"):
        self.task = task
        self.model = model
        self.sched = sched
        self.config = dict(config)
        self.device = sched.betas.device
        self._apply = unet_apply_fn(model, backend)
        self._D = task.data_dim(self.config)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, task: str = "msr",
                        device: DeviceLike = "cuda", backend: str = "fused",
                        dataset_config: Optional[Dict] = None) -> "Solver":
        """Load a ``diffsg_tpu.npz.v1`` checkpoint onto ``device``."""
        dev = resolve_device(device)
        ck = load_checkpoint(ckpt_dir, device=dev)
        config = dict(ck["metadata"].get("dataset_config") or {})
        config.update(dataset_config or {})
        t = TASKS[task]
        model = t.build_model(config)
        model.load_state_dict(params_from_jax(ck["params"]), strict=True)
        return cls(t, model.to(dev).eval(), ck["sched"], config, backend)

    @torch.inference_mode()
    def solve(self, X: np.ndarray, omega: Optional[float] = None, seed: int = 0,
              sampler: str = "ddpm", n_steps: Optional[int] = None, eta: float = 0.0,
              renorm_steps: Optional[int] = None) -> np.ndarray:
        """Conditions (B, C), loader-normalized -> decoded solutions (B, D).

        sampler: "ddpm" (the ancestral CFG sampler over all T steps) or
          "ddim" (over ``n_steps`` respaced steps, default T).
        eta / renorm_steps: DDIM only: its stochasticity, and the number of
          leading steps with batch re-standardization (default
          ``clamp(n // 5, 1, 4)``).

        The noise comes from a generator seeded with ``seed``. DDPM draws it
        row-major, (B, T+1, D): column 0 is y_T, columns 1.. the per-step
        z. DDIM draws y_T (B, D), then its per-step noise when ``eta > 0``.
        """
        if sampler not in ("ddpm", "ddim"):
            raise ValueError(f"unknown sampler {sampler!r}; use 'ddpm' or 'ddim'")
        if sampler == "ddpm" and (n_steps is not None or eta != 0.0 or renorm_steps is not None):
            raise ValueError("n_steps, eta and renorm_steps are DDIM options")
        omega = self.task.default_omega if omega is None else float(omega)
        cond = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        B, T = cond.shape[0], self.sched.T
        gen = torch.Generator(device=self.device).manual_seed(seed)
        param = self.config.get("parameterization", "eps")
        if sampler == "ddim":
            init = torch.randn((B, self._D), generator=gen, device=self.device)
            y0 = ddim_sample(self._apply, self.sched, cond, omega, self._D, generator=gen,
                             n_steps=n_steps, eta=eta, init_noise=init,
                             renorm_steps=renorm_steps, parameterization=param,
                             skip_uncond=omega == 0.0)
        else:
            flat = torch.randn((B, T + 1, self._D), generator=gen, device=self.device)
            y0 = cfg_sample(self._apply, self.sched, cond, omega, self._D,
                            init_noise=flat[:, 0], step_noise=flat[:, 1:].transpose(0, 1),
                            parameterization=param, skip_uncond=omega == 0.0)
        return self.task.decode(y0, self.config).cpu().numpy()

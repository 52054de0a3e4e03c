"""Classifier-free-guidance DDPM: the training loss and the reverse sampler.

Counterpart of ``diffsg_tpu/diffusion/ddpm.py``. The training side
(:func:`q_sample`, :func:`ddpm_loss`) draws a per-row timestep uniform in
``[0, T)``, noises ``y_t = sqrt(abar_t) y_0 + sqrt(1 - abar_t) eps``, drops
the condition with probability ``uncond_prob`` per row, shows the net the
normalized time ``t / T`` and takes the plain mean of the squared error.
The sampler keeps the reference numerics:

* the two CFG passes are folded into one forward of ``2B`` rows, rows
  ``[0:B]`` unconditional (mask 0) and ``[B:2B]`` conditional (mask 1),
  combined as ``(1 + omega) eps_cond - omega eps_uncond``;
* the time MLP runs at batch 1 (``t_norm = i / T``, shape (1,));
* ``y_{t-1} = (y_t - beta_t / sqrt(1 - abar_t) eps) / sqrt(alpha_t)
  + (1 - abar_{t-1}) / (1 - abar_t) z``, with the **un-square-rooted**
  variance ratio on ``z``, and ``z = 0`` for the last two steps (``i <= 1``);
* in the first ``renorm_steps`` steps the state is re-standardized over the
  whole batch tensor with the **unbiased** (ddof=1) variance, or over the
  valid rows when ``valid_mask`` is given.

``compute_dtype`` (e.g. ``torch.bfloat16``) runs the denoiser forward in that
type and keeps the CFG combine and the reverse step in float32.
``record_trace`` returns the per-step trajectory beside ``y_0``.
``guidance_fn`` tilts each step's epsilon by the gradient of a per-row
cost at the step's ``x0`` estimate (objective guidance).

``omega`` may be a Python number or a 0-d tensor on ``cond``'s device: a
tensor keeps one captured CUDA graph valid for every guidance scale.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch

from .. import obs
from ..parallel.mesh import all_reduce_sum, current_mesh
from .schedule import Schedule

# apply_fn(y_t, t_norm, cond, cond_mask) -> model output (B, D)
ApplyFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
Omega = Union[float, torch.Tensor]


def q_sample(sched: Schedule, y0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """The forward (noising) process: ``y_t | y_0`` for integer ``t`` (B,)
    in ``[0, T)``."""
    return (sched.sqrt_alphas_cumprod[t][:, None] * y0
            + sched.sqrt_one_minus_alphas_cumprod[t][:, None] * noise)


def ddpm_draws(T: int, shape: Tuple[int, int], uncond_prob: float,
               generator: Optional[torch.Generator], device: torch.device, dtype: torch.dtype,
               t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
               cond_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The loss's draws for a batch of ``shape`` (B, D), those not given
    drawn from ``generator`` in this order: ``t`` uniform in ``[0, T)``,
    ``noise`` standard normal, ``cond_mask`` Bernoulli with keep-probability
    ``1 - uncond_prob``."""
    B = shape[0]
    if t is None:
        t = torch.randint(0, T, (B,), generator=generator, device=device)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    if cond_mask is None:
        keep = torch.full((B, 1), 1.0 - uncond_prob, device=device, dtype=dtype)
        cond_mask = torch.bernoulli(keep, generator=generator)
    return t, noise, cond_mask


def ddpm_loss(apply_fn: ApplyFn, sched: Schedule, y0: torch.Tensor, cond: torch.Tensor,
              uncond_prob: float = 0.1, parameterization: str = "eps", *,
              t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
              cond_mask: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The CFG training loss: the mean squared error of the net's output
    against epsilon (``"eps"``, the reference), ``y_0`` (``"x0"``) or the
    velocity ``sqrt(abar_t) eps - sqrt(1 - abar_t) y_0`` (``"v"``).

    The draws may be given: ``t`` (B,) integers in ``[0, T)``, ``noise``
    (B, D) and ``cond_mask`` (B, 1) of 1.0 (keep the condition) and 0.0
    (drop it). Those not given are drawn from ``generator`` (on ``y0``'s
    device): ``t`` uniform, ``noise`` standard normal and ``cond_mask``
    Bernoulli with keep-probability ``1 - uncond_prob``, in that order.
    """
    if parameterization not in ("eps", "x0", "v"):
        raise ValueError(f"unknown parameterization {parameterization!r}")
    B, T, dev, dtype = y0.shape[0], sched.T, y0.device, y0.dtype
    if t is None or noise is None or cond_mask is None:
        t, noise, cond_mask = ddpm_draws(T, y0.shape, uncond_prob, generator, dev, dtype,
                                         t, noise, cond_mask)
    y_t = q_sample(sched, y0, t, noise)
    pred = apply_fn(y_t, t.to(dtype) / T, cond, cond_mask)
    if parameterization == "eps":
        target = noise
    elif parameterization == "x0":
        target = y0
    else:
        target = (sched.sqrt_alphas_cumprod[t][:, None] * noise
                  - sched.sqrt_one_minus_alphas_cumprod[t][:, None] * y0)
    return ((target - pred) ** 2).mean()


class SampleTrace(NamedTuple):
    """The per-step trajectory of :func:`cfg_sample`, each (T, B, D):
    ``ys[s]`` the state and ``eps[s]`` the CFG-combined epsilon after reverse
    step ``s`` (s = 0 is the first, t = T-1)."""

    ys: torch.Tensor
    eps: torch.Tensor


def masked_mean_var(y: torch.Tensor, valid_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and unbiased variance over the valid rows (``valid_mask`` (B, 1),
    1.0 real / 0.0 padding; None: every row, as ``y.mean()``, ``y.var()``).

    Under an active mesh (``parallel.mesh``) ``y`` is the rank's shard: the
    sum and the count are summed over dp, then the sum of squares about the
    global mean, so the statistics are the whole batch's."""
    mesh = current_mesh()
    if valid_mask is None and mesh is None:
        return y.mean(), y.var()
    if valid_mask is None:
        cnt = y.new_full((), float(y.numel()))
        total = y.sum()
    else:
        cnt = valid_mask.sum() * y.shape[1]
        total = (y * valid_mask).sum()
    if mesh is not None:
        total, cnt = all_reduce_sum(torch.stack([total, cnt]), mesh).unbind()
    mean = total / cnt
    sq = (y - mean) ** 2
    sq = (sq if valid_mask is None else valid_mask * sq).sum()
    if mesh is not None:
        sq = all_reduce_sum(sq, mesh)
    return mean, sq / (cnt - 1.0)


def cfg_net(apply_fn: ApplyFn, cond: torch.Tensor, omega: Omega, skip_uncond: bool,
            compute_dtype: Optional[torch.dtype] = None
            ) -> Callable[[torch.Tensor, torch.Tensor, Tuple[int, int]], torch.Tensor]:
    """``net_cfg(y_t, t_norm, step)``: the CFG-combined denoiser output at
    the sampler's step ``(i, T)``, ``t_norm`` being ``i / T``.

    The two CFG passes are folded into one forward of 2B rows (rows [0:B]
    unconditional, [B:2B] conditional) and combined as
    ``(1 + omega) eps_cond - omega eps_uncond``; with ``skip_uncond`` only
    the conditional half runs. With ``compute_dtype`` the forward's inputs
    are cast to it and its output back to ``cond``'s type.

    An ``apply_fn`` with a ``prepare(cond, cond_mask)`` method (the fused
    backend's, ``models.unet1d_fused.FusedApplyFn``) is handed the fixed
    condition and mask once, here, and each step runs the forward it
    returned, keyed by ``step``; any other is called once a step.
    """
    B, dtype, dev = cond.shape[0], cond.dtype, cond.device
    if skip_uncond:
        c, m = cond, torch.ones((B, 1), dtype=dtype, device=dev)
    else:
        c = torch.cat([cond, cond], dim=0)
        m = torch.cat([torch.zeros((B, 1), dtype=dtype, device=dev),
                       torch.ones((B, 1), dtype=dtype, device=dev)], dim=0)
    prepare = getattr(apply_fn, "prepare", None) if compute_dtype is None else None
    prepared = prepare(c, m) if prepare is not None else None

    def forward(y, t_norm, step):
        if prepared is not None:
            return prepared(y, t_norm, step)
        if compute_dtype is None:
            return apply_fn(y, t_norm, c, m)
        cd = compute_dtype
        return apply_fn(y.to(cd), t_norm.to(cd), c.to(cd), m.to(cd)).to(dtype)

    if skip_uncond:
        return forward

    w_cond = 1.0 + omega

    def net_cfg(y_t, t_norm, step):
        eps2 = forward(torch.cat([y_t, y_t], dim=0), t_norm, step)
        return w_cond * eps2[B:] - omega * eps2[:B]
    return net_cfg


def _reverse_step(sched: Schedule, y_t: torch.Tensor, i: int, eps_cfg: torch.Tensor,
                  z: Optional[torch.Tensor], T: int, renorm_steps: int,
                  valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One reverse-diffusion update with the reference's coefficients;
    ``z`` is None where the reference draws no noise."""
    y_next = (y_t - sched.remove_noise_coeff[i] * eps_cfg) * sched.reciprocal_sqrt_alphas[i]
    if z is not None:
        prev = max(i - 1, 0)
        noise_coeff = (1.0 - sched.alphas_cumprod[prev]) / (1.0 - sched.alphas_cumprod[i])
        y_next = y_next + noise_coeff * z
    if i > T - 1 - renorm_steps:
        mean, var = masked_mean_var(y_next, valid_mask)
        y_next = (y_next - mean) / torch.sqrt(var)
    return y_next


@torch.no_grad()
def cfg_sample(
    apply_fn: ApplyFn,
    sched: Schedule,
    cond: torch.Tensor,
    omega: Omega,
    data_dim: int,
    generator: Optional[torch.Generator] = None,
    init_noise: Optional[torch.Tensor] = None,
    step_noise: Optional[torch.Tensor] = None,
    renorm_steps: int = 4,
    valid_mask: Optional[torch.Tensor] = None,
    parameterization: str = "eps",
    skip_uncond: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    record_trace: bool = False,
    guidance_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    guidance_scale: float = 0.0,
    guidance_relative: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, SampleTrace]]:
    """Batched CFG reverse sampler; returns ``y_0`` (B, data_dim), or
    ``(y_0, SampleTrace)`` with ``record_trace``.

    Args:
      apply_fn: the denoiser, ``apply_fn(y_t, t_norm, cond, cond_mask)``.
      sched: coefficient table (defines T), on ``cond``'s device.
      cond: (B, C) conditions.
      omega: guidance scale.
      data_dim: solution dimensionality D.
      generator: draws the noise that is not supplied.
      init_noise: optional (B, D) y_T.
      step_noise: optional (T, B, D) per-step z; entry s is used at step
        i = T-1-s, and the entries for i <= 1 are ignored.
      renorm_steps: number of initial steps with batch re-standardization.
      valid_mask: optional (B, 1) 1.0/0.0 mask restricting the
        re-standardization statistics to the valid rows.
      parameterization: "eps", "x0" or "v" — what the denoiser predicts;
        each step that turns x0 or v into epsilon counts in ``obs``'s
        ``x0_steps``.
      skip_uncond: run only the conditional half (exact at omega == 0).
      compute_dtype: optional type of the denoiser forward: y, t, cond and
        mask are cast to it and the output back to ``cond``'s type, so the
        CFG combine and the reverse step stay float32. Pair it with an
        ``apply_fn`` built for that type (``unet_apply_fn(model, "mega",
        compute_dtype=...)``).
      record_trace: also return the state and the CFG-combined epsilon
        after every step (``SampleTrace``, each (T, B, D)).
      guidance_fn: optional per-row cost ``(B, D) -> (B,)``, differentiable
        with ``torch.autograd``. Each step adds
        ``guidance_scale * sqrt(1 - abar_i) * grad(sum cost)(x0_hat)`` to
        the epsilon, the gradient taken at ``x0_hat = (y_t - sqrt(1 -
        abar_i) eps) / sqrt(abar_i)`` as a leaf (not through the denoiser).
        Tensors it closes over must not be inference tensors.
      guidance_scale: the tilt's scale; 0 leaves the epsilon as it is.
      guidance_relative: normalize the gradient per row and scale the tilt
        by the row's epsilon RMS instead of ``sqrt(1 - abar_i)``.
    """
    if parameterization not in ("eps", "x0", "v"):
        raise ValueError(f"unknown parameterization {parameterization!r}")
    B = cond.shape[0]
    T = sched.T
    dtype, dev = cond.dtype, cond.device
    if init_noise is None or step_noise is None:
        if generator is None:
            raise ValueError("cfg_sample needs a generator when noise is not supplied")
        if init_noise is None:
            init_noise = torch.randn((B, data_dim), generator=generator, dtype=dtype, device=dev)
        if step_noise is None:
            step_noise = torch.randn((T, B, data_dim), generator=generator, dtype=dtype, device=dev)

    net_cfg = cfg_net(apply_fn, cond, omega, skip_uncond, compute_dtype)

    y = init_noise
    ys, epss = [], []
    for s, i in enumerate(range(T - 1, -1, -1)):
        t_norm = torch.full((1,), i, dtype=dtype, device=dev) / T
        eps = net_cfg(y, t_norm, (i, T))
        if parameterization == "x0":
            eps = (y - sched.sqrt_alphas_cumprod[i] * eps) / sched.sqrt_one_minus_alphas_cumprod[i]
        elif parameterization == "v":
            eps = sched.sqrt_one_minus_alphas_cumprod[i] * y + sched.sqrt_alphas_cumprod[i] * eps
        if parameterization != "eps":
            obs.count("x0_steps", 1, y)
        if guidance_fn is not None:
            sq1m = sched.sqrt_one_minus_alphas_cumprod[i]
            x0_hat = (y - sq1m * eps) / sched.sqrt_alphas_cumprod[i]
            with torch.enable_grad():
                x = x0_hat.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(guidance_fn(x).sum(), x)
            if guidance_relative:
                g = g / (torch.linalg.norm(g, dim=1, keepdim=True) + 1e-8)
                eps_rms = torch.sqrt((eps ** 2).mean(dim=1, keepdim=True))
                eps = eps + guidance_scale * eps_rms * g
            else:
                eps = eps + guidance_scale * sq1m * g
        z = step_noise[s] if i > 1 else None
        y = _reverse_step(sched, y, i, eps, z, T, renorm_steps, valid_mask)
        if record_trace:
            ys.append(y)
            epss.append(eps)
    if record_trace:
        return y, SampleTrace(torch.stack(ys), torch.stack(epss))
    return y

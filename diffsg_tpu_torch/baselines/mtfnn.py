"""MTFNN baseline: supervised MLP regressors (reference ``baselines/MTFNN.py``).

Counterpart of ``diffsg_tpu/baselines/mtfnn.py``. Three per-task MLPs
trained with MSE on the oracle labels, with the reference's architectures
and layer names (``lin1..linN``), so that its ``mtfnn_*.pt`` files and the
JAX package's npz checkpoints load strictly:

* CO (``MTFNN.py:44-53``): 9 -> 32 -> 64 -> 16 -> 3, ReLU, sigmoid head;
* MSR (``MTFNN.py:123-132``): M -> 8 -> 16 -> 8 -> M, ReLU, softmax head;
* NU (``MTFNN.py:187-211``): 2K -> 64 -> 32 -> 16 -> 32 -> (2+K), ReLU, a
  split head: sigmoid on the 2 coordinates, softmax on the K powers.

Training defaults are the reference's: Adam 5e-3, batch 512, CO and MSR 50
epochs with the milestone [20], NU 100 epochs with [20, 60], and its
``init_weights`` (N(0, 0.01) Linear weights) applied first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.unet1d import Dense
from ..train.init import torch_style_init
from ..train.trainer import Optimizer, multistep_lr
from ..utils.params import params_from_jax, params_to_jax
from ..utils.torch_import import load_torch_state_dict, sequential_mlp_from_torch

HEADS = ("none", "sigmoid", "softmax", "nu_split")


class MLP(nn.Module):
    """``lin1..linN`` Dense layers with ReLU between them and a head."""

    def __init__(self, in_dim: int, features: Sequence[int], head: str = "none"):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r}; use one of {HEADS}")
        self.head = head
        dims = [in_dim, *features]
        for i in range(len(features)):
            self.add_module(f"lin{i + 1}", Dense(dims[i], dims[i + 1]))
        self.n_layers = len(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"lin{i + 1}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(x)
        if self.head == "sigmoid":
            return torch.sigmoid(x)
        if self.head == "softmax":
            return torch.softmax(x, dim=1)
        if self.head == "nu_split":
            return torch.cat([torch.sigmoid(x[:, :2]), torch.softmax(x[:, 2:], dim=1)], dim=1)
        return x


def mtfnn_co_model() -> MLP:
    return MLP(9, (32, 64, 16, 3), head="sigmoid")


def mtfnn_msr_model(M: int = 3) -> MLP:
    return MLP(M, (8, 16, 8, M), head="softmax")


def mtfnn_nu_model(K: int = 3) -> MLP:
    return MLP(2 * K, (64, 32, 16, 32, 2 + K), head="nu_split")


def load_mtfnn_ckpt(path: str, n_layers: int) -> Dict[str, torch.Tensor]:
    """A reference ``mtfnn_*.pt`` as the state dict the port's MLP loads."""
    return sequential_mlp_from_torch(load_torch_state_dict(path),
                                     [f"lin{i + 1}" for i in range(n_layers)])


@dataclasses.dataclass(frozen=True)
class MTFNNConfig:
    epochs: int = 50
    batch_size: int = 512
    lr: float = 5e-3
    milestones: Sequence[int] = (20,)
    seed: int = 0


def train_mtfnn(model: MLP, X_train: np.ndarray, Y_train: np.ndarray,
                cfg: MTFNNConfig = MTFNNConfig(), log_fn: Callable[[str], None] = print,
                log_every: int = 10, init_params: Optional[Dict[str, Any]] = None,
                device: DeviceLike = "cuda",
                draws: Optional[Callable[[int], torch.Tensor]] = None) -> Dict[str, Any]:
    """MSE regression on ``device``; ``model`` is moved there and trained in
    place. Returns its parameters as the flax tree (``save_checkpoint`` and
    ``params_from_jax`` take it).

    Starts from ``init_params`` (a flax tree) when given, else from
    :func:`torch_style_init` with a generator seeded by ``cfg.seed``. Each
    epoch takes ``floor(n/B)`` full batches of one permutation, ``B =
    min(batch_size, n)``: from ``draws(epoch)`` (n,) where given, else from
    a generator on the device seeded by ``cfg.seed``. Adam at the
    MultiStepLR rate, as the JAX package's optax chain.
    """
    dev = resolve_device(device)
    model.to(dev)
    if init_params is not None:
        model.load_state_dict(params_from_jax(init_params), strict=True)
    else:
        torch_style_init(model, torch.Generator().manual_seed(cfg.seed))
    n = X_train.shape[0]
    batch = min(cfg.batch_size, n)
    steps = max(n // batch, 1)
    optimizer = Optimizer(multistep_lr(cfg.lr, cfg.milestones, steps))
    adam = optimizer.init(model)
    X = torch.as_tensor(np.asarray(X_train), dtype=torch.float32).to(dev)
    Y = torch.as_tensor(np.asarray(Y_train), dtype=torch.float32).to(dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed) if draws is None else None
    step = 0
    for epoch in range(cfg.epochs):
        perm = (torch.randperm(n, generator=gen, device=dev) if draws is None
                else draws(epoch).to(dev))[: steps * batch]
        losses = []
        for s in range(steps):
            idx = perm[s * batch:(s + 1) * batch]
            with torch.enable_grad():
                loss = torch.mean((Y[idx] - model(X[idx])) ** 2)
                adam.zero_grad(set_to_none=True)
                loss.backward()
            optimizer.apply(adam, step)
            step += 1
            losses.append(loss.detach())
        if log_every and (epoch % log_every == 0 or epoch == cfg.epochs - 1):
            log_fn(f"mtfnn epoch {epoch}: loss {float(torch.stack(losses).mean()):.6f}")
    return params_to_jax(model)

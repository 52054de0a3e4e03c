"""PPO baseline: one-step contextual-bandit PPO (reference ``baselines/PPO.py``).

Counterpart of ``diffsg_tpu/baselines/ppo.py``. The "environment" is
stateless: a reward shaped from the task objective,
``1 / (|obj(action) - obj(ground truth)| + eps)`` (``PPO.py:89-100,
216-228, 347-361``). The advantage uses the reference's constant bootstrap
``returns = r + gamma * 3.8`` (``PPO.py:73-80``) and the clipped surrogate
with epsilon 0.2 (``:82-86``).

Architecture (``PPO.py:33-70``): critic and actor are 4-Linear Tanh trunks
(state -> 64 -> 16 -> 32 -> out) with orthogonal weights (gain sqrt 2, the
heads 1.0 and 0.01) and zero biases, plus a ``log_std`` parameter. The
Linear layers sit at the torch ``nn.Sequential`` indices 0, 2, 4 and 6, so
the reference's ``ppo_*.pt`` files and the JAX package's npz checkpoints
(``critic/0/kernel``, ...) map one to one.

The reference's quirks are kept: its two optimizers cover the actor and
the critic only, so ``log_std`` is never optimized and stays 0 (std 1);
the rows are trimmed to ``steps * B`` up front; the first epoch's old
log-probs come from N(0.5, 0.2) draws; the advantage takes the value of the
forward before the update, detached; both gradients are taken at the same
parameters before either Adam steps; the next epoch's rows are this epoch's
permuted order with the fresh log-probs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..models.unet1d import Dense
from ..train.trainer import Optimizer, multistep_lr
from ..utils.params import params_from_jax, params_to_jax
from ..utils.torch_import import load_torch_state_dict, sequential_mlp_from_torch

_TRUNK = (64, 16, 32)


def _trunk(in_dim: int, out_dim: int) -> nn.Sequential:
    """Linear-Tanh x3 -> Linear; the Linears at indices 0, 2, 4, 6."""
    dims = [in_dim, *_TRUNK]
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        layers += [Dense(a, b), nn.Tanh()]
    return nn.Sequential(*layers, Dense(dims[-1], out_dim))


class PPOAgent(nn.Module):
    def __init__(self, state_dim: int, action_dim: int):
        super().__init__()
        self.state_dim, self.action_dim = state_dim, action_dim
        self.critic = _trunk(state_dim, 1)
        self.actor = _trunk(state_dim, action_dim)
        self.log_std = nn.Parameter(torch.zeros(1, action_dim))

    def forward(self, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(value (B, 1), mu (B, A), std (1, A))."""
        return self.critic(state), self.actor(state), torch.exp(self.log_std)


@torch.no_grad()
def orthogonal_ppo_init(agent: PPOAgent, generator: torch.Generator) -> PPOAgent:
    """The reference's ``layer_init`` (``PPO.py:28-31``), in place:
    ``torch.nn.init.orthogonal_`` on each Linear's (out, in) weight with
    gain sqrt 2 (1.0 for the critic's head, 0.01 for the actor's), zero
    biases, ``log_std`` 0. The draws come from ``generator`` on the CPU."""
    for trunk, head_gain in ((agent.critic, 1.0), (agent.actor, 0.01)):
        for i in (0, 2, 4, 6):
            dense = trunk[i]
            w = torch.empty(dense.kernel.shape[::-1])
            nn.init.orthogonal_(w, gain=head_gain if i == 6 else math.sqrt(2),
                                generator=generator)
            dense.kernel.copy_(w.t())
            dense.bias.zero_()
    agent.log_std.zero_()
    return agent


def load_ppo_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``ppo_*.pt`` as the state dict ``PPOAgent`` loads."""
    sd = load_torch_state_dict(path)
    state = {"log_std": sd["log_std"].to(torch.float32).clone()}
    for trunk in ("critic", "actor"):
        layers = sequential_mlp_from_torch(sd, ("0", "2", "4", "6"), prefix=f"{trunk}.")
        state.update({f"{trunk}.{k}": v for k, v in layers.items()})
    return state


def normal_log_prob(x: torch.Tensor, mu, std) -> torch.Tensor:
    """Elementwise Normal log-density (``torch.distributions.Normal.log_prob``);
    ``mu`` and ``std`` tensors or numbers."""
    log_std = torch.log(std) if isinstance(std, torch.Tensor) else math.log(std)
    return -((x - mu) ** 2) / (2 * std ** 2) - log_std - 0.5 * math.log(2 * math.pi)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    epochs: int = 200
    batch_size: int = 512
    lr: float = 5e-3
    milestones: Sequence[int] = (20, 100)
    gamma: float = 0.99
    bootstrap: float = 3.8
    clip_eps: float = 0.2
    seed: int = 0


class PPODraws(NamedTuple):
    """The draws of one epoch of ``steps`` batches of ``B`` rows: ``perm``
    (steps * B,) row indices and ``noise`` (steps, B, A) standard normals
    for the actions."""

    perm: torch.Tensor
    noise: torch.Tensor


def train_ppo(agent: PPOAgent, X_train: np.ndarray, Y_train: np.ndarray,
              env_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
              action_transform: Callable[[torch.Tensor], torch.Tensor],
              cfg: PPOConfig = PPOConfig(), log_fn: Callable[[str], None] = print,
              log_every: int = 20, init_params: Optional[Dict[str, Any]] = None,
              device: DeviceLike = "cuda", a0: Optional[np.ndarray] = None,
              draws: Optional[Callable[[int], PPODraws]] = None) -> Tuple[Dict[str, Any], Dict]:
    """Contextual-bandit PPO on ``device`` (reference ``ppo_co`` et al.);
    ``agent`` is moved there and trained in place. Returns (params as the
    flax tree, {}).

    ``env_fn(x, decoded_action, y_true)`` -> rewards (B,);
    ``action_transform(raw_action)`` -> the decoded action ``env_fn`` scores.

    Starts from ``init_params`` (a flax tree) when given, else from
    :func:`orthogonal_ppo_init` with a generator seeded by ``cfg.seed``.
    ``a0`` (n, A), the standard-normal draws behind the first old
    log-probs, and ``draws(epoch)`` replace the draws of a generator on the
    device seeded by ``cfg.seed``.
    """
    dev = resolve_device(device)
    agent.to(dev)
    if init_params is not None:
        agent.load_state_dict(params_from_jax(init_params), strict=True)
    else:
        orthogonal_ppo_init(agent, torch.Generator().manual_seed(cfg.seed))
    B = min(cfg.batch_size, X_train.shape[0])
    steps = max(X_train.shape[0] // B, 1)
    # The next epoch's rows are exactly steps * B: trim up front, so every
    # epoch permutes the same row count.
    n = steps * B
    X = torch.as_tensor(np.asarray(X_train[:n]), dtype=torch.float32).to(dev)
    Y = torch.as_tensor(np.asarray(Y_train[:n]), dtype=torch.float32).to(dev)
    # One Adam over both trunks takes the steps of the reference's two (Adam
    # is per parameter, the schedules are equal); log_std is in neither.
    optimizer = Optimizer(multistep_lr(cfg.lr, cfg.milestones, steps))
    adam = torch.optim.Adam([*agent.actor.parameters(), *agent.critic.parameters()],
                            lr=optimizer.lr(0), betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed) if draws is None else None

    # The first old log-probs, from N(0.5, 0.2) draws (PPO.py:126-132).
    z0 = (torch.randn(Y.shape, generator=gen, device=dev) if a0 is None
          else torch.tensor(np.asarray(a0), dtype=torch.float32, device=dev))
    old_lp = normal_log_prob(0.5 + 0.2 * z0, 0.5, 0.2)

    step = 0
    for epoch in range(cfg.epochs):
        if draws is None:
            perm = torch.randperm(n, generator=gen, device=dev)
            noise = torch.randn((steps, B, Y.shape[1]), generator=gen, device=dev)
        else:
            d = draws(epoch)
            perm, noise = d.perm.to(dev), d.noise.to(dev)
        X, Y, old_lp = X[perm], Y[perm], old_lp[perm]
        new_lps, stats = [], []
        for s in range(steps):
            sl = slice(s * B, (s + 1) * B)
            xb, yb = X[sl], Y[sl]
            with torch.enable_grad():
                value, mu, std = agent(xb)
                std = std.detach()               # log_std: no gradient, never optimized
                with torch.no_grad():
                    actions = mu + std * noise[s]
                    new_lp = normal_log_prob(actions, mu, std)
                    rewards = env_fn(xb, action_transform(actions), yb)
                    returns = (rewards + cfg.gamma * cfg.bootstrap)[:, None]
                ratio = torch.exp(normal_log_prob(actions, mu, std) - old_lp[sl])
                adv = returns - value.detach()
                clipped = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
                actor_loss = -torch.mean(torch.minimum(ratio * adv, clipped))
                critic_loss = torch.mean((value - returns) ** 2)
                adam.zero_grad(set_to_none=True)
                # The two losses share no optimized parameter: one backward
                # gives each trunk its own loss's gradient.
                (actor_loss + critic_loss).backward()
            optimizer.apply(adam, step)
            step += 1
            new_lps.append(new_lp)
            stats.append(torch.stack([actor_loss.detach(), critic_loss.detach(),
                                      rewards.mean()]))
        old_lp = torch.cat(new_lps)
        if log_every and (epoch % log_every == 0 or epoch == cfg.epochs - 1):
            al, cl, rw = torch.stack(stats).mean(dim=0).tolist()
            log_fn(f"ppo epoch {epoch}: actor {al:.4f} critic {cl:.4f} reward {rw:.4f}")
    return params_to_jax(agent), {}


@torch.inference_mode()
def ppo_predict(agent: PPOAgent, X: np.ndarray,
                action_transform: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Deterministic eval (PPO.py:322-328): the mean action of every row of
    ``X`` in one forward, on the agent's device, then ``action_transform``.
    One call for the whole split: the NU transform's min-max is
    batch-global."""
    dev = next(agent.parameters()).device
    _, mu, _ = agent(torch.as_tensor(np.asarray(X), dtype=torch.float32).to(dev))
    return action_transform(mu)

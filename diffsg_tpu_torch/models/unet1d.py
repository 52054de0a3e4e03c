"""UNet1D — the classifier-free conditional denoiser, plain PyTorch.

Counterpart of ``diffsg_tpu/models/unet1d.py``: a U-Net over feature
vectors, where every op is a Linear, a per-row LayerNorm or a Swish and the
"resolutions" are feature widths. Module names and parameter layouts are
flax's (see ``utils/params.py``), so a ``diffsg_tpu.npz.v1`` checkpoint
loads strictly.

This module is the plain forward. ``models/unet1d_fused.py`` runs the same
parameters with every ResidualBlock through the hand-written CUDA kernel.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import tp_linear

# torch nn.LayerNorm's epsilon, pinned in the JAX package too.
_LN_EPS = 1e-5


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with flax's (in, out) kernel layout.

    ``tp`` is the mesh over whose tp axis ``parallel.mesh.shard_params``
    split the kernel by columns (None: whole): the Dense then computes its
    columns and gathers the output."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.empty(out_dim))
        self.tp = None
        bound = 1.0 / math.sqrt(in_dim)
        nn.init.uniform_(self.kernel, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return tp_linear(x, self.kernel, self.bias, self.tp)
        return torch.matmul(x, self.kernel) + self.bias


class LayerNorm(nn.Module):
    """Per-row LayerNorm with flax's parameter names (``scale``, ``bias``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, _LN_EPS)


class TimeEmbedding(nn.Module):
    """Sinusoidal time embedding + 2-layer MLP. ``in_dim = proj_dim * 4``."""

    def __init__(self, in_dim: int):
        super().__init__()
        self.in_dim = in_dim
        self.lin1 = Dense(in_dim // 4, in_dim)
        self.lin2 = Dense(in_dim, in_dim)

    def sinusoid(self, t: torch.Tensor) -> torch.Tensor:
        """(B, in_dim // 4) sin and cos features of ``t``, in ``t``'s type."""
        half = self.in_dim // 8
        freq = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device)
                         * -(math.log(10_000) / (half - 1)))
        emb = t[:, None] * freq[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.lin2(swish(self.lin1(self.sinusoid(t))))


class ResidualBlock(nn.Module):
    """3x (LayerNorm -> Swish -> Linear) with the time embedding added after
    lin1 and the condition after lin2; a Linear shortcut iff widths differ."""

    def __init__(self, in_dim: int, out_dim: int, time_dim: int, cond_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(in_dim)
        self.lin1 = Dense(in_dim, out_dim)
        self.time_emb = Dense(time_dim, out_dim)
        self.norm2 = LayerNorm(out_dim)
        self.lin2 = Dense(out_dim, out_dim)
        self.cond_emb = Dense(cond_dim, out_dim)
        self.norm3 = LayerNorm(out_dim)
        self.lin3 = Dense(out_dim, out_dim)
        self.shortcut = Dense(in_dim, out_dim) if in_dim != out_dim else None

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        h = self.lin1(swish(self.norm1(x)))
        h = h + self.time_emb(swish(t))
        h = self.lin2(swish(self.norm2(h)))
        h = h + self.cond_emb(swish(cond))
        h = self.lin3(swish(self.norm3(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return h + x


class AttentionBlock(nn.Module):
    """Single-token self-attention. The sequence has length 1, so the
    softmax over it is 1 and q and k are dead: the block is ``output(v) +
    x``. Its LayerNorm ``norm`` is built and never applied, as in the
    reference, so checkpoints of attention nets carry over 1:1."""

    def __init__(self, in_dim: int, n_heads: int = 1):
        super().__init__()
        self.n_heads = n_heads
        self.norm = LayerNorm(in_dim)
        self.projection = Dense(in_dim, n_heads * in_dim * 3)
        self.output = Dense(n_heads * in_dim, in_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d_k = self.output.kernel.shape[1]
        qkv = self.projection(x).reshape(x.shape[0], self.n_heads, 3 * d_k)
        v = qkv[..., 2 * d_k:]
        return self.output(v.reshape(x.shape[0], -1)) + x


class DownBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, time_dim: int, cond_dim: int,
                 has_attn: bool = False):
        super().__init__()
        self.res = ResidualBlock(in_dim, out_dim, time_dim, cond_dim)
        self.attn = AttentionBlock(out_dim) if has_attn else None

    def forward(self, x, t, cond):
        x = self.res(x, t, cond)
        return x if self.attn is None else self.attn(x)


class UpBlock(nn.Module):
    """Input is ``in_dim + out_dim`` wide: the skip concat."""

    def __init__(self, in_dim: int, out_dim: int, time_dim: int, cond_dim: int,
                 has_attn: bool = False):
        super().__init__()
        self.res = ResidualBlock(in_dim + out_dim, out_dim, time_dim, cond_dim)
        self.attn = AttentionBlock(out_dim) if has_attn else None

    def forward(self, x, t, cond):
        x = self.res(x, t, cond)
        return x if self.attn is None else self.attn(x)


class MiddleBlock(nn.Module):
    def __init__(self, dim: int, time_dim: int, cond_dim: int, has_attn: bool = False):
        super().__init__()
        self.res1 = ResidualBlock(dim, dim, time_dim, cond_dim)
        self.attn = AttentionBlock(dim) if has_attn else None
        self.res2 = ResidualBlock(dim, dim, time_dim, cond_dim)

    def forward(self, x, t, cond):
        x = self.res1(x, t, cond)
        if self.attn is not None:
            x = self.attn(x)
        return self.res2(x, t, cond)


class Resample(nn.Module):
    """Plain Linear feature resize (both Up- and Downsample)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin = Dense(in_dim, out_dim)

    def forward(self, x):
        return self.lin(x)


def unet_topology(dims: Sequence[int], n_blocks: int) -> Tuple[List[str], List[str]]:
    """Down/up module-kind lists ("block" or "resample"), index-aligned with
    the ``down_{i}`` / ``up_{i}`` module names."""
    n_res = len(dims)
    down, up = [], []
    for i in range(n_res):
        down += ["block"] * n_blocks + ["resample"]
        if i == n_res - 1:
            down += ["block"] * n_blocks
    for i in reversed(range(n_res)):
        up += ["block"] * (n_blocks + 1) + ["resample"]
        if i == 0:
            up += ["block"] * (n_blocks + 1)
    return down, up


class UNet1D(nn.Module):
    """The full denoiser. ``forward(x, t, cond, cond_mask)``: x (B, input_dim),
    t (B,) or (1,) normalized time, cond (B, cond_dim), cond_mask (B, 1) with
    1.0 = keep the condition, 0.0 = drop it.

    ``is_attn[i]`` puts an :class:`AttentionBlock` after every block of
    level i, ``middle_attn`` one between the middle's two blocks. No shipped
    configuration uses them; the ``plain`` backend runs them, and ``fused``
    and ``mega`` raise on them, as the JAX package's kernels do.
    """

    def __init__(self, input_dim: int = 3, proj_dim: int = 16, cond_dim: int = 4,
                 dims: Sequence[int] = (8, 4, 2),
                 is_attn: Sequence[bool] = (False, False, False),
                 middle_attn: bool = False, n_blocks: int = 2):
        super().__init__()
        # A shorter is_attn (the 3-level default on a deeper net) means no
        # attention on the levels it does not name.
        self.is_attn = tuple(bool(a) for a in is_attn) + (False,) * (len(dims) - len(is_attn))
        self.middle_attn = bool(middle_attn)
        self.input_dim, self.proj_dim, self.cond_dim = input_dim, proj_dim, cond_dim
        self.dims, self.n_blocks = tuple(dims), n_blocks
        time_dim = proj_dim * 4
        self.feature_proj = Dense(input_dim, proj_dim)
        self.time_emb = TimeEmbedding(time_dim)

        self.down_kinds, self.up_kinds = unet_topology(self.dims, n_blocks)
        widths = [proj_dim] + list(self.dims)
        self.down: List[nn.Module] = []
        level = 0
        for kind in self.down_kinds:
            if kind == "block":
                m = DownBlock(widths[level], widths[level], time_dim, cond_dim,
                              self.is_attn[min(level, len(self.dims) - 1)])
            else:
                m = Resample(widths[level], widths[level + 1])
                level += 1
            self.add_module(f"down_{len(self.down)}", m)
            self.down.append(m)

        self.middle = MiddleBlock(widths[level], time_dim, cond_dim, self.middle_attn)

        self.up: List[nn.Module] = []
        for kind in self.up_kinds:
            if kind == "block":
                m = UpBlock(widths[level], widths[level], time_dim, cond_dim,
                            self.is_attn[max(level - 1, 0)])
            else:
                m = Resample(widths[level], widths[level - 1])
                level -= 1
            self.add_module(f"up_{len(self.up)}", m)
            self.up.append(m)

        self.norm = LayerNorm(proj_dim)
        self.final = Dense(proj_dim, input_dim)

    def forward(self, x, t, cond, cond_mask):
        t = self.time_emb(t)
        x = self.feature_proj(x)
        cond = cond * cond_mask

        h = [x]
        for kind, m in zip(self.down_kinds, self.down):
            x = m(x, t, cond) if kind == "block" else m(x)
            h.append(x)

        x = self.middle(x, t, cond)

        for kind, m in zip(self.up_kinds, self.up):
            if kind == "resample":
                x = m(x)
            else:
                x = m(torch.cat([x, h.pop()], dim=1), t, cond)

        return self.final(swish(self.norm(x)))


def unet_msr(M: int = 3, proj_dim: int = 128, dims=(64, 32, 16, 8),
             cond_extra: int = 0) -> UNet1D:
    """MSR config; M=3 or 80. ``cond_extra`` widens the condition (+1 for
    the power-budget feature of ``msr_budget``)."""
    return UNet1D(input_dim=M, proj_dim=proj_dim, cond_dim=M + cond_extra, dims=tuple(dims),
                  is_attn=(False,) * len(dims), middle_attn=False, n_blocks=2)


def unet_co(node_num: int = 3) -> UNet1D:
    """CO config: proj 64, dims (64, 32, 16, 8), three blocks a level
    (``n_blocks=3``), condition ``3N`` derived per-node features."""
    return UNet1D(input_dim=node_num, proj_dim=64, cond_dim=3 * node_num,
                  dims=(64, 32, 16, 8), is_attn=(False,) * 4, middle_attn=False, n_blocks=3)


def unet_nu(K: int = 3, cond_extra: int = 0, proj_dim: int = 32,
            dims=(32, 16, 8)) -> UNet1D:
    """NU config: input ``2 + K`` (UAV x, y and K powers), condition ``2K``
    user coordinates (+ ``cond_extra``)."""
    return UNet1D(input_dim=2 + K, proj_dim=proj_dim, cond_dim=2 * K + cond_extra,
                  dims=tuple(dims), is_attn=(False,) * len(dims), middle_attn=False,
                  n_blocks=2)

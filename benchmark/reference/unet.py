"""The UNet1D denoiser of DiffSG, written out in plain PyTorch.

A U-Net over feature vectors: every layer is a Dense, a per-row LayerNorm
or a swish, and the "resolutions" are feature widths. The net is read
straight from a checkpoint's ``arrays.npz`` (flax parameter paths joined
with ``/``, kernels laid out (in, out)); nothing of the served program is
imported.

``matmul`` is the one product every Dense uses, so a caller can put a
lower-precision product in its place (the control of ``benchmark.harness
.correct``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

LN_EPS = 1e-5
MatMul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def load_arrays(ckpt_dir: str) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The ``params/...`` arrays (keys without the prefix) and the float64
    betas of a checkpoint directory."""
    with np.load(f"{ckpt_dir}/arrays.npz") as data:
        params = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
        betas = np.asarray(data["schedule/betas"], np.float64)
    return params, betas


def topology(dims: Sequence[int], n_blocks: int) -> Tuple[List[str], List[str]]:
    """The kinds ("block" or "resample") of the modules ``down_i`` and
    ``up_i``: each level has ``n_blocks`` blocks and a resample down, the
    last level ``n_blocks`` more; each level going up ``n_blocks + 1``
    blocks, each fed the skip of one module going down."""
    down, up = [], []
    for i in range(len(dims)):
        down += ["block"] * n_blocks + ["resample"]
        if i == len(dims) - 1:
            down += ["block"] * n_blocks
    for i in reversed(range(len(dims))):
        up += ["block"] * (n_blocks + 1) + ["resample"]
        if i == 0:
            up += ["block"] * (n_blocks + 1)
    return down, up


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class UNet1D:
    """The forward of a checkpoint's net, float32 on ``device``."""

    def __init__(self, params: Dict[str, np.ndarray], dims: Sequence[int], n_blocks: int,
                 device: torch.device, matmul: MatMul = torch.matmul):
        self.p = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                  for k, v in params.items()}
        self.down, self.up = topology(dims, n_blocks)
        self.matmul = matmul
        self.time_dim = self.p["time_emb/lin1/kernel"].shape[1]

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self.matmul(x, self.p[f"{name}/kernel"]) + self.p[f"{name}/bias"]

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + LN_EPS) * self.p[f"{name}/scale"] + self.p[f"{name}/bias"]

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """(1, time_dim): sin and cos of ``t`` at geometric frequencies,
        then Dense, swish, Dense."""
        half = self.time_dim // 8
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * -(math.log(10_000) / (half - 1)))
        emb = t[:, None] * freq[None, :]
        emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
        return self.dense("time_emb/lin2", swish(self.dense("time_emb/lin1", emb)))

    def block(self, name: str, x: torch.Tensor, st: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
        """A residual block: 3 x (LayerNorm, swish, Dense), the time
        projection added after the first Dense and the condition projection
        after the second; a Dense shortcut where the widths differ."""
        h = self.dense(f"{name}/lin1", swish(self.norm(f"{name}/norm1", x)))
        h = h + self.dense(f"{name}/time_emb", st)
        h = self.dense(f"{name}/lin2", swish(self.norm(f"{name}/norm2", h)))
        h = h + self.dense(f"{name}/cond_emb", sc)
        h = self.dense(f"{name}/lin3", swish(self.norm(f"{name}/norm3", h)))
        if f"{name}/shortcut/kernel" in self.p:
            x = self.dense(f"{name}/shortcut", x)
        return h + x

    def __call__(self, y: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """y (R, D), t (1,) the normalized time, cond (R, C) already masked
        (zero rows for the unconditional pass) -> (R, D)."""
        st = swish(self.time_embedding(t))
        sc = swish(cond)
        x = self.dense("feature_proj", y)
        skips = [x]
        for i, kind in enumerate(self.down):
            x = self.block(f"down_{i}/res", x, st, sc) if kind == "block" else self.dense(f"down_{i}/lin", x)
            skips.append(x)
        x = self.block("middle/res1", x, st, sc)
        x = self.block("middle/res2", x, st, sc)
        for i, kind in enumerate(self.up):
            if kind == "resample":
                x = self.dense(f"up_{i}/lin", x)
            else:
                x = self.block(f"up_{i}/res", torch.cat([x, skips.pop()], dim=1), st, sc)
        return self.dense("final", swish(self.norm("norm", x)))


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product whose operands are first rounded to TF32's 10-bit
    mantissa (to nearest, ties to even), as the tensor cores read them in
    TF32 mode; products and sums stay float32. The same on every device."""
    return torch.matmul(round_mantissa(a, 10), round_mantissa(b, 10))


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Float32 ``x`` rounded to ``bits`` mantissa bits, to nearest even."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    lsb = (i >> drop) & 1
    i = (i + ((1 << (drop - 1)) - 1) + lsb) & ~((1 << drop) - 1)
    return i.view(torch.float32)

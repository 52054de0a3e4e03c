"""Parameter initialization with the reference's training semantics.

Counterpart of ``diffsg_tpu/train/init.py``. The reference applies
``init_weights`` (``diffusion.py:82-84``) to the whole model before
training: every ``nn.Linear`` weight is redrawn from N(0, 0.01) while the
biases keep torch's default U(-1/sqrt(fan_in), +1/sqrt(fan_in)); LayerNorm
affine stays at (1, 0). The draws come from ``generator`` on the CPU and are
copied to the parameters' device, so one seed gives one init on every
device.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..models.unet1d import Dense, LayerNorm


@torch.no_grad()
def torch_style_init(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw ``model``'s parameters in place; returns ``model``.

    Dense: kernel ~ N(0, 0.01), bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
    LayerNorm: scale 1, bias 0.
    """
    for m in model.modules():
        if isinstance(m, Dense):
            fan_in = m.kernel.shape[0]
            bound = 1.0 / math.sqrt(fan_in)
            kernel = torch.randn(m.kernel.shape, generator=generator) * 0.01
            bias = (torch.rand(m.bias.shape, generator=generator) * 2.0 - 1.0) * bound
            m.kernel.copy_(kernel)
            m.bias.copy_(bias)
        elif isinstance(m, LayerNorm):
            m.scale.fill_(1.0)
            m.bias.zero_()
    return model

"""Operations and bytes of the denoiser, from a configuration's widths.

The yardstick of ``mfu.batch`` and the kernels' roofline shares. Counts come
from the UNet1D topology at the widths the configuration file states, never
from how the program packs or tiles its weights, so they read the same
work whatever implements it. A multiply-add is 2 operations; each input
and output of a kernel is moved once, in float32 (4 bytes).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

#: NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit.
PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores (SIMT)
PEAK_HBM_BYTES = 3.35e12      # HBM3 bytes/s
F32 = 4


class Layer(NamedTuple):
    kind: str                 # "dense" or "block"
    din: int
    dout: int
    shortcut: bool            # a block whose widths differ has a Dense shortcut


def layers(model: Dict) -> List[Layer]:
    """The net's Denses and residual blocks in forward order (the time MLP
    aside), from ``input_dim``, ``proj_dim``, ``dims`` and ``n_blocks``."""
    dims, nb, proj = list(model["dims"]), model["n_blocks"], model["proj_dim"]
    widths = [proj] + dims
    out = [Layer("dense", model["input_dim"], proj, False)]
    skips, level = [proj], 0
    for i in range(len(dims)):
        for _ in range(nb):
            out.append(Layer("block", widths[level], widths[level], False))
            skips.append(widths[level])
        out.append(Layer("dense", widths[level], widths[level + 1], False))
        level += 1
        skips.append(widths[level])
        if i == len(dims) - 1:
            for _ in range(nb):
                out.append(Layer("block", widths[level], widths[level], False))
                skips.append(widths[level])
    out += [Layer("block", widths[level], widths[level], False)] * 2       # the middle
    for i in reversed(range(len(dims))):
        for _ in range(nb + 1):
            din = widths[level] + skips.pop()
            out.append(Layer("block", din, widths[level], din != widths[level]))
        out.append(Layer("dense", widths[level], widths[level - 1], False))
        level -= 1
        if i == 0:
            for _ in range(nb + 1):
                din = widths[level] + skips.pop()
                out.append(Layer("block", din, widths[level], din != widths[level]))
    out.append(Layer("dense", proj, model["input_dim"], False))
    return out


def block_macs(b: Layer, cond_dim: int) -> int:
    """A residual block's multiply-adds per row: its three Denses, the
    shortcut and the condition projection."""
    return b.din * b.dout + 2 * b.dout * b.dout + cond_dim * b.dout + (
        b.din * b.dout if b.shortcut else 0)


def per_row_macs(model: Dict) -> int:
    """Multiply-adds of one row's forward."""
    return sum(block_macs(l, model["cond_dim"]) if l.kind == "block" else l.din * l.dout
               for l in layers(model))


def time_dim(model: Dict) -> int:
    return 4 * model["proj_dim"]


def batch1_macs(model: Dict) -> int:
    """Multiply-adds a forward does once, whatever its rows: the time MLP and
    every block's time projection, at batch 1."""
    td, proj = time_dim(model), model["proj_dim"]
    return proj * td + td * td + sum(td * l.dout for l in layers(model) if l.kind == "block")


def request_flops(model: Dict, sampler: Dict, rows: int) -> float:
    """Dense operations of one request of ``rows`` solutions: every sampler
    step runs the net on 2 rows a solution (the CFG fold; 1 at omega 0) and
    the batch-1 part once."""
    steps = sampler["T"] if sampler["kind"] == "ddpm" else sampler["n_steps"]
    fold = 1 if sampler["omega"] == 0 else 2
    return 2.0 * steps * (fold * rows * per_row_macs(model) + batch1_macs(model))


def resblock_work(b: Layer, rows: int) -> tuple:
    """(operations, bytes) of one residual-block kernel launch at ``rows``
    rows: the three Denses and the shortcut per row; it reads x, the
    batch-1 time projection, the per-row condition projection, its weights,
    LayerNorm parameters and biases once, and writes its output once."""
    mm = b.din * b.dout + 2 * b.dout * b.dout + (b.din * b.dout if b.shortcut else 0)
    vectors = 2 * b.din + 7 * b.dout + (b.dout if b.shortcut else 0)
    nbytes = F32 * (rows * b.din + b.dout + 2 * rows * b.dout + mm + vectors)
    return 2.0 * rows * mm, float(nbytes)


def forward_resblock_bound_s(model: Dict, rows: int) -> float:
    """The least time the residual blocks of one forward at ``rows`` rows
    could take: operations over the float32 peak or bytes over HBM bandwidth,
    each summed over the blocks, the larger."""
    work = [resblock_work(l, rows) for l in layers(model) if l.kind == "block"]
    return max(sum(w[0] for w in work) / PEAK_F32_FLOPS, sum(w[1] for w in work) / PEAK_HBM_BYTES)


def param_count(model: Dict) -> int:
    """Parameters of the whole net: Denses with biases, three LayerNorms a
    block and the final one, the time MLP."""
    n, C, td, proj = 0, model["cond_dim"], time_dim(model), model["proj_dim"]
    for l in layers(model):
        if l.kind == "dense":
            n += l.din * l.dout + l.dout
        else:
            n += (l.din * l.dout + 2 * l.dout * l.dout + (l.din * l.dout if l.shortcut else 0)
                  + (td + C) * l.dout + 7 * l.dout + 2 * l.din + (l.dout if l.shortcut else 0)
                  + 2 * l.dout)
    return n + 2 * proj + proj * td + td + td * td + td


def forward_mega_bound_s(model: Dict, rows: int) -> float:
    """The least time of the whole forward but the time MLP (what one
    whole-net kernel launch computes) at ``rows`` rows: operations are the
    per-row multiply-adds and the blocks' batch-1 time projections; bytes
    the rows' inputs (the sample and the activated condition), the
    activated time embedding, every weight but the time MLP's, and the
    output."""
    td, proj = time_dim(model), model["proj_dim"]
    flops = 2.0 * (rows * per_row_macs(model)
                   + sum(td * l.dout for l in layers(model) if l.kind == "block"))
    weights = param_count(model) - (proj * td + td + td * td + td)
    D, C = model["input_dim"], model["cond_dim"]
    nbytes = F32 * (rows * (2 * D + C) + td + weights)
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES)


def roofline_pct(run, kernel: str, bound_s) -> Optional[float]:
    """A kernel's share of its roofline over the traced requests of a closed
    loop, in percent: ``bound_s(model, rows)`` for every forward (the CFG
    fold's 2 x ``rows`` rows, one forward a sampler step) over the measured
    device time of the operations whose name holds ``kernel``; None where
    the trace holds none."""
    p = run.profile
    if p is None:
        return None
    measured = sum(s for name, (_, s) in p.device_ops.items() if kernel in name)
    if measured == 0:
        return None
    s = run.config["sampler"]
    forwards = p.requests * (s["T"] if s["kind"] == "ddpm" else s["n_steps"])
    return 100.0 * forwards * bound_s(run.config["model"], 2 * run.traffic["rows"]) / measured

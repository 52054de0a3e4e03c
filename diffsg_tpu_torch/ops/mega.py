"""Whole-UNet1D forward in one kernel launch: the hand-written CUDA kernel,
its plain PyTorch version and the weight packer.

Counterpart of ``diffsg_tpu/ops/pallas_mega.py::unet_forward_mega``. The
whole denoiser forward runs for a tile of rows in one launch of
``csrc/mega.cu``: ``feature_proj``; the down blocks and resamples, pushing
the skip stack; ``middle.res1`` and ``res2``; the up blocks, each
concatenating ``[x, skip]`` before ``norm1``; the final LN -> swish ->
Linear. As in the JAX package, the time MLP runs outside at batch 1 and its
swish ``st`` goes in (each block's time projection ``st @ W_t + b_t`` is
computed inside), and ``sc = swish(cond * mask)`` is computed outside.

The compute type follows the JAX kernel's rule: ``compute_dtype`` when it
is given, else the type of ``y``. Activations are rounded to it with the
JAX kernel's rounding points: LN statistics, swish and every product's
accumulation and bias add in float32, each result rounded to the compute
type; residual adds and the concat in the compute type. The weights are
cast to ``compute_dtype`` when it is given and otherwise read in the
model's own type (a bfloat16 copy of the model for bfloat16 weights). The
output is float32 when ``compute_dtype`` is given, else of the compute
type: bfloat16 weights and inputs give bfloat16 out, as
``pallas_mega.py`` returns. The kernel itself always writes float32 (each
value already rounded to the compute type) and the wrapper casts.

``unet_forward_mega`` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; there is no fallback
between the two.

The packed layout: every Dense is stored (in, out) with both dimensions
padded to a multiple of 16 and the pad zero-filled, and every array starts
on a multiple of 16 values (32 bytes or more), as the tensor-core loads
need. The skip stack lives in a scratch buffer in device memory, one slice
of (tile rows x ``skip_width``) per CTA of the persistent grid, which the
wrapper allocates; shared memory holds the rest of a tile
(``mega_smem_bytes``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import TYPE_CHECKING, Dict, List, NamedTuple, Optional, Tuple

import torch

from .. import obs
from ..parallel.mesh import sharded_names
from . import _build
from .resblock import FORWARD_ONLY

if TYPE_CHECKING:  # the models package imports this module
    from ..models.unet1d import UNet1D

_LN_EPS = 1e-5

# Layer kinds of the table.
FEATURE_PROJ, BLOCK, RESAMPLE, HEAD = 0, 1, 2, 3
# Layer flags.
F_SHORTCUT, F_PUSH, F_CONCAT = 1, 2, 4
# Columns of one table row (int32). The weight offsets index the packed
# buffer; dense layers and the head use W1/B1 (and the head G1/BE1). LDW is
# the padded output width: the row stride of every Dense of the layer.
# STAGE and NSTAGE are the one contiguous range of the buffer that holds
# every array the layer reads per row (a block's all but W_t and b_t, which
# are packed before it), which the row-resident kernel copies into shared
# memory whole.
(K_KIND, K_IN, K_OUT, K_FLAGS, K_SKIP_OFF, K_SKIP_W, K_TPROJ,
 K_G1, K_BE1, K_W1, K_B1, K_WT, K_BT, K_G2, K_BE2, K_W2, K_B2, K_WC, K_BC,
 K_G3, K_BE3, K_W3, K_B3, K_WS, K_BS, K_LDW, K_STAGE, K_NSTAGE) = range(28)
TABLE_COLS = 32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: The tile heights (rows per CTA) the kernel is built for, per compute type:
#: float32 products are SIMT FMAs, bf16 products run on the tensor cores.
TILE_ROWS = {torch.float32: (16, 32), torch.bfloat16: (32, 64, 128)}
#: Shared memory a CTA may have on sm_90, and the most that still lets two
#: CTAs share an SM (each also reserves 1 KB of the SM's 228 KB).
SMEM_MAX = 232_448
SMEM_TWO_PER_SM = 113 * 1024
_PAD = 16          # Dense dimensions and array starts, in values


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


class MegaParams(NamedTuple):
    """The packed network: every weight the kernel reads in one contiguous
    buffer of the compute type (each Dense in its (in, out) layout), and
    the int32 layer table (rows of ``TABLE_COLS``) the kernel walks."""

    weights: torch.Tensor      # (n,) compute type
    table: torch.Tensor        # (layers, TABLE_COLS) int32
    skip_width: int            # values of the skip stack per row
    max_in: int                # widest block input (the widest concat)
    max_out: int               # widest layer output
    n_tproj: int               # values of all blocks' time projections
    time_dim: int              # width of st (4 * proj_dim)
    input_dim: int             # D
    cond_dim: int              # C
    stage_max: int             # values of the largest staged range (K_NSTAGE)


def _ld(width: int, dtype: torch.dtype) -> int:
    """Row stride of a shared-memory tile ``width`` values wide: a multiple
    of 4 in float32; in bfloat16 the width padded to 16 plus 8, so that the
    tensor cores' 16-wide loads stay aligned and rows start on other banks."""
    return _round_up(width, 4) if dtype == torch.float32 else _round_up(width, 16) + 8


def _smem_bytes(dtype: torch.dtype, tile_rows: int, D: int, C: int, max_in: int,
                max_out: int, time_dim: int, n_tproj: int) -> int:
    # The sizing of csrc/mega.cu::smem_bytes, value for value; in bf16 each
    # of the 8 warps also has a 16 x 16 float32 staging tile.
    size, stage = (2, 4 * 8 * 256) if dtype == torch.bfloat16 else (4, 0)
    per_row = (_ld(D, dtype) + _ld(C, dtype) + 2 * _ld(max(max_in, max_out), dtype)
               + _ld(max_out, dtype))
    return (stage + 4 * _round_up(n_tproj, 8)
            + size * (_round_up(time_dim, 16) + tile_rows * per_row))


def mega_smem_bytes(packed: MegaParams, dtype: torch.dtype, tile_rows: int) -> int:
    """Dynamic shared memory of one CTA of the kernel for ``packed``'s net
    in ``dtype`` at ``tile_rows`` rows per tile, as the launcher sizes it:
    the time projections, st, and the y, sc, x, swish(LN(.)) and h tiles
    (and in bf16 the warps' staging tiles)."""
    return _smem_bytes(dtype, tile_rows, packed.input_dim, packed.cond_dim, packed.max_in,
                       packed.max_out, packed.time_dim, packed.n_tproj)


def mega_tile_rows(packed: MegaParams, rows: int, sms: int) -> int:
    """The tile height the wrapper launches ``rows`` rows at on a card of
    ``sms`` SMs: the tallest that fits two CTAs on an SM and still gives
    every SM a tile; else the tallest that fits one CTA and gives every SM
    a tile; else (few rows) the lowest that fits (``pack_params`` refused
    a net for which none fits)."""
    dtype = packed.weights.dtype
    fits = [r for r in TILE_ROWS[dtype] if mega_smem_bytes(packed, dtype, r) <= SMEM_MAX]
    full = [r for r in fits if -(-rows // r) >= sms]
    two = [r for r in full if mega_smem_bytes(packed, dtype, r) <= SMEM_TWO_PER_SM]
    return max(two or full or [min(fits)])


def mega_grid(packed: MegaParams, rows: int, tile_rows: int, sms: int) -> int:
    """CTAs of the persistent grid: as many as are resident at once (two
    per SM where their shared memory allows), at most one per tile."""
    two = mega_smem_bytes(packed, packed.weights.dtype, tile_rows) <= SMEM_TWO_PER_SM
    return min(-(-rows // tile_rows), (2 if two else 1) * sms)


#: The row-resident design (``csrc/mega_rows.cu``) takes float32 nets whose
#: every layer input is at most ``ROW_MAX_IN`` wide and every output (the
#: head's D included) at most ``ROW_MAX_OUT``: a thread keeps two sets of up
#: to 32 sums of its row in registers, and its row's input, up to 64 values,
#: in its own columns of shared memory. The kernel states the same limits.
ROW_MAX_IN, ROW_MAX_OUT = 64, 32
#: Rows (threads) a CTA of the row-resident kernel may take, in whole warps;
#: its launch bound, which leaves a thread 168 registers.
ROW_CTA_MAX = 384
#: Shared memory of an SM: 228 KB, of which each resident CTA reserves 1 KB.
SMEM_SM = 233_472
#: Up to this many rows a launch, the row-resident kernel gives a row a warp
#: (``mega_kernel_rows_warp``: the row's values across the lanes, lane j
#: computing output column j); above it a thread (``mega_kernel_rows``).
#: With few rows a thread a row leaves most of the card idle behind one
#: thread's chain of a whole forward.
ROW_WARP_MAX_ROWS = 4096


def mega_path(packed: MegaParams) -> str:
    """The design that runs ``packed``'s net when the caller forces no tile
    height: "rows" (``csrc/mega_rows.cu``: each row resident in a thread or
    a warp from the first layer to the last, each layer's weights staged
    once a CTA in shared memory, one barrier a layer) for float32 nets
    within ``ROW_MAX_IN`` and ``ROW_MAX_OUT`` whose smallest CTA fits, else
    "tile" (``csrc/mega.cu``: tiles of rows in shared memory, a barrier
    between every pass). Read from the packed net alone."""
    narrow = (packed.weights.dtype == torch.float32 and packed.max_in <= ROW_MAX_IN
              and max(packed.max_out, packed.input_dim) <= ROW_MAX_OUT)
    return "rows" if narrow and mega_row_smem_bytes(packed, 32) <= SMEM_MAX else "tile"


def mega_row_smem_bytes(packed: MegaParams, cta_rows: int, lanes: int = 1) -> int:
    """Dynamic shared memory of one CTA of the row-resident kernel at
    ``cta_rows`` rows and ``lanes`` lanes a row (1 or 32), as
    ``csrc/mega_rows.cu::smem_bytes`` sizes it: the mbarriers (128 bytes),
    the weight buffers of the largest staged range (two with a thread a row,
    four with a warp), the time projections, st and the layer table; with a
    thread a row also each row's columns of x (the widest input, output or
    D), of h (the widest output) and of sc (C)."""
    ldx = max(packed.max_in, packed.max_out, packed.input_dim)
    per_row = ldx + packed.max_out + packed.cond_dim if lanes == 1 else 0
    buffers = 2 if lanes == 1 else 4
    return 128 + 4 * (buffers * packed.stage_max + _round_up(packed.n_tproj, 4)
                      + _round_up(packed.time_dim, 4) + TABLE_COLS * packed.table.shape[0]
                      + cta_rows * per_row)


def mega_row_layout(packed: MegaParams, rows: int, sms: int) -> Tuple[int, int, int]:
    """(lanes a row, rows a CTA, grid) of the row-resident kernel at
    ``rows`` rows on ``sms`` SMs.

    Up to ``ROW_WARP_MAX_ROWS`` rows (and a condition of at most 64 values)
    a warp a row: CTAs of 8 warps while that gives each SM at most one, else
    of 16, as many resident as shared memory and 2,048 threads an SM allow.

    Else a thread a row: the most rows a CTA (whole warps, up to
    ``ROW_CTA_MAX``) whose CTA fits, where that leaves every SM four tiles
    or more to walk, so that the last, partial wave costs little; else 128,
    four warps, two CTAs an SM where they fit (an SM's wave of tiles takes
    longer the more warps share it, so below a few waves the narrower CTAs
    finish first). As many CTAs as are resident at once (by shared memory,
    and by the registers the launch bound allows, ``ROW_CTA_MAX`` threads
    an SM), at most one a tile."""
    if rows <= ROW_WARP_MAX_ROWS and packed.cond_dim <= 64:
        cta_rows = 8 if -(-rows // 8) <= sms else 16
        smem = mega_row_smem_bytes(packed, cta_rows, 32)
        per_sm = max(1, min(2048 // (32 * cta_rows), SMEM_SM // (smem + 1024)))
        return 32, cta_rows, min(-(-rows // cta_rows), per_sm * sms)
    fits = [n for n in range(32, ROW_CTA_MAX + 1, 32) if mega_row_smem_bytes(packed, n) <= SMEM_MAX]
    cta_rows = max(fits) if -(-rows // max(fits)) >= 4 * sms else min(128, max(fits))
    smem = mega_row_smem_bytes(packed, cta_rows)
    per_sm = max(1, min(ROW_CTA_MAX // cta_rows, SMEM_SM // (smem + 1024)))
    return 1, cta_rows, min(-(-rows // cta_rows), per_sm * sms)


def _check_model(model: "UNet1D") -> None:
    if any(model.is_attn) or model.middle_attn:
        raise NotImplementedError("the mega kernel runs no attention blocks; use the 'plain' "
                                  "backend for attention nets (no shipped net has them)")
    if sharded_names(model):
        raise ValueError("the mega kernel takes whole weight matrices, not tp column slices")
    widths = (model.proj_dim, *model.dims)
    if any(w % 4 for w in widths):
        raise ValueError(f"the mega kernel needs widths that are multiples of 4, got {widths}")


def pack_params(model: "UNet1D", dtype: Optional[torch.dtype] = None,
                device: Optional[torch.device] = None) -> MegaParams:
    """Pack ``model``'s weights (all but the time MLP, which runs outside)
    into one buffer of ``dtype`` (the model's weight type when None) on
    ``device`` (the model's when None), and build the layer table from
    ``unet_topology``.
    Raises ValueError, with the footprint, for a net too wide for any tile
    height of the kernel."""
    _check_model(model)
    dtype = model.feature_proj.kernel.dtype if dtype is None else dtype
    if dtype not in _DTYPES:
        raise TypeError(f"the mega kernel computes in float32 or bfloat16, not {dtype}")
    if device is None:
        device = model.feature_proj.kernel.device
    pieces: List[Tuple[int, torch.Tensor, Tuple[int, ...]]] = []   # (offset, array, padded shape)
    size = 0

    def put(t: torch.Tensor) -> int:
        nonlocal size
        shape = tuple(_round_up(n, _PAD) for n in t.shape)
        pieces.append((size, t.detach(), shape))
        off = size
        size += math.prod(shape)
        return off

    rows: List[List[int]] = []
    skip: List[Tuple[int, int]] = []      # (offset, width) of each pushed entry
    skip_top = 0
    n_tproj = 0

    def row(kind: int, d_in: int, d_out: int) -> List[int]:
        r = [0] * TABLE_COLS
        r[K_KIND], r[K_IN], r[K_OUT] = kind, d_in, d_out
        r[K_LDW] = _round_up(d_out, _PAD)
        rows.append(r)
        return r

    def push(r: List[int]) -> None:
        nonlocal skip_top
        r[K_FLAGS] |= F_PUSH
        r[K_SKIP_OFF], r[K_SKIP_W] = skip_top, r[K_OUT]
        skip.append((skip_top, r[K_OUT]))
        skip_top += r[K_OUT]

    def staged(r: List[int], start: int) -> None:
        r[K_STAGE], r[K_NSTAGE] = start, size - start

    def dense(r: List[int], lin) -> None:
        start = size
        r[K_W1], r[K_B1] = put(lin.kernel), put(lin.bias)
        staged(r, start)

    def block(res, concat: bool) -> List[int]:
        nonlocal n_tproj
        d_in, d_out = res.lin1.kernel.shape
        r = row(BLOCK, d_in, d_out)
        r[K_TPROJ] = n_tproj
        n_tproj += d_out
        r[K_WT], r[K_BT] = put(res.time_emb.kernel), put(res.time_emb.bias)
        start = size
        r[K_G1], r[K_BE1] = put(res.norm1.scale), put(res.norm1.bias)
        r[K_W1], r[K_B1] = put(res.lin1.kernel), put(res.lin1.bias)
        r[K_G2], r[K_BE2] = put(res.norm2.scale), put(res.norm2.bias)
        r[K_W2], r[K_B2] = put(res.lin2.kernel), put(res.lin2.bias)
        r[K_WC], r[K_BC] = put(res.cond_emb.kernel), put(res.cond_emb.bias)
        r[K_G3], r[K_BE3] = put(res.norm3.scale), put(res.norm3.bias)
        r[K_W3], r[K_B3] = put(res.lin3.kernel), put(res.lin3.bias)
        if res.shortcut is not None:
            r[K_FLAGS] |= F_SHORTCUT
            r[K_WS], r[K_BS] = put(res.shortcut.kernel), put(res.shortcut.bias)
        staged(r, start)
        if concat:
            r[K_FLAGS] |= F_CONCAT
            r[K_SKIP_OFF], r[K_SKIP_W] = skip.pop()
        return r

    r = row(FEATURE_PROJ, model.input_dim, model.proj_dim)
    dense(r, model.feature_proj)
    push(r)
    for kind, m in zip(model.down_kinds, model.down):
        if kind == "block":
            r = block(m.res, concat=False)
        else:
            r = row(RESAMPLE, *m.lin.kernel.shape)
            dense(r, m.lin)
        push(r)
    block(model.middle.res1, concat=False)
    block(model.middle.res2, concat=False)
    for kind, m in zip(model.up_kinds, model.up):
        if kind == "block":
            block(m.res, concat=True)
        else:
            r = row(RESAMPLE, *m.lin.kernel.shape)
            dense(r, m.lin)
    r = row(HEAD, model.proj_dim, model.input_dim)
    start = size
    r[K_G1], r[K_BE1] = put(model.norm.scale), put(model.norm.bias)
    dense(r, model.final)
    staged(r, start)
    if skip:
        raise AssertionError(f"skip stack not empty after the up path: {skip}")

    blocks = [r for r in rows if r[K_KIND] == BLOCK]
    max_in = max(r[K_IN] for r in blocks)
    max_out = max(r[K_OUT] for r in rows if r[K_KIND] != HEAD)
    tile = TILE_ROWS[dtype][0]
    smem = _smem_bytes(dtype, tile, model.input_dim, model.cond_dim, max_in, max_out,
                       model.proj_dim * 4, n_tproj)
    if smem > SMEM_MAX:      # checked before any weight is read
        raise ValueError(f"the mega kernel needs {smem:,} bytes of shared memory for a "
                         f"{tile}-row {str(dtype).replace('torch.', '')} tile of this net, "
                         f"more than the {SMEM_MAX:,} a CTA can have")

    buf = torch.zeros(size)
    with torch.no_grad():
        for off, t, shape in pieces:
            view = buf[off:off + math.prod(shape)].view(shape)
            view[tuple(slice(0, n) for n in t.shape)] = t.float().cpu()
    return MegaParams(
        weights=buf.to(device=device, dtype=dtype), table=torch.tensor(rows, dtype=torch.int32,
                                                                       device=device),
        skip_width=skip_top, max_in=max_in, max_out=max_out, n_tproj=n_tproj,
        time_dim=model.proj_dim * 4, input_dim=model.input_dim, cond_dim=model.cond_dim,
        stage_max=max(r[K_NSTAGE] for r in rows))


# -- the function, in plain PyTorch ---------------------------------------------

def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _time_features(model: "UNet1D", t: torch.Tensor) -> torch.Tensor:
    """The time MLP at the batch of ``t``, as the JAX package's
    ``_time_features``: the sinusoid in ``t``'s type (bfloat16 when the
    sampler casts t), the MLP in the promotion of that type and the module's
    weight type (float32 with float32 weights; bfloat16 with a bfloat16 copy
    of the model and bfloat16 t)."""
    te = model.time_emb
    emb = te.sinusoid(t)
    dt = torch.promote_types(emb.dtype, te.lin1.kernel.dtype)

    def dense(lin, x):
        return torch.matmul(x, lin.kernel.to(dt)) + lin.bias.to(dt)

    return dense(te.lin2, _swish(dense(te.lin1, emb.to(dt))))


def mega_inputs(model: "UNet1D", y: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                cond_mask: torch.Tensor, compute_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, sc, st) in the compute type (``compute_dtype``, else ``y``'s
    type), as the kernel reads them: ``sc = swish(cond * mask)`` (B, C) and
    ``st = swish(time MLP(t))`` (1, 4 * proj). ``t`` must hold exactly one
    entry: the sampler's batch-1 time."""
    dtype = y.dtype if compute_dtype is None else compute_dtype
    if dtype not in _DTYPES:
        raise TypeError(f"the mega kernel computes in float32 or bfloat16, not {dtype}")
    if t.numel() != 1:
        raise ValueError(f"the mega forward takes a batch-1 time t (one entry), got shape "
                         f"{tuple(t.shape)}")
    B, D = y.shape
    if D != model.input_dim or cond.shape != (B, model.cond_dim) or cond_mask.shape != (B, 1):
        raise ValueError(f"shapes y {tuple(y.shape)}, cond {tuple(cond.shape)}, mask "
                         f"{tuple(cond_mask.shape)} do not fit a net of input "
                         f"{model.input_dim} and condition {model.cond_dim}")
    st = _swish(_time_features(model, t.reshape(1))).to(dtype)
    sc = _swish(cond * cond_mask).to(dtype)
    return y.to(dtype), sc, st


def unet_forward_mega_reference(model: "UNet1D", y: torch.Tensor, t: torch.Tensor,
                                cond: torch.Tensor, cond_mask: torch.Tensor,
                                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole forward in plain PyTorch, rounded where the kernel rounds.
    Returns (B, D) in float32 when ``compute_dtype`` is given, else in the
    compute type (``y``'s)."""
    _check_model(model)
    y, sc, st = mega_inputs(model, y, t, cond, cond_mask, compute_dtype)
    dt = y.dtype
    wdt = _weight_dtype(model, compute_dtype)

    def rnd(x):                       # round to the compute type, go on in f32
        return x.to(dt).float()

    def w(p):
        return p.detach().to(wdt).float()

    def ln(norm, x):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        return rnd((x - mean) * torch.rsqrt(var + _LN_EPS) * w(norm.scale) + w(norm.bias))

    def dense(lin, x):
        return rnd(torch.matmul(x, w(lin.kernel)) + w(lin.bias))

    def act(x):
        return rnd(_swish(x))

    stf, scf = st.float(), sc.float()

    def resblock(res, x):
        h = rnd(dense(res.lin1, act(ln(res.norm1, x))) + dense(res.time_emb, stf))
        h = rnd(dense(res.lin2, act(ln(res.norm2, h))) + dense(res.cond_emb, scf))
        h = dense(res.lin3, act(ln(res.norm3, h)))
        return rnd(h + (dense(res.shortcut, x) if res.shortcut is not None else x))

    x = dense(model.feature_proj, y.float())
    skips = [x]
    for kind, m in zip(model.down_kinds, model.down):
        x = resblock(m.res, x) if kind == "block" else dense(m.lin, x)
        skips.append(x)
    x = resblock(model.middle.res1, x)
    x = resblock(model.middle.res2, x)
    for kind, m in zip(model.up_kinds, model.up):
        x = dense(m.lin, x) if kind == "resample" else resblock(m.res, torch.cat([x, skips.pop()], 1))
    return dense(model.final, act(ln(model.norm, x))).to(_out_dtype(dt, compute_dtype))


def _weight_dtype(model: "UNet1D", compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The type the weights are read in: ``compute_dtype``, else the model's."""
    return model.feature_proj.kernel.dtype if compute_dtype is None else compute_dtype


def _out_dtype(dtype: torch.dtype, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """float32 when ``compute_dtype`` is given, else the compute type."""
    return torch.float32 if compute_dtype is not None else dtype


# -- the kernel -------------------------------------------------------------------

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 7 + [ctypes.c_int] * 12 + [_P]
_ROW_ARGTYPES = [_P] * 7 + [ctypes.c_int] * 13 + [_P]
#: The design of the last launch in this process: its path ("rows" or
#: "tile") and, on "rows", its lanes a row.
_LAST: Dict[str, object] = {"path": "tile"}


def _library() -> ctypes.CDLL:
    lib = _build.library()
    fn = lib.diffsg_unet_mega
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.diffsg_unet_mega_rows.argtypes = _ROW_ARGTYPES
        lib.diffsg_unet_mega_rows.restype = ctypes.c_int
        lib.diffsg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.diffsg_cuda_error_string.restype = ctypes.c_char_p
        for last in (lib.diffsg_unet_mega_last_launch, lib.diffsg_unet_mega_rows_last_launch):
            last.argtypes = [ctypes.c_void_p]
            last.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def unet_forward_mega(model: "UNet1D", y: torch.Tensor, t: torch.Tensor, cond: torch.Tensor,
                      cond_mask: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                      packed: Optional[MegaParams] = None) -> torch.Tensor:
    """The whole UNet1D forward: one launch of the CUDA kernel on a CUDA
    device, the plain version on the CPU. Returns (B, D), float32 when
    ``compute_dtype`` is given, else of the compute type (``y``'s).

    ``packed`` is ``pack_params(model, compute_dtype)``, packed once by the
    caller (``unet_apply_fn(model, "mega")`` does); without it the weights
    are packed on every call. The kernel takes weights of the compute type
    only: with ``y`` in bfloat16, no ``compute_dtype`` and a float32 model
    (whose weights JAX would read in float32) it raises. Raises on anything
    the kernel does not take.

    The kernel is forward-only, as the Pallas kernel is: under autograd, with
    an input or a parameter of ``model`` that requires grad, it raises on
    every device (its plain version reads the weights detached).
    """
    if torch.is_grad_enabled() and (
            any(a.requires_grad for a in (y, t, cond, cond_mask))
            or any(p.requires_grad for p in model.parameters())):
        raise RuntimeError(FORWARD_ONLY.format(name="unet_forward_mega"))
    if y.device.type == "cpu":
        return unet_forward_mega_reference(model, y, t, cond, cond_mask, compute_dtype)
    if y.device.type != "cuda":
        raise ValueError(f"unet_forward_mega runs on cuda or cpu, not {y.device}")
    _check_model(model)
    dev = y.device
    for name, a in (("y", y), ("t", t), ("cond", cond), ("cond_mask", cond_mask)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, y on {dev}")
    ys, sc, st = mega_inputs(model, y, t, cond, cond_mask, compute_dtype)
    if packed is None:
        packed = pack_params(model, _weight_dtype(model, compute_dtype), dev)
    if (packed.input_dim, packed.cond_dim) != (model.input_dim, model.cond_dim):
        raise ValueError("packed weights are of another net")
    return launch_mega(packed, ys, sc, st).to(_out_dtype(ys.dtype, compute_dtype))


def launch_mega(packed: MegaParams, y: torch.Tensor, sc: torch.Tensor, st: torch.Tensor,
                tile_rows: int = 0) -> torch.Tensor:
    """One launch of the kernel on the inputs ``mega_inputs`` makes (all on
    one CUDA device, of the packed weights' type); returns float32 (B, D).
    ``tile_rows`` 0 runs the design ``mega_path`` picks: the row-resident
    kernel in ``mega_row_layout``'s layout, or the tile kernel at
    ``mega_tile_rows``' height. A ``tile_rows`` of ``TILE_ROWS[dtype]``
    forces the tile kernel at that height. The skip stack's scratch is
    allocated here, on the current stream, one (rows a CTA, skip_width)
    slice per CTA. A row-resident launch counts ``mega_row_launches`` in
    ``obs``."""
    dev, dtype = y.device, packed.weights.dtype
    if dev.type != "cuda":
        raise ValueError(f"launch_mega runs on a CUDA device, not {dev}")
    if tile_rows and tile_rows not in TILE_ROWS[dtype]:
        raise ValueError(f"tile_rows must be 0 or one of {TILE_ROWS[dtype]} for {dtype}, "
                         f"got {tile_rows}")
    rows = y.shape[0]
    for name, a, shape in (("y", y, (rows, packed.input_dim)), ("sc", sc, (rows, packed.cond_dim)),
                           ("st", st, (1, packed.time_dim)), ("weights", packed.weights, None),
                           ("table", packed.table, None)):
        if a.device != dev:
            raise ValueError(f"{name} is on {a.device}, y on {dev}")
        if name != "table" and a.dtype != dtype:
            raise TypeError(f"{name} is {a.dtype}, weights packed as {dtype}")
        if shape is not None and tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected {shape}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((rows, packed.input_dim), device=dev, dtype=torch.float32)
    if rows == 0:
        return out
    sms = _sm_count(dev.index)
    path = "tile" if tile_rows else mega_path(packed)
    if path == "rows":
        lanes, tile_rows, grid = mega_row_layout(packed, rows, sms)
    else:
        tile_rows = tile_rows or mega_tile_rows(packed, rows, sms)
        grid = mega_grid(packed, rows, tile_rows, sms)
    skip = torch.empty(grid * tile_rows * packed.skip_width, device=dev, dtype=dtype)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (y.data_ptr(), sc.data_ptr(), st.data_ptr(), packed.weights.data_ptr(),
            packed.table.data_ptr(), out.data_ptr(), skip.data_ptr())
    with torch.cuda.device(dev):
        if path == "rows":
            err = lib.diffsg_unet_mega_rows(
                *ptrs, rows, packed.table.shape[0], packed.input_dim, packed.cond_dim,
                packed.time_dim, packed.skip_width, packed.max_in, packed.max_out,
                packed.n_tproj, packed.stage_max, int(lanes == 32), tile_rows, grid, stream)
        else:
            err = lib.diffsg_unet_mega(
                *ptrs, _DTYPES[dtype], rows, packed.table.shape[0], packed.input_dim,
                packed.cond_dim, packed.time_dim, packed.skip_width, packed.max_in,
                packed.max_out, packed.n_tproj, tile_rows, grid, stream)
    if err != 0:
        msg = lib.diffsg_cuda_error_string(err).decode()
        raise RuntimeError(f"mega kernel launch failed: {msg} ({err})")
    global _LAST
    _LAST = {"path": path, "lanes": lanes} if path == "rows" else {"path": path}
    obs.count("mega_launches", 1, y)
    if path == "rows":
        obs.count("mega_row_launches", 1, y)
    return out


def last_launch() -> Dict[str, object]:
    """The design of the last launch in this process (``path``: "rows" or
    "tile"; on "rows" ``lanes``, 1 or 32 lanes a row), its rows a CTA
    (``tile_rows``), grid size and shared-memory bytes (0 before the first
    launch of that path)."""
    info = (ctypes.c_int * 3)()
    lib = _library()
    if _LAST["path"] == "rows":
        lib.diffsg_unet_mega_rows_last_launch(info)
    else:
        lib.diffsg_unet_mega_last_launch(info)
    return {**_LAST, **dict(zip(("tile_rows", "grid", "smem_bytes"), info))}

"""Fused UNet1D residual block: the hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``diffsg_tpu/ops/pallas_kernels.py``. The block computes

  h   = swish(LN1(x)) @ W1 + b1 + t_proj
  h   = swish(LN2(h)) @ W2 + b2 + c_proj
  h   = swish(LN3(h)) @ W3 + b3
  out = h + (x @ Ws + bs  if a shortcut is given, else x)

``fused_residual_block`` takes the plain version for tensors on the CPU and
launches ``csrc/resblock.cu`` for tensors on a CUDA device; there is no
fallback between the two. Weights keep flax's (in, out) layout.

The kernel has two paths, each a grid whose CTAs walk row tiles. Blocks
with a side wider than 32 take the wide path: tiles of 32 or 64 rows, the
weights streamed through a ring of shared memory, register micro-tiles.
Blocks no wider than 32 take the narrow path: the whole block's weights in
shared memory, a few lanes per row. The wrapper picks the path, the tile
height and the grid (``resblock_tile_rows``, ``resblock_grid``) from
``resblock_smem_bytes``, the mirror of the kernel's own sizing, and passes
them to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from .. import obs
from . import _build

_LN_EPS = 1e-5

#: The kernel's two paths (``last_launch()["variant"]``).
NARROW, WIDE = "narrow", "wide"
#: Output widths the wide path is built for: a block runs in the smallest
#: that holds its ``out_dim``.
WIDE_NP = (32, 64, 128, 256)
#: Tile heights (rows per CTA) of the wide path, per output width class.
WIDE_TILE_ROWS = {32: (32, 64), 64: (32, 64), 128: (32, 64), 256: (32,)}
#: The widest block the narrow path takes (8 lanes of one float4 a row;
#: the kernel's kNarrowMaxWidth); every wider block takes the wide path.
NARROW_MAX_WIDTH = 32
_THREADS = 256
#: The widest input the wide path takes (its LayerNorm 1 holds 4 float4 a lane).
MAX_WIDE_IN = 512
#: Shared memory a CTA may have on sm_90, and the most that still lets two
#: CTAs share an SM (each also reserves 1 KB of the SM's 228 KB).
SMEM_MAX = 232_448
SMEM_TWO_PER_SM = 113 * 1024
_SLOT_FLOATS, _SLOTS = 4096, 3     # the wide path's weight ring

_F32P = ctypes.c_void_p
_ARGTYPES = ([_F32P, _F32P, ctypes.c_int, _F32P] + [_F32P] * 12
             + [_F32P, _F32P, _F32P] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
             + [ctypes.c_int] * 2)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + _LN_EPS) * gamma + beta


def resblock_reference(x, t_proj, c_proj, g1, be1, w1, b1, g2, be2, w2, b2,
                       g3, be3, w3, b3, ws=None, bs=None) -> torch.Tensor:
    """The block in plain PyTorch (two-pass LayerNorm, as the kernel)."""
    h = torch.matmul(_swish(_ln(x, g1, be1)), w1) + b1 + t_proj
    h = torch.matmul(_swish(_ln(h, g2, be2)), w2) + b2 + c_proj
    h = torch.matmul(_swish(_ln(h, g3, be3)), w3) + b3
    return h + (torch.matmul(x, ws) + bs if ws is not None else x)


# -- sizing: the mirror of csrc/resblock.cu's host side ---------------------------

def resblock_variant(in_dim: int, out_dim: int) -> str:
    """The kernel's path for an ``in_dim -> out_dim`` block."""
    return NARROW if max(in_dim, out_dim) <= NARROW_MAX_WIDTH else WIDE


def _wide_np(out_dim: int) -> int:
    for np_ in WIDE_NP:
        if out_dim <= np_:
            return np_
    raise ValueError(f"the resblock kernel takes out_dim <= {WIDE_NP[-1]}, got {out_dim}")


def _narrow_group(in_dim: int, out_dim: int) -> int:
    """Lanes per row on the narrow path: one float4 of the widest row each."""
    wide = max(in_dim, out_dim)
    return 2 if wide <= 8 else 4 if wide <= 16 else 8


def resblock_tile_heights(in_dim: int, out_dim: int) -> Tuple[int, ...]:
    """The tile heights the kernel is built for at this block's widths (the
    narrow path has one: 256 threads over its lanes per row). Raises
    ValueError for widths it does not take."""
    if resblock_variant(in_dim, out_dim) == NARROW:
        return (_THREADS // _narrow_group(in_dim, out_dim),)
    if in_dim > MAX_WIDE_IN:
        raise ValueError(f"the resblock kernel takes in_dim <= {MAX_WIDE_IN}, got {in_dim}")
    return WIDE_TILE_ROWS[_wide_np(out_dim)]


def resblock_smem_bytes(in_dim: int, out_dim: int, shortcut: bool, tile_rows: int) -> int:
    """Dynamic shared memory of one CTA at ``tile_rows`` rows, as the
    kernel's launcher sizes it. Narrow: the block's weights (the shortcut's
    too), its vectors (2 in + 8 out) and each warp's two staging buffers of
    32 / G rows, 4 G + 4 floats apart (G lanes per row). Wide: one
    activation tile, ``max(in, out)`` wide with each row padded by 4 floats
    (8 at out > 128: the row's LayerNorm partial sums), and the ring of
    three 16 KB weight slots; the shortcut takes none (it waits in
    ``out``)."""
    if resblock_variant(in_dim, out_dim) == NARROW:
        g = _narrow_group(in_dim, out_dim)
        if tile_rows != _THREADS // g:
            raise ValueError(f"the narrow path runs a {in_dim} -> {out_dim} block at "
                             f"{_THREADS // g} rows, not {tile_rows}")
        weights = in_dim * out_dim * (2 if shortcut else 1) + 2 * out_dim * out_dim
        stage = _THREADS // 32 * 2 * (32 // g) * (4 * g + 4)
        return 4 * (weights + 2 * in_dim + 8 * out_dim + stage)
    pad = 8 if _wide_np(out_dim) > 128 else 4
    return 4 * (tile_rows * (max(in_dim, out_dim) + pad) + _SLOTS * _SLOT_FLOATS)


def resblock_tile_rows(in_dim: int, out_dim: int, shortcut: bool, rows: int, sms: int) -> int:
    """The tile height the wrapper launches ``rows`` rows at on a card of
    ``sms`` SMs: the tallest that fits and still gives every SM a tile,
    else (few rows) the lowest that fits."""
    fits = [r for r in resblock_tile_heights(in_dim, out_dim)
            if resblock_smem_bytes(in_dim, out_dim, shortcut, r) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"no tile of a {in_dim} -> {out_dim} block fits {SMEM_MAX:,} bytes "
                         "of shared memory")
    full = [r for r in fits if -(-rows // r) >= sms]
    return max(full) if full else min(fits)


def resblock_grid(in_dim: int, out_dim: int, shortcut: bool, rows: int, tile_rows: int,
                  sms: int) -> int:
    """CTAs of the grid, at most one per tile. Wide: as many as are
    resident at once (two per SM where their shared memory allows), each
    walking tiles. Narrow: one per tile."""
    tiles = -(-rows // tile_rows)
    if resblock_variant(in_dim, out_dim) == NARROW:
        return tiles
    two = resblock_smem_bytes(in_dim, out_dim, shortcut, tile_rows) <= SMEM_TWO_PER_SM
    return min(tiles, (2 if two else 1) * sms)


# -- the kernel -------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _build.library()
    fn = lib.diffsg_resblock_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.diffsg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.diffsg_cuda_error_string.restype = ctypes.c_char_p
        lib.diffsg_resblock_last_launch.argtypes = [ctypes.c_void_p]
        lib.diffsg_resblock_last_launch.restype = None
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_shape(in_dim: int, out_dim: int, shortcut: bool, rows: int, sms: int,
                  tile_rows: int) -> Tuple[int, int]:
    """(tile rows, grid) of a launch."""
    heights = resblock_tile_heights(in_dim, out_dim)
    if tile_rows and tile_rows not in heights:
        raise ValueError(f"tile_rows must be 0 or one of {heights} for a {in_dim} -> "
                         f"{out_dim} block, got {tile_rows}")
    tile_rows = tile_rows or resblock_tile_rows(in_dim, out_dim, shortcut, rows, sms)
    return tile_rows, resblock_grid(in_dim, out_dim, shortcut, rows, tile_rows, sms)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


#: The error of a kernel wrapper called where autograd would record it.
FORWARD_ONLY = ("{name} is forward-only, as the Pallas kernel it ports is: it has no backward, "
                "so its output would carry no gradient. Call it under torch.no_grad() or "
                "torch.inference_mode() (as the samplers and the Solver do), and train with "
                "the 'plain' backend (the module's own forward), as train.train_ddpm does")


def _check(name: str, t: torch.Tensor, device: torch.device, shape: Tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_residual_block(
    x: torch.Tensor,          # (R, in_dim)
    t_proj: torch.Tensor,     # (1, out_dim) broadcast, or (R, out_dim)
    c_proj: torch.Tensor,     # (R, out_dim)
    g1, be1, w1, b1,          # LN1 (in_dim), W1 (in_dim, out_dim)
    g2, be2, w2, b2,          # LN2 (out_dim), W2 (out_dim, out_dim)
    g3, be3, w3, b3,          # LN3 (out_dim), W3 (out_dim, out_dim)
    ws: Optional[torch.Tensor] = None,  # (in_dim, out_dim) shortcut
    bs: Optional[torch.Tensor] = None,
    *, tile_rows: int = 0,
) -> torch.Tensor:
    """One residual block: the CUDA kernel on a CUDA device, the plain
    version on the CPU. Raises on anything the kernel does not take.
    ``tile_rows`` is the kernel's rows per CTA, one of
    ``resblock_tile_heights(in_dim, out_dim)``; 0 takes
    ``resblock_tile_rows``'s choice.

    The kernel is forward-only, as the Pallas kernel is: under autograd, with
    any argument that requires grad, it raises on every device rather than
    return an output that drops the gradient."""
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, t_proj, c_proj, g1, be1, w1, b1, g2, be2, w2, b2, g3, be3, w3, b3,
                      ws, bs)):
        raise RuntimeError(FORWARD_ONLY.format(name="fused_residual_block"))
    if x.device.type == "cpu":
        return resblock_reference(x, t_proj, c_proj, g1, be1, w1, b1, g2, be2,
                                  w2, b2, g3, be3, w3, b3, ws, bs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_residual_block runs on cuda or cpu, not {x.device}")
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError("x and w1 must be 2-D")
    rows, in_dim = x.shape
    out_dim = w1.shape[1]
    if in_dim % 4 or out_dim % 4:
        raise ValueError(f"widths must be multiples of 4, got {in_dim} -> {out_dim}")
    if (ws is None) != (bs is None):
        raise ValueError("ws and bs must be given together")
    if ws is None and in_dim != out_dim:
        raise ValueError(f"a {in_dim} -> {out_dim} block needs a shortcut (ws, bs)")
    if t_proj.dim() != 2 or t_proj.shape[0] not in (1, rows):
        raise ValueError(f"t_proj must be (1, {out_dim}) or ({rows}, {out_dim})")
    dev = x.device
    expect = [("x", x, (rows, in_dim)), ("t_proj", t_proj, (t_proj.shape[0], out_dim)),
              ("c_proj", c_proj, (rows, out_dim)),
              ("g1", g1, (in_dim,)), ("be1", be1, (in_dim,)),
              ("w1", w1, (in_dim, out_dim)), ("b1", b1, (out_dim,)),
              ("g2", g2, (out_dim,)), ("be2", be2, (out_dim,)),
              ("w2", w2, (out_dim, out_dim)), ("b2", b2, (out_dim,)),
              ("g3", g3, (out_dim,)), ("be3", be3, (out_dim,)),
              ("w3", w3, (out_dim, out_dim)), ("b3", b3, (out_dim,))]
    if ws is not None:
        expect += [("ws", ws, (in_dim, out_dim)), ("bs", bs, (out_dim,))]
    for name, t, shape in expect:
        _check(name, t, dev, shape)
    # Read in 16-byte accesses: x, t_proj, c_proj, and the weight matrices
    # (copied to shared memory 16 bytes at a time).
    for name, t in (("x", x), ("t_proj", t_proj), ("c_proj", c_proj), ("w1", w1), ("w2", w2),
                    ("w3", w3), ("ws", ws)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    tile_rows, grid = _launch_shape(in_dim, out_dim, ws is not None, max(rows, 1),
                                    _sm_count(dev.index), tile_rows)

    out = torch.empty((rows, out_dim), device=dev, dtype=torch.float32)
    if rows == 0:
        return out
    lib = _library()
    t_stride = out_dim if t_proj.shape[0] == rows and rows > 1 else 0
    with torch.cuda.device(dev):
        err = lib.diffsg_resblock_f32(
            _ptr(x), _ptr(t_proj), t_stride, _ptr(c_proj),
            _ptr(g1), _ptr(be1), _ptr(w1), _ptr(b1),
            _ptr(g2), _ptr(be2), _ptr(w2), _ptr(b2),
            _ptr(g3), _ptr(be3), _ptr(w3), _ptr(b3),
            _ptr(ws), _ptr(bs), _ptr(out), rows, in_dim, out_dim,
            torch.cuda.current_stream(dev).cuda_stream, tile_rows, grid)
    if err != 0:
        msg = lib.diffsg_cuda_error_string(err).decode()
        raise RuntimeError(f"resblock kernel launch failed: {msg} ({err})")
    obs.count("resblock_launches", 1, x)
    return out


def last_launch() -> Dict[str, object]:
    """Path (``"narrow"`` or ``"wide"``), tile rows, grid size and
    shared-memory bytes of the last launch in this process (tile rows, grid
    and bytes 0 before the first)."""
    info = (ctypes.c_int * 4)()
    _library().diffsg_resblock_last_launch(info)
    return {"variant": (NARROW, WIDE)[info[0]], "tile_rows": info[1], "grid": info[2],
            "smem_bytes": info[3]}


def resblock_params_tuple(res) -> tuple:
    """The kernel's weight arguments from a ``models.unet1d.ResidualBlock``:
    (g1, be1, w1, b1, g2, be2, w2, b2, g3, be3, w3, b3, ws, bs), with
    ``ws, bs = None, None`` when the block has no shortcut."""
    args = (res.norm1.scale, res.norm1.bias, res.lin1.kernel, res.lin1.bias,
            res.norm2.scale, res.norm2.bias, res.lin2.kernel, res.lin2.bias,
            res.norm3.scale, res.norm3.bias, res.lin3.kernel, res.lin3.bias)
    if res.shortcut is not None:
        return args + (res.shortcut.kernel, res.shortcut.bias)
    return args + (None, None)

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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_LN_EPS = 1e-5

#: Number of kernel launches in this process; only the CUDA path counts.
LAUNCHES = 0

_F32P = ctypes.c_void_p
_ARGTYPES = ([_F32P, _F32P, ctypes.c_int, _F32P] + [_F32P] * 12
             + [_F32P, _F32P, _F32P] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


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


def _library() -> ctypes.CDLL:
    lib = _build.library()
    fn = lib.diffsg_resblock_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        lib.diffsg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.diffsg_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
) -> torch.Tensor:
    """One residual block: the CUDA kernel on a CUDA device, the plain
    version on the CPU. Raises on anything the kernel does not take."""
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
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")

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
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.diffsg_cuda_error_string(err).decode()
        raise RuntimeError(f"resblock kernel launch failed: {msg} ({err})")
    global LAUNCHES
    LAUNCHES += 1
    return out


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

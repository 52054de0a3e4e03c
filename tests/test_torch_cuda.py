"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

from diffsg_tpu_torch.ops import resblock
from diffsg_tpu_torch.ops.resblock import fused_residual_block, resblock_reference

# (rows, in_dim, out_dim, t_proj rows): the cases of tests/test_pallas.py
# (128 -> 128 at 64 rows, 256 -> 128 with shortcut at 32 rows), the narrow
# widths 8 and 16 (narrower than a warp), the (1, out) t_proj broadcast of
# the sampler, and row counts that are no multiple of any tile (37, 45).
CASES = [
    (64, 128, 128, "full"),
    (32, 256, 128, "full"),
    (37, 8, 8, "row"),
    (37, 16, 16, "row"),
    (45, 16, 8, "row"),
    (45, 32, 16, "full"),
    (37, 128, 64, "row"),
]


def block_inputs(rows, din, dout, t_kind, seed):
    """NumPy-seeded block arguments in ``fused_residual_block`` order."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    t_rows = 1 if t_kind == "row" else rows
    args = [n(rows, din), n(t_rows, dout), n(rows, dout)]
    for k_in in (din, dout, dout):
        args += [1.0 + n(k_in, scale=0.1), n(k_in, scale=0.1),
                 n(k_in, dout, scale=k_in ** -0.5), n(dout, scale=0.1)]
    sc = [n(din, dout, scale=din ** -0.5), n(dout, scale=0.1)] if din != dout else [None, None]
    return args + sc


def to_torch(args, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,din,dout,t_kind", CASES + [(16384, 256, 128, "row"),
                                                          (1000, 256, 128, "full")])
def test_cuda_kernel_matches_reference(rows, din, dout, t_kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = to_torch(block_inputs(rows, din, dout, t_kind, seed=rows + din), device="cuda")
    before = resblock.LAUNCHES
    out = fused_residual_block(*args)
    torch.cuda.synchronize()
    assert resblock.LAUNCHES == before + 1
    # f32, TF32 off, differing only in summation order over <= 256 terms.
    torch.testing.assert_close(out, resblock_reference(*args), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = to_torch(block_inputs(37, 16, 8, "row", seed=1), device="cuda")
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()        # c_proj not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_residual_block(*bad)
    bad = list(args)
    bad[-2:] = [None, None]                        # 16 -> 8 without its shortcut
    with pytest.raises(ValueError, match="shortcut"):
        fused_residual_block(*bad)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError, match="float32"):
        fused_residual_block(*bad)

"""The fused residual block on the CPU: the port's plain version against the
JAX package's Pallas kernel in interpret mode, and the wrapper's CPU rule.
The CUDA kernel itself is held to the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsg_tpu.ops.pallas_kernels import fused_residual_block as jax_fused
from diffsg_tpu_torch.ops import resblock
from diffsg_tpu_torch.ops.resblock import fused_residual_block, resblock_reference
from test_torch_cuda import CASES, block_inputs, to_torch


@pytest.mark.parametrize("rows,din,dout,t_kind", CASES)
def test_reference_matches_pallas(rows, din, dout, t_kind):
    args = block_inputs(rows, din, dout, t_kind, seed=rows + din + dout)
    ref = np.asarray(jax_fused(*[None if a is None else jnp.asarray(a) for a in args],
                               interpret=True))
    got = resblock_reference(*to_torch(args)).numpy()
    # f32 on both sides, differing only in summation order over <= 256 terms
    # (the tolerance of tests/test_pallas.py).
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_cpu_wrapper_is_the_reference_and_does_not_count():
    args = to_torch(block_inputs(37, 16, 8, "row", seed=3))
    before = resblock.LAUNCHES
    out = fused_residual_block(*args)
    assert resblock.LAUNCHES == before
    torch.testing.assert_close(out, resblock_reference(*args), rtol=0, atol=0)


def test_row_broadcast_equals_full_t_proj():
    args = to_torch(block_inputs(37, 16, 16, "row", seed=4))
    full = list(args)
    full[1] = args[1].expand(37, 16).contiguous()
    torch.testing.assert_close(fused_residual_block(*args), fused_residual_block(*full),
                               rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    args = to_torch(block_inputs(8, 8, 8, "row", seed=5), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_residual_block(*args)


"""The fused residual block on the CPU: the port's plain version against the
JAX package's Pallas kernel in interpret mode, and the wrapper's CPU rule.
The CUDA kernel itself is held to the plain version in test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsg_tpu.ops.pallas_kernels import fused_residual_block as jax_fused
from diffsg_tpu_torch import obs
from diffsg_tpu_torch.models import UNet1D, unet_msr, unet_nu
from diffsg_tpu_torch.ops import resblock
from diffsg_tpu_torch.ops.resblock import (SMEM_MAX, fused_residual_block, resblock_grid,
                                           resblock_reference, resblock_smem_bytes,
                                           resblock_tile_heights, resblock_tile_rows,
                                           resblock_variant)
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
    before = obs.counters()["resblock_launches"]
    out = fused_residual_block(*args)
    assert obs.counters()["resblock_launches"] == before
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



# (in, out, shortcut, tile rows, bytes): the kernel's footprint reckoned by
# hand. Wide: 4 * (rows * (max(in, out) + pad) + 3 * 4096), pad 8 at out > 128
# (the row's LayerNorm partial sums), else 4. Narrow, G lanes a row (2, 4, 8 up to widths 8, 16,
# 32) and 256 / G rows: 4 * (weights + 2 in + 8 out + 8 warps * 2 buffers *
# (32 / G rows) * (4 G + 4)).
@pytest.mark.parametrize("din,dout,sc,tile_rows,nbytes", [
    (256, 128, True, 64, 4 * (64 * 260 + 12288)),        # 115,712: two CTAs an SM
    (256, 128, True, 32, 4 * (32 * 260 + 12288)),        # 82,432
    (128, 128, False, 64, 4 * (64 * 132 + 12288)),       # 82,944
    (128, 64, True, 64, 4 * (64 * 132 + 12288)),         # 82,944
    (64, 32, True, 32, 4 * (32 * 68 + 12288)),           # 57,856
    (512, 256, True, 32, 4 * (32 * 520 + 12288)),        # 115,712: two CTAs an SM
    (256, 256, False, 32, 4 * (32 * 264 + 12288)),       # 82,944
    (32, 64, True, 64, 4 * (64 * 68 + 12288)),           # 66,560
    (32, 16, True, 32, 4 * (2 * 512 + 2 * 256 + 64 + 128 + 8 * 2 * 4 * 36)),   # 16,128
    (32, 32, False, 32, 4 * (3 * 1024 + 64 + 256 + 8 * 2 * 4 * 36)),          # 22,784
    (16, 8, True, 64, 4 * (2 * 128 + 2 * 64 + 32 + 64 + 8 * 2 * 8 * 20)),     # 12,160
    (8, 8, False, 128, 4 * (3 * 64 + 16 + 64 + 8 * 2 * 16 * 12)),             # 13,376
])
def test_resblock_smem_bytes_reckoned(din, dout, sc, tile_rows, nbytes):
    assert resblock_smem_bytes(din, dout, sc, tile_rows) == nbytes


def test_resblock_tile_rows_and_grid_reckoned():
    # MSR-3c at 2B = 16,384 rows on 132 SMs: 64-row tiles (256 of them),
    # two CTAs an SM (at most 115,712 B each): one CTA per tile.
    assert resblock_tile_rows(256, 128, True, 16384, 132) == 64
    assert resblock_grid(256, 128, True, 16384, 64, 132) == 256
    assert resblock_tile_rows(128, 128, False, 16384, 132) == 64
    assert resblock_grid(128, 128, False, 16384, 64, 132) == 256
    # The proj-256 blocks take 32-row tiles only: 512 tiles on 264 CTAs.
    assert resblock_tile_rows(512, 256, True, 16384, 132) == 32
    assert resblock_grid(512, 256, True, 16384, 32, 132) == 264
    assert resblock_grid(256, 256, False, 16384, 32, 132) == 264
    # One CTA an SM above 115,712 B (a 96 -> 64 tile of 64 rows is less).
    assert resblock_grid(512, 64, True, 16384, 64, 132) == 132
    # Too few rows to give every SM a 64-row tile: the lowest height.
    assert resblock_tile_rows(256, 128, True, 1000, 132) == 32
    assert resblock_grid(256, 128, True, 1000, 32, 132) == 32
    # Narrow: 256 / G rows a tile (G = 8, 4, 2 lanes a row at widths 32,
    # 16, 8), one CTA a tile.
    assert resblock_tile_rows(32, 16, True, 16384, 132) == 32
    assert resblock_tile_rows(16, 16, False, 16384, 132) == 64
    assert resblock_tile_rows(8, 8, False, 16384, 132) == 128
    assert resblock_grid(32, 16, True, 16384, 32, 132) == 512
    assert resblock_grid(32, 32, False, 65536, 32, 132) == 2048
    assert resblock_grid(8, 8, False, 37, 128, 132) == 1


# (in, out, path, tile heights): the narrow path takes blocks no wider than
# 32 (8 lanes of one float4 a row); every wider block, whatever its width
# class, takes the wide path, 36 and 60 included.
@pytest.mark.parametrize("din,dout,variant,heights", [
    (32, 32, "narrow", (32,)), (32, 16, "narrow", (32,)), (24, 12, "narrow", (32,)),
    (16, 8, "narrow", (64,)), (8, 8, "narrow", (128,)),
    (36, 36, "wide", (32, 64)), (40, 32, "wide", (32, 64)), (32, 36, "wide", (32, 64)),
    (48, 48, "wide", (32, 64)), (48, 32, "wide", (32, 64)), (60, 60, "wide", (32, 64)),
    (64, 32, "wide", (32, 64)), (32, 64, "wide", (32, 64)),
])
def test_resblock_path_boundary(din, dout, variant, heights):
    assert resblock.NARROW_MAX_WIDTH == 32
    assert resblock_variant(din, dout) == variant
    assert resblock_tile_heights(din, dout) == heights
    for tile_rows in heights:
        nbytes = resblock_smem_bytes(din, dout, din != dout, tile_rows)
        if variant == "wide":   # the tile is max(in, out) + 4 floats wide, plus the ring
            assert nbytes == 4 * (tile_rows * (max(din, dout) + 4) + 3 * 4096)
        assert nbytes <= SMEM_MAX


def test_resblock_sizing_refuses_widths_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="out_dim <= 256"):
        resblock_tile_heights(256, 512)
    with pytest.raises(ValueError, match="in_dim <= 512"):
        resblock_tile_heights(1024, 256)
    with pytest.raises(ValueError, match="at 32 rows"):
        resblock_smem_bytes(32, 16, True, 64)


def _block_shapes(model):
    return sorted({(m.lin1.kernel.shape[0], m.lin1.kernel.shape[1], m.shortcut is not None)
                   for m in model.modules() if type(m).__name__ == "ResidualBlock"})


# The attention-free nets the repo ships: MSR-3c (ckpts/ddpm_msr_3c_T100),
# NU (ckpts/ddpm_nu_3u_aug32_s8c) and proj 256 (ckpts/ddpm_msr_80c_budget
# and kin, the widest: 512 -> 256 with a shortcut).
SHIPPED_NETS = {
    "msr": lambda: unet_msr(3),
    "nu": lambda: unet_nu(3),
    "p256": lambda: UNet1D(input_dim=80, proj_dim=256, cond_dim=81, dims=(256, 128, 64, 32),
                           n_blocks=2),
}


@pytest.mark.parametrize("net", sorted(SHIPPED_NETS))
def test_every_shipped_block_shape_fits_a_tile(net):
    with torch.device("meta"):
        model = SHIPPED_NETS[net]()
    shapes = _block_shapes(model)
    assert shapes
    for din, dout, sc in shapes:
        heights = resblock_tile_heights(din, dout)
        assert any(resblock_smem_bytes(din, dout, sc, r) <= SMEM_MAX for r in heights)
        for rows in (1, 1000, 16384):
            tr = resblock_tile_rows(din, dout, sc, rows, 132)
            assert tr in heights
            assert resblock_smem_bytes(din, dout, sc, tr) <= SMEM_MAX
            assert 1 <= resblock_grid(din, dout, sc, rows, tr, 132) <= -(-rows // tr)
    if net == "p256":
        assert (512, 256, True) in shapes

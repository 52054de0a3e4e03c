"""The whole-UNet forward on the CPU: the port's plain mega version against
the JAX package's ``unet_forward_mega`` in interpret mode and its flax
forward, the weight packer, and the wrapper's rules. The CUDA kernel itself
is held to the plain version in test_torch_cuda.py."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsg_tpu.models import UNet1D as JaxUNet1D, unet_msr as jax_unet_msr, unet_nu as jax_unet_nu
from diffsg_tpu.models.unet1d_pallas import unet_topology as jax_topology
from diffsg_tpu.ops.pallas_mega import unet_forward_mega as jax_mega
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch import obs
from diffsg_tpu_torch.models import UNet1D, unet_apply_fn, unet_msr, unet_nu
from diffsg_tpu_torch.ops import mega
from diffsg_tpu_torch.ops.mega import pack_params, unet_forward_mega, unet_forward_mega_reference
from diffsg_tpu_torch.utils import params_from_jax

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPTS = pathlib.Path(__file__).resolve().parent.parent / "ckpts"
# The widest net the repo ships without attention: ckpts/ddpm_msr_80c_budget
# (also ddpm_msr_80c_wf250k, ddpm_multi_80, ddpm_multi_zoo).
P256 = dict(input_dim=80, proj_dim=256, cond_dim=81, dims=(256, 128, 64, 32), n_blocks=2)


def unet_p256():
    return UNet1D(**P256)


def _inputs(B, D, C, seed=0):
    """2B rows as the sampler folds them: batch-1 t, rows [0:B/2] CFG-masked."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, D)).astype(np.float32)
    t = np.array([0.35], np.float32)
    c = rng.uniform(size=(B, C)).astype(np.float32)
    m = np.concatenate([np.zeros((B // 2, 1)), np.ones((B - B // 2, 1))]).astype(np.float32)
    return y, t, c, m


def _torch(arrays, dtype=None):
    ts = [torch.from_numpy(a) for a in arrays]
    return ts if dtype is None else [t.to(dtype) for t in ts]


def _random_params(model, seed):
    """Seeded numpy weights for ``model`` (kernels uniform in +-1/sqrt(in),
    as torch's init; biases N(0, 0.1); LayerNorm scales 1 + N(0, 0.1)),
    loaded into it and returned as the flax tree."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in model.state_dict().items():
        if p.dim() == 2:
            bound = 1.0 / np.sqrt(p.shape[0])
            a = rng.uniform(-bound, bound, p.shape)
        else:
            a = float(name.endswith("scale")) + 0.1 * rng.normal(size=p.shape)
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = a.astype(np.float32)
    model.load_state_dict(params_from_jax(tree), strict=True)
    return tree


@pytest.fixture(scope="module")
def msr_random():
    """unet_msr(3) with seeded random weights, B = 96, tile 32: the case of
    tests/test_pallas.py::test_mega_kernel_matches_flax."""
    jmodel, model = jax_unet_msr(3), unet_msr(3)
    params = _random_params(model, seed=0)
    inputs = _inputs(96, 3, 3)
    f32 = np.asarray(jax_mega(params, jmodel, *inputs, tile_rows=32, interpret=True))
    return jmodel, params, model, inputs, f32


def test_f32_matches_jax_mega_and_flax(msr_random):
    jmodel, params, model, inputs, jax_out = msr_random
    y, t, c, m = inputs
    flax_out = np.asarray(jmodel.apply({"params": params}, y, np.broadcast_to(t, (96,)), c, m))
    with torch.no_grad():
        got = unet_forward_mega_reference(model, *_torch(inputs)).numpy()
    # f32 on both sides, summed in another order (the tolerance of
    # tests/test_pallas.py). Measured: 4.8e-7 against outputs of 0.96.
    np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, flax_out, rtol=0, atol=1e-6)


def test_bf16_matches_jax_mega_bf16(msr_random):
    jmodel, params, model, inputs, jax_f32 = msr_random
    bf = jnp.bfloat16
    jax_bf16 = np.asarray(jax_mega(params, jmodel, *[jnp.asarray(a, bf) for a in inputs],
                                   tile_rows=32, interpret=True, compute_dtype=bf))
    with torch.no_grad():
        got = unet_forward_mega_reference(model, *_torch(inputs, torch.bfloat16),
                                          compute_dtype=torch.bfloat16).numpy()
    assert got.dtype == np.float32
    # Both round to bf16 after every layer of 37 (8 significant bits); a
    # float32 reassociation that flips one rounding (the time MLP's st
    # differs by one bf16 ulp in places) carries through the net. Measured:
    # 1.17e-2 against outputs of 0.96 (1.2%), while JAX's own bf16 output
    # is 1.02e-2 from its f32 one and the port's 0.97e-2. Hold the port to
    # 2% of the output's magnitude, and its error against f32 to between a
    # quarter of and twice JAX's own.
    scale = np.abs(jax_f32).max()
    np.testing.assert_allclose(got, jax_bf16, rtol=0, atol=2e-2 * scale)
    jerr, terr = np.abs(jax_bf16 - jax_f32).max(), np.abs(got - jax_f32).max()
    assert 0.25 * jerr <= terr <= 2 * jerr, (terr, jerr)

@pytest.mark.parametrize("ckpt,build,jbuild,D,C", [
    ("ddpm_msr_3c_T100", lambda: unet_msr(3), lambda: jax_unet_msr(3), 3, 3),
    ("ddpm_nu_3u_aug32_s8c", lambda: unet_nu(3), lambda: jax_unet_nu(3), 5, 6),
    ("ddpm_msr_80c_budget", unet_p256,
     lambda: JaxUNet1D(**P256, is_attn=(False,) * 4, middle_attn=False), 80, 81),
])
def test_checkpoint_forward_matches_flax(ckpt, build, jbuild, D, C):
    params = jax_load_checkpoint(str(CKPTS / ckpt))["params"]
    model = build()
    model.load_state_dict(params_from_jax(params), strict=True)
    B = 16 if D == 80 else 48
    inputs = _inputs(B, D, C, seed=D)
    y, t, c, m = inputs
    flax_out = np.asarray(jbuild().apply({"params": params}, y, np.broadcast_to(t, (B,)), c, m))
    with torch.no_grad():
        got = unet_apply_fn(model, "mega")(*_torch(inputs)).numpy()
    # The forward tolerance of test_torch_unet.py: 1e-4 of the output's magnitude.
    np.testing.assert_allclose(got, flax_out, rtol=0, atol=1e-4 * np.abs(flax_out).max())


def _packed_arrays(model):
    """(table row, column, module parameter) of every array ``pack_params``
    packs, walking the net in its own order."""
    rows = [("feature_proj", model.feature_proj)]
    rows += [(k, m.res if k == "block" else m.lin) for k, m in zip(model.down_kinds, model.down)]
    rows += [("block", model.middle.res1), ("block", model.middle.res2)]
    rows += [(k, m.res if k == "block" else m.lin) for k, m in zip(model.up_kinds, model.up)]
    rows += [("head", model)]
    out = []
    for i, (kind, m) in enumerate(rows):
        if kind == "block":
            names = [(mega.K_G1, m.norm1.scale), (mega.K_BE1, m.norm1.bias),
                     (mega.K_W1, m.lin1.kernel), (mega.K_B1, m.lin1.bias),
                     (mega.K_WT, m.time_emb.kernel), (mega.K_BT, m.time_emb.bias),
                     (mega.K_G2, m.norm2.scale), (mega.K_BE2, m.norm2.bias),
                     (mega.K_W2, m.lin2.kernel), (mega.K_B2, m.lin2.bias),
                     (mega.K_WC, m.cond_emb.kernel), (mega.K_BC, m.cond_emb.bias),
                     (mega.K_G3, m.norm3.scale), (mega.K_BE3, m.norm3.bias),
                     (mega.K_W3, m.lin3.kernel), (mega.K_B3, m.lin3.bias)]
            if m.shortcut is not None:
                names += [(mega.K_WS, m.shortcut.kernel), (mega.K_BS, m.shortcut.bias)]
        elif kind == "head":
            names = [(mega.K_G1, m.norm.scale), (mega.K_BE1, m.norm.bias),
                     (mega.K_W1, m.final.kernel), (mega.K_B1, m.final.bias)]
        else:
            names = [(mega.K_W1, m.kernel), (mega.K_B1, m.bias)]
        out += [(i, col, p.detach()) for col, p in names]
    return out


@pytest.mark.parametrize("build,dims", [(lambda: unet_msr(3), (64, 32, 16, 8)),
                                        (lambda: unet_nu(3), (32, 16, 8)),
                                        (unet_p256, P256["dims"])])
def test_pack_params_table_reproduces_topology(build, dims):
    torch.manual_seed(0)
    model = build()
    packed = pack_params(model, torch.bfloat16, torch.device("cpu"))
    keys = ("kind", "in", "out", "flags", "skip_off", "skip_w")
    table = [dict(zip(keys, r[:6])) for r in packed.table.tolist()]
    down, up = jax_topology(dims, 2)
    kinds = ["feature_proj"] + ["block" if k == "block" else "resample" for k in down] \
        + ["block", "block"] + up + ["head"]
    names = {mega.FEATURE_PROJ: "feature_proj", mega.BLOCK: "block",
             mega.RESAMPLE: "resample", mega.HEAD: "head"}
    assert [names[r["kind"]] for r in table] == kinds
    # Widths: the module's own, layer by layer.
    layers = [model.feature_proj] + [m.res.lin1 if k == "block" else m.lin
                                     for k, m in zip(model.down_kinds, model.down)]
    layers += [model.middle.res1.lin1, model.middle.res2.lin1]
    layers += [m.res.lin1 if k == "block" else m.lin for k, m in zip(model.up_kinds, model.up)]
    layers += [model.final]
    assert [(r["in"], r["out"]) for r in table] == [tuple(lin.kernel.shape) for lin in layers]
    # Every pushed entry is popped in reverse order, by an up block whose
    # input is [x, skip].
    stack = []
    for r in table:
        if r["flags"] & mega.F_CONCAT:
            assert stack.pop() == (r["skip_off"], r["skip_w"])
            assert r["in"] == r["out"] + r["skip_w"] and r["flags"] & mega.F_SHORTCUT
        if r["flags"] & mega.F_PUSH:
            stack.append((r["skip_off"], r["skip_w"]))
    assert stack == []
    assert packed.skip_width == sum(r["skip_w"] for r in table if r["flags"] & mega.F_PUSH)
    assert packed.weights.dtype == torch.bfloat16
    # The padded-width column is the output width rounded up to 16.
    rows = packed.table.tolist()
    assert [r[mega.K_LDW] for r in rows] == [-(-r[mega.K_OUT] // 16) * 16 for r in rows]
    # Every weight but the time MLP's, each array padded to 16 in every
    # dimension.
    n = sum(int(np.prod([-(-d // 16) * 16 for d in p.shape]))
            for name, p in model.named_parameters() if not name.startswith("time_emb."))
    assert packed.weights.numel() == n
    # The first block's lin1 kernel lies where its row says, rows ldw apart.
    r = rows[1]
    k_in, ldw = -(-r[mega.K_IN] // 16) * 16, r[mega.K_LDW]
    w1 = packed.weights[r[mega.K_W1]:r[mega.K_W1] + k_in * ldw].view(k_in, ldw)
    torch.testing.assert_close(w1[:r[mega.K_IN], :r[mega.K_OUT]],
                               model.down[0].res.lin1.kernel.detach().bfloat16())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("build", [lambda: unet_msr(3), lambda: unet_nu(3), unet_p256],
                         ids=["msr", "nu", "p256"])
def test_pack_params_padded_layout(build, dtype):
    """Every array of the net (all but the time MLP) lies where its table
    row says, starts on a multiple of 32 bytes, each Dense padded to 16 in
    both dimensions; unpacked it is the model's own, and every pad is 0."""
    torch.manual_seed(1)
    model = build()
    packed = pack_params(model, dtype, torch.device("cpu"))
    w, rows = packed.weights, packed.table.tolist()
    covered = torch.zeros(w.numel(), dtype=torch.bool)
    arrays = _packed_arrays(model)
    for i, col, p in arrays:
        off = rows[i][col]
        assert off * w.element_size() % 32 == 0, (i, col, off)
        shape = tuple(-(-n // 16) * 16 for n in p.shape)
        if p.dim() == 2:
            assert shape[1] == rows[i][mega.K_LDW]
        n = int(np.prod(shape))
        assert not covered[off:off + n].any(), f"array ({i}, {col}) overlaps another"
        covered[off:off + n] = True
        view = w[off:off + n].view(shape)
        inner = tuple(slice(0, d) for d in p.shape)
        torch.testing.assert_close(view[inner], p.to(dtype), rtol=0, atol=0)
        pad = view.clone()
        pad[inner] = 0
        assert not pad.any(), f"nonzero pad in array ({i}, {col})"
    assert bool(covered.all()), "the buffer holds values of no array"
    n_params = sum(p.numel() for name, p in model.named_parameters()
                   if not name.startswith("time_emb."))
    assert sum(p.numel() for _, _, p in arrays) == n_params


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("build", [lambda: unet_msr(3), lambda: unet_nu(3), unet_p256],
                         ids=["msr", "nu", "p256"])
def test_mega_smem_bytes_every_shipped_net_fits(build, dtype):
    """Every attention-free net the repo ships has a tile height that fits a
    CTA, and the wrapper's choice at the serving row counts is one of them."""
    model = build()
    packed = pack_params(model, dtype, torch.device("cpu"))
    sizes = {r: mega.mega_smem_bytes(packed, dtype, r) for r in mega.TILE_ROWS[dtype]}
    assert sizes[min(sizes)] <= mega.SMEM_MAX, sizes
    # Taller tiles need more: each row adds its tiles, nothing else grows.
    assert sorted(sizes.values()) == [sizes[r] for r in sorted(sizes)]
    for rows in (37, 1000, 16384, 1 << 20):
        tile = mega.mega_tile_rows(packed, rows, sms=132)
        assert tile in mega.TILE_ROWS[dtype] and sizes[tile] <= mega.SMEM_MAX
        grid = mega.mega_grid(packed, rows, tile, sms=132)
        assert 1 <= grid <= -(-rows // tile) and grid <= 2 * 132


def test_mega_smem_bytes_reckoned():
    """The footprints at the tile heights the launcher takes, reckoned by
    hand from the layout (strides: float32 rounded to 4; bf16 rounded to 16,
    plus 8): the time projections in float32, st, then per row the y, sc,
    x, swish(LN(.)) and h tiles."""
    msr, p256 = pack_params(unet_msr(3)), pack_params(unet_p256())
    # MSR-3c float32: 1,256 projections, st 512; per row 4 + 4 + 2 x 256 + 128.
    assert mega.mega_smem_bytes(msr, torch.float32, 32) == 4 * 1256 + 4 * (512 + 32 * 648)
    # The proj-256 net float32: 3,744 projections, st 1,024; per row
    # 80 + 84 + 2 x 512 + 256.
    assert mega.mega_smem_bytes(p256, torch.float32, 16) == 4 * 3744 + 4 * (1024 + 16 * 1444)
    # Two 32-row float32 CTAs fit an SM on MSR-3c; the proj-256 net takes
    # 16-row tiles, two to an SM, where the skip stack in shared memory
    # (2,208 values per row) made even one too many before.
    assert mega.mega_tile_rows(msr, 16384, 132) == 32
    assert mega.mega_tile_rows(p256, 16384, 132) == 16
    assert mega.mega_grid(p256, 16384, 16, 132) == 264
    assert p256.skip_width == 2208 and msr.skip_width == 744
    # bf16 adds 8 staging tiles of 16 x 16 floats; strides are the width
    # rounded to 16, plus 8. MSR-3c per row: 24 + 24 + 2 x 264 + 136.
    msr_bf, p256_bf = (pack_params(m, torch.bfloat16) for m in (unet_msr(3), unet_p256()))
    assert mega.mega_smem_bytes(msr_bf, torch.bfloat16, 64) == \
        8192 + 4 * 1256 + 2 * (512 + 64 * 712)
    # The proj-256 net per row: 88 + 104 + 2 x 520 + 264.
    assert mega.mega_smem_bytes(p256_bf, torch.bfloat16, 64) == \
        8192 + 4 * 3744 + 2 * (1024 + 64 * 1496)
    # MSR-3c bf16 at 16,384 rows: 64-row tiles, two CTAs to an SM, 256 tiles
    # (128-row tiles would leave SMs without a tile).
    assert mega.mega_tile_rows(msr_bf, 16384, 132) == 64
    assert mega.mega_grid(msr_bf, 16384, 64, 132) == 256
    assert mega.mega_smem_bytes(msr_bf, torch.bfloat16, 128) > mega.SMEM_TWO_PER_SM
    # NU bf16 at 1,048,576 rows: 128-row tiles, two CTAs to an SM.
    nu_bf = pack_params(unet_nu(3), torch.bfloat16)
    assert mega.mega_tile_rows(nu_bf, 1 << 20, 132) == 128
    assert mega.mega_grid(nu_bf, 1 << 20, 128, 132) == 264
    # No 128-row bf16 tile of the proj-256 net fits a CTA.
    assert mega.mega_smem_bytes(p256_bf, torch.bfloat16, 128) > mega.SMEM_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_params_refuses_a_net_too_wide_for_any_tile(dtype):
    # A 3,072-wide concat: more shared memory than a CTA has at any height.
    # Built on the meta device, so no weight is allocated: the check comes
    # before any weight is read.
    with torch.device("meta"):
        model = UNet1D(input_dim=4, proj_dim=64, cond_dim=4, dims=(1536,), n_blocks=1)
    with pytest.raises(ValueError, match=r"bytes of shared memory .* more than the 232,448"):
        pack_params(model, dtype, torch.device("cpu"))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    model = unet_nu(3)
    y, t, c, m = _torch(_inputs(8, 5, 6))
    with torch.no_grad():          # the wrapper is forward-only
        with pytest.raises(ValueError, match="batch-1 time"):
            unet_forward_mega(model, y, t.expand(8).contiguous(), c, m)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            unet_forward_mega(model, y, t, c, m, compute_dtype=torch.float16)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            pack_params(model, torch.float64)
        with pytest.raises(ValueError, match="do not fit"):
            unet_forward_mega(model, y[:, :3], t, c, m)
        with pytest.raises(ValueError, match="multiples of 4"):
            pack_params(UNet1D(input_dim=5, proj_dim=30, cond_dim=6, dims=(32, 16, 8)))
        with pytest.raises(ValueError, match="cuda or cpu"):
            unet_forward_mega(model, *[a.to("meta") for a in (y, t, c, m)])
    with pytest.raises(TypeError, match="float32 only"):
        unet_apply_fn(model, "fused", compute_dtype=torch.bfloat16)
    # Attention nets build (the plain backend runs them), and the kernel
    # refuses them, as the JAX kernel does (pallas_mega.py:151).
    with pytest.raises(NotImplementedError):
        pack_params(UNet1D(is_attn=(False, False, False), middle_attn=True))


def test_cpu_wrapper_is_the_reference_and_does_not_count():
    model = unet_nu(3)
    inputs = _torch(_inputs(20, 5, 6, seed=2))
    before = obs.counters()["mega_launches"]
    with torch.no_grad():
        out = unet_apply_fn(model, "mega")(*inputs)
        ref = unet_forward_mega_reference(model, *inputs)
    assert obs.counters()["mega_launches"] == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# The odd-width net of the card tests: widths that are no multiple of 16
# (20, 12, 8; concats of 40 and 24).
def unet_odd():
    return UNet1D(input_dim=3, proj_dim=20, cond_dim=4, dims=(12, 8), n_blocks=2)


@pytest.mark.parametrize("build,dtype,path", [
    (lambda: unet_nu(3), torch.float32, "rows"),
    (unet_odd, torch.float32, "rows"),
    (lambda: unet_nu(3, cond_extra=1), torch.float32, "rows"),
    (lambda: unet_nu(3), torch.bfloat16, "tile"),
    (unet_odd, torch.bfloat16, "tile"),
    (lambda: unet_msr(3), torch.float32, "tile"),
    (unet_p256, torch.float32, "tile"),
    (lambda: unet_nu(3, cond_extra=3, proj_dim=64, dims=(64, 32, 16)), torch.float32, "tile"),
], ids=["nu-f32", "odd-f32", "nu_budget-f32", "nu-bf16", "odd-bf16", "msr-f32", "p256-f32",
        "nu_geo-f32"])
def test_mega_path_rule(build, dtype, path):
    """The design is a function of the packed net and its type alone:
    float32 nets whose every input is at most 64 wide and every output (D
    included) at most 32 take the row-resident kernel; bf16 and the wider
    nets the tile kernel."""
    packed = pack_params(build(), dtype, torch.device("cpu"))
    assert mega.mega_path(packed) == path
    narrow = packed.max_in <= mega.ROW_MAX_IN and max(packed.max_out, packed.input_dim) <= 32
    assert (path == "rows") == (dtype == torch.float32 and narrow)


@pytest.mark.parametrize("build", [lambda: unet_nu(3), unet_odd, lambda: unet_msr(3), unet_p256],
                         ids=["nu", "odd", "msr", "p256"])
def test_pack_params_staged_ranges(build):
    """Each layer's staged range (K_STAGE, K_NSTAGE) is one contiguous run of
    the buffer that holds exactly the arrays the layer reads per row (a
    block's all but W_t and b_t), starts on 16 values (64 bytes) and is a
    multiple of 16 values long, so one bulk copy moves it; ``stage_max`` is
    the longest."""
    torch.manual_seed(2)
    model = build()
    packed = pack_params(model, torch.float32, torch.device("cpu"))
    rows = packed.table.tolist()
    per_layer = {}
    for i, col, p in _packed_arrays(model):
        size = int(np.prod([-(-n // 16) * 16 for n in p.shape]))
        per_layer.setdefault(i, []).append((col, rows[i][col], size))
    for i, r in enumerate(rows):
        start, n = r[mega.K_STAGE], r[mega.K_NSTAGE]
        assert start % 16 == 0 and n % 16 == 0 and n > 0, (i, start, n)
        staged = sorted((off, size) for col, off, size in per_layer[i]
                        if col not in (mega.K_WT, mega.K_BT))
        # The staged arrays tile [start, start + n) with no gap.
        assert staged[0][0] == start and staged[-1][0] + staged[-1][1] == start + n, i
        assert all(a + sa == b for (a, sa), (b, _) in zip(staged, staged[1:])), i
        for col, off, size in per_layer[i]:
            if col in (mega.K_WT, mega.K_BT):   # read once a CTA, from device memory
                assert off + size <= start or off >= start + n, (i, col)
    assert packed.stage_max == max(r[mega.K_NSTAGE] for r in rows)
    # The NU net's largest range: a 64 -> 32 up block with its shortcut,
    # 4 x 64 + 9 x 32 vector values and W1, W2, W3, Ws, W_c (padded to 16 rows).
    if packed.input_dim == 5 and packed.cond_dim == 6:
        assert packed.stage_max == 4 * 64 + 9 * 32 - 128 + 64 * 32 * 2 + 32 * 32 * 2 + 16 * 32


def test_mega_row_smem_bytes_reckoned():
    """The row-resident kernel's shared memory, reckoned by hand for the NU
    net: 128 bytes of mbarriers, two weight buffers of the largest range
    (7,072 values) with a thread a row and four with a warp, 456 time
    projections, st (128), the table (30 rows of 32), and with a thread a
    row 64 + 32 + 6 columns a row."""
    nu = pack_params(unet_nu(3))
    fixed = 456 + 128 + 30 * 32
    assert nu.stage_max == 7072 and nu.table.shape[0] == 30
    assert mega.mega_row_smem_bytes(nu, 384) == 128 + 4 * (2 * 7072 + fixed + 384 * 102)
    assert mega.mega_row_smem_bytes(nu, 8, 32) == 128 + 4 * (4 * 7072 + fixed)
    assert mega.mega_row_smem_bytes(nu, 16, 32) == mega.mega_row_smem_bytes(nu, 8, 32)
    # 384 rows a CTA fit; 416 do not.
    assert mega.mega_row_smem_bytes(nu, 384) <= mega.SMEM_MAX < mega.mega_row_smem_bytes(nu, 416)


@pytest.mark.parametrize("rows,layout", [
    (1, (32, 8, 1)), (16, (32, 8, 2)), (1000, (32, 8, 125)), (1056, (32, 8, 132)),
    (1057, (32, 16, 67)), (4096, (32, 16, 132)), (4097, (1, 128, 33)), (65536, (1, 128, 264)),
    (202368, (1, 128, 264)), (202369, (1, 384, 132)), (1 << 20, (1, 384, 132)),
])
def test_mega_row_layout_from_the_row_count(rows, layout):
    """Lanes a row, rows a CTA and grid on 132 SMs for the NU net: a warp a
    row up to 4,096 rows, 8 warps a CTA while every SM gets at most one CTA,
    then 16 (one CTA an SM: 16 warps of 119 KB); a thread a row above, 128
    rows a CTA (two an SM) until 384-row CTAs leave every SM four tiles
    (more than 384 x 527 = 202,368 rows), then 384 (one an SM)."""
    nu = pack_params(unet_nu(3))
    assert mega.mega_row_layout(nu, rows, sms=132) == layout
    lanes, cta_rows, grid = layout
    assert mega.mega_row_smem_bytes(nu, cta_rows, lanes) <= mega.SMEM_MAX
    assert 1 <= grid <= -(-rows // cta_rows)


def test_mega_row_layout_odd_and_few_sms():
    """The odd-width net lays out as the NU net does; on 3 SMs the grids
    stay within what is resident and every CTA gets a tile."""
    odd = pack_params(unet_odd())
    assert mega.mega_path(odd) == "rows"
    for rows in (1, 37, 1000, 4096, 4097, 1 << 16):
        lanes, cta_rows, grid = mega.mega_row_layout(odd, rows, sms=3)
        assert lanes in (1, 32) and (lanes == 32) == (rows <= mega.ROW_WARP_MAX_ROWS)
        assert 1 <= grid <= min(-(-rows // cta_rows), 3 * (384 // cta_rows if lanes == 1 else 4))
        assert mega.mega_row_smem_bytes(odd, cta_rows, lanes) <= mega.SMEM_MAX

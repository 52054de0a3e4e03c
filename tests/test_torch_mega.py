"""The whole-UNet forward on the CPU: the port's plain mega version against
the JAX package's ``unet_forward_mega`` in interpret mode and its flax
forward, the weight packer, and the wrapper's rules. The CUDA kernel itself
is held to the plain version in test_torch_cuda.py."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsg_tpu.models import unet_msr as jax_unet_msr, unet_nu as jax_unet_nu
from diffsg_tpu.models.unet1d_pallas import unet_topology as jax_topology
from diffsg_tpu.ops.pallas_mega import unet_forward_mega as jax_mega
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.models import UNet1D, unet_apply_fn, unet_msr, unet_nu
from diffsg_tpu_torch.ops import mega
from diffsg_tpu_torch.ops.mega import pack_params, unet_forward_mega, unet_forward_mega_reference
from diffsg_tpu_torch.utils import params_from_jax

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPTS = pathlib.Path(__file__).resolve().parent.parent / "ckpts"


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
])
def test_checkpoint_forward_matches_flax(ckpt, build, jbuild, D, C):
    params = jax_load_checkpoint(str(CKPTS / ckpt))["params"]
    model = build()
    model.load_state_dict(params_from_jax(params), strict=True)
    inputs = _inputs(48, D, C, seed=D)
    y, t, c, m = inputs
    flax_out = np.asarray(jbuild().apply({"params": params}, y, np.broadcast_to(t, (48,)), c, m))
    with torch.no_grad():
        got = unet_apply_fn(model, "mega")(*_torch(inputs)).numpy()
    # The forward tolerance of test_torch_unet.py: 1e-4 of the output's magnitude.
    np.testing.assert_allclose(got, flax_out, rtol=0, atol=1e-4 * np.abs(flax_out).max())


@pytest.mark.parametrize("build,dims", [(lambda: unet_msr(3), (64, 32, 16, 8)),
                                        (lambda: unet_nu(3), (32, 16, 8))])
def test_pack_params_table_reproduces_topology(build, dims):
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
    # Every weight but the time MLP's, each array padded to 8 values.
    n = sum(p.numel() + (-p.numel() % 8) for name, p in model.named_parameters()
            if not name.startswith("time_emb."))
    assert packed.weights.numel() == n
    # The first block's lin1 kernel lies where its row says.
    r = packed.table[1].tolist()
    w1 = packed.weights[r[mega.K_W1]:r[mega.K_W1] + r[mega.K_IN] * r[mega.K_OUT]]
    torch.testing.assert_close(w1.view(r[mega.K_IN], r[mega.K_OUT]),
                               model.down[0].res.lin1.kernel.detach().bfloat16())


def test_wrapper_rejects_what_the_kernel_does_not_take():
    model = unet_nu(3)
    y, t, c, m = _torch(_inputs(8, 5, 6))
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
    with pytest.raises(ValueError, match="'mega' backend only"):
        unet_apply_fn(model, "fused", compute_dtype=torch.bfloat16)
    # Attention configs cannot be built, so no net with attention reaches
    # the kernel.
    with pytest.raises(NotImplementedError):
        UNet1D(is_attn=(False, False, False), middle_attn=True)


def test_cpu_wrapper_is_the_reference_and_does_not_count():
    model = unet_nu(3)
    inputs = _torch(_inputs(20, 5, 6, seed=2))
    before = mega.LAUNCHES
    with torch.no_grad():
        out = unet_apply_fn(model, "mega")(*inputs)
        ref = unet_forward_mega_reference(model, *inputs)
    assert mega.LAUNCHES == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)

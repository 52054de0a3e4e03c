"""The port in bfloat16 against the JAX package in bfloat16, on the CPU: the
mega forward following its input's type, the ``plain`` bfloat16 backend
against flax, and the bfloat16 DDIM-3 production row of ``bench.py``."""

import copy
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.diffusion import ddim_sample as jax_ddim_sample
from diffsg_tpu.models import unet_msr as jax_unet_msr, unet_nu as jax_unet_nu
from diffsg_tpu.ops.pallas_mega import unet_forward_mega as jax_mega
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.diffusion import ddim_sample
from diffsg_tpu_torch.models import unet_apply_fn, unet_msr, unet_nu
from diffsg_tpu_torch.ops import nu_rate
from diffsg_tpu_torch.ops.mega import unet_forward_mega
from diffsg_tpu_torch.tasks import TASKS
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPTS = pathlib.Path(__file__).resolve().parent.parent / "ckpts"
NU_CKPT = CKPTS / "ddpm_nu_3u_aug32_s8c"
BF = jnp.bfloat16
NETS = {"msr": ("ddpm_msr_3c_T100", lambda: unet_msr(3), lambda: jax_unet_msr(3), 3, 3),
        "nu": ("ddpm_nu_3u_aug32_s8c", lambda: unet_nu(3), lambda: jax_unet_nu(3), 5, 6)}


def _inputs(B, D, C, seed=0):
    """2B rows as the sampler folds them: batch-1 t, rows [0:B/2] CFG-masked."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, D)).astype(np.float32)
    t = np.array([0.35], np.float32)
    c = rng.uniform(size=(B, C)).astype(np.float32)
    m = np.concatenate([np.zeros((B // 2, 1)), np.ones((B - B // 2, 1))]).astype(np.float32)
    return y, t, c, m


def _nets(net):
    ckpt, build, jbuild, D, C = NETS[net]
    params = jax_load_checkpoint(str(CKPTS / ckpt))["params"]
    model = build()
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, jax.tree.map(lambda a: a.astype(BF), params), model, jbuild(), D, C


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32)) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


def test_mega_follows_its_input_type_as_jax():
    """bf16 params and bf16 inputs, no compute_dtype: JAX's mega kernel
    computes in bf16 and returns bf16 (``pallas_mega.py:155-198``); so does
    the port, on a bf16 copy of the net."""
    params, pb, model, jmodel, D, C = _nets("nu")
    inputs = _inputs(96, D, C, seed=4)
    jout = jax_mega(pb, jmodel, *[jnp.asarray(a, BF) for a in inputs], tile_rows=32,
                    interpret=True)
    assert jout.dtype == BF
    low = copy.deepcopy(model).to(torch.bfloat16)
    bf_in = [torch.from_numpy(a).bfloat16() for a in inputs]
    with torch.no_grad():
        got = unet_forward_mega(low, *bf_in)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, unet_apply_fn(low, "mega")(*bf_in))
        # With compute_dtype the output is float32, whatever the inputs.
        f32_out = unet_forward_mega(model, *bf_in, compute_dtype=torch.bfloat16)
        assert f32_out.dtype == torch.float32
        # A float32 net without compute_dtype follows float32 inputs.
        assert unet_forward_mega(model, *[torch.from_numpy(a) for a in inputs]).dtype == \
            torch.float32
    # bf16 rounds after every one of 37 layers, and the two sides round a
    # few values differently (test_bf16_rounding_points_against_xla); a flip
    # carries through the net. Measured: max 7.8e-2, mean 6.0e-3 against
    # outputs of 6.8, where JAX's own bf16 output lies max 1.2e-1, mean
    # 7.7e-3 from its f32 one. Hold the port within that distance.
    jf32 = np.asarray(jax_mega(params, jmodel, *inputs, tile_rows=32, interpret=True))
    err, own = np.abs(_f32(got) - _f32(jout)), np.abs(_f32(jout) - jf32)
    assert err.max() <= own.max() and err.mean() <= own.mean(), \
        (err.max(), own.max(), err.mean(), own.mean())


@pytest.mark.parametrize("net", ["msr", "nu"])
def test_plain_bf16_matches_flax_bf16(net):
    params, pb, model, jmodel, D, C = _nets(net)
    inputs = _inputs(64, D, C, seed=5)
    fwd = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))
    flax_bf16 = fwd(pb, *[jnp.asarray(a, BF) for a in inputs])
    assert flax_bf16.dtype == BF
    before = model.feature_proj.kernel.clone()
    with torch.no_grad():
        got = unet_apply_fn(model, "plain", compute_dtype=torch.bfloat16)(
            *[torch.from_numpy(a) for a in inputs])
    assert got.dtype == torch.bfloat16
    assert model.feature_proj.kernel.dtype == torch.float32      # never cast in place
    assert torch.equal(model.feature_proj.kernel, before)
    # Measured: 9.0e-2 against outputs of 6.2 (NU) and 9.8e-4 against
    # 3.9e-3 (MSR-3c), where JAX's bf16 lies 9.1e-2 and 8.7e-4 from its f32
    # forward. Hold the port within twice that distance.
    flax_f32 = np.asarray(fwd(params, *inputs))
    np.testing.assert_allclose(_f32(got), _f32(flax_bf16), rtol=0,
                               atol=2 * np.abs(_f32(flax_bf16) - flax_f32).max())
    with pytest.raises(TypeError, match="float32 only"):
        unet_apply_fn(model, "fused", compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        unet_apply_fn(copy.deepcopy(model).to(torch.bfloat16), "fused")(
            *[torch.from_numpy(a).bfloat16() for a in inputs])


def test_bf16_rounding_points_against_xla(monkeypatch):
    """Where the port's bf16 forward and flax's differ, and by nothing else.
    XLA on the CPU expands sigmoid to 1 / (1 + exp(-x)) with every op
    rounded to bf16, and rounds the sinusoid's weakly typed frequency step
    to bf16 before it multiplies; the port keeps torch.sigmoid (rounded
    once) and a float step. With those two put in, the port's plain bf16
    forward equals flax's program compiled with every op rounded (no
    excess float32 precision) bit for bit: LayerNorm's float32 statistics,
    the dense layers and the rest already round where flax does."""
    from diffsg_tpu_torch.models import unet1d

    def xla_swish(x):
        return x * torch.sigmoid(x) if x.dtype == torch.float32 else \
            x * (1.0 / (1.0 + torch.exp(-x)))

    def xla_sinusoid(self, t):
        half = self.in_dim // 8
        step = float(torch.tensor(-(math.log(10_000) / (half - 1)), dtype=t.dtype))
        freq = torch.exp(torch.arange(half, dtype=t.dtype) * step)
        emb = t[:, None] * freq[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)

    params, pb, model, jmodel, D, C = _nets("nu")
    inputs = _inputs(64, D, C, seed=5)
    bf_in = [jnp.asarray(a, BF) for a in inputs]
    fwd = jax.jit(lambda p, *a: jmodel.apply({"params": p}, *a))
    strict = fwd.lower(pb, *bf_in).compile(
        compiler_options={"xla_allow_excess_precision": False})(pb, *bf_in)
    monkeypatch.setattr(unet1d, "swish", xla_swish)
    monkeypatch.setattr(unet1d.TimeEmbedding, "sinusoid", xla_sinusoid)
    with torch.no_grad():
        got = unet_apply_fn(model, "plain", compute_dtype=torch.bfloat16)(
            *[torch.from_numpy(a) for a in inputs])
    np.testing.assert_array_equal(_f32(got), _f32(strict))


def _jax_production_y0(params, cfg, X, init):
    """``bench.py:_production_row``'s DDIM-3 (flax forward, omega 0.125, no
    compute_dtype) on the given conditions and y_T, in their type."""
    jck = jax_load_checkpoint(str(NU_CKPT))
    model = JAX_TASKS["nu_direct"].build_model(cfg)
    return jax.jit(lambda p, c, i: jax_ddim_sample(
        lambda p_, y, t, c_, m: model.apply({"params": p_}, y, t, c_, m), p, jck["sched"], c,
        0.125, 5, n_steps=3, init_noise=i)[0])(params, X, init)


def _port_production_y0(model, sched, X, init, backend):
    """The port's bf16 DDIM-3: ``plain`` on a bf16 copy made by
    ``unet_apply_fn``, or ``mega`` on a bf16 copy of the net (bf16 in, bf16
    out; its plain version on the CPU)."""
    apply_fn = (unet_apply_fn(model, "plain", compute_dtype=torch.bfloat16) if backend == "plain"
                else unet_apply_fn(copy.deepcopy(model).to(torch.bfloat16), "mega"))
    with torch.no_grad():
        return ddim_sample(apply_fn, sched, torch.from_numpy(X).bfloat16(), 0.125, 5, n_steps=3,
                           init_noise=torch.from_numpy(init).bfloat16())


def _mean_rate(cfg, X, y0):
    """Mean nu_rate of the nu_direct decode of y0, decoded in float32."""
    users = torch.from_numpy(np.asarray(TASKS["nu_direct"].unnormalize_x(X, cfg), np.float32))
    return float(nu_rate(TASKS["nu_direct"].decode(torch.from_numpy(_f32(y0)), cfg), users).mean())


@pytest.fixture(scope="module")
def nu_production():
    params, pb, model, _, _, _ = _nets("nu")
    cfg = jax_load_checkpoint(str(NU_CKPT))["metadata"]["dataset_config"]
    sched = load_checkpoint(str(NU_CKPT), device="cpu")["sched"]
    return params, pb, model, cfg, sched


def test_bf16_ddim3_matches_jax_production_row(nu_production):
    """The whole DDIM-3 in bf16 (state, coefficients, time, renorm), held
    to JAX's with params cast to bf16, bf16 conditions and the same numpy
    y_T cast to bf16, as ``bench.py:_production_row`` calls it."""
    params, pb, model, cfg, sched = nu_production
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (256, 6)).astype(np.float32)
    init = rng.normal(size=(256, 5)).astype(np.float32)
    Xb, ib = jnp.asarray(X, BF), jnp.asarray(init, BF)
    jy0 = _jax_production_y0(pb, cfg, Xb, ib)
    assert jy0.dtype == BF
    jf32 = np.asarray(_jax_production_y0(params, cfg, X, init))
    own = np.abs(_f32(jy0) - jf32).max()
    jrate = _mean_rate(cfg, X, jy0)
    for backend in ("plain", "mega"):
        y0 = _port_production_y0(model, sched, X, init, backend)
        assert y0.dtype == torch.bfloat16, backend
        got = _f32(y0)
        # y0: every bf16 rounding that differs (test_bf16_rounding_points_
        # against_xla) carries through three steps and the renorm. Measured:
        # 2.0e-1 (plain) and 8.6e-2 (mega) against y0 of magnitude 4.0,
        # where JAX's own bf16 y0 lies 6.7e-1 from its f32 one. Hold both
        # within that distance.
        np.testing.assert_allclose(got, _f32(jy0), rtol=0, atol=own, err_msg=backend)
        # The decoded mean rate: measured 1.1e-5 (plain) and 0 (mega) relative.
        assert _mean_rate(cfg, X, y0) == pytest.approx(jrate, rel=1e-3), backend


def test_nu_bf16_vs_jax_constant(nu_production):
    """The JAX package's bf16 production-row mean rate on chip_smoke.py's
    nu_vs_jax inputs is the constant the script holds the card's bf16 row
    to; the port's plain and mega bf16 paths give it on the CPU too."""
    import importlib.util

    params, pb, model, cfg, sched = nu_production
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (4096, 6)).astype(np.float32)
    init = rng.normal(size=(4096, 5)).astype(np.float32)
    jy0 = _jax_production_y0(pb, cfg, jnp.asarray(X, BF), jnp.asarray(init, BF))
    assert _mean_rate(cfg, X, jy0) == pytest.approx(chip_smoke.NU_JAX_BF16_MEAN_RATE, rel=1e-6)
    for backend in ("plain", "mega"):
        rate = _mean_rate(cfg, X, _port_production_y0(model, sched, X, init, backend))
        assert rate == pytest.approx(chip_smoke.NU_JAX_BF16_MEAN_RATE, rel=1e-3), backend

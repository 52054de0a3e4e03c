"""The port's CFG-DDPM sampler on the MSR-3c T=100 checkpoint, against the
JAX package's, with the same injected noise, in float32 and with the
denoiser forward in bfloat16 (``compute_dtype``); and the fused backend's
prepared path (the condition prologue and the time table) against its
per-call forward."""

import copy
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.baselines import waterfilling as jax_waterfilling
from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample
from diffsg_tpu.diffusion import schedule_from_betas as jax_schedule_from_betas
from diffsg_tpu.models import unet_msr as jax_unet_msr
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.ops import msr_decode as jax_msr_decode, msr_sum_rate as jax_sum_rate
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch import obs
from diffsg_tpu_torch.baselines import waterfilling
from diffsg_tpu_torch.diffusion import cfg_sample, ddim_sample, schedule_from_betas
from diffsg_tpu_torch.models import unet_apply_fn, unet_msr
from diffsg_tpu_torch.ops import msr_decode, msr_sum_rate
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "ckpts" / "ddpm_msr_3c_T100"


@pytest.fixture(scope="module")
def both():
    jck = jax_load_checkpoint(str(CKPT))
    ck = load_checkpoint(str(CKPT), device="cpu")
    model = unet_msr(3)
    model.load_state_dict(params_from_jax(ck["params"]), strict=True)
    cfg = ck["metadata"]["dataset_config"]
    return jck, ck["sched"], model, cfg


def _noise(B, T, seed):
    rng = np.random.default_rng(seed)
    cond = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    return cond, rng.normal(size=(B, 3)).astype(np.float32), \
        rng.normal(size=(T, B, 3)).astype(np.float32)


def _sample_both(both, cond, init, steps, omega, valid=None):
    jck, sched, model, _ = both
    japply = jax_apply_fn(jax_unet_msr(3), "xla")
    vm = None if valid is None else jnp.asarray(valid)
    jy0 = jax.jit(lambda c, i, s: jax_cfg_sample(
        japply, jck["params"], jck["sched"], c, omega, 3, init_noise=i,
        step_noise=s, valid_mask=vm)[0])(cond, init, steps)
    ty0 = cfg_sample(unet_apply_fn(model, "fused"), sched, torch.from_numpy(cond), omega, 3,
                     init_noise=torch.from_numpy(init), step_noise=torch.from_numpy(steps),
                     valid_mask=None if valid is None else torch.from_numpy(valid))
    return np.asarray(jy0), ty0


def test_omega0_matches_jax_elementwise(both):
    cfg = both[3]
    cond, init, steps = _noise(64, 100, seed=0)
    jy0, ty0 = _sample_both(both, cond, init, steps, 0.0)
    # The two JAX backends (flax, Pallas) agree to 3.4e-5 on y0 of scale ~108
    # here: hold the port to 1e-5 of y0's magnitude.
    np.testing.assert_allclose(ty0.numpy(), jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())
    jp = cfg["W"] * np.asarray(jax_msr_decode(jnp.asarray(jy0)))
    tp = cfg["W"] * msr_decode(ty0).numpy()
    # Decoded powers (W = 10): the JAX backends agree to 5e-7.
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)


def test_valid_mask_matches_jax_and_ignores_padding(both):
    cond, init, steps = _noise(16, 100, seed=1)
    n = 12  # rows 12..15 are padding that repeats the last real condition
    cond[n:] = cond[n - 1]
    valid = (np.arange(16) < n).astype(np.float32)[:, None]
    jy0, ty0 = _sample_both(both, cond, init, steps, 0.0, valid=valid)
    np.testing.assert_allclose(ty0.numpy(), jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())
    # The padded batch gives its real rows what an unpadded batch gives them.
    _, sched, model, _ = both
    solo = cfg_sample(unet_apply_fn(model, "fused"), sched, torch.from_numpy(cond[:n]), 0.0, 3,
                      init_noise=torch.from_numpy(init[:n]),
                      step_noise=torch.from_numpy(steps[:, :n].copy()))
    torch.testing.assert_close(ty0[:n], solo, rtol=0, atol=1e-5 * float(solo.abs().max()))


def test_omega500_mean_waterfilling_ratio_matches_jax(both):
    """At omega=500 guidance amplifies reassociation row by row (the JAX
    backends themselves differ by up to 0.17 W per row), so the port is held
    by the mean sum-rate ratio to the waterfilling optimum at B=1024."""
    cfg = both[3]
    W, mn, mx = cfg["W"], cfg["scaler_min"], cfg["scaler_max"]
    cond, init, steps = _noise(1024, 100, seed=2)
    jy0, ty0 = _sample_both(both, cond, init, steps, 500.0)
    g = cond * (mx - mn) + mn

    jg = jnp.asarray(g)
    jratio = float(jnp.mean(jax_sum_rate(W * jax_msr_decode(jnp.asarray(jy0)), jg)
                            / jax_sum_rate(jax_waterfilling(jg, W), jg)))
    tg = torch.from_numpy(g)
    tratio = float((msr_sum_rate(W * msr_decode(ty0), tg)
                    / msr_sum_rate(waterfilling(tg, W), tg)).mean())
    assert jratio > 0.99
    assert abs(tratio - jratio) <= 1e-3, (tratio, jratio)


def test_waterfilling_matches_jax():
    rng = np.random.default_rng(5)
    g = rng.uniform(0.05, 3.0, (256, 5)).astype(np.float32)
    ref = np.asarray(jax_waterfilling(jnp.asarray(g), 10.0))
    got = waterfilling(torch.from_numpy(g), 10.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 10.0, rtol=1e-6)


def test_compute_dtype_bf16_mega_matches_jax(both):
    """``compute_dtype=bfloat16`` through the mega backend, on the MSR-3c T=100
    checkpoint over the last 4 betas of its schedule (the large ones, where
    the denoiser's output moves y most), omega 0."""
    jck, _, model, _ = both
    betas = np.asarray(jck["sched"].betas, np.float64)[-4:]
    rng = np.random.default_rng(5)
    B = 16
    cond = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    init = rng.normal(size=(B, 3)).astype(np.float32)
    steps = rng.normal(size=(4, B, 3)).astype(np.float32)

    japply = jax_apply_fn(jax_unet_msr(3), "mega", tile_rows=32, interpret=True,
                          compute_dtype=jnp.bfloat16)
    jsched = jax_schedule_from_betas(betas)

    def jrun(cd):
        return np.asarray(jax_cfg_sample(japply if cd else jax_apply_fn(jax_unet_msr(3), "xla"),
                                         jck["params"], jsched, jnp.asarray(cond), 0.0, 3,
                                         init_noise=jnp.asarray(init),
                                         step_noise=jnp.asarray(steps),
                                         compute_dtype=cd)[0])

    def trun(cd):
        return cfg_sample(unet_apply_fn(model, "mega", compute_dtype=cd),
                          schedule_from_betas(betas, device="cpu"), torch.from_numpy(cond),
                          0.0, 3, init_noise=torch.from_numpy(init),
                          step_noise=torch.from_numpy(steps), compute_dtype=cd).numpy()

    jb, jf = jrun(jnp.bfloat16), jrun(None)
    tb = trun(torch.bfloat16)
    assert tb.dtype == np.float32
    # The forward rounds to bf16 at every layer of 37, so single roundings
    # flip with float32 reassociation. Measured: the port's bf16 y0 is
    # 5.7e-4 from JAX's against y0 of 3.3, while each is 1.3e-3 and 1.4e-3
    # from JAX's f32 y0. Hold the port to 1e-3 of y0's magnitude, to no more
    # than twice JAX's own bf16 error against f32, and to a bf16 error of at
    # least a quarter of JAX's (the path really rounds).
    scale = np.abs(jf).max()
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-3 * scale)
    jerr, terr = np.abs(jb - jf).max(), np.abs(tb - jf).max()
    assert 0.25 * jerr <= terr <= 2 * jerr, (terr, jerr)


def _per_call(apply_fn):
    """``apply_fn`` without its ``prepare``: the samplers then call it once a
    step, as they call every other backend."""
    return lambda y, t, c, m: apply_fn(y, t, c, m)


def _sample(sampler, apply_fn, sched, cond, init, steps, valid, skip):
    kw = dict(init_noise=init, valid_mask=valid, skip_uncond=skip)
    if sampler == "ddim":
        return ddim_sample(apply_fn, sched, cond, 500.0, 3, n_steps=10, **kw)
    return cfg_sample(apply_fn, sched, cond, 500.0, 3, step_noise=steps, **kw)


@pytest.mark.parametrize("sampler,B,masked,skip", [
    ("ddpm", 7, False, False), ("ddpm", 8, True, False), ("ddpm", 5, False, True),
    ("ddim", 6, True, False), ("ddim", 9, False, True)])
def test_fused_prepared_path_equals_per_call(both, sampler, B, masked, skip):
    """``cfg_sample`` and ``ddim_sample`` through the fused backend's prepared
    path (``FusedApplyFn.prepare``: the condition projections once a call,
    the time projections from a table) return the per-call path's answer bit
    for bit: on the call that fills the table and on the next, which reads
    it. Every step of both counts in ``hoisted_steps``."""
    _, sched, model, _ = both
    cond, init, steps = (torch.from_numpy(a) for a in _noise(B, 100, seed=B))
    valid = None
    if masked:
        valid = (torch.arange(B) < B - 2).to(torch.float32)[:, None]
        cond[B - 2:] = cond[B - 3]
    fused = unet_apply_fn(model, "fused")
    ref = _sample(sampler, _per_call(fused), sched, cond, init, steps, valid, skip)
    before = obs.COUNTS.hoisted_steps
    for _ in range(2):
        got = _sample(sampler, fused, sched, cond, init, steps, valid, skip)
        assert torch.equal(got, ref)
    n = 10 if sampler == "ddim" else 100
    assert obs.COUNTS.hoisted_steps - before == 2 * n
    assert len(fused._table) == n


def test_fused_prepare_refuses_changed_time_weights(both):
    """The time table holds the time weights as the apply function was built
    with them: after an in-place update of a block's ``time_emb`` kernel, then
    of the time MLP's bias, ``prepare`` raises ValueError, and a new apply
    function on the updated model answers as the per-call path does."""
    _, sched, model, _ = both
    model = copy.deepcopy(model)
    cond, init, steps = (torch.from_numpy(a) for a in _noise(6, 100, seed=11))
    mask = torch.ones(6, 1)
    fused = unet_apply_fn(model, "fused")
    last = _sample("ddim", fused, sched, cond, init, steps, None, False)
    for p in (model.down[0].res.time_emb.kernel, model.time_emb.lin1.bias):
        with torch.no_grad():
            p.mul_(1.5)
        with pytest.raises(ValueError, match="time weights changed"):
            fused.prepare(cond, mask)
        with pytest.raises(ValueError, match="time weights changed"):
            _sample("ddim", fused, sched, cond, init, steps, None, False)
        fused = unet_apply_fn(model, "fused")
        got = _sample("ddim", fused, sched, cond, init, steps, None, False)
        assert torch.equal(got, _sample("ddim", _per_call(fused), sched, cond, init, steps,
                                        None, False))
        assert not torch.equal(got, last)
        last = got


def test_fused_prepared_path_on_inference_weights(both):
    """Weights made under inference mode (as ``tasks.base.sample_solutions``
    loads them) carry no version counter; the prepared path keys them by
    storage and answers as the per-call path does."""
    _, sched, model, _ = both
    cond, init, steps = (torch.from_numpy(a) for a in _noise(4, 100, seed=12))
    with torch.inference_mode():
        frozen = copy.deepcopy(model)
        assert frozen.time_emb.lin1.kernel.is_inference()
        fused = unet_apply_fn(frozen, "fused")
        got = _sample("ddim", fused, sched, cond, init, steps, None, False)
        assert torch.equal(got, _sample("ddim", _per_call(fused), sched, cond, init, steps,
                                        None, False))

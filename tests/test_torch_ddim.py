"""The port's DDIM sampler against the JAX package's, with the same injected
noise, on the production NU serving setup (``ckpts/ddpm_nu_3u_aug32_s8c``,
``nu_direct``, DDIM-3, omega 0.125)."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.diffusion import ddim_sample as jax_ddim_sample
from diffsg_tpu.diffusion import respaced_steps as jax_respaced_steps
from diffsg_tpu.models import unet_nu as jax_unet_nu
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.diffusion import ddim_sample, respaced_steps
from diffsg_tpu_torch.models import unet_apply_fn, unet_nu
from diffsg_tpu_torch.tasks import TASKS
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPTS = pathlib.Path(__file__).resolve().parent.parent / "ckpts"
NU_CKPT = CKPTS / "ddpm_nu_3u_aug32_s8c"


@pytest.mark.parametrize("T,n", [(20, 3), (20, 5), (20, 20), (100, 3), (100, 7), (1000, 20),
                                 (20, 40)])
def test_respaced_steps_match_jax(T, n):
    np.testing.assert_array_equal(respaced_steps(T, n), jax_respaced_steps(T, n))


@pytest.fixture(scope="module")
def nu():
    jck = jax_load_checkpoint(str(NU_CKPT))
    ck = load_checkpoint(str(NU_CKPT), device="cpu")
    cfg = dict(ck["metadata"]["dataset_config"])
    model = unet_nu(cfg["K"])
    model.load_state_dict(params_from_jax(ck["params"]), strict=True)
    return jck, ck["sched"], model, cfg


def _draw(B, seed, D=5, C=6):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (B, C)).astype(np.float32),
            rng.normal(size=(B, D)).astype(np.float32))


def _ddim_both(nu, cond, init, omega, n_steps=3, valid=None, skip=False, param="eps",
               backend="plain"):
    jck, sched, model, _ = nu
    japply = jax_apply_fn(jax_unet_nu(3), "xla")
    vm = None if valid is None else jnp.asarray(valid)
    jy0 = jax.jit(lambda c, i: jax_ddim_sample(
        japply, jck["params"], jck["sched"], c, omega, 5, n_steps=n_steps, init_noise=i,
        valid_mask=vm, parameterization=param, skip_uncond=skip)[0])(cond, init)
    ty0 = ddim_sample(unet_apply_fn(model, backend), sched, torch.from_numpy(cond), omega, 5,
                      n_steps=n_steps, init_noise=torch.from_numpy(init),
                      valid_mask=None if valid is None else torch.from_numpy(valid),
                      parameterization=param, skip_uncond=skip)
    return np.asarray(jy0), ty0.numpy()


@pytest.mark.parametrize("backend", ["plain", "mega"])
def test_ddim3_nu_matches_jax(nu, backend):
    cfg = nu[3]
    cond, init = _draw(256, seed=0)
    jy0, ty0 = _ddim_both(nu, cond, init, 0.125, backend=backend)
    # f32, three steps at omega 0.125, which barely amplifies the forward's
    # reassociation. Measured: 1.7e-6 (plain) and 2.2e-6 (mega) against y0
    # of 3.9.
    np.testing.assert_allclose(ty0, jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())
    jdec = np.asarray(JAX_TASKS["nu_direct"].decode(jnp.asarray(jy0), cfg))
    tdec = TASKS["nu_direct"].decode(torch.from_numpy(ty0), cfg).numpy()
    # Decoded: UAV position in m (area 400 x 400; measured 1.1e-4 m), powers
    # in mW (sum 18; measured 1.4e-6 mW).
    np.testing.assert_allclose(tdec[:, :2], jdec[:, :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(tdec[:, 2:], jdec[:, 2:], rtol=0, atol=1e-5)


@pytest.mark.parametrize("param", ["x0", "v"])
def test_ddim_parameterizations_match_jax(nu, param):
    """The eps checkpoint read as an x0 or v net: the conversions alone."""
    cond, init = _draw(64, seed=1)
    jy0, ty0 = _ddim_both(nu, cond, init, 0.125, n_steps=5, param=param)
    np.testing.assert_allclose(ty0, jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())


def test_ddim_valid_mask_matches_jax_and_ignores_padding(nu):
    cond, init = _draw(32, seed=2)
    n = 24  # rows 24..31 repeat the last real condition
    cond[n:] = cond[n - 1]
    valid = (np.arange(32) < n).astype(np.float32)[:, None]
    jy0, ty0 = _ddim_both(nu, cond, init, 0.125, valid=valid)
    np.testing.assert_allclose(ty0, jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())
    _, sched, model, _ = nu
    solo = ddim_sample(unet_apply_fn(model, "plain"), sched, torch.from_numpy(cond[:n]), 0.125,
                       5, n_steps=3, init_noise=torch.from_numpy(init[:n])).numpy()
    np.testing.assert_allclose(ty0[:n], solo, rtol=0, atol=1e-5 * np.abs(solo).max())


def test_ddim_skip_uncond_at_omega0_matches_jax(nu):
    cond, init = _draw(64, seed=3)
    jy0, ty0 = _ddim_both(nu, cond, init, 0.0, skip=True)
    np.testing.assert_allclose(ty0, jy0, rtol=0, atol=1e-5 * np.abs(jy0).max())
    # At omega 0 the folded forward gives the same answer.
    _, full = _ddim_both(nu, cond, init, 0.0, skip=False)
    np.testing.assert_allclose(ty0, full, rtol=0, atol=1e-5 * np.abs(full).max())


def test_ddim_eta_draws_from_the_generator(nu):
    _, sched, model, _ = nu
    cond = torch.from_numpy(_draw(16, seed=4)[0])

    def run(eta, seed):
        return ddim_sample(unet_apply_fn(model, "plain"), sched, cond, 0.125, 5,
                           generator=torch.Generator().manual_seed(seed), n_steps=5, eta=eta)

    torch.testing.assert_close(run(1.0, 7), run(1.0, 7), rtol=0, atol=0)
    assert not torch.equal(run(1.0, 7), run(1.0, 8))
    assert not torch.equal(run(1.0, 7), run(0.0, 7))
    with pytest.raises(ValueError, match="generator"):
        ddim_sample(unet_apply_fn(model, "plain"), sched, cond, 0.125, 5, n_steps=3,
                    init_noise=torch.zeros(16, 5), eta=0.5)


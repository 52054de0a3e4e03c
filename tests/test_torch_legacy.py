"""The legacy sampler, the loss zoo, the debug evaluators, attention blocks
and the CFG-pair backend of the port, held to the JAX package on the CPU
with the same seeded NumPy inputs (and the same injected draws)."""

import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from diffsg_tpu_torch.diffusion import cosine_schedule
from diffsg_tpu_torch.diffusion.legacy import (dirichlet_noise, legacy_denoise_step,
                                               legacy_sample)
from diffsg_tpu_torch.models import AttentionBlock, UNet1D, unet_apply_fn
from diffsg_tpu_torch.ops import debug_eval, losses
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.utils.params import params_from_jax, params_to_jax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ATTN = dict(input_dim=3, proj_dim=16, cond_dim=3, dims=(8, 4), is_attn=(True, True),
            middle_attn=True, n_blocks=1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax_sched(T):
    from diffsg_tpu.diffusion import cosine_schedule as jax_schedule

    return jax_schedule(T)


# -- legacy sampler ----------------------------------------------------------------------

def test_dirichlet_noise_rows_and_signs():
    n = dirichlet_noise(np.random.default_rng(0), (16, 5), 0.0, alpha=3.0, device="cpu")
    d = np.random.default_rng(0).dirichlet(np.full(5, 3.0), 16).astype(np.float32)
    np.testing.assert_allclose(n.numpy(), d - 1.0 / 5 + 0.0 / 5, rtol=0, atol=1e-7)
    np.testing.assert_allclose(n.numpy().sum(1), 0.0, atol=1e-6)
    assert (n.numpy() < 0).any()
    n2 = dirichlet_noise(np.random.default_rng(1), (16, 5), 1.0, enable_neg=False, device="cpu")
    np.testing.assert_allclose(n2.numpy().sum(1), 1.0, atol=1e-6)
    assert (n2.numpy() >= 0).all() and n2.dtype == torch.float32


@pytest.mark.parametrize("task", ["CONV_CO", "MAX SUM RATE"])
@pytest.mark.parametrize("step", [0, 7, 19])
def test_legacy_denoise_step_matches_jax(task, step):
    from diffsg_tpu.diffusion.legacy import legacy_denoise_step as jax_step

    rng = np.random.default_rng(step)
    y, eps, z = (rng.normal(0, 1.5, (32, 3)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_step(_jax_sched(20), jnp.asarray(y), jnp.asarray(eps), step,
                               jnp.asarray(z), task))
    got = legacy_denoise_step(cosine_schedule(20, device="cpu"), _t(y), _t(eps), step, _t(z),
                              task).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if task == "MAX SUM RATE":
        assert got.max() <= 1.0 and got.min() >= 0.00001 - 1e-9


def _small_nets(kw, seed=0):
    from diffsg_tpu.models.unet1d import UNet1D as JaxUNet1D

    torch.manual_seed(seed)
    port = UNet1D(**kw)
    return port, JaxUNet1D(**kw), params_to_jax(port)


def test_legacy_sample_matches_a_jax_loop_on_the_same_draws():
    """The port's loop with injected draws against JAX's legacy_denoise_step
    and the whole-tensor min-max, step by step, with the objective record."""
    from diffsg_tpu.diffusion.legacy import legacy_denoise_step as jax_step
    from diffsg_tpu.ops.debug_eval import step_sum_rate as jax_rate

    T, B, D = 10, 8, 3
    port, jax_model, params = _small_nets(dict(input_dim=D, proj_dim=16, cond_dim=D,
                                               dims=(8, 4), n_blocks=1,
                                               is_attn=(False, False)))
    rng = np.random.default_rng(3)
    cond = rng.uniform(0.5, 2.5, (B, D)).astype(np.float32)
    init = rng.dirichlet(np.ones(D), B).astype(np.float32)
    steps = (rng.dirichlet(np.full(D, 3.0), (T, B)) - 1.0 / D).astype(np.float32)
    g = rng.uniform(0.5, 2.5, (B, D)).astype(np.float32)

    sched = _jax_sched(T)
    y = jnp.asarray(init)
    jax_records = []
    apply = jax.jit(jax_model.apply)
    for s, i in enumerate(range(T - 1, -1, -1)):
        t = jnp.full((B,), i, jnp.float32)
        eps = apply({"params": params}, y, t / T, jnp.asarray(cond), jnp.ones((B, 1)))
        z = jnp.zeros_like(y) if i == 0 else jnp.asarray(steps[s])
        y = jax_step(sched, y, eps, i, z, "MAX SUM RATE")
        y = (y - jnp.min(y)) / (jnp.max(y) - jnp.min(y))
        jax_records.append(np.asarray(jax_rate(y, jnp.asarray(g))[0]))

    with torch.no_grad():
        y0, records = legacy_sample(lambda y_, t_, c_: port(y_, t_ / T, c_, torch.ones(B, 1)),
                                    cosine_schedule(T, device="cpu"), _t(cond), D,
                                    task="MAX SUM RATE", init=_t(init), step_noise=_t(steps),
                                    record_objective=lambda y_: debug_eval.step_sum_rate(
                                        y_, _t(g))[0])
    np.testing.assert_allclose(y0.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    assert len(records) == T
    np.testing.assert_allclose(np.stack([r.numpy() for r in records]), np.stack(jax_records),
                               rtol=1e-5, atol=1e-5)


def test_legacy_sample_draws_from_its_generator():
    sched = cosine_schedule(10, device="cpu")
    run = lambda seed: legacy_sample(lambda y, t, c: 0.1 * y, sched, torch.ones(8, 3), 3,
                                     rng=np.random.default_rng(seed))[0]
    y0 = run(0)
    assert y0.shape == (8, 3) and float(y0.min()) >= 0.0 and float(y0.max()) <= 1.0
    assert torch.equal(run(0), y0) and not torch.equal(run(1), y0)
    with pytest.raises(ValueError, match="rng"):
        legacy_sample(lambda y, t, c: y, sched, torch.ones(8, 3), 3)


# -- the loss zoo and the debug evaluators ------------------------------------------------

def _loss_inputs():
    rng = np.random.default_rng(0)
    yp, yt = (rng.uniform(0, 1, (16, 3)).astype(np.float32) for _ in range(2))
    x9 = rng.uniform(0.1, 1, (16, 9)).astype(np.float32)
    g = rng.uniform(0.5, 2.5, (16, 4)).astype(np.float32)
    return yp, yt, x9, g


@pytest.mark.parametrize("name", ["class_loss", "custom_loss", "vae_loss",
                                  "convention_co_opt_loss", "sum_rate_loss"])
def test_losses_match_jax(name):
    from diffsg_tpu.ops import losses as jax_losses

    yp, yt, x9, g = _loss_inputs()
    args = {"class_loss": (yp, yt), "custom_loss": (yt, yp),
            "vae_loss": (yt, yp, yp * 0.1, yp * 0.01), "convention_co_opt_loss": (yp, x9),
            "sum_rate_loss": (yp, g)}[name]
    extra = (0.5,) if name == "vae_loss" else ()
    want = float(getattr(jax_losses, name)(*map(jnp.asarray, args), *extra))
    got = float(getattr(losses, name)(*map(_t, args), *extra))
    np.testing.assert_allclose(got, want, rtol=2e-6)


def _opt_loss_inputs():
    rng = np.random.default_rng(1)
    B, N, T = 16, 3, 20
    feat = rng.uniform(0.5, 2.0, (B, 7 * N)).astype(np.float32)
    feat[:, 6::7] = rng.uniform(0.2, 0.8, (B, N))            # alpha in (0, 1)
    tail = np.tile(rng.uniform(0.5, 2.0, 6).astype(np.float32), (B, 1))
    x0 = np.concatenate([feat, tail], axis=1)
    est, noise = (rng.normal(0, 1, (B, N)).astype(np.float32) for _ in range(2))
    y_t = rng.uniform(0.02, 0.9, (B, N)).astype(np.float32)
    alphas = (1.0 - np.asarray(cosine_schedule(T, device="cpu").betas)).astype(np.float32)
    t = rng.integers(0, T, B)
    return est, noise, y_t, x0, alphas, t


def test_diffusion_opt_loss_and_its_gradient_match_jax():
    from diffsg_tpu.ops import losses as jax_losses

    est, noise, y_t, x0, alphas, t = _opt_loss_inputs()
    j_args = [jnp.asarray(a) for a in (noise, y_t, x0, alphas, t)]
    want, want_grad = jax.value_and_grad(
        lambda e, yy: jax_losses.diffusion_opt_loss(e, j_args[0], yy, *j_args[2:]),
        argnums=(0, 1))(jnp.asarray(est), jnp.asarray(y_t))
    e, yy = _t(est).requires_grad_(True), _t(y_t).requires_grad_(True)
    got = losses.diffusion_opt_loss(e, _t(noise), yy, _t(x0), _t(alphas), _t(t))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)
    for g, w in zip((e.grad, yy.grad), want_grad):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_debug_evaluators_match_jax():
    from diffsg_tpu.ops.debug_eval import step_cost_calc, step_sum_rate

    rng = np.random.default_rng(0)
    y = rng.normal(0, 1, (8, 3)).astype(np.float32)
    x = rng.uniform(0, 1, (8, 9)).astype(np.float32)
    p = rng.uniform(0.1, 1, (8, 3)).astype(np.float32)
    g = rng.uniform(0.5, 2.5, (8, 4)).astype(np.float32)
    for fn, jfn, args in ((debug_eval.step_cost_calc, step_cost_calc, (y, x)),
                          (debug_eval.step_sum_rate, step_sum_rate, (p, g))):
        got = fn(*map(_t, args))
        want = jfn(*map(jnp.asarray, args))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-6)
    assert debug_eval.CO_DEBUG_SCALER_MAX == 9.99927554792418
    assert debug_eval.CO_DEBUG_SCALER_MIN == 0.0015867173453851023


# -- attention blocks ------------------------------------------------------------------

def test_attention_unet_matches_jax_with_carried_params():
    """tests/test_attention_config.py's net: the flax init's params load
    strictly into the port (the unused ``norm`` included) and both forwards
    agree."""
    from diffsg_tpu.models.unet1d import UNet1D as JaxUNet1D

    jax_model = JaxUNet1D(**ATTN)
    v = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 3)), jnp.zeros((2,)),
                                jnp.zeros((2, 3)), jnp.ones((2, 1)))
    port = UNet1D(**ATTN)
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, v["params"])), strict=True)
    assert "middle.attn.norm.scale" in dict(port.named_parameters())
    rng = np.random.default_rng(0)
    args = (rng.normal(0, 1, (6, 3)).astype(np.float32), rng.uniform(0, 1, 6).astype(np.float32),
            rng.uniform(0, 1, (6, 3)).astype(np.float32), np.ones((6, 1), np.float32))
    want = np.asarray(jax.jit(jax_model.apply)(v, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = port(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_attention_block_is_residual_passthrough():
    blk = AttentionBlock(8)
    x = _t(np.random.default_rng(0).normal(0, 1, (4, 8)).astype(np.float32))
    with torch.no_grad():
        qkv = x @ blk.projection.kernel + blk.projection.bias
        expect = qkv[:, 16:24] @ blk.output.kernel + blk.output.bias + x
        np.testing.assert_allclose(blk(x).numpy(), expect.numpy(), atol=1e-6)


def test_attention_checkpoint_round_trips_through_torch_files(tmp_path):
    """ddpm_to_torch and ddpm_from_torch carry the attention blocks' norm,
    projection and output keys, both ways between the packages."""
    from diffsg_tpu.utils.torch_export import ddpm_to_torch as jax_to_torch
    from diffsg_tpu.utils.torch_import import ddpm_from_torch as jax_from_torch
    from diffsg_tpu_torch.utils.torch_export import ddpm_to_torch
    from diffsg_tpu_torch.utils.torch_import import ddpm_from_torch

    port, _, params = _small_nets(ATTN, seed=2)
    sched = cosine_schedule(20, device="cpu")
    path = ddpm_to_torch(str(tmp_path / "port.pt"), params, sched)
    sd = torch.load(path, weights_only=True)
    for key in ("model.down.0.attn.norm.weight", "model.middle.attn.projection.weight",
                "ema.module.up.1.attn.output.bias"):
        assert key in sd, key
    jax_params = jax_from_torch(path)[0]
    for name, v in params_from_jax(jax.tree.map(np.asarray, jax_params)).items():
        np.testing.assert_array_equal(v.numpy(), port.state_dict()[name].numpy())
    path2 = jax_to_torch(str(tmp_path / "jax.pt"), jax_params, _jax_sched(20))
    state = ddpm_from_torch(path2, device="cpu")[0]
    back = UNet1D(**ATTN)
    back.load_state_dict(state, strict=True)
    for name, v in back.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), port.state_dict()[name].numpy())


@pytest.mark.parametrize("backend", ["fused", "mega", "pair"])
def test_kernels_reject_attention_nets(backend):
    model = UNet1D(**{**ATTN, "is_attn": (True, False), "middle_attn": False})
    y = torch.ones(4, 3)
    mask = torch.cat([torch.zeros(2, 1), torch.ones(2, 1)])
    with pytest.raises(NotImplementedError), torch.no_grad():
        unet_apply_fn(model, backend)(y, torch.ones(1) * 0.5, torch.ones(4, 3), mask)
    with torch.no_grad():          # plain runs them
        assert torch.isfinite(unet_apply_fn(model, "plain")(y, torch.ones(1) * 0.5,
                                                            torch.ones(4, 3), mask)).all()


# -- the CFG-pair backend ------------------------------------------------------------------

@pytest.mark.parametrize("ckpt,task,config", [
    ("ddpm_msr_3c_T100", "msr", None),
    ("ddpm_co", "co", {"node_num": 3, "scaler_min": 0.001618138251306864,
                       "scaler_max": 9.996995111158247})])
def test_pair_backend_matches_jax_pair_and_plain(ckpt, task, config):
    from diffsg_tpu.models.unet1d_pallas import unet_forward_cfg_pair as jax_pair
    from diffsg_tpu.utils.checkpoint import load_checkpoint as jax_load

    solver = Solver.from_checkpoint(str(REPO / "ckpts" / ckpt), task=task, device="cpu",
                                    backend="plain", dataset_config=config)
    model = solver.model
    B = 48
    rng = np.random.default_rng(5)
    y = rng.normal(0, 1, (B, model.input_dim)).astype(np.float32)
    c = rng.uniform(0, 1, (B, model.cond_dim)).astype(np.float32)
    t = np.asarray([0.37], np.float32)
    ck = jax_load(str(REPO / "ckpts" / ckpt))
    want = np.asarray(jax_pair(ck["params"], _jax_model(model), jnp.asarray(y),
                               jnp.asarray(t), jnp.asarray(c)))
    y2, c2 = _t(np.concatenate([y, y])), _t(np.concatenate([c, c]))
    mask = torch.cat([torch.zeros(B, 1), torch.ones(B, 1)])
    with torch.no_grad():
        got = unet_apply_fn(model, "pair")(y2, _t(t), c2, mask).numpy()
        plain = model(y2, _t(t), c2, mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="fold"), torch.no_grad():
        unet_apply_fn(model, "pair")(y2, _t(t), c2, torch.ones(2 * B, 1))


def _jax_model(port):
    from diffsg_tpu.models.unet1d import UNet1D as JaxUNet1D

    return JaxUNet1D(input_dim=port.input_dim, proj_dim=port.proj_dim, cond_dim=port.cond_dim,
                     dims=port.dims, is_attn=(False,) * len(port.dims), middle_attn=False,
                     n_blocks=port.n_blocks)


def test_pair_backend_samples_as_plain():
    """A DDIM-3 NU solve through cfg_sample's fold on the pair backend
    against plain (omega 0.125; the Solver's noise)."""
    X = np.random.default_rng(7).uniform(0.05, 0.95, (64, 6)).astype(np.float32)
    kw = {"omega": 0.125, "sampler": "ddim", "n_steps": 3}
    out = {b: Solver.from_checkpoint(str(REPO / "ckpts" / "ddpm_nu_3u_aug32_s8c"),
                                     task="nu_direct", device="cpu", backend=b).solve(X, **kw)
           for b in ("plain", "pair")}
    np.testing.assert_allclose(out["pair"], out["plain"], rtol=0, atol=1e-4)

"""The port's training path against the JAX package's, on the CPU.

The same numpy-seeded data and the same initial parameters go through
``diffsg_tpu.train.train_ddpm`` and ``diffsg_tpu_torch.train.train_ddpm``;
the port replays JAX's draws (``jax_draws``: the permutation, then per step
``t``, the noise and the condition mask, from the keys ``train_ddpm`` and
``build_train_epoch`` derive). Also the loss and its gradient, the
schedule, EMA, init, clip, resume, and the kernel wrappers' refusal to run
under autograd.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffsg_tpu.diffusion.ddpm import ddpm_loss as jax_ddpm_loss
from diffsg_tpu.diffusion.schedule import cosine_schedule as jax_cosine_schedule
from diffsg_tpu.models.unet1d import UNet1D as JaxUNet1D
from diffsg_tpu.train import (TrainConfig as JaxTrainConfig, multistep_lr as jax_multistep_lr,
                              torch_style_init as jax_torch_style_init,
                              train_ddpm as jax_train_ddpm)
from diffsg_tpu_torch.diffusion import cfg_sample, cosine_schedule, ddpm_loss
from diffsg_tpu_torch.models import UNet1D, unet_apply_fn
from diffsg_tpu_torch.ops import fused_residual_block, resblock_params_tuple
from diffsg_tpu_torch.ops.mega import unet_forward_mega
from diffsg_tpu_torch.tasks import TASKS, refine_solutions
from diffsg_tpu_torch.train import (EpochDraws, TrainConfig, clip_by_global_norm, ema_init,
                                    ema_update, multistep_lr, torch_style_init, train_ddpm)
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax

NET = dict(input_dim=3, proj_dim=16, cond_dim=3, dims=(8, 4), n_blocks=1)
# Three epochs of four steps, a milestone inside the run, EMA gated on.
RUN = dict(epochs=3, batch_size=64, lr=5e-3, milestones=(2,), T=10, seed=0, use_ema=True,
           warmup_epoch=0, ema_start=1, ema_update_rate=2)
# float32 on both sides; measured port-vs-JAX spread after these 12 steps:
# parameters 1.43e-6 (1.28e-6 with the clip), EMA 1.18e-6 (8.0e-7). Adam
# turns a rounding difference on a near-zero gradient into an lr-sized
# step, so the bound is on the absolute difference, 7x the spread.
PARAM_ATOL = 1e-5
# The logged losses carry 6 decimals.
LOSS_ATOL = 2e-6


def _data(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, 3)), rng.dirichlet(np.ones(3), n)


def _jax_net():
    return JaxUNet1D(**NET, is_attn=(False, False), middle_attn=False)


def _jax_init(seed=5):
    """A JAX init (flax init, then the reference's redraw) as NumPy."""
    v = _jax_net().init(jax.random.PRNGKey(seed), jnp.zeros((1, 3)), jnp.zeros((1,)),
                        jnp.zeros((1, 3)), jnp.ones((1, 1)))
    return jax.tree.map(np.asarray, jax_torch_style_init(v["params"], jax.random.PRNGKey(seed + 1)))


def _step_draws(key, B, D, T, uncond_prob):
    """One step's draws as ``diffsg_tpu.diffusion.ddpm.ddpm_loss`` makes them."""
    k_t, k_eps, k_mask = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(k_t, (B,), 0, T)),
            np.asarray(jax.random.normal(k_eps, (B, D), jnp.float32)),
            np.asarray(jax.random.bernoulli(k_mask, 1.0 - uncond_prob, (B, 1)), np.float32))


def jax_draws(cfg, n, D):
    """``draws(epoch)`` replaying JAX's ``train_ddpm`` streams: the root key
    of ``split(PRNGKey(seed), 3)``, ``fold_in(root, epoch)``, the
    permutation and one key a step (``trainer.py:142-146, 184, 215``)."""
    root = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[2]
    B = min(cfg.batch_size, n)
    steps = max(n // B, 1)

    def draws(epoch):
        k_perm, k_steps = jax.random.split(jax.random.fold_in(root, epoch))
        perm = np.asarray(jax.random.permutation(k_perm, n)[: steps * B])
        per = [_step_draws(k, B, D, cfg.T, cfg.uncond_prob)
               for k in jax.random.split(k_steps, steps)]
        t, noise, mask = (np.stack(a) for a in zip(*per))
        return EpochDraws(torch.from_numpy(perm.astype(np.int64)),
                          torch.from_numpy(t.astype(np.int64)), torch.from_numpy(noise),
                          torch.from_numpy(mask))
    return draws


def _losses(log):
    return [float(m.rsplit(" ", 1)[1]) for m in log]


def _flat(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _close(a, b, atol):
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=atol, msg=k)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's train_ddpm for each clip setting, checkpointing every 2 epochs:
    (final params, EMA, epoch losses, checkpoint dir)."""
    X, Y = _data()
    init = _jax_init()
    runs = {}
    for clip in (None, 0.05):
        ck_dir = str(tmp_path_factory.mktemp(f"jax_clip_{clip}"))
        log = []
        params, ema, _ = jax_train_ddpm(_jax_net(), X, Y, JaxTrainConfig(**RUN, grad_clip=clip),
                                        init_params=init, log_every=1, log_fn=log.append,
                                        checkpoint_every=2, checkpoint_dir=ck_dir)
        runs[clip] = (params, ema, _losses(log), ck_dir)
    return init, runs


@pytest.mark.parametrize("clip", [None, 0.05])
def test_train_ddpm_matches_jax(jax_runs, clip):
    """Three epochs across a milestone with EMA gating (and the clip): the
    epoch losses, the params and the EMA agree with JAX's."""
    init, runs = jax_runs
    j_params, j_ema, j_losses, _ = runs[clip]
    X, Y = _data()
    cfg = TrainConfig(**RUN, grad_clip=clip)
    log = []
    params, ema, sched = train_ddpm(UNet1D(**NET), X, Y, cfg, init_params=init, log_every=1,
                                    log_fn=log.append, device="cpu",
                                    draws=jax_draws(cfg, X.shape[0], 3))
    np.testing.assert_allclose(_losses(log), j_losses, rtol=0, atol=LOSS_ATOL)
    _close(_flat(j_params), params_from_jax(params), PARAM_ATOL)
    _close(_flat(j_ema.params), ema.params, PARAM_ATOL)
    assert ema.n_averaged == int(j_ema.n_averaged) == 4     # steps 6, 8, 10, 12
    assert sched.T == cfg.T


@pytest.mark.parametrize("clip", [None, 0.05])
def test_jax_checkpoint_resumes_in_port(jax_runs, clip):
    """A JAX ``checkpoint_every`` directory (epoch 2, with optax's state)
    resumes in the port and ends where JAX's run ended."""
    _, runs = jax_runs
    j_params, j_ema, j_losses, ck_dir = runs[clip]
    ck = load_checkpoint(ck_dir, device="cpu", training=True)
    assert ck["metadata"]["epoch"] == 2 and ck["step"] == 8 and "opt_state_raw" in ck
    X, Y = _data()
    cfg = TrainConfig(**RUN, grad_clip=clip)
    log = []
    params, ema, _ = train_ddpm(UNet1D(**NET), X, Y, cfg, resume_state=ck, log_every=1,
                                log_fn=log.append, device="cpu",
                                draws=jax_draws(cfg, X.shape[0], 3))
    np.testing.assert_allclose(_losses(log), j_losses[2:], rtol=0, atol=LOSS_ATOL)
    _close(_flat(j_params), params_from_jax(params), PARAM_ATOL)
    _close(_flat(j_ema.params), ema.params, PARAM_ATOL)
    assert ema.n_averaged == int(j_ema.n_averaged)


def test_resume_matches_uninterrupted(tmp_path):
    """The port's 3 + 3 epochs equal its 6 bit for bit (its own draws)."""
    X, Y = _data()
    cfg = TrainConfig(epochs=6, batch_size=64, lr=1e-3, milestones=(100,), T=10, seed=0)
    full, ema_full, _ = train_ddpm(UNet1D(**NET), X, Y, cfg, log_every=0, device="cpu")
    ck_dir = str(tmp_path / "ck")
    train_ddpm(UNet1D(**NET), X, Y, dataclasses.replace(cfg, epochs=3), log_every=0,
               checkpoint_every=3, checkpoint_dir=ck_dir, device="cpu")
    ck = load_checkpoint(ck_dir, device="cpu", training=True)
    assert ck["metadata"]["epoch"] == 3 and ck["step"] == 12
    resumed, ema_res, _ = train_ddpm(UNet1D(**NET), X, Y, cfg, log_every=0, resume_state=ck,
                                     device="cpu")
    a, b = params_from_jax(full), params_from_jax(resumed)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(ema_full.params[k], ema_res.params[k]) for k in ema_full.params)


def test_train_ddpm_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card rule cannot be shown here")
    X, Y = _data(64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ddpm(UNet1D(**NET), X, Y, TrainConfig(epochs=1))


@pytest.mark.parametrize("parameterization", ["eps", "x0", "v"])
def test_ddpm_loss_and_gradients_match_jax(parameterization):
    """The loss on JAX's draws, and the gradient of every parameter (float32).
    Measured spread: all gradients 1.7e-7 relative (L2; 7e-8 for x0, 1.2e-7
    for v); the worst parameter, a LayerNorm scale whose gradient is a sum
    that cancels, 3.6e-5 of its largest entry. Bounds 1e-6 and 2e-4."""
    rng = np.random.default_rng(3)
    B, T = 48, 10
    y0 = rng.dirichlet(np.ones(3), B).astype(np.float32)
    cond = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    params = _jax_init(7)
    key = jax.random.PRNGKey(11)
    net, sched = _jax_net(), jax_cosine_schedule(T)

    def jloss(p):
        return jax_ddpm_loss(lambda p, y, t, c, m: net.apply({"params": p}, y, t, c, m), p,
                             sched, jnp.asarray(y0), jnp.asarray(cond), key, 0.1,
                             parameterization)

    j_loss, j_grads = jax.value_and_grad(jloss)(params)
    t, noise, mask = _step_draws(key, B, 3, T, 0.1)
    model = UNet1D(**NET)
    model.load_state_dict(params_from_jax(params))
    loss = ddpm_loss(model, cosine_schedule(T, device="cpu"), torch.from_numpy(y0),
                     torch.from_numpy(cond), 0.1, parameterization, t=torch.from_numpy(t),
                     noise=torch.from_numpy(noise), cond_mask=torch.from_numpy(mask))
    loss.backward()
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-6)
    want = _flat(j_grads)
    got = {k: p.grad for k, p in model.named_parameters()}
    for k, g in want.items():
        torch.testing.assert_close(got[k], g, rtol=0, atol=2e-4 * float(g.abs().max()), msg=k)
    a, b = (torch.cat([d[k].flatten() for k in want]) for d in (got, want))
    assert float((a - b).norm() / b.norm()) <= 1e-6


def test_ddpm_loss_draws_and_rejects():
    """Without injected draws the loss draws from the generator (same
    generator state, same loss); an unknown parameterization raises."""
    model = UNet1D(**NET)
    sched = cosine_schedule(10, device="cpu")
    y0, cond = (torch.from_numpy(a.astype(np.float32)) for a in _data(32))
    with torch.no_grad():
        a = ddpm_loss(model, sched, y0, cond, generator=torch.Generator().manual_seed(4))
        b = ddpm_loss(model, sched, y0, cond, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and torch.isfinite(a)
    with pytest.raises(ValueError, match="unknown parameterization"):
        ddpm_loss(model, sched, y0, cond, parameterization="score")


def test_multistep_lr_matches_optax():
    """The rate at each update count equals optax's piecewise-constant
    schedule across the milestones, as ``tests/test_train.py`` checks it."""
    lr = multistep_lr(0.005, (100, 150), steps_per_epoch=10)
    jlr = jax_multistep_lr(0.005, (100, 150), steps_per_epoch=10)
    for step in (0, 1, 999, 1000, 1001, 1499, 1500, 5000):
        assert lr(step) == pytest.approx(float(jlr(step)), rel=1e-6)
    assert lr(999) == pytest.approx(0.005) and lr(1000) == pytest.approx(0.0005)
    assert lr(1500) == pytest.approx(0.00005)


def test_ema_first_update_copies():
    p = {"w": torch.ones(2, 2)}
    ema = ema_init(p)
    p["w"].fill_(7.0)                       # a later in-place update does not reach the copy
    assert torch.equal(ema.params["w"], torch.ones(2, 2)) and ema.n_averaged == 0
    ema = ema_update(ema, {"w": torch.full((2, 2), 3.0)}, decay=0.9999)
    assert torch.equal(ema.params["w"], torch.full((2, 2), 3.0)) and ema.n_averaged == 1
    ema = ema_update(ema, {"w": torch.full((2, 2), 5.0)}, decay=0.5)
    assert torch.equal(ema.params["w"], torch.full((2, 2), 4.0)) and ema.n_averaged == 2


def test_torch_style_init_distributions():
    """JAX's distributions (``tests/test_train.py``): kernels N(0, 0.01),
    biases within 1/sqrt(fan_in), LayerNorm scale 1 and bias 0."""
    model = torch_style_init(UNet1D(input_dim=3, proj_dim=32, cond_dim=9, dims=(16, 8),
                                    n_blocks=1), torch.Generator().manual_seed(1))
    kernels = torch.cat([p.flatten() for n, p in model.named_parameters()
                         if n.endswith("kernel")]).detach()
    assert abs(float(kernels.std()) - 0.01) < 0.001 and abs(float(kernels.mean())) < 0.001
    for name, mod in model.named_modules():
        if hasattr(mod, "kernel"):
            bound = 1 / np.sqrt(mod.kernel.shape[0])
            assert float(mod.bias.abs().max()) <= bound + 1e-7, name
        elif hasattr(mod, "scale"):
            assert torch.equal(mod.scale, torch.ones_like(mod.scale))
            assert torch.equal(mod.bias, torch.zeros_like(mod.bias))
    again = torch_style_init(UNet1D(input_dim=3, proj_dim=32, cond_dim=9, dims=(16, 8),
                                    n_blocks=1), torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("scale", [1e-3, 1e3])
def test_clip_by_global_norm_matches_optax(scale):
    """Below the threshold the gradients pass unchanged; above, they are
    scaled as optax scales them (not ``clip_grad_norm_``'s norm + 1e-6)."""
    rng = np.random.default_rng(2)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((4, 3), (3,), (5,))]
    want = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)[0]
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm(got, 1.0)
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if scale < 1:
            assert np.array_equal(g.numpy(), orig)


def _block_args(res, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(rows, res.lin1.kernel.shape[0])), dtype=torch.float32)
    t_proj = torch.tensor(rng.normal(size=(1, res.lin1.kernel.shape[1])), dtype=torch.float32)
    c_proj = torch.tensor(rng.normal(size=(rows, res.lin1.kernel.shape[1])),
                          dtype=torch.float32)
    return x, t_proj, c_proj, *resblock_params_tuple(res)


def test_kernel_wrappers_raise_under_grad():
    """Both kernels are forward-only: under autograd each wrapper raises on
    the CPU too (where it would take its plain version), for trainable
    weights and for an input that requires grad; under no_grad it runs."""
    model = UNet1D(**NET)
    rng = np.random.default_rng(1)
    y = torch.tensor(rng.normal(size=(8, 3)), dtype=torch.float32)
    c = torch.tensor(rng.uniform(size=(8, 3)), dtype=torch.float32)
    m, t = torch.ones(8, 1), torch.tensor([0.3])
    args = _block_args(model.middle.res1)
    for call in (lambda: fused_residual_block(*args),
                 lambda: unet_forward_mega(model, y, t, c, m),
                 lambda: unet_apply_fn(model, "fused")(y, t, c, m),
                 lambda: unet_apply_fn(model, "mega")(y, t, c, m)):
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
    frozen = UNet1D(**NET).requires_grad_(False)
    with pytest.raises(RuntimeError, match="forward-only"):
        unet_forward_mega(frozen, y.requires_grad_(True), t, c, m)
    detached = [a.detach() if a is not None else None for a in args]
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_residual_block(detached[0].requires_grad_(True), *detached[1:])
    with torch.no_grad():
        for backend in ("fused", "mega"):
            assert torch.isfinite(unet_apply_fn(model, backend)(y.detach(), t, c, m)).all()


@pytest.mark.parametrize("backend", ["fused", "mega"])
def test_guidance_and_refinement_do_not_differentiate_the_net(backend):
    """Guidance takes its gradient at a detached x0 estimate and refinement
    at the decoded solutions: neither goes through the net, so both run on
    a kernel backend with autograd on outside."""
    torch.manual_seed(0)
    task = TASKS["msr"]
    model = task.build_model({"M": 3})
    cfg = {"M": 3, "W": 10.0, "scaler_min": 0.5, "scaler_max": 2.5}
    X = torch.tensor(np.random.default_rng(0).uniform(0, 1, (16, 3)), dtype=torch.float32)
    sched = cosine_schedule(5, device="cpu")
    y0 = cfg_sample(unet_apply_fn(model, backend), sched, X, 2.0, 3,
                    generator=torch.Generator().manual_seed(0),
                    guidance_fn=lambda x: (x ** 2).sum(dim=1), guidance_scale=0.1)
    assert torch.isfinite(y0).all()
    Xu = torch.as_tensor(task.unnormalize_x(X.numpy(), cfg), dtype=torch.float32)
    Y = refine_solutions(task, task.decode(y0, cfg), Xu, cfg, iters=3)
    assert torch.isfinite(Y).all() and torch.allclose(Y.sum(dim=1), torch.full((16,), 10.0))

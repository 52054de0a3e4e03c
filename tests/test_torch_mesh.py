"""The port's device mesh on the CPU: worlds of four gloo processes.

Each world is spawned once (``parallel.launch.spawn``, a ``file://`` store
under the test's temporary directory, one intra-op thread a rank, a timeout
on the set-up, every collective and the join) and runs the cases of
``diffsg_tpu_torch.parallel.cases``; the tests hold rank 0's results to the
JAX package's meshed functions on the conftest's virtual devices and to the
unmeshed port on the same inputs.
"""

import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from diffsg_tpu_torch.diffusion import cosine_schedule, ddpm_loss
from diffsg_tpu_torch.models import UNet1D
from diffsg_tpu_torch.parallel import cases, launch
from diffsg_tpu_torch.parallel.dryrun import dryrun_multichip
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.train import TrainConfig, clip_by_global_norm, train_ddpm
from diffsg_tpu_torch.utils.params import params_from_jax, params_to_jax

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
NU_CKPT = str(REPO / "ckpts" / "ddpm_nu_3u_aug32_s8c")
MSR_CKPT = str(REPO / "ckpts" / "ddpm_msr_3c_T100")
TIMEOUT_S = 180
# tests/test_parallel.py's net, and one whose 128-wide blocks split over tp
# at shard_params' default tp_min_width (the gradient and training cases).
SMALL = dict(input_dim=3, proj_dim=32, cond_dim=3, dims=(16, 8), is_attn=(False, False),
             middle_attn=False, n_blocks=1)
WIDE = dict(input_dim=3, proj_dim=128, cond_dim=3, dims=(32, 16), is_attn=(False, False),
            middle_attn=False, n_blocks=1)
TRAIN_CFG = dict(batch_size=32, lr=1e-3, milestones=(100,), T=20, seed=0, use_ema=True,
                 ema_start=0, ema_update_rate=1, warmup_epoch=-1, grad_clip=0.5)
NU_KW = {"omega": 0.125, "sampler": "ddim", "n_steps": 3}
MSR_KW = {"omega": 0.0, "sampler": "ddim", "n_steps": 5}
MAX_NORM = 0.05


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def small_net():
    """The flax module and a seeded params tree for it (the port's init, so
    that no flax init is compiled)."""
    from diffsg_tpu.models.unet1d import UNet1D as JaxUNet1D

    torch.manual_seed(1)
    return JaxUNet1D(**SMALL), params_to_jax(UNet1D(**SMALL))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    B = 64
    sample = (rng.uniform(0, 1, (B, 3)).astype(np.float32),
              rng.normal(0, 1, (B, 3)).astype(np.float32),
              rng.normal(0, 1, (20, B, 3)).astype(np.float32))
    Y = rng.normal(0, 1, (B, 5)).astype(np.float32)
    valid = (np.arange(B) < 57).astype(np.float32)[:, None]
    Xnu = rng.uniform(0.05, 0.95, (50, 6)).astype(np.float32)
    Xmsr = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    N = 256
    X = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    Yt = rng.dirichlet(np.ones(3), N).astype(np.float32)
    torch.manual_seed(0)
    wide = params_to_jax(UNet1D(**WIDE))
    batch = (X[:32], Yt[:32], rng.integers(0, 20, 32),
             rng.normal(0, 1, (32, 3)).astype(np.float32),
             (rng.uniform(0, 1, (32, 1)) > 0.1).astype(np.float32))
    steps = N // TRAIN_CFG["batch_size"]
    draws = (rng.permutation(N), rng.integers(0, 20, (steps, 32)),
             rng.normal(0, 1, (steps, 32, 3)).astype(np.float32),
             (rng.uniform(0, 1, (steps, 32, 1)) > 0.1).astype(np.float32))
    return {"sample": sample, "Y": Y, "valid": valid, "Xnu": Xnu, "Xmsr": Xmsr, "X": X,
            "Yt": Yt, "wide": wide, "batch": batch, "draws": draws}


@pytest.fixture(scope="module")
def dp4(tmp_path_factory, small_net, inputs):
    cond, init, step = inputs["sample"]
    calls = [("sample", (SMALL, small_net[1], 20, 150.0, cond, init, step)),
             ("decode", (inputs["Y"], inputs["valid"])),
             ("decode", (inputs["Y"], None)),
             ("solve", (NU_CKPT, "nu_direct", inputs["Xnu"], "plain", NU_KW)),
             ("solve", (MSR_CKPT, "msr", inputs["Xmsr"], "plain", MSR_KW)),
             ("solve", (NU_CKPT, "nu_direct", inputs["Xnu"], "plain", NU_KW, (50, 64)))]
    return launch.spawn(cases.run, 4, 1, "cpu", args=(calls,), timeout_s=TIMEOUT_S,
                        store_dir=str(tmp_path_factory.mktemp("dp4")))[0]


@pytest.fixture(scope="module")
def dp2_tp2(tmp_path_factory, inputs):
    ckpt_dir = str(tmp_path_factory.mktemp("meshed_ckpt"))
    calls = [("solve", (NU_CKPT, "nu_direct", inputs["Xnu"], "plain", NU_KW)),
             ("solve", (MSR_CKPT, "msr", inputs["Xmsr"], "plain", MSR_KW)),
             ("solve", (NU_CKPT, "nu_direct", inputs["Xnu"], "fused", NU_KW)),
             ("train", (WIDE, inputs["X"], inputs["Yt"], TRAIN_CFG, ckpt_dir, inputs["wide"],
                        inputs["draws"])),
             ("grads", (WIDE, inputs["wide"], *inputs["batch"], MAX_NORM))]
    out = launch.spawn(cases.run, 4, 2, "cpu", args=(calls,), timeout_s=TIMEOUT_S,
                       store_dir=str(tmp_path_factory.mktemp("dp2_tp2")))[0]
    return out, ckpt_dir


def test_meshed_sampler_matches_jax_meshed_sampler(dp4, small_net, inputs):
    """tests/test_parallel.py's case at dp=4: the re-standardization's
    batch statistics as all-reduces, against JAX's GSPMD collectives."""
    from diffsg_tpu.diffusion import cfg_sample, cosine_schedule as jax_schedule
    from diffsg_tpu.parallel import batch_sharding, make_mesh, shard_params

    model, params = small_net
    cond, init, step = (jnp.asarray(a) for a in inputs["sample"])

    def run(p, c, i, s):
        y0, _ = cfg_sample(lambda p_, y, t, c_, m: model.apply({"params": p_}, y, t, c_, m),
                           p, jax_schedule(20), c, 150.0, 3, init_noise=i, step_noise=s)
        return y0

    mesh = make_mesh(4, tp=1)
    bs = batch_sharding(mesh)
    with jax.set_mesh(mesh):
        y_jax = np.asarray(jax.jit(run)(
            shard_params(params, mesh), jax.device_put(cond, bs), jax.device_put(init, bs),
            jax.device_put(step, jax.NamedSharding(mesh, jax.P(None, "dp")))))
    np.testing.assert_allclose(dp4[0], y_jax, rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("masked", [True, False])
def test_meshed_decode_and_statistics_match_jax(dp4, inputs, masked):
    """msr_decode's and nu_decode's global min and max and masked_mean_var
    over four shards, against JAX's on the whole batch."""
    from diffsg_tpu.diffusion.ddpm import masked_mean_var
    from diffsg_tpu.ops.decoders import msr_decode, nu_decode

    got = dp4[1 if masked else 2]
    Y = jnp.asarray(inputs["Y"])
    valid = jnp.asarray(inputs["valid"] if masked else np.ones((Y.shape[0], 1), np.float32))
    np.testing.assert_allclose(got["msr"], np.asarray(msr_decode(Y[:, :3], valid)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["nu"], np.asarray(nu_decode(Y, 400.0, 400.0, 18.0, valid)),
                               rtol=1e-6, atol=1e-6)
    mean, var = masked_mean_var(Y, valid)
    np.testing.assert_allclose([got["mean"], got["var"]], [float(mean), float(var)],
                               rtol=1e-6, atol=1e-6)


def _unmeshed(ckpt, task, X, kw):
    return Solver.from_checkpoint(ckpt, task=task, device="cpu", backend="plain").solve(X, **kw)


@pytest.mark.parametrize("world", ["dp4", "dp2_tp2"])
def test_meshed_solver_matches_unmeshed_solver(world, dp4, dp2_tp2, inputs):
    """50 rows (not a dp multiple: padded with masked rows) on NU DDIM-3 at
    omega 0.125 within 1e-3 (the JAX dryrun's bound), and MSR-3c at omega 0
    within serve_buckets' elementwise tolerance."""
    out = dp4 if world == "dp4" else dp2_tp2[0]
    nu, msr = (out[3], out[4]) if world == "dp4" else (out[0], out[1])
    assert nu.shape == (50, 5) and msr.shape == (50, 3)
    assert np.max(np.abs(nu - _unmeshed(NU_CKPT, "nu_direct", inputs["Xnu"], NU_KW))) < 1e-3
    W = Solver.from_checkpoint(MSR_CKPT, task="msr", device="cpu").config["W"]
    np.testing.assert_allclose(msr, _unmeshed(MSR_CKPT, "msr", inputs["Xmsr"], MSR_KW),
                               rtol=1e-3, atol=1e-2 * W / 400.0)


@pytest.mark.parametrize("case", ["bucket_not_dp_multiple", "tp_on_fused"])
def test_meshed_solver_refuses_as_jax_does(case, dp4, dp2_tp2):
    msg = dp4[5] if case == "bucket_not_dp_multiple" else dp2_tp2[0][2]
    expect = ("bucket 50 not divisible by dp=4" if case == "bucket_not_dp_multiple"
              else "tp=2")
    assert isinstance(msg, str) and msg.startswith("ValueError") and expect in msg, msg


def _max_err(a, b, scale):
    """The largest difference over the parameters of ``b``, over ``scale``."""
    return max(float((torch.as_tensor(a[k]).double() - torch.as_tensor(v).double()).abs().max())
               for k, v in b.items()) / scale


def test_meshed_epoch_matches_unmeshed_epoch(dp2_tp2, inputs):
    """One dp=2 x tp=2 epoch (128-wide kernels split, EMA and a global-norm
    clip on) against the unmeshed epoch on the same draws; and the loss
    falls over two epochs, as tests/test_parallel.py asserts.

    The witness is float64: on injected draws the meshed epoch equals the
    unmeshed one to 1e-12 of the largest parameter (it measured 0). In
    float32 Adam's normalization of near-zero gradients lifts rounding to
    about 3e-5 of the largest parameter after one epoch (the unmeshed
    float32 epoch against the float64 one), so the float32 meshed epoch is
    held to that drift: no further from the float64 epoch than twice the
    unmeshed float32 epoch is, and no further from the unmeshed float32
    epoch (parameters and EMA) than the drift itself."""
    from diffsg_tpu_torch.train import EpochDraws

    got = dp2_tp2[0][3]
    assert len(got["split"]) > 20, got["split"]
    drawn = EpochDraws(*(torch.as_tensor(a) for a in inputs["draws"]))
    ref = {}
    for dtype in (torch.float32, torch.float64):
        p, _, _ = train_ddpm(UNet1D(**WIDE).to(dtype), inputs["X"], inputs["Yt"],
                             TrainConfig(epochs=1, **TRAIN_CFG), init_params=inputs["wide"],
                             log_every=0, device="cpu", draws=lambda epoch: drawn)
        ref[dtype] = params_from_jax(p)
    scale = max(float(v.abs().max()) for v in ref[torch.float64].values())
    drift = _max_err(ref[torch.float32], ref[torch.float64], scale)
    assert 0 < drift < 1e-4, drift
    assert _max_err(params_from_jax(got["injected_float64"]), ref[torch.float64], scale) <= 1e-12
    assert _max_err(params_from_jax(got["injected_float32"]), ref[torch.float64], scale) \
        <= 2 * drift

    params, ema, _ = train_ddpm(UNet1D(**WIDE), inputs["X"], inputs["Yt"],
                                TrainConfig(epochs=1, **TRAIN_CFG), log_every=0, device="cpu")
    want = params_from_jax(params)
    meshed = params_from_jax(got["params"])
    scale = max(float(v.abs().max()) for v in want.values())
    for name, v in want.items():
        assert meshed[name].shape == v.shape, name
    assert _max_err(meshed, want, scale) <= drift
    assert _max_err(got["ema"], ema.params, scale) <= drift
    first, second = got["losses_2"]
    assert np.isfinite(first) and second < first


def test_tp_gradients_match_unsplit_gradients(dp2_tp2, inputs):
    """The split Dense's gather returns its own columns of the gradient: a
    gradient summed over tp (tp times too large), or a partial input
    gradient, would fail here; so would a clip norm that counts replicated
    tensors tp times."""
    got = dp2_tp2[0][4]
    assert len(got["split"]) > 20
    X, Y, t, noise, mask = inputs["batch"]
    model = UNet1D(**WIDE)
    model.load_state_dict(params_from_jax(inputs["wide"]), strict=True)
    loss = ddpm_loss(model, cosine_schedule(20, device="cpu"), torch.as_tensor(Y),
                     torch.as_tensor(X), t=torch.as_tensor(t), noise=torch.as_tensor(noise),
                     cond_mask=torch.as_tensor(mask))
    loss.backward()
    named = dict(model.named_parameters())
    raw = {k: p.grad.clone() for k, p in named.items()}
    norm = torch.sqrt(sum(torch.sum(g * g) for g in raw.values()))
    assert float(norm) > MAX_NORM           # so the clip below clips
    with torch.no_grad():
        clip_by_global_norm([p.grad for p in named.values()], MAX_NORM)
    for kind, want in (("raw", raw), ("clipped", {k: p.grad for k, p in named.items()})):
        scale = max(float(g.abs().max()) for g in want.values())
        for name, g in want.items():
            err = float((torch.as_tensor(got[kind][name]) - g).abs().max())
            assert err <= 1e-6 * max(1.0, scale), (kind, name, err)


def test_meshed_checkpoint_reads_in_jax(dp2_tp2):
    """Rank 0 writes the whole parameters in the JAX package's layout."""
    from diffsg_tpu.utils.checkpoint import load_checkpoint

    out, ckpt_dir = dp2_tp2
    ck = load_checkpoint(ckpt_dir)
    want = params_from_jax(out[3]["params"])
    have = params_from_jax(_np_tree(ck["params"]))
    assert set(have) == set(want)
    for name, v in want.items():
        np.testing.assert_array_equal(have[name].numpy(), v.numpy())
    assert int(ck["step"]) == 8 and ck["metadata"]["epoch"] == 1


def test_param_shardings_and_batch_rows_follow_jax():
    """On a (4, 2) mesh, rank r at JAX's device r: the same kernels split
    over tp as JAX's param_shardings, and the rank's rows those JAX's
    batch_sharding puts on its device."""
    from diffsg_tpu.parallel import batch_sharding as jax_batch, make_mesh
    from diffsg_tpu.parallel import param_shardings as jax_shardings
    from diffsg_tpu_torch.parallel import Mesh, param_shardings, shard_batch

    torch.manual_seed(0)
    port = UNet1D(**WIDE)
    jmesh = make_mesh(8, tp=2)
    want = {".".join(k.key for k in path): leaf.spec == jax.P(None, "tp") for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax_shardings(params_to_jax(port), jmesh))}
    X = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    shards = {s.device.id: np.asarray(s.data) for s in
              jax.device_put(X, jax_batch(jmesh)).addressable_shards}
    for rank in range(8):
        mesh = Mesh(4, 2, rank, rank // 2, rank % 2, None, None, torch.device("cpu"))
        got = {k: v == (None, "tp") for k, v in param_shardings(port, mesh).items()}
        assert got == want and sum(got.values()) > 20
        rows_x, rows_t = shard_batch((X, torch.as_tensor(X)), mesh)
        np.testing.assert_array_equal(rows_x, shards[jmesh.devices.flat[rank].id])
        np.testing.assert_array_equal(rows_t.numpy(), rows_x)


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    r = dryrun_multichip(4, device="cpu", timeout_s=TIMEOUT_S)
    assert r["shape"] == {"dp": 2, "tp": 2} and np.isfinite(r["loss"])
    assert r["serve_max_abs_err"] < 1e-3
    assert "dryrun_multichip ok: mesh=({'dp': 2, 'tp': 2}), platform=cpu" in capsys.readouterr().out

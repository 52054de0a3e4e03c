"""Checkpoints, exports, task training configs, the MSR label generators and
the training CLI of the port, against the JAX package on the CPU.

A checkpoint the port writes (params, EMA, Adam's state under optax's
keys, step, betas) restores in JAX's ``restore_train_state``; the reverse
direction, a JAX ``checkpoint_every`` directory resumed by the port, is in
``tests/test_torch_train.py``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsg_tpu.data.generators import (msr_waterfilling_labels as jax_wf_labels,
                                        sum_rate_gen as jax_sum_rate_gen)
from diffsg_tpu.diffusion.schedule import cosine_schedule as jax_cosine_schedule
from diffsg_tpu.serve import Solver as JaxSolver
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.train import (EmaState as JaxEmaState, TrainConfig as JaxTrainConfig,
                              TrainState as JaxTrainState, ema_init as jax_ema_init,
                              make_optimizer as jax_make_optimizer,
                              restore_train_state as jax_restore_train_state)
from diffsg_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from diffsg_tpu.utils.torch_export import ddpm_to_torch as jax_ddpm_to_torch
from diffsg_tpu_torch.data import msr_waterfilling_labels, sum_rate_gen, write_msr_csv
from diffsg_tpu_torch.diffusion import cosine_schedule
from diffsg_tpu_torch.models import UNet1D
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import TASKS
from diffsg_tpu_torch.tools import train_ddpm as train_cli
from diffsg_tpu_torch.train import (EmaState, TrainConfig, TrainState, make_optimizer,
                                    ema_init, torch_style_init, train_epoch)
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax, params_to_jax, \
    save_checkpoint
from diffsg_tpu_torch.utils.torch_import import ddpm_from_torch
from diffsg_tpu_torch.utils.torch_export import ddpm_to_torch

NET = dict(input_dim=3, proj_dim=16, cond_dim=3, dims=(8, 4), n_blocks=1)


def _tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def _trained_state(clip, steps=4, B=32):
    """A port TrainState after one epoch of ``steps`` steps with the EMA on
    from the first step, and its optimizer."""
    rng = np.random.default_rng(0)
    n = steps * B
    X = torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    Y = torch.tensor(rng.dirichlet(np.ones(3), n), dtype=torch.float32)
    cfg = TrainConfig(epochs=1, batch_size=B, T=10, use_ema=True, warmup_epoch=-1,
                      ema_start=0, ema_update_rate=1, grad_clip=clip)
    model = torch_style_init(UNet1D(**NET), torch.Generator().manual_seed(0))
    opt = make_optimizer(cfg, steps)
    state = TrainState(model, opt.init(model), ema_init(dict(model.named_parameters())))
    train_epoch(state, opt, cosine_schedule(cfg.T, device="cpu"), X, Y, cfg, epoch=0)
    return state, opt, cfg


@pytest.mark.parametrize("clip", [None, 0.05])
def test_port_checkpoint_restores_in_jax(tmp_path, clip):
    """JAX's load_checkpoint and restore_train_state give the port's params,
    EMA, Adam moments (mu, nu) and counts exactly, under optax's keys."""
    state, opt, cfg = _trained_state(clip)
    model, adam = state.model, state.adam
    sched = cosine_schedule(cfg.T, device="cpu")
    save_checkpoint(str(tmp_path), params_to_jax(model), ema=state.ema,
                    opt_state=opt.export_state(adam, model, state.step), step=state.step,
                    sched=sched, metadata={"epoch": 1})
    with np.load(tmp_path / "arrays.npz") as f:
        keys = set(f.files)
    pre = "opt/0/" if clip is None else "opt/1/0/"
    sched_count = "opt/1/.count" if clip is None else "opt/1/1/.count"
    assert {pre + ".count", pre + ".mu/feature_proj/kernel", pre + ".nu/final/bias",
            sched_count, "ema/n_averaged", "schedule/betas", "step"} <= keys

    ck = jax_load_checkpoint(str(tmp_path))
    params = jax.tree.map(jnp.asarray, ck["params"])
    jopt = jax_make_optimizer(JaxTrainConfig(grad_clip=clip), 4)
    template = JaxTrainState(params, jopt.init(params), jax_ema_init(params),
                             jnp.zeros((), jnp.int32))
    js, epoch = jax_restore_train_state(ck, jopt, template)
    assert epoch == 1 and int(js.step) == state.step == 4
    assert _tree_equal(jax.tree.map(np.asarray, js.params), params_to_jax(model))
    ema_tree = jax.tree.map(np.asarray, js.ema.params)
    assert all(torch.equal(params_from_jax(ema_tree)[k], state.ema.params[k])
               for k in state.ema.params)
    assert int(js.ema.n_averaged) == state.ema.n_averaged == 4
    adam_state = js.opt_state[0] if clip is None else js.opt_state[1][0]
    sched_state = js.opt_state[1] if clip is None else js.opt_state[1][1]
    assert int(adam_state.count) == int(sched_state.count) == 4
    mu = params_from_jax(jax.tree.map(np.asarray, adam_state.mu))
    nu = params_from_jax(jax.tree.map(np.asarray, adam_state.nu))
    for name, p in model.named_parameters():
        assert torch.equal(mu[name], adam.state[p]["exp_avg"]), name
        assert torch.equal(nu[name], adam.state[p]["exp_avg_sq"]), name
    np.testing.assert_array_equal(np.asarray(ck["sched"].betas),
                                  np.asarray(jax_cosine_schedule(cfg.T).betas))


@pytest.mark.parametrize("clip", [None, 0.05])
def test_port_checkpoint_round_trips_in_the_port(tmp_path, clip):
    """Saved and restored by the port, Adam's state is the live one, and a
    checkpoint loaded for serving holds no training state."""
    from diffsg_tpu_torch.train import restore_train_state

    state, opt, cfg = _trained_state(clip)
    model = state.model
    save_checkpoint(str(tmp_path), params_to_jax(model), ema=state.ema,
                    opt_state=opt.export_state(state.adam, model, state.step), step=state.step,
                    sched=cosine_schedule(cfg.T, device="cpu"), metadata={"epoch": 1})
    served = load_checkpoint(str(tmp_path), device="cpu")
    assert "ema" not in served and "opt_state_raw" not in served
    ck = load_checkpoint(str(tmp_path), device="cpu", training=True)
    fresh = UNet1D(**NET)
    other = TrainState(fresh, opt.init(fresh), ema_init(dict(fresh.named_parameters())))
    assert restore_train_state(ck, opt, other) == 1 and other.step == 4
    for (name, p), q in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(p, q), name
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(state.adam.state[p][k], other.adam.state[q][k]), (name, k)
    assert other.ema.n_averaged == 4


def test_ddpm_to_torch_matches_jax_and_round_trips(tmp_path):
    """The reference-format .pt: key for key and value for value JAX's, and
    the port's ddpm_from_torch reads back the params, EMA and schedule."""
    model = torch_style_init(UNet1D(**NET), torch.Generator().manual_seed(3))
    params = params_to_jax(model)
    ema_model = torch_style_init(UNet1D(**NET), torch.Generator().manual_seed(4))
    ema = EmaState(dict(ema_model.named_parameters()), 7)
    ddpm_to_torch(str(tmp_path / "port.pt"), params, cosine_schedule(20, device="cpu"), ema)
    jax_ddpm_to_torch(str(tmp_path / "jax.pt"), params, jax_cosine_schedule(20),
                      JaxEmaState(params_to_jax(ema_model), jnp.asarray(7)))
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    assert got.keys() == want.keys() and len(got) == 8 + 1 + 2 * len(params_from_jax(params))
    assert "model.down.2.res.lin1.weight" in got and "ema.module.up.3.res.norm1.weight" in got
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    state, ema_state, sched, n_avg = ddpm_from_torch(str(tmp_path / "port.pt"), device="cpu")
    assert n_avg == 7
    assert all(torch.equal(state[k], v) for k, v in params_from_jax(params).items())
    assert all(torch.equal(ema_state[k], v.detach()) for k, v in ema.params.items())
    assert torch.equal(sched.betas, cosine_schedule(20, device="cpu").betas)


@pytest.mark.parametrize("name", sorted(JAX_TASKS))
def test_train_config_matches_jax(name):
    assert sorted(TASKS) == sorted(JAX_TASKS)
    assert dataclasses.asdict(TASKS[name].train_config) == \
        dataclasses.asdict(JAX_TASKS[name].train_config)


@pytest.mark.parametrize("M,W,n", [(3, 10.0, 500), (8, 20.0, 300), (80, 20.0, 100)])
def test_msr_generators_match_jax(M, W, n):
    """sum_rate_gen and msr_waterfilling_labels: byte-equal to JAX's."""
    got, want = sum_rate_gen(n, M, W=W, seed=M), jax_sum_rate_gen(n, M, W=W, seed=M)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(msr_waterfilling_labels(got[0], W), jax_wf_labels(want[0], W)):
        assert a.tobytes() == b.tobytes()


def test_train_cli_trains_and_both_packages_serve(tmp_path, capsys):
    """The port's CLI (--cpu) trains one epoch on a 600-row MSR CSV written
    with the port's sum_rate_gen, saves, evaluates and logs as JAX's CLI
    does; JAX's Solver and the port's serve the checkpoint, feasibly."""
    csv = tmp_path / "3c_10w_600samples.csv"
    write_msr_csv(str(csv), *sum_rate_gen(600, 3, W=10.0, seed=0))
    out = tmp_path / "ck"
    train_cli.main(["--task", "msr", "--dataset", str(csv), "--out", str(out), "--epochs", "1",
                    "--cpu", "--checkpoint-every", "1"])
    printed = capsys.readouterr().out.strip().splitlines()
    metrics = json.loads(printed[-1])
    assert metrics["task"] == "msr" and metrics["n_samples"] == 180.0
    assert 0.5 < metrics["less_ratio"] <= 1.0 + 1e-6
    meta = json.loads((out / "metadata.json").read_text())
    assert {"task", "dataset", "config", "dataset_config", "train_seconds"} <= meta.keys()
    assert meta["format"] == "diffsg_tpu.npz.v1" and meta["config"]["epochs"] == 1
    assert meta["dataset_config"]["W"] == 10.0 and load_checkpoint(str(out), "cpu")["step"] == 1
    log = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert log[0]["msg"].startswith("epoch 0: loss ") and log[-1]["event"] == "saved"
    assert (out / "resume" / "arrays.npz").exists()

    X = np.random.default_rng(1).uniform(0, 1, (32, 3)).astype(np.float32)
    for P in (JaxSolver.from_checkpoint(str(out), task="msr").solve(X),
              Solver.from_checkpoint(str(out), task="msr", device="cpu").solve(X)):
        P = np.asarray(P)
        assert P.shape == (32, 3) and np.isfinite(P).all() and (P >= 0).all()
        np.testing.assert_allclose(P.sum(axis=1), 10.0, rtol=1e-5)


def test_train_cli_needs_a_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card rule cannot be shown here")
    csv = tmp_path / "3c_10w_100samples.csv"
    write_msr_csv(str(csv), *sum_rate_gen(100, 3, W=10.0, seed=0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--task", "msr", "--dataset", str(csv), "--out", str(tmp_path / "o")])
    with pytest.raises(SystemExit):        # --y-shift only where the decode inverts it
        train_cli.main(["--task", "msr", "--dataset", str(csv), "--out", str(tmp_path / "o"),
                        "--y-shift", "1.0", "--cpu"])

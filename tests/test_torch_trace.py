"""``cfg_sample(record_trace=True)`` and the trajectory decoders against the
JAX package's, on the same injected noise at omega 0."""

import pathlib

import numpy as np
import pytest
import torch

import jax

from diffsg_tpu.diffusion import cfg_sample as jax_cfg_sample
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu.utils.trace import decode_trace as jax_decode_trace, eps_trace as jax_eps_trace
from diffsg_tpu_torch.diffusion import SampleTrace, cfg_sample
from diffsg_tpu_torch.models import unet_apply_fn
from diffsg_tpu_torch.tasks import TASKS
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax
from diffsg_tpu_torch.utils.trace import decode_trace, eps_trace

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPTS = pathlib.Path(__file__).resolve().parent.parent / "ckpts"
# All T=20: ckpts/ddpm_msr_3c (M=3, W=10), ckpts/ddpm_nu_3u (K=3) and
# ckpts/ddpm_co (N=3, n_blocks=3).
CASES = {"msr": ("ddpm_msr_3c", {"M": 3, "W": 10.0}, 3, 3),
         "nu": ("ddpm_nu_3u", {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0}, 5, 6),
         "co": ("ddpm_co", {"node_num": 3}, 3, 9)}


@pytest.mark.parametrize("task", ["msr", "nu", "co"])
def test_record_trace_and_decoders_match_jax(task):
    ckpt, cfg, D, C = CASES[task]
    jck = jax_load_checkpoint(str(CKPTS / ckpt))
    ck = load_checkpoint(str(CKPTS / ckpt), device="cpu")
    model = TASKS[task].build_model(cfg)
    model.load_state_dict(params_from_jax(ck["params"]), strict=True)
    B, T = 32, ck["sched"].T
    rng = np.random.default_rng(3)
    cond = rng.uniform(0, 1, (B, C)).astype(np.float32)
    init = rng.normal(size=(B, D)).astype(np.float32)
    steps = rng.normal(size=(T, B, D)).astype(np.float32)
    japply = jax_apply_fn(JAX_TASKS[task].build_model(cfg), "xla")
    jy0, jtrace = jax.jit(lambda c, i, s: jax_cfg_sample(
        japply, jck["params"], jck["sched"], c, 0.0, D, init_noise=i, step_noise=s,
        record_trace=True))(cond, init, steps)
    with torch.no_grad():
        y0, trace = cfg_sample(unet_apply_fn(model, "fused"), ck["sched"], torch.from_numpy(cond),
                               0.0, D, init_noise=torch.from_numpy(init),
                               step_noise=torch.from_numpy(steps), record_trace=True)
        plain = cfg_sample(unet_apply_fn(model, "fused"), ck["sched"], torch.from_numpy(cond),
                           0.0, D, init_noise=torch.from_numpy(init),
                           step_noise=torch.from_numpy(steps))
    assert isinstance(trace, SampleTrace)
    assert trace.ys.shape == trace.eps.shape == (T, B, D)
    torch.testing.assert_close(trace.ys[-1], y0, rtol=0, atol=0)
    torch.testing.assert_close(y0, plain, rtol=0, atol=0)
    # f32 through 20 steps, reassociated: 1e-5 of the magnitude, as
    # tests/test_torch_sampler.py holds the sampler at omega 0.
    for got, ref in ((trace.ys, jtrace.ys), (trace.eps, jtrace.eps)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    dec, jdec = decode_trace(task, trace, cfg), np.asarray(jax_decode_trace(task, jtrace, cfg))
    assert dec.shape == jdec.shape == (B, T * D)
    # Decoded: softmax and min-max of states held to 1e-5 of their scale
    # (NU positions on a 400 m side, to 1e-2); CO's softmax on every step.
    np.testing.assert_allclose(dec, jdec, rtol=0, atol=1e-2 if task == "nu" else 1e-5)
    eps, jeps = eps_trace(trace), np.asarray(jax_eps_trace(jtrace))
    np.testing.assert_allclose(eps, jeps, rtol=0, atol=1e-5 * np.abs(jeps).max())

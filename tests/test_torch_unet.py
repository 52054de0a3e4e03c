"""The port's UNet1D forwards (plain, and fused on the CPU) against the JAX
package's flax forward and its Pallas forward in interpret mode."""

import pathlib

import numpy as np
import pytest
import torch

import jax

from diffsg_tpu.models import unet_msr as jax_unet_msr, unet_nu as jax_unet_nu
from diffsg_tpu.models.unet1d_pallas import unet_apply_fn as jax_apply_fn
from diffsg_tpu.models.unet1d_pallas import unet_topology as jax_topology
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.models import UNet1D, unet_apply_fn, unet_msr, unet_topology
from diffsg_tpu_torch.utils import params_from_jax

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

CKPT = pathlib.Path(__file__).resolve().parent.parent / "ckpts" / "ddpm_msr_3c_T100"


def _inputs(rows, D, C, seed, y_scale):
    """2B rows as the sampler folds them: batch-1 t, rows [0:B] CFG-masked."""
    rng = np.random.default_rng(seed)
    y = (y_scale * rng.normal(size=(rows, D))).astype(np.float32)
    t = np.array([0.37], np.float32)
    c = rng.uniform(size=(rows, C)).astype(np.float32)
    m = np.concatenate([np.zeros((rows // 2, 1)), np.ones((rows - rows // 2, 1))]).astype(np.float32)
    return y, t, c, m


def _port_outputs(model, inputs):
    ts = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        return {b: unet_apply_fn(model, b)(*ts).numpy() for b in ("plain", "fused")}


@pytest.fixture(scope="module")
def msr_nets():
    params = jax_load_checkpoint(str(CKPT))["params"]
    model = unet_msr(3)
    model.load_state_dict(params_from_jax(params), strict=True)
    return jax_unet_msr(3), params, model


def test_msr_param_count_and_topology(msr_nets):
    _, _, model = msr_nets
    assert sum(p.numel() for p in model.parameters()) == 1_539_027
    for dims, n in (((64, 32, 16, 8), 2), ((32, 16, 8), 2), ((64, 32, 16, 8), 3)):
        assert unet_topology(dims, n) == jax_topology(dims, n)


# y at the scale of a unit-variance draw, and at the O(100) scale the
# omega=500 trajectories reach.
@pytest.mark.parametrize("y_scale", [1.0, 100.0])
def test_msr_checkpoint_forward_matches_jax(msr_nets, y_scale):
    jmodel, params, model = msr_nets
    inputs = _inputs(32, 3, 3, seed=int(y_scale), y_scale=y_scale)
    flax_out = np.asarray(jmodel.apply({"params": params}, *inputs))
    pallas_out = np.asarray(jax_apply_fn(jmodel, "pallas", interpret=True)(params, *inputs))
    # f32 through 27 blocks, reassociated differently by XLA and PyTorch:
    # 1e-4 of the output's magnitude. Measured: 1.2e-5 at y_scale 1, where
    # this checkpoint's outputs are only ~4e-3 against O(1) activations
    # inside the net, and 3.5e-7 at y_scale 100.
    tol = 1e-4 * np.abs(flax_out).max()
    for name, got in _port_outputs(model, inputs).items():
        np.testing.assert_allclose(got, flax_out, rtol=0, atol=tol, err_msg=name)
        np.testing.assert_allclose(got, pallas_out, rtol=0, atol=tol, err_msg=name)


def test_nu_shaped_random_net_matches_flax():
    """A second topology: unet_nu(3) (input 5, proj 32, dims (32, 16, 8)),
    random weights from flax's own init."""
    jmodel = jax_unet_nu(3)
    inputs = _inputs(24, 5, 6, seed=7, y_scale=1.0)
    params = jmodel.init(jax.random.PRNGKey(3), *inputs)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    flax_out = np.asarray(jmodel.apply({"params": params}, *inputs))
    model = UNet1D(input_dim=5, proj_dim=32, cond_dim=6, dims=(32, 16, 8), n_blocks=2)
    model.load_state_dict(params_from_jax(params), strict=True)
    tol = 1e-5 * np.abs(flax_out).max()  # measured: 5.4e-7 relative
    for name, got in _port_outputs(model, inputs).items():
        np.testing.assert_allclose(got, flax_out, rtol=0, atol=tol, err_msg=name)


def test_attention_configs_are_rejected():
    """By the kernels, as the JAX package's Pallas backends reject them
    (the plain forward runs them: tests/test_torch_legacy.py)."""
    model = UNet1D(is_attn=(True, False, False))
    args = (torch.ones(4, 3), torch.full((1,), 0.5), torch.ones(4, 4), torch.ones(4, 1))
    for backend in ("fused", "mega"):
        with pytest.raises(NotImplementedError), torch.no_grad():
            unet_apply_fn(model, backend)(*args)
    with pytest.raises(ValueError, match="unknown backend"):
        unet_apply_fn(unet_msr(3), "pallas")

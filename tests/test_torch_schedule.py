"""The port's schedule, checkpoint reader and device rule, held to the JAX
package on the CPU."""

import pathlib

import numpy as np
import pytest
import torch

from diffsg_tpu.diffusion import cosine_beta_schedule as jax_cosine
from diffsg_tpu.diffusion import schedule_from_betas as jax_schedule
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.device import resolve_device
from diffsg_tpu_torch.diffusion import cosine_beta_schedule, schedule_from_betas
from diffsg_tpu_torch.utils import load_checkpoint

CKPT = pathlib.Path(__file__).resolve().parent.parent / "ckpts" / "ddpm_msr_3c_T100"


def _t100_betas():
    with np.load(CKPT / "arrays.npz") as d:
        return d["schedule/betas"]


def test_cosine_betas_match_fixture_and_jax(fixture_dir):
    fx = np.load(fixture_dir / "schedule_T20.npz")
    for T in (20, 500):
        got = cosine_beta_schedule(T)
        # float64 on both sides, same formula: equal to the last bits.
        np.testing.assert_allclose(got, fx[f"betas_T{T}"], rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got, jax_cosine(T))
    assert cosine_beta_schedule(20)[-1] == 0.84


@pytest.mark.parametrize("source", ["T20_fixture", "T100_checkpoint"])
def test_schedule_matches_jax(source, fixture_dir):
    betas = (np.load(fixture_dir / "schedule_T20.npz")["betas_T20"]
             if source == "T20_fixture" else _t100_betas())
    ref = jax_schedule(betas)
    got = schedule_from_betas(betas, device="cpu")
    assert got.T == ref.T == len(betas)
    for name in ref._fields:
        # float64 math cast once to float32 on both sides: bitwise equal.
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
        assert getattr(got, name).dtype == torch.float32


def test_load_checkpoint_matches_jax():
    ref = jax_load_checkpoint(str(CKPT))
    got = load_checkpoint(str(CKPT), device="cpu")
    assert got["step"] == ref["step"]
    assert got["metadata"] == ref["metadata"]

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + "/")
            else:
                yield prefix + k, v

    ref_leaves, got_leaves = dict(flat(ref["params"])), dict(flat(got["params"]))
    assert ref_leaves.keys() == got_leaves.keys()
    for k, v in ref_leaves.items():
        np.testing.assert_array_equal(got_leaves[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(got["sched"].betas.numpy(), np.asarray(ref["sched"].betas))


def test_device_rule():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card rule cannot be shown here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        schedule_from_betas(cosine_beta_schedule(10))

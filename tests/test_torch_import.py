"""``Solver.from_torch_checkpoint`` on a reference-layout ``.pt`` that the
JAX package's exporter writes from ``ckpts/ddpm_nu_3u``."""

import pathlib

import numpy as np
import pytest
import torch

import jax

from diffsg_tpu.train.ema import EmaState
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu.utils.torch_export import ddpm_to_torch
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.utils.torch_import import ddpm_from_torch

# One intra-op thread: the tests run in several worker processes at once,
# and PyTorch's per-process thread pools would contend for the same cores.
torch.set_num_threads(1)

NU = pathlib.Path(__file__).resolve().parent.parent / "ckpts" / "ddpm_nu_3u"
NU_CFG = {"K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0}


@pytest.fixture(scope="module")
def pt_path(tmp_path_factory):
    """The checkpoint as a reference .pt, with an EMA copy that differs
    from the live weights (serving reads the live ones)."""
    ck = jax_load_checkpoint(str(NU))
    ema = EmaState(jax.tree.map(lambda a: a * 0.5, ck["params"]), np.int32(7))
    return ddpm_to_torch(str(tmp_path_factory.mktemp("pt") / "ddpm_nu_3u.pt"), ck["params"],
                         ck["sched"], ema)


def test_ddpm_from_torch_reads_the_live_weights(pt_path):
    state, ema_state, sched, n_averaged = ddpm_from_torch(pt_path, device="cpu")
    ref = Solver.from_checkpoint(str(NU), task="nu", device="cpu", dataset_config=NU_CFG)
    assert n_averaged == 7 and sched.T == ref.sched.T
    for name, val in ref.model.state_dict().items():
        torch.testing.assert_close(state[name], val, rtol=0, atol=0)
        torch.testing.assert_close(ema_state[name], 0.5 * val, rtol=0, atol=0)
    for field in sched._fields:
        torch.testing.assert_close(getattr(sched, field), getattr(ref.sched, field), rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["fused", "mega"])
def test_from_torch_checkpoint_equals_from_checkpoint(pt_path, backend):
    kw = {"task": "nu", "device": "cpu", "dataset_config": NU_CFG, "backend": backend,
          "buckets": (32,)}
    ours = Solver.from_torch_checkpoint(pt_path, **kw)
    ref = Solver.from_checkpoint(str(NU), **kw)
    rng = np.random.default_rng(0)
    y = torch.tensor(rng.normal(size=(8, 5)), dtype=torch.float32)
    c = torch.tensor(rng.uniform(size=(8, 6)), dtype=torch.float32)
    t, m = torch.tensor([0.4]), torch.ones(8, 1)
    with torch.no_grad():
        torch.testing.assert_close(ours.model(y, t, c, m), ref.model(y, t, c, m), rtol=0, atol=0)
    X = rng.uniform(0, 1, (20, 6)).astype(np.float32)
    np.testing.assert_array_equal(ours.solve(X, seed=3), ref.solve(X, seed=3))

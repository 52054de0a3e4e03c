"""The proj-256 zoo checkpoint (``ckpts/ddpm_multi_zoo``: MSR-3c, CO,
geometry-conditioned NU, MSR-80c and MSR-8c on one net) in the port
against the JAX package: each face's forward on the zoo's own weights, the
eval loop on a slice of each eval split with the same noise, and the
constants ``chip_smoke.py`` holds the card to (``JAX_QUALITY``'s ``zoo_*``
entries and ``EVAL_ZOO_JAX``; their JAX recompute takes minutes on the
CPU, so those two tests are marked slow)."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks.base import objective_metrics as jax_objective_metrics
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import evaluate

from test_torch_eval import _jax_draws, _port_data, _port_noise, jax_eval_constants
from test_torch_multi import _inputs, _port_forwards
from test_torch_tasks import check_vs_jax_constant, chip_smoke, jax_config

torch.set_num_threads(1)

ZOO = pathlib.Path(__file__).resolve().parent.parent / "ckpts" / "ddpm_multi_zoo"
FACES = ["multi_msr", "multi_co", "multi_nu_geo", "multi_msr80", "multi_msr8"]


@pytest.fixture(scope="module")
def zoo_jax():
    return jax_load_checkpoint(str(ZOO))


@pytest.mark.parametrize("face", FACES)
def test_zoo_face_forward_matches_jax(zoo_jax, face):
    """The Solver's config is the JAX package's; the face's adapter on
    plain, fused and mega (their plain versions on the CPU) against flax on
    the zoo's own weights at 256 rows: within 1e-5 of the output's
    magnitude (float32, another summation order through 27 blocks)."""
    solver = Solver.from_checkpoint(str(ZOO), task=face, device="cpu")
    cfg = jax_config(zoo_jax["metadata"], face, {})
    assert cfg == solver.config
    assert (cfg["canvas_dim"], cfg["payload_dim"], cfg["proj_dim"]) == (80, 81, 256)
    D, C = solver.task.data_dim(cfg), solver.task.cond_dim(cfg)
    y, t, c, m = _inputs(256, D, C, seed=len(face))
    ref = np.asarray(JAX_TASKS[face].build_model(cfg).apply({"params": zoo_jax["params"]},
                                                            y, t, c, m))
    for backend, got in _port_forwards(solver.model, y, t, c, m).items():
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max(),
                                   err_msg=backend)


@pytest.mark.parametrize("name", list(chip_smoke.EVAL_ZOO_SPECS))
def test_zoo_evaluate_slice_matches_jax(name):
    """``evaluate`` on the first 256 rows of each zoo eval split against the
    JAX package's sampler and metric block on the port's noise: the ratio
    to 1e-5, the mean difference to 1e-5 of the mean objective, CO's
    decision accuracy and count of terrible rows equal."""
    task, ck, data = _port_data(name)
    spec = chip_smoke.EVAL_ZOO_SPECS[name]
    part = dataclasses.replace(data, X_test=data.X_test[:256], Y_test=data.Y_test[:256])
    got = evaluate(task, ck["params"], ck["sched"], part, omega=spec["omega"], seed=5,
                   backend="plain")
    noise = _port_noise(256, 512, ck["sched"].T + 1, task.data_dim(data.config), seed=5)
    Y = _jax_draws(spec["task"], spec["ckpt"], data.config, part.X_test, noise, spec["omega"])
    jt, cfg = JAX_TASKS[spec["task"]], data.config
    ref = jax_objective_metrics(jt, part, Y)
    Xu = jnp.asarray(jt.unnormalize_x(part.X_test, cfg), jnp.float32)
    Y_true = jt.unnormalize_y(part.Y_test, cfg)
    true = np.asarray(jt.objective(jnp.asarray(Y_true, jnp.float32), Xu, cfg))
    if jt.extra_metrics is not None:
        pred = np.asarray(jt.objective(jnp.asarray(Y, jnp.float32), Xu, cfg))
        ref.update(jt.extra_metrics(Y, Y_true, pred, true, cfg))
    assert got.pop("n_samples") == 256 and got.keys() == ref.keys()
    ratio = "less_ratio" if jt.higher_is_better else "exceeded_ratio"
    assert got[ratio] == pytest.approx(ref[ratio], rel=1e-5)
    # A mean difference: to 1e-5 of the mean objective.
    assert abs(got["avg_diff"] - ref["avg_diff"]) <= 1e-5 * np.abs(true).mean()
    for k in set(got) - {ratio, "avg_diff"}:      # CO's decision accuracy and count
        assert got[k] == ref[k], k


@pytest.mark.slow
@pytest.mark.parametrize("name", ["zoo_msr", "zoo_co", "zoo_nu_geo", "zoo_msr80", "zoo_msr8"])
def test_zoo_vs_jax_constants(name):
    q0, port = check_vs_jax_constant(name)
    if name.startswith("zoo_msr"):
        assert (q0 <= 1 + 1e-5).all() and (port <= 1 + 1e-5).all()


@pytest.mark.slow
@pytest.mark.parametrize("name", list(chip_smoke.EVAL_ZOO_SPECS))
def test_zoo_evaluate_vs_jax_constants(name):
    """EVAL_ZOO_JAX[name] is ``jax_eval_constants(name)``; the port's
    evaluate on the CPU, with its own noise, lands within its tolerance."""
    want = chip_smoke.EVAL_ZOO_JAX[name]
    got_jax = jax_eval_constants(name)
    assert set(want) == set(got_jax)
    for k, (mean, tol) in want.items():
        assert mean == pytest.approx(got_jax[k][0], rel=1e-6, abs=1e-12), k
        assert tol == pytest.approx(got_jax[k][1], rel=1e-3), k
    task, ck, data = _port_data(name)
    got = evaluate(task, ck["params"], ck["sched"], data,
                   omega=chip_smoke.EVAL_ZOO_SPECS[name]["omega"], seed=0, backend="plain")
    assert got["n_samples"] == data.X_test.shape[0]
    for k, (mean, tol) in want.items():
        assert abs(got[k] - mean) <= tol, (k, got[k], mean, tol)

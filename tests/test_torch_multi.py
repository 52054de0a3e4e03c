"""The port's multi-task faces (``diffsg_tpu_torch/tasks/multi.py``) against
the JAX package's: the embeddings, the condition adapter's forward through
every backend on small nets and on the three multi-task checkpoints (weights
carried by ``params_from_jax``), the six faces' crops and decodes,
``merge_multi_config``, ``Solver.from_checkpoint``'s multi branch,
``TASKS``, and the faces' quality constants that ``chip_smoke.py`` holds
the card to."""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffsg_tpu.serve import Solver as JaxSolver
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks import multi as jax_multi
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
from diffsg_tpu_torch import obs
from diffsg_tpu_torch.models import unet_apply_fn
from diffsg_tpu_torch.serve import Solver
from diffsg_tpu_torch.tasks import TASKS, multi
from diffsg_tpu_torch.utils import params_from_jax

from test_torch_tasks import check_vs_jax_constant, jax_config

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CKPTS = REPO / "ckpts"
# (checkpoint, face): one face of each multi-task net.
CKPT_FACES = [("ddpm_multi", "multi_co"), ("ddpm_multi_geo", "multi_nu_geo"),
              ("ddpm_multi_80", "multi_msr80")]
# Every face on the checkpoint that carries its subtask config.
FACE_CKPT = {"multi_msr": "ddpm_multi", "multi_co": "ddpm_multi", "multi_nu": "ddpm_multi",
             "multi_nu_geo": "ddpm_multi_geo", "multi_msr80": "ddpm_multi_80",
             "multi_msr8": "ddpm_multi_80"}


def _inputs(B, D, C, seed):
    """y (B, D), t (B,), cond (B, C), mask (B, 1): half the rows masked."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, D)).astype(np.float32)
    t = np.full((B,), 0.35, np.float32)
    c = rng.uniform(0.1, 1, (B, C)).astype(np.float32)
    m = (np.arange(B) >= B // 2).astype(np.float32)[:, None]
    return y, t, c, m


def _port_forwards(model, y, t, c, m):
    """The adapter's forward on every backend (the CPU takes the kernels'
    plain versions), batch-1 t as the sampler passes it."""
    args = [torch.from_numpy(a) for a in (y, t[:1], c, m)]
    with torch.no_grad():
        return {b: unet_apply_fn(model, b)(*args).numpy() for b in ("plain", "fused", "mega")}


def test_embeddings_match_jax():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (17, 7)).astype(np.float32)
    for slot, slots in (("nu", multi.SLOTS), ("msr8", ("msr", "co", "nu", "msr80", "msr8"))):
        got = multi.embed_cond_np(X, slot, slots, payload_dim=11)
        np.testing.assert_array_equal(got, jax_multi.embed_cond_np(X, slot, slots,
                                                                   payload_dim=11))
        assert got.shape == (17, len(slots) + 11)
    Y = rng.normal(size=(17, 3)).astype(np.float32)
    np.testing.assert_array_equal(multi.embed_y_np(Y), jax_multi.embed_y_np(Y))
    np.testing.assert_array_equal(multi.embed_y_np(Y, 80), jax_multi.embed_y_np(Y, 80))
    assert (multi.D_UNI, multi.PAYLOAD, multi.SLOTS, multi.COND_UNI) == (
        jax_multi.D_UNI, jax_multi.PAYLOAD, jax_multi.SLOTS, jax_multi.COND_UNI)


@pytest.mark.parametrize("slot_idx,payload,n_slots,total", [(0, 3, 3, 9), (1, 9, 3, 9),
                                                            (4, 5, 5, 12)])
def test_adapter_matches_jax_on_small_nets(slot_idx, payload, n_slots, total):
    """A small shared net (proj 16, dims 8-4) with flax's random init: the
    port's adapter on plain, fused and mega equals flax's within 1e-4 of the
    output's magnitude (float32, another summation order)."""
    jinner = jax_multi.unet_multi(16, (8, 4), canvas_dim=5, payload_dim=total, n_slots=n_slots)
    jad = jax_multi._CondAdapter(jinner, slot_idx, payload, n_slots=n_slots,
                                 payload_total=total)
    y, t, c, m = _inputs(48, 5, payload, seed=slot_idx)
    params = jad.init(jax.random.PRNGKey(slot_idx), y, t, c, m)["params"]
    ref = np.asarray(jad.apply({"params": params}, y, t, c, m))
    inner = multi.unet_multi(16, (8, 4), canvas_dim=5, payload_dim=total, n_slots=n_slots)
    model = multi._CondAdapter(inner, slot_idx, payload, n_slots=n_slots, payload_total=total)
    model.inner.load_state_dict(params_from_jax(params), strict=True)
    model.eval()
    for backend, got in _port_forwards(model, y, t, c, m).items():
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=backend)
    padded = model.pad_cond(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(padded, np.asarray(jad._pad_cond(jnp.asarray(c))))
    np.testing.assert_array_equal(padded[:, slot_idx], 1.0)
    assert (padded[:, n_slots + payload:] == 0).all()


@pytest.mark.parametrize("ckpt,face", CKPT_FACES)
def test_checkpoint_faces_match_jax(ckpt, face):
    """Strict loads into the adapter's inner net; the forward on plain,
    fused and mega against flax at 64 rows."""
    solver = Solver.from_checkpoint(str(CKPTS / ckpt), task=face, device="cpu")
    jck = jax_load_checkpoint(str(CKPTS / ckpt))
    cfg = jax_config(jck["metadata"], face, {})
    assert cfg == solver.config
    jmodel = JAX_TASKS[face].build_model(cfg)
    D, C = solver.task.data_dim(cfg), solver.task.cond_dim(cfg)
    assert (D, C) == (JAX_TASKS[face].data_dim(cfg), JAX_TASKS[face].cond_dim(cfg))
    assert solver.model.inner.cond_dim == len(cfg["slots"] if "slots" in cfg else multi.SLOTS) \
        + cfg.get("payload_dim", multi.PAYLOAD)
    y, t, c, m = _inputs(64, D, C, seed=len(face))
    ref = np.asarray(jmodel.apply({"params": jck["params"]}, y, t, c, m))
    for backend, got in _port_forwards(solver.model, y, t, c, m).items():
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=backend)


def _face_inputs(face, cfg, B, seed):
    """Loader-normalized conditions and a raw canvas for ``face``."""
    rng = np.random.default_rng(seed)
    task = TASKS[face]
    C, D = task.cond_dim(cfg), task.data_dim(cfg)
    X = rng.uniform(0.1, 1, (B, C)).astype(np.float32)
    if face in ("multi_nu", "multi_nu_geo"):
        X[:, 6] = rng.uniform(0.5, 2.0, B)
    if face == "multi_nu_geo":
        X[:, 7:] = rng.choice([0.5, 1.0, 1.5], (B, 2))
    if face in ("multi_msr80", "multi_msr8"):
        X[:, -1] = cfg["W"] / cfg["w_ref"]
    return X, rng.normal(0, 2, (B, D)).astype(np.float32)


@pytest.mark.parametrize("face", sorted(FACE_CKPT))
def test_face_crops_and_decodes_match_jax(face):
    """The canvas is cropped to the specialist's columns (a copy: the
    crop of a wider canvas is a strided view) and decoded as the
    specialist decodes; against the JAX package's face."""
    md = jax_load_checkpoint(str(CKPTS / FACE_CKPT[face]))["metadata"]
    cfg = jax_config(md, face, {})
    task, jt = TASKS[face], JAX_TASKS[face]
    X, Y = _face_inputs(face, cfg, 48, seed=len(face))
    Xu = np.asarray(task.unnormalize_x(X, cfg), np.float32)
    np.testing.assert_array_equal(Xu, np.asarray(jt.unnormalize_x(X, cfg), np.float32))
    tY, tX = torch.from_numpy(Y), torch.from_numpy(Xu)
    if task.decode_with_x is not None:
        got = task.decode_with_x(tY, tX, cfg).numpy()
        ref = np.array(jt.decode_with_x(jnp.asarray(Y), jnp.asarray(Xu), cfg))
    else:
        got = task.decode(tY, cfg).numpy()
        ref = np.array(jt.decode(jnp.asarray(Y), cfg))
    assert got.shape == ref.shape and ref.shape[1] <= Y.shape[1]
    # Decodes of the same f32 values (softmaxes, projections, sorts): to
    # 1e-5 of the solution's magnitude.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1.0))
    obj = task.objective(torch.from_numpy(ref), tX, cfg).numpy()
    np.testing.assert_allclose(obj, np.asarray(jt.objective(jnp.asarray(ref), jnp.asarray(Xu),
                                                            cfg)), rtol=1e-5)


def test_multi_nu_geo_takes_a_validity_mask():
    """The port's face passes the mask on and its per-row decode ignores
    it; the JAX package's specialist decode takes none, so its bucketed
    Solver raises for this face."""
    md = jax_load_checkpoint(str(CKPTS / "ddpm_multi_geo"))["metadata"]
    cfg = jax_config(md, "multi_nu_geo", {})
    task = TASKS["multi_nu_geo"]
    X, Y = _face_inputs("multi_nu_geo", cfg, 32, seed=9)
    Xu = torch.from_numpy(np.asarray(task.unnormalize_x(X, cfg), np.float32))
    masked = task.decode_with_x(torch.from_numpy(Y), Xu, cfg,
                                valid_mask=(torch.arange(32) < 20).float()[:, None])
    torch.testing.assert_close(masked, task.decode_with_x(torch.from_numpy(Y), Xu, cfg),
                               rtol=0, atol=0)
    with pytest.raises(TypeError):
        JAX_TASKS["multi_nu_geo"].decode_with_x(jnp.asarray(Y), jnp.asarray(Xu.numpy()), cfg,
                                                valid_mask=jnp.ones((32, 1)))


def test_face_crop_is_contiguous_before_the_decode():
    """MSR-8c's 8 columns of an 80-wide canvas reach the specialist decode
    as a contiguous copy."""
    seen = []
    sub = multi.MSR_BUDGET

    def spy(Y_raw, X_unnorm, cfg, valid_mask=None):
        seen.append(Y_raw.is_contiguous())
        return sub.decode_with_x(Y_raw, X_unnorm, cfg, valid_mask)

    import dataclasses

    face = multi._wrap(dataclasses.replace(sub, decode_with_x=spy), "msr8")
    cfg = {"M": 8, "W": 10.0, "w_ref": 10.0, "canvas_dim": 80, "scaler_min": 0.5,
           "scaler_max": 2.5}
    Y = torch.randn(16, 80)
    Xu = torch.cat([torch.rand(16, 8) + 0.5, torch.full((16, 1), 10.0)], dim=1)
    face.decode_with_x(Y, Xu, cfg)
    assert seen == [True] and not Y[:, :8].is_contiguous()


@pytest.mark.parametrize("ckpt", ["ddpm_multi", "ddpm_multi_geo", "ddpm_multi_80"])
def test_merge_multi_config_matches_jax(ckpt):
    md = jax_load_checkpoint(str(CKPTS / ckpt))["metadata"]
    for slot in md["subtask_configs"]:
        base = {"K": 3, "y_scale": 99.0, "dims": [1], "W": 7.0}
        got = multi.merge_multi_config(dict(base), md, slot)
        assert got == jax_multi.merge_multi_config(dict(base), md, slot)
        assert got["dims"] == md["arch"]["dims"] and got["W"] == 7.0
        assert got["parameterization"] == "x0"
    assert multi.merge_multi_config({"a": 1}, None, "msr") == {"a": 1}
    assert (multi._ARCH_KEYS, multi._LABEL_KEYS) == (jax_multi._ARCH_KEYS, jax_multi._LABEL_KEYS)


@pytest.mark.parametrize("face", sorted(FACE_CKPT))
def test_from_checkpoint_multi_branch_matches_jax(face):
    """The face's config is the JAX Solver's: the subtask config (``nu_geo``
    for ``multi_nu_geo``), the shared architecture, then the caller's."""
    path = str(CKPTS / FACE_CKPT[face])
    extra = {"W": 20.0} if face == "multi_msr80" else {}
    solver = Solver.from_checkpoint(path, task=face, device="cpu", dataset_config=extra)
    jsolver = JaxSolver.from_checkpoint(path, task=face, dataset_config=extra)
    assert solver.config == jsolver.config
    assert solver.config["parameterization"] == "x0" and solver.sched.T == 20
    assert solver.task.data_dim(solver.config) == solver.config.get("canvas_dim", multi.D_UNI)


def test_tasks_keys_equal_jax():
    assert set(TASKS) == set(JAX_TASKS) and len(TASKS) == 18
    for name in multi.MULTI_TASKS:
        task, jt = TASKS[name], JAX_TASKS[name]
        assert task.name == jt.name == name
        assert task.higher_is_better == jt.higher_is_better
        assert task.default_omega == jt.default_omega
        assert (task.decode_with_x is None) == (jt.decode_with_x is None)
        assert (task.project is None) == (jt.project is None)
        assert task.load.__name__ == jt.load.__name__


@pytest.mark.parametrize("backend", ["fused", "mega"])
def test_multi_solve_counts_no_launch_on_the_cpu(backend):
    """On the CPU the kernels' plain versions run and count nothing; a
    multi face solves on every backend with the same answer."""
    solver = Solver.from_checkpoint(str(CKPTS / "ddpm_multi"), task="multi_msr", device="cpu",
                                    backend=backend)
    plain = Solver(solver.task, solver.model, solver.sched, solver.config, backend="plain")
    X = np.random.default_rng(3).uniform(0, 1, (40, 3)).astype(np.float32)
    before = obs.counters()
    got = solver.solve(X, omega=0.5, seed=2)
    after = obs.counters()
    assert all(after[k] == before[k] for k in ("resblock_launches", "mega_launches"))
    np.testing.assert_allclose(got, plain.solve(X, omega=0.5, seed=2), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.sum(1), solver.config["W"], rtol=1e-5)


@pytest.mark.parametrize("name", ["multi_msr", "multi_co", "multi_nu", "multi_nu_geo",
                                  "multi_msr80", "multi_msr8"])
def test_multi_vs_jax_constants(name):
    q0, port = check_vs_jax_constant(name)
    if name.startswith("multi_msr"):
        assert (q0 <= 1 + 1e-5).all() and (port <= 1 + 1e-5).all()

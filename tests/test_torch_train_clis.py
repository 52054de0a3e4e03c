"""The port's five task-specific training CLIs (``diffsg_tpu_torch/tools/
train_msr_budget.py``, ``train_nu_budget.py``, ``train_nu_geo.py``,
``train_nu_augmented.py``, ``train_multi.py``) against the JAX package's
``tools/`` CLIs, on the same arguments and small CSVs made here.

Each case runs the port's CLI for one epoch on the CPU at narrow widths
(training, checkpoint, evaluation), then the JAX CLI with its
``train_ddpm`` replaced by a recorder that returns the port's trained
params, and its ``save_checkpoint`` made to stop the run once the
checkpoint is written. Held:

* the float32 ``X`` and ``Y``, the ``TrainConfig`` and the net's parameter
  shapes that each CLI hands to ``train_ddpm`` are equal (the float64 rows
  within 1e-12: the JAX CLIs read CSVs with pandas, whose parser is one or
  two units off in the last place on some values; the port with
  ``np.loadtxt``);
* the metadata the two write are equal but for the port's
  ``train_seconds`` (the floats derived from a parsed CSV within 1e-12);
* the port's checkpoint loads in the JAX package's ``load_checkpoint``
  and gives the port's forward within 1e-5 of its magnitude.
"""

import dataclasses
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diffsg_tpu.train as jax_train
import diffsg_tpu.utils as jax_utils
from diffsg_tpu.tasks import TASKS as JAX_TASKS
from diffsg_tpu.tasks import multi as jax_multi
from diffsg_tpu.utils import load_checkpoint as jax_load_checkpoint
import diffsg_tpu_torch.train as port_train
from diffsg_tpu_torch.tasks import TASKS, multi
from diffsg_tpu_torch.tools import (make_datasets, train_msr_budget, train_multi,
                                    train_nu_augmented, train_nu_budget, train_nu_geo)
from diffsg_tpu_torch.utils import load_checkpoint, params_from_jax, params_to_jax

import tools.make_datasets as jax_make_datasets
import tools.train_msr_budget as jax_train_msr_budget
import tools.train_multi as jax_train_multi
import tools.train_nu_augmented as jax_train_nu_augmented
import tools.train_nu_budget as jax_train_nu_budget
import tools.train_nu_geo as jax_train_nu_geo

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
# The small inputs (the port's make_datasets writes the JAX package's bytes:
# tests/test_torch_generators.py).
INPUTS = {
    "3c_10w_400samples.csv": ["msr", "--samples", "400"],
    "3c_20w_200samples_ood.csv": ["msr", "--samples", "200", "--power", "20", "--seed", "1"],
    "8c_10w_wf_300samples.csv": ["msr", "--samples", "300", "--channels", "8", "--labels",
                                 "wf"],
    "8c_20w_wf_200samples_ood.csv": ["msr", "--samples", "200", "--channels", "8", "--power",
                                     "20", "--seed", "1", "--labels", "wf"],
    "80c_20w_wf_200samples.csv": ["msr", "--samples", "200", "--channels", "80", "--power",
                                  "20", "--labels", "wf"],
    "80c_40w_wf_200samples_ood.csv": ["msr", "--samples", "200", "--channels", "80",
                                      "--power", "40", "--seed", "1", "--labels", "wf"],
    "3nodes_400samples.csv": ["co", "--samples", "400"],
    "3nodes_200samples_ood.csv": ["co", "--samples", "200", "--seed", "1"],
    "3u_18mW_200samples.csv": ["nu", "--samples", "200", "--grid-step", "8"],
    "3u_30mW_100samples_ood.csv": ["nu", "--samples", "100", "--power", "30", "--seed", "1",
                                   "--grid-step", "8"],
    "3u_budget_200samples.csv": ["nu-budget", "--samples", "200", "--budget-step", "3",
                                 "--grid-step", "8"],
    "3u_geo_200samples.csv": ["nu-geo", "--samples", "200", "--geom-step", "200",
                              "--grid-step", "8"],
    "3u_geo_focus_100samples.csv": ["nu-geo", "--samples", "100", "--geom-step", "200",
                                    "--focus-frac", "0.5", "--focus-geom-min", "280",
                                    "--focus-geom-max", "520", "--focus-geom-step", "120",
                                    "--grid-step", "8", "--seed", "1"],
    "3u_geo480x360_21mW_60samples.csv": ["nu", "--samples", "60", "--power", "21", "--width",
                                         "480", "--height", "360", "--seed", "7",
                                         "--grid-step", "8"],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("inputs")
    for name, argv in INPUTS.items():
        make_datasets.main(argv + ["--out", str(root / name)])
    return lambda name: str(root / name)


def _cases(d):
    """(port module, JAX module, task for the forward check, arguments[,
    the port's own arguments]) per case; ``d(name)`` is an input's path."""
    msr3 = ["--indist", d("3c_10w_400samples.csv"), "--ood", d("3c_20w_200samples_ood.csv")]
    msr8 = ["--indist", d("8c_10w_wf_300samples.csv"), "--ood",
            d("8c_20w_wf_200samples_ood.csv")]
    nu = ["--indist", d("3u_18mW_200samples.csv"), "--ood", d("3u_30mW_100samples_ood.csv")]
    geo = ["--geo-dataset", d("3u_geo_200samples.csv"), d("3u_geo_focus_100samples.csv")]
    multi_in = ["--msr-dataset", d("3c_10w_400samples.csv"), "--co-dataset",
                d("3nodes_400samples.csv"), "--nu-dataset", d("3u_18mW_200samples.csv"),
                "--nu-budget-dataset", d("3u_budget_200samples.csv"),
                "--msr-repeat", "1", "--co-repeat", "1", "--nu-times", "1", "--epochs", "1",
                "--proj-dim", "16", "--dims", "16", "8"]
    # The eval sets, flags of the port's train_multi only (the JAX CLI names
    # them in its code, after the checkpoint).
    multi_evals = ["--msr-ood", d("3c_20w_200samples_ood.csv"),
                   "--co-ood", d("3nodes_200samples_ood.csv"),
                   "--nu-ood", d("3u_30mW_100samples_ood.csv")]
    zoo_evals = ["--msr80-evals", d("80c_20w_wf_200samples.csv"),
                 d("80c_40w_wf_200samples_ood.csv"),
                 "--msr8-evals", d("8c_10w_wf_300samples.csv"),
                 d("8c_20w_wf_200samples_ood.csv"),
                 "--nu-geo-evals", d("3u_geo480x360_21mW_60samples.csv")]
    return {
        "msr_budget": (train_msr_budget, jax_train_msr_budget, "msr_budget",
                       ["--samples", "600", "--epochs", "1", "--proj-dim", "16", "--dims", "16",
                        "8", "--omegas", "1.0", *msr3]),
        "msr_budget_8c": (train_msr_budget, jax_train_msr_budget, "msr_budget",
                          ["--samples", "700", "--channels", "8", "--w-max", "45", "--w-step",
                           "2.5", "--exclude-budgets", "10", "20", "--y-scale", "8", "--lr",
                           "1e-3", "--milestones", "1", "2", "--epochs", "1", "--proj-dim",
                           "16", "--dims", "16", "8", "--omegas", "0.5", *msr8]),
        "nu_budget": (train_nu_budget, jax_train_nu_budget, "nu_budget",
                      ["--budget-dataset", d("3u_budget_200samples.csv"), "--times", "1",
                       "--epochs", "1", "--omegas", "0.125", *nu]),
        "nu_budget_noid": (train_nu_budget, jax_train_nu_budget, "nu_budget",
                           ["--budget-dataset", d("3u_budget_200samples.csv"), "--times", "2",
                            "--epochs", "1", "--no-indist", "--no-center",
                            "--parameterization", "x0", "--omegas", "0.5", *nu]),
        "nu_geo": (train_nu_geo, jax_train_nu_geo, "nu_geo",
                   [*geo, "--budget-dataset", d("3u_budget_200samples.csv"),
                    "--with-ref-indist", "--ref-repeat", "2", "--budget-repeat", "2",
                    "--times", "1", "--epochs", "1", "--proj-dim", "16", "--dims", "16", "8",
                    "--parameterization", "x0", "--warmup-epoch", "0", "--lr", "1e-3",
                    "--omegas", "0.5", *nu]),
        "nu_geo_init_from": (train_nu_geo, jax_train_nu_geo, "nu_geo",
                             [*geo, "--init-from", str(REPO / "ckpts" / "ddpm_nu_geo_x0f"),
                              "--times", "1", "--epochs", "1", "--lr", "1e-4", "--omegas",
                              "0.5", *nu]),
        "nu_augmented": (train_nu_augmented, jax_train_nu_augmented, "nu",
                         ["--dataset", d("3u_18mW_200samples.csv"), "--ood",
                          d("3u_30mW_100samples_ood.csv"), "--times", "1", "--epochs", "1",
                          "--omegas", "500"]),
        "nu_augmented_scaled": (train_nu_augmented, jax_train_nu_augmented, "nu_direct",
                                ["--dataset", d("3u_18mW_200samples.csv"), "--ood",
                                 d("3u_30mW_100samples_ood.csv"), "--times", "2", "--epochs",
                                 "1", "--y-scale", "8", "--center", "--grad-clip", "1.0",
                                 "--omegas", "0.125"]),
        "multi_budget": (train_multi, jax_train_multi, None, multi_in, multi_evals),
        "multi_zoo": (train_multi, jax_train_multi, None,
                      [*multi_in, "--nu-mode", "geo", "--with-msr80", "--with-msr8",
                       "--lr", "5e-4", "--milestones", "90", "160", "--grad-clip", "0.25",
                       "--parameterization", "x0", "--nu-geo-datasets",
                       d("3u_geo_200samples.csv"), d("3u_geo_focus_100samples.csv"),
                       "--nu-ref-repeat", "2", "--nu-budget-repeat", "2",
                       "--msr80-samples", "300", "--msr8-samples", "200"],
                      multi_evals + zoo_evals),
    }


CASES = ["msr_budget", "msr_budget_8c", "nu_budget", "nu_budget_noid", "nu_geo",
         "nu_geo_init_from", "nu_augmented", "nu_augmented_scaled", "multi_budget", "multi_zoo"]


class _Stop(Exception):
    """Ends the JAX CLI once its checkpoint is written."""


def run_port(monkeypatch, module, argv):
    """The port's CLI on the CPU; returns what it handed ``train_ddpm``."""
    seen = {}
    real = port_train.train_ddpm

    def recorder(model, X, Y, cfg, **kw):
        seen.update(model=model, X=np.asarray(X), Y=np.asarray(Y), cfg=cfg,
                    init=kw.get("init_params"))
        return real(model, X, Y, cfg, **kw)

    monkeypatch.setattr(port_train, "train_ddpm", recorder)
    module.main(argv + ["--cpu"])
    return seen


def run_jax(monkeypatch, module, argv, port_out):
    """The JAX package's CLI up to its checkpoint, ``train_ddpm`` recorded
    and returning the port's trained params and schedule."""
    seen = {}
    ck = jax_load_checkpoint(port_out)

    def recorder(model, X, Y, cfg, init_params=None, **kw):
        seen.update(model=model, X=np.asarray(X), Y=np.asarray(Y), cfg=cfg, init=init_params)
        return ck["params"], None, ck["sched"]

    real_save = jax_utils.save_checkpoint

    def save_and_stop(*args, **kw):
        real_save(*args, **kw)
        raise _Stop

    monkeypatch.setattr(jax_train, "train_ddpm", recorder)
    monkeypatch.setattr(jax_utils, "save_checkpoint", save_and_stop)
    monkeypatch.setattr(jax_make_datasets, "ensure_datasets", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(_Stop):
            module.main()
    finally:     # the JAX CLIs point JAX's compilation cache at a directory of their own
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return seen


def assert_close_tree(a, b, where="", rtol=1e-12):
    """JSON trees equal; floats within ``rtol`` (values derived from a
    parsed CSV)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            assert_close_tree(a[k], b[k], f"{where}/{k}", rtol)
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_close_tree(x, y, f"{where}[{i}]", rtol)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=rtol, abs_tol=1e-15), (where, a, b)
    else:
        assert a == b, (where, a, b)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _jax_param_shapes(model, D, C):
    tree = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((2, D)),
                                             jnp.zeros((2,)), jnp.zeros((2, C)),
                                             jnp.ones((2, 1)))["params"])
    return {k: tuple(v.shape) for k, v in _leaves(tree)}


def _models(ck_dir, task_name):
    """The JAX and the port's net of a checkpoint the port wrote."""
    md = json.loads((pathlib.Path(ck_dir) / "metadata.json").read_text())
    if task_name is None:
        a = md["arch"]
        kw = dict(canvas_dim=a["canvas_dim"], payload_dim=a["payload_dim"],
                  n_slots=len(a["slots"]))
        return (jax_multi.unet_multi(a["proj_dim"], tuple(a["dims"]), **kw),
                multi.unet_multi(a["proj_dim"], tuple(a["dims"]), **kw))
    cfg = dict(md["dataset_config"])
    return JAX_TASKS[task_name].build_model(cfg), TASKS[task_name].build_model(cfg)


@pytest.mark.parametrize("case", CASES)
def test_cli_matches_jax(monkeypatch, tmp_path, capsys, inputs, case):
    port_module, jax_module, task_name, argv, *port_only = _cases(inputs)[case]
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    port = run_port(monkeypatch, port_module, argv + sum(port_only, []) + ["--out", port_out])
    evals = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith('{"split"')]
    assert evals and all(np.isfinite(e[k]) for e in evals for k in e
                         if isinstance(e[k], float)), evals
    jx = run_jax(monkeypatch, jax_module, argv + ["--out", jax_out], port_out)

    # What each hands train_ddpm.
    for k in ("X", "Y"):
        assert port[k].shape == jx[k].shape, k
        np.testing.assert_array_equal(port[k].astype(np.float32), jx[k].astype(np.float32),
                                      err_msg=k)
        np.testing.assert_allclose(port[k], jx[k], rtol=1e-12, atol=1e-12, err_msg=k)
    assert dataclasses.asdict(port["cfg"]) == dataclasses.asdict(jx["cfg"])
    got = {k: v.shape for k, v in _leaves(params_to_jax(port["model"]))}
    assert got == _jax_param_shapes(jx["model"], port["model"].input_dim,
                                    port["model"].cond_dim)
    assert (port["init"] is None) == (jx["init"] is None)
    if port["init"] is not None:
        for (k, a), (k2, b) in zip(_leaves(port["init"]), _leaves(jx["init"])):
            assert k == k2
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # The metadata.
    meta = json.loads((tmp_path / "port" / "metadata.json").read_text())
    assert meta.pop("train_seconds") > 0
    assert_close_tree(meta, json.loads((tmp_path / "jax" / "metadata.json").read_text()))
    log = [json.loads(line) for line in (tmp_path / "port" / "train_log.jsonl").open()]
    assert [r["event"] for r in log] == ["start", "train", "saved"]

    # The port's checkpoint in the JAX package: the same forward.
    jck = jax_load_checkpoint(port_out)
    ck = load_checkpoint(port_out, device="cpu")
    np.testing.assert_array_equal(np.asarray(jck["sched"].betas),
                                  ck["sched"].betas.double().numpy())
    jmodel, model = _models(port_out, task_name)
    model.load_state_dict(params_from_jax(ck["params"]), strict=True)
    rng = np.random.default_rng(len(case))
    B, D, C = 96, model.input_dim, model.cond_dim
    y = rng.normal(size=(B, D)).astype(np.float32)
    t = np.full((B,), 0.4, np.float32)
    c = rng.uniform(0, 1, (B, C)).astype(np.float32)
    m = (np.arange(B) >= B // 2).astype(np.float32)[:, None]
    ref = np.asarray(jmodel.apply({"params": jck["params"]}, y, t, c, m))
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (y, t, c, m))).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_init_from_inherits_the_donor(monkeypatch, tmp_path, inputs):
    """``--init-from`` keeps the donor's proj_dim, dims, y_shift, y_scale
    and parameterization (x0) when no parameterization is given; an explicit
    one overrides it."""
    donor = REPO / "ckpts" / "ddpm_nu_geo_x0f"
    d_cfg = json.loads((donor / "metadata.json").read_text())["dataset_config"]
    argv = _cases(inputs)["nu_geo_init_from"][3]
    seen = run_port(monkeypatch, train_nu_geo, argv + ["--out", str(tmp_path / "a")])
    cfg = json.loads((tmp_path / "a" / "metadata.json").read_text())["dataset_config"]
    assert seen["cfg"].parameterization == "x0" == cfg["parameterization"]
    for k in ("y_shift", "y_scale", "proj_dim", "dims"):
        assert cfg[k] == d_cfg[k], k
    assert seen["init"] is not None
    seen = run_port(monkeypatch, train_nu_geo, argv + ["--parameterization", "eps", "--out",
                                                       str(tmp_path / "b")])
    assert seen["cfg"].parameterization == "eps"


def test_geo_load_kw_reads_the_file_name():
    assert train_multi.geo_load_kw("d/3u_geo480x360_21mW_1000samples.csv") == {
        "width": 480.0, "height": 360.0, "P_sum": 21.0}
    with pytest.raises(ValueError):
        train_multi.geo_load_kw("3u_18mW_10000samples.csv")


def test_clis_run_on_the_card_by_default(inputs, tmp_path):
    """Without ``--cpu`` a CLI asks for the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card tests run the CLIs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_nu_augmented.main(["--dataset", inputs("3u_18mW_200samples.csv"), "--out",
                                 str(tmp_path / "x")])

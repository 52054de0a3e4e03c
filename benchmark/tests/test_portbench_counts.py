"""The benchmark's operation and byte counts, from the configuration files'
widths, against hand counts and the checkpoints' own parameter shapes."""

import json
import pathlib

import numpy as np
import pytest

from benchmark.metrics import counts
from benchmark.reference.unet import load_arrays, topology

ROOT = pathlib.Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, per_row, batch1", [("msr3c_t100", 550_456, 970_752),
                                                   ("nu3u_ddim3", 63_600, 78_848)])
def test_macs_from_widths(name, per_row, batch1):
    m = config(name)["model"]
    assert counts.per_row_macs(m) == per_row
    assert counts.batch1_macs(m) == batch1
    assert counts.param_count(m) == m["parameters"]


def test_msr_flops_per_solution():
    c = config("msr3c_t100")
    per_solution = counts.request_flops(c["model"], c["sampler"], 8192) / 8192
    assert round(per_solution / 1e9, 4) == 0.2202
    nu = config("nu3u_ddim3")
    assert round(counts.request_flops(nu["model"], nu["sampler"], 524288) / 524288 / 1e6, 3) == 0.763


@pytest.mark.parametrize("name", ["msr3c_t100", "nu3u_ddim3"])
def test_layers_match_checkpoint(name):
    """The topology walk gives the checkpoint's Dense and block shapes in
    forward order, and its parameter count."""
    c = config(name)
    params, _ = load_arrays(str(ROOT / c["checkpoint"]))
    down, up = topology(c["model"]["dims"], c["model"]["n_blocks"])
    names = (["feature_proj"]
             + [f"down_{i}/res" if k == "block" else f"down_{i}/lin" for i, k in enumerate(down)]
             + ["middle/res1", "middle/res2"]
             + [f"up_{i}/res" if k == "block" else f"up_{i}/lin" for i, k in enumerate(up)]
             + ["final"])
    layers = counts.layers(c["model"])
    assert len(layers) == len(names)
    for layer, name_ in zip(layers, names):
        key = f"{name_}/lin1/kernel" if layer.kind == "block" else f"{name_}/kernel"
        assert params[key].shape == (layer.din, layer.dout), name_
        assert (f"{name_}/shortcut/kernel" in params) == layer.shortcut, name_
    assert sum(a.size for a in params.values()) == counts.param_count(c["model"])


def test_bounds():
    msr, nu = config("msr3c_t100")["model"], config("nu3u_ddim3")["model"]
    # The 27 blocks' sums at 16,384 folded rows: operations bound it.
    work = [counts.resblock_work(l, 16384) for l in counts.layers(msr) if l.kind == "block"]
    assert len(work) == 27
    assert sum(w[0] for w in work) / counts.PEAK_F32_FLOPS > sum(w[1] for w in work) / counts.PEAK_HBM_BYTES
    assert counts.forward_resblock_bound_s(msr, 16384) == pytest.approx(2.5635e-4, rel=1e-4)
    # The whole-net forward of NU at 1,048,576 rows: 1.991 ms, operations.
    assert counts.forward_mega_bound_s(nu, 1 << 20) == pytest.approx(1.9907e-3, rel=1e-4)
    assert counts.forward_mega_bound_s(msr, 16384) == pytest.approx(2.6923e-4, rel=1e-4)


def test_block_macs_by_hand():
    b = counts.Layer("block", 256, 128, True)
    assert counts.block_macs(b, 3) == 256 * 128 + 2 * 128 * 128 + 3 * 128 + 256 * 128
    flops, nbytes = counts.resblock_work(b, 10)
    assert flops == 2 * 10 * (256 * 128 * 2 + 2 * 128 * 128)
    assert nbytes == 4 * (10 * 256 + 128 + 2 * 10 * 128 + 256 * 128 * 2 + 2 * 128 * 128
                          + 2 * 256 + 8 * 128)
    assert np.isclose(counts.time_dim({"proj_dim": 32}), 128)


SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_every_metric_has_a_reader(name):
    from benchmark import run
    assert callable(run.load_reader(name))


def test_roofline_pct_from_a_summary():
    """A roofline share reads the bound of every traced forward over the
    time of the operations named for the kernel, and nothing without them."""
    from types import SimpleNamespace
    from benchmark.harness.trace import TraceSummary
    cfg = config("msr3c_t100")
    bound = counts.forward_resblock_bound_s(cfg["model"], 2 * 8192)
    ops = {"resblock_wide<64,128>": (10, 100 * bound), "resblock_narrow<8>": (5, 100 * bound),
           "sgemm": (3, 1.0)}
    run = SimpleNamespace(config=cfg, traffic={"rows": 8192},
                          profile=TraceSummary(1.0, 0.5, ops, 18, {}, 3))
    assert counts.roofline_pct(run, "resblock_", counts.forward_resblock_bound_s) == \
        pytest.approx(100.0 * 3 * 100 / 200)
    assert counts.roofline_pct(run, "mega_kernel", counts.forward_mega_bound_s) is None

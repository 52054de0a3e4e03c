"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import json

import numpy as np
import pytest
import torch

from diffsg_tpu_torch import obs
from diffsg_tpu_torch.models import UNet1D, unet_co, unet_forward_fused, unet_msr, unet_nu
from diffsg_tpu_torch.ops import mega, resblock
from diffsg_tpu_torch.ops.mega import (launch_mega, mega_inputs as mega_kernel_inputs,
                                       pack_params, unet_forward_mega,
                                       unet_forward_mega_reference)
from diffsg_tpu_torch.ops.resblock import fused_residual_block, resblock_reference

# (rows, in_dim, out_dim, t_proj rows): the cases of tests/test_pallas.py
# (128 -> 128 at 64 rows, 256 -> 128 with shortcut at 32 rows), the narrow
# widths 8 and 16 (narrower than a warp), the (1, out) t_proj broadcast of
# the sampler, and row counts that are no multiple of any tile (37, 45).
CASES = [
    (64, 128, 128, "full"),
    (32, 256, 128, "full"),
    (37, 8, 8, "row"),
    (37, 16, 16, "row"),
    (45, 16, 8, "row"),
    (45, 32, 16, "full"),
    (37, 128, 64, "row"),
]


def block_inputs(rows, din, dout, t_kind, seed):
    """NumPy-seeded block arguments in ``fused_residual_block`` order."""
    rng = np.random.default_rng(seed)

    def n(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    t_rows = 1 if t_kind == "row" else rows
    args = [n(rows, din), n(t_rows, dout), n(rows, dout)]
    for k_in in (din, dout, dout):
        args += [1.0 + n(k_in, scale=0.1), n(k_in, scale=0.1),
                 n(k_in, dout, scale=k_in ** -0.5), n(dout, scale=0.1)]
    sc = [n(din, dout, scale=din ** -0.5), n(dout, scale=0.1)] if din != dout else [None, None]
    return args + sc


def to_torch(args, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device) for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,din,dout,t_kind", CASES + [(16384, 256, 128, "row"),
                                                          (1000, 256, 128, "full")])
def test_cuda_kernel_matches_reference(rows, din, dout, t_kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = to_torch(block_inputs(rows, din, dout, t_kind, seed=rows + din), device="cuda")
    before = obs.counters()["resblock_launches"]
    out = fused_residual_block(*args)
    torch.cuda.synchronize()
    assert obs.counters()["resblock_launches"] == before + 1
    # f32, TF32 off, differing only in summation order over <= 256 terms.
    torch.testing.assert_close(out, resblock_reference(*args), rtol=0, atol=1e-4)


# (rows, in, out, t_proj rows, tile rows): each path at each tile height it
# is built for (wide: out classes 32, 64, 128 at 32 and 64 rows, 256 at 32;
# narrow: 32, 64 and 128 rows at widths 32, 16 and 8), ragged row counts (1, 37, 1,000) and multi-tile grids, the
# proj-256 net's widest block (512 -> 256 with a shortcut, 512-term sums),
# the widths on either side of the narrow/wide boundary (32 -> 32, 64 -> 32,
# 32 -> 64, and the first ones past it: 36 -> 36, 40 -> 32, 48 -> 48,
# 48 -> 32, 60 -> 60), output widths that are no width class (48, 96, 160),
# and both kinds of t_proj.
TILE_CASES = [
    (1000, 64, 32, "row", 32), (1000, 64, 32, "full", 64),
    (37, 128, 64, "row", 32), (4096, 128, 64, "full", 64),
    (1000, 128, 128, "row", 32), (16384, 256, 128, "row", 64),
    (1000, 256, 128, "full", 64), (1, 256, 128, "row", 64),
    (16384, 512, 256, "row", 32), (1000, 512, 256, "full", 32), (1, 512, 256, "full", 32),
    (4096, 256, 256, "row", 32), (37, 256, 256, "full", 32),
    (1000, 32, 32, "row", 32), (37, 32, 64, "full", 64), (1000, 64, 64, "row", 64),
    (1000, 96, 48, "full", 64), (37, 160, 160, "row", 32),
    (1000, 32, 16, "full", 32), (1, 8, 8, "row", 128), (1000, 16, 16, "row", 64),
    (37, 16, 8, "full", 64), (16384, 8, 8, "row", 128), (37, 24, 12, "row", 32),
    (1000, 48, 48, "row", 32), (37, 48, 32, "full", 64), (37, 40, 32, "row", 32),
    (1000, 36, 36, "full", 64), (1000, 60, 60, "row", 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,din,dout,t_kind,tile_rows", TILE_CASES)
def test_cuda_kernel_every_tile_height(rows, din, dout, t_kind, tile_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = to_torch(block_inputs(rows, din, dout, t_kind, seed=rows + din + dout),
                    device="cuda")
    out = fused_residual_block(*args, tile_rows=tile_rows)
    torch.cuda.synchronize()
    info = resblock.last_launch()
    assert info["variant"] == resblock.resblock_variant(din, dout)
    assert info["tile_rows"] == tile_rows
    assert info["smem_bytes"] == resblock.resblock_smem_bytes(din, dout, din != dout, tile_rows)
    assert info["grid"] == resblock.resblock_grid(din, dout, din != dout, rows, tile_rows,
                                                  resblock._sm_count(0))
    # f32, TF32 off, differing only in summation order over <= 512 terms.
    torch.testing.assert_close(out, resblock_reference(*args), rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    args = to_torch(block_inputs(37, 16, 8, "row", seed=1), device="cuda")
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()        # c_proj not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fused_residual_block(*bad)
    bad = list(args)
    bad[-2:] = [None, None]                        # 16 -> 8 without its shortcut
    with pytest.raises(ValueError, match="shortcut"):
        fused_residual_block(*bad)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError, match="float32"):
        fused_residual_block(*bad)
    with pytest.raises(ValueError, match="tile_rows"):
        fused_residual_block(*args, tile_rows=32)      # 16 -> 8 runs at 64 rows
    bad = list(args)
    bad[2] = torch.empty(37 * 8 + 1, device="cuda")[1:].view(37, 8)   # c_proj off 16 bytes
    bad[2].copy_(args[2])
    with pytest.raises(ValueError, match="aligned"):
        fused_residual_block(*bad)


# (net, rows, compute dtype, tile rows): the three nets at both types,
# ragged row counts (37, 1,000) and multi-tile grids at every tile height
# (float32 16 and 32 rows, SIMT; bf16 32, 64 and 128 rows, tensor cores).
# "p256" has the shapes of ckpts/ddpm_msr_80c_budget (proj 256, a 512-wide
# concat, a skip stack of 2,208 values per row).
# "odd" has widths that are no multiple of 16 (20, 12, 8; concats of 40 and
# 24), so its tensor-core products read pad columns the kernel must zero.
MEGA_CASES = [
    ("msr", 37, torch.float32, 0),
    ("msr", 1000, torch.float32, 16),
    ("msr", 1000, torch.bfloat16, 0),
    ("msr", 16384, torch.bfloat16, 64),
    ("nu", 37, torch.bfloat16, 128),
    ("nu", 1000, torch.float32, 0),
    ("nu", 65536, torch.float32, 0),
    ("msr", 16384, torch.bfloat16, 128),
    ("msr", 1000, torch.bfloat16, 64),
    ("nu", 65536, torch.bfloat16, 64),
    ("nu", 1000, torch.bfloat16, 128),
    ("nu", 65536, torch.bfloat16, 32),
    ("p256", 37, torch.float32, 0),
    ("p256", 4096, torch.float32, 0),
    ("p256", 4096, torch.float32, 32),
    ("p256", 37, torch.bfloat16, 0),
    ("p256", 4096, torch.bfloat16, 0),
    ("odd", 1000, torch.bfloat16, 0),
    ("odd", 1000, torch.bfloat16, 128),
    ("odd", 37, torch.float32, 0),
    ("co", 4096, torch.float32, 0),
    ("co", 1000, torch.float32, 32),
    ("co", 4096, torch.bfloat16, 0),
    ("co", 1000, torch.bfloat16, 128),
    ("nu_geo", 4096, torch.float32, 16),
    ("nu_geo", 4096, torch.bfloat16, 0),
    ("nu_geo", 1000, torch.bfloat16, 32),
    ("msr_budget", 4096, torch.float32, 0),
    ("msr_budget", 1000, torch.bfloat16, 0),
    ("nu_budget", 65536, torch.float32, 0),
    ("nu_budget", 1000, torch.float32, 16),
    ("nu_budget", 1000, torch.bfloat16, 0),
]
NETS = {"msr": lambda: unet_msr(3), "nu": lambda: unet_nu(3),
        "p256": lambda: UNet1D(input_dim=80, proj_dim=256, cond_dim=81,
                               dims=(256, 128, 64, 32), n_blocks=2),
        "odd": lambda: UNet1D(input_dim=3, proj_dim=20, cond_dim=4, dims=(12, 8), n_blocks=2),
        # The shapes of ckpts/ddpm_co (n_blocks=3: 37 blocks, 20 skips),
        # ddpm_nu_geo_x0f, ddpm_msr_budget and ddpm_nu_budget.
        "co": lambda: unet_co(3),
        "nu_geo": lambda: unet_nu(3, cond_extra=3, proj_dim=64, dims=(64, 32, 16)),
        "msr_budget": lambda: unet_msr(3, cond_extra=1),
        "nu_budget": lambda: unet_nu(3, cond_extra=1)}


def mega_inputs(net, rows, seed, device="cpu"):
    """A seeded random net and the sampler's 2B-row inputs on ``device``."""
    torch.manual_seed(seed)
    model = NETS[net]().to(device)
    rng = np.random.default_rng(seed)
    y = torch.tensor(rng.normal(size=(rows, model.input_dim)), dtype=torch.float32)
    c = torch.tensor(rng.uniform(size=(rows, model.cond_dim)), dtype=torch.float32)
    m = (torch.arange(rows) >= rows // 2).float()[:, None]
    t = torch.tensor([0.37])
    return model, [a.to(device) for a in (y, t, c, m)]


@pytest.mark.cuda
@pytest.mark.parametrize("net,rows,dtype,tile_rows", MEGA_CASES)
def test_cuda_mega_matches_reference(net, rows, dtype, tile_rows):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, inputs = mega_inputs(net, rows, seed=rows, device="cuda")
    cd = None if dtype == torch.float32 else dtype
    inputs = inputs if cd is None else [a.to(cd) for a in inputs]
    packed = pack_params(model, dtype)
    before = obs.counters()["mega_launches"]
    with torch.no_grad():
        if tile_rows:
            out = launch_mega(packed, *mega_kernel_inputs(model, *inputs, cd), tile_rows)
        else:
            out = unet_forward_mega(model, *inputs, compute_dtype=cd, packed=packed)
        torch.cuda.synchronize()
        ref = unet_forward_mega_reference(model, *inputs, compute_dtype=cd)
    assert obs.counters()["mega_launches"] == before + 1
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    # float32: summation order only, through 37 layers (the forward
    # tolerance, 1e-4 of the output's magnitude). bf16: the same rounding
    # points, but a reassociation can flip one rounding, and the flip
    # carries through the net: 2% of the magnitude, as against JAX.
    tol = (1e-4 if cd is None else 2e-2) * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("net,rows", [("nu", 1), ("nu", 16), ("nu", 37), ("nu", 1000), ("nu", 4096),
                                      ("nu", 4097), ("nu", 70001), ("nu", 1 << 20), ("odd", 37),
                                      ("odd", 5000), ("nu_budget", 1000)])
def test_cuda_mega_rows_matches_reference(net, rows):
    """The row-resident kernel (a warp a row up to 4,096 rows, a thread a row
    above; ragged last tiles at 37, 4,097, 70,001) against the plain version
    under the float32 tolerance, and against the tile kernel forced through
    ``tile_rows`` on the same inputs; one launch, counted by ``obs``'s
    ``mega_launches`` and ``mega_row_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, inputs = mega_inputs(net, rows, seed=rows, device="cuda")
    packed = pack_params(model)
    assert mega.mega_path(packed) == "rows"
    before = obs.counters()
    with torch.no_grad():
        out = unet_forward_mega(model, *inputs, packed=packed)
        torch.cuda.synchronize()
        info = mega.last_launch()
        after = obs.counters()
        assert (after["mega_launches"], after["mega_row_launches"]) == (
            before["mega_launches"] + 1, before["mega_row_launches"] + 1)
        ref = unet_forward_mega_reference(model, *inputs)
        tile = launch_mega(packed, *mega_kernel_inputs(model, *inputs), 32)
        torch.cuda.synchronize()
    assert info["path"] == "rows" and info["lanes"] == (32 if rows <= mega.ROW_WARP_MAX_ROWS else 1)
    assert mega.last_launch()["path"] == "tile"
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    # The forward tolerance of test_cuda_mega_matches_reference.
    tol = 1e-4 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)
    torch.testing.assert_close(out, tile, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1000, 70001])
def test_cuda_mega_rows_graph_replay_equals_eager(rows):
    """A row-resident launch captured in a CUDA graph: the replay's answer
    equals the eager launch's bit for bit; ``mega_row_launches`` counts 1
    for the eager launch, and the capture keeps 1 in ``obs.captured()`` for
    whoever replays the graph to add (``serve.Solver`` does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model, inputs = mega_inputs("nu", rows, seed=11, device="cuda")
    packed = pack_params(model)
    with torch.no_grad():
        ys, sc, st = mega_kernel_inputs(model, *inputs)
        counted = obs.counters()["mega_row_launches"]
        eager = launch_mega(packed, ys, sc, st)
        torch.cuda.synchronize()
        assert obs.counters()["mega_row_launches"] == counted + 1
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            launch_mega(packed, ys, sc, st)
        torch.cuda.current_stream().wait_stream(side)
        captured = obs.captured()["mega_row_launches"]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = launch_mega(packed, ys, sc, st)
        assert obs.captured()["mega_row_launches"] == captured + 1
        assert obs.counters()["mega_row_launches"] == counted + 2
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.cuda
def test_cuda_mega_row_launches_from_the_solvers_graphs():
    """Served from the buckets' CUDA graphs, an NU request (mega, DDIM 3)
    adds 3 row-resident launches a replay, as many as its mega launches;
    an MSR-3c request (fused) adds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    nu = _serve_solver("ddpm_nu_3u_aug32_s8c", "nu_direct", "mega", buckets=(64,))
    kw = {"omega": 0.125, "sampler": "ddim", "n_steps": 3}
    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (40, nu._C)).astype(np.float32)
    nu.solve(X, seed=1, **kw)            # captures the bucket's graph
    before = obs.counters()
    for seed in (2, 3):
        nu.solve(X, seed=seed, **kw)
    after = obs.counters()
    assert after["replays"] - before["replays"] == 2
    assert after["mega_row_launches"] - before["mega_row_launches"] == 2 * 3
    assert after["mega_launches"] - before["mega_launches"] == 2 * 3
    msr = _serve_solver("ddpm_msr_3c_T100", "msr", "fused", buckets=(8,))
    X = rng.uniform(0, 1, (5, msr._C)).astype(np.float32)
    msr.solve(X, seed=1)
    before = obs.counters()
    msr.solve(X, seed=2)
    assert obs.counters()["mega_row_launches"] == before["mega_row_launches"]


@pytest.mark.cuda
def test_cuda_mega_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model, (y, t, c, m) = mega_inputs("nu", 37, seed=1, device="cuda")
    with torch.no_grad():          # the wrapper is forward-only
        with pytest.raises(ValueError, match="batch-1 time"):
            unet_forward_mega(model, y, t.expand(37).contiguous(), c, m)
        with pytest.raises(TypeError, match="packed as"):
            unet_forward_mega(model, y, t, c, m, packed=pack_params(model, torch.bfloat16))
        with pytest.raises(ValueError, match="tile_rows"):
            launch_mega(pack_params(model), *mega_kernel_inputs(model, y, t, c, m), tile_rows=8)
        bf = [a.bfloat16() for a in (y, t, c, m)]
        with pytest.raises(ValueError, match="tile_rows"):
            launch_mega(pack_params(model, torch.bfloat16),
                        *mega_kernel_inputs(model, *bf, torch.bfloat16), tile_rows=16)
        with pytest.raises(ValueError, match="is on"):
            unet_forward_mega(model, y, t.cpu(), c, m)


@pytest.mark.cuda
def test_cuda_mega_follows_its_input_type():
    """A bf16 copy of the net on bf16 inputs, no compute_dtype: bf16 out,
    against its plain version (``pallas_mega.py:155-198``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import copy

    model, inputs = mega_inputs("nu", 1000, seed=5, device="cuda")
    low = copy.deepcopy(model).to(torch.bfloat16)
    bf = [a.bfloat16() for a in inputs]
    before = obs.counters()["mega_launches"]
    with torch.no_grad():
        out = unet_forward_mega(low, *bf)
        torch.cuda.synchronize()
        ref = unet_forward_mega_reference(low, *bf)
    assert obs.counters()["mega_launches"] == before + 1
    assert out.dtype == ref.dtype == torch.bfloat16
    # The bf16 tolerance of test_cuda_mega_matches_reference.
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=2e-2 * float(ref.float().abs().max()))


def _serve_solver(ckpt, task, backend, **kw):
    import pathlib

    from diffsg_tpu_torch.serve import Solver

    path = pathlib.Path(__file__).resolve().parent.parent / "ckpts" / ckpt
    return Solver.from_checkpoint(str(path), task=task, backend=backend, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("backend,per_request", [("fused", 2700), ("mega", 100)])
def test_cuda_graph_replay_equals_eager_and_counts_launches(backend, per_request):
    """One CUDA graph per (bucket, config): replays equal the same program
    run eagerly bit for bit, and each replay adds its captured launches to
    the counters, which the capture itself does not move."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from diffsg_tpu_torch.serve import Solver

    graphed = _serve_solver("ddpm_msr_3c_T100", "msr", backend, buckets=(64, 256))
    eager = Solver(graphed.task, graphed.model, graphed.sched, graphed.config, backend=backend,
                   buckets=(64, 256), graphs=False)
    X = np.random.default_rng(0).uniform(0, 1, (50, 3)).astype(np.float32)
    name = "resblock_launches" if backend == "fused" else "mega_launches"
    launches, captured = obs.counters()[name], obs.captured()[name]
    first = graphed.solve(X, seed=1)         # warm run, capture, replay
    assert len(graphed._graphs) == 1
    assert obs.captured()[name] == captured + per_request
    assert obs.counters()[name] == launches + 2 * per_request    # the warm run and one replay
    launches = obs.counters()[name]
    again = graphed.solve(X, seed=1)
    assert obs.counters()[name] == launches + per_request
    assert obs.captured()[name] == captured + per_request
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, eager.solve(X, seed=1))
    # omega is a runtime input of the graph: another scale, the same graph.
    np.testing.assert_array_equal(graphed.solve(X, omega=150.0, seed=2),
                                  eager.solve(X, omega=150.0, seed=2))
    graphed.solve(X[:40], seed=2)
    assert len(graphed._graphs) == 1
    # omega 0 is its own graph (the conditional half only), as is a bucket.
    np.testing.assert_array_equal(graphed.solve(X, omega=0.0, seed=3),
                                  eager.solve(X, omega=0.0, seed=3))
    graphed.solve(np.concatenate([X] * 3), seed=3)
    assert len(graphed._graphs) == 3
    # Above the largest bucket: eager, no graph.
    graphed.solve(np.concatenate([X] * 6), seed=3)
    assert len(graphed._graphs) == 3


@pytest.mark.cuda
def test_cuda_bucket_invariance_and_best_of():
    """NU DDIM-3 (omega 0.125, the production checkpoint): 100 rows in
    bucket 128 against an unbucketed solve, at the JAX package's bucket
    tolerance; best-of-4 with an omega mixture, graph against eager."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.serve import Solver

    bucketed = _serve_solver("ddpm_nu_3u_aug32_s8c", "nu_direct", "mega", buckets=(128,))
    plain = Solver(bucketed.task, bucketed.model, bucketed.sched, bucketed.config,
                   backend="mega")
    eager = Solver(bucketed.task, bucketed.model, bucketed.sched, bucketed.config,
                   backend="mega", buckets=(128,), graphs=False)
    X = np.random.default_rng(1).uniform(0, 1, (100, 6)).astype(np.float32)
    kw = {"omega": 0.125, "sampler": "ddim", "n_steps": 3}
    np.testing.assert_allclose(bucketed.solve(X, seed=4, **kw), plain.solve(X, seed=4, **kw),
                               rtol=1e-3, atol=1e-2)
    mix = {"omega": [0.0625, 0.125, 0.25, 0.5], "best_of": 4, "sampler": "ddim", "n_steps": 3}
    best = bucketed.solve(X, seed=4, **mix)
    np.testing.assert_array_equal(best, eager.solve(X, seed=4, **mix))
    users = torch.tensor(bucketed.task.unnormalize_x(X, bucketed.config), dtype=torch.float32)
    one = bucketed.solve(X, seed=4, **{**kw, "omega": 0.0625})
    rate = bucketed.task.objective
    assert bool((rate(torch.from_numpy(best), users, {}) >=
                 rate(torch.from_numpy(one), users, {})).all())


@pytest.mark.cuda
@pytest.mark.parametrize("net,blocks", [("co", 37), ("nu_geo", 22), ("msr_budget", 27)])
def test_cuda_fused_forward_matches_plain(net, blocks):
    """The whole forward with every residual block through the kernel, one
    launch a block, against the module's own forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    model, inputs = mega_inputs(net, 4096, seed=3, device="cuda")
    before = obs.counters()["resblock_launches"]
    with torch.no_grad():
        out = unet_forward_fused(model, *inputs)
        torch.cuda.synchronize()
        ref = model(*inputs)
    assert obs.counters()["resblock_launches"] == before + blocks
    # The forward tolerance: 1e-4 of the output's magnitude.
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("ckpt,task,kw", [
    ("ddpm_nu_geo_x0f", "nu_geo", {"sampler": "ddim", "n_steps": 3}),
    ("ddpm_msr_3c_T100", "msr", {}),
])
def test_cuda_refine_graph_replay_equals_eager(ckpt, task, kw):
    """``refine_iters`` runs inside the bucket's graph: replays equal the
    same program run eagerly bit for bit, and no refined row is worse than
    its unrefined decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from diffsg_tpu_torch.serve import Solver

    graphed = _serve_solver(ckpt, task, "mega", buckets=(64,), refine_iters=10)
    eager = Solver(graphed.task, graphed.model, graphed.sched, graphed.config, backend="mega",
                   buckets=(64,), graphs=False, refine_iters=10)
    unrefined = Solver(graphed.task, graphed.model, graphed.sched, graphed.config,
                       backend="mega", buckets=(64,))
    C = graphed.task.cond_dim(graphed.config)
    X = np.random.default_rng(2).uniform(0.3, 1, (50, C)).astype(np.float32)
    first = graphed.solve(X, seed=1, **kw)
    assert len(graphed._graphs) == 1
    np.testing.assert_array_equal(first, graphed.solve(X, seed=1, **kw))
    np.testing.assert_array_equal(first, eager.solve(X, seed=1, **kw))
    base = unrefined.solve(X, seed=1, **kw)
    Xu = torch.tensor(graphed.task.unnormalize_x(X, graphed.config), dtype=torch.float32)
    score = graphed.task.objective
    refined_q = score(torch.from_numpy(first), Xu, graphed.config)
    base_q = score(torch.from_numpy(base), Xu, graphed.config)
    assert bool((refined_q >= base_q - 1e-6 * base_q.abs()).all())
    assert bool((refined_q > base_q).any())


@pytest.mark.cuda
def test_cuda_co_ranked_decode_is_stable_on_ties():
    """Tied entries rank in index order on the card too (``argsort`` with
    ``stable=True``), so the card decodes as the CPU does."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.baselines import co_ranked_decode

    rng = np.random.default_rng(4)
    X = torch.tensor(rng.uniform(0.01, 8.0, (4096, 9)), dtype=torch.float32)
    Y = torch.tensor(rng.integers(-2, 3, (4096, 3)), dtype=torch.float32) * 5000.0
    order = torch.argsort(-Y.cuda(), dim=1, stable=True).cpu()
    torch.testing.assert_close(order, torch.argsort(-Y, dim=1, stable=True), rtol=0, atol=0)
    got = co_ranked_decode(Y.cuda(), X.cuda()).cpu()
    torch.testing.assert_close(got, co_ranked_decode(Y, X), rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("ckpt,face,backend,per_request", [
    ("ddpm_multi", "multi_co", "fused", 20 * 27),
    ("ddpm_multi", "multi_co", "mega", 20),
    ("ddpm_multi_geo", "multi_nu_geo", "mega", 20),
])
def test_cuda_multi_graph_replay_equals_eager_and_counts_launches(ckpt, face, backend,
                                                                  per_request):
    """A multi-task face in its bucket's graph (the condition adapter's
    pad inside the capture, T=20): replays equal eager bit for bit and add
    the captured launches per replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from diffsg_tpu_torch.serve import Solver

    graphed = _serve_solver(ckpt, face, backend, buckets=(64,))
    eager = Solver(graphed.task, graphed.model, graphed.sched, graphed.config, backend=backend,
                   buckets=(64,), graphs=False)
    C = graphed.task.cond_dim(graphed.config)
    X = np.random.default_rng(6).uniform(0.2, 1, (50, C)).astype(np.float32)
    name = "resblock_launches" if backend == "fused" else "mega_launches"
    launches, captured = obs.counters()[name], obs.captured()[name]
    first = graphed.solve(X, omega=0.5, seed=1)
    assert len(graphed._graphs) == 1
    assert obs.captured()[name] == captured + per_request
    assert obs.counters()[name] == launches + 2 * per_request
    again = graphed.solve(X, omega=0.5, seed=1)
    assert obs.counters()[name] == launches + 3 * per_request
    np.testing.assert_array_equal(first, again)
    np.testing.assert_array_equal(first, eager.solve(X, omega=0.5, seed=1))
    assert bool(np.isfinite(first).all()) and first.shape[0] == 50


@pytest.mark.cuda
@pytest.mark.parametrize("ckpt,face,backend,per_forward,rows", [
    ("ddpm_multi", "multi_msr", "fused", 27, 4096),
    ("ddpm_multi", "multi_msr", "mega", 1, 4096),
    ("ddpm_multi_80", "multi_msr80", "fused", 27, 16384),
    ("ddpm_multi_80", "multi_msr80", "mega", 1, 16384),
    ("ddpm_multi_80", "multi_msr8", "mega", 1, 1000),
])
def test_cuda_multi_forward_matches_plain_and_counts_launches(ckpt, face, backend, per_forward,
                                                              rows):
    """``unet_apply_fn`` on a face's condition adapter runs the backend's
    kernels on the shared net (one launch a block, or one a forward), and
    equals the plain forward within the float32 forward tolerance (1e-4 of
    the output's magnitude): on ddpm_multi and on the proj-256 ddpm_multi_80."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from diffsg_tpu_torch.models import unet_apply_fn

    solver = _serve_solver(ckpt, face, backend)
    model = solver.model
    rng = np.random.default_rng(rows)
    y = torch.tensor(rng.normal(size=(rows, model.inner.input_dim)), dtype=torch.float32,
                     device="cuda")
    c = torch.tensor(rng.uniform(size=(rows, model.payload_dim)), dtype=torch.float32,
                     device="cuda")
    m = (torch.arange(rows, device="cuda") >= rows // 2).float()[:, None]
    t = torch.tensor([0.37], device="cuda")
    name = "resblock_launches" if backend == "fused" else "mega_launches"
    before = obs.counters()[name]
    with torch.no_grad():
        out = unet_apply_fn(model, backend)(y, t, c, m)
        torch.cuda.synchronize()
        ref = unet_apply_fn(model, "plain")(y, t, c, m)
    assert obs.counters()[name] == before + per_forward
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def _train_inputs(steps, B, seed):
    """A small net's data and every draw of one epoch of ``steps`` batches."""
    from diffsg_tpu_torch.train import EpochDraws

    rng = np.random.default_rng(seed)
    n = steps * B
    X, Y = rng.uniform(0, 1, (n, 3)), rng.dirichlet(np.ones(3), n)
    draws = EpochDraws(torch.as_tensor(rng.permutation(n)),
                       torch.as_tensor(rng.integers(0, 10, (steps, B))),
                       torch.as_tensor(rng.normal(size=(steps, B, 3)).astype(np.float32)),
                       torch.as_tensor((rng.uniform(size=(steps, B, 1)) >= 0.1)
                                       .astype(np.float32)))
    return X, Y, draws


@pytest.mark.cuda
@pytest.mark.parametrize("grad_clip", [None, 0.05])
def test_cuda_train_steps_match_cpu(grad_clip):
    """Three train steps on the card equal the same steps on the CPU (one
    init, injected draws, TF32 off). The spread of the port against the JAX
    package on the CPU on this net is 1.4e-6 after 12 steps
    (tests/test_torch_train.py); the bound is 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.train import TrainConfig, torch_style_init, train_ddpm
    from diffsg_tpu_torch.utils import params_from_jax, params_to_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    X, Y, draws = _train_inputs(3, 64, seed=0)
    cfg = TrainConfig(epochs=1, batch_size=64, T=10, milestones=(100,), grad_clip=grad_clip)
    net = lambda: UNet1D(input_dim=3, proj_dim=16, cond_dim=3, dims=(8, 4), n_blocks=1)
    init = params_to_jax(torch_style_init(net(), torch.Generator().manual_seed(0)))
    out = {}
    for device in ("cpu", "cuda"):
        logs = []
        params, _, _ = train_ddpm(net(), X, Y, cfg, init_params=init, log_every=1,
                                  log_fn=logs.append, device=device, draws=lambda e: draws)
        out[device] = (float(logs[0].rsplit(" ", 1)[1]), params_from_jax(params))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    for k, cpu in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], cpu, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_wrappers_raise_under_grad():
    """The kernels are forward-only: under autograd each wrapper raises on
    the card, as on the CPU, instead of returning an output without a
    gradient; under no_grad they run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.models import unet_apply_fn
    from diffsg_tpu_torch.ops.resblock import resblock_params_tuple

    model, (y, t, c, m) = mega_inputs("msr", 64, seed=3, device="cuda")
    res = model.middle.res1
    x = torch.randn(64, res.lin1.kernel.shape[0], device="cuda")
    args = (x, res.time_emb(torch.randn(1, res.time_emb.kernel.shape[0], device="cuda")),
            res.cond_emb(torch.randn(64, res.cond_emb.kernel.shape[0], device="cuda")),
            *resblock_params_tuple(res))
    for fn in (lambda: fused_residual_block(*args), lambda: unet_forward_mega(model, y, t, c, m),
               lambda: unet_apply_fn(model, "fused")(y, t, c, m)):
        with pytest.raises(RuntimeError, match="forward-only"):
            fn()
    with torch.no_grad():
        assert torch.isfinite(unet_forward_mega(model, y, t, c, m)).all()
        assert torch.isfinite(fused_residual_block(*[a.detach() if a is not None else None
                                                     for a in args])).all()


def _make_cli_inputs(root):
    """Small CSVs for the training CLIs, from the port's make_datasets."""
    from diffsg_tpu_torch.tools import make_datasets

    recipes = {
        "3c_10w_400samples.csv": ["msr", "--samples", "400"],
        "3c_20w_200samples_ood.csv": ["msr", "--samples", "200", "--power", "20", "--seed", "1"],
        "3nodes_400samples.csv": ["co", "--samples", "400"],
        "3u_18mW_200samples.csv": ["nu", "--samples", "200", "--grid-step", "8"],
        "3u_budget_200samples.csv": ["nu-budget", "--samples", "200", "--budget-step", "3",
                                     "--grid-step", "8"],
        "3u_geo_200samples.csv": ["nu-geo", "--samples", "200", "--geom-step", "200",
                                  "--grid-step", "8"],
    }
    for name, argv in recipes.items():
        make_datasets.main(argv + ["--out", str(root / name)])
    return lambda name: str(root / name)


@pytest.mark.cuda
@pytest.mark.parametrize("cli", ["train_msr_budget", "train_multi"])
def test_cuda_cli_epoch_matches_cpu(cli, tmp_path, monkeypatch):
    """One epoch of a training CLI on the card against the same epoch with
    ``--cpu``: one init, the same injected draws, TF32 off. Held as
    ``chip_smoke.py``'s train phase holds card steps (loss within 1e-5
    relative; at most 1e-4 of the parameters off by more than 1e-4, none by
    more than 2 lr)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import importlib

    import diffsg_tpu_torch.train as port_train
    from diffsg_tpu_torch.train import EpochDraws
    from diffsg_tpu_torch.utils import load_checkpoint

    d = _make_cli_inputs(tmp_path)
    if cli == "train_msr_budget":
        argv = ["--samples", "1536", "--proj-dim", "32", "--dims", "16", "8", "--epochs", "1",
                "--omegas", "1.0", "--indist", d("3c_10w_400samples.csv"),
                "--ood", d("3c_20w_200samples_ood.csv")]
    else:
        argv = ["--nu-mode", "geo", "--with-msr80", "--with-msr8", "--proj-dim", "32",
                "--dims", "16", "8", "--lr", "5e-4", "--grad-clip", "0.25",
                "--parameterization", "x0", "--epochs", "1", "--skip-eval",
                "--msr-dataset", d("3c_10w_400samples.csv"),
                "--co-dataset", d("3nodes_400samples.csv"),
                "--nu-dataset", d("3u_18mW_200samples.csv"),
                "--nu-budget-dataset", d("3u_budget_200samples.csv"),
                "--nu-geo-datasets", d("3u_geo_200samples.csv"), "--msr-repeat", "1",
                "--co-repeat", "1", "--nu-times", "1", "--msr80-samples", "300",
                "--msr8-samples", "200"]
    real = port_train.train_ddpm

    def with_fixed_draws(model, X, Y, cfg, **kw):
        n = X.shape[0]
        B = min(cfg.batch_size, n)
        steps = max(n // B, 1)
        rng = np.random.default_rng(0)
        draws = EpochDraws(torch.as_tensor(rng.permutation(n)[:steps * B]),
                           torch.as_tensor(rng.integers(0, cfg.T, (steps, B))),
                           torch.as_tensor(rng.normal(size=(steps, B, Y.shape[1]))
                                           .astype(np.float32)),
                           torch.as_tensor((rng.uniform(size=(steps, B, 1)) >= cfg.uncond_prob)
                                           .astype(np.float32)))
        return real(model, X, Y, cfg, draws=lambda epoch: draws, **kw)

    monkeypatch.setattr(port_train, "train_ddpm", with_fixed_draws)
    module = importlib.import_module(f"diffsg_tpu_torch.tools.{cli}")
    out = {}
    for device, flags in (("cpu", ["--cpu"]), ("cuda", [])):
        run = tmp_path / device
        module.main(argv + flags + ["--out", str(run)])
        log = [json.loads(line) for line in (run / "train_log.jsonl").open()]
        assert log[0]["device"] == ("cpu" if device == "cpu" else torch.cuda.get_device_name(0))
        loss = float(next(r for r in log if r["event"] == "train")["msg"].rsplit(" ", 1)[1])
        ck = load_checkpoint(str(run), device="cpu")
        out[device] = (loss, np.concatenate([np.asarray(v, np.float64).ravel()
                                             for _, v in _flat(ck["params"])]))
        lr = ck["metadata"]["config"]["lr"]
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    diff = np.abs(out["cuda"][1] - out["cpu"][1])
    assert (diff > 1e-4).mean() <= 1e-4 and diff.max() <= 2 * lr, (diff.max(), lr)


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.cuda
@pytest.mark.parametrize("face", ["multi_msr", "multi_co", "multi_nu_geo", "multi_msr80",
                                  "multi_msr8"])
def test_cuda_zoo_faces_kernels_match_plain(face):
    """``ckpts/ddpm_multi_zoo``'s faces (proj 256, canvas 80, condition 5 +
    81) through ``fused`` (27 launches a forward) and ``mega`` (1) against
    ``plain`` on the card at 4,096 rows, half masked: within 1e-4 of the
    output's magnitude, as ``chip_smoke.py``'s FORWARD_RTOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import pathlib

    from diffsg_tpu_torch.models import unet_apply_fn
    from diffsg_tpu_torch.serve import Solver

    zoo = pathlib.Path(__file__).resolve().parent.parent / "ckpts" / "ddpm_multi_zoo"
    model = Solver.from_checkpoint(str(zoo), task=face, device="cuda").model
    rng = np.random.default_rng(len(face))
    rows = 4096
    y = torch.tensor(rng.normal(size=(rows, model.inner.input_dim)), dtype=torch.float32,
                     device="cuda")
    c = torch.tensor(rng.uniform(0, 1, (rows, model.payload_dim)), dtype=torch.float32,
                     device="cuda")
    m = (torch.arange(rows, device="cuda") >= rows // 2).float()[:, None]
    t = torch.tensor([0.37], device="cuda")
    with torch.no_grad():
        ref = unet_apply_fn(model, "plain")(y, t, c, m)
        for backend, name, per_forward in (("fused", "resblock_launches", 27),
                                           ("mega", "mega_launches", 1)):
            before = obs.counters()[name]
            out = unet_apply_fn(model, backend)(y, t, c, m)
            torch.cuda.synchronize()
            assert obs.counters()[name] == before + per_forward, backend
            torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def _gd_inputs(fam, rows=4096, seed=0):
    """(solver, conditions) of a GD family at ``rows`` rows: CO features and
    MSR gains in physical units, NU coordinates loader-normalized."""
    from diffsg_tpu_torch.baselines import co_gd_solve, msr_gd_solve, nu_gd_solve

    rng = np.random.default_rng(seed)
    if fam == "co":
        return co_gd_solve, rng.uniform(0.01, 10.0, (rows, 9)).astype(np.float32)
    if fam == "msr":
        return (lambda g: msr_gd_solve(g, W=10.0)), rng.uniform(0.5, 2.5, (rows, 3)).astype(
            np.float32)
    return (lambda c: nu_gd_solve(c, P_sum=18.0)), rng.uniform(0, 1, (rows, 6)).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("fam", ["co", "msr", "nu"])
def test_cuda_gd_matches_cpu(fam):
    """GD's 100 iterations on the card against the CPU on the same rows:
    within 1e-5 of the magnitude. Every op rounds alone on both (and the row
    sums are left folds), which CO's iteration needs: it grows a one-ulp
    difference to O(1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    solve, X = _gd_inputs(fam)
    cpu = solve(torch.from_numpy(X))
    card = solve(torch.from_numpy(X).cuda()).cpu()
    assert torch.isfinite(card).all()
    assert float((card - cpu).abs().max()) <= 1e-5 * float(cpu.abs().max())


def _logged(line):
    """The numbers of an epoch's log line ("... loss 0.206475", "... actor
    0.7004 critic 11.6247 reward 2.3226")."""
    return [float(t) for t in line.split(":", 1)[1].split()[1::2]]


def _params_within(cpu, card, lr):
    """The train phase's bounds: at most 1e-4 of the parameters off by more
    than 1e-4, none by more than 2 lr (Adam moves a parameter whose gradient
    is near zero by up to lr, whatever the gradient's rounding)."""
    from diffsg_tpu_torch.utils import params_from_jax

    a, b = params_from_jax(cpu), params_from_jax(card)
    diff = torch.cat([(a[k] - b[k]).abs().flatten() for k in a])
    assert float((diff > 1e-4).float().mean()) <= 1e-4 and float(diff.max()) <= 2 * lr


@pytest.mark.cuda
def test_cuda_mtfnn_step_matches_cpu():
    """One train_mtfnn step (512 rows, the CO net) on the card against the
    CPU: one init, one permutation, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.baselines import MTFNNConfig, mtfnn_co_model, train_mtfnn
    from diffsg_tpu_torch.train import torch_style_init
    from diffsg_tpu_torch.utils import params_to_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    X, Y = rng.uniform(0, 1, (512, 9)), rng.dirichlet(np.ones(3), 512)
    init = params_to_jax(torch_style_init(mtfnn_co_model(), torch.Generator().manual_seed(1)))
    perm = torch.from_numpy(rng.permutation(512))
    out = {}
    for device in ("cpu", "cuda"):
        logs = []
        out[device] = (train_mtfnn(mtfnn_co_model(), X, Y, MTFNNConfig(epochs=1),
                                   log_fn=logs.append, log_every=1, init_params=init,
                                   device=device, draws=lambda e: perm), logs[0])
    assert _logged(out["cuda"][1]) == pytest.approx(_logged(out["cpu"][1]), abs=2e-6)
    _params_within(out["cpu"][0], out["cuda"][0], MTFNNConfig.lr)


@pytest.mark.cuda
def test_cuda_ppo_step_matches_cpu():
    """One train_ppo step (512 rows, CO's rewards) on the card against the
    CPU: one init, the same injected draws, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.baselines import PPOConfig, PPODraws, orthogonal_ppo_init, train_ppo
    from diffsg_tpu_torch.tools.train_baselines import ppo_recipe
    from diffsg_tpu_torch.utils import params_to_jax

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_d = {"node_num": 3, "scaler_min": 0.0016, "scaler_max": 9.997}
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 1, (512, 9))
    Y = rng.dirichlet(np.ones(3), 512) * (rng.uniform(size=(512, 1)) > 0.1)
    agent = ppo_recipe("co", cfg_d)[0]
    init = params_to_jax(orthogonal_ppo_init(agent, torch.Generator().manual_seed(2)))
    z0 = rng.normal(size=(512, 3)).astype(np.float32)
    draws = PPODraws(torch.from_numpy(rng.permutation(512)),
                     torch.from_numpy(rng.normal(size=(1, 512, 3)).astype(np.float32)))
    out = {}
    for device in ("cpu", "cuda"):
        agent, _, env_fn, transform, _, _ = ppo_recipe("co", cfg_d)
        logs = []
        params, _ = train_ppo(agent, X, Y, env_fn, transform, PPOConfig(epochs=1),
                              log_fn=logs.append, log_every=1, init_params=init, device=device,
                              a0=z0, draws=lambda e: draws)
        out[device] = (params, logs[0])
    assert _logged(out["cuda"][1]) == pytest.approx(_logged(out["cpu"][1]), abs=2e-4)
    _params_within(out["cpu"][0], out["cuda"][0], PPOConfig.lr)


# -- the mesh, the legacy sampler, attention nets and the pair backend ------------------

@pytest.mark.cuda
def test_cuda_meshed_solver_one_rank_equals_unmeshed_bit_for_bit(tmp_path):
    """A spawned world of one NCCL rank serves MSR-3c from the bucket's CUDA
    graph with its collectives captured inside; at world 1 they add nothing,
    so the answer equals the unmeshed bucketed Solver's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import pathlib

    from diffsg_tpu_torch.parallel import cases, launch

    torch.backends.cuda.matmul.allow_tf32 = False
    ckpt = str(pathlib.Path(__file__).resolve().parent.parent / "ckpts" / "ddpm_msr_3c_T100")
    X = np.random.default_rng(0).uniform(0, 1, (1000, 3)).astype(np.float32)
    meshed = launch.spawn(cases.run, 1, 1, "cuda", timeout_s=300, store_dir=str(tmp_path),
                          args=([("solve", (ckpt, "msr", X, "fused", {"seed": 2}, (1024,)))],),
                          threads=4)[0][0]
    unmeshed = _serve_solver("ddpm_msr_3c_T100", "msr", "fused",
                             buckets=(1024,)).solve(X, seed=2)
    assert isinstance(meshed, np.ndarray), meshed
    np.testing.assert_array_equal(meshed, unmeshed)


@pytest.mark.cuda
def test_cuda_dryrun_multichip_one_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.parallel.dryrun import dryrun_multichip

    r = dryrun_multichip(1, device="cuda", timeout_s=300)
    assert r["shape"] == {"dp": 1, "tp": 1} and r["platform"] == "cuda"
    assert np.isfinite(r["loss"]) and r["serve_max_abs_err"] < 1e-3


@pytest.mark.cuda
def test_cuda_legacy_sample_matches_cpu():
    """legacy_sample on the card against the CPU on the same injected
    Dirichlet draws (MSR clamp, a small net as the denoiser), each float32
    run also held to a float64 run on the CPU.

    The float64 run is the witness for the bound: each step's whole-tensor
    min-max rescales rounding differences, so the CPU's own float32 run
    lies up to 1.1e-4 from the float64 one (at one entry of 768; 1.5e-7 on
    the mean). The card must be no further from the float64 run than twice
    the CPU's float32 run is, and within 1e-4 of the CPU's float32 run, as
    chip_smoke.py's legacy phase holds its run."""
    import copy

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.diffusion import Schedule, cosine_schedule
    from diffsg_tpu_torch.diffusion.legacy import legacy_sample

    torch.backends.cuda.matmul.allow_tf32 = False
    B, T = 256, 10
    rng = np.random.default_rng(4)
    cond = rng.uniform(0, 1, (B, 3))
    init = rng.dirichlet(np.ones(3), B).astype(np.float32)
    steps = (rng.dirichlet(np.full(3, 3.0), (T, B)) - 1 / 3).astype(np.float32)
    torch.manual_seed(0)
    net = UNet1D(input_dim=3, proj_dim=32, cond_dim=3, dims=(16, 8), n_blocks=1,
                 is_attn=(False, False))
    out = {}
    for device, dtype in (("cpu", torch.float32), ("cuda", torch.float32),
                          ("cpu", torch.float64)):
        model = copy.deepcopy(net).to(device, dtype)
        sched = Schedule(*(c.to(dtype) for c in cosine_schedule(T, device=device)))
        ones = torch.ones(B, 1, device=device, dtype=dtype)

        def f(a):
            return torch.from_numpy(a).to(device, dtype)
        with torch.no_grad():
            out[device, dtype] = legacy_sample(lambda y, t, c: model(y, t / T, c, ones), sched,
                                               f(cond.astype(np.float32)), 3,
                                               task="MAX SUM RATE", init=f(init),
                                               step_noise=f(steps))[0].cpu().double()
    exact = out["cpu", torch.float64]
    cpu_drift = float((out["cpu", torch.float32] - exact).abs().max())
    card_drift = float((out["cuda", torch.float32] - exact).abs().max())
    assert 0 < cpu_drift < 1e-3, cpu_drift
    assert card_drift <= 2 * cpu_drift, (card_drift, cpu_drift)
    torch.testing.assert_close(out["cuda", torch.float32], out["cpu", torch.float32], rtol=0,
                               atol=1e-4)


@pytest.mark.cuda
def test_cuda_attention_net_plain_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(1)
    net = UNet1D(input_dim=3, proj_dim=64, cond_dim=3, dims=(32, 16), n_blocks=2,
                 is_attn=(True, True), middle_attn=True)
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(a) for a in (rng.normal(size=(512, 3)).astype(np.float32),
                                          np.full(1, 0.4, np.float32),
                                          rng.uniform(0, 1, (512, 3)).astype(np.float32),
                                          np.ones((512, 1), np.float32))]
    with torch.no_grad():
        want = net(*args)
        got = net.cuda()(*[a.cuda() for a in args]).cpu()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_pair_backend_matches_plain():
    """The CFG-pair forward on MSR-3c at 4,096 folded rows against plain,
    and a request through it against plain at omega 0.125 on NU DDIM-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.models import unet_apply_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    model = _serve_solver("ddpm_msr_3c_T100", "msr", "plain").model
    rng = np.random.default_rng(6)
    half = torch.from_numpy(rng.normal(size=(2048, 3)).astype(np.float32)).cuda()
    c = torch.from_numpy(rng.uniform(0, 1, (2048, 3)).astype(np.float32)).cuda()
    y2, c2 = torch.cat([half, half]), torch.cat([c, c])
    mask = torch.cat([torch.zeros(2048, 1), torch.ones(2048, 1)]).cuda()
    t = torch.full((1,), 0.37, device="cuda")
    with torch.no_grad():
        ref = model(y2, t, c2, mask)
        got = unet_apply_fn(model, "pair")(y2, t, c2, mask)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    X = rng.uniform(0.05, 0.95, (512, 6)).astype(np.float32)
    kw = {"omega": 0.125, "sampler": "ddim", "n_steps": 3}
    out = {b: _serve_solver("ddpm_nu_3u_aug32_s8c", "nu_direct", b,
                            buckets=(512,)).solve(X, **kw) for b in ("plain", "pair")}
    np.testing.assert_allclose(out["pair"], out["plain"], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_unblocked_requests_equal_blocking_ones():
    """``Solver.solve(_block=False)`` returns the solutions on the card,
    cut to the real rows, before they are waited for; four requests issued
    back to back from one bucket's graph equal blocking requests of their
    seeds bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    solver = _serve_solver("ddpm_nu_3u_aug32_s8c", "nu_direct", "mega", buckets=(512,))
    X = np.random.default_rng(7).uniform(0.05, 0.95, (300, 6)).astype(np.float32)
    kw = {"sampler": "ddim", "n_steps": 3}
    solver.solve(X, **kw)
    pending = [solver.solve(X, seed=10 + i, _block=False, **kw) for i in range(4)]
    assert all(p.is_cuda and p.shape == (300, 5) for p in pending)
    for i, p in enumerate(pending):
        np.testing.assert_array_equal(p.cpu().numpy(), solver.solve(X, seed=10 + i, **kw))


@pytest.mark.cuda
def test_cuda_refine_rows_matches_cpu():
    """``tools/refine_labels.refine_rows`` on the card against the CPU on
    the same starts (the label and two random starts, 3 steps, 256 rows of
    uniform power splits): the rates agree to 1e-5; a label may part only
    where the two devices' objectives tie at an accept test, and then its
    rate agrees to one float32 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from diffsg_tpu_torch.tools.refine_labels import refine_rows

    rng = np.random.default_rng(9)
    B = 256
    coords = rng.uniform(0, 400, (B, 6))
    budgets = rng.choice([9.0, 18.0, 27.0], B)
    Y0 = np.concatenate([rng.uniform(100, 300, (B, 2)), np.repeat(budgets[:, None] / 3, 3, 1)],
                        axis=1)
    starts = torch.from_numpy(rng.uniform(0, 1, (2, B, 5)).astype(np.float32))
    out = {dev: refine_rows(coords, Y0, budgets, 3, starts, 0, 400.0, 400.0, device=dev)
           for dev in ("cpu", "cuda")}
    (Yc, Rc, _), (Yg, Rg, _) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(Rg, Rc, rtol=1e-5, atol=0)
    part = ~np.isclose(Yg, Yc, rtol=1e-5, atol=1e-5).all(axis=1)
    assert part.mean() <= 0.02, np.nonzero(part)
    assert (np.abs(Rg[part] - Rc[part]) <= np.spacing(Rc[part].astype(np.float32))).all()
    assert np.isfinite(Yg).all()


@pytest.mark.cuda
def test_cuda_orbax_fixture_loads_onto_the_card():
    """The JAX package's orbax checkpoint of the NU net (OCDBT, zstd),
    read by the port's ``load_checkpoint_orbax`` onto the card: the
    schedule on the card, every array and the schedule bit-equal to the npz
    checkpoint's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import pathlib

    from diffsg_tpu_torch.utils import load_checkpoint
    from diffsg_tpu_torch.utils.orbax_io import load_checkpoint_orbax

    root = pathlib.Path(__file__).resolve().parent.parent
    got = load_checkpoint_orbax(str(root / "tests" / "fixtures" / "orbax_ddpm_nu_3u_aug32_s8c"),
                                device="cuda")
    want = load_checkpoint(str(root / "ckpts" / "ddpm_nu_3u_aug32_s8c"), device="cuda",
                           training=True)

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    g, w = flat(got["params"]), flat(want["params"])
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert got["sched"].betas.is_cuda
    for name in want["sched"]._fields:
        assert torch.equal(getattr(got["sched"], name), getattr(want["sched"], name)), name
    assert sorted(got["ema"].params) == sorted(want["ema"].params)
    for k, v in want["ema"].params.items():
        assert torch.equal(got["ema"].params[k], v), k
    assert (got["step"], got["metadata"], got["ema"].n_averaged) == \
        (want["step"], want["metadata"], want["ema"].n_averaged)

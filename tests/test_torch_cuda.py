"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` configures JAX.)
"""

import numpy as np
import pytest
import torch

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
    before = resblock.LAUNCHES
    out = fused_residual_block(*args)
    torch.cuda.synchronize()
    assert resblock.LAUNCHES == before + 1
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
    before = mega.LAUNCHES
    with torch.no_grad():
        if tile_rows:
            out = launch_mega(packed, *mega_kernel_inputs(model, *inputs, cd), tile_rows)
        else:
            out = unet_forward_mega(model, *inputs, compute_dtype=cd, packed=packed)
        torch.cuda.synchronize()
        ref = unet_forward_mega_reference(model, *inputs, compute_dtype=cd)
    assert mega.LAUNCHES == before + 1
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    # float32: summation order only, through 37 layers (the forward
    # tolerance, 1e-4 of the output's magnitude). bf16: the same rounding
    # points, but a reassociation can flip one rounding, and the flip
    # carries through the net: 2% of the magnitude, as against JAX.
    tol = (1e-4 if cd is None else 2e-2) * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


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
    before = mega.LAUNCHES
    with torch.no_grad():
        out = unet_forward_mega(low, *bf)
        torch.cuda.synchronize()
        ref = unet_forward_mega_reference(low, *bf)
    assert mega.LAUNCHES == before + 1
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
    counter = resblock if backend == "fused" else mega
    launches, captured = counter.LAUNCHES, counter.CAPTURED
    first = graphed.solve(X, seed=1)         # warm run, capture, replay
    assert len(graphed._graphs) == 1
    assert counter.CAPTURED == captured + per_request
    assert counter.LAUNCHES == launches + 2 * per_request    # the warm run and one replay
    launches = counter.LAUNCHES
    again = graphed.solve(X, seed=1)
    assert counter.LAUNCHES == launches + per_request and counter.CAPTURED == captured + per_request
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
    before = resblock.LAUNCHES
    with torch.no_grad():
        out = unet_forward_fused(model, *inputs)
        torch.cuda.synchronize()
        ref = model(*inputs)
    assert resblock.LAUNCHES == before + blocks
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
    counter = resblock if backend == "fused" else mega
    launches, captured = counter.LAUNCHES, counter.CAPTURED
    first = graphed.solve(X, omega=0.5, seed=1)
    assert len(graphed._graphs) == 1
    assert counter.CAPTURED == captured + per_request
    assert counter.LAUNCHES == launches + 2 * per_request
    again = graphed.solve(X, omega=0.5, seed=1)
    assert counter.LAUNCHES == launches + 3 * per_request
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
    counter = resblock if backend == "fused" else mega
    before = counter.LAUNCHES
    with torch.no_grad():
        out = unet_apply_fn(model, backend)(y, t, c, m)
        torch.cuda.synchronize()
        ref = unet_apply_fn(model, "plain")(y, t, c, m)
    assert counter.LAUNCHES == before + per_forward
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

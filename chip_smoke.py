#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffsg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA (no JAX needed). It builds the CUDA kernels from
``diffsg_tpu_torch/csrc``, holds each kernel against its plain PyTorch
version at the shapes of the serving paths, drives those paths and checks
their answers:

* MSR-3c (``ckpts/ddpm_msr_3c_T100``, DDPM T=100, omega=500) through
  ``serve.Solver`` with the ``fused`` backend (every residual block one
  launch of ``csrc/resblock.cu``) and the ``mega`` backend (every forward
  one launch of ``csrc/mega.cu``), and through ``cfg_sample`` with the mega
  forward in bfloat16;
* NU (``ckpts/ddpm_nu_3u_aug32_s8c``, task ``nu_direct``, DDIM-3, omega
  0.125) through ``serve.Solver`` with the ``mega`` backend at B = 524,288,
  and held to the JAX package's answer on the same inputs;
* the production row as ``bench.py:_production_row`` runs it: that NU
  DDIM-3 with the params and the conditions in bfloat16, through ``mega``
  (a bfloat16 copy of the net: bfloat16 in, bfloat16 out) and ``plain``
  bfloat16 (cuBLAS) in turns, held to the JAX package's bfloat16 answer;
  and MSR-3c through ``cfg_sample(compute_dtype=bfloat16)`` on ``plain``;
* the Solver's serving surface: one CUDA graph per bucket on ``fused`` and
  ``mega`` (eager, graph, graph, eager; replays equal to eager bit for bit,
  launches counted per replay), a bucket of 1,024 holding 1,000 real rows
  against an unbucketed solve, and best-of-4 with an omega mixture.

The residual-block kernel is held to its plain version at every block
shape of the MSR-3c forward (16,384 rows) and at the two widest shapes of
a net of the shapes of ``ckpts/ddpm_msr_80c_budget`` (proj 256, dims
256-128-64-32, input 80, condition 81) with seeded random weights, the
widest net the repository ships: 512 -> 256 with a shortcut and 256 -> 256,
at 16,384 rows and, for 512 -> 256, at a ragged 1,000 rows with a full
t_proj; each case at every tile height its path is built for. The
whole-UNet kernel is held to its plain version on MSR-3c, NU and that net.

Every phase prints one JSON line with the seconds since start; any failure
raises and exits non-zero. The last three lines are the ``kernels``
summary, the card's name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "ckpts", "ddpm_msr_3c_T100")
NU_CKPT = os.path.join(REPO, "ckpts", "ddpm_nu_3u_aug32_s8c")
T_START = time.perf_counter()

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
ROWS = 16_384          # 2B rows of the CFG fold at B = 8,192
SERVE_B = 8_192
NU_B = 524_288         # the JAX package's production NU batch (bench.py)
NU_OMEGA, NU_STEPS = 0.125, 3
# f32, TF32 off, summation order only. The deepest sums (512 terms, the
# proj-256 blocks' input) of products of O(1) activations and weights of
# O(1/sqrt(512)) round to a few 1e-6 at the outputs' magnitudes.
KERNEL_ATOL = 1e-4
FORWARD_RTOL = 1e-4    # of the output's max magnitude, through 27 blocks
BF16_MEAN_SHARE = 0.25  # bf16 kernel vs plain: mean error against bf16's own
RESBLOCK_REPLACES = "diffsg_tpu/ops/pallas_kernels.py:71"
RESBLOCK_SOURCE = "diffsg_tpu_torch/csrc/resblock.cu"
MEGA_REPLACES = "diffsg_tpu/ops/pallas_mega.py:131"
MEGA_SOURCE = "diffsg_tpu_torch/csrc/mega.cu"
# The shapes of ckpts/ddpm_msr_80c_budget, ddpm_msr_80c_wf250k, ddpm_multi_80
# and ddpm_multi_zoo.
P256 = dict(input_dim=80, proj_dim=256, cond_dim=81, dims=(256, 128, 64, 32), n_blocks=2)
# Mean nu_rate of the JAX package on the nu_vs_jax inputs (B = 4,096
# conditions and y_T from np.random.default_rng(0), DDIM-3, omega 0.125,
# flax forward, nu_direct decode), computed on the CPU by
# tests/test_torch_nu.py::test_nu_vs_jax_constant, which holds this number.
NU_JAX_MEAN_RATE = 0.00042744530946947634
# The same in bf16, as bench.py's production row runs it (params, conditions
# and y_T cast to bf16, no compute_dtype; y0 decoded in float32), computed
# by tests/test_torch_bf16.py::test_nu_bf16_vs_jax_constant.
NU_JAX_BF16_MEAN_RATE = 0.0004274172824807465
MSR_MIX = [150.0, 500.0, 2000.0, 5000.0]   # best-of-4 omega mixture


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "s": round(time.perf_counter() - T_START, 3), **fields}),
          flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per eager call, by CUDA events around ``reps``
    calls. Where the host issues work more slowly than the card runs it,
    this is the host's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50, replays: int = 5) -> float:
    """Mean device milliseconds per call: ``reps`` calls captured in one CUDA
    graph, timed by CUDA events over ``replays`` replays, so no host time
    between launches is counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * replays)


def resblock_bound(rows: int, t_rows: int, din: int, dout: int, shortcut: bool):
    """(bound_ms, bound_by): the larger of the float32 operations over the
    SIMT peak and the bytes (each input read once, the output written once)
    over HBM bandwidth."""
    mm = din * dout + 2 * dout * dout + (din * dout if shortcut else 0)
    flops = 2 * rows * mm
    vectors = 2 * din + 7 * dout + (dout if shortcut else 0)   # LN scales/biases, biases
    nbytes = 4 * (rows * din + t_rows * dout + 2 * rows * dout + mm + vectors)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def mega_work(packed, rows: int):
    """(multiply-adds per row, batch-1 multiply-adds, bytes) of one mega
    forward at ``rows`` rows: every product of the table per row, each
    block's time projection once, and each input, weight and output moved
    once."""
    from diffsg_tpu_torch.ops import mega

    per_row = once = 0
    C = packed.cond_dim
    for r in packed.table.cpu().tolist():
        din, dout = r[mega.K_IN], r[mega.K_OUT]
        if r[mega.K_KIND] == mega.BLOCK:
            per_row += din * dout + 2 * dout * dout + C * dout
            per_row += din * dout if r[mega.K_FLAGS] & mega.F_SHORTCUT else 0
            once += packed.time_dim * dout
        else:
            per_row += din * dout
    size = packed.weights.element_size()
    nbytes = (size * (rows * (packed.input_dim + C) + packed.time_dim + packed.weights.numel())
              + 4 * rows * packed.input_dim)
    return per_row, once, nbytes


def mega_bound(packed, rows: int):
    """(bound_ms, bound_by): operations at the float32 SIMT peak (the bf16
    tensor-core peak for bf16 weights) against bytes at HBM bandwidth."""
    import torch

    per_row, once, nbytes = mega_work(packed, rows)
    peak = PEAK_BF16_FLOPS if packed.weights.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops = 2 * (rows * per_row + once) / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from diffsg_tpu_torch.baselines import waterfilling
    from diffsg_tpu_torch.diffusion import cfg_sample, ddim_sample
    from diffsg_tpu_torch.models import UNet1D, unet_apply_fn, unet_forward_fused
    from diffsg_tpu_torch.ops import _build, mega, msr_sum_rate, nu_rate, resblock
    from diffsg_tpu_torch.ops.resblock import (fused_residual_block, resblock_params_tuple,
                                               resblock_reference)
    from diffsg_tpu_torch.serve import Solver
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def zero_counts():
        resblock.LAUNCHES = 0
        mega.LAUNCHES = 0

    # -- device ---------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- build: one nvcc per source, all started together ------------------------
    _build.library()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", nvcc_s=_build.BUILD_SECONDS, cached=_build.BUILD_SECONDS is None,
         flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas)

    # -- kernel: every (in, out, shortcut) shape of the MSR-3c forward, and the ---
    # -- proj-256 net's two widest shapes ------------------------------------------
    solver = Solver.from_checkpoint(CKPT, task="msr", backend="fused")
    model = solver.model
    torch.manual_seed(0)
    p256_model = UNet1D(**P256).to(dev)

    def block_shapes(net):
        blocks = [m.res for m in net.down if hasattr(m, "res")]
        blocks += [net.middle.res1, net.middle.res2]
        blocks += [m.res for m in net.up if hasattr(m, "res")]
        shapes = {}
        for res in blocks:
            key = (res.lin1.kernel.shape[0], res.lin1.kernel.shape[1], res.shortcut is not None)
            shapes.setdefault(key, [res, 0])[1] += 1
        return blocks, shapes

    blocks, shapes = block_shapes(model)
    check(len(blocks) == 27, f"27 residual blocks, found {len(blocks)}")
    p256_shapes = block_shapes(p256_model)[1]

    rng = np.random.default_rng(0)
    per_shape = []
    cases = ([("msr", key, ROWS, 1) for key in shapes] + [("msr", (256, 128, True), 1000, 1000)]
             + [("p256", key, rows, t_rows) for key, rows, t_rows in
                (((512, 256, True), ROWS, 1), ((256, 256, False), ROWS, 1),
                 ((512, 256, True), 1000, 1000))])
    for net, (din, dout, sc), rows, t_rows in cases:
        res, per_forward = (shapes if net == "msr" else p256_shapes)[(din, dout, sc)]
        x = torch.tensor(rng.normal(size=(rows, din)), dtype=torch.float32, device=dev)
        t_proj = torch.tensor(rng.normal(size=(t_rows, dout)), dtype=torch.float32, device=dev)
        c_proj = torch.tensor(rng.normal(size=(rows, dout)), dtype=torch.float32, device=dev)
        args = (x, t_proj, c_proj, *[p.detach() for p in resblock_params_tuple(res)
                                     if p is not None])
        with torch.no_grad():
            out = fused_residual_block(*args)
            torch.cuda.synchronize()
            launch = resblock.last_launch()
            ref = resblock_reference(*args)
            err = float((out - ref).abs().max())
            check(bool(torch.isfinite(out).all()), f"finite kernel output at {din}->{dout}")
            check(err <= KERNEL_ATOL, f"kernel {din}->{dout} rows {rows}: max abs err {err}")
            k_ms = graph_ms(lambda: fused_residual_block(*args), reps=20, replays=3)
            tile_ms = {}
            for tr in resblock.resblock_tile_heights(din, dout):
                o = fused_residual_block(*args, tile_rows=tr)
                e = float((o - ref).abs().max())
                check(e <= KERNEL_ATOL, f"kernel {din}->{dout} rows {rows} tile {tr}: "
                                        f"max abs err {e}")
                tile_ms[tr] = graph_ms(lambda: fused_residual_block(*args, tile_rows=tr),
                                       reps=20, replays=3)
            p_ms = graph_ms(lambda: resblock_reference(*args), reps=20, replays=3)
            k_call_ms = cuda_ms(lambda: fused_residual_block(*args), reps=20)
            p_call_ms = cuda_ms(lambda: resblock_reference(*args), reps=20)
        bound_ms, bound_by = resblock_bound(rows, t_rows, din, dout, sc)
        on_path = net == "msr" and rows == ROWS
        row = {"net": net, "in": din, "out": dout, "shortcut": sc, "rows": rows,
               "t_rows": t_rows, "per_forward": per_forward if on_path else 0,
               "max_abs_err": err, "kernel_ms": k_ms, "tile_ms": tile_ms, "plain_ms": p_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "of_bound": bound_ms / k_ms,
               "library_ms": None, "kernel_call_ms": k_call_ms, "plain_call_ms": p_call_ms,
               **launch}
        per_shape.append(row)
        emit("kernel", **row)
        del x, t_proj, c_proj, args, out, ref

    # -- mega_kernel: the whole-UNet kernel against its plain version ----------
    nu_solver = Solver.from_checkpoint(NU_CKPT, task="nu_direct", backend="mega")
    nu_model = nu_solver.model
    mega_cases = [("msr", model, ROWS, torch.float32), ("msr", model, ROWS, torch.bfloat16),
                  ("nu", nu_model, 2 * NU_B, torch.float32),
                  ("nu", nu_model, 2 * NU_B, torch.bfloat16),
                  ("p256", p256_model, ROWS, torch.float32),
                  ("p256", p256_model, ROWS, torch.bfloat16),
                  ("msr", model, 1000, torch.float32), ("nu", nu_model, 1000, torch.bfloat16),
                  ("p256", p256_model, 1000, torch.float32),
                  ("p256", p256_model, 1000, torch.bfloat16)]
    mega_rows = []
    for net, net_model, rows, dtype in mega_cases:
        cd = None if dtype == torch.float32 else dtype
        y = torch.tensor(rng.normal(size=(rows, net_model.input_dim)), dtype=torch.float32,
                         device=dev).to(dtype)
        cond = torch.tensor(rng.uniform(0, 1, (rows, net_model.cond_dim)), dtype=torch.float32,
                            device=dev).to(dtype)
        mask = (torch.arange(rows, device=dev) >= rows // 2).to(dtype)[:, None]
        t = torch.full((1,), 0.37, device=dev).to(dtype)
        packed = mega.pack_params(net_model, dtype)
        with torch.no_grad():
            ys, sc, st = mega.mega_inputs(net_model, y, t, cond, mask, cd)
            out = mega.unet_forward_mega(net_model, y, t, cond, mask, cd, packed)
            torch.cuda.synchronize()
            launch = mega.last_launch()
            ref = mega.unet_forward_mega_reference(net_model, y, t, cond, mask, cd)
            scale = float(ref.abs().max())
            diff = (out - ref).abs()
            err, mean_err = float(diff.max()), float(diff.mean())
            check(bool(torch.isfinite(out).all()), f"finite mega output, {net} {dtype} {rows}")
            if cd is None:
                tol, mean_tol = FORWARD_RTOL * scale, None
            else:
                # bf16: the kernel may flip a rounding that the plain version
                # does not, but it must stay closer to the plain version than
                # bf16 rounding moves the plain version from float32.
                noise = (ref - mega.unet_forward_mega_reference(
                    net_model, y.float(), t.float(), cond.float(), mask.float())).abs()
                tol, mean_tol = float(noise.max()), BF16_MEAN_SHARE * float(noise.mean())
                check(mean_err <= mean_tol, f"mega {net} bf16 rows {rows}: mean abs err "
                                            f"{mean_err} > {mean_tol}")
                del noise
            check(err <= tol, f"mega {net} {dtype} rows {rows}: max abs err {err} > {tol}")
            big = rows > ROWS or (net == "p256" and rows >= ROWS)
            reps, replays = (3, 2) if big else (20, 3)
            k_ms = graph_ms(lambda: mega.launch_mega(packed, ys, sc, st), reps, replays)
            tile_ms = {tr: graph_ms(lambda: mega.launch_mega(packed, ys, sc, st, tr), reps,
                                    replays)
                       for tr in mega.TILE_ROWS[dtype]
                       if rows >= ROWS and mega.mega_smem_bytes(packed, dtype, tr) <= mega.SMEM_MAX}
            w_ms = graph_ms(lambda: mega.unet_forward_mega(net_model, y, t, cond, mask, cd,
                                                           packed), reps, replays)
            p_ms = graph_ms(lambda: mega.unet_forward_mega_reference(net_model, y, t, cond,
                                                                     mask, cd), reps, replays)
            call_ms = cuda_ms(lambda: mega.unet_forward_mega(net_model, y, t, cond, mask, cd,
                                                             packed), reps=10 if big else 20)
            # The plain bf16 backend (cuBLAS on a bf16 copy of the net): the
            # counterpart of JAX's xla_bf16, not a library call of this function.
            plain_bf16_ms = None
            if cd is not None:
                plain_bf16 = unet_apply_fn(net_model, "plain", compute_dtype=cd)
                plain_bf16_ms = graph_ms(lambda: plain_bf16(y, t, cond, mask), reps, replays)
                del plain_bf16
            del ref, out, diff
        bound_ms, bound_by = mega_bound(packed, rows)
        per_row, once, nbytes = mega_work(packed, rows)
        row = {"net": net, "dtype": str(dtype).replace("torch.", ""), "rows": rows,
               "max_abs_err": err, "tol": tol, "mean_abs_err": mean_err, "mean_tol": mean_tol,
               "out_max_abs": scale, "kernel_ms": k_ms, "tile_ms": tile_ms,
               "wrapper_ms": w_ms, "call_ms": call_ms, "plain_ms": p_ms,
               "plain_bf16_ms": plain_bf16_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "of_bound": bound_ms / k_ms, "library_ms": None,
               "macs_per_row": per_row, "batch1_macs": once, "bytes": nbytes, **launch}
        mega_rows.append(row)
        emit("mega_kernel", **row)
        torch.cuda.empty_cache()

    # -- forward: the checkpoint's full forward at 2B rows, every backend ------
    y = torch.tensor(rng.normal(size=(ROWS, 3)), dtype=torch.float32, device=dev)
    cond = torch.tensor(rng.uniform(0, 1, (ROWS, 3)), dtype=torch.float32, device=dev)
    mask = torch.cat([torch.zeros(ROWS // 2, 1), torch.ones(ROWS // 2, 1)]).to(dev)
    t = torch.full((1,), 0.37, device=dev)
    mega_apply = unet_apply_fn(model, "mega")
    with torch.no_grad():
        zero_counts()
        fused = unet_forward_fused(model, y, t, cond, mask)
        torch.cuda.synchronize()
        fwd_launches = resblock.LAUNCHES
        megafwd = mega_apply(y, t, cond, mask)
        torch.cuda.synchronize()
        mega_fwd_launches = mega.LAUNCHES
        plain = model(y, t, cond, mask)
        scale = float(plain.abs().max())
        fwd_err = float((fused - plain).abs().max())
        mega_fwd_err = float((megafwd - plain).abs().max())
        fused_fwd_ms = graph_ms(lambda: unet_forward_fused(model, y, t, cond, mask), reps=10)
        mega_fwd_ms = graph_ms(lambda: mega_apply(y, t, cond, mask), reps=10)
        plain_fwd_ms = graph_ms(lambda: model(y, t, cond, mask), reps=10)
        fused_call_ms = cuda_ms(lambda: unet_forward_fused(model, y, t, cond, mask), reps=20)
        mega_call_ms = cuda_ms(lambda: mega_apply(y, t, cond, mask), reps=20)
        plain_call_ms = cuda_ms(lambda: model(y, t, cond, mask), reps=20)
    check(fwd_launches == 27, f"27 fused launches per forward, counted {fwd_launches}")
    check(mega_fwd_launches == 1, f"1 mega launch per forward, counted {mega_fwd_launches}")
    check(bool(torch.isfinite(fused).all()) and bool(torch.isfinite(megafwd).all()),
          "finite forward")
    check(fwd_err <= FORWARD_RTOL * scale, f"fused forward max abs err {fwd_err} vs {scale}")
    check(mega_fwd_err <= FORWARD_RTOL * scale, f"mega forward max abs err {mega_fwd_err}")
    kernel_ms_per_fwd = sum(r["kernel_ms"] * r["per_forward"] for r in per_shape)
    emit("forward", rows=ROWS, launches=fwd_launches, mega_launches=mega_fwd_launches,
         max_abs_err=fwd_err, mega_max_abs_err=mega_fwd_err, out_max_abs=scale,
         fused_ms=fused_fwd_ms, mega_ms=mega_fwd_ms, plain_ms=plain_fwd_ms,
         kernel_ms_sum=kernel_ms_per_fwd, fused_call_ms=fused_call_ms,
         mega_call_ms=mega_call_ms, plain_call_ms=plain_call_ms)

    # -- MSR-3c serving: fused, mega, mega in bf16, plain ----------------------
    cfg = solver.config
    W = cfg["W"]
    X = rng.uniform(0, 1, (SERVE_B, 3)).astype(np.float32)
    g = torch.tensor(solver.task.unnormalize_x(X, cfg), dtype=torch.float32, device=dev)
    rate_opt = msr_sum_rate(waterfilling(g, W), g)

    def score(P: np.ndarray) -> float:
        check(P.shape == (SERVE_B, 3), f"solution shape {P.shape}")
        check(bool(np.isfinite(P).all()), "finite solutions")
        check(bool((P >= 0).all()), "p >= 0 on every row")
        gap = float(np.abs(P.sum(axis=1) - W).max())
        check(gap <= 1e-4 * W, f"|sum p - W| = {gap} on some row")
        p = torch.tensor(P, device=dev)
        return float((solver.task.objective(p, g, cfg) / rate_opt).mean())

    def serve(solve, seeds):
        """Requests timed on the host clock around a synchronize; the
        launches are counted from 0 over exactly these requests."""
        zero_counts()
        out = []
        for seed in seeds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            P = solve(seed)
            torch.cuda.synchronize()
            out.append({"seed": seed, "s": time.perf_counter() - t0, "P": P})
        return out, resblock.LAUNCHES, mega.LAUNCHES

    def rate_per_s(reqs, B):
        timed = [r["s"] for r in reqs[1:]] or [reqs[0]["s"]]   # request 0 warms up
        return B / float(np.median(timed))

    def public(reqs, metric):
        return [{"seed": r["seed"], "s": r["s"], metric: r[metric]} for r in reqs]

    fused_reqs, n_fused, n_mega = serve(lambda s: solver.solve(X, seed=s), range(2))
    check(n_fused == 2 * 2700 and n_mega == 0,
          f"fused path: 2,700 resblock launches per request and no mega, counted "
          f"{n_fused} and {n_mega}")
    for r in fused_reqs:
        r["ratio"] = score(r["P"])
        check(r["ratio"] >= 0.99, f"fused mean waterfilling ratio {r['ratio']} < 0.99")
    emit("serve", B=SERVE_B, T=solver.sched.T, omega=solver.task.default_omega,
         launches=n_fused, requests=public(fused_reqs, "ratio"),
         solutions_per_s=rate_per_s(fused_reqs, SERVE_B))

    mega_solver = Solver(solver.task, model, solver.sched, cfg, backend="mega")
    mega_reqs, n_fused, n_mega = serve(lambda s: mega_solver.solve(X, seed=s), range(3))
    check(n_mega == 3 * 100 and n_fused == 0,
          f"mega path: 100 mega launches per request and no resblock, counted {n_mega} "
          f"and {n_fused}")
    serve_msr_mega_launches = n_mega
    for r in mega_reqs:
        r["ratio"] = score(r["P"])
        check(r["ratio"] >= 0.99, f"mega mean waterfilling ratio {r['ratio']} < 0.99")
    for fr, mr in zip(fused_reqs, mega_reqs):
        check(abs(fr["ratio"] - mr["ratio"]) <= 1e-3,
              f"seed {fr['seed']}: fused ratio {fr['ratio']} vs mega {mr['ratio']}")
    emit("serve_msr_mega", B=SERVE_B, T=solver.sched.T, omega=solver.task.default_omega,
         launches=n_mega, requests=public(mega_reqs, "ratio"),
         solutions_per_s=rate_per_s(mega_reqs, SERVE_B),
         max_abs_power_diff_fused=float(np.abs(mega_reqs[0]["P"] - fused_reqs[0]["P"]).max()))

    bf16_apply = unet_apply_fn(model, "mega", compute_dtype=torch.bfloat16)
    cond_msr = torch.as_tensor(X, device=dev)

    @torch.inference_mode()
    def solve_bf16(seed, apply_fn=bf16_apply):
        gen = torch.Generator(device=dev).manual_seed(seed)
        flat = torch.randn((SERVE_B, solver.sched.T + 1, 3), generator=gen, device=dev)
        y0 = cfg_sample(apply_fn, solver.sched, cond_msr, solver.task.default_omega, 3,
                        init_noise=flat[:, 0], step_noise=flat[:, 1:].transpose(0, 1),
                        compute_dtype=torch.bfloat16)
        return solver.task.decode(y0, cfg).cpu().numpy()

    bf16_reqs, n_fused, n_mega = serve(solve_bf16, range(2))
    check(n_mega == 2 * 100 and n_fused == 0,
          f"mega bf16 path: 100 launches per request, counted {n_mega} and {n_fused}")
    serve_msr_bf16_launches = n_mega
    for r, fr in zip(bf16_reqs, mega_reqs):
        r["ratio"] = score(r["P"])
        check(r["ratio"] >= 0.99, f"bf16 mean waterfilling ratio {r['ratio']} < 0.99")
        check(abs(r["ratio"] - fr["ratio"]) <= 1e-3,
              f"seed {r['seed']}: bf16 ratio {r['ratio']} vs f32 mega {fr['ratio']}")
    bf16_ratios = [r["ratio"] for r in bf16_reqs]
    emit("serve_msr_mega_bf16", B=SERVE_B, T=solver.sched.T, omega=solver.task.default_omega,
         launches=n_mega, requests=public(bf16_reqs, "ratio"),
         solutions_per_s=rate_per_s(bf16_reqs, SERVE_B),
         f32_ratio_same_seeds=[r["ratio"] for r in mega_reqs[:2]])

    plain_solver = Solver(solver.task, model, solver.sched, cfg, backend="plain")
    plain_reqs, n_fused, n_mega = serve(lambda s: plain_solver.solve(X, seed=s), [1])
    check(n_fused == 0 and n_mega == 0, "the plain backend launches no kernel")
    plain_ratio = score(plain_reqs[0]["P"])
    check(abs(plain_ratio - fused_reqs[1]["ratio"]) <= 1e-3,
          f"fused ratio {fused_reqs[1]['ratio']} vs plain {plain_ratio}")
    emit("serve_msr_plain", B=SERVE_B, request_s=plain_reqs[0]["s"], ratio=plain_ratio,
         solutions_per_s=SERVE_B / plain_reqs[0]["s"],
         max_abs_power_diff_fused=float(np.abs(plain_reqs[0]["P"] - fused_reqs[1]["P"]).max()))
    del fused_reqs, mega_reqs, bf16_reqs, plain_reqs

    # -- serve_nu: NU DDIM-3 at B = 524,288 through the mega backend ------------
    ncfg = nu_solver.config
    XN = rng.uniform(0, 1, (NU_B, 6)).astype(np.float32)
    users = torch.tensor(nu_solver.task.unnormalize_x(XN, ncfg), dtype=torch.float32,
                         device=dev)

    def nu_score(S: np.ndarray) -> float:
        check(S.shape == (NU_B, 5), f"NU solution shape {S.shape}")
        check(bool(np.isfinite(S).all()), "finite NU solutions")
        xy = S[:, :2]
        check(bool(((xy >= 0) & (xy <= 400)).all()), "0 <= x, y <= 400 on every row")
        check(bool((S[:, 2:] >= 0).all()), "p >= 0 on every row")
        gap = float(np.abs(S[:, 2:].sum(axis=1) - 18.0).max())
        check(gap <= 1e-4 * 18.0, f"|sum p - 18| = {gap} on some row")
        return float(nu_rate(torch.tensor(S, device=dev), users).mean())

    def nu_solve(s_):
        return lambda seed: s_.solve(XN, omega=NU_OMEGA, sampler="ddim", n_steps=NU_STEPS,
                                     seed=seed)

    nu_reqs, n_fused, n_mega = serve(nu_solve(nu_solver), range(3))
    check(n_mega == 3 * NU_STEPS and n_fused == 0,
          f"NU path: {NU_STEPS} mega launches per request, counted {n_mega} and {n_fused}")
    serve_nu_launches = n_mega
    for r in nu_reqs:
        r["rate"] = nu_score(r["P"])
    nu_plain_solver = Solver(nu_solver.task, nu_model, nu_solver.sched, ncfg, backend="plain")
    nu_plain, _, _ = serve(nu_solve(nu_plain_solver), [0])
    nu_plain_rate = nu_score(nu_plain[0]["P"])
    rel = abs(nu_reqs[0]["rate"] - nu_plain_rate) / nu_plain_rate
    check(rel <= 1e-3, f"NU mean rate mega {nu_reqs[0]['rate']} vs plain {nu_plain_rate}")
    emit("serve_nu", B=NU_B, T=nu_solver.sched.T, steps=NU_STEPS, omega=NU_OMEGA,
         launches=n_mega, requests=public(nu_reqs, "rate"),
         solutions_per_s=rate_per_s(nu_reqs, NU_B), plain_s=nu_plain[0]["s"],
         plain_solutions_per_s=NU_B / nu_plain[0]["s"], plain_rate=nu_plain_rate,
         rel_rate_diff_plain=rel,
         max_abs_diff_plain=float(np.abs(nu_plain[0]["P"] - nu_reqs[0]["P"]).max()))
    del nu_reqs, nu_plain

    # -- nu_vs_jax: the card's end-to-end answer against the JAX package's -----
    ref_rng = np.random.default_rng(0)
    XJ = ref_rng.uniform(0, 1, (4096, 6)).astype(np.float32)
    init = ref_rng.normal(size=(4096, 5)).astype(np.float32)
    zero_counts()
    with torch.inference_mode():
        y0 = ddim_sample(unet_apply_fn(nu_model, "mega"), nu_solver.sched,
                         torch.tensor(XJ, device=dev), NU_OMEGA, 5, n_steps=NU_STEPS,
                         init_noise=torch.tensor(init, device=dev))
        dec = nu_solver.task.decode(y0, ncfg)
        rate = float(nu_rate(dec, torch.tensor(nu_solver.task.unnormalize_x(XJ, ncfg),
                                               dtype=torch.float32, device=dev)).mean())
    check(mega.LAUNCHES == NU_STEPS, f"nu_vs_jax: {NU_STEPS} mega launches, {mega.LAUNCHES}")
    rel = abs(rate - NU_JAX_MEAN_RATE) / NU_JAX_MEAN_RATE
    check(rel <= 1e-3, f"NU mean rate {rate} vs the JAX package's {NU_JAX_MEAN_RATE}")
    emit("nu_vs_jax", B=4096, mean_rate=rate, jax_mean_rate=NU_JAX_MEAN_RATE, rel_diff=rel)

    # -- serve_nu_bf16: the production row, bench.py:_production_row ------------
    nu_bf16_model = copy.deepcopy(nu_model).to(torch.bfloat16)
    nu_bf16_apply = {"mega": unet_apply_fn(nu_bf16_model, "mega"),
                     "plain": unet_apply_fn(nu_model, "plain", compute_dtype=torch.bfloat16)}
    cond_nu_bf16 = torch.tensor(XN, device=dev).to(torch.bfloat16)

    def production_y0(backend, cond, seed=None, init=None):
        if init is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            init = torch.randn((cond.shape[0], 5), generator=gen, device=dev,
                               dtype=torch.bfloat16)
        with torch.inference_mode():
            y0 = ddim_sample(nu_bf16_apply[backend], nu_solver.sched, cond, NU_OMEGA, 5,
                             n_steps=NU_STEPS, init_noise=init)
        check(y0.dtype == torch.bfloat16, f"{backend} bf16 DDIM state is {y0.dtype}")
        return y0

    def production_solve(backend):
        def solve(seed):
            y0 = production_y0(backend, cond_nu_bf16, seed)
            return nu_solver.task.decode(y0.float(), ncfg).cpu().numpy()
        return solve

    bf16_runs = {"mega": [], "plain": []}
    bf16_counts = {"mega": 0, "plain": 0}
    for turn in ("mega", "plain", "plain", "mega"):
        seeds = range(2) if not bf16_runs[turn] else range(2, 4)
        reqs, n_fused, n_mega = serve(production_solve(turn), seeds)
        want = 2 * NU_STEPS if turn == "mega" else 0
        check(n_mega == want and n_fused == 0,
              f"NU bf16 {turn}: {want} mega launches over 2 requests, counted {n_mega} "
              f"and {n_fused} resblock")
        bf16_counts[turn] += n_mega
        for r in reqs:
            r["rate"] = nu_score(r["P"])
        bf16_runs[turn] += reqs
    for m, pl in zip(bf16_runs["mega"], bf16_runs["plain"]):
        rel = abs(m["rate"] - pl["rate"]) / pl["rate"]
        check(rel <= 1e-3, f"NU bf16 seed {m['seed']}: mega rate {m['rate']} vs plain "
                           f"{pl['rate']}")
    serve_nu_bf16_launches = bf16_counts["mega"]
    # The JAX package's bf16 answer on the nu_vs_jax inputs.
    jax_rates = {}
    zero_counts()
    for backend in ("mega", "plain"):
        y0 = production_y0(backend, torch.tensor(XJ, device=dev).to(torch.bfloat16),
                           init=torch.tensor(init, device=dev).to(torch.bfloat16))
        dec = nu_solver.task.decode(y0.float(), ncfg)
        jax_rates[backend] = float(nu_rate(dec, torch.tensor(
            nu_solver.task.unnormalize_x(XJ, ncfg), dtype=torch.float32, device=dev)).mean())
        rel = abs(jax_rates[backend] - NU_JAX_BF16_MEAN_RATE) / NU_JAX_BF16_MEAN_RATE
        check(rel <= 1e-3, f"NU bf16 {backend} mean rate {jax_rates[backend]} vs the JAX "
                           f"package's {NU_JAX_BF16_MEAN_RATE}")
    check(mega.LAUNCHES == NU_STEPS, f"nu bf16 vs jax: {NU_STEPS} mega launches")
    emit("serve_nu_bf16", B=NU_B, T=nu_solver.sched.T, steps=NU_STEPS, omega=NU_OMEGA,
         launches=serve_nu_bf16_launches,
         requests={k: public(v, "rate") for k, v in bf16_runs.items()},
         mega_solutions_per_s=rate_per_s(bf16_runs["mega"], NU_B),
         plain_solutions_per_s=rate_per_s(bf16_runs["plain"], NU_B),
         jax_bf16_mean_rate=NU_JAX_BF16_MEAN_RATE, vs_jax_mean_rate=jax_rates,
         vs_jax_rel_diff={k: abs(v - NU_JAX_BF16_MEAN_RATE) / NU_JAX_BF16_MEAN_RATE
                          for k, v in jax_rates.items()})
    del bf16_runs, cond_nu_bf16

    # -- serve_msr_plain_bf16: the cuBLAS bf16 forward on MSR-3c -----------------
    plain_bf16_apply = unet_apply_fn(model, "plain", compute_dtype=torch.bfloat16)
    plain_bf16_reqs, n_fused, n_mega = serve(lambda s: solve_bf16(s, plain_bf16_apply), range(2))
    check(n_fused == 0 and n_mega == 0, "the plain bf16 backend launches no kernel")
    for r, mr in zip(plain_bf16_reqs, bf16_ratios):
        r["ratio"] = score(r["P"])
        check(r["ratio"] >= 0.99, f"plain bf16 mean waterfilling ratio {r['ratio']} < 0.99")
        check(abs(r["ratio"] - mr) <= 1e-3,
              f"seed {r['seed']}: plain bf16 ratio {r['ratio']} vs mega bf16 {mr}")
    emit("serve_msr_plain_bf16", B=SERVE_B, T=solver.sched.T, omega=solver.task.default_omega,
         requests=public(plain_bf16_reqs, "ratio"),
         solutions_per_s=rate_per_s(plain_bf16_reqs, SERVE_B), mega_bf16_ratios=bf16_ratios)
    del plain_bf16_reqs, plain_bf16_apply

    # -- serve_graph: one CUDA graph per bucket, against the same program eagerly -
    graph_rows = {}
    serve_graph_launches = {"fused": 0, "mega": 0}
    for backend, per_req in (("fused", 2700), ("mega", 100)):
        eager = Solver(solver.task, model, solver.sched, cfg, backend=backend,
                       buckets=(SERVE_B,), graphs=False)
        graphed = Solver(solver.task, model, solver.sched, cfg, backend=backend,
                         buckets=(SERVE_B,))
        t0 = time.perf_counter()
        with torch.inference_mode():
            graphed.warmup()
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        check(len(graphed._graphs) == 1, f"{backend}: one graph captured")
        captured = next(iter(graphed._graphs.values())).launches
        check(captured == ((per_req, 0) if backend == "fused" else (0, per_req)),
              f"{backend}: the graph captured {captured} launches, not {per_req}")
        runs = []
        for mode, s_ in (("eager", eager), ("graph", graphed), ("graph", graphed),
                         ("eager", eager)):
            reqs, n_fused, n_mega = serve(lambda seed: s_.solve(X, seed=seed), range(2))
            counted = n_fused if backend == "fused" else n_mega
            other = n_mega if backend == "fused" else n_fused
            check(counted == 2 * per_req and other == 0,
                  f"serve_graph {backend} {mode}: {per_req} launches per request, counted "
                  f"{counted} and {other}")
            serve_graph_launches[backend] += counted
            runs.append((mode, reqs))
        ref = {r["seed"]: r["P"] for r in runs[0][1]}
        for mode, reqs in runs:
            for r in reqs:
                check(np.array_equal(r["P"], ref[r["seed"]]),
                      f"serve_graph {backend}: {mode} seed {r['seed']} differs from eager")
        ratio = score(ref[0])
        check(ratio >= 0.99, f"serve_graph {backend} ratio {ratio}")
        graph_rows[backend] = {
            "capture_s": capture_s, "ratio": ratio,
            "runs": [{"mode": m, "solutions_per_s": rate_per_s(reqs, SERVE_B),
                      "request_s": [r["s"] for r in reqs]} for m, reqs in runs]}
        del eager, graphed, runs, ref
        torch.cuda.empty_cache()
    emit("serve_graph", B=SERVE_B, bucket=SERVE_B, T=solver.sched.T,
         omega=solver.task.default_omega, launches=serve_graph_launches, **graph_rows)

    # -- serve_best_of: best-of-4 with an omega mixture, mega f32 ----------------
    best_reqs, n_fused, n_mega = serve(
        lambda s: mega_solver.solve(X, omega=MSR_MIX, best_of=4, seed=s), [0, 0])
    check(n_mega == 2 * 4 * 100 and n_fused == 0,
          f"best-of-4: 4 x 100 mega launches per request, counted {n_mega} and {n_fused}")
    serve_best_of_launches = n_mega
    check(np.array_equal(best_reqs[0]["P"], best_reqs[1]["P"]), "best-of-4 is deterministic")
    with torch.inference_mode():
        single = mega_solver.solve(X, omega=MSR_MIX[0], seed=0)
        rate_best = solver.task.objective(torch.tensor(best_reqs[0]["P"], device=dev), g, cfg)
        rate_one = solver.task.objective(torch.tensor(single, device=dev), g, cfg)
    worse = int((rate_best < rate_one).sum())
    check(worse == 0, f"best-of-4 below its candidate 0 on {worse} rows")
    best_ratio, single_ratio = score(best_reqs[0]["P"]), score(single)
    emit("serve_best_of", B=SERVE_B, T=solver.sched.T, omega=MSR_MIX, best_of=4,
         launches=serve_best_of_launches, ratio=best_ratio, single_ratio_omega150=single_ratio,
         rows_improved=int((rate_best > rate_one).sum()),
         solutions_per_s=SERVE_B / best_reqs[1]["s"], request_s=[r["s"] for r in best_reqs])
    del best_reqs

    # -- serve_buckets: 1,000 real rows in a bucket of 1,024 vs unbucketed -------
    # Elementwise at JAX's bucket tolerance (rtol 1e-3, atol 1e-2; on MSR the
    # atol scaled by W / 400) where no guidance amplifies the statistics'
    # last bits: NU (DDIM-3, omega 0.125) and MSR at omega 0. At omega 500 a
    # row moves by up to 0.22 W on the CPU (ROADMAP Queue 3, item 3), so MSR
    # there is held by its mean waterfilling ratio, within 1e-3.
    bucket_rows = {}
    XB = rng.uniform(0, 1, (1000, 3)).astype(np.float32)
    gb = torch.tensor(solver.task.unnormalize_x(XB, cfg), dtype=torch.float32, device=dev)
    opt_b = msr_sum_rate(waterfilling(gb, W), gb)
    cases = [("nu", nu_solver, XN[:1000], {"omega": NU_OMEGA, "sampler": "ddim",
                                            "n_steps": NU_STEPS}, 1.0),
             ("msr_omega0", solver, XB, {"omega": 0.0}, W / 400.0),
             ("msr_omega500", solver, XB, {}, None)]
    for name, base, Xb, kw, atol_scale in cases:
        bucketed = Solver(base.task, base.model, base.sched, base.config, backend="mega",
                          buckets=(1024,))
        unbucketed = Solver(base.task, base.model, base.sched, base.config, backend="mega")
        a, b_ = bucketed.solve(Xb, seed=3, **kw), unbucketed.solve(Xb, seed=3, **kw)
        row = {"max_abs_diff": float(np.abs(a - b_).max()), "graphs": len(bucketed._graphs)}
        if atol_scale is None:
            row["ratios"] = [float((base.task.objective(torch.tensor(P, device=dev), gb, cfg)
                                    / opt_b).mean()) for P in (a, b_)]
        else:
            row["excess"] = float(np.max(np.abs(a - b_) - (1e-2 * atol_scale
                                                           + 1e-3 * np.abs(b_))))
        bucket_rows[name] = row
        del bucketed, unbucketed
    emit("serve_buckets", rows=1000, bucket=1024, **bucket_rows)
    for name, row in bucket_rows.items():
        check(row["graphs"] == 1, f"serve_buckets {name}: one graph for bucket 1,024")
        if "excess" in row:
            check(row["excess"] <= 0, f"serve_buckets {name}: bucketed vs unbucketed beyond "
                                      f"rtol 1e-3, atol 1e-2 (x W/400 on MSR): {row}")
        else:
            check(abs(row["ratios"][0] - row["ratios"][1]) <= 1e-3,
                  f"serve_buckets {name}: mean ratios {row['ratios']}")

    # -- kernels: one line per kernel ---------------------------------------------
    main_shapes = [r for r in per_shape if r["per_forward"]]
    bounds = {}
    for r in main_shapes:
        bounds[r["bound_by"]] = bounds.get(r["bound_by"], 0.0) + r["bound_ms"] * r["per_forward"]
    msr_f32 = mega_rows[0]
    print(json.dumps({"kernels": [
        {"name": "fused_residual_block", "route": "cuda", "source": RESBLOCK_SOURCE,
         "replaces": RESBLOCK_REPLACES, "launches": 2 * 2700 + serve_graph_launches["fused"],
         "max_abs_err": max(r["max_abs_err"] for r in per_shape),
         "ms": kernel_ms_per_fwd,
         "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in main_shapes),
         "bound_ms": sum(bounds.values()), "bound_by": max(bounds, key=bounds.get),
         "library_ms": None,
         "per": f"one MSR-3c forward: the 27 launches at {ROWS} rows; launches over the "
                f"2 fused serving requests and serve_graph's 8 fused requests (4 replayed)",
         "cases": [{k: r[k] for k in ("net", "in", "out", "shortcut", "rows", "per_forward",
                                      "variant", "tile_rows", "grid", "max_abs_err",
                                      "kernel_ms", "tile_ms", "plain_ms", "bound_ms",
                                      "bound_by")}
                   for r in per_shape]},
        {"name": "unet_forward_mega", "route": "cuda", "source": MEGA_SOURCE,
         "replaces": MEGA_REPLACES,
         "launches": (serve_msr_mega_launches + serve_msr_bf16_launches + serve_nu_launches
                      + serve_nu_bf16_launches + serve_graph_launches["mega"]
                      + serve_best_of_launches),
         "max_abs_err": max(r["max_abs_err"] for r in mega_rows),
         "ms": msr_f32["kernel_ms"], "plain_ms": msr_f32["plain_ms"],
         "bound_ms": msr_f32["bound_ms"], "bound_by": msr_f32["bound_by"], "library_ms": None,
         "per": f"one MSR-3c float32 forward at {ROWS} rows; launches over serve_msr_mega "
                f"({serve_msr_mega_launches}), serve_msr_mega_bf16 ({serve_msr_bf16_launches}), "
                f"serve_nu ({serve_nu_launches}), serve_nu_bf16 ({serve_nu_bf16_launches}), "
                f"serve_graph ({serve_graph_launches['mega']}) and serve_best_of "
                f"({serve_best_of_launches})",
         "cases": [{k: r[k] for k in ("net", "dtype", "rows", "tile_rows", "max_abs_err",
                                      "kernel_ms", "plain_ms", "plain_bf16_ms", "bound_ms",
                                      "bound_by")}
                   for r in mega_rows]},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``diffsg_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA (no JAX needed). It builds the CUDA kernels from
``diffsg_tpu_torch/csrc``, holds each kernel against its plain PyTorch
version at the shapes of the serving path, drives that path
(``serve.Solver`` on ``ckpts/ddpm_msr_3c_T100``: MSR-3c, T=100, omega=500)
and checks its answers. Every phase prints one JSON line with the seconds
since start; any failure raises and exits non-zero. The last three lines
are the ``kernels`` summary, the card's name and power limit as
``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "ckpts", "ddpm_msr_3c_T100")
T_START = time.perf_counter()

# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
ROWS = 16_384          # 2B rows of the CFG fold at B = 8,192
SERVE_B = 8_192
KERNEL_ATOL = 1e-4     # f32, TF32 off, summation order over <= 256 terms
FORWARD_RTOL = 1e-4    # of the output's max magnitude, through 27 blocks
RESBLOCK_REPLACES = "diffsg_tpu/ops/pallas_kernels.py:71"
RESBLOCK_SOURCE = "diffsg_tpu_torch/csrc/resblock.cu"


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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from diffsg_tpu_torch.baselines import waterfilling
    from diffsg_tpu_torch.models import unet_forward_fused
    from diffsg_tpu_torch.ops import _build, msr_sum_rate, resblock
    from diffsg_tpu_torch.ops.resblock import (fused_residual_block, resblock_params_tuple,
                                               resblock_reference)
    from diffsg_tpu_torch.serve import Solver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- device ---------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ----------------------------------------------------------------
    _build.library()
    ptxas = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", nvcc_s=_build.BUILD_SECONDS, cached=_build.BUILD_SECONDS is None,
         flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas)

    # -- kernel: every (in, out, shortcut) shape of the MSR-3c forward ----------
    solver = Solver.from_checkpoint(CKPT, task="msr", backend="fused")
    model = solver.model
    blocks = [m.res for m in model.down if hasattr(m, "res")]
    blocks += [model.middle.res1, model.middle.res2]
    blocks += [m.res for m in model.up if hasattr(m, "res")]
    check(len(blocks) == 27, f"27 residual blocks, found {len(blocks)}")
    shapes = {}
    for res in blocks:
        key = (res.lin1.kernel.shape[0], res.lin1.kernel.shape[1], res.shortcut is not None)
        shapes.setdefault(key, [res, 0])[1] += 1

    rng = np.random.default_rng(0)
    per_shape = []
    cases = [(key, ROWS, 1) for key in shapes] + [((256, 128, True), 1000, 1000)]
    for (din, dout, sc), rows, t_rows in cases:
        res, per_forward = shapes[(din, dout, sc)]
        x = torch.tensor(rng.normal(size=(rows, din)), dtype=torch.float32, device=dev)
        t_proj = torch.tensor(rng.normal(size=(t_rows, dout)), dtype=torch.float32, device=dev)
        c_proj = torch.tensor(rng.normal(size=(rows, dout)), dtype=torch.float32, device=dev)
        args = (x, t_proj, c_proj, *[p.detach() for p in resblock_params_tuple(res)
                                     if p is not None])
        with torch.no_grad():
            out = fused_residual_block(*args)
            torch.cuda.synchronize()
            ref = resblock_reference(*args)
            err = float((out - ref).abs().max())
            check(bool(torch.isfinite(out).all()), f"finite kernel output at {din}->{dout}")
            check(err <= KERNEL_ATOL, f"kernel {din}->{dout} rows {rows}: max abs err {err}")
            k_ms = graph_ms(lambda: fused_residual_block(*args))
            p_ms = graph_ms(lambda: resblock_reference(*args))
            k_call_ms = cuda_ms(lambda: fused_residual_block(*args))
            p_call_ms = cuda_ms(lambda: resblock_reference(*args))
        bound_ms, bound_by = resblock_bound(rows, t_rows, din, dout, sc)
        row = {"in": din, "out": dout, "shortcut": sc, "rows": rows, "t_rows": t_rows,
               "per_forward": per_forward if rows == ROWS else 0, "max_abs_err": err,
               "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "kernel_call_ms": k_call_ms, "plain_call_ms": p_call_ms}
        per_shape.append(row)
        emit("kernel", **row)

    # -- forward: the checkpoint's full forward at 2B rows, fused vs plain -----
    y = torch.tensor(rng.normal(size=(ROWS, 3)), dtype=torch.float32, device=dev)
    cond = torch.tensor(rng.uniform(0, 1, (ROWS, 3)), dtype=torch.float32, device=dev)
    mask = torch.cat([torch.zeros(ROWS // 2, 1), torch.ones(ROWS // 2, 1)]).to(dev)
    t = torch.full((1,), 0.37, device=dev)
    with torch.no_grad():
        before = resblock.LAUNCHES
        fused = unet_forward_fused(model, y, t, cond, mask)
        torch.cuda.synchronize()
        fwd_launches = resblock.LAUNCHES - before
        plain = model(y, t, cond, mask)
        scale = float(plain.abs().max())
        fwd_err = float((fused - plain).abs().max())
        fused_fwd_ms = graph_ms(lambda: unet_forward_fused(model, y, t, cond, mask), reps=10)
        plain_fwd_ms = graph_ms(lambda: model(y, t, cond, mask), reps=10)
        fused_call_ms = cuda_ms(lambda: unet_forward_fused(model, y, t, cond, mask), reps=20)
        plain_call_ms = cuda_ms(lambda: model(y, t, cond, mask), reps=20)
    check(fwd_launches == 27, f"27 kernel launches per forward, counted {fwd_launches}")
    check(bool(torch.isfinite(fused).all()), "finite forward")
    check(fwd_err <= FORWARD_RTOL * scale, f"forward max abs err {fwd_err} vs scale {scale}")
    kernel_ms_per_fwd = sum(r["kernel_ms"] * r["per_forward"] for r in per_shape)
    emit("forward", rows=ROWS, launches=fwd_launches, max_abs_err=fwd_err, out_max_abs=scale,
         fused_ms=fused_fwd_ms, plain_ms=plain_fwd_ms, kernel_ms_sum=kernel_ms_per_fwd,
         fused_call_ms=fused_call_ms, plain_call_ms=plain_call_ms)

    # -- serve: the main path, Solver.solve on the card ------------------------
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

    resblock.LAUNCHES = 0
    requests = []
    for seed in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P = solver.solve(X, seed=seed)
        torch.cuda.synchronize()
        requests.append({"seed": seed, "s": time.perf_counter() - t0})
        last_P = P
        requests[-1]["ratio"] = score(P)
    serve_launches = resblock.LAUNCHES
    check(serve_launches == 3 * 2700, f"2,700 launches per request, counted {serve_launches}")
    for r in requests:
        check(r["ratio"] >= 0.99, f"mean waterfilling ratio {r['ratio']} < 0.99")

    plain_solver = Solver.from_checkpoint(CKPT, task="msr", backend="plain")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P_plain = plain_solver.solve(X, seed=2)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_ratio = score(P_plain)
    check(abs(plain_ratio - requests[-1]["ratio"]) <= 1e-3,
          f"fused ratio {requests[-1]['ratio']} vs plain {plain_ratio}")
    timed = [r["s"] for r in requests[1:]]   # request 0 is the warm one
    emit("serve", B=SERVE_B, T=solver.sched.T, omega=solver.task.default_omega,
         launches=serve_launches, requests=requests,
         solutions_per_s=SERVE_B / float(np.median(timed)),
         plain_s=plain_s, plain_solutions_per_s=SERVE_B / plain_s, plain_ratio=plain_ratio,
         max_abs_power_diff_plain=float(np.abs(P_plain - last_P).max()))

    # -- kernels: one line per kernel, per forward of the serving path ---------
    main = [r for r in per_shape if r["per_forward"]]
    bounds = {}
    for r in main:
        bounds[r["bound_by"]] = bounds.get(r["bound_by"], 0.0) + r["bound_ms"] * r["per_forward"]
    print(json.dumps({"kernels": [{
        "name": "fused_residual_block", "route": "cuda", "source": RESBLOCK_SOURCE,
        "replaces": RESBLOCK_REPLACES, "launches": serve_launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        "max_err": max(r["max_abs_err"] for r in per_shape),
        "ms": kernel_ms_per_fwd,
        "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in main),
        "bound_ms": sum(bounds.values()), "bound_by": max(bounds, key=bounds.get),
        "library_ms": None,
        "per": f"one forward: the 27 launches at {ROWS} rows"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

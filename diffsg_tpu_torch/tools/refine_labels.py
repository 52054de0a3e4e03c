"""Hybrid-oracle data engine: refine NU training labels in place.

Counterpart of the JAX package's ``tools/refine_labels.py``, with its flags
and its functions' signatures; ``--cpu`` runs on the CPU (the default is the
CUDA card). Every training label is replaced by the best of {the label, N
random feasible starts} after ``--iters`` steps of
``ops.refine.projected_refine`` on the exact NOMA-SIC rate. The CSV formats
stay: 13 columns (``make_datasets nu-budget``: a per-row budget), 12 (the
reference's fixed-budget layout: ``--p-indist``) and 15 (``nu-geo``: per-row
W and H columns drive a per-row projection and preconditioner). The output
is written in the same format: the label and rate columns refined, every
other column passed through.

Expert iteration (``--model-seed CKPT``): the previous generation's own
refined single draw becomes the label wherever its rate is within
``--tie-eps`` (relative) of the multistart best, so rows keep the basin the
network already represents.

The CSVs are read with NumPy. Random starts: unit-uniform draws (B, 2+K)
per start from one ``torch.Generator`` seeded by ``--seed`` on the run's
device; ``refine_rows(starts=...)`` also takes them as a tensor.

    python -m diffsg_tpu_torch.tools.refine_labels --iters 300 --starts 16 \\
        --budget-in datasets/3u_budget9-36_10000samples.csv \\
        --budget-out datasets/3u_budget9-36_10000samples_refined.csv --skip-indist
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Union

import numpy as np
import torch

from ..data.loaders import _read_csv
from ..device import DeviceLike, resolve_device
from ..ops.decoders import msr_simplex_project
from ..ops.objectives import nu_rate
from ..ops.refine import best_of_starts, projected_refine, random_starts
from ..tasks import TASKS, merge_ckpt_config, sample_solutions
from ..utils import load_checkpoint
from ._cli import add_device_args, device_from_args, reference_csv


def refine_rows(coords, Y0, P_row, iters, starts: Union[int, torch.Tensor], seed, width, height,
                model_Y0=None, tie_eps=0.0, device: DeviceLike = "cuda"):
    """Refine labels ``Y0`` (B, 2+K) for users ``coords`` (B, 2K) under
    per-row budgets ``P_row`` (B,). ``width``/``height`` are scalars or
    per-row (B,) arrays (mixed-geometry 15-col CSVs). ``starts``: the
    number of random starts, drawn (B, 2+K) unit-uniform a start from a
    ``torch.Generator`` seeded by ``seed``; or those draws themselves, a
    tensor (n, B, 2+K). ``model_Y0`` (B, 2+K), if given, is a feasible draw
    from the previous-generation model; its refined result is preferred over
    the multistart best whenever within ``tie_eps`` (relative) of it.
    Returns (Y_best, rate_best, frac_model) as float64, ``frac_model`` the
    fraction of rows labeled from the model's basin (0.0 without
    ``model_Y0``)."""
    dev = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    coords = f32(coords)
    P_col = f32(P_row).reshape(-1, 1)
    B, K = coords.shape[0], Y0.shape[1] - 2
    WH = torch.stack([f32(np.broadcast_to(np.asarray(width, np.float32), (B,))),
                      f32(np.broadcast_to(np.asarray(height, np.float32), (B,)))], dim=1)

    def obj(Y):
        return nu_rate(Y, coords)

    def proj(Y):
        xy = torch.minimum(torch.clamp(Y[:, :2], min=0.0), WH)
        return torch.cat([xy, msr_simplex_project(Y[:, 2:], P_col)], dim=1)

    precond = torch.cat([WH * 0.02, (P_col * 0.02).repeat(1, K)], dim=1)

    def refine(Y):
        return projected_refine(obj, proj, Y, iters, 1.0, higher_is_better=True,
                                precond=precond)

    starts_Y = random_starts(starts, proj, WH, (B, 2 + K), seed, dev)
    best, best_r = best_of_starts(refine, obj, starts_Y, refine(f32(Y0)))
    frac_model = 0.0
    if model_Y0 is not None:
        Ym = refine(proj(f32(model_Y0)))
        rm = obj(Ym)
        # Keep the network's own (representable) basin unless the multistart
        # best beats it by more than the tolerance.
        take_m = rm >= (1.0 - tie_eps) * torch.maximum(rm, best_r)
        best = torch.where(take_m[:, None], Ym, best)
        best_r = torch.where(take_m, rm, best_r)
        frac_model = float(take_m.float().mean())

    def f64(t):
        return t.detach().cpu().numpy().astype(np.float64)

    return f64(best), f64(best_r), frac_model


def model_draws(coords, P_row, model_ckpt, omega, width, height, seed=0,
                device: DeviceLike = "cuda"):
    """One decoded draw of the previous-generation conditioned model for
    every raw row. The task is read from the checkpoint's metadata:
    ``nu_budget`` samples per budget group (its decode needs a scalar
    ``P_sum`` per call), ``nu_geo`` every row in one call (its decode is
    per row; ``width``/``height`` may be per-row arrays). Returns feasible
    physical solutions (B, 2+K), float64."""
    ck = load_checkpoint(model_ckpt, device=device)
    task_name = (ck.get("metadata") or {}).get("task", "nu_budget")
    task = TASKS[task_name]
    p_ref, w_ref, h_ref = 18.0, 400.0, 400.0
    B = coords.shape[0]
    P = np.asarray(P_row, float)
    W = np.broadcast_to(np.asarray(width, float), (B,))
    H = np.broadcast_to(np.asarray(height, float), (B,))
    X = coords.astype(float).copy()
    X[:, 0::2] /= W[:, None]
    X[:, 1::2] /= H[:, None]

    if task_name == "nu_geo":
        X = np.concatenate([X, P[:, None] / p_ref, W[:, None] / w_ref, H[:, None] / h_ref],
                           axis=1)
        config = {"K": 3, "p_ref": p_ref, "w_ref": w_ref, "h_ref": h_ref}
        merge_ckpt_config(config, ck.get("metadata"))
        dec, _ = sample_solutions(task, ck["params"], ck["sched"], X, config, omega=omega,
                                  batch_size=4096, seed=seed)
        return np.asarray(dec, np.float64)

    assert task_name == "nu_budget", f"unsupported model-seed task {task_name}"
    assert np.ptp(W) == 0 and np.ptp(H) == 0, (
        "a nu_budget model seed needs a fixed geometry; use a nu_geo checkpoint for "
        "mixed-geometry (15-col) inputs")
    X = np.concatenate([X, P[:, None] / p_ref], axis=1)
    out = np.empty((B, 5), np.float64)
    for p in np.unique(P):
        idx = np.nonzero(P == p)[0]
        config = {"width": float(W[0]), "height": float(H[0]), "K": 3, "P_sum": float(p),
                  "p_ref": p_ref}
        merge_ckpt_config(config, ck.get("metadata"))
        dec, _ = sample_solutions(task, ck["params"], ck["sched"], X[idx], config, omega=omega,
                                  batch_size=4096, seed=seed)
        out[idx] = np.asarray(dec, np.float64)
    return out


def process(path_in, path_out, iters, starts, seed, width, height, P_fixed, model_ckpt=None,
            model_omega=0.5, tie_eps=0.004, device: DeviceLike = "cuda"):
    """Refine one CSV into ``path_out`` (``%.18e``, as the JAX CLI writes);
    returns the stats line."""
    raw = _read_csv(path_in)
    ncol = raw.shape[1]
    assert ncol in (12, 13, 15), f"unexpected column count {ncol} in {path_in}"
    coords, Y0 = raw[:, :6], raw[:, 6:11]
    if ncol == 12:
        assert P_fixed is not None, (
            f"{path_in} has no budget column (12-col reference format); pass its fixed "
            "budget via --p-indist")
        P_row = np.full(raw.shape[0], float(P_fixed))
    else:
        P_row = raw[:, 12]
    if ncol == 15:  # mixed-geometry (nu-geo) format: per-row W/H columns
        width, height = raw[:, 13], raw[:, 14]
    old_rate = raw[:, 11]

    m_Y0 = (None if model_ckpt is None else
            model_draws(coords, P_row, model_ckpt, model_omega, width, height, seed=seed,
                        device=device))
    Y, R, frac_model = refine_rows(coords, Y0, P_row, iters, starts, seed, width, height,
                                   model_Y0=m_Y0, tie_eps=tie_eps, device=device)
    out = raw.copy()
    out[:, 6:11] = Y
    out[:, 11] = R
    np.savetxt(path_out, out, delimiter=",", fmt="%.18e")
    # Broken source labels (an all-zero row or a NaN rate from a degenerate
    # user triangle) are rebuilt from the random starts: keep them out of
    # the ratio statistics.
    ok = np.isfinite(old_rate) & (old_rate > 0)
    ratio = R[ok] / old_rate[ok]
    return {"file": str(path_out), "rows": int(raw.shape[0]),
            "mean_ratio": float(np.mean(ratio)), "min_ratio": float(np.min(ratio)),
            "frac_improved": float(np.mean(R[ok] > old_rate[ok] + 1e-12)),
            "repaired_rows": int((~ok).sum()), "frac_model_basin": frac_model}


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--starts", type=int, default=16,
                    help="random multi-starts per row (label seed always on)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--budget-in", default="datasets/3u_budget9-36_10000samples.csv")
    ap.add_argument("--budget-out", default="datasets/3u_budget9-36_10000samples_refined.csv")
    ap.add_argument("--indist-in", default=reference_csv("3u_18mW_10000samples.csv"))
    ap.add_argument("--indist-out", default="datasets/3u_18mW_10000samples_refined.csv")
    ap.add_argument("--skip-indist", action="store_true",
                    help="refine only --budget-in (e.g. the 15-col mixed-geometry CSV, which "
                         "has no companion fixed-config file)")
    ap.add_argument("--p-indist", type=float, default=18.0)
    ap.add_argument("--model-seed", default=None,
                    help="previous-generation nu_budget ckpt dir; its refined single draw "
                         "becomes the preferred label within --tie-eps of the multistart "
                         "best (expert iteration)")
    ap.add_argument("--model-omega", type=float, default=0.5)
    ap.add_argument("--tie-eps", type=float, default=0.004)
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    dev = device_from_args(args)
    pairs = [(args.budget_in, args.budget_out, None)]
    if not args.skip_indist:
        pairs.append((args.indist_in, args.indist_out, args.p_indist))
    out = []
    for src, dst, pfix in pairs:
        out.append(process(src, dst, args.iters, args.starts, args.seed, 400.0, 400.0, pfix,
                           model_ckpt=args.model_seed, model_omega=args.model_omega,
                           tie_eps=args.tie_eps, device=dev))
        print(json.dumps(out[-1]), flush=True)
    return out


if __name__ == "__main__":
    main()

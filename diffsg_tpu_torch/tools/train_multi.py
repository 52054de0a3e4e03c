"""Train the multi-task DDPM, one denoiser for MSR, CO and NU, and evaluate
its faces.

Counterpart of the JAX package's ``tools/train_multi.py``, with its flags
and the eval sets as flags of their own; ``--cpu`` runs on the CPU, and the
default is the CUDA card. The training sets are embedded into the shared
canvas (``tasks/multi.py``); the task's identity rides in the condition's
one-hot, and each subtask keeps its own label recipe:

* MSR-3c: the reference CSV, labels centered and scaled (y_shift W/M,
  y_scale 3), decoded by ``msr_wf``'s projection;
* CO: the 50,000-row oracle CSV, raw allocation shares, decoded by the
  ranked decision;
* NU (``--nu-mode budget``): the multi-budget CSV and the 18 mW reference
  training split, rigid-motion augmented, centered per column, y_scale 8,
  payload ``[coords | P / p_ref]`` (face ``multi_nu``); ``--nu-mode geo``:
  the ``nu_geo`` recipe's mixture (mixed-geometry CSVs, the multi-budget
  CSV at 400 m, the reference split), payload ``[coords | P / p_ref | W /
  w_ref | H / h_ref]`` (face ``multi_nu_geo``);
* ``--with-msr80`` / ``--with-msr8``: the W-conditioned waterfilling recipe
  at M = 80 and M = 8 on an 80-wide (8-wide) canvas, payload ``[gains |
  W / w_ref]``, the eval budgets left out of the training grids (faces
  ``multi_msr80``, ``multi_msr8``).

The per-subtask label transforms go into the checkpoint's metadata under
``subtask_configs``; ``merge_multi_config`` merges them back at eval. The
zoo (``ckpts/ddpm_multi_zoo``):

    python -m diffsg_tpu_torch.tools.train_multi --nu-mode geo --with-msr80 \\
        --with-msr8 --proj-dim 256 --dims 256 128 64 32 --lr 5e-4 \\
        --milestones 90 160 --grad-clip 0.25 --parameterization x0 \\
        --out build/ddpm_multi_zoo
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
from typing import Dict, List, Optional

import numpy as np

from ._cli import add_device_args, reference_csv


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--msr-dataset", default=reference_csv("3c_10w_10000samples.csv"))
    ap.add_argument("--co-dataset", default="datasets/3nodes_50000samples_new.csv")
    ap.add_argument("--nu-dataset", default=reference_csv("3u_18mW_10000samples.csv"))
    ap.add_argument("--nu-budget-dataset", default="datasets/3u_budget9-36_10000samples.csv",
                    help="13-column multi-budget oracle CSV (make_datasets nu-budget)")
    ap.add_argument("--nu-mode", choices=["budget", "geo"], default="budget",
                    help="'budget': coordinates and P / p_ref (face multi_nu); 'geo': the "
                         "whole nu_geo condition (face multi_nu_geo)")
    ap.add_argument("--nu-geo-datasets", nargs="+",
                    default=["datasets/3u_geo200-600_10000samples.csv",
                             "datasets/3u_geo_focus320-480_15000samples.csv",
                             "datasets/3u_18mW400_fresh4000_geo.csv"],
                    help="15-column mixed-geometry CSVs for --nu-mode geo")
    ap.add_argument("--nu-ref-repeat", type=int, default=4,
                    help="geo mode: repeat factor for the 18 mW reference training rows")
    ap.add_argument("--nu-budget-repeat", type=int, default=3,
                    help="geo mode: repeat factor for the 400x400 multi-budget rows")
    ap.add_argument("--msr-repeat", type=int, default=14,
                    help="repeat the MSR training rows to balance the classes")
    ap.add_argument("--co-repeat", type=int, default=3,
                    help="repeat the CO training rows to balance the classes")
    ap.add_argument("--nu-times", type=int, default=5,
                    help="rigid-motion augmentation copies for NU")
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--lr", type=float, default=4e-3)
    ap.add_argument("--milestones", type=int, nargs="+", default=[80, 150])
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--parameterization", choices=["eps", "x0"], default="eps",
                    help="the denoiser's target: eps (the reference's) or x0")
    ap.add_argument("--proj-dim", type=int, default=128)
    ap.add_argument("--dims", type=int, nargs="+", default=[64, 32, 16, 8])
    ap.add_argument("--canvas-dim", type=int, default=None,
                    help="shared solution-canvas width (default 5; 80 with --with-msr80)")
    ap.add_argument("--with-msr80", action="store_true",
                    help="add an 'msr80' slot: the W-conditioned 80-channel waterfilling "
                         "recipe (canvas 80, payload 81)")
    ap.add_argument("--msr80-samples", type=int, default=250000)
    ap.add_argument("--msr80-channels", type=int, default=80)
    ap.add_argument("--msr80-w-min", type=float, default=5.0)
    ap.add_argument("--msr80-w-max", type=float, default=45.0)
    ap.add_argument("--msr80-w-step", type=float, default=2.5)
    ap.add_argument("--msr80-exclude-budgets", type=float, nargs="*", default=[20.0, 40.0])
    ap.add_argument("--msr80-y-scale", type=float, default=8.0)
    ap.add_argument("--with-msr8", action="store_true",
                    help="add an 'msr8' slot: the same recipe at M = 8")
    ap.add_argument("--msr8-samples", type=int, default=100000)
    ap.add_argument("--msr8-exclude-budgets", type=float, nargs="*", default=[10.0, 20.0])
    ap.add_argument("--out", default="ckpts/ddpm_multi")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-eval", action="store_true")
    # The eval sets (the JAX CLI names them in its code).
    ap.add_argument("--msr-ood", default=reference_csv("3c_20w_2000samples_ood.csv"))
    ap.add_argument("--co-ood", default=reference_csv("3nodes_2000samples_ood.csv"))
    ap.add_argument("--nu-ood", default=reference_csv("3u_30mW_1000samples_ood.csv"))
    ap.add_argument("--msr80-evals", nargs="+", default=["datasets/80c_20w_wf_10000samples.csv",
                                                         "datasets/80c_40w_wf_2000samples_ood.csv"])
    ap.add_argument("--msr8-evals", nargs="+", default=["datasets/8c_10w_wf_10000samples.csv",
                                                        "datasets/8c_20w_wf_2000samples_ood.csv"])
    ap.add_argument("--nu-geo-evals", nargs="+",
                    default=["datasets/3u_geo480x360_21mW_1000samples.csv",
                             "datasets/3u_geo600x600_33mW_500samples.csv",
                             "datasets/3u_geo200x200_12mW_500samples.csv"],
                    help="geo mode: NU eval sets named '..._geo<W>x<H>_<P>mW_...'")
    add_device_args(ap)
    return ap.parse_args(argv)


def geo_load_kw(path: str) -> Dict[str, float]:
    """The field and budget an NU eval file's name gives: ``geo<W>x<H>_<P>mW``."""
    m = re.search(r"geo(\d+(?:\.\d+)?)x(\d+(?:\.\d+)?)_(\d+(?:\.\d+)?)mW",
                  pathlib.Path(path).name)
    if m is None:
        raise ValueError(f"{path}: the name gives no field and budget (geo<W>x<H>_<P>mW)")
    return {"width": float(m[1]), "height": float(m[2]), "P_sum": float(m[3])}


def eval_sets(args: argparse.Namespace):
    """(face, slot, path, load_kw) per eval set, in the JAX CLI's order."""
    evals = []
    if args.with_msr80:     # both 80c eval budgets are left out of msr80's grid
        evals += [("multi_msr80", "msr80", p, {}) for p in args.msr80_evals]
    if args.with_msr8:      # both 8c eval budgets are left out of msr8's grid
        evals += [("multi_msr8", "msr8", p, {}) for p in args.msr8_evals]
    evals += [("multi_msr", "msr", args.msr_dataset, {}), ("multi_msr", "msr", args.msr_ood, {}),
              ("multi_co", "co", args.co_dataset, {}), ("multi_co", "co", args.co_ood, {})]
    if args.nu_mode == "geo":   # every one an unseen (budget, W, H)
        evals += [("multi_nu_geo", "nu_geo", args.nu_dataset, {}),
                  ("multi_nu_geo", "nu_geo", args.nu_ood, {})]
        evals += [("multi_nu_geo", "nu_geo", p, geo_load_kw(p)) for p in args.nu_geo_evals]
    else:
        evals += [("multi_nu", "nu", args.nu_dataset, {}), ("multi_nu", "nu", args.nu_ood, {})]
    return evals


def main(argv: Optional[List[str]] = None) -> None:
    from ..data.datasets import value_grid, wf_budget_rows
    from ..data.generators import nu_dataset_extension
    from ..data.loaders import MSR_W_REF, NU_P_REF, TRAIN_RATIO, load_co, load_msr, load_nu
    from ..tasks import TASKS, evaluate
    from ..tasks.multi import (D_UNI, PAYLOAD, SLOTS, embed_cond_np, embed_y_np,
                               merge_multi_config, unet_multi)
    from ._cli import device_from_args, ensure_inputs, read_rows, train_and_save
    from .train_nu_budget import load_budget_rows, normalize_rows
    from .train_nu_geo import assemble_training_rows, augment_geo, normalize_rows_geo

    args = parse_args(argv)
    dev = device_from_args(args)
    ensure_inputs([args.co_dataset] + ([] if args.skip_eval else
                                       [p for _, _, p, _ in eval_sets(args)]))
    slots = (tuple(SLOTS) + (("msr80",) if args.with_msr80 else ())
             + (("msr8",) if args.with_msr8 else ()))
    if args.with_msr80 and args.canvas_dim is None:
        args.canvas_dim = args.msr80_channels
    if args.with_msr8 and (args.canvas_dim or D_UNI) < 8:
        args.canvas_dim = 8
    canvas = args.canvas_dim or D_UNI
    payload = (args.msr80_channels + 1) if args.with_msr80 else PAYLOAD

    def embed_x(X, slot):
        return embed_cond_np(X, slot, slots=slots, payload_dim=payload)

    def embed_y(Y):
        return embed_y_np(Y, canvas_dim=canvas)

    subtask_configs = {}
    parts_X, parts_Y = [], []

    # MSR: centered and scaled labels, the ddpm_msr_3c_wf recipe.
    msr = load_msr(args.msr_dataset)
    W, M = msr.config["W"], msr.config["M"]
    msr_shift, msr_scale = W / M, 3.0
    Xm = np.tile(msr.X_train, (args.msr_repeat, 1))
    Ym = np.tile((msr.Y_train - msr_shift) * msr_scale, (args.msr_repeat, 1))
    parts_X.append(embed_x(Xm.astype(np.float32), "msr"))
    parts_Y.append(embed_y(Ym.astype(np.float32)))
    # The whole physics config and the label transforms: the Solver serves
    # the face from the checkpoint alone.
    subtask_configs["msr"] = {**msr.config, "y_scale": msr_scale, "y_shift": msr_shift}
    print(f"msr rows: {len(Xm)} (x{args.msr_repeat})")

    # CO: raw shares (the eps ddpm_co recipe).
    co = load_co(args.co_dataset)
    Xc = np.tile(co.X_train, (args.co_repeat, 1))
    Yc = np.tile(co.Y_train, (args.co_repeat, 1))
    parts_X.append(embed_x(Xc.astype(np.float32), "co"))
    parts_Y.append(embed_y(Yc.astype(np.float32)))
    subtask_configs["co"] = dict(co.config)
    print(f"co rows: {len(Xc)} (x{args.co_repeat})")

    # The wide MSR slots: the W-conditioned waterfilling recipe.
    wide_msr = []
    if args.with_msr80:
        wide_msr.append(("msr80", args.msr80_channels, args.msr80_samples,
                         args.msr80_exclude_budgets))
    if args.with_msr8:
        wide_msr.append(("msr8", 8, args.msr8_samples, args.msr8_exclude_budgets))
    for si, (slot_w, Mw, n_w, excl_w) in enumerate(wide_msr):
        grid = value_grid(args.msr80_w_min, args.msr80_w_max, args.msr80_w_step, excl_w)
        Xw, Yw_t, mn_w, mx_w = wf_budget_rows(np.random.default_rng(args.seed + 100 + si), n_w,
                                              Mw, grid, args.msr80_y_scale)
        parts_X.append(embed_x(Xw.astype(np.float32), slot_w))
        parts_Y.append(embed_y(Yw_t.astype(np.float32)))
        subtask_configs[slot_w] = {"M": Mw, "W": MSR_W_REF, "w_ref": MSR_W_REF,
                                   "scaler_min": mn_w, "scaler_max": mx_w,
                                   "y_scale": args.msr80_y_scale}
        print(f"{slot_w} rows: {len(Xw)} over {len(grid)} budgets {grid[0]}..{grid[-1]} W "
              f"(excluded: {excl_w})")

    # NU: budget- or geometry-conditioned.
    if args.nu_mode == "geo":
        # The nu_geo recipe: mixed-geometry rows, the 400x400 multi-budget
        # rows and the reference 18 mW training split, augmented per (W, H)
        # group, normalized per row (train_nu_geo's helpers).
        base = assemble_training_rows(
            args.nu_geo_datasets, budget_path=args.nu_budget_dataset,
            indist_path=args.nu_dataset, train_ratio=TRAIN_RATIO,
            budget_repeat=args.nu_budget_repeat, ref_repeat=args.nu_ref_repeat)
        rows = np.concatenate([base, augment_geo(base, times=args.nu_times, seed=args.seed)])
        Xn, Yn = normalize_rows_geo(rows)
        nu_shift, nu_scale = Yn.mean(axis=0), 8.0
        parts_X.append(embed_x(Xn.astype(np.float32), "nu"))
        parts_Y.append(embed_y(((Yn - nu_shift) * nu_scale).astype(np.float32)))
        subtask_configs["nu_geo"] = {
            "K": 3, "P_sum": 18.0, "width": 400.0, "height": 400.0, "p_ref": NU_P_REF,
            "w_ref": 400.0, "h_ref": 400.0, "y_scale": nu_scale,
            "y_shift": [float(v) for v in nu_shift]}
        print(f"nu rows: {len(Xn)} ({len(base)} base x{args.nu_times + 1}, "
              "geometry+budget-conditioned)")
    else:
        nu = load_nu(args.nu_dataset)
        w, h, p_ref = nu.config["width"], nu.config["height"], NU_P_REF
        raw_b = load_budget_rows(args.nu_budget_dataset, w, h)
        raw_i = read_rows(args.nu_dataset, 12)
        raw_i = raw_i[: int(raw_i.shape[0] * TRAIN_RATIO)]     # the training split
        raw_i = np.concatenate([raw_i, np.full((raw_i.shape[0], 1), nu.config["P_sum"])], axis=1)
        base = np.concatenate([raw_b, raw_i])
        rows = np.concatenate([base, nu_dataset_extension(base, times=args.nu_times,
                                                          seed=args.seed)])
        Xn, Yn = normalize_rows(rows, w, h, p_ref)
        nu_shift, nu_scale = Yn.mean(axis=0), 8.0
        parts_X.append(embed_x(Xn.astype(np.float32), "nu"))
        parts_Y.append(embed_y(((Yn - nu_shift) * nu_scale).astype(np.float32)))
        subtask_configs["nu"] = {**nu.config, "p_ref": p_ref, "y_scale": nu_scale,
                                 "y_shift": [float(v) for v in nu_shift]}
        print(f"nu rows: {len(Xn)} ({len(base)} base x{args.nu_times + 1}, "
              "budget-conditioned)")

    X = np.concatenate(parts_X)
    Y = np.concatenate(parts_Y)
    print(f"total train rows: {len(X)} (cond {X.shape[1]}, canvas {Y.shape[1]})")

    model = unet_multi(args.proj_dim, tuple(args.dims), canvas_dim=canvas, payload_dim=payload,
                       n_slots=len(slots))
    cfg = dataclasses.replace(TASKS["multi_nu"].train_config, epochs=args.epochs, lr=args.lr,
                              milestones=tuple(args.milestones), seed=args.seed,
                              grad_clip=args.grad_clip,
                              parameterization=args.parameterization)
    if args.parameterization != "eps":
        for sub_cfg in subtask_configs.values():
            sub_cfg["parameterization"] = args.parameterization
    # n_blocks and is_attn are recorded so that the net can be rebuilt from
    # the checkpoint alone (unet_multi fixes both).
    arch = {"proj_dim": args.proj_dim, "dims": list(args.dims), "n_blocks": 2,
            "is_attn": [False] * len(args.dims), "middle_attn": False, "canvas_dim": canvas,
            "payload_dim": payload, "slots": list(slots)}
    params, sched = train_and_save(args.out, model, X, Y, cfg, dev, {
        "task": "multi", "nu_mode": args.nu_mode,
        "datasets": {"msr": args.msr_dataset, "co": args.co_dataset, "nu": args.nu_dataset,
                     "nu_budget": args.nu_budget_dataset,
                     **({"nu_geo": args.nu_geo_datasets} if args.nu_mode == "geo" else {})},
        "msr_repeat": args.msr_repeat, "co_repeat": args.co_repeat,
        "nu_times": args.nu_times, "config": dataclasses.asdict(cfg), "arch": arch,
        "subtask_configs": subtask_configs})

    if args.skip_eval:
        return
    metadata = {"arch": arch, "subtask_configs": subtask_configs}
    if args.parameterization == "x0":
        # x0-space guidance extrapolates solution estimates: it lives near
        # omega 1 for every subtask.
        om_msr = om_co = (0.5, 1.0, 2.0)
        om_nu = (0.0, 0.06, 0.25, 1.0)
    else:
        om_msr, om_co, om_nu = ((0.5, 1.0, 2.0), (1000.0, 5000.0, 20000.0),
                                (0.0, 0.06, 0.125, 0.5))
    omegas = {"msr": om_msr, "msr80": om_msr, "msr8": om_msr, "co": om_co, "nu": om_nu,
              "nu_geo": om_nu}
    for face, slot, path, load_kw in eval_sets(args):
        task = TASKS[face]
        d = task.load(path, **load_kw)
        merge_multi_config(d.config, metadata, slot)
        for om in omegas[slot]:
            m = evaluate(task, params, sched, d, omega=om)
            print(json.dumps({"split": pathlib.Path(path).name, "task": face, "omega": om,
                              **m}), flush=True)


if __name__ == "__main__":
    main()

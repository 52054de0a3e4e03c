"""Reproduce the headline quality rows in one run: one JSON line per row.

Counterpart of the JAX package's ``tools/headline.py``, with its flags, its
row names in its order and its JSON line per row (``{"row": name,
**metrics}``); ``--cpu`` runs on the CPU (the default is the CUDA card).
Each row loads its committed checkpoint, its dataset's test split (cut to
``--limit`` rows where given) and runs ``tasks.evaluate`` at the row's
documented sampler settings (the ``fused`` backend).

Rows that read the reference repository's datasets (``_cli.reference_csv``,
``$DIFFSG_REFERENCE_PATH/datasets``) are skipped, with one line on stderr,
when the file is absent; their checkpoints are then not loaded. The
``datasets/`` CSVs the selected rows read are made first where missing
(``data.ensure_datasets``).

    python -m diffsg_tpu_torch.tools.headline --tasks co nu --limit 1024
    python -m diffsg_tpu_torch.tools.headline --fast --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
from typing import Any, Callable, Dict, List, Optional

from ..data import ensure_datasets
from ..tasks import TASKS, evaluate, merge_ckpt_config, merge_multi_config
from ..utils import load_checkpoint
from ._cli import add_device_args, device_from_args, reference_csv

TASK_GROUPS = ("msr", "msr80", "co", "nu", "multi", "hybrid")
REPO = pathlib.Path(__file__).resolve().parent.parent.parent


@dataclasses.dataclass(frozen=True)
class Row:
    """One headline row: ``evaluate(TASKS[task], ...)`` on checkpoint
    ``ckpts/<ckpt>`` and ``csv`` (a ``datasets/`` file, or a reference file
    where ``ref``), loaded with ``load_kw``. ``slot``: the multi-task slot
    whose ``merge_multi_config`` applies (None: ``merge_ckpt_config``)."""

    name: str
    task: str
    ckpt: str
    csv: str
    ref: bool = False
    load_kw: Dict[str, float] = dataclasses.field(default_factory=dict)
    eval_kw: Dict[str, Any] = dataclasses.field(default_factory=dict)
    fast: bool = False
    slot: Optional[str] = None

    def path(self) -> str:
        return csv_path(self.csv, self.ref)


def csv_path(csv: str, ref: bool) -> str:
    """A reference dataset (``_cli.reference_csv``) or a ``datasets/`` file."""
    return reference_csv(csv) if ref else str(REPO / "datasets" / csv)


def _geo(width: float, height: float, power: float) -> Dict[str, float]:
    return {"width": width, "height": height, "P_sum": power}


GEO600, GEO200, GEO480 = _geo(600.0, 600.0, 33.0), _geo(200.0, 200.0, 12.0), _geo(480.0, 360.0,
                                                                                    21.0)
CSV600 = "3u_geo600x600_33mW_500samples.csv"
CSV200 = "3u_geo200x200_12mW_500samples.csv"
CSV480 = "3u_geo480x360_21mW_1000samples.csv"
CO_CSV = "3nodes_50000samples_new.csv"
MSR3, MSR3_OOD = "3c_10w_10000samples.csv", "3c_20w_2000samples_ood.csv"
NU18, NU30 = "3u_18mW_10000samples.csv", "3u_30mW_1000samples_ood.csv"
CO_OOD = "3nodes_2000samples_ood.csv"
MSR80, MSR80_OOD = "80c_20w_wf_10000samples.csv", "80c_40w_wf_2000samples_ood.csv"
MSR8, MSR8_OOD = "8c_10w_wf_10000samples.csv", "8c_20w_wf_2000samples_ood.csv"


def _row(name, task, ckpt, csv, ref=False, load_kw=None, fast=False, **eval_kw) -> Row:
    return Row(name, task, ckpt, csv, ref, dict(load_kw or {}), eval_kw, fast)


def _mrow(name, task, csv, omega, ref=False, load_kw=None, fast=False,
          ckpt="ddpm_multi") -> Row:
    return Row(name, task, ckpt, csv, ref, dict(load_kw or {}), {"omega": omega}, fast,
               slot=task.split("_", 1)[1])


def _msr_rows() -> List[Row]:
    return [
        _row("msr_3c wf single-draw", "msr_wf", "ddpm_msr_3c_wf", MSR3, True, omega=1.0,
             fast=True),
        _row("msr_3c wf OOD 20w single-draw", "msr_wf", "ddpm_msr_3c_wf", MSR3_OOD, True,
             omega=1.0),
        _row("msr_3c best-of-8 (legacy softmax path)", "msr", "ddpm_msr_3c", MSR3, True,
             omega=500.0, best_of=8),
        _row("msr_3c W-conditioned single-draw (10w unseen)", "msr_budget", "ddpm_msr_budget",
             MSR3, True, omega=0.5),
        _row("msr_3c W-conditioned OOD 20w single-draw (unseen)", "msr_budget",
             "ddpm_msr_budget", MSR3_OOD, True, omega=0.5),
        _row("msr_8c wf single-draw", "msr_wf", "ddpm_msr_8c_wf", MSR8, omega=1.0),
        _row("msr_8c wf OOD 20w single-draw", "msr_wf", "ddpm_msr_8c_wf", MSR8_OOD, omega=1.0),
    ]


def _msr80_rows() -> List[Row]:
    return [
        _row("msr_80c wf250k single-draw", "msr_wf", "ddpm_msr_80c_wf250k", MSR80, omega=1.0,
             fast=True),
        _row("msr_80c wf250k OOD 40w single-draw", "msr_wf", "ddpm_msr_80c_wf250k", MSR80_OOD,
             omega=1.0),
        _row("msr_80c W-conditioned single-draw (20w unseen)", "msr_budget",
             "ddpm_msr_80c_budget", MSR80, omega=0.5),
        _row("msr_80c W-conditioned OOD 40w single-draw (unseen)", "msr_budget",
             "ddpm_msr_80c_budget", MSR80_OOD, omega=1.0),
        _row("msr_80c wf50k single-draw", "msr_wf", "ddpm_msr_80c_wf50k", MSR80, omega=8.0),
        _row("msr_80c wf50k OOD 40w single-draw", "msr_wf", "ddpm_msr_80c_wf50k", MSR80_OOD,
             omega=8.0),
        _row("msr_80c wf single-draw (10k-trained)", "msr_wf", "ddpm_msr_80c_wf", MSR80,
             omega=8.0),
        _row("msr_80c temp-decode (legacy labels)", "msr_temp", "ddpm_msr_80c",
             "80c_20w_10000samples.csv", omega=1000.0),
    ]


def _co_rows() -> List[Row]:
    wide_mix = [10., 30., 100., 300., 1000., 3000., 5000., 10000.] * 4
    rank_mix = [2000., 5000., 10000., 20000.] * 2
    x0_mix = [0., 0.5, 1., 1.5] * 2
    return [
        _row("co x0 ranked single-draw", "co_ranked", "ddpm_co_x0", CO_CSV, omega=1.0,
             fast=True),
        _row("co OOD x0 ranked single-draw", "co_ranked", "ddpm_co_x0", CO_OOD, True,
             omega=1.0),
        _row("co x0 ranked bo8 mix", "co_ranked", "ddpm_co_x0", CO_CSV, omega=x0_mix,
             best_of=len(x0_mix)),
        _row("co OOD x0 ranked bo8 mix", "co_ranked", "ddpm_co_x0", CO_OOD, True, omega=x0_mix,
             best_of=len(x0_mix)),
        _row("co ranked single-draw", "co_ranked", "ddpm_co", CO_CSV, omega=20000.0),
        _row("co OOD ranked single-draw", "co_ranked", "ddpm_co", CO_OOD, True, omega=20000.0),
        _row("co ranked bo8 mix", "co_ranked", "ddpm_co", CO_CSV, omega=rank_mix,
             best_of=len(rank_mix)),
        _row("co OOD ranked bo8 mix", "co_ranked", "ddpm_co", CO_OOD, True, omega=rank_mix,
             best_of=len(rank_mix)),
        _row("co analytic bo32", "co_analytic", "ddpm_co", CO_CSV, omega=wide_mix,
             best_of=len(wide_mix)),
        _row("co OOD analytic bo32", "co_analytic", "ddpm_co", CO_OOD, True, omega=wide_mix,
             best_of=len(wide_mix)),
        _row("co OOD single-draw", "co", "ddpm_co", CO_OOD, True, omega=5000.0),
    ]


def _nu_rows() -> List[Row]:
    refined, geo, x0f = "ddpm_nu_geo_refined", "ddpm_nu_geo", "ddpm_nu_geo_x0f"
    return [
        _row("nu self-improved gen2 single-draw", "nu_budget", "ddpm_nu_budget_refined2", NU18,
             True, omega=0.5),
        _row("nu self-improved gen2 OOD 30mW single-draw", "nu_budget",
             "ddpm_nu_budget_refined2", NU30, True, omega=0.5),
        _row("nu self-improved single-draw", "nu_budget", "ddpm_nu_budget_refined", NU18, True,
             omega=0.5),
        _row("nu self-improved OOD 30mW single-draw", "nu_budget", "ddpm_nu_budget_refined",
             NU30, True, omega=0.5),
        _row("nu budget-conditioned single-draw", "nu_budget", "ddpm_nu_budget", NU18, True,
             omega=0.06, fast=True),
        _row("nu budget-conditioned OOD 30mW single-draw", "nu_budget", "ddpm_nu_budget", NU30,
             True, omega=0.06),
        _row("nu direct single-draw (aug32 centered)", "nu_direct", "ddpm_nu_3u_aug32_s8c", NU18,
             True, omega=0.125),
        _row("nu direct OOD single-draw (aug32 centered)", "nu_direct", "ddpm_nu_3u_aug32_s8c",
             NU30, True, omega=0.125),
        _row("nu direct single-draw (aug2 s8, round-2a)", "nu_direct", "ddpm_nu_3u_aug_s8", NU18,
             True, omega=1.0),
        _row("nu bo32 mix", "nu", "ddpm_nu_3u_best", NU18, True,
             omega=[50., 150., 500., 1000., 2000., 5000., 10000., 20000.] * 4, best_of=32),
        _row("nu OOD bo32 mix", "nu", "ddpm_nu_3u_best", NU30, True,
             omega=[50., 150., 500., 1000., 2000., 5000., 10000., 20000.] * 4, best_of=32),
        _row("nu OOD augmented", "nu", "ddpm_nu_3u_aug", NU30, True, omega=2000.0),
        _row("nu geo universal self-improved (unseen 18mW 400x400)", "nu_geo", refined, NU18,
             True, omega=0.5),
        _row("nu geo universal self-improved (unseen 30mW 400x400)", "nu_geo", refined, NU30,
             True, omega=0.5),
        _row("nu geo universal self-improved (600x600 33mW)", "nu_geo", refined, CSV600,
             load_kw=GEO600, omega=0.5),
        _row("nu geo universal self-improved (200x200 12mW)", "nu_geo", refined, CSV200,
             load_kw=GEO200, omega=0.5),
        _row("nu geo universal self-improved (480x360 21mW)", "nu_geo", refined, CSV480,
             load_kw=GEO480, omega=0.5),
        _row("nu geo universal (unseen 18mW 400x400)", "nu_geo", geo, NU18, True, omega=0.5),
        _row("nu geo universal (unseen 30mW 400x400)", "nu_geo", geo, NU30, True, omega=0.06),
        _row("nu geo universal (600x600 33mW)", "nu_geo", geo, CSV600, load_kw=GEO600,
             omega=0.25),
        _row("nu geo universal (200x200 12mW)", "nu_geo", geo, CSV200, load_kw=GEO200,
             omega=0.06),
        _row("nu geo universal x0f (unseen 18mW 400x400)", "nu_geo", x0f, NU18, True, omega=0.0,
             fast=True),
        _row("nu geo universal x0f (unseen 30mW 400x400)", "nu_geo", x0f, NU30, True,
             omega=0.0),
        _row("nu geo universal x0f (480x360 21mW)", "nu_geo", x0f, CSV480, load_kw=GEO480,
             omega=0.0),
        _row("nu geo universal x0f (600x600 33mW)", "nu_geo", x0f, CSV600, load_kw=GEO600,
             omega=0.0),
        _row("nu geo universal x0f (200x200 12mW)", "nu_geo", x0f, CSV200, load_kw=GEO200,
             omega=0.0),
        _row("nu geo dense_w4 (unseen 18mW 400x400)", "nu_geo", "ddpm_nu_geo_dense_w4", NU18,
             True, omega=0.06),
        _row("nu geo dense_w4_fresh (unseen 18mW 400x400)", "nu_geo",
             "ddpm_nu_geo_dense_w4_fresh", NU18, True, omega=0.06),
        _row("nu geo dense_w4_fresh (unseen 30mW 400x400)", "nu_geo",
             "ddpm_nu_geo_dense_w4_fresh", NU30, True, omega=0.06),
    ]


def _multi_rows() -> List[Row]:
    geo, m80, zoo = "ddpm_multi_geo", "ddpm_multi_80", "ddpm_multi_zoo"
    return [
        _mrow("multi msr_3c single-draw", "multi_msr", MSR3, 0.5, True, fast=True),
        _mrow("multi msr_3c OOD 20w single-draw", "multi_msr", MSR3_OOD, 1.0, True),
        _mrow("multi co ranked single-draw", "multi_co", CO_CSV, 0.5),
        _mrow("multi co OOD ranked single-draw", "multi_co", CO_OOD, 0.5, True),
        _mrow("multi nu single-draw", "multi_nu", NU18, 0.0, True),
        _mrow("multi nu OOD 30mW single-draw", "multi_nu", NU30, 0.0, True),
        _mrow("multi_geo nu 18mW 400x400 (unseen)", "multi_nu_geo", NU18, 0.0, True, ckpt=geo),
        _mrow("multi_geo nu OOD 30mW 400x400 (unseen)", "multi_nu_geo", NU30, 0.0, True,
              ckpt=geo),
        _mrow("multi_geo nu 480x360 21mW", "multi_nu_geo", CSV480, 0.0, load_kw=GEO480,
              ckpt=geo),
        _mrow("multi_geo nu 600x600 33mW", "multi_nu_geo", CSV600, 0.0, load_kw=GEO600,
              ckpt=geo),
        _mrow("multi_geo nu 200x200 12mW", "multi_nu_geo", CSV200, 0.0, load_kw=GEO200,
              ckpt=geo),
        _mrow("multi_geo msr_3c single-draw", "multi_msr", MSR3, 0.5, True, ckpt=geo),
        _mrow("multi_geo co ranked single-draw", "multi_co", CO_CSV, 0.5, ckpt=geo),
        _mrow("multi_80 msr_80c 20w (unseen)", "multi_msr80", MSR80, 0.5, ckpt=m80),
        _mrow("multi_80 msr_80c OOD 40w (unseen)", "multi_msr80", MSR80_OOD, 0.5, ckpt=m80),
        _mrow("multi_80 msr_8c 10w (unseen)", "multi_msr8", MSR8, 0.5, ckpt=m80),
        _mrow("multi_80 msr_8c OOD 20w (unseen)", "multi_msr8", MSR8_OOD, 0.5, ckpt=m80),
        _mrow("multi_80 msr_3c single-draw", "multi_msr", MSR3, 0.5, True, ckpt=m80),
        _mrow("multi_80 co ranked single-draw", "multi_co", CO_CSV, 0.5, ckpt=m80),
        _mrow("multi_80 nu single-draw", "multi_nu", NU18, 0.0, True, ckpt=m80),
        _mrow("multi_80 nu OOD 30mW single-draw", "multi_nu", NU30, 0.0, True, ckpt=m80),
        _mrow("multi_zoo nu 18mW 400x400 (unseen)", "multi_nu_geo", NU18, 0.0, True, ckpt=zoo),
        _mrow("multi_zoo nu OOD 30mW 400x400 (unseen)", "multi_nu_geo", NU30, 0.0, True,
              ckpt=zoo),
        _mrow("multi_zoo msr_80c 20w (unseen)", "multi_msr80", MSR80, 0.5, ckpt=zoo),
        _mrow("multi_zoo msr_8c 10w (unseen)", "multi_msr8", MSR8, 0.5, ckpt=zoo),
        _mrow("multi_zoo msr_3c single-draw", "multi_msr", MSR3, 0.5, True, ckpt=zoo),
        _mrow("multi_zoo co ranked single-draw", "multi_co", CO_CSV, 0.5, ckpt=zoo),
    ]


def _hybrid_rows() -> List[Row]:
    return [
        _row("hybrid msr_80c wf50k +refine50", "msr_wf", "ddpm_msr_80c_wf50k", MSR80, omega=8.0,
             refine_iters=50),
        _row("hybrid msr_80c OOD 40w +refine50", "msr_wf", "ddpm_msr_80c_wf50k", MSR80_OOD,
             omega=8.0, refine_iters=50),
        _row("hybrid nu budget +refine50", "nu_budget", "ddpm_nu_budget", NU18, True,
             omega=0.06, refine_iters=50),
        _row("hybrid nu budget OOD 30mW +refine50", "nu_budget", "ddpm_nu_budget", NU30, True,
             omega=0.06, refine_iters=50),
    ]


GROUP_ROWS: Dict[str, Callable[[], List[Row]]] = {
    "msr": _msr_rows, "msr80": _msr80_rows, "co": _co_rows, "nu": _nu_rows,
    "multi": _multi_rows, "hybrid": _hybrid_rows}


def plan(tasks, fast: bool = False) -> List[Row]:
    """The rows ``--tasks`` selects (``--fast``: its smoke rows only), in
    the order the JAX CLI runs them."""
    return [r for g in TASK_GROUPS if g in tasks for r in GROUP_ROWS[g]()
            if r.fast or not fast]


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tasks", nargs="+", default=list(TASK_GROUPS), choices=TASK_GROUPS)
    ap.add_argument("--fast", action="store_true",
                    help="smoke tier: one representative row per task family on the first "
                         "--limit (default 512) eval rows; values are single-batch, NOT the "
                         "documented full-split numbers")
    ap.add_argument("--limit", type=int, default=None,
                    help="evaluate only the first N test rows (decoders have batch-global "
                         "semantics, so values shift slightly vs the full split)")
    add_device_args(ap)
    args = ap.parse_args(argv)
    if args.fast and args.limit is None:
        args.limit = 512
    return args


def limit_data(data, limit: Optional[int]) -> None:
    """Cut ``data``'s test split to its first ``limit`` rows."""
    if limit:
        data.X_test = data.X_test[:limit]
        data.Y_test = data.Y_test[:limit]
        if data.R_test is not None:
            data.R_test = data.R_test[:limit]


def run_row(row: Row, limit: Optional[int], dev) -> Dict[str, float]:
    """Load the row's checkpoint and data, merge the checkpoint's config
    keys, and ``evaluate``: the row's metrics."""
    task = TASKS[row.task]
    ck = load_checkpoint(str(REPO / "ckpts" / row.ckpt), device=dev)
    data = task.load(row.path(), **row.load_kw)
    limit_data(data, limit)
    if row.slot is None:
        merge_ckpt_config(data.config, ck.get("metadata"))
    else:
        merge_multi_config(data.config, ck["metadata"], row.slot)
    return evaluate(task, ck["params"], ck["sched"], data, **row.eval_kw)


def main(argv: Optional[List[str]] = None,
         on_row: Optional[Callable[[Row, Dict[str, float]], None]] = None) -> List[Dict]:
    """Run the selected rows; print and return one ``{"row": name,
    **metrics}`` per row run. ``on_row(row, metrics)`` is called after
    each."""
    args = parse_args(argv)
    dev = device_from_args(args)
    rows = plan(args.tasks, args.fast)
    ensure_datasets(sorted({r.csv for r in rows if not r.ref}))
    out = []
    for row in rows:
        if row.ref and not os.path.exists(row.path()):
            print(f"headline: skipped {row.name!r}: the reference dataset {row.path()} is "
                  f"absent", file=sys.stderr, flush=True)
            continue
        metrics = run_row(row, args.limit, dev)
        line = {"row": row.name, **metrics}
        print(json.dumps(line), flush=True)
        out.append(line)
        if on_row is not None:
            on_row(row, metrics)
    return out

if __name__ == "__main__":
    main()

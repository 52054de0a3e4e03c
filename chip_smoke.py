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
  against an unbucketed solve, and best-of-4 with an omega mixture;
* the CO family at B = 32,768 (``ckpts/ddpm_co``, T=20, omega 500, on
  ``fused``, ``mega`` and ``mega`` in bf16; ``co_ranked`` on
  ``ckpts/ddpm_co_x0`` at omega 5000 and ``co_direct``), the MSR variants at
  B = 8,192 (``msr_temp``, ``msr_wf``, ``msr_budget`` at 5 and 25 W), the
  conditioned NU tasks at B = 524,288 (``nu_budget`` at 30 mW, ``nu_geo`` on
  fields of 200, 400 and 600 m) and 50 refinement steps inside the bucket's
  graph (MSR-3c, ``nu_geo``): each eagerly and from the graph, feasible row
  by row, and held to the JAX package's mean quality (``JAX_QUALITY``);
* the multi-task faces, eagerly and from their buckets' graphs, each held to
  its JAX constant: ``ckpts/ddpm_multi``'s MSR-3c (B = 8,192), CO (32,768)
  and budget-conditioned NU (65,536) faces on ``fused`` and ``mega``
  (``serve_multi``), ``ddpm_multi_geo``'s geometry-conditioned NU face on
  mixed fields (``serve_multi_geo``), and the proj-256 ``ddpm_multi_80``'s
  MSR-80c (20 W) and MSR-8c (10 W) faces at B = 8,192 on ``plain``,
  ``fused`` and ``mega`` in turns, float32, with their forward times
  (``serve_multi_80``);
* ``tasks.base.evaluate`` on the repository's data (``eval``): the CSVs of
  ``datasets/`` remade where missing (a checkout has none), then a best-of-4
  on the 200x200 geometry split held to the JAX package's ``evaluate``
  (``EVAL_JAX``);
* the quality CLIs (``headline``): the port's ``tools/headline.py`` on the
  multi-task rows (whole splits) and on the MSR, CO, NU and hybrid rows
  that the repository's files reproduce (the first 1,024 test rows), each
  row held to the JAX package's ``evaluate`` on the same rows
  (``HEADLINE_JAX``, and ``EVAL_JAX`` / ``EVAL_ZOO_JAX`` for the rows they
  hold); ``tools/eval_nu_geo.py`` on ``ckpts/ddpm_nu_geo``; and
  ``tools/co_guided.py`` on ``ckpts/ddpm_co_aux`` (``CO_GUIDED_JAX``: at
  omega 5,000 unguided and at scale 0.3, and at omega 0 unguided and at
  scale 3, the guided row apart from the unguided one);
* training (``train``): ``train.train_ddpm`` on the card for the CO net
  (the training split of that CO CSV) and MSR-3c (a 10,000-row, 10 W set
  from ``sum_rate_gen``), 2 epochs each at batch 512 from the reference
  init, finite losses (CO's after an epoch below its initial net's on
  fixed draws), a checkpoint after epoch 1 resumed to the
  uninterrupted run's weights bit for bit, three card steps held to the
  same steps on the CPU, and the trained checkpoints served by
  ``Solver.from_checkpoint`` through ``fused`` and ``mega``, feasible row by
  row, each kernel's forward held to ``plain`` on the trained weights;
* the data generators (``datasets_gen``): every subcommand of the port's
  ``tools/make_datasets.py`` at a small size, each file's SHA-256 held to
  the JAX package's, and the native CO oracle held to the NumPy oracle;
* the five task-specific training CLIs (``train_clis``: ``train_msr_budget``,
  ``train_nu_budget``, ``train_nu_geo``, ``train_nu_augmented`` and
  ``train_multi`` in the zoo's recipe at proj 256), one epoch each on those
  files at the full width of the net each ships, then each checkpoint
  served through ``fused`` and ``mega`` (feasible row by row) and both
  kernels' forwards held to ``plain`` on the trained weights;
* the proj-256 zoo ``ckpts/ddpm_multi_zoo`` (``serve_multi_zoo``): its five
  faces at their tasks' batches on ``fused``, MSR-80c on ``mega`` too,
  eagerly and from their buckets' graphs, and MSR-80c on ``plain``,
  ``fused`` and ``mega`` in turns from the graphs, held to the JAX
  package's mean quality, the forward on the three in turns;
* the baselines (``baselines``): GD on each task at 65,536 rows on the card,
  equal to the CPU's on the same rows and feasible row by row; the five
  shipped ``ckpts/retrain_*`` checkpoints' metrics on the test splits held
  to the JAX package's (``BASELINE_JAX``); one MTFNN and one PPO epoch on
  the card held to the same epoch on the CPU. Their training CLI
  (``train_baselines``: 2 epochs for each shipped checkpoint's pair) and the
  comparison (``report``): ``tools/report.py`` on CO, MSR-3c and NU, a DDPM
  row through ``fused`` held to ``REPORT_JAX`` beside the GD, MTFNN and PPO
  rows, and ``tools/fewstep.py`` on NU (``mega``) and CO (``fused``);
* the device mesh (``mesh``): this process as a world of one NCCL rank,
  ``make_mesh(1)``, the meshed Solver against the unmeshed one on MSR-3c
  (``fused``) and NU (``mega``) from their buckets' CUDA graphs with the
  collectives captured inside, in turns, bit for bit; a CO training epoch
  meshed against unmeshed; ``parallel.dryrun.dryrun_multichip(1)`` in a
  spawned rank;
* ``legacy``: ``diffusion.legacy.legacy_sample`` on the card against the
  CPU on the same injected draws, an attention net's ``plain`` forward card
  against CPU, and the CFG-pair backend (``pair``): its MSR-3c forward held
  to ``plain`` and timed beside ``plain`` and ``fused``, and one ``msr_temp``
  request served through it, eagerly and from its graph, held to
  ``JAX_QUALITY``;
* the timing CLIs (``timing``): ``tools/profile_sampler.py``'s
  ``torch.profiler`` trace of one MSR-3c sampler call on ``fused`` and on
  ``mega`` (the trace counts 2,700 residual-block and 100 mega launches; the
  top device operations are reported), ``tools/serving_latency.py``'s table
  on NU through a ``mega`` Solver (pipelined requests equal blocking ones
  bit for bit) and ``tools/latency_probe.py`` on MSR-3c;
* the research CLIs (``research``): ``tools/dump_trajectory.py`` on CO,
  ``tools/refine_labels.py`` with a model seed on a small nu-budget set,
  ``tools/refine_study.py`` and ``tools/nu12_to_geo15.py`` on the 18 mW NU
  set, each held to its contract (the last, byte for byte, to the JAX
  CLI's output).

The residual-block kernel is held to its plain version at every block
shape of the MSR-3c forward (16,384 rows) and of the CO forward (65,536
rows, and 1,000 rows for its widest), and at the two widest shapes of
a net of the shapes of ``ckpts/ddpm_msr_80c_budget`` (proj 256, dims
256-128-64-32, input 80, condition 81) with seeded random weights, the
widest net the repository ships: 512 -> 256 with a shortcut and 256 -> 256,
at 16,384 rows and, for 512 -> 256, at a ragged 1,000 rows with a full
t_proj; each case at every tile height its path is built for. The
whole-UNet kernel is held to its plain version on MSR-3c, NU, that net, the
CO net and the nets of ``ckpts/ddpm_nu_geo_x0f``, ``ddpm_msr_budget``,
``ddpm_nu_budget``, ``ddpm_multi`` and ``ddpm_multi_80``; the
residual-block kernel also at every block shape of ``ddpm_multi_80`` with
its own weights (``ddpm_multi``'s are MSR-3c's shapes).

Every phase prints one JSON line with the seconds since start; any failure
raises and exits non-zero. The last three lines are the ``kernels``
summary, the card's name and power limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

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
CO_B = 32_768          # bench.py:_per_task_rows' CO batch
CO_ROWS = 2 * CO_B
MULTI_NU_B = 65_536    # the multi-task NU faces' batch
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

# -- quality against the JAX package ---------------------------------------------
# Each spec is one served configuration on seeded inputs: the checkpoint, the
# task, the dataset config over the checkpoint's own, the sampler ("ddpm" over
# all T steps, or ("ddim", n)), omega, the rows and the projected-gradient
# steps after the decode. Its per-row quality is the cost over
# co_exact_solve's (CO, lower is better), the rate over waterfilling's at the
# row's budget (MSR) or the NOMA rate (NU). Its noise is y_T and the per-step
# z from np.random.default_rng(seed).
CO_FIXTURE = os.path.join(REPO, "tests", "fixtures", "co_cond.npz")
# ckpts/ddpm_co records no dataset config: the values of its training set,
# datasets/3nodes_50000samples_new.csv, as ckpts/ddpm_co_x0 records them.
CO_CONFIG = {"node_num": 3, "scaler_min": 0.001618138251306864,
             "scaler_max": 9.996995111158247}
QUALITY_SPECS = {
    "co": dict(ckpt="ddpm_co", task="co", config=CO_CONFIG, omega=500.0, rows=("co",)),
    "co_ranked": dict(ckpt="ddpm_co_x0", task="co_ranked", omega=5000.0, rows=("co",)),
    "co_direct": dict(ckpt="exp_co_s2_clip", task="co_direct", omega=1.0, rows=("co",)),
    "msr_temp": dict(ckpt="ddpm_msr_3c_T100", task="msr_temp", omega=500.0,
                     rows=("msr", 512)),
    "msr_refine": dict(ckpt="ddpm_msr_3c_T100", task="msr", omega=500.0, rows=("msr", 512),
                       refine=50),
    "msr_wf": dict(ckpt="ddpm_msr_3c_wf", task="msr_wf", omega=1.0, rows=("msr", 1024)),
    "msr_budget_5": dict(ckpt="ddpm_msr_budget", task="msr_budget", config={"W": 5.0},
                         omega=1.0, rows=("msr", 1024, 5.0)),
    "msr_budget_25": dict(ckpt="ddpm_msr_budget", task="msr_budget", config={"W": 25.0},
                          omega=1.0, rows=("msr", 1024, 25.0)),
    "nu_budget": dict(ckpt="ddpm_nu_budget", task="nu_budget", config={"P_sum": 30.0},
                      sampler=("ddim", 3), omega=0.125, rows=("nu_budget", 4096, 30.0)),
    "nu_geo": dict(ckpt="ddpm_nu_geo_x0f", task="nu_geo", sampler=("ddim", 3), omega=0.5,
                   rows=("nu_geo", 4096)),
    "nu_geo_refine": dict(ckpt="ddpm_nu_geo_x0f", task="nu_geo", sampler=("ddim", 3),
                          omega=0.5, rows=("nu_geo", 4096), refine=50),
    # The faces of the multi-task nets (DDPM T=20, x0): ckpts/ddpm_multi's
    # MSR-3c, CO and budget-conditioned NU (at 30 mW), ddpm_multi_geo's
    # geometry-conditioned NU, and the proj-256 ddpm_multi_80's MSR-80c at
    # 20 W and MSR-8c at 10 W.
    "multi_msr": dict(ckpt="ddpm_multi", task="multi_msr", omega=0.5, rows=("msr", 1024)),
    "multi_co": dict(ckpt="ddpm_multi", task="multi_co", omega=0.5, rows=("co",)),
    "multi_nu": dict(ckpt="ddpm_multi", task="multi_nu", config={"P_sum": 30.0}, omega=0.0,
                     rows=("nu_budget", 4096, 30.0)),
    "multi_nu_geo": dict(ckpt="ddpm_multi_geo", task="multi_nu_geo", omega=0.0,
                         rows=("nu_geo", 4096)),
    "multi_msr80": dict(ckpt="ddpm_multi_80", task="multi_msr80", config={"W": 20.0},
                        omega=0.5, rows=("msr", 512, 20.0, 80)),
    "multi_msr8": dict(ckpt="ddpm_multi_80", task="multi_msr8", omega=0.5,
                       rows=("msr", 512, 10.0, 8)),
    # The five faces of the proj-256 zoo (ckpts/ddpm_multi_zoo): MSR-3c, CO,
    # geometry-conditioned NU, MSR-80c at 20 W and MSR-8c at 10 W on one net,
    # at the omegas of tools/headline.py's zoo rows.
    "zoo_msr": dict(ckpt="ddpm_multi_zoo", task="multi_msr", omega=0.5, rows=("msr", 1024)),
    "zoo_co": dict(ckpt="ddpm_multi_zoo", task="multi_co", omega=0.5, rows=("co",)),
    "zoo_nu_geo": dict(ckpt="ddpm_multi_zoo", task="multi_nu_geo", omega=0.0,
                       rows=("nu_geo", 4096)),
    "zoo_msr80": dict(ckpt="ddpm_multi_zoo", task="multi_msr80", config={"W": 20.0},
                      omega=0.5, rows=("msr", 512, 20.0, 80)),
    "zoo_msr8": dict(ckpt="ddpm_multi_zoo", task="multi_msr8", omega=0.5,
                     rows=("msr", 512, 10.0, 8)),
}
# The JAX package's mean quality per spec, noise seed 0, flax forward on the
# CPU, and the tolerance: 4 standard errors of the difference between two
# JAX draws' means (seeds 0 and 1, from their per-row differences), but no
# less than 1e-6 of the mean (8 float32 ulps): where every draw reaches the
# optimum (msr_refine, multi_msr, multi_msr8) the spread is float rounding
# alone. Computed and held by tests/test_torch_co.py, test_torch_tasks.py,
# test_torch_refine.py and test_torch_multi.py (test_*_vs_jax_constants); the
# zoo's by tests/test_torch_zoo.py (marked slow).
JAX_QUALITY = {
    "co": (1.0895304273581132, 0.03838794270798506),
    "co_ranked": (1.0343122543999925, 0.0027104437903954616),
    "co_direct": (1.0800527355168015, 0.03241476819068911),
    "msr_temp": (0.9978372390614823, 0.00043437960974434804),
    "msr_refine": (1.0000000429572538, 1.0000000429572536e-06),
    "msr_wf": (0.9999906264129095, 2.4263671568242067e-06),
    "msr_budget_5": (0.9999487556051463, 1.4121820817363112e-05),
    "msr_budget_25": (0.9999975467799231, 2.1548523156405994e-06),
    "nu_budget": (0.000713795230616654, 7.736737432380983e-08),
    "nu_geo": (0.0005522479747419595, 1.4223689930762734e-07),
    "nu_geo_refine": (0.0007602846748611114, 1.4730445098868318e-06),
    "multi_msr": (0.9999991727527231, 9.999991727527232e-07),
    "multi_co": (1.000234799721511, 0.00022960730411175203),
    "multi_nu": (0.0007138378908067011, 2.4706348815265537e-08),
    "multi_nu_geo": (0.000554529605665266, 2.2862253590615736e-08),
    "multi_msr80": (0.999599517788738, 7.5049514129841494e-06),
    "multi_msr8": (0.999994060723111, 9.99994060723111e-07),
    "zoo_msr": (0.9999954628292471, 9.999954628292472e-07),
    "zoo_co": (1.0016148820286617, 0.0007023933457981357),
    "zoo_nu_geo": (0.0005544387013003416, 2.3737473563899007e-08),
    "zoo_msr80": (0.9994912332622334, 9.945242038891176e-06),
    "zoo_msr8": (0.9999939353438094, 9.999939353438095e-07),
}
# On a spec's own inputs and noise the port's mean sits far inside that
# tolerance: guidance and refinement's accept/reject part a few rows between
# two float32 forwards. The port's plain forward on the CPU lands at most
# 0.038 of the tolerance from the constant (co_ranked; nu_geo_refine 0.032,
# co 0.023, msr_refine 0.018, the rest below 0.002). Held within 0.15, four
# times that: on CO, 0.53% of the mean cost ratio.
SAME_NOISE_SHARE = 0.15

# -- tasks.base.evaluate on the repository's data --------------------------------
# The CSVs of datasets/ (not committed; remade from their recipes by
# diffsg_tpu_torch.data.ensure_datasets) and the SHA-256 of the files the
# constants below were computed on.
DATASET_SHA256 = {
    "3nodes_50000samples_new.csv":
        "e3b09368ff416b5c140603ba3ba42e978a3661265da5e23fba1fabada9d1bd99",
    "3u_geo200x200_12mW_500samples.csv":
        "1437553b497cc7e2a16b29b8c26859c931c8efb670f696da48a9ed88608be604",
    "3u_geo480x360_21mW_1000samples.csv":
        "42d4527c0ec96f252bc6921cc9c26466bad9f307c07b45334970806b0247d27e",
    "3u_geo600x600_33mW_500samples.csv":
        "5a40ac0be2d7c261189b518415181590424d3f775ab6f042989a26ed9ebd7b9d",
    "80c_20w_wf_10000samples.csv":
        "c062d00c856ae09b7ce275025d38cd28a847f755a802e689179666e388ee55cd",
    "80c_40w_wf_2000samples_ood.csv":
        "0416be68aa2b7315b6e95faaa2a2447ad3d2ebabd43fc2c06c7b60bb6180086b",
    "8c_10w_wf_10000samples.csv":
        "f64ce29bfb7bd7e38ced813636653d9e19f967af0d1873929b11c32c99fdccb7",
    "8c_20w_wf_2000samples_ood.csv":
        "c01eb95c699cd104066a2da17c5bb02f3b524716ed67052fc448835e5456e498",
}


def _geo_eval(csv, width, height, P_sum, **kw):
    return dict(ckpt="ddpm_multi_geo", task="multi_nu_geo", omega=0.0, csv=csv, seeds=64,
                load_kw={"width": width, "height": height, "P_sum": P_sum}, **kw)


# The rows of tools/headline.py:357-440 that the repository's own files can
# reproduce: each face's test split through its task's loader (load_kw) and
# the multi checkpoint's merge_multi_config, at the row's omega; and a
# best-of-4 on the smallest split. ``seeds``: the JAX draws behind its
# constants, enough that rows times draws reach 9,600 or more (below).
EVAL_SPECS = {
    "multi_co": dict(ckpt="ddpm_multi", task="multi_co", csv="3nodes_50000samples_new.csv",
                     omega=0.5, seeds=2),
    "multi_nu_geo_480x360": _geo_eval("3u_geo480x360_21mW_1000samples.csv", 480.0, 360.0, 21.0),
    "multi_nu_geo_600x600": _geo_eval("3u_geo600x600_33mW_500samples.csv", 600.0, 600.0, 33.0),
    "multi_nu_geo_200x200": _geo_eval("3u_geo200x200_12mW_500samples.csv", 200.0, 200.0, 12.0),
    "multi_nu_geo_200x200_best_of_4": _geo_eval("3u_geo200x200_12mW_500samples.csv", 200.0,
                                                200.0, 12.0, best_of=4),
}
# The JAX package's evaluate per spec and metric: the mean over its seeds 0
# to K-1 (K the spec's ``seeds``; flax forward on the CPU, its own loaders)
# and the tolerance: 4 standard errors of one draw's deviation from that
# mean, from the rows' seed-to-seed variances (at least 1e-6 of the mean;
# one row for a count). On the 150- to 300-row geo splits a few rows fail
# rarely and badly, and two draws underestimate the spread 2.6-3.4x
# (PERF.md §6, PR 11), so those constants take 64 draws. Computed and held
# by tests/test_torch_eval.py::test_evaluate_vs_jax_constants.
EVAL_JAX = {
    "multi_co": {"exceeded_ratio": (1.0002288818359375, 8.584676794699987e-05),
                 "avg_diff": (0.00043527173693291843, 0.00016325196392797327),
                 "decision_accuracy": (0.9822333333333335, 0.004554850894010327),
                 "terrible_count": (0.0, 1.0)},
    "multi_nu_geo_480x360": {"less_ratio": (0.9999276399612427, 0.00025028852068274506),
                             "avg_diff": (-3.1522340293577145e-08, 1.0898933140300408e-07)},
    "multi_nu_geo_600x600": {"less_ratio": (0.9980524778366089, 0.000919522573509814),
                             "avg_diff": (-1.1166325748490635e-06, 5.272247546631206e-07)},
    "multi_nu_geo_200x200": {"less_ratio": (1.0000348091125488, 8.257095212869035e-05),
                             "avg_diff": (1.1912114850076705e-08, 2.8193645713288867e-08)},
    "multi_nu_geo_200x200_best_of_4": {
        "less_ratio": (1.0002458095550537, 6.478120942752427e-05),
        "avg_diff": (8.396119000053659e-08, 2.2119451143748614e-08)},
}


# The eval phase's own row (the others are headline rows, run by the headline
# phase through tools/headline.py).
EVAL_ONLY = ("multi_nu_geo_200x200_best_of_4",)


# -- the zoo's rows of tools/headline.py:432-438 that the repository's files
# reproduce (MSR-80c at 20 W, MSR-8c at 10 W, CO), as EVAL_SPECS; the headline
# phase holds them. Their constants: the mean of JAX seeds 0 and 1 and 4
# standard errors, as multi_co's; computed by
# tests/test_torch_zoo.py::test_zoo_evaluate_vs_jax_constants (marked slow: two
# JAX evaluates of the proj-256 net over CO's 15,000 rows).
EVAL_ZOO_SPECS = {
    "zoo_msr80": dict(ckpt="ddpm_multi_zoo", task="multi_msr80",
                      csv="80c_20w_wf_10000samples.csv", omega=0.5, seeds=2),
    "zoo_msr8": dict(ckpt="ddpm_multi_zoo", task="multi_msr8",
                     csv="8c_10w_wf_10000samples.csv", omega=0.5, seeds=2),
    "zoo_co": dict(ckpt="ddpm_multi_zoo", task="multi_co", csv="3nodes_50000samples_new.csv",
                   omega=0.5, seeds=2),
}
EVAL_ZOO_JAX = {
    "zoo_msr80": {"less_ratio": (0.999487578868866, 3.6266963207770826e-06),
                  "avg_diff": (-0.020825989544391632, 0.00014739764381962311)},
    "zoo_msr8": {"less_ratio": (0.9999932050704956, 9.999932050704956e-07),
                 "avg_diff": (-8.156935655279085e-05, 4.805893163942779e-06)},
    "zoo_co": {"exceeded_ratio": (1.0014357566833496, 0.0003019825024290014),
               "avg_diff": (0.0027304759714752436, 0.0005742703118042561),
               "decision_accuracy": (0.9550333333333336, 0.006114463726825654),
               "terrible_count": (0.0, 1.0)},
}

# -- headline: the port's tools/headline.py, its rows that the repository's files ----
# reproduce. Two runs: the multi-task rows on whole splits, and the MSR, CO, NU
# and hybrid rows on the first HEADLINE_LIMIT test rows (the geometry splits
# have 150-300 rows, so they stay whole). Each row is held to the JAX
# package's evaluate on the same rows: the rows EVAL_JAX and EVAL_ZOO_JAX
# already hold keep those constants (HEADLINE_EVAL), the others take
# HEADLINE_JAX, built as EVAL_JAX is from HEADLINE_SEEDS[row] JAX draws: 2 on
# splits of 1,000 rows or more, 8 on the 600-row OOD MSR splits, 64 on the
# geometry splits, and 16 on the best-of rows, where most rows converge to
# one answer whatever the seed and a rare row fails badly (14 of 16 JAX draws
# of "co x0 ranked bo8 mix" give the same ratio to the last bit, one is
# 1.8e-4 above it), so two draws understate the spread 10x. avg_diff's floor
# is 1e-6 of the labels' mean objective, the ratio's floor in its units:
# after 50 refinement steps float32 rounding of the objectives is all that
# parts two draws. Computed and held by
# tests/test_torch_quality_clis.py::test_headline_vs_jax_constants (slow).
HEADLINE_LIMIT = 1024
HEADLINE_ARGV = (["--tasks", "multi"],
                 ["--tasks", "msr", "co", "nu", "hybrid", "--limit", str(HEADLINE_LIMIT)])
HEADLINE_EVAL = {
    "multi co ranked single-draw": "multi_co",
    "multi_geo nu 480x360 21mW": "multi_nu_geo_480x360",
    "multi_geo nu 600x600 33mW": "multi_nu_geo_600x600",
    "multi_geo nu 200x200 12mW": "multi_nu_geo_200x200",
    "multi_zoo msr_80c 20w (unseen)": "zoo_msr80",
    "multi_zoo msr_8c 10w (unseen)": "zoo_msr8",
    "multi_zoo co ranked single-draw": "zoo_co",
}
HEADLINE_SEEDS = {
    "multi_geo co ranked single-draw": 2,
    "multi_80 msr_80c 20w (unseen)": 2,
    "multi_80 msr_80c OOD 40w (unseen)": 8,
    "multi_80 msr_8c 10w (unseen)": 2,
    "multi_80 msr_8c OOD 20w (unseen)": 8,
    "multi_80 co ranked single-draw": 2,
    "msr_8c wf single-draw": 2,
    "msr_8c wf OOD 20w single-draw": 8,
    "co x0 ranked single-draw": 2,
    "co x0 ranked bo8 mix": 16,
    "co ranked single-draw": 2,
    "co ranked bo8 mix": 16,
    "co analytic bo32": 16,
    "nu geo universal self-improved (600x600 33mW)": 64,
    "nu geo universal self-improved (200x200 12mW)": 64,
    "nu geo universal self-improved (480x360 21mW)": 64,
    "nu geo universal (600x600 33mW)": 64,
    "nu geo universal (200x200 12mW)": 64,
    "nu geo universal x0f (480x360 21mW)": 64,
    "nu geo universal x0f (600x600 33mW)": 64,
    "nu geo universal x0f (200x200 12mW)": 64,
    "hybrid msr_80c wf50k +refine50": 2,
    "hybrid msr_80c OOD 40w +refine50": 8,
}
HEADLINE_JAX = {
    "multi_geo co ranked single-draw":
        {"exceeded_ratio": (1.0009961128234863, 0.0002949874307562435),
         "avg_diff": (0.001894175074994564, 0.0005609679698845038),
         "decision_accuracy": (0.9651000000000003, 0.006470445631227162),
         "terrible_count": (0.0, 1.0)},
    "multi_80 msr_80c 20w (unseen)":
        {"less_ratio": (0.9996020197868347, 2.8494802752437004e-06),
         "avg_diff": (-0.016175100579857826, 0.00011580909082324812)},
    "multi_80 msr_80c OOD 40w (unseen)":
        {"less_ratio": (0.9998619556427002, 1.259023590370714e-06),
         "avg_diff": (-0.009237931109964848, 8.425850862208221e-05)},
    "multi_80 msr_8c 10w (unseen)":
        {"less_ratio": (0.9999934434890747, 9.999934434890747e-07),
         "avg_diff": (-7.879240729380399e-05, 1.1938036918640137e-05)},
    "multi_80 msr_8c OOD 20w (unseen)":
        {"less_ratio": (0.9999986886978149, 9.999986886978148e-07),
         "avg_diff": (-2.1896759790251963e-05, 1.7362220764160154e-05)},
    "multi_80 co ranked single-draw":
        {"exceeded_ratio": (1.0008044242858887, 0.0001761990879212929),
         "avg_diff": (0.0015297982608899474, 0.0003350720743899087),
         "decision_accuracy": (0.967766666666667, 0.004871686908385363),
         "terrible_count": (0.0, 1.0)},
    "msr_8c wf single-draw":
        {"less_ratio": (0.999923825263977, 1.6638345696771392e-05),
         "avg_diff": (-0.0009088926017284393, 0.00019831577478129616)},
    "msr_8c wf OOD 20w single-draw":
        {"less_ratio": (0.9999802112579346, 4.386995529731579e-06),
         "avg_diff": (-0.0003433068632148206, 7.616798836609485e-05)},
    "co x0 ranked single-draw":
        {"exceeded_ratio": (1.0017542839050293, 0.0013418230186514504),
         "avg_diff": (0.003278113901615143, 0.002507406617327646),
         "decision_accuracy": (0.943359375, 0.030257682392245442),
         "terrible_count": (0.0, 1.0)},
    "co x0 ranked bo8 mix":
        {"exceeded_ratio": (1.0000042915344238, 0.00019726854181374164),
         "avg_diff": (8.040449756663293e-06, 0.00036862725938813343),
         "decision_accuracy": (0.99884033203125, 0.0017435127999372191),
         "terrible_count": (0.0, 1.0)},
    "co ranked single-draw":
        {"exceeded_ratio": (1.0023524761199951, 0.0042669018994623215),
         "avg_diff": (0.004395965952426195, 0.007973373387772618),
         "decision_accuracy": (0.962890625, 0.010697706201272776),
         "terrible_count": (0.0, 1.0)},
    "co ranked bo8 mix":
        {"exceeded_ratio": (1.0003498792648315, 0.00029493647498097706),
         "avg_diff": (0.000653728493489325, 0.0005511350816650779),
         "decision_accuracy": (0.982666015625, 0.005364431237098542),
         "terrible_count": (0.0, 1.0)},
    "co analytic bo32":
        {"exceeded_ratio": (1.0025320053100586, 0.002577343432264315),
         "avg_diff": (0.004731310997158289, 0.004816169635223633),
         "decision_accuracy": (0.9573974609375, 0.01663408273194928),
         "terrible_count": (0.0, 1.0)},
    "nu geo universal self-improved (600x600 33mW)":
        {"less_ratio": (2.0022459030151367, 0.023231763126807893),
         "avg_diff": (0.0005746558890677989, 1.3320348696376633e-05)},
    "nu geo universal self-improved (200x200 12mW)":
        {"less_ratio": (1.2252519130706787, 0.00600900413359551),
         "avg_diff": (7.691218343097717e-05, 2.0517731738003496e-06)},
    "nu geo universal self-improved (480x360 21mW)":
        {"less_ratio": (1.6756068468093872, 0.013859441019809944),
         "avg_diff": (0.0002941964194178581, 6.035163041939804e-06)},
    "nu geo universal (600x600 33mW)":
        {"less_ratio": (0.9858058094978333, 0.028413557361117517),
         "avg_diff": (-8.138476914609782e-06, 1.629142332421616e-05)},
    "nu geo universal (200x200 12mW)":
        {"less_ratio": (0.9983683824539185, 0.005535526844004752),
         "avg_diff": (-5.571113206315204e-07, 1.8901042052423791e-06)},
    "nu geo universal x0f (480x360 21mW)":
        {"less_ratio": (1.0001375675201416, 0.00015284528373403036),
         "avg_diff": (5.98691656250594e-08, 6.655720492838616e-08)},
    "nu geo universal x0f (600x600 33mW)":
        {"less_ratio": (0.9979137778282166, 0.0011956432187450912),
         "avg_diff": (-1.1961576547037112e-06, 6.855434212677051e-07)},
    "nu geo universal x0f (200x200 12mW)":
        {"less_ratio": (1.0000579357147217, 7.358845277237542e-05),
         "avg_diff": (1.977872443603701e-08, 2.5126690002346342e-08)},
    "hybrid msr_80c wf50k +refine50":
        {"less_ratio": (1.000000238418579, 1.000000238418579e-06),
         "avg_diff": (6.77257776260376e-06, 4.063783264160156e-05)},
    "hybrid msr_80c OOD 40w +refine50":
        {"less_ratio": (1.000000238418579, 1.000000238418579e-06),
         "avg_diff": (9.636084541853052e-06, 6.692412567138672e-05)},
}
# eval_nu_geo on ckpts/ddpm_nu_geo at omegas 0.06 and 0.25: the (config,
# omega) pairs that are headline rows, held to those rows' constants.
EVAL_NU_GEO_ARGV = ["--ckpt", "ckpts/ddpm_nu_geo", "--omegas", "0.06", "0.25"]
EVAL_NU_GEO_ROWS = {("12mW 200x200", 0.06): "nu geo universal (200x200 12mW)",
                    ("33mW 600x600", 0.25): "nu geo universal (600x600 33mW)"}
# co_guided on ckpts/ddpm_co_aux (tau 0.05), in two runs: at omega 5,000 on the
# first 1,024 CO test rows at guidance scales 0 and 0.3, and at omega 0 on the
# whole test split (15,000 rows) at scales 0 and 3. At omega 5,000 the tilt
# moves no decision (the two constants are equal); at omega 0 scale 3 moves
# the means of exceeded_ratio and avg_diff 2.9 times both rows' tolerances
# together off the unguided row's, so the card run shows the guidance
# gradient changing the answers.
# Per (omega, scale), the JAX package's guided sampler (its co_guided.py's
# program) over CO_GUIDED_SEEDS seeds, as HEADLINE_JAX; computed and held by
# tests/test_torch_quality_clis.py::test_co_guided_vs_jax_constants (slow).
_CO_GUIDED_DATA = ["--ckpt", "ckpts/ddpm_co_aux", "--dataset",
                   "datasets/3nodes_50000samples_new.csv"]
CO_GUIDED_RUNS = [_CO_GUIDED_DATA + ["--limit", "1024", "--scales", "0", "0.3"],
                  _CO_GUIDED_DATA + ["--omegas", "0", "--scales", "0", "3"]]
CO_GUIDED_SEEDS = 2
CO_GUIDED_JAX = {
    (5000.0, 0.0): {"acc": (0.78955078125, 0.0033829117335329633),
                    "exceeded_ratio": (1.0254096984863281, 0.00035771772959352363),
                    "avg_diff": (0.04748209938406944, 0.0006684513787907259)},
    (5000.0, 0.3): {"acc": (0.78955078125, 0.0033829117335329633),
                    "exceeded_ratio": (1.0254096984863281, 0.00035771772959352363),
                    "avg_diff": (0.04748209938406944, 0.0006684513787907259)},
    (0.0, 0.0): {"acc": (0.0027, 0.0015491933384829668),
                 "exceeded_ratio": (2.3157191276550293, 0.005850635116342607),
                 "avg_diff": (2.5020599365234375, 0.011125961410591799)},
    (0.0, 3.0): {"acc": (0.01596666666666667, 0.004849742261192856),
                 "exceeded_ratio": (2.2418875694274902, 0.019663350787927532),
                 "avg_diff": (2.36165714263916, 0.037393149188965434)},
}

# -- timing: the port's profile_sampler, serving_latency and latency_probe -----------
# profile_sampler on MSR-3c shapes: one profiled sampler call sees every launch.
PROFILE_SPEC = dict(task="msr", T=100, batch=SERVE_B, omega=500.0)
PROFILE_KERNELS = {"fused": ("resblock_", 27 * 100), "mega": ("mega_kernel", 100)}
SERVING_SIZES = [1, 512, 32768]
SERVING_ARGS = dict(samplers=["ddim:3"], repeats=10, depth=8)
# latency_probe's plain single-sample draw is host-paced (1.33 s for 100
# eager steps on the H100): 5 repeats, not its default 20.
LATENCY_REPEATS = 5

# -- research: dump_trajectory, refine_labels, refine_study and nu12_to_geo15 --------
# A small nu-budget set (make_datasets nu-budget at grid step 8) beside
# BASELINE_DATA's 18 mW NU set, which refine_study and nu12_to_geo15 read.
RESEARCH_BUDGET_CSV = ("build", "datasets", "3u_budget9-36_300samples.csv")
RESEARCH_BUDGET_ROWS = ("nu-budget", {"samples": 300, "grid_step": 8.0})
# SHA-256 of the JAX package's tools/nu12_to_geo15.py output on BASELINE_DATA's
# NU set (--power 18 --width 400 --height 400), its pandas reader parsing
# correctly rounded (float_precision="round_trip"; pandas' default parser puts
# some values 1 ulp off); computed by
# tests/test_torch_research_clis.py::test_chip_smoke_nu12_to_geo15_constant.
NU12_TO_GEO15_SHA256 = "f2ac3aab77d9eb2f18a7c5d0bde7e5308dfeb2b96f58c41498ddaddd9b7619d0"

# -- datasets_gen: tools/make_datasets.py's subcommands at small sizes --------------
# Each file's arguments (the port's make_datasets and the JAX package's take the
# same) and the SHA-256 of the file the JAX package's tools/make_datasets.py
# writes from them (NumPy 2.x on x86-64). The train_clis phase trains on them.
DATASETS_GEN = {
    "3c_10w_1000samples.csv": (
        ["msr", "--samples", "1000", "--channels", "3", "--power", "10"],
        "3d3e45bd55153470e1499a68ea8ae7fa4da8b7806a92156838e1c3d790522183"),
    "3c_20w_500samples_ood.csv": (
        ["msr", "--samples", "500", "--channels", "3", "--power", "20", "--seed", "1"],
        "e081641bf4ca61c15331d0580aa56208294dd9a8f099e4231e12d3da6acde17c"),
    "80c_20w_wf_500samples.csv": (
        ["msr", "--samples", "500", "--channels", "80", "--power", "20", "--labels", "wf"],
        "9cb94e59104a3d01614c37e2f8ba83e89e6c4be11e844347952c9057971821de"),
    "80c_40w_wf_300samples_ood.csv": (
        ["msr", "--samples", "300", "--channels", "80", "--power", "40", "--seed", "1",
         "--labels", "wf"],
        "3887ad3edd042790f87b24ba6662aa78a53a649c94f9ba5c81d25c5f9da9e40c"),
    "8c_10w_wf_500samples.csv": (
        ["msr", "--samples", "500", "--channels", "8", "--power", "10", "--labels", "wf"],
        "0e21ca343278c48deb4e095dc3964fbd1e4c9013b6d2ee0e1f149d9b5a4832aa"),
    "8c_20w_wf_300samples_ood.csv": (
        ["msr", "--samples", "300", "--channels", "8", "--power", "20", "--seed", "1",
         "--labels", "wf"],
        "669875422fd96f6edfcc6e61df8ae92001f00d910ca6b28220287f0a19f12841"),
    "3nodes_600samples.csv": (
        ["co", "--samples", "600"],
        "a4f2542d8050a823a18ec52204a863c1bc2f9a6e4c71eedfff707a1baf93006a"),
    "3nodes_300samples_ood.csv": (
        ["co", "--samples", "300", "--seed", "1"],
        "aebaac576b068ffb3f5f8dbfa358418b8dc8224c98916b9b615ca627d640a5c9"),
    "3u_18mW_400samples.csv": (
        ["nu", "--samples", "400", "--grid-step", "8"],
        "328d592b63f06acfba6db45429432182ef011bd566057b327e18efcd2c1e35ec"),
    "3u_18mW_3samples_numpy.csv": (
        ["nu", "--samples", "3", "--grid-step", "8", "--no-native"],
        "f534f79bde35544e90e488f1fc30888b9e4edafba36d58f963fbb24227abdfda"),
    "3u_30mW_200samples_ood.csv": (
        ["nu", "--samples", "200", "--power", "30", "--seed", "1", "--grid-step", "8"],
        "165518fa0c9aa885a9a121a8f1966f8cc0b103da6f99ca898480ea58748ce8e0"),
    "3u_geo480x360_21mW_150samples.csv": (
        ["nu", "--samples", "150", "--power", "21", "--width", "480", "--height", "360",
         "--seed", "7", "--grid-step", "8"],
        "d499716b8698ee340b6963a9ac59d8ec607763137a5ea03a7703b7e239846b48"),
    "3u_budget9-36_400samples.csv": (
        ["nu-budget", "--samples", "400", "--budget-step", "3", "--grid-step", "8"],
        "6d33f2d54c8ef65484eeb878013fac3d37849ed8c9f2f6652e2dae7d3250c6de"),
    "3u_geo200-600_400samples.csv": (
        ["nu-geo", "--samples", "400", "--geom-step", "200", "--grid-step", "8"],
        "b561d0ecbef61df4ea7e5101d9dcec99a964eae66d2564aafd9548fdd197e9b1"),
    "3u_geo_focus_300samples.csv": (
        ["nu-geo", "--samples", "300", "--geom-step", "200", "--focus-frac", "0.5",
         "--focus-geom-min", "280", "--focus-geom-max", "520", "--focus-geom-step", "120",
         "--grid-step", "8", "--seed", "1"],
        "6b98777cd57d28458488fe55e745a08f3fdf0b0c88c1da73cfcd8da74c9a10ce"),
}
GEN_DIR = os.path.join(REPO, "build", "datasets_gen")


def co_rows():
    """The CO fixture: 4,096 rows of the test split of
    datasets/3nodes_50000samples_new.csv through the JAX package's loader
    (loader-normalized conditions X (B, 9) and the oracle's labels Y)."""
    with np.load(CO_FIXTURE) as d:
        return d["X"].astype(np.float32), d["Y"].astype(np.float32)


def quality_rows(rows):
    """Loader-normalized conditions for a spec's ``rows``: the CO fixture;
    MSR gains U(0, 1) of M channels (``rows[3]``, default 3; with the budget
    column W / 10 where ``rows[2]`` gives W); NU users U(0, 1) and the
    budget P / 18; nu_geo square fields of 200, 400 or 600 m and budgets
    U(9, 36) mW, each row its own."""
    kind = rows[0]
    if kind == "co":
        return co_rows()[0]
    B = rows[1]
    rng = np.random.default_rng({"msr": 11, "nu_budget": 12, "nu_geo": 13}[kind])
    if kind == "msr":
        X = rng.uniform(0, 1, (B, rows[3] if len(rows) > 3 else 3))
        if len(rows) > 2:
            X = np.concatenate([X, np.full((B, 1), rows[2] / 10.0)], axis=1)
    elif kind == "nu_budget":
        X = np.concatenate([rng.uniform(0, 1, (B, 6)), np.full((B, 1), rows[2] / 18.0)], axis=1)
    else:
        side = rng.choice([200.0, 400.0, 600.0], B)
        X = np.concatenate([rng.uniform(0, 1, (B, 6)), rng.uniform(9, 36, (B, 1)) / 18.0,
                            side[:, None] / 400.0, side[:, None] / 400.0], axis=1)
    return X.astype(np.float32)


def seeded_noise(seed: int, B: int, T: int, D: int):
    """y_T (B, D) and the per-step z (T, B, D) from np.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, D)).astype(np.float32),
            rng.normal(size=(T, B, D)).astype(np.float32))


def spec_quality(name: str, task, cfg, dec, Xu, exact=None):
    """Per-row quality of spec ``name``'s decoded solutions ``dec`` on the
    unnormalized conditions ``Xu`` (torch tensors on one device): the cost
    over that of ``exact`` (co_exact_solve's, computed when not given) on
    CO, the rate over waterfilling's at the budget on MSR, the NOMA rate on
    NU. Returns it with CO's extra metrics against ``exact`` (else {})."""
    from diffsg_tpu_torch.baselines import co_exact_solve, waterfilling

    score = task.objective(dec, Xu, cfg)
    kind = QUALITY_SPECS[name]["rows"][0]
    if kind == "co":
        exact = co_exact_solve(Xu) if exact is None else exact
        ref = task.objective(exact, Xu, cfg)
        return score / ref, task.extra_metrics(dec.cpu().numpy(), exact.cpu().numpy(),
                                               score.cpu(), ref.cpu(), cfg)
    if kind == "msr":
        return score / task.objective(waterfilling(Xu[:, :cfg["M"]], cfg["W"]), Xu, cfg), {}
    return score, {}


def port_quality(name: str, seed: int, device: str = "cuda", backend: str = "mega"):
    """The port's per-row quality (a numpy array) and solutions on spec
    ``name``'s rows and seeded noise, through ``backend``'s forward."""
    import torch

    from diffsg_tpu_torch.diffusion import cfg_sample, ddim_sample
    from diffsg_tpu_torch.models import unet_apply_fn
    from diffsg_tpu_torch.serve import Solver
    from diffsg_tpu_torch.tasks import refine_solutions

    spec = QUALITY_SPECS[name]
    solver = Solver.from_checkpoint(os.path.join(REPO, "ckpts", spec["ckpt"]), task=spec["task"],
                                    device=device, backend=backend,
                                    dataset_config=spec.get("config"))
    task, cfg, dev = solver.task, solver.config, solver.sched.betas.device
    X = quality_rows(spec["rows"])
    B, D = X.shape[0], task.data_dim(cfg)
    sampler = spec.get("sampler", "ddpm")
    init, steps = seeded_noise(seed, B, solver.sched.T if sampler == "ddpm" else 0, D)
    cond = torch.tensor(X, device=dev)
    Xu = torch.tensor(np.asarray(task.unnormalize_x(X, cfg), np.float32), device=dev)
    kw = dict(init_noise=torch.tensor(init, device=dev),
              parameterization=cfg.get("parameterization", "eps"),
              skip_uncond=spec["omega"] == 0.0)
    apply_fn = unet_apply_fn(solver.model, backend)
    with torch.no_grad():
        if sampler == "ddpm":
            y0 = cfg_sample(apply_fn, solver.sched, cond, spec["omega"], D,
                            step_noise=torch.tensor(steps, device=dev), **kw)
        else:
            y0 = ddim_sample(apply_fn, solver.sched, cond, spec["omega"], D, n_steps=sampler[1],
                             **kw)
        dec = (task.decode_with_x(y0, Xu, cfg) if task.decode_with_x is not None
               else task.decode(y0, cfg))
        if spec.get("refine"):
            dec = refine_solutions(task, dec, Xu, cfg, spec["refine"])
        q = spec_quality(name, task, cfg, dec, Xu)[0]
    return q.cpu().double().numpy(), dec.cpu().numpy()


# -- train: train_ddpm on the card, then the trained nets served ------------------
# The two nets, at full width, on the datasets their task loaders take: CO on
# the training split (35,000 rows) of datasets/3nodes_50000samples_new.csv,
# MSR-3c on the 10,000-row, 10 W set that `tools/make_datasets.py msr
# --samples 10000 --channels 3 --power 10` writes (sum_rate_gen, seed 0;
# 7,000 training rows), under build/. Each trains TRAIN_EPOCHS epochs of its
# task's TrainConfig (batch 512), serves one request at the serving phases'
# batch and runs the forward check at their rows.
# `learns`: after one epoch the net's loss on fixed rows and draws is held
# below the initial net's on the same (`fixed_loss`, a paired comparison);
# CO's falls from 1.006 to 0.288 in an epoch (H100, PR 12). MSR-3c's sits on the
# trivial plateau (~1.0, predicting no noise) for its first epochs: the JAX
# package's own run logged 1.0154 at epoch 0 and 1.0021 at epoch 10
# (ckpts/ddpm_msr_3c/train_log.jsonl), and this phase's run moves it by
# ~0.01 either way; its losses are reported, its steps held to the CPU's. The later epochs are reported, not held to fall: at the
# reference's lr (5e-3, no warm-up, no clip) CO's loss spikes in some runs
# and the net falls back to the plateau, and the card's seed-0 run does so
# in epoch 1 (PERF.md section 6).
TRAIN_SPECS = {
    "co": dict(csv=("datasets", "3nodes_50000samples_new.csv"), serve_B=CO_B, fwd_rows=CO_ROWS,
               learns=True),
    "msr": dict(csv=("build", "datasets", "3c_10w_10000samples.csv"), serve_B=SERVE_B,
                fwd_rows=ROWS, learns=False),
}
TRAIN_EPOCHS = 2
TRAIN_CHECK_STEPS = 3
# Card steps against CPU steps (TRAIN_CHECK_STEPS Adam steps from one init on
# the same injected draws, TF32 off). Adam divides each gradient by its own
# magnitude, so a rounding difference on a near-zero gradient can move its
# parameter by up to 2 lr: a bound on every parameter cannot be tight. So:
# loss within 1e-5 relative, at most 1e-4 of the parameters off by more than
# 1e-4, none by more than 2 lr. This phase measured (H100, PR 12) losses
# equal to the log's 6 decimals and parameters within 3.7e-6 (CO, 774,059)
# and 5.6e-5 (MSR-3c, 1,539,027).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-4
TRAIN_PARAM_SHARE = 1e-4


def check_feasible(kind: str, config, S, Xu, what: str) -> None:
    """Every row of the solutions ``S`` finite and inside its task's
    feasible set, on the unnormalized conditions ``Xu`` (NumPy): CO shares
    >= 0 summing to 1 (or 0: no node offloads); MSR powers >= 0 summing to
    W; NU (``kind`` "nu_budget", "nu_geo" or "nu") the UAV inside the field
    (each row's own for "nu_geo") and powers >= 0 on the row's budget (the
    config's P_sum where the condition carries none)."""
    check(bool(np.isfinite(S).all()), f"{what}: finite solutions")
    if kind == "co":
        sums = S.sum(axis=1)
        check(bool((S >= 0).all()), f"{what}: shares >= 0")
        gap = float(np.where(sums == 0, 0.0, np.abs(sums - 1.0)).max())
        check(gap <= 1e-5, f"{what}: offloaded shares sum to 1 within 1e-5, off by {gap}")
    elif kind == "msr":
        W = config["W"]
        check(bool((S >= 0).all()), f"{what}: p >= 0")
        gap = float(np.abs(S.sum(axis=1) - W).max())
        check(gap <= 1e-4 * W, f"{what}: |sum p - W| = {gap}")
    else:
        K = config["K"]
        box = (Xu[:, 2 * K + 1:2 * K + 3] if kind == "nu_geo"
               else np.array([[config["width"], config["height"]]]))
        budget = Xu[:, 2 * K] if Xu.shape[1] > 2 * K else np.full(len(S), config["P_sum"])
        check(bool(((S[:, :2] >= 0) & (S[:, :2] <= box * (1 + 1e-6))).all()),
              f"{what}: UAV inside each row's own field")
        check(bool((S[:, 2:] >= 0).all()), f"{what}: p >= 0")
        gap = float((np.abs(S[:, 2:].sum(axis=1) - budget) / budget).max())
        check(gap <= 1e-4, f"{what}: powers off their row's budget by {gap} (relative)")


def train_phase(dev):
    """The ``train`` phase: for CO and MSR-3c, ``train_ddpm`` from
    ``torch_style_init`` on the card (losses finite, CO's falling; steps/s,
    seconds per epoch, peak memory), a run checkpointed after epoch 1 and
    resumed (under the profiler: the device's busy share of that epoch;
    equal to the uninterrupted run bit for bit), card steps against CPU
    steps, then the trained checkpoint served through ``fused`` and ``mega``
    f32 (feasible row by row) and both kernels' forwards held to ``plain``
    on the trained weights. Returns (fields, {"fused": n, "mega": n}): the
    serving launches."""
    import dataclasses
    import shutil

    import torch

    from diffsg_tpu_torch.data import ensure_datasets, sum_rate_gen, write_msr_csv
    from diffsg_tpu_torch.diffusion import cosine_schedule, ddpm_loss
    from diffsg_tpu_torch.models import unet_apply_fn, unet_forward_fused
    from diffsg_tpu_torch.models.unet1d import ResidualBlock
    from diffsg_tpu_torch.ops import mega, resblock
    from diffsg_tpu_torch.serve import Solver
    from diffsg_tpu_torch.tasks import TASKS
    from diffsg_tpu_torch.train import EpochDraws, torch_style_init, train_ddpm
    from diffsg_tpu_torch.utils import (load_checkpoint, params_from_jax, params_to_jax,
                                        save_checkpoint)

    ensure_datasets(["3nodes_50000samples_new.csv"])
    msr_csv = os.path.join(REPO, *TRAIN_SPECS["msr"]["csv"])
    if not os.path.exists(msr_csv):
        os.makedirs(os.path.dirname(msr_csv), exist_ok=True)
        write_msr_csv(msr_csv, *sum_rate_gen(10000, 3, (0.5, 2.5), 10.0, seed=0))
    out_root = os.path.join(REPO, "build", "train_smoke")
    shutil.rmtree(out_root, ignore_errors=True)
    fields, launches = {}, {"fused": 0, "mega": 0}

    def same(a, b):
        """Two flax trees equal bit for bit."""
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return np.array_equal(a, b)

    def flat(tree):
        if isinstance(tree, dict):
            return np.concatenate([flat(tree[k]) for k in sorted(tree)])
        return np.asarray(tree, np.float64).ravel()

    def loss_log(record):
        return lambda msg: record.append((time.perf_counter(), float(msg.rsplit(" ", 1)[1])))

    for name, spec in TRAIN_SPECS.items():
        t_net = time.perf_counter()
        task = TASKS[name]
        data = task.load(os.path.join(REPO, *spec["csv"]))
        cfg = dataclasses.replace(task.train_config, epochs=TRAIN_EPOCHS)
        n = data.X_train.shape[0]
        steps = n // cfg.batch_size
        row = {"train_rows": n, "batch": cfg.batch_size, "steps_per_epoch": steps, "T": cfg.T,
               "lr": cfg.lr, "milestones": list(cfg.milestones)}

        def fixed_loss(net):
            """The loss on the first 4,096 training rows, with the draws of
            one fixed generator: the same for every net."""
            rows0 = slice(0, 8 * cfg.batch_size)
            return float(ddpm_loss(
                net.to(dev), cosine_schedule(cfg.T, device=dev),
                torch.as_tensor(data.Y_train[rows0], dtype=torch.float32, device=dev),
                torch.as_tensor(data.X_train[rows0], dtype=torch.float32, device=dev),
                cfg.uncond_prob, generator=torch.Generator(device=dev).manual_seed(0)))

        # train_ddpm's own init for cfg.seed
        init_loss = fixed_loss(torch_style_init(task.build_model(data.config),
                                                torch.Generator().manual_seed(cfg.seed)))

        # The uninterrupted run, timed: the loss log syncs at each epoch's end.
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, ema, sched = train_ddpm(task.build_model(data.config), data.X_train,
                                        data.Y_train, cfg, log_every=1, log_fn=loss_log(stamps),
                                        device=dev)
        row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        losses = [l for _, l in stamps]
        epoch_s = np.diff([t0] + [t for t, _ in stamps]).tolist()
        check(len(losses) == TRAIN_EPOCHS and bool(np.isfinite(losses).all()),
              f"train {name}: finite loss each epoch, got {losses}")
        def loaded(tree):
            net = task.build_model(data.config)
            net.load_state_dict(params_from_jax(tree))
            return net

        row.update(fixed_loss_init=init_loss, fixed_loss_trained=fixed_loss(loaded(params)),
                   epoch_losses=losses, falls_each_epoch=bool(np.all(np.diff(losses) < 0)),
                   epoch_s=epoch_s,
                   steps_per_s=steps / epoch_s[-1],
                   samples_per_s=steps * cfg.batch_size / epoch_s[-1])

        # Checkpointed after epoch 1, then resumed under the profiler.
        ck_dir = os.path.join(out_root, name, "resume")
        train_ddpm(task.build_model(data.config), data.X_train, data.Y_train,
                   dataclasses.replace(cfg, epochs=1), log_every=0, checkpoint_every=1,
                   checkpoint_dir=ck_dir, device=dev)
        ck = load_checkpoint(ck_dir, device=dev, training=True)
        check(ck["metadata"]["epoch"] == 1 and ck["step"] == steps and "opt_state_raw" in ck,
              f"train {name}: checkpoint at epoch 1, step {steps}, with the optimizer state")
        row["fixed_loss_epoch1"] = fixed_loss(loaded(ck["params"]))
        check(np.isfinite(row["fixed_loss_epoch1"])
              and (row["fixed_loss_epoch1"] < init_loss or not spec["learns"]),
              f"train {name}: after one epoch the loss {row['fixed_loss_epoch1']} on fixed rows "
              f"and draws below the initial net's {init_loss}")
        torch.cuda.synchronize()
        # Device activity only: the host's op events would double what the
        # trace must hold and parse, and its busy share needs none of them.
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            r_params, r_ema, _ = train_ddpm(task.build_model(data.config), data.X_train,
                                            data.Y_train, cfg, log_every=0, resume_state=ck,
                                            device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, -np.inf
        for a, b in spans:                      # the union of the device's intervals
            busy += max(0.0, b - max(a, end))
            end = max(end, b)
        row.update(profiled_epoch_s=wall, device_events=len(spans),
                   device_busy_s=busy * 1e-6 if spans else None,
                   device_busy_share=busy * 1e-6 / wall if spans else None)
        check(same(r_params, params), f"train {name}: resumed params equal the "
                                      "uninterrupted run's bit for bit")
        check(r_ema.n_averaged == ema.n_averaged and all(
            torch.equal(r_ema.params[k], ema.params[k]) for k in ema.params),
            f"train {name}: resumed EMA equals the uninterrupted run's bit for bit")
        row["resume_bitwise"] = True

        # Card steps against CPU steps: one init, the same injected draws.
        rng = np.random.default_rng(1)
        B, k = cfg.batch_size, TRAIN_CHECK_STEPS
        draws = EpochDraws(torch.arange(k * B), torch.as_tensor(rng.integers(0, cfg.T, (k, B))),
                           torch.as_tensor(rng.normal(size=(k, B, data.Y_train.shape[1]))
                                           .astype(np.float32)),
                           torch.as_tensor((rng.uniform(size=(k, B, 1)) >= cfg.uncond_prob)
                                           .astype(np.float32)))
        init = params_to_jax(torch_style_init(task.build_model(data.config),
                                              torch.Generator().manual_seed(1)))
        ran = {}
        for d in ("cpu", dev):
            log = []
            p, _, _ = train_ddpm(task.build_model(data.config), data.X_train[:k * B],
                                 data.Y_train[:k * B], dataclasses.replace(cfg, epochs=1),
                                 init_params=init, log_every=1, log_fn=loss_log(log), device=d,
                                 draws=lambda epoch: draws)
            ran[str(d)] = (log[0][1], flat(p))
        (l_cpu, p_cpu), (l_dev, p_dev) = ran["cpu"], ran[str(dev)]
        diff = np.abs(p_cpu - p_dev)
        row["card_vs_cpu"] = {"steps": k, "loss_cpu": l_cpu, "loss_card": l_dev,
                              "loss_rel": abs(l_cpu - l_dev) / abs(l_cpu),
                              "max_abs": float(diff.max()),
                              "share_over_atol": float((diff > TRAIN_PARAM_ATOL).mean()),
                              "params": int(diff.size)}
        check(row["card_vs_cpu"]["loss_rel"] <= TRAIN_LOSS_RTOL
              and row["card_vs_cpu"]["share_over_atol"] <= TRAIN_PARAM_SHARE
              and row["card_vs_cpu"]["max_abs"] <= 2 * cfg.lr,
              f"train {name}: card steps vs CPU steps {row['card_vs_cpu']}")

        # Save, load through the Solver, serve through both kernels.
        out = os.path.join(out_root, name)
        dataset_config = {k: (v.item() if hasattr(v, "item") else v)
                          for k, v in data.config.items()}
        save_checkpoint(out, params, ema=ema, sched=sched, step=cfg.epochs,
                        metadata={"task": name, "config": dataclasses.asdict(cfg),
                                  "dataset_config": dataset_config})
        B_serve = spec["serve_B"]
        X = np.resize(data.X_test, (B_serve, data.X_test.shape[1])).astype(np.float32)
        served = {}
        for backend in ("fused", "mega"):
            solver = Solver.from_checkpoint(out, task=name, backend=backend, device=dev)
            model = solver.model
            blocks = sum(isinstance(m, ResidualBlock) for m in model.modules())
            want = solver.sched.T * (blocks if backend == "fused" else 1)
            resblock.LAUNCHES = mega.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S = solver.solve(X, seed=0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = resblock.LAUNCHES if backend == "fused" else mega.LAUNCHES
            other = mega.LAUNCHES if backend == "fused" else resblock.LAUNCHES
            check(got == want and other == 0, f"train {name} serve {backend}: {want} launches "
                                              f"and no other, counted {got} and {other}")
            launches[backend] += got
            check(S.shape == (B_serve, model.input_dim) and bool(np.isfinite(S).all()),
                  f"train {name} serve {backend}: finite ({B_serve}, {model.input_dim})")
            check(bool((S >= 0).all()), f"train {name} serve {backend}: every entry >= 0")
            sums = S.sum(axis=1)
            if name == "co":        # offloaded shares sum to 1, or no node offloads
                gap = float(np.where(sums == 0, 0.0, np.abs(sums - 1.0)).max())
                check(gap <= 1e-5, f"train co serve {backend}: shares off 1 by {gap}")
            else:                   # powers sum to the budget W
                W = solver.config["W"]
                gap = float(np.abs(sums - W).max())
                check(gap <= 1e-4 * W, f"train msr serve {backend}: |sum p - W| = {gap}")
            served[backend] = {"B": B_serve, "s": seconds, "launches": got,
                               "feasible_gap": gap}

        # Both kernels' forwards against plain on the trained weights.
        rows = spec["fwd_rows"]
        frng = np.random.default_rng(2)
        y = torch.tensor(frng.normal(size=(rows, model.input_dim)), dtype=torch.float32,
                         device=dev)
        c = torch.tensor(frng.uniform(0, 1, (rows, model.cond_dim)), dtype=torch.float32,
                         device=dev)
        m = torch.cat([torch.zeros(rows // 2, 1), torch.ones(rows // 2, 1)]).to(dev)
        t = torch.full((1,), 0.37, device=dev)
        with torch.no_grad():
            plain = model(y, t, c, m)
            scale = float(plain.abs().max())
            errs = {"fused": float((unet_forward_fused(model, y, t, c, m) - plain).abs().max()),
                    "mega": float((unet_apply_fn(model, "mega")(y, t, c, m) - plain)
                                  .abs().max())}
        for backend, err in errs.items():
            check(err <= FORWARD_RTOL * scale, f"train {name}: {backend} forward on the trained "
                                               f"weights, max abs err {err} vs {scale}")
        row.update(serve=served, forward={"rows": rows, "out_max_abs": scale,
                                          **{f"{b}_max_abs_err": e for b, e in errs.items()}},
                   seconds=time.perf_counter() - t_net)
        fields[name] = row
    return fields, launches


def datasets_gen_phase():
    """The ``datasets_gen`` phase: every ``make_datasets`` subcommand of the
    port at a small size (``DATASETS_GEN``) into ``build/datasets_gen``,
    each file's SHA-256 held to the one the JAX package's CLI writes from the
    same arguments; then the native CO oracle (built here by g++) held to the
    NumPy oracle's labels of the CO file. Returns the phase's fields."""
    import contextlib
    import io
    import shutil

    from diffsg_tpu_torch.data.native import co_oracle_native
    from diffsg_tpu_torch.tools import make_datasets

    shutil.rmtree(GEN_DIR, ignore_errors=True)
    t_all = time.perf_counter()
    files = {}
    for name, (argv, want) in DATASETS_GEN.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):     # the CLI's progress lines
            path = make_datasets.main(argv + ["--out", os.path.join(GEN_DIR, name)])
        got = hashlib.sha256(path.read_bytes()).hexdigest()
        check(got == want, f"datasets_gen {name}: SHA-256 {got}, the JAX package's file {want}")
        files[name] = {"argv": " ".join(argv), "s": time.perf_counter() - t0, "sha256": got}
    data = np.loadtxt(os.path.join(GEN_DIR, "3nodes_600samples.csv"), delimiter=",")
    feats = np.concatenate([data[:, k:18:6] for k in range(5)], axis=1)
    t0 = time.perf_counter()
    native = co_oracle_native(feats)
    native_s = time.perf_counter() - t0
    err = float(np.abs(native[:, 1:] - data[:, 19:22]).max())
    check(np.array_equal(native[:, 0], data[:, 18]) and err <= 1e-12,
          f"datasets_gen: the native CO oracle's labels against the NumPy oracle's "
          f"(classes equal: {np.array_equal(native[:, 0], data[:, 18])}, shares off by {err})")
    return {"files": files, "seconds": time.perf_counter() - t_all,
            "co_oracle_native": {"rows": int(len(data)), "s": native_s,
                                 "classes_equal": True, "max_share_err": err}}


# -- train_clis: the five task-specific training CLIs on the card ------------------
# Each at the full width of the net it ships (ckpts/ddpm_msr_budget: proj 128,
# dims 64-32-16-8; nu_budget and nu_augmented: unet_nu; ddpm_nu_geo_x0f: proj 64,
# dims 64-32-16; the zoo: proj 256, dims 256-128-64-32, canvas 80) and its
# recipe's flags, on the datasets_gen files, one epoch. Cut: the epochs (1 of
# 100-200), the rows (the datasets_gen files, --samples, --msr80-samples,
# --msr8-samples: PERF.md section 4) and the eval sets (datasets_gen's). Each
# trained checkpoint is then served at ``serve_B`` on the ``rows`` of
# quality_rows (``cols`` of them) with ``config``, as ``task``.
def train_cli_specs():
    def g(name):
        return os.path.join(GEN_DIR, name)

    nu_eval = ["--indist", g("3u_18mW_400samples.csv"), "--ood", g("3u_30mW_200samples_ood.csv")]
    return {
        "msr_budget": dict(
            module="train_msr_budget", task="msr_budget", rows=("msr", 1024, 5.0),
            config={"W": 5.0}, serve_B=SERVE_B, kind="msr",
            argv=["--samples", "16384", "--lr", "2e-3", "--milestones", "30", "60",
                  "--epochs", "1", "--omegas", "1.0", "--indist", g("3c_10w_1000samples.csv"),
                  "--ood", g("3c_20w_500samples_ood.csv")]),
        "nu_budget": dict(
            module="train_nu_budget", task="nu_budget", rows=("nu_budget", 4096, 30.0),
            config={"P_sum": 30.0}, serve_B=MULTI_NU_B, kind="nu_budget",
            argv=["--budget-dataset", g("3u_budget9-36_400samples.csv"), "--times", "16",
                  "--lr", "4e-3", "--milestones", "80", "200", "--epochs", "1",
                  "--omegas", "0.125", *nu_eval]),
        "nu_geo": dict(
            module="train_nu_geo", task="nu_geo", rows=("nu_geo", 4096), serve_B=MULTI_NU_B,
            kind="nu_geo",
            argv=["--geo-dataset", g("3u_geo200-600_400samples.csv"),
                  g("3u_geo_focus_300samples.csv"), "--budget-dataset",
                  g("3u_budget9-36_400samples.csv"), "--with-ref-indist", "--times", "8",
                  "--proj-dim", "64", "--dims", "64", "32", "16", "--parameterization", "x0",
                  "--lr", "2e-3", "--milestones", "80", "200", "--epochs", "1",
                  "--omegas", "0.5", *nu_eval]),
        "nu_augmented": dict(
            module="train_nu_augmented", task="nu_direct", rows=("nu_budget", 4096, 18.0),
            cols=6, serve_B=MULTI_NU_B, kind="nu",
            argv=["--dataset", g("3u_18mW_400samples.csv"), "--ood",
                  g("3u_30mW_200samples_ood.csv"), "--times", "32", "--y-scale", "8",
                  "--center", "--epochs", "1", "--omegas", "0.125"]),
        "multi": dict(
            module="train_multi", task="multi_msr80", rows=("msr", 512, 20.0, 80),
            config={"W": 20.0}, serve_B=SERVE_B, kind="msr",
            argv=["--nu-mode", "geo", "--with-msr80", "--with-msr8", "--proj-dim", "256",
                  "--dims", "256", "128", "64", "32", "--lr", "5e-4", "--milestones", "90",
                  "160", "--grad-clip", "0.25", "--parameterization", "x0", "--epochs", "1",
                  "--msr-dataset", g("3c_10w_1000samples.csv"),
                  "--co-dataset", g("3nodes_600samples.csv"),
                  "--nu-dataset", g("3u_18mW_400samples.csv"),
                  "--nu-budget-dataset", g("3u_budget9-36_400samples.csv"),
                  "--nu-geo-datasets", g("3u_geo200-600_400samples.csv"),
                  g("3u_geo_focus_300samples.csv"),
                  "--msr80-samples", "4096", "--msr8-samples", "2048",
                  "--msr-ood", g("3c_20w_500samples_ood.csv"),
                  "--co-ood", g("3nodes_300samples_ood.csv"),
                  "--nu-ood", g("3u_30mW_200samples_ood.csv"),
                  "--msr80-evals", g("80c_20w_wf_500samples.csv"),
                  g("80c_40w_wf_300samples_ood.csv"),
                  "--msr8-evals", g("8c_10w_wf_500samples.csv"),
                  g("8c_20w_wf_300samples_ood.csv"),
                  "--nu-geo-evals", g("3u_geo480x360_21mW_150samples.csv")]),
    }


def train_clis_phase(dev):
    """The ``train_clis`` phase: each CLI of ``train_cli_specs`` in this
    process on the card (its log, checkpoint and eval lines under
    build/train_clis), its losses and eval metrics finite; the checkpoint
    served by ``Solver.from_checkpoint`` through ``fused`` and ``mega`` f32,
    one request each, launches counted, every row feasible; both kernels'
    forwards held to ``plain`` on the trained weights. Returns (fields,
    {"fused": n, "mega": n}): the serving launches."""
    import contextlib
    import importlib
    import io
    import shutil

    import torch

    from diffsg_tpu_torch.models import unet_apply_fn
    from diffsg_tpu_torch.models.unet1d import ResidualBlock
    from diffsg_tpu_torch.ops import mega, resblock
    from diffsg_tpu_torch.serve import Solver
    from diffsg_tpu_torch.train import TrainConfig
    from diffsg_tpu_torch.utils import load_checkpoint

    out_root = os.path.join(REPO, "build", "train_clis")
    shutil.rmtree(out_root, ignore_errors=True)
    fields, launches = {}, {"fused": 0, "mega": 0}
    for name, spec in train_cli_specs().items():
        t_cli = time.perf_counter()
        out = os.path.join(out_root, name)
        module = importlib.import_module(f"diffsg_tpu_torch.tools.{spec['module']}")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            module.main(spec["argv"] + ["--out", out])
        cli_s = time.perf_counter() - t_cli
        log = [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))]
        start = next(r for r in log if r["event"] == "start")
        losses = [float(r["msg"].rsplit(" ", 1)[1]) for r in log if r["event"] == "train"]
        train_s = next(r for r in log if r["event"] == "saved")["train_seconds"]
        meta = json.load(open(os.path.join(out, "metadata.json")))
        check(start["device"] == torch.cuda.get_device_name(dev),
              f"train_clis {name}: trained on {start['device']}")
        check(len(losses) == 1 and bool(np.isfinite(losses).all()),
              f"train_clis {name}: a finite loss for the epoch, got {losses}")
        evals = [json.loads(line) for line in printed.getvalue().splitlines()
                 if line.startswith('{"split"')]
        check(bool(evals) and all(np.isfinite(v) for e in evals for v in e.values()
                                  if isinstance(v, float)),
              f"train_clis {name}: finite eval metrics, got {evals}")
        # train_nu_augmented's metadata records no config: its task's batch.
        batch = meta.get("config", {}).get("batch_size", TrainConfig.batch_size)
        epochs = load_checkpoint(out, device="cpu")["step"]
        steps = start["rows"] // batch
        row = {"argv": " ".join(a if not a.startswith(REPO) else os.path.relpath(a, REPO)
                                for a in spec["argv"]),
               "rows": start["rows"], "steps": steps, "epoch_losses": losses,
               "train_seconds": train_s, "epoch_s": train_s / epochs,
               "steps_per_s": steps * epochs / train_s,
               "cli_s": cli_s, "evals": evals}

        # Served through both kernels.
        X = quality_rows(spec["rows"])[:, :spec.get("cols")]
        X = np.concatenate([X] * (spec["serve_B"] // X.shape[0]))
        served = {}
        for backend in ("fused", "mega"):
            solver = Solver.from_checkpoint(out, task=spec["task"], backend=backend, device=dev,
                                            dataset_config=spec.get("config"))
            model = solver.model
            net = getattr(model, "inner", model)
            blocks = sum(isinstance(m, ResidualBlock) for m in net.modules())
            want = solver.sched.T * (blocks if backend == "fused" else 1)
            resblock.LAUNCHES = mega.LAUNCHES = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S = solver.solve(X, seed=0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            got = resblock.LAUNCHES if backend == "fused" else mega.LAUNCHES
            other = mega.LAUNCHES if backend == "fused" else resblock.LAUNCHES
            check(got == want and other == 0, f"train_clis {name} serve {backend}: {want} "
                                              f"launches and no other, counted {got}, {other}")
            launches[backend] += got
            Xu = np.asarray(solver.task.unnormalize_x(X, solver.config), np.float32)
            check(S.shape[0] == spec["serve_B"], f"train_clis {name}: {S.shape[0]} rows served")
            check_feasible(spec["kind"], solver.config, S, Xu, f"train_clis {name} {backend}")
            served[backend] = {"B": spec["serve_B"], "s": seconds, "launches": got}

        # Both kernels' forwards against plain on the trained weights.
        rows = ROWS
        frng = np.random.default_rng(2)
        C = getattr(model, "payload_dim", None) or net.cond_dim
        y = torch.tensor(frng.normal(size=(rows, net.input_dim)), dtype=torch.float32,
                         device=dev)
        c = torch.tensor(frng.uniform(0, 1, (rows, C)), dtype=torch.float32, device=dev)
        m = torch.cat([torch.zeros(rows // 2, 1), torch.ones(rows // 2, 1)]).to(dev)
        t = torch.full((1,), 0.37, device=dev)
        with torch.no_grad():
            plain = unet_apply_fn(model, "plain")(y, t, c, m)
            scale = float(plain.abs().max())
            errs = {b: float((unet_apply_fn(model, b)(y, t, c, m) - plain).abs().max())
                    for b in ("fused", "mega")}
        for backend, err in errs.items():
            check(err <= FORWARD_RTOL * scale, f"train_clis {name}: {backend} forward on the "
                                               f"trained weights, max abs err {err} vs {scale}")
        row.update(serve=served, forward={"rows": rows, "out_max_abs": scale,
                                          **{f"{b}_max_abs_err": e for b, e in errs.items()}},
                   seconds=time.perf_counter() - t_cli)
        fields[name] = row
        torch.cuda.empty_cache()
    return fields, launches


# -- baselines, train_baselines, report: GD, MTFNN, PPO and the comparison CLIs -----
# The test splits: the CO set of datasets/, and two sets made in build/datasets
# (the reference's 3-channel 10 W MSR set and its 18 mW NU set are not in the
# repository): the reference's LRH labels on 10,000 MSR rows, and 1,000 NU
# rows on the 400 x 400 field at grid step 2. Each made file's SHA-256 is the
# JAX package's tools/make_datasets.py output for its recipe.
BASELINE_DATA = {
    "co": (("datasets", "3nodes_50000samples_new.csv"), None, None),
    "msr": (("build", "datasets", "3c_10w_10000samples.csv"),
            ("msr", {"samples": 10000, "channels": 3, "power": 10.0}),
            "25feebddf6eb9c319356e1d46b7003e9d8cc705a7fc9388578c7a52bb8b80980"),
    "nu": (("build", "datasets", "3u_18mW_1000samples.csv"),
           ("nu", {"samples": 1000, "power": 18.0, "grid_step": 2.0, "seed": 0}),
           "6ab5f628e22425bb7d4b6cd82b8b3502980cbaafb944c5279b36de8f8985f70a"),
}
# The shipped baseline checkpoints (tools/train_baselines.py's output) by
# (algo, family).
BASELINE_CKPTS = {("mtfnn", "co"): "retrain_mtfnn_co", ("mtfnn", "nu"): "retrain_mtfnn_nu",
                  ("ppo", "co"): "retrain_ppo_co", ("ppo", "msr"): "retrain_ppo_msr_3c",
                  ("ppo", "nu"): "retrain_ppo_nu"}
# tests/test_baselines.py:362,365's pins of the two CO checkpoints, within 2e-3.
CO_RETRAIN_PINS = {"retrain_mtfnn_co": 1.06299, "retrain_ppo_co": 1.59212}
GD_B = 65_536
# The JAX package's metrics on BASELINE_DATA's test splits (its loaders, the
# flax forward, float32 objectives on the CPU): each shipped checkpoint
# through tools/report.py's run_mtfnn / run_ppo, and GD (run_gd) run op by op
# (jax.disable_jit), which rounds after every op as the port does: XLA's
# compiled CO loop contracts multiply-adds and parts from it on ~30% of rows.
# Deterministic, so held to BASELINE_RTOL. Computed by
# tests/test_torch_report_clis.py::test_chip_smoke_baseline_constants (slow):
#     python -m pytest -m slow tests/test_torch_report_clis.py -k baseline_constants
BASELINE_RTOL = 1e-5
BASELINE_JAX = {
    "retrain_mtfnn_co": {"exceeded_ratio": 1.0630491971969604, "avg_diff": 0.11989863961935043},
    "retrain_mtfnn_nu": {"less_ratio": 0.8854092359542847, "avg_diff": -4.406654625199735e-05},
    "retrain_ppo_co": {"exceeded_ratio": 1.5921201705932617, "avg_diff": 1.126015543937683},
    "retrain_ppo_msr_3c": {"less_ratio": 0.9989832639694214,
                           "avg_diff": -0.0076301321387290955},
    "retrain_ppo_nu": {"less_ratio": 0.4645560681819916, "avg_diff": -0.0002059081889456138},
    "gd_co": {"exceeded_ratio": 1.3196297883987427, "avg_diff": 0.6078296899795532},
    "gd_msr": {"less_ratio": 0.9984303116798401, "avg_diff": -0.011779670603573322},
    "gd_nu": {"less_ratio": 0.8483281135559082, "avg_diff": -5.8326324506197125e-05},
}
# The report phase's DDPM rows (tools/report.py's protocol: evaluate, 512 rows
# a batch): CO through co_ranked on ckpts/ddpm_co_x0 at omega 1, MSR-3c on
# ckpts/ddpm_msr_3c_T100 (DDPM T=100) at omega 500, NU through nu_direct on
# ckpts/ddpm_nu_3u_aug32_s8c with DDIM-3 at omega 0.125; each with the baseline
# rows that have a checkpoint. ``seeds``: the JAX draws behind the constants.
REPORT_SPECS = {
    "co": dict(task="co_ranked", ckpt="ddpm_co_x0", argv=["--omegas", "1"], seeds=2),
    "msr": dict(task="msr", ckpt="ddpm_msr_3c_T100", argv=["--omegas", "500"], seeds=8),
    "nu": dict(task="nu_direct", ckpt="ddpm_nu_3u_aug32_s8c",
               argv=["--omegas", "0.125", "--sampler", "ddim", "--n-steps", "3"], seeds=64),
}
# The JAX package's evaluate on each spec: per metric the mean over JAX seeds
# 0 to K-1 (K the spec's ``seeds``: 2 on CO's 30 batches, 8 on MSR-3c's 6, 64
# on NU's one) and 4 standard errors of one draw (at least 1e-6 of the mean;
# one row for a count), from the seed-to-seed variance of each 512-row
# batch's contribution: the MSR decoder's batch-global min-max ties a batch's
# rows together, and per-row variances (EVAL_JAX's way) understate MSR-3c's
# spread 3x: they put a card draw 1.9 tolerances off (PERF.md section 6).
# Computed by
# tests/test_torch_report_clis.py::test_chip_smoke_report_constants (slow):
#     python -m pytest -m slow tests/test_torch_report_clis.py -k report_constants
REPORT_JAX = {
    "co": {"exceeded_ratio": (1.0018973350524902, 0.0004272470895293353),
           "avg_diff": (0.003608160885050893, 0.0008124930945224258),
           "decision_accuracy": (0.9443000000000003, 0.007364781055808767),
           "terrible_count": (0.0, 1.0)},
    "msr": {"less_ratio": (0.9958694577217102, 0.0011169118181003758),
            "avg_diff": (-0.030997756868600845, 0.008381994668819037)},
    "nu": {"less_ratio": (0.9993964433670044, 0.00026241813434792633),
           "avg_diff": (-2.320828684787557e-07, 1.0091819369068218e-07)},
}
# The fewstep runs: nu_direct through mega (the production NU row's backend),
# co_ranked through fused; steps 3, 5, 10 and 20 and the DDPM row.
FEWSTEP_SPECS = {
    "nu": dict(backend="mega", argv=["--omega", "0.125", "--steps", "3", "5", "10", "20"]),
    "co": dict(backend="fused", argv=["--omega", "1", "--steps", "3", "5", "10", "20"]),
}


def baseline_splits():
    """{family: the CSV's path}: BASELINE_DATA's files, made where missing,
    each made file's SHA-256 held to the JAX package's."""
    from diffsg_tpu_torch.data import ensure_datasets
    from diffsg_tpu_torch.data.datasets import make_rows, write_csv

    ensure_datasets(["3nodes_50000samples_new.csv"])
    paths = {}
    for fam, (parts, recipe, sha) in BASELINE_DATA.items():
        path = paths[fam] = os.path.join(REPO, *parts)
        if recipe is None:
            continue
        if not os.path.exists(path):
            write_csv(path, make_rows(recipe[0], **recipe[1]))
        with open(path, "rb") as f:
            check(hashlib.sha256(f.read()).hexdigest() == sha,
                  f"baselines: {parts[-1]} remade as the JAX package makes it")
    return paths


def _metrics_within(what, got, want, rtol):
    for k, v in want.items():
        check(np.isfinite(got[k]) and abs(got[k] - v) <= rtol * abs(v),
              f"{what}: {k} {got[k]} vs the JAX package's {v} (rtol {rtol})")


def baselines_phase(dev):
    """The ``baselines`` phase: GD on each family at GD_B rows on the card,
    held to the CPU on the same rows and feasible row by row (solutions/s);
    the five shipped checkpoints' predictions on the test splits, each
    metric held to BASELINE_JAX and the CO pair to its pins; one train_mtfnn
    and one train_ppo epoch over CO's training split on the card and on the
    CPU from one init on the same injected draws, the parameters held to
    the train phase's bounds."""
    import dataclasses

    import torch

    from diffsg_tpu_torch.baselines import (MTFNNConfig, PPOConfig, PPODraws, mtfnn_co_model,
                                            orthogonal_ppo_init, train_mtfnn, train_ppo)
    from diffsg_tpu_torch.tasks import TASKS, objective_metrics
    from diffsg_tpu_torch.tools import report, train_baselines
    from diffsg_tpu_torch.train import torch_style_init
    from diffsg_tpu_torch.utils import params_from_jax, params_to_jax

    paths = baseline_splits()
    data = {fam: TASKS[fam].load(p) for fam, p in paths.items()}
    out = {"splits": {fam: {"csv": os.path.relpath(p, REPO), "test_rows": len(data[fam].X_test)}
                      for fam, p in paths.items()}}

    # GD at GD_B rows (the test split repeated), through the report's runner.
    gd = {}
    for fam, d in data.items():
        big = dataclasses.replace(d, X_test=np.resize(d.X_test, (GD_B, d.X_test.shape[1])))
        secs = []
        for _ in range(4):
            t0 = time.perf_counter()
            S = report.run_gd(fam, big, TASKS[fam], dev)      # ends with a copy to the host
            secs.append(time.perf_counter() - t0)
        S_cpu = report.run_gd(fam, big, TASKS[fam], torch.device("cpu"))
        err = float(np.abs(S - S_cpu).max() / np.abs(S_cpu).max())
        check(bool(np.isfinite(S).all()) and err <= BASELINE_RTOL,
              f"baselines gd {fam}: card vs CPU {err} of the magnitude")
        if fam == "msr":
            gap = float(np.abs(S.sum(1) - d.config["W"]).max() / d.config["W"])
        elif fam == "nu":
            gap = float(np.abs(S[:, 2:].sum(1) - d.config["P_sum"]).max() / d.config["P_sum"])
        else:                       # min-max per row: each row spans [0, 1]
            gap = float(np.abs(S.min(1)).max() + np.abs(S.max(1) - 1).max())
        check(gap <= 1e-5, f"baselines gd {fam}: feasibility off by {gap}")
        gd[fam] = {"B": GD_B, "card_vs_cpu": err, "bitwise": bool(np.array_equal(S, S_cpu)),
                   "feasibility_gap": gap, "s": secs[1:],
                   "solutions_per_s": GD_B / float(np.median(secs[1:]))}
    out["gd"] = gd

    # The shipped checkpoints on the test splits.
    retrain = {}
    for (algo, fam), name in BASELINE_CKPTS.items():
        run = report.run_mtfnn if algo == "mtfnn" else report.run_ppo
        Y = run(fam, data[fam], os.path.join(REPO, "ckpts", name), dev)
        m = objective_metrics(TASKS[fam], data[fam], Y, device=dev)
        _metrics_within(f"baselines {name}", m, BASELINE_JAX[name], BASELINE_RTOL)
        if name in CO_RETRAIN_PINS:
            check(abs(m["exceeded_ratio"] - CO_RETRAIN_PINS[name]) <= 2e-3,
                  f"baselines {name}: exceeded ratio {m['exceeded_ratio']} vs its pin "
                  f"{CO_RETRAIN_PINS[name]}")
        retrain[name] = {"rows": len(Y), **m}
    out["checkpoints"] = retrain

    # One epoch of each trainer, card and CPU, one init and the same draws.
    co = data["co"]
    n = co.X_train.shape[0]
    B = 512
    steps = n // B
    rng = np.random.default_rng(3)
    perm = torch.from_numpy(rng.permutation(n))
    agent, labels = train_baselines.ppo_recipe("co", co.config)[:2]
    A = agent.action_dim
    z0 = rng.normal(size=(steps * B, A)).astype(np.float32)
    draws = PPODraws(torch.from_numpy(rng.permutation(steps * B)),
                     torch.from_numpy(rng.normal(size=(steps, B, A)).astype(np.float32)))
    inits = {"mtfnn": params_to_jax(torch_style_init(mtfnn_co_model(),
                                                     torch.Generator().manual_seed(3))),
             "ppo": params_to_jax(orthogonal_ppo_init(agent, torch.Generator().manual_seed(3)))}
    epochs = {}
    for algo in ("mtfnn", "ppo"):
        ran = {}
        for d in ("cpu", dev):
            log = []
            t0 = time.perf_counter()
            if algo == "mtfnn":
                p = train_mtfnn(mtfnn_co_model(), co.X_train, co.Y_train, MTFNNConfig(epochs=1),
                                log_fn=log.append, log_every=1, init_params=inits[algo],
                                device=d, draws=lambda e: perm)
            else:
                a, _, env_fn, transform, _, _ = train_baselines.ppo_recipe("co", co.config)
                p, _ = train_ppo(a, co.X_train, labels(co.Y_train), env_fn, transform,
                                 PPOConfig(epochs=1), log_fn=log.append, log_every=1,
                                 init_params=inits[algo], device=d, a0=z0,
                                 draws=lambda e: draws)
            if str(d) != "cpu":
                torch.cuda.synchronize()
            ran[str(d)] = (torch.cat([v.flatten() for v in params_from_jax(p).values()]),
                           log[0], time.perf_counter() - t0)
        (p_cpu, log_cpu, s_cpu), (p_dev, log_dev, s_dev) = ran["cpu"], ran[str(dev)]
        diff = (p_cpu - p_dev).abs()
        row = {"steps": steps, "log_cpu": log_cpu, "log_card": log_dev, "card_s": s_dev,
               "cpu_s": s_cpu, "steps_per_s": steps / s_dev, "max_abs": float(diff.max()),
               "share_over_atol": float((diff > TRAIN_PARAM_ATOL).float().mean()),
               "params": int(diff.numel())}
        if algo == "mtfnn":
            l_cpu, l_dev = (float(s.rsplit(" ", 1)[1]) for s in (log_cpu, log_dev))
            row["loss_rel"] = abs(l_cpu - l_dev) / abs(l_cpu)
            check(row["loss_rel"] <= TRAIN_LOSS_RTOL, f"baselines {algo} epoch: loss {row}")
        check(row["share_over_atol"] <= TRAIN_PARAM_SHARE and row["max_abs"] <= 2 * 5e-3,
              f"baselines {algo} epoch: card vs CPU parameters {row}")
        epochs[algo] = row
    out["epoch_card_vs_cpu"] = epochs
    return out


# train_baselines: the CLI for TRAIN_BASELINE_EPOCHS epochs in each (algo,
# family) of the shipped checkpoints, on BASELINE_DATA's files (a cut from the
# recipes' 50 to 200 epochs); each checkpoint then read back by report.
TRAIN_BASELINE_EPOCHS = 2


def train_baselines_phase(dev):
    """The ``train_baselines`` phase: ``tools/train_baselines.py`` on the card
    for each shipped checkpoint's (algo, family), its log and metric row
    finite (steps/s, seconds an epoch); then ``tools/report.py`` reads each
    family's new checkpoints, its rows finite."""
    import contextlib
    import io
    import shutil

    import torch

    from diffsg_tpu_torch.tools import train_baselines

    paths = baseline_splits()
    out_root = os.path.join(REPO, "build", "train_baselines")
    shutil.rmtree(out_root, ignore_errors=True)
    fields, outs = {}, {}
    for algo, fam in BASELINE_CKPTS:
        out = outs[algo, fam] = os.path.join(out_root, f"{algo}_{fam}")
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            train_baselines.main([algo, "--task", fam, "--dataset", paths[fam], "--out", out,
                                  "--epochs", str(TRAIN_BASELINE_EPOCHS)])
        cli_s = time.perf_counter() - t0
        log = [json.loads(line) for line in open(os.path.join(out, "train_log.jsonl"))]
        start = next(r for r in log if r["event"] == "start")
        done = next(r for r in log if r["event"] == "trained")
        (row,) = [json.loads(line) for line in printed.getvalue().splitlines()
                  if line.startswith('{"algo"')]
        check(start["device"] == torch.cuda.get_device_name(dev),
              f"train_baselines {algo} {fam}: trained on {start['device']}")
        check(all(np.isfinite(v) for v in row.values() if isinstance(v, float)),
              f"train_baselines {algo} {fam}: finite metrics {row}")
        steps = done["steps_per_epoch"] * done["epochs"]
        fields[f"{algo}_{fam}"] = {
            "rows": start["rows"], "epochs": done["epochs"], "steps": steps,
            "train_seconds": done["train_seconds"],
            "epoch_s": done["train_seconds"] / done["epochs"],
            "steps_per_s": steps / done["train_seconds"], "cli_s": cli_s,
            "log": [r["msg"] for r in log if r["event"] == "train"],
            "metrics": {k: v for k, v in row.items() if k not in ("algo", "task")}}
    for fam in ("co", "msr", "nu"):
        argv = ["--task", fam, "--datasets", paths[fam], "--baselines"]
        algos = [a for a, f in BASELINE_CKPTS if f == fam]
        argv += algos + [x for a in algos for x in (f"--{a}-ckpt", outs[a, fam])]
        rows = run_report(argv, os.path.join(out_root, f"report_{fam}.jsonl"))
        check([r["solver"] for r in rows] == algos and all(
            np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float)),
            f"train_baselines: report on the new {fam} checkpoints {rows}")
        fields[f"report_{fam}"] = {r["solver"]: {k: v for k, v in r.items() if k not in (
            "solver", "task", "dataset")} for r in rows}
    return fields


def run_report(argv, out):
    """``tools/report.py`` in this process, its rows from ``out``."""
    import contextlib
    import io

    from diffsg_tpu_torch.tools import report

    if os.path.exists(out):
        os.remove(out)
    with contextlib.redirect_stdout(io.StringIO()):
        report.main(argv + ["--out", out])
    return [json.loads(line) for line in open(out)]


def report_phase(dev):
    """The ``report`` phase: ``tools/report.py`` on CO, MSR-3c and NU, one
    DDPM row (fused) held to REPORT_JAX and the baseline rows with a
    checkpoint held to BASELINE_JAX; then ``tools/fewstep.py`` on nu_direct
    (mega) and co_ranked (fused), its rows finite and the NU DDIM-3 row held
    to the report's DDIM-3 constant. Launches counted per run against the
    batches, steps and blocks. Returns (fields, {"fused": n, "mega": n})."""
    import contextlib
    import io

    from diffsg_tpu_torch.ops import mega, resblock
    from diffsg_tpu_torch.tasks import TASKS
    from diffsg_tpu_torch.tools import fewstep

    paths = baseline_splits()
    out_root = os.path.join(REPO, "build", "report_smoke")
    os.makedirs(out_root, exist_ok=True)
    fields, launches = {}, {"fused": 0, "mega": 0}
    for fam, spec in REPORT_SPECS.items():
        ckpt = os.path.join(REPO, "ckpts", spec["ckpt"])
        algos = [a for a, f in BASELINE_CKPTS if f == fam]
        argv = (["--task", spec["task"], "--datasets", paths[fam], "--ckpt", ckpt, *spec["argv"],
                 "--baselines", "gd", *algos]
                + [x for a in algos for x in (f"--{a}-ckpt",
                                              os.path.join(REPO, "ckpts", BASELINE_CKPTS[a, fam]))])
        resblock.LAUNCHES = mega.LAUNCHES = 0
        t0 = time.perf_counter()
        rows = run_report(argv, os.path.join(out_root, f"report_{fam}.jsonl"))
        seconds = time.perf_counter() - t0
        n_test = int(rows[0]["n_samples"])
        T, blocks = _steps_and_blocks(ckpt)
        steps = 3 if "--n-steps" in spec["argv"] else T
        want = -(-n_test // 512) * steps * blocks
        check(resblock.LAUNCHES == want and mega.LAUNCHES == 0,
              f"report {fam}: {want} fused launches, counted {resblock.LAUNCHES} and "
              f"{mega.LAUNCHES} mega")
        launches["fused"] += want
        check([r["solver"] for r in rows] == [rows[0]["solver"], "gd", *algos],
              f"report {fam}: rows {[r['solver'] for r in rows]}")
        for k, (mean, tol) in REPORT_JAX[fam].items():
            check(np.isfinite(rows[0][k]) and abs(rows[0][k] - mean) <= tol,
                  f"report {fam}: {k} {rows[0][k]} vs the JAX package's {mean} (+-{tol})")
        for r in rows[1:]:
            name = f"gd_{fam}" if r["solver"] == "gd" else BASELINE_CKPTS[r["solver"], fam]
            _metrics_within(f"report {fam} {r['solver']}", r, BASELINE_JAX[name], BASELINE_RTOL)
        fields[fam] = {"argv": spec["argv"], "seconds": seconds, "launches": want,
                       "rows": [{k: v for k, v in r.items() if k not in ("task", "dataset")}
                                for r in rows],
                       "ddpm_diff_over_tol": {k: abs(rows[0][k] - m) / t
                                              for k, (m, t) in REPORT_JAX[fam].items()}}

    for fam, spec in FEWSTEP_SPECS.items():
        rspec = REPORT_SPECS[fam]
        ckpt = os.path.join(REPO, "ckpts", rspec["ckpt"])
        argv = ["--task", rspec["task"], "--ckpt", ckpt, "--datasets", paths[fam],
                "--backend", spec["backend"], *spec["argv"]]
        printed = io.StringIO()
        resblock.LAUNCHES = mega.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            fewstep.main(argv)
        seconds = time.perf_counter() - t0
        rows = [json.loads(line) for line in printed.getvalue().splitlines()
                if line.startswith("{")]
        T, blocks = _steps_and_blocks(ckpt)
        n_test = len(TASKS[rspec["task"]].load(paths[fam]).X_test)
        steps = [int(s) for s in spec["argv"][spec["argv"].index("--steps") + 1:]]
        want = -(-n_test // 512) * (T + sum(steps)) * (blocks if spec["backend"] == "fused" else 1)
        counted, other = ((resblock.LAUNCHES, mega.LAUNCHES) if spec["backend"] == "fused"
                          else (mega.LAUNCHES, resblock.LAUNCHES))
        check(counted == want and other == 0, f"fewstep {fam}: {want} {spec['backend']} "
                                              f"launches, counted {counted} and {other}")
        launches[spec["backend"]] += want
        check([(r["sampler"], r["steps"]) for r in rows]
              == [("ddpm", T)] + [("ddim", s) for s in steps]
              and all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float)),
              f"fewstep {fam}: rows {rows}")
        if fam == "nu":
            for k, (mean, tol) in REPORT_JAX["nu"].items():
                check(abs(rows[1][k] - mean) <= tol, f"fewstep nu DDIM-3: {k} {rows[1][k]} vs "
                                                     f"the JAX package's {mean} (+-{tol})")
        fields[f"fewstep_{fam}"] = {"backend": spec["backend"], "seconds": seconds,
                                    "launches": want,
                                    "rows": [{k: v for k, v in r.items()
                                              if k not in ("task", "dataset")} for r in rows]}
    return fields, launches


def _steps_and_blocks(ckpt):
    """(T, residual blocks a forward) of the checkpoint ``ckpt`` (a path, or
    a name under ``ckpts/``), from its arrays' names (each block has one
    ``lin3``)."""
    with np.load(os.path.join(REPO, "ckpts", ckpt, "arrays.npz")) as z:
        return (int(z["schedule/betas"].shape[0]),
                sum(k.startswith("params/") and k.endswith("/lin3/kernel") for k in z.files))


def _within(what, got, constants):
    """Hold each metric of ``got`` to its (mean, tolerance); returns each
    metric's distance over its tolerance."""
    for k, (mean, tol) in constants.items():
        check(np.isfinite(got[k]) and abs(got[k] - mean) <= tol,
              f"{what}: {k} {got[k]} vs the JAX package's {mean} (+-{tol})")
    return {k: abs(got[k] - m) / t for k, (m, t) in constants.items()}


def headline_constants(name):
    """The JAX constants of headline row ``name``."""
    if name in HEADLINE_EVAL:
        return {**EVAL_JAX, **EVAL_ZOO_JAX}[HEADLINE_EVAL[name]]
    return HEADLINE_JAX[name]


def _counted(what, fn, fused=0, mega=0):
    """Run ``fn()`` with its standard output swallowed, both launch counters
    set to 0 just before it and read once the card has finished; check them
    against ``fused`` residual-block and ``mega`` launches (each a number,
    or a function of ``fn``'s result). Returns (result, seconds, counts),
    the counts as the wrappers counted them."""
    import contextlib
    import io

    import torch

    from diffsg_tpu_torch.ops import mega as mega_op
    from diffsg_tpu_torch.ops import resblock

    resblock.LAUNCHES = mega_op.LAUNCHES = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn()
    torch.cuda.synchronize()
    counts = {"fused": resblock.LAUNCHES, "mega": mega_op.LAUNCHES}
    want = {"fused": fused(out) if callable(fused) else fused,
            "mega": mega(out) if callable(mega) else mega}
    check(counts == want, f"{what}: {want} launches wanted, counted {counts}")
    return out, time.perf_counter() - t0, counts


def _add(total, counts):
    for backend, n in counts.items():
        total[backend] += n


def headline_phase(dev):
    """The ``headline`` phase: the port's ``tools/headline.py`` (its
    ``main``) in the two HEADLINE_ARGV runs, every row held to its JAX
    constant and its fused launches counted against its batches, candidates,
    steps and blocks; ``tools/eval_nu_geo.py`` on ``ckpts/ddpm_nu_geo``, the
    rows that are headline rows held to their constants; ``tools/co_guided.py``
    (plain) in the CO_GUIDED_RUNS, held to CO_GUIDED_JAX, the guided row at
    omega 0 apart from the unguided one. Returns (fields, launches)."""
    import torch

    from diffsg_tpu_torch.ops import mega, resblock
    from diffsg_tpu_torch.tools import co_guided, eval_nu_geo, headline

    rows, launches, t_row = {}, {"fused": 0, "mega": 0}, [0.0]

    def on_row(row, metrics):
        torch.cuda.synchronize()
        T, blocks = _steps_and_blocks(row.ckpt)
        want = -(-int(metrics["n_samples"]) // 512) * row.eval_kw.get("best_of", 1) * T * blocks
        counts = {"fused": resblock.LAUNCHES, "mega": mega.LAUNCHES}
        check(counts == {"fused": want, "mega": 0},
              f"headline {row.name!r}: {want} fused launches wanted, counted {counts}")
        _add(launches, counts)
        rows[row.name] = {"seconds": time.perf_counter() - t_row[0], "launches": counts["fused"],
                          "metrics": metrics,
                          "diff_over_tol": _within(f"headline {row.name!r}", metrics,
                                                   headline_constants(row.name))}
        resblock.LAUNCHES = mega.LAUNCHES = 0
        t_row[0] = time.perf_counter()

    runs = []
    for argv in HEADLINE_ARGV:
        t_row[0] = time.perf_counter()
        # on_row takes each row's launches; none may follow the last row.
        printed, seconds, _ = _counted(f"headline {argv}",
                                       lambda: headline.main(argv, on_row=on_row))
        runs.append({"argv": argv, "rows": len(printed), "seconds": seconds})
    check(set(rows) == set(HEADLINE_SEEDS) | set(HEADLINE_EVAL),
          f"headline: rows {sorted(rows)}")

    # eval_nu_geo: its repository-made configs at the two omegas.
    T, blocks = _steps_and_blocks("ddpm_nu_geo")
    omegas = sorted({w for _, w in EVAL_NU_GEO_ROWS})
    lines, seconds, counts = _counted(
        "eval_nu_geo",
        lambda: eval_nu_geo.main(["--ckpt", os.path.join(REPO, "ckpts", "ddpm_nu_geo"),
                                  "--omegas", *map(str, omegas)]),
        fused=lambda printed: sum(-(-int(l["n_samples"]) // 512) * T * blocks
                                  for l in printed if "omega" in l))
    _add(launches, counts)
    metric_lines = [l for l in lines if "omega" in l]
    check(len(metric_lines) == 6, f"eval_nu_geo: {len(metric_lines)} rows")
    geo = {"seconds": seconds, "launches": counts["fused"], "lines": lines, "held": {}}
    for l in metric_lines:
        check(np.isfinite(l["less_ratio"]), f"eval_nu_geo: {l}")
        name = EVAL_NU_GEO_ROWS.get((l["config"], l["omega"]))
        if name is not None:
            geo["held"][name] = _within(f"eval_nu_geo {name!r}", l, HEADLINE_JAX[name])
    check(len(geo["held"]) == len(EVAL_NU_GEO_ROWS), f"eval_nu_geo: held {geo['held']}")

    # co_guided: the guided sampler on the plain forward (no kernel launches).
    co, guided = {"runs": [], "rows": []}, {}
    for argv in CO_GUIDED_RUNS:
        argv = [os.path.join(REPO, a) if a.startswith(("ckpts/", "datasets/")) else a
                for a in argv]
        out, seconds, _ = _counted(f"co_guided {argv}", lambda: co_guided.main(argv))
        co["runs"].append({"argv": argv, "seconds": seconds})
        for r in out:
            key = (r["omega"], r["gscale"])
            guided[key] = r
            co["rows"].append({**r, "diff_over_tol": _within(
                f"co_guided omega {key[0]} gscale {key[1]}", r, CO_GUIDED_JAX[key])})
    check(set(guided) == set(CO_GUIDED_JAX), f"co_guided: rows {sorted(guided)}")
    # At omega 0 the tilt moves the answers further than both tolerances.
    off, on = guided[(0.0, 0.0)], guided[(0.0, 3.0)]
    for k in ("exceeded_ratio", "avg_diff"):
        apart = CO_GUIDED_JAX[(0.0, 0.0)][k][1] + CO_GUIDED_JAX[(0.0, 3.0)][k][1]
        check(abs(on[k] - off[k]) > apart,
              f"co_guided omega 0: {k} {on[k]} at scale 3 and {off[k]} at scale 0, not "
              f"{apart} apart")
    return {"runs": runs, "rows": rows, "eval_nu_geo": geo, "co_guided": co}, launches


def timing_phase(dev):
    """The ``timing`` phase: ``tools/profile_sampler.py``'s profile of one
    MSR-3c sampler call (T=100, B=8,192, omega 500) on ``fused`` and ``mega``,
    each kernel's launches counted in the trace (27 x 100 and 100) and by its
    wrapper (the warm call and the profiled one), the top device operations
    reported; ``tools/serving_latency.py``'s table on NU (``nu_direct``, DDIM-3)
    through a ``mega`` Solver with a bucket per size, each pipelined request's
    result equal to a blocking request of its seed, bit for bit; and
    ``tools/latency_probe.py`` on MSR-3c (plain). Returns (fields, launches)."""
    from diffsg_tpu_torch.tools import latency_probe, profile_sampler, serving_latency

    fields, launches = {"profile": {}}, {"fused": 0, "mega": 0}
    for backend, (kernel, want) in PROFILE_KERNELS.items():
        res, seconds, counts = _counted(
            f"profile_sampler {backend}",
            lambda: profile_sampler.profile(**PROFILE_SPEC, backend=backend, device=dev,
                                            out=os.path.join(REPO, "build", "profile_sampler",
                                                             backend)),
            **{backend: 2 * want})
        _add(launches, counts)
        seen = sum(o["count"] for o in res["ops"] if kernel in o["name"])
        check(seen == want, f"profile_sampler {backend}: {seen} {kernel} kernels in the "
                            f"trace, not {want}")
        fields["profile"][backend] = {
            "seconds": seconds, "kernel_events": seen,
            "device_ms": sum(o["total_ms"] for o in res["ops"]),
            "kernel_ms": sum(o["total_ms"] for o in res["ops"] if kernel in o["name"]),
            "trace_bytes": os.path.getsize(res["trace"]), "top_device_ops": res["ops"][:10]}

    solver = serving_latency.make_solver(NU_CKPT, "nu_direct", SERVING_SIZES, dev, backend="mega")
    reps, depth = SERVING_ARGS["repeats"], SERVING_ARGS["depth"]
    # Three DDIM steps a request; a row's warm request runs its bucket's
    # program eagerly once before the capture and then replays it.
    table, seconds, counts = _counted(
        "serving_latency", lambda: serving_latency.table(solver, SERVING_SIZES, **SERVING_ARGS),
        mega=lambda table: 3 * len(table) * (2 + reps + depth))
    _add(launches, counts)
    for row, X, piped in table:
        blocking, _, counts = _counted(
            f"serving_latency batch {row['batch']}: the blocking twins",
            lambda: [solver.solve(X, seed=1000 + i, sampler="ddim", n_steps=3)
                     for i in range(len(piped))], mega=3 * depth)
        _add(launches, counts)
        for i, (p, b) in enumerate(zip(piped, blocking, strict=True)):
            check(np.array_equal(p, b) and np.isfinite(p).all(),
                  f"serving_latency batch {row['batch']}: pipelined request {i} differs from "
                  f"the blocking one")
    fields["serving_latency"] = {"seconds": seconds, "launches": launches["mega"],
                                 "rows": [row for row, _, _ in table]}

    paths = baseline_splits()
    probe, seconds, _ = _counted(
        "latency_probe",
        lambda: latency_probe.main(["--task", "msr", "--ckpt", CKPT, "--dataset", paths["msr"],
                                    "--repeats", str(LATENCY_REPEATS)]))
    check(probe["single_sample_ms"] > 0 and probe["batched_solutions_per_sec"] > 0
          and probe["T"] == 100, f"latency_probe: {probe}")
    fields["latency_probe"] = {"seconds": seconds, **probe}
    return fields, launches


def research_phase(dev):
    """The ``research`` phase: ``tools/dump_trajectory.py`` on CO (512 rows;
    its last step's block equals ``sample_solutions``' decode of the same
    seed to 1e-6: the host decodes the trajectory, the card the solutions),
    ``tools/refine_labels.py`` with a model seed on a small nu-budget
    set (the other columns passed through byte for byte, feasible labels,
    rates that are the labels' and no lower than before, a mean ratio above
    1), ``tools/refine_study.py`` on BASELINE_DATA's NU set (the best of the
    starts never below start 0) and ``tools/nu12_to_geo15.py`` on that set
    (its SHA-256 held to the JAX CLI's). Returns (fields, launches)."""
    import torch

    from diffsg_tpu_torch.data.datasets import make_rows, write_csv
    from diffsg_tpu_torch.ops import nu_rate
    from diffsg_tpu_torch.tasks import TASKS, sample_solutions
    from diffsg_tpu_torch.tools import dump_trajectory, nu12_to_geo15, refine_labels, refine_study
    from diffsg_tpu_torch.utils import load_checkpoint

    paths = baseline_splits()
    out_root = os.path.join(REPO, "build", "research_smoke")
    os.makedirs(out_root, exist_ok=True)
    fields, launches = {}, {"fused": 0, "mega": 0}

    # dump_trajectory: CO, 512 rows, omega 500, and the same draw through
    # sample_solutions.
    co_ckpt = os.path.join(REPO, "ckpts", "ddpm_co")
    T, blocks = _steps_and_blocks("ddpm_co")
    traj, seconds, counts = _counted(
        "dump_trajectory",
        lambda: dump_trajectory.main(["--task", "co", "--ckpt", co_ckpt, "--dataset", paths["co"],
                                      "--out", os.path.join(out_root, "co_denoise_path.csv"),
                                      "--limit", "512"]),
        fused=T * blocks)
    _add(launches, counts)
    task = TASKS["co"]
    data = task.load(paths["co"])
    ck = load_checkpoint(co_ckpt, device=dev)
    (dec, _), _, ref_counts = _counted(
        "dump_trajectory's sample_solutions twin",
        lambda: sample_solutions(task, ck["params"], ck["sched"], data.X_test[:512], data.config,
                                 omega=500.0, seed=0),
        fused=T * blocks)
    _add(launches, ref_counts)
    D = task.data_dim(data.config)
    # The trajectory is decoded on the host (decode_trace), the solutions on
    # the card: the same softmax of the same last state, to float32 rounding.
    last_err = float(np.abs(traj[:, -D:] - dec).max())
    check(traj.shape == (512, T * D) and np.isfinite(traj).all() and last_err <= 1e-6,
          f"dump_trajectory: shape {traj.shape}; its last step {last_err} from the decode")
    fields["dump_trajectory"] = {"seconds": seconds, "shape": list(traj.shape),
                                 "launches": counts["fused"] + ref_counts["fused"],
                                 "last_step_max_abs_err": last_err}

    # refine_labels: the expert-iteration path on a small nu-budget set.
    src = os.path.join(REPO, *RESEARCH_BUDGET_CSV)
    if not os.path.exists(src):
        write_csv(src, make_rows(RESEARCH_BUDGET_ROWS[0], **RESEARCH_BUDGET_ROWS[1]))
    raw = np.loadtxt(src, delimiter=",")
    dst = os.path.join(out_root, "budget_refined.csv")
    nb_ckpt = os.path.join(REPO, "ckpts", "ddpm_nu_budget")
    T, blocks = _steps_and_blocks("ddpm_nu_budget")
    # One model draw per budget group.
    (stats,), seconds, counts = _counted(
        "refine_labels",
        lambda: refine_labels.main(["--budget-in", src, "--budget-out", dst, "--skip-indist",
                                    "--iters", "50", "--starts", "4", "--model-seed", nb_ckpt]),
        fused=len(np.unique(raw[:, 12])) * T * blocks)
    _add(launches, counts)
    out = np.loadtxt(dst, delimiter=",")
    keep = [c for c in range(raw.shape[1]) if c not in range(6, 12)]
    fields_in = [l.split(",") for l in open(src).read().splitlines()]
    fields_out = [l.split(",") for l in open(dst).read().splitlines()]
    rate = nu_rate(torch.as_tensor(out[:, 6:11], dtype=torch.float32),
                   torch.as_tensor(out[:, :6], dtype=torch.float32)).numpy()
    check(all(a[c] == b[c] for a, b in zip(fields_in, fields_out, strict=True) for c in keep)
          and out[:, 6:8].min() >= 0 and out[:, 6:8].max() <= 400
          and out[:, 8:11].min() >= -1e-5
          and np.allclose(out[:, 8:11].sum(axis=1), raw[:, 12], rtol=1e-5, atol=0)
          and np.allclose(out[:, 11], rate, rtol=1e-4, atol=0)
          and (out[:, 11] >= raw[:, 11]).all() and stats["mean_ratio"] > 1.0,
          f"refine_labels: the CSV contract failed ({stats})")
    fields["refine_labels"] = {"seconds": seconds, "launches": counts["fused"], **stats}

    # refine_study: on BASELINE_DATA's 18 mW NU set.
    study, seconds, counts = _counted(
        "refine_study",
        lambda: refine_study.main(["--iters", "20", "--starts", "4", "--ckpt", nb_ckpt,
                                   "--dataset", paths["nu"]]),
        fused=lambda study: -(-study["n"] // 512) * T * blocks)
    _add(launches, counts)
    check(all(np.isfinite(v) for k, v in study.items() if k not in ("dataset",))
          and all(study[f"random4_it{n}"] >= study[f"random1_it{n}"] for n in (20, 80)),
          f"refine_study: {study}")
    fields["refine_study"] = {"seconds": seconds, "launches": counts["fused"], **study}

    # nu12_to_geo15: the JAX CLI's bytes.
    geo = os.path.join(out_root, "nu_geo15.csv")
    _counted("nu12_to_geo15",
             lambda: nu12_to_geo15.main(["--inp", paths["nu"], "--power", "18", "--width", "400",
                                         "--height", "400", "--out", geo]))
    with open(geo, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    check(sha == NU12_TO_GEO15_SHA256, f"nu12_to_geo15: SHA-256 {sha}")
    fields["nu12_to_geo15"] = {"sha256_match": True}
    return fields, launches


MESH_STORE = os.path.join(REPO, "build", "mesh_store")


def mesh_phase(dev, solver, nu_solver, X, XN, serve, new_launches):
    """The ``mesh`` phase: this process joins a world of one NCCL rank
    (``init_process``, a ``file://`` store under ``build/``), builds
    ``make_mesh(1)`` and serves MSR-3c (``fused``, bucket 8,192, DDPM T=100,
    omega 500) and NU ``nu_direct`` (``mega``, DDIM-3, bucket 524,288) from
    the buckets' CUDA graphs, the collectives captured inside, meshed and
    unmeshed in turns (unmeshed, meshed, meshed, unmeshed; two seeds each):
    at world 1 the collectives add nothing, so the answers are equal bit for
    bit. Then one CO training epoch meshed against unmeshed (bit for bit;
    the ``train`` phase's bounds otherwise), and ``dryrun_multichip(1)`` in
    a spawned process. A failure of NCCL or of a capture raises."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from diffsg_tpu_torch.data import ensure_datasets
    from diffsg_tpu_torch.parallel import init_process, make_mesh
    from diffsg_tpu_torch.parallel.dryrun import dryrun_multichip
    from diffsg_tpu_torch.serve import Solver
    from diffsg_tpu_torch.tasks import TASKS
    from diffsg_tpu_torch.train import train_ddpm

    os.makedirs(os.path.dirname(MESH_STORE), exist_ok=True)
    if os.path.exists(MESH_STORE):
        os.remove(MESH_STORE)
    t0 = time.perf_counter()
    init_process(0, 1, f"file://{MESH_STORE}", "cuda")
    # make_mesh runs one eager all-reduce on each of its groups, so NCCL's
    # communicator exists before a graph captures a collective on it.
    mesh = make_mesh(1)
    out = {"backend": dist.get_backend(), "shape": mesh.shape,
           "device_count": torch.cuda.device_count(), "init_s": time.perf_counter() - t0}
    check(out["backend"] == "nccl", f"mesh: NCCL process group, got {out['backend']}")
    nu_kw = {"omega": NU_OMEGA, "sampler": "ddim", "n_steps": NU_STEPS}
    for name, base, backend, B, Xm, kw, per_req in (
            ("msr", solver, "fused", SERVE_B, X, {}, 2700),
            ("nu", nu_solver, "mega", NU_B, XN, nu_kw, NU_STEPS)):
        solvers = {m: Solver(base.task, base.model, base.sched, base.config, backend=backend,
                             buckets=(B,), mesh=mesh if m == "meshed" else None)
                   for m in ("unmeshed", "meshed")}
        capture_s = {}
        for m, s_ in solvers.items():
            t1 = time.perf_counter()
            with torch.inference_mode():
                s_.warmup(configs=[kw])
            torch.cuda.synchronize()
            capture_s[m] = time.perf_counter() - t1
            check(len(s_._graphs) == 1, f"mesh {name} {m}: one graph captured")
            captured = next(iter(s_._graphs.values())).launches
            check(captured == ((per_req, 0) if backend == "fused" else (0, per_req)),
                  f"mesh {name} {m}: the graph captured {captured} launches, not {per_req}")
        runs = []
        for m in ("unmeshed", "meshed", "meshed", "unmeshed"):
            reqs, n_fused, n_mega = serve(lambda seed: solvers[m].solve(Xm, seed=seed, **kw),
                                          range(2))
            counted, other = (n_fused, n_mega) if backend == "fused" else (n_mega, n_fused)
            check(counted == 2 * per_req and other == 0,
                  f"mesh {name} {m}: {per_req} {backend} launches a request, counted {counted} "
                  f"and {other}")
            new_launches[backend] += counted
            runs.append((m, reqs))
        ref = {r["seed"]: r["P"] for r in runs[0][1]}
        diff = max(float(np.abs(r["P"] - ref[r["seed"]]).max()) for _, reqs in runs for r in reqs)
        check(all(np.array_equal(r["P"], ref[r["seed"]]) for _, reqs in runs for r in reqs),
              f"mesh {name}: meshed and unmeshed answers differ (max abs {diff})")
        check(bool(np.isfinite(ref[0]).all()) and ref[0].shape == (B, base.task.data_dim(
            base.config)), f"mesh {name}: finite solutions of shape {ref[0].shape}")
        out[name] = {"B": B, "backend": backend, **kw, "capture_s": capture_s,
                     "launches_per_request": per_req, "max_abs_diff": diff,
                     "turns": [{"mode": m, "request_s": [r["s"] for r in reqs],
                                "solutions_per_s": B / float(np.median([r["s"] for r in reqs]))}
                               for m, reqs in runs]}
        del solvers, runs, ref
        torch.cuda.empty_cache()

    # One CO epoch, meshed against unmeshed, from train_ddpm's own init.
    ensure_datasets(["3nodes_50000samples_new.csv"])
    task = TASKS["co"]
    data = task.load(os.path.join(REPO, "datasets", "3nodes_50000samples_new.csv"))
    cfg = dataclasses.replace(task.train_config, epochs=1)
    trained, epoch_s, losses = {}, {}, {}
    for m in ("unmeshed", "meshed"):
        logged = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.enable_grad():
            trained[m] = train_ddpm(task.build_model(data.config), data.X_train, data.Y_train,
                                    cfg, log_every=1, log_fn=logged.append, device=dev,
                                    mesh=mesh if m == "meshed" else None)[0]
        torch.cuda.synchronize()
        epoch_s[m] = time.perf_counter() - t1
        losses[m] = float(logged[-1].rsplit(" ", 1)[1])

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [np.asarray(tree)]

    a, b = leaves(trained["unmeshed"]), leaves(trained["meshed"])
    off = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
    bitwise = all(np.array_equal(x, y) for x, y in zip(a, b))
    check(bitwise or (float((off > TRAIN_PARAM_ATOL).mean()) <= TRAIN_PARAM_SHARE
                      and abs(losses["meshed"] - losses["unmeshed"])
                      <= TRAIN_LOSS_RTOL * abs(losses["unmeshed"])),
          f"mesh: the meshed CO epoch off the unmeshed one (max {float(off.max())})")
    out["train_co"] = {"rows": int(data.X_train.shape[0]), "batch": cfg.batch_size,
                       "epoch_s": epoch_s, "loss": losses, "bitwise": bitwise,
                       "max_abs_param_diff": float(off.max())}
    dist.destroy_process_group()

    t1 = time.perf_counter()
    dry = dryrun_multichip(1, device="cuda", timeout_s=300)
    check(dry["serve_max_abs_err"] is not None and dry["serve_max_abs_err"] < 1e-3,
          f"mesh: dryrun_multichip(1) serve error {dry['serve_max_abs_err']}")
    out["dryrun"] = {**dry, "s": time.perf_counter() - t1}
    return out


LEGACY_B, LEGACY_T = 1024, 20
LEGACY_ATOL = 1e-4


def legacy_phase(dev, model):
    """The ``legacy`` phase: ``legacy_sample`` (MSR clamp, T=20, 1,024 rows,
    the MSR-3c net as its denoiser) on the card against the CPU on the same
    injected Dirichlet draws; an attention net (MSR-3c's widths, attention
    at every level and in the middle, seeded weights) on ``plain``, card
    against CPU; and the ``pair`` backend's MSR-3c forward at 16,384 rows
    held to ``plain`` and timed beside ``plain`` and ``fused``."""
    import copy

    import torch

    from diffsg_tpu_torch.diffusion import cosine_schedule
    from diffsg_tpu_torch.diffusion.legacy import legacy_sample
    from diffsg_tpu_torch.models import UNet1D, unet_apply_fn, unet_forward_fused
    from diffsg_tpu_torch.ops import step_sum_rate

    out = {}
    rng = np.random.default_rng(21)
    B, T = LEGACY_B, LEGACY_T
    cond = rng.uniform(0, 1, (B, 3)).astype(np.float32)
    gains = rng.uniform(0.5, 2.5, (B, 3)).astype(np.float32)
    init = rng.dirichlet(np.ones(3), B).astype(np.float32)
    steps = (rng.dirichlet(np.full(3, 3.0), (T, B)) - 1.0 / 3).astype(np.float32)
    cpu_model = copy.deepcopy(model).cpu()

    def run(net, device):
        ones = torch.ones(B, 1, device=device)
        g = torch.tensor(gains, device=device)
        with torch.no_grad():
            y0, rec = legacy_sample(lambda y, t, c: net(y, t / T, c, ones),
                                    cosine_schedule(T, device=device),
                                    torch.tensor(cond, device=device), 3, task="MAX SUM RATE",
                                    init=torch.tensor(init), step_noise=torch.tensor(steps),
                                    record_objective=lambda y: step_sum_rate(y, g)[0].mean())
        return y0.cpu().numpy(), [float(r) for r in rec]

    t0 = time.perf_counter()
    y_card, rec_card = run(model, dev)
    card_s = time.perf_counter() - t0
    y_cpu, rec_cpu = run(cpu_model, torch.device("cpu"))
    err = float(np.abs(y_card - y_cpu).max())
    check(bool(np.isfinite(y_card).all()) and y_card.min() >= 0 and y_card.max() <= 1,
          "legacy_sample: finite, in [0, 1]")
    check(err <= LEGACY_ATOL, f"legacy_sample card vs CPU: max abs {err} > {LEGACY_ATOL}")
    out["legacy_sample"] = {"B": B, "T": T, "max_abs_err": err, "atol": LEGACY_ATOL,
                            "card_s": card_s, "record_card": rec_card[-1],
                            "record_cpu": rec_cpu[-1]}

    torch.manual_seed(3)
    attn = UNet1D(input_dim=3, proj_dim=128, cond_dim=3, dims=(64, 32, 16, 8),
                  is_attn=(True,) * 4, middle_attn=True, n_blocks=2).eval()
    y = torch.tensor(rng.normal(size=(ROWS, 3)), dtype=torch.float32)
    c = torch.tensor(rng.uniform(0, 1, (ROWS, 3)), dtype=torch.float32)
    mask = torch.cat([torch.zeros(ROWS // 2, 1), torch.ones(ROWS // 2, 1)])
    t = torch.full((1,), 0.37)
    with torch.no_grad():
        want = attn(y, t, c, mask)
        attn_dev = attn.to(dev)
        args = [a.to(dev) for a in (y, t, c, mask)]
        got = attn_dev(*args).cpu()
        plain_ms = graph_ms(lambda: attn_dev(*args), reps=10)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(err <= FORWARD_RTOL * scale, f"attention net card vs CPU: {err} vs {scale}")
    out["attention"] = {"rows": ROWS, "max_abs_err": err, "out_max_abs": scale,
                        "plain_ms": plain_ms}

    half = torch.tensor(rng.normal(size=(ROWS // 2, 3)), dtype=torch.float32, device=dev)
    ch = torch.tensor(rng.uniform(0, 1, (ROWS // 2, 3)), dtype=torch.float32, device=dev)
    y2, c2 = torch.cat([half, half]), torch.cat([ch, ch])
    m2, t2 = mask.to(dev), t.to(dev)
    pair = unet_apply_fn(model, "pair")
    with torch.no_grad():
        ref = model(y2, t2, c2, m2)
        got = pair(y2, t2, c2, m2)
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        check(err <= FORWARD_RTOL * scale, f"pair forward vs plain: {err} vs {scale}")
        times = {name: graph_ms(fn, reps=10) for name, fn in (
            ("pair_ms", lambda: pair(y2, t2, c2, m2)), ("plain_ms", lambda: model(y2, t2, c2, m2)),
            ("fused_ms", lambda: unet_forward_fused(model, y2, t2, c2, m2)))}
    out["pair_forward"] = {"rows": ROWS, "max_abs_err": err, "out_max_abs": scale, **times}
    return out


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
    # The kernels are forward-only and their wrappers raise under autograd:
    # every phase runs without it (train_ddpm turns it on for its steps).
    torch.set_grad_enabled(False)
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
    co_solver = Solver.from_checkpoint(os.path.join(REPO, "ckpts", "ddpm_co"), task="co",
                                       backend="fused", dataset_config=CO_CONFIG)
    co_model = co_solver.model
    geo_model = Solver.from_checkpoint(os.path.join(REPO, "ckpts", "ddpm_nu_geo_x0f"),
                                       task="nu_geo", backend="mega").model
    # The budget-conditioned nets: MSR-3c's and NU's widths, a condition one
    # column wider (C 4 and 7), served by serve_msr_variants and serve_nu_cond.
    budget_model = Solver.from_checkpoint(os.path.join(REPO, "ckpts", "ddpm_msr_budget"),
                                          task="msr_budget", backend="mega").model
    nub_model = Solver.from_checkpoint(os.path.join(REPO, "ckpts", "ddpm_nu_budget"),
                                       task="nu_budget", backend="mega").model
    check((budget_model.cond_dim, nub_model.cond_dim) == (4, 7),
          f"budget nets' condition widths {budget_model.cond_dim}, {nub_model.cond_dim}")
    co_blocks, co_shapes = block_shapes(co_model)
    check(len(co_blocks) == 37, f"37 residual blocks in the CO net, found {len(co_blocks)}")
    # Every block shape of nu_geo_x0f is one of the CO net's: its cases are those.
    geo_shapes = block_shapes(geo_model)[1]
    check(set(geo_shapes) <= set(co_shapes), f"nu_geo shapes {sorted(geo_shapes)} beyond CO's")
    # The multi-task nets: ddpm_multi and ddpm_multi_geo have MSR-3c's widths
    # (input 5, condition 12), so MSR-3c's block shapes; ddpm_multi_80 is a
    # proj-256 net (input 80, condition 86) on a serving path, every one of
    # its block shapes a case here with its own weights.
    multi_model = Solver.from_checkpoint(os.path.join(REPO, "ckpts", "ddpm_multi"),
                                         task="multi_co", backend="mega").model.inner
    m80_model = Solver.from_checkpoint(os.path.join(REPO, "ckpts", "ddpm_multi_80"),
                                       task="multi_msr80", backend="mega").model.inner
    check(set(block_shapes(multi_model)[1]) == set(shapes)
          and (multi_model.input_dim, multi_model.cond_dim) == (5, 12),
          "ddpm_multi: MSR-3c's block shapes, input 5, condition 12")
    check((m80_model.proj_dim, m80_model.input_dim, m80_model.cond_dim) == (256, 80, 86),
          "ddpm_multi_80: proj 256, input 80, condition 86")
    m80_blocks, m80_shapes = block_shapes(m80_model)
    check(len(m80_blocks) == 27, f"27 residual blocks in ddpm_multi_80, found {len(m80_blocks)}")
    net_shapes = {"msr": shapes, "p256": p256_shapes, "co": co_shapes, "multi80": m80_shapes}

    rng = np.random.default_rng(0)
    per_shape = []
    cases = ([("msr", key, ROWS, 1) for key in shapes] + [("msr", (256, 128, True), 1000, 1000)]
             + [("p256", key, rows, t_rows) for key, rows, t_rows in
                (((512, 256, True), ROWS, 1), ((256, 256, False), ROWS, 1),
                 ((512, 256, True), 1000, 1000))]
             + [("co", key, CO_ROWS, 1) for key in co_shapes]
             + [("co", (128, 64, True), 1000, 1000)]
             + [("multi80", key, ROWS, 1) for key in m80_shapes])
    for net, (din, dout, sc), rows, t_rows in cases:
        res, per_forward = net_shapes[net][(din, dout, sc)]
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
            err, mean_err = float((out - ref).abs().max()), float((out - ref).abs().mean())
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
        on_path = (net, rows) in (("msr", ROWS), ("co", CO_ROWS), ("multi80", ROWS))
        row = {"net": net, "in": din, "out": dout, "shortcut": sc, "rows": rows,
               "t_rows": t_rows, "per_forward": per_forward if on_path else 0,
               "max_abs_err": err, "mean_abs_err": mean_err, "kernel_ms": k_ms, "tile_ms": tile_ms, "plain_ms": p_ms,
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
                  ("p256", p256_model, 1000, torch.bfloat16),
                  ("co", co_model, CO_ROWS, torch.float32), ("co", co_model, CO_ROWS, torch.bfloat16),
                  ("nu_geo", geo_model, 2 * NU_B, torch.float32),
                  ("nu_geo", geo_model, 2 * NU_B, torch.bfloat16),
                  ("co", co_model, 1000, torch.float32), ("co", co_model, 1000, torch.bfloat16),
                  ("nu_geo", geo_model, 1000, torch.float32),
                  ("nu_geo", geo_model, 1000, torch.bfloat16),
                  ("msr_budget", budget_model, ROWS, torch.float32),
                  ("msr_budget", budget_model, ROWS, torch.bfloat16),
                  ("nu_budget", nub_model, 2 * NU_B, torch.float32),
                  ("msr_budget", budget_model, 1000, torch.float32),
                  ("nu_budget", nub_model, 1000, torch.float32),
                  ("nu_budget", nub_model, 1000, torch.bfloat16),
                  ("multi", multi_model, ROWS, torch.float32),
                  ("multi", multi_model, CO_ROWS, torch.float32),
                  ("multi80", m80_model, ROWS, torch.float32),
                  ("multi80", m80_model, 1000, torch.float32)]
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
            # Few repeats at the 1,000-row cases (their check is the point)
            # and at the big ones; the script's time holds the rest to 10 x 3.
            big = rows > ROWS or (net in ("p256", "multi80") and rows >= ROWS)
            reps, replays = (3, 2) if big or rows < ROWS else (10, 3)
            k_ms = graph_ms(lambda: mega.launch_mega(packed, ys, sc, st), reps, replays)
            # Every tile height on the two serving nets of the main path; the
            # wrapper's and the eager call's times on MSR-3c f32 alone (the
            # depth these sweeps had is cut to hold the script's time).
            tile_ms = {tr: graph_ms(lambda: mega.launch_mega(packed, ys, sc, st, tr), reps,
                                    replays)
                       for tr in mega.TILE_ROWS[dtype]
                       if rows >= ROWS and net in ("msr", "nu")
                       and mega.mega_smem_bytes(packed, dtype, tr) <= mega.SMEM_MAX}
            main_case = (net, rows, cd) == ("msr", ROWS, None)
            w_ms = (graph_ms(lambda: mega.unet_forward_mega(net_model, y, t, cond, mask, cd,
                                                            packed), reps, replays)
                    if main_case else None)
            p_ms = graph_ms(lambda: mega.unet_forward_mega_reference(net_model, y, t, cond,
                                                                     mask, cd), reps, replays)
            call_ms = (cuda_ms(lambda: mega.unet_forward_mega(net_model, y, t, cond, mask, cd,
                                                              packed), reps=20)
                       if main_case else None)
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
    kernel_ms_per_fwd = sum(r["kernel_ms"] * r["per_forward"] for r in per_shape
                            if r["net"] == "msr")
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

    # -- the CO family, the MSR variants, conditioned NU and refinement ------------
    # Each spec of QUALITY_SPECS serves its own rows, tiled up to the batch, so
    # its mean quality has the expectation of the JAX constant's. Its noise is
    # the Solver's, another draw than the constant's: held within the
    # constant's seed-to-seed tolerance, in float32 and bf16 alike. The same
    # program runs eagerly and replayed from the bucket's graph, in turns, and
    # the two agree bit for bit. Then the spec's exact inputs and noise on the
    # card (port_quality) are held to the JAX constant within
    # SAME_NOISE_SHARE of its tolerance.
    from diffsg_tpu_torch.baselines import co_exact_solve
    from diffsg_tpu_torch.tasks import refine_solutions

    def spec_solver(name, backend):
        spec = QUALITY_SPECS[name]
        return Solver.from_checkpoint(os.path.join(REPO, "ckpts", spec["ckpt"]),
                                      task=spec["task"], backend=backend,
                                      dataset_config=spec.get("config"))

    def spec_rows(name, B):
        X = quality_rows(QUALITY_SPECS[name]["rows"])
        return np.concatenate([X] * (B // X.shape[0]))

    def spec_kw(name):
        spec = QUALITY_SPECS[name]
        kw = {"omega": spec["omega"]}
        if spec.get("sampler", "ddpm") != "ddpm":
            kw.update(sampler="ddim", n_steps=spec["sampler"][1])
        return kw

    def per_request(name, base, backend):
        sampler = QUALITY_SPECS[name].get("sampler", "ddpm")
        steps = base.sched.T if sampler == "ddpm" else sampler[1]
        if backend == "mega":
            return steps
        if backend in ("plain", "pair"):
            return 0
        return steps * len(block_shapes(getattr(base.model, "inner", base.model))[0])

    def feasible(name, base, S, Xu):
        check_feasible(QUALITY_SPECS[name]["rows"][0], base.config, S, Xu, name)

    def serve_spec(name, backend, B, seeds, refine=None, bf16=False, held_to="spec"):
        """Serve spec ``name`` at B rows on ``backend``: eagerly and from the
        bucket's graph in turns (bf16: eagerly, through cfg_sample with the
        mega forward in bf16, as the MSR-3c bf16 phase), each request's mean
        quality held to the JAX constant ``held_to`` (the spec's own by
        default; None: reported only). Returns the row."""
        spec = QUALITY_SPECS[name]
        base = spec_solver(name, backend)
        refine = spec.get("refine", 0) if refine is None else refine
        X = spec_rows(name, B)
        Xu = np.asarray(base.task.unnormalize_x(X, base.config), np.float32)
        Xu_t = torch.tensor(Xu, device=dev)
        exact = co_exact_solve(Xu_t) if spec["rows"][0] == "co" else None
        kw = spec_kw(name)
        n_req = per_request(name, base, backend)
        held_to = name if held_to == "spec" else held_to
        mean, tol = JAX_QUALITY[held_to] if held_to else (None, None)
        row = {"B": B, "backend": backend + (" bf16" if bf16 else ""), "T": base.sched.T,
               **kw, "refine_iters": refine, "launches_per_request": n_req}
        runs = {}
        if bf16:
            apply_fn = unet_apply_fn(base.model, "mega", compute_dtype=torch.bfloat16)
            cond = torch.tensor(X, device=dev)
            D = base.task.data_dim(base.config)

            @torch.inference_mode()
            def solve(seed):
                gen = torch.Generator(device=dev).manual_seed(seed)
                flat = torch.randn((B, base.sched.T + 1, D), generator=gen, device=dev)
                y0 = cfg_sample(apply_fn, base.sched, cond, kw["omega"], D, init_noise=flat[:, 0],
                                step_noise=flat[:, 1:].transpose(0, 1),
                                parameterization=base.config.get("parameterization", "eps"),
                                compute_dtype=torch.bfloat16)
                dec = (base.task.decode_with_x(y0, Xu_t, base.config) if base.task.decode_with_x
                       else base.task.decode(y0, base.config))
                return dec.cpu().numpy()

            reqs, n_fused, n_mega = serve(solve, seeds)
            check(n_mega == len(seeds) * n_req and n_fused == 0,
                  f"{name} bf16: {n_req} mega launches a request, counted {n_mega}, {n_fused}")
            runs["eager"] = reqs
            launches = n_mega
        else:
            def make(graphs):
                return Solver(base.task, base.model, base.sched, base.config, backend=backend,
                              buckets=(B,), graphs=graphs, refine_iters=refine)

            eager, graphed = make(False), make(True)
            t0 = time.perf_counter()
            graphed.solve(X, seed=seeds[0], **kw)           # warm run and capture
            torch.cuda.synchronize()
            row["capture_s"] = time.perf_counter() - t0
            launches = 0
            for mode, s_ in (("eager", eager), ("graph", graphed)):
                reqs, n_fused, n_mega = serve(lambda seed: s_.solve(X, seed=seed, **kw), seeds)
                counted, other = (n_fused, n_mega) if backend == "fused" else (n_mega, n_fused)
                check(counted == len(seeds) * n_req and other == 0,
                      f"{name} {backend} {mode}: {n_req} launches a request, counted "
                      f"{counted} and {other}")
                launches += counted
                runs[mode] = reqs
            for a, b in zip(runs["eager"], runs["graph"]):
                check(np.array_equal(a["P"], b["P"]),
                      f"{name} {backend}: the graph's seed {a['seed']} differs from eager")
            del eager, graphed
        for mode, reqs in runs.items():
            for r in reqs:
                feasible(name, base, r["P"], Xu)
                q, extra = spec_quality(name, base.task, base.config,
                                        torch.tensor(r["P"], device=dev), Xu_t, exact)
                r["q"] = q.double().cpu().numpy()
                r["quality"] = float(r["q"].mean())
                r.update(extra)
                if held_to:
                    check(abs(r["quality"] - mean) <= tol,
                          f"{name} {row['backend']} {mode} seed {r['seed']}: mean quality "
                          f"{r['quality']} vs the JAX package's {mean} (+-{tol})")
            row[mode] = {"solutions_per_s": rate_per_s(reqs, B),
                         "requests": [{k: r[k] for k in r if k not in ("P", "q")} for r in reqs]}
        row["jax_quality"], row["tol"] = mean, tol
        row["launches"] = launches
        row["_runs"] = runs
        return row

    def vs_jax(name, backend="mega"):
        zero_counts()
        q, _ = port_quality(name, 0, "cuda", backend)
        mean, tol = JAX_QUALITY[name]
        limit = SAME_NOISE_SHARE * tol
        check(abs(q.mean() - mean) <= limit,
              f"{name} {backend} on the card, JAX's inputs and noise: mean {q.mean()} vs the "
              f"JAX package's {mean} (+-{limit})")
        return {"backend": backend, "rows": int(q.size), "mean": float(q.mean()),
                "jax_mean": mean, "tol": tol, "limit": limit,
                "diff_over_tol": abs(float(q.mean()) - mean) / tol,
                "launches": mega.LAUNCHES if backend == "mega" else resblock.LAUNCHES}

    def public_row(row):
        return {k: v for k, v in row.items() if k != "_runs"}

    new_launches = {"fused": 0, "mega": 0}

    # -- serve_co: bench.py's CO row (ckpts/ddpm_co, T=20, omega 500, B=32,768) --
    co_rows_out = {}
    for backend, bf16 in (("fused", False), ("mega", False), ("mega", True)):
        row = serve_spec("co", backend, CO_B, [0, 1] if not bf16 else [0, 1, 2], bf16=bf16)
        new_launches["fused" if backend == "fused" else "mega"] += row["launches"]
        co_rows_out[row["backend"]] = public_row(row)
    check(co_rows_out["fused"]["launches_per_request"] == 740,
          "740 fused launches per CO request")
    emit("serve_co", vs_jax=vs_jax("co"), vs_jax_fused=vs_jax("co", "fused"), **co_rows_out)
    torch.cuda.empty_cache()

    # -- serve_co_ranked: round 3's recipe (ckpts/ddpm_co_x0, omega 5000) and co_direct
    rows_out = {}
    for name in ("co_ranked", "co_direct"):
        row = serve_spec(name, "mega", CO_B, [0, 1])
        new_launches["mega"] += row["launches"]
        rows_out[name] = {**public_row(row), "vs_jax": vs_jax(name)}
    emit("serve_co_ranked", **rows_out)

    # -- serve_msr_variants: msr_temp, msr_wf, msr_budget at 5 W and 25 W --------
    rows_out = {}
    for name in ("msr_temp", "msr_wf", "msr_budget_5", "msr_budget_25"):
        row = serve_spec(name, "mega", SERVE_B, [0, 1])
        new_launches["mega"] += row["launches"]
        rows_out[name] = {**public_row(row), "vs_jax": vs_jax(name)}
    emit("serve_msr_variants", **rows_out)

    # -- serve_nu_cond: nu_budget at 30 mW, nu_geo on mixed fields, B=524,288 ----
    rows_out = {}
    for name in ("nu_budget", "nu_geo"):
        row = serve_spec(name, "mega", NU_B, [0, 1])
        new_launches["mega"] += row["launches"]
        rows_out[name] = {**public_row(row), "vs_jax": vs_jax(name)}
    emit("serve_nu_cond", **rows_out)
    torch.cuda.empty_cache()

    # -- serve_refine: 50 projected-gradient steps after the decode, in the graph --
    rows_out = {}
    # The unrefined MSR-3c decode has no JAX constant here: the mean
    # waterfilling ratio of the earlier MSR phases' program, reported.
    for name, unrefined_constant, B in (("msr_refine", None, SERVE_B),
                                        ("nu_geo_refine", "nu_geo", NU_B)):
        row = serve_spec(name, "mega", B, [0, 1])
        base_row = serve_spec(name, "mega", B, [0], refine=0, held_to=unrefined_constant)
        new_launches["mega"] += row["launches"] + base_row["launches"]
        refined, unrefined = row["_runs"]["graph"][0]["q"], base_row["_runs"]["graph"][0]["q"]
        # Refinement starts from the decode's projection (the identity up to
        # rounding on a feasible decode): no row may end below it.
        worse = int((refined < unrefined - 1e-6 * np.abs(unrefined)).sum())
        check(worse == 0, f"{name}: {worse} refined rows worse than their unrefined decode")
        rows_out[name] = {**public_row(row), "unrefined_quality": float(unrefined.mean()),
                          "rows_improved": int((refined > unrefined).sum()),
                          "unrefined_solutions_per_s": base_row["graph"]["solutions_per_s"],
                          "vs_jax": vs_jax(name)}
        # One refinement step's device time: ten steps less one, each
        # replayed from a graph, on the unrefined decode.
        base = spec_solver(name, "mega")
        Xu_t = torch.tensor(np.asarray(base.task.unnormalize_x(spec_rows(name, B), base.config),
                                       np.float32), device=dev)
        Y = torch.tensor(base_row["_runs"]["graph"][0]["P"], device=dev)
        steps_ms = [graph_ms(lambda n=n: refine_solutions(base.task, Y, Xu_t, base.config, n),
                             reps=3, replays=2) for n in (1, 11)]
        rows_out[name]["step_ms"] = (steps_ms[1] - steps_ms[0]) / 10
        del row, base_row, Y, Xu_t
    rows_out["msr_temp_same_draws_vs_jax"] = vs_jax("msr_temp")
    emit("serve_refine", **rows_out)
    torch.cuda.empty_cache()

    # -- the multi-task nets ------------------------------------------------------
    def forward_turns(model, rows, order):
        """Device ms of one forward of ``model`` (a face's condition adapter)
        per backend at ``rows`` rows, half of them masked, each timed from a
        graph in ``order``; each backend held to ``plain`` within
        FORWARD_RTOL of the output's magnitude."""
        net = model.inner
        y = torch.tensor(rng.normal(size=(rows, net.input_dim)), dtype=torch.float32,
                         device=dev)
        cond = torch.tensor(rng.uniform(0, 1, (rows, model.payload_dim)), dtype=torch.float32,
                            device=dev)
        mask = (torch.arange(rows, device=dev) >= rows // 2).float()[:, None]
        t = torch.full((1,), 0.37, device=dev)
        fns = {b: unet_apply_fn(model, b) for b in order}
        out = {"ms": {b: [] for b in fns}, "max_abs_err": {}}
        with torch.no_grad():
            ref = fns["plain"](y, t, cond, mask)
            scale = float(ref.abs().max())
            for b, fn in fns.items():
                err = float((fn(y, t, cond, mask) - ref).abs().max())
                check(err <= FORWARD_RTOL * scale, f"{b} forward of the adapter: max abs err "
                                                   f"{err} vs {scale}")
                out["max_abs_err"][b] = err
            for b in order:
                out["ms"][b].append(graph_ms(lambda: fns[b](y, t, cond, mask), reps=10))
        out["out_max_abs"] = scale
        return out

    # serve_multi: ckpts/ddpm_multi's faces, fused and mega f32 in turns (the
    # order alternates by face), each eagerly and from its bucket's graph.
    multi_out = {}
    for name, B, order in (("multi_msr", SERVE_B, ("fused", "mega")),
                           ("multi_co", CO_B, ("mega", "fused")),
                           ("multi_nu", MULTI_NU_B, ("fused", "mega"))):
        multi_out[name] = {}
        for backend in order:
            row = serve_spec(name, backend, B, [0, 1])
            new_launches[backend] += row["launches"]
            multi_out[name][backend] = public_row(row)
        multi_out[name]["vs_jax"] = vs_jax(name)
        multi_out[name]["vs_jax_fused"] = vs_jax(name, "fused")
        torch.cuda.empty_cache()
    base = spec_solver("multi_msr", "mega")
    multi_out["forward"] = {"rows": ROWS, **forward_turns(
        base.model, ROWS, ("plain", "fused", "mega", "mega", "fused", "plain"))}
    emit("serve_multi", **multi_out)

    # serve_multi_geo: ckpts/ddpm_multi_geo's geometry-conditioned NU face on
    # mixed fields.
    geo_out = {}
    for backend in ("mega", "fused"):
        row = serve_spec("multi_nu_geo", backend, MULTI_NU_B, [0, 1])
        new_launches[backend] += row["launches"]
        geo_out[backend] = public_row(row)
    geo_out["vs_jax"] = vs_jax("multi_nu_geo")
    emit("serve_multi_geo", **geo_out)
    torch.cuda.empty_cache()

    # serve_multi_80: the proj-256 net (ckpts/ddpm_multi_80) through MSR-80c
    # at 20 W and MSR-8c at 10 W, float32 only, on plain, fused and mega in
    # turns, each from its bucket's graph: which backend serves this net.
    turns = ("plain", "fused", "mega", "mega", "fused", "plain")

    def serve_turns(name):
        """Spec ``name`` at SERVE_B rows from its bucket's graph on plain,
        fused and mega in ``turns``, each request feasible and held to the
        JAX constant. Returns the row."""
        base = spec_solver(name, "plain")
        X = spec_rows(name, SERVE_B)
        Xu_t = torch.tensor(np.asarray(base.task.unnormalize_x(X, base.config), np.float32),
                            device=dev)
        kw = spec_kw(name)
        mean, tol = JAX_QUALITY[name]
        solvers = {b: Solver(base.task, base.model, base.sched, base.config, backend=b,
                             buckets=(SERVE_B,)) for b in ("plain", "fused", "mega")}
        capture_s = {}
        for b, s_ in solvers.items():
            t0 = time.perf_counter()
            s_.solve(X, seed=0, **kw)
            torch.cuda.synchronize()
            capture_s[b] = time.perf_counter() - t0
        reqs_by = {b: [] for b in solvers}
        for b in turns:
            reqs, n_fused, n_mega = serve(lambda seed: solvers[b].solve(X, seed=seed, **kw), [1, 2])
            n_req = per_request(name, base, b)
            counted, other = ((n_fused, n_mega) if b == "fused" else (n_mega, n_fused))
            check(counted == 2 * n_req and other == 0,
                  f"{name} {b}: {n_req} launches a request, counted {counted} and {other}")
            if b != "plain":
                new_launches[b] += counted
            for r in reqs:
                feasible(name, base, r["P"], Xu_t.cpu().numpy())
                r["quality"] = float(spec_quality(name, base.task, base.config,
                                                  torch.tensor(r["P"], device=dev), Xu_t)[0].mean())
                check(abs(r["quality"] - mean) <= tol,
                      f"{name} {b} seed {r['seed']}: mean quality {r['quality']} vs the JAX "
                      f"package's {mean} (+-{tol})")
            reqs_by[b] += reqs
        row = {
            "B": SERVE_B, "T": base.sched.T, **kw, "jax_quality": mean, "tol": tol,
            "capture_s": capture_s, "launches_per_request": {
                b: per_request(name, base, b) for b in solvers},
            **{b: {"solutions_per_s": SERVE_B / float(np.median([r["s"] for r in reqs])),
                   "requests": [{k: r[k] for k in ("seed", "s", "quality")} for r in reqs]}
               for b, reqs in reqs_by.items()}}
        del solvers, reqs_by
        torch.cuda.empty_cache()
        return row

    m80_out = {name: {**serve_turns(name), "vs_jax": vs_jax(name)}
               for name in ("multi_msr80", "multi_msr8")}
    m80_out["forward"] = {"rows": ROWS, **forward_turns(spec_solver("multi_msr80", "plain").model,
                                                        ROWS, turns)}
    emit("serve_multi_80", **m80_out)

    # -- eval: tasks.base.evaluate on the repository's data ------------------------
    # datasets/ is not committed: its CSVs are remade from their recipes where
    # missing (data.datasets.ensure_datasets), and their SHA-256 are held
    # against the files the JAX constants were computed on. evaluate runs the
    # Solver's default backend (fused), 512 rows a batch.
    from diffsg_tpu_torch.data import ensure_datasets
    from diffsg_tpu_torch.tasks import TASKS, evaluate, merge_multi_config
    from diffsg_tpu_torch.utils import load_checkpoint

    t0 = time.perf_counter()
    paths = ensure_datasets()
    eval_out = {"datasets_s": time.perf_counter() - t0, "sha256_match": {
        n: hashlib.sha256(p.read_bytes()).hexdigest() == DATASET_SHA256[n]
        for n, p in paths.items()}}
    check(all(eval_out["sha256_match"].values()),
          f"eval: datasets/ remade as the JAX package makes them {eval_out['sha256_match']}")

    def eval_rows(specs, constants):
        """``evaluate`` (fused, 512 rows a batch) per spec on its CSV, each
        metric held to the JAX package's constant."""
        out = {}
        for name, spec in specs.items():
            ck = load_checkpoint(os.path.join(REPO, "ckpts", spec["ckpt"]), device=dev)
            task = TASKS[spec["task"]]
            data = task.load(str(paths[spec["csv"]]), **spec.get("load_kw", {}))
            merge_multi_config(data.config, ck["metadata"], spec["task"].split("_", 1)[1])
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            best_of = spec.get("best_of", 1)
            metrics = evaluate(task, ck["params"], ck["sched"], data, omega=spec["omega"],
                               seed=0, best_of=best_of)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            n = data.X_test.shape[0]
            want = -(-n // 512) * best_of * ck["sched"].T * 27
            check(resblock.LAUNCHES == want and mega.LAUNCHES == 0,
                  f"eval {name}: {want} fused launches, counted {resblock.LAUNCHES} and "
                  f"{mega.LAUNCHES} mega")
            new_launches["fused"] += resblock.LAUNCHES
            check(metrics["n_samples"] == n, f"eval {name}: {metrics['n_samples']} rows, not {n}")
            for k, (mean, tol) in constants[name].items():
                check(np.isfinite(metrics[k]) and abs(metrics[k] - mean) <= tol,
                      f"eval {name}: {k} {metrics[k]} vs the JAX package's {mean} (+-{tol})")
            out[name] = {"rows": n, "omega": spec["omega"], "seconds": seconds,
                         "rows_per_s": n / seconds, "launches": resblock.LAUNCHES,
                         "metrics": metrics, "jax": constants[name],
                         "diff_over_tol": {k: abs(metrics[k] - m) / t
                                           for k, (m, t) in constants[name].items()}}
        return out

    # The headline phase runs EVAL_SPECS' other rows through tools/headline.py.
    eval_out.update(eval_rows({k: EVAL_SPECS[k] for k in EVAL_ONLY}, EVAL_JAX))
    emit("eval", **eval_out)

    # -- headline: the quality CLIs (headline, eval_nu_geo, co_guided) ------------------
    headline_out, headline_launches = headline_phase(dev)
    for backend, count in headline_launches.items():
        new_launches[backend] += count
    emit("headline", **headline_out)

    # -- train: training on the card, and the trained nets served --------------------
    train_out, train_launches = train_phase(dev)
    for backend, count in train_launches.items():
        new_launches[backend] += count
    emit("train", **train_out)

    # -- datasets_gen: make_datasets' subcommands on this host -------------------------
    emit("datasets_gen", **datasets_gen_phase())

    # -- train_clis: the five task-specific training CLIs, their nets served -----------
    clis_out, clis_launches = train_clis_phase(dev)
    for backend, count in clis_launches.items():
        new_launches[backend] += count
    emit("train_clis", **clis_out)

    # -- serve_multi_zoo: ckpts/ddpm_multi_zoo's five faces ----------------------------
    # Each face at its task's batch on fused (the zoo's backend), eagerly and
    # from its bucket's graph; MSR-80c on mega f32 too, and on plain, fused
    # and mega in turns from the graphs; each request's mean quality held to
    # the JAX constant; then the forward on plain, fused and mega in turns.
    zoo_out = {}
    for name, B in (("zoo_msr80", SERVE_B), ("zoo_msr8", SERVE_B), ("zoo_msr", SERVE_B),
                    ("zoo_co", CO_B), ("zoo_nu_geo", MULTI_NU_B)):
        zoo_out[name] = {}
        for backend in (("fused", "mega") if name == "zoo_msr80" else ("fused",)):
            row = serve_spec(name, backend, B, [0, 1])
            new_launches[backend] += row["launches"]
            zoo_out[name][backend] = public_row(row)
        if name == "zoo_msr80":
            zoo_out[name]["turns"] = serve_turns(name)
        zoo_out[name]["vs_jax"] = vs_jax(name, "fused")
        torch.cuda.empty_cache()
    zoo_out["forward"] = {"rows": ROWS, **forward_turns(spec_solver("zoo_msr80", "plain").model,
                                                        ROWS, turns)}
    emit("serve_multi_zoo", **zoo_out)

    # -- baselines, train_baselines, report: DiffSG against GD, MTFNN and PPO -----------
    emit("baselines", **baselines_phase(dev))
    emit("train_baselines", **train_baselines_phase(dev))
    report_out, report_launches = report_phase(dev)
    for backend, count in report_launches.items():
        new_launches[backend] += count
    emit("report", **report_out)

    # -- mesh: the device mesh over NCCL, a world of one rank ---------------------------
    emit("mesh", **mesh_phase(dev, solver, nu_solver, X, XN, serve, new_launches))

    # -- legacy: the legacy sampler, an attention net and the CFG-pair backend ----------
    legacy_out = legacy_phase(dev, model)
    pair_row = serve_spec("msr_temp", "pair", SERVE_B, [0])
    legacy_out["pair_request"] = public_row(pair_row)
    emit("legacy", **legacy_out)

    # -- timing and research: the profiling, serving-latency and research CLIs ----------
    for phase in (timing_phase, research_phase):
        out, launches = phase(dev)
        for backend, count in launches.items():
            new_launches[backend] += count
        emit(phase.__name__[:-len("_phase")], **out)

    # -- kernels: one line per kernel ---------------------------------------------
    main_shapes = [r for r in per_shape if r["per_forward"] and r["net"] == "msr"]
    bounds = {}
    for r in main_shapes:
        bounds[r["bound_by"]] = bounds.get(r["bound_by"], 0.0) + r["bound_ms"] * r["per_forward"]
    msr_f32 = mega_rows[0]
    print(json.dumps({"kernels": [
        {"name": "fused_residual_block", "route": "cuda", "source": RESBLOCK_SOURCE,
         "replaces": RESBLOCK_REPLACES,
         "launches": 2 * 2700 + serve_graph_launches["fused"] + new_launches["fused"],
         "max_abs_err": max(r["max_abs_err"] for r in per_shape),
         "ms": kernel_ms_per_fwd,
         "plain_ms": sum(r["plain_ms"] * r["per_forward"] for r in main_shapes),
         "bound_ms": sum(bounds.values()), "bound_by": max(bounds, key=bounds.get),
         "library_ms": None,
         "per": f"one MSR-3c forward: the 27 launches at {ROWS} rows; launches over the "
                f"2 fused serving requests, serve_graph's 8 fused requests (4 replayed), and "
                f"serve_co, the multi-task phases, eval, headline, train, train_clis, "
                f"serve_multi_zoo, report, mesh, timing and research ({new_launches['fused']})",
         "co_forward_ms": sum(r["kernel_ms"] * r["per_forward"] for r in per_shape
                              if r["net"] == "co"),
         "multi80_forward_ms": sum(r["kernel_ms"] * r["per_forward"] for r in per_shape
                                   if r["net"] == "multi80"),
         "cases": [{k: r[k] for k in ("net", "in", "out", "shortcut", "rows", "per_forward",
                                      "variant", "tile_rows", "grid", "max_abs_err",
                                      "mean_abs_err", "kernel_ms", "tile_ms", "plain_ms",
                                      "bound_ms", "bound_by")}
                   for r in per_shape]},
        {"name": "unet_forward_mega", "route": "cuda", "source": MEGA_SOURCE,
         "replaces": MEGA_REPLACES,
         "launches": (serve_msr_mega_launches + serve_msr_bf16_launches + serve_nu_launches
                      + serve_nu_bf16_launches + serve_graph_launches["mega"]
                      + serve_best_of_launches + new_launches["mega"]),
         "max_abs_err": max(r["max_abs_err"] for r in mega_rows),
         "ms": msr_f32["kernel_ms"], "plain_ms": msr_f32["plain_ms"],
         "bound_ms": msr_f32["bound_ms"], "bound_by": msr_f32["bound_by"], "library_ms": None,
         "per": f"one MSR-3c float32 forward at {ROWS} rows; launches over serve_msr_mega "
                f"({serve_msr_mega_launches}), serve_msr_mega_bf16 ({serve_msr_bf16_launches}), "
                f"serve_nu ({serve_nu_launches}), serve_nu_bf16 ({serve_nu_bf16_launches}), "
                f"serve_graph ({serve_graph_launches['mega']}), serve_best_of "
                f"({serve_best_of_launches}) and the CO, MSR-variant, conditioned-NU, "
                f"refinement, multi-task, train, train_clis, serve_multi_zoo, report, mesh "
                f"and timing phases ({new_launches['mega']})",
         "cases": [{k: r[k] for k in ("net", "dtype", "rows", "tile_rows", "max_abs_err",
                                      "mean_abs_err", "kernel_ms", "plain_ms", "plain_bf16_ms",
                                      "bound_ms", "bound_by")}
                   for r in mega_rows]},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

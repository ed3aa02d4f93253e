#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pairwise_perturbation_tpu_torch) on
one NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own result lines; any failure prints the
traceback and exits nonzero:

1. Require CUDA (no CPU fallback), pin FP32 matmuls, print the card's
   name and power limit.
2. Build the CUDA kernels from ops/kernels/csrc with nvcc (sm_90a); print
   ptxas's registers and spills of every instance, and of the tensor-core
   (mma) instances by name.
3. Hold each fused order-3 MTTKRP kernel (modes 0/1/2) against its plain
   PyTorch version on the card, two launches bit for bit equal, at 200^3
   and 512^3 (R 10), a small and a ragged-K shape, R = 40 and a V 4 bytes
   off 16-byte alignment; time both with CUDA events. At 200^3 also
   torch.profiler device times, warm and with the L2 flushed (by a store,
   and by a store and a read, which leaves no dirty lines), and the host
   time of a call; at 512^3 device times (the _512 fields).
3b. The same for the chain-root kernels, float32 and bf16-stored V:
   mid_contract in its package layouts (K4 rank-minor, K4' rank-major;
   torch.profiler device times beside the einsum's at 512^3, both types;
   also 512^3 with V one element off a 16-byte boundary and a ragged M)
   and triple_roots (K6), every check bit for bit across two calls; at
   the coil shape K6's torch.profiler device time split by launch,
   beside its yardstick of three torch.matmul calls over views of V
   (device time too), its one-read bound and its two-read floor. Every
   mid_contract label names its path (f32v: K4's f32 loop; mma: tensor
   cores; fma), as every bf16 triple_roots label names its launches'.
3c. The sparse COO MTTKRP kernel (K7) against its plain version, every
   mode, on phase 6's own tensor and initial factors, at the
   sparse200_4_nnz1.6M fixture and its PP pair view (0, 1), the Pallas
   tests' two shapes, R = 40, a Zipf-skewed mode 0 (16M nonzeros) and
   NELL-2's shape with 76.9M uniform nonzeros; two launches must agree
   bit for bit; an order-5 tensor takes the kernel's instance for orders
   5 to 16. The fixture's mode 0, its pair view and NELL-2's mode 0 also
   get torch.profiler device times; the fixture's mode 0 the host time of
   a call, of the wrapper and of its C entry alone; NELL-2 its L2 gather
   floor, from an L2 read rate measured here.
3d. The last kernels, each against its plain version with two launches
   bit for bit equal: last_contract (K5), mid_contract's rank-outer
   layout (S2), column_sum (S4) and mid_contract rank-major at every
   block width (S5), at the coil-100 shapes of the scripts, ragged
   shapes and R = 40 (K5 also with V 4 bytes off 16-byte alignment,
   and with bf16 V at the coil shape, aligned and 2 bytes off, a ragged
   shape and R 40; K5's and S4's device times beside torch.matmul's and
   torch.sum's from torch.profiler); K4' at the coil shape in f32 (S1)
   and bf16 (S3), and S2, with device times beside their einsum's; the
   rank-outer and rank-major layouts in bf16 at every view check shape,
   the path named in each bf16 label.
   Every kernel row of phases 3-3d is timed beside its plain version, the
   one PyTorch call that computes the same function (or "none"), and its
   bound: the larger of its bytes (each input read once, each output
   written once) over 3.35 TB/s and its operations over the peak rate of
   its type (67 TFLOP/s FP32, 989 TFLOP/s bf16). Inputs that fit the
   50 MB L2 are also timed with the L2 flushed before each launch.
4. The main path through the CLI: ``test_als -model CP -pp 1`` on a
   200^3 rank-10 tensor; checks the CSV and that every kernel ran.
4b. The CLI at 512^3 rank 10, f32 and ``-dtype bfloat16``: short
   untimed warm-up runs, then each dtype with the kernels' defaults and
   under ``config.override(use_kernels_first=True)``: the DT tree's
   top-level child (1, 2) goes through K4 once per DT sweep, and K4'
   never.
4c. ``pp_bench -model CP`` at 512^3 rank 10, f32, maxiter 3, through the
   CLI, with use_kernels_first off, on, on, off: the CSV's header and row
   kinds, K4 launched once a DT sweep in the "on" runs (none "off"), and
   the [DTtime], [PPfirst] and [PPsecond] medians of each run beside the
   card's name and power limit.
5. Order-4 CP-PP at the coil-100 shape (3, 128, 128, 7200) f32, rank 10.
5b. The same shape, f32 and bf16 V, under
   ``config.override(use_kernels_triple=True)``: every PP cache build
   takes its three chain roots from one K6 call (two rank-outer
   mid_contract launches and one last_contract).
5c. PP-partupdate (``test_als -pp 2``, update percentage 0.5: 2 of the 4
   modes solved a PP sweep) at the same shape, f32, with the kernels'
   defaults and under use_kernels_triple (K6 once a cache build); the
   CSV checked (finite, PP rows, a falling gradnorm); the
   cp.pp_partupdate_sweep and cp.pp_cache_build medians beside phase 5's
   cp.pp_sweep.
6. The sparse CLI: ``test_als -model CP -issparse 1 -pp 1`` on the folded
   Poisson tensor (100^4); checks the CSV and that K7 launched exactly N
   times per exact sweep, N + 1 times per diagnostics row and N +
   N(N-1)/2 times per PP cache build (singles, then pairs on their fused
   views).
6b. Sparse PP on the sparse200_4_nnz1.6M fixture, rank 10, 20 sweeps,
   kernels off and on in turns, phase medians side by side; then plain
   sparse ALS (maxiter 3) at NELL-2's shape with K7.
6c. Repeatability of sparse PP with the kernels: the fixture's PP caches
   through K7 against the kernel-off route and bit for bit across two
   builds; then sparse PP at the fixture twice from one seed (every
   logged row's gradnorm, diffV and PP flag identical, PP rows in both),
   and the Poisson CLI twice (CSVs identical but for [dtime]); each
   run's PP rows and cache-build median beside 6b's kernel-off one.
7. The three ported benchmark scripts (pairwise_perturbation_tpu_torch.
   scripts: bench_firstpair, bench_rankpos, bench_midvariants) at the
   coil-100 shape, rank 10, in this process: each must return 0 (every
   error row under its tolerance), and its rows' launches give the launch
   counts of K5 and S1-S5 (K4' = S1 + S3 + S5).

8. ``run`` (the second-gen optimizers), f32, rank 10. At 512^3 through
   the CLI: -pp 4 (Simple), whose K1, K2 and K3 launch once a step (in
   dtime) and once, once and twice a diagnostics row; -pp 1 (MSDT) with
   use_kernels_first off and on: K4 serves every step whose hold-out is
   mode 0, only when on. At the coil-100 shape through ``cli.run_cpd``
   (the body of ``run``; the CLI makes cubic tensors only): -pp 0-3 a
   few sweeps each, -pp 1 -device_loop 1 (a rotation, 3 sweeps, a step),
   and -pp 1 under use_kernels_first (K4 for every hold-out of mode 1).
   Every CSV checked; the step medians (tracing scopes
   ``<Optimizer>.step``) printed beside the card's name and power limit.

9. Tucker (models/tucker.py, models/sparse_tucker.py), which reaches no
   kernel in either package: every part asserts that no port kernel
   launched and prints its ``tucker.*`` (``sparse_tucker.*``) scope
   medians and peak memory beside the card's name and power limit.
   9a. The coil-100 shape at its rank vector (3, 10, 10, 70), a seeded
   low-Tucker-rank tensor plus 1% noise: HOSVD three times (mode 3 on
   the randomized branch); Tucker-PP (pp_res_tol 0.1, AUTO extraction, 20
   sweeps) with V in f64, f32 and stored in bf16, CSVs checked (finite,
   PP rows), every run's fit held to HOSVD's by a float64 reconstruction
   (no CSV's norm identity resolves the sweeps' gain here) and the f32
   run to the f64 run (factor subspaces, residual); then bench.py's
   timings: 10 DT sweeps at subspace_iters 0, 2 and AUTO, 5 cache builds
   and 10 PP sweeps from one build, exact and AUTO.
   9b. Time-lapse's shape (33, 1344, 1024, 9) and rank vector in the
   port's own mode order, bench.py's uniform x 255 tensor: HOSVD, 10 DT
   sweeps under AUTO and 10 with exact eigh.
   9c. ``test_als -model Tucker`` through the CLI at 200^3 rank 10:
   tensor r2 at ``-pp 0`` and ``-pp 1`` in f32 and ``-pp 1`` in f64 (all
   20 sweeps, two PP phases or more), tensor c at ``-pp 1`` in f32 and
   f64; CSVs checked; ``pp_bench -model Tucker`` at 512^3 rank 10,
   maxiter 3: header, row kinds, medians.
   9d. ``test_als -model Tucker -issparse 1 -pp 1`` on phase 6's Poisson
   100^4 tensor at rank 1, f32 and f64, CSVs checked; sparse Tucker-PP
   on phase 6b's sparse200_4_nnz1.6M tensor at rank 10, f32 and f64,
   CSVs checked, then 5 cache builds and 10 PP sweeps timed.
   ``--phases 9`` runs phases 1, 2 and 9 alone.

10. ``run -issparse 1``, the dataset loaders, checkpoints and device
   traces, f32; every time beside the card's name and power limit.
   10a. ``run -issparse 1`` through the CLI on phase 6's Poisson 100^4
   tensor at rank 4 (RUN_SPARSE_P says why not 10): -pp 0 to 4, then
   -pp 1 -device_loop 1; every CSV checked; K7 launched 4 times a Simple
   step, 5 times a diagnostics row of every optimizer and never in a DT,
   MSDT or LR step (their chain tops are index_add_).
   10b. ``cli.run_cpd`` on phase 6b's sparse200_4_nnz1.6M tensor, rank
   10, all five optimizers, step medians and peak memory; Simple with
   use_kernels on and off (its first three steps' factors held to the
   same steps in float64: K7's to REL_TOL, the float32 index_add_'s,
   which sums rows of ~8,000 nonzeros in arbitrary order, to 10
   REL_TOL).
   10c. A seeded uniform float64 binary in coil-100's file shape (7200,
   128, 128, 3), 2.83 GB, written by utils/io.py in a temporary directory
   (free space printed): load_coil100 gives it with its axes reversed
   (load time printed); ``test_als -tensor o1 -pp 1 -checkpoint`` under
   use_kernels_triple (K6 once a cache build); ``-resume`` from that
   checkpoint starts from its factors (first row = their gradnorm, 1e-5).
   10d. The same in time-lapse's file shape (9, 1024, 1344, 33), 3.27 GB,
   after 10c's file is deleted: ``test_als -model Tucker -tensor o2 -pp 0
   -checkpoint``, whose factors are (33, 10), (1344, 100), (1024, 100),
   (9, 5) and core (10, 100, 100, 5): the natural mode order.
   10e. ``test_als`` at 200^3 -pp 1 with ``-profile 1 -trace_dir``: the
   torch.profiler trace names mttkrp3.cu's kernels (K1-K3 run in the
   diagnostics) and the cli.test_als range; without -profile no trace.
   ``--phases 10`` runs phases 1, 2 and 10 alone.

11. The parallel layer's nnz-sharded half under torchrun
   (scripts/multiprocess_worker.py), two ranks sharing the card over
   gloo; every cluster has its own time limit; every time beside the
   card's name and power limit.
   11a. One cluster on phase 6b's fixture at rank 10, f32 and f64: the
   five sharded sparse functions bit for bit equal on both ranks and
   held to one process (f32 REL_TOL, K7 on each shard; f64 1e-10);
   sparse CP-PP and Tucker-PP with mesh=, 10 sweeps, held to one-rank
   runs in this process (the same logged rows and decisions; factors
   within MESH_FACTOR_TOL, f32 Tucker by its diffV), medians beside one
   rank's with the time in all_reduce; each rank's K7 launches equal the
   phase machine's. A second cluster repeats the f32 K7 results bit for
   bit (C6 on the card).
   11b. Plain sparse ALS with mesh= at NELL-2's shape and nnz, rank 10,
   maxiter 3: medians and peak memory per rank, K7 counted.
   11c. ``test_als -model Tucker -issparse 1 -pp 1 -mesh 2`` at rank 1
   (phase 9d's run) in f32 and f64 through cli.main in the second
   cluster, CSVs checked; ``torchrun -m pairwise_perturbation_tpu_torch.cli
   test_als -issparse 1 -pp 1 -mesh 2`` on phase 6's tensor, CSV checked,
   row 0's gradnorm held to phase 6's (later rows printed: that run's
   Grams are near singular).
   11d. A world of one on NCCL (``--nproc_per_node 1``, ``-mesh 1``): its
   CSV equals phase 6's bit for bit but for [dtime].
   11e. sharded_mttkrp at 200^3 f32 in the first cluster, K1-K3 once on
   each rank's block, held to one process.
   ``--phases 11`` runs phases 1, 2 and 11 alone.

12. The dense engines on a block-sharded V (parallel/mesh.py's dense
   half) under torchrun, two ranks sharing the card over gloo, three
   cluster start-ups; every time beside the card's name and power limit.
   12a. CP-PP (-pp 1, use_kernels_triple) at the coil shape, V sharded
   over mode 3 (3600 a rank, each rank memory-maps its block of a .npy),
   f64 and f32, 12 sweeps: each rank's medians of the CP scopes and its
   all_reduce count, seconds and share of the wall, beside one process's
   run from the same factors: f64 with the same decisions and factors
   within DENSE_FACTOR_TOL, f32 by its fit (its decisions are not
   determined in f32 there); K6 (and K5 as its O3) once a cache build
   on each rank's block, and K6 at rank 0's block held to its plain
   version, twice bit for bit.
   12b. Tucker-PP at the coil shape (phase 9a's tensor, ranks 3, 10, 10,
   70), f64 and f32, 10 sweeps: HOSVD's sharded mode 3 by matrix-free
   subspace iteration; f64 held to one process by decisions and factor
   sines, f32 by a float64 reconstruction of the fit (as 9a); per-rank
   medians.
   12c. ``test_als -model CP -pp 1 -mesh 2`` at 200^3 rank 10 (f64, f32)
   through cli.main in a cluster, each CSV against the unsharded CLI's
   (DENSE_CLI_TOL); K1-K3 on each rank's (100, 200, 200) block in every
   diagnostics row, counted, and each held to its plain version there.
   12d. ``pp_bench -model CP -mesh 2`` at 512^3 under use_kernels_first in
   the same cluster: K4 on each rank's (256, 512, 512) block once a DT
   sweep, held to its plain version there.
   12e. A world of one on NCCL (``--nproc_per_node 1``, ``-mesh 1``):
   ``test_als -tensor o1`` read block by block from a seeded coil-100
   binary writes the unsharded CLI's CSV bit for bit but for [dtime] and
   [tol].
   ``--phases 12`` runs phases 1, 2 and 12 alone.

13. ``run -mesh 2``: the second-gen optimizers on a block-sharded V, two
   ranks sharing the card over gloo, one cluster start-up, then a world
   of one.
   13a. DT, MSDT (use_kernels_first: K4 on the hold-outs it admits at
   the block's shape), DT-LR and MSDT-LR through cli.run_cpd at the coil
   shape, V sharded over mode 3 (3600 a rank, each rank memory-maps its
   block of a .npy), f64 and f32: f64 factors within RUN_MESH_FACTOR_TOL
   of one process's, f32 held by its fit (every logged diffV within
   RUN_MESH_F32_DIFFV), the same logged sweeps; per-rank step medians
   beside one process's, all_reduce calls and seconds, peak memory; K4
   counted on each rank and held to its plain version at rank 0's block.
   13b. The CLI in the same cluster: ``run -pp 4 -mesh 2`` at 512^3 f32
   (K1-K3 on each rank's (256, 512, 512) block, once a Simple step and
   1/1/2 a diagnostics row, each held to its plain version there) and
   ``run -pp 1 -device_loop 1 -mesh 2`` at 200^3 f64, each CSV against
   the unsharded CLI's.
   13c. A world of one on NCCL (``--nproc_per_node 1``, ``run -pp 3
   -mesh 1`` at 200^3 f32) writes the unsharded CSV bit for bit but for
   [dtime].
   ``--phases 13`` runs phases 1, 2 and 13 alone.

14. ``test_als -model CP -pp 1 -device_loop 1``: the device-resident
   phase loops (models/cp.py, sweeps issued in chunks of
   DEVICE_LOOP_CHUNK with the loop state on the card) beside the host
   engine, f32.
   14a. The 200^3 CLI, -device_loop 0 then 1: the same (iter, pp) rows,
   final factors (-checkpoint) within DEVICE_LOOP_FACTOR_TOL, K1-K3
   1/1/2 a logged row in both (the device engine's from the ring's
   snapshots); scope medians, sweeps issued and masked, ms an issued
   sweep and host pulls a phase.
   14b. The coil shape under use_kernels_triple, cp.als_cp_pp against
   cp.als_cp_pp_device: the same rows and factors, K6 (and K5 as its O3)
   once a cache build in both.
   14c. Syncs per sweep under torch.cuda.set_sync_debug_mode("warn"),
   named by their source, at 200^3 and coil: a host DT sweep, cache
   build and PP sweep, the host engine's ratio pull, and a chunk of each
   device phase.
   ``--phases 14`` runs phases 1, 2 and 14 alone.

15. The fused machines (``-device_loop 2``), Tucker's device engines and
   the ported bench_pp_e2e, f32. Rows of the three engines are held to
   the fused run's (rows_beside_fused: the fused row L is the state after
   L sweeps; the host engine's row L the same state, its flag one row
   earlier; the phase engine's row L the fused row L + 1): where the
   flags agree, factors bit for bit, else the fit.
   15a. test_als -model CP -pp 1 at 200^3 rank 10, -device_loop 0, 1 and
   2 from the same factors: rows, final factors (-checkpoint), K1-K3
   1/1/2 a logged row (and the fused engine's final exact call),
   [dtime], body steps by kind, pulls a sweep, -profile scope medians.
   15b. The coil shape under use_kernels_triple, cp.als_cp_pp against
   cp.als_cp_pp_fused: K6 and K5 once a cache build; rows and factors,
   or the fit within DEVICE_LOOP_COIL_DIFFV.
   15c. Tucker -device_loop 0, 1 and 2 at the coil shape, ranks (3, 10,
   10, 70), and through the 200^3 CLI (tensor r2): rows beside the fused
   run's, fits by a float64 reconstruction no worse than HOSVD's, the
   phase and fused engines' factors bit for bit where their decisions
   agree, no port kernel launched.
   15d. One chunk of each fused machine at 200^3 under
   set_sync_debug_mode("warn"): syncs a body step by source, pulls.
   15e. bench_pp_e2e --quick into a temporary directory: DT and PP times
   to the target, the rule, pp_row_fraction; finite rows asserted, no
   claim on the speed-up.
   ``--phases 15`` runs phases 1, 2 and 15 alone.

16. dtime's warm-ups, the device engines under -mesh, -layouts 1.
   16a. test_als at 200^3 f32 (-pp 1, -device_loop 0, 1 and 2) and CP-PP
   at the coil shape with use_kernels_triple, each in a fresh process,
   with the engines' warm-ups (models/cp.warm_run) and with each made a
   no-op: the first DT step (row 1's dtime less row 0's) against the
   median of the later DT steps; held to 2x for -device_loop 0; each
   warm-up's seconds by function and _build.load()'s.
   16b. the CP device engines (-device_loop 1, 2) on 2 ranks over gloo on
   the card at 200^3 (f64 by rows and factors, f32 by the fit; K1-K3 on
   each rank's block in the exact rows, 1/1/2 a row and a warm-up's), a
   world of one on NCCL bit for bit, then at the coil shape with K6 (f32,
   K6 and K5 once an in-loop build and once in the warm-ups) beside
   Tucker's device engines (f32); mesh.all_reduce calls and seconds.
   16c. -layouts 1: als_cp_dt and the fused machine at the coil shape
   and test_als -pp 0 and -pp 1 -device_loop 2 at 512^3, f32, layouts off
   then on: DT sweep medians, the copy kernels' device ms in one DT sweep
   (torch.profiler), peak memory, the last diffV held to the off run's.
   ``--phases 16`` runs phases 1, 2 and 16 alone.

Every engine runs its warm-ups before its loop (models/cp.warm_run, out
of dtime), and the kernels they reach count: where a check holds a
kernel's launches to the scopes of a run, the warm-ups' launches are
counted apart (scripts/_bench.warm_launches) and held to their own number
(a warm DT sweep's K4, a warm cache build's K6 and K5, a warm exact row's
K1-K3, a warm sparse sweep's and cache build's K7).

The last three lines are a JSON line of every TPU kernel's row (K1-K7,
S1-S5), the card's name and power limit, and
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --phases 3c,3d`` (or ``--phases 3`` for K1-K3,
``--phases 3b`` for K4, K4' and K6) runs phases 1, 2 and the named
kernel phases alone and ends with their rows as one JSON line and the
card's name and power limit, without the ok line: run from the root of
two checkouts in turns, it times two trees' kernels on one card.
"""

from __future__ import annotations

import csv
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = "pairwise_perturbation_tpu_torch/ops/kernels/csrc/"
PALLAS = "pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py:"
COO_REPLACES = "pairwise_perturbation_tpu/ops/kernels/coo_pallas.py:145"
# Every function of the repo that reaches pl.pallas_call: table id ->
# (JSON name, CUDA sources it launches, the pl.pallas_call it replaces).
TABLE = {
    "K1": ("mttkrp3_mode0", "mttkrp3.cu", PALLAS + "145"),
    "K2": ("mttkrp3_mode1", "mttkrp3.cu", PALLAS + "240"),
    "K3": ("mttkrp3_mode2", "mttkrp3.cu", PALLAS + "288"),
    "K4": ("mid_contract_rank_minor", "mid_contract.cu", PALLAS + "468"),
    "K4'": ("mid_contract_rank_major", "mid_contract.cu", PALLAS + "482"),
    "K5": ("last_contract", "last_contract.cu", PALLAS + "550"),
    "K6": ("triple_roots", ("mid_contract.cu", "last_contract.cu"),
           PALLAS + "712"),
    "K7": ("coo_mttkrp", "coo_mttkrp.cu", COO_REPLACES),
    "S1": ("mid_contract_rank_major_f32_rankpos", "mid_contract.cu",
           "scripts/bench_rankpos.py:64"),
    "S2": ("mid_contract_rank_outer", "mid_contract.cu",
           "scripts/bench_rankpos.py:112"),
    "S3": ("mid_contract_rank_major_bf16_rankpos", "mid_contract.cu",
           "scripts/bench_rankpos.py:167"),
    "S4": ("column_sum", "column_sum.cu", "scripts/bench_midvariants.py:56"),
    "S5": ("mid_contract_rank_major_block_widths", "mid_contract.cu",
           "scripts/bench_midvariants.py:90"),
}
# Per table id: max_abs_err, and at the row's reported shape ms,
# plain_ms, library_ms, bound_ms, bound_by (filled by phases 3-3d).
RESULTS = {k: dict(max_abs_err=0.0) for k in TABLE}
# The launch counter each script kernel's rows read (phase 7).
SCRIPT_COUNTERS = {"K5": "last_contract.last_contract",
                   "S1": "mid_contract.rank_major",
                   "S2": "mid_contract.rank_outer",
                   "S3": "mid_contract.rank_major",
                   "S4": "column_sum.column_sum",
                   "S5": "mid_contract.rank_major"}
SCRIPTS = ("bench_firstpair", "bench_rankpos", "bench_midvariants")
# The card's published rates (H100 SXM data sheet, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
L2_BYTES = 50 * 2**20
# (shape, mode, R, V's offset in elements) of mid_contract: DT node (1, 2)
# at 512^3, the coil shape's mode 1, a ragged column tile, R above one
# rank pass (f32v: 3 of 14; fma: 32), then 512^3 with V one element off a
# 16-byte boundary and a ragged M (M % 4 != 0), which keep the FMA
# template in f32.
MID_CHECKS = [((512, 512, 512), 0, 10, 0), ((3, 128, 128, 7200), 1, 10, 0),
              ((5, 40, 1000), 1, 7, 0), ((200, 200, 200), 1, 40, 0),
              ((512, 512, 512), 0, 10, 1), ((5, 40, 1001), 1, 7, 0)]
# (shape, R) of triple_roots: the coil cache build, a ragged column tile,
# and R above one rank pass (16).
TRIPLE_CHECKS = [((3, 128, 128, 7200), 10), ((3, 16, 24, 1200), 5),
                 ((3, 64, 64, 2048), 40)]
# (I, J, K, R, offset) of K1-K3: the main path's two shapes, a small one,
# a ragged K (K % 4 != 0: scalar loads), R above one rank chunk (32), and
# the main shape with V's data 4 bytes past a 16-byte boundary (offset 1
# float: scalar loads).
CHECK_SHAPES = [(200, 200, 200, 10, 0), (512, 512, 512, 10, 0),
                (13, 37, 200, 7, 0), (13, 37, 203, 7, 0), (96, 96, 96, 40, 0),
                (200, 200, 200, 10, 1)]
MAIN_SHAPE = (200, 200, 200, 10)
BIG_SHAPE = (512, 512, 512, 10)
# f32 on both sides (bf16 V: the same bf16-rounded operands, whose
# products are exact in f32), summed in different orders over up to
# 512*512 terms.
REL_TOL = 1e-4
CSV_HEADER = "[dim],[iter],[gradnorm],[tol],[pp_update],[diffV],[dtime]"
COIL_SHAPE = (3, 128, 128, 7200)
CP_PHASES = ("cp.dt_sweep", "cp.pp_cache_build", "cp.pp_sweep",
             "cp.diagnostics")
SPARSE_PHASES = ("sparse.sweep", "sparse.pp_cache_build", "sparse.pp_sweep",
                 "sparse.diagnostics")
# bench.py's sparse fixture (uniform indices and values) and FROSTT
# NELL-2's shape and nonzero count (synthetic uniform nonzeros).
SPARSE_SHAPE, SPARSE_NNZ = (200, 200, 200, 200), 1_600_000
NELL2_SHAPE, NELL2_NNZ = (12092, 9184, 28818), 76_879_419
# Phase 6's sparse CLI run; phase 3c also holds K7 on its tensor and
# first factors.
SPARSE_CLI = ["-model", "CP", "-issparse", "1", "-pp", "1", "-tensor", "p",
              "-dim", "8", "-size", "10", "-rank", "10"]
# (label, shape, nnz, R, Zipf-skewed mode 0) of the other K7 checks.
COO_CHECKS = [("sparse200_4_nnz1.6M", SPARSE_SHAPE, SPARSE_NNZ, 10, False),
              ("pallas-test order 4", (37, 50, 29, 61), 3000, 5, False),
              ("pallas-test order 3", (20, 31, 17), 777, 4, False),
              ("sparse200_4 R=40", SPARSE_SHAPE, SPARSE_NNZ, 40, False),
              ("zipf(1.2) mode 0", SPARSE_SHAPE, 16_000_000, 10, True),
              ("order 5", (60, 50, 40, 30, 20), 200_000, 10, False),
              ("NELL-2 shape", NELL2_SHAPE, NELL2_NNZ, 10, False)]


_T0 = time.perf_counter()


def phase(name):
    print(f"\n=== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


_FLUSH = []


def flush_l2(clean=False):
    """Overwrite the 50 MB L2 cache with a 256 MB store, so that the next
    launch reads its inputs from device memory. The store leaves the L2
    full of dirty lines, which the next launch's reads write back; with
    ``clean`` a 256 MB read follows it, which leaves clean lines."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2**20, device="cuda"))
    _FLUSH[0].zero_()
    if clean:
        _FLUSH[0].sum()


def median_ms(fn, n=25, warmup=3, flush=False):
    """Median device time of ``fn`` over ``n`` calls, each bracketed by
    CUDA events, after ``warmup`` untimed calls; with ``flush`` the L2 is
    flushed before each call, outside the events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        if flush:
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split_ms(what, fn, reps=25):
    """(device busy ms per call of ``fn``, {kernel name: device ms per
    call}) from torch.profiler (device events only), printed. Event times
    also hold the host's enqueue of a call; this is the device's time
    alone."""
    from pairwise_perturbation_tpu_torch import phase_profile
    busy, per = phase_profile.profile(fn, "cuda", reps)
    print(f"  {what}: device busy {1e3 * busy:.1f} us per call "
          "(torch.profiler): " + ", ".join(
              f"{k[:48]} {1e3 * v:.1f} us" for k, v in per.items()))
    return busy, per


def device_busy_ms(what, fn, reps=25):
    """Device busy ms per call of ``fn`` (:func:`device_split_ms`)."""
    return device_split_ms(what, fn, reps)[0]


def host_us(fn, n=200):
    """Host microseconds per call of ``fn``: the wall time of ``n`` calls
    issued back to back with no synchronisation (the device runs behind;
    their launches stay well inside the launch queue), after a warm-up
    call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(nbytes, ops, dtype="float32"):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``ops`` operations of ``dtype``."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / PEAK_OPS[dtype]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def timed_row(key, label, abs_err, rel, kernel, plain, library, nbytes, ops,
              dtype="float32", library_name="", reference=None,
              report=False):
    """Time ``kernel``, ``plain`` and ``library`` (the one PyTorch call
    that computes the same function, or None) and print them beside the
    bound; ``reference`` = (name, fn) is the non-kernel route timed where
    no single call exists. Inputs that fit the L2 are timed again with
    it flushed. Adds the error to ``RESULTS[key]``, and with ``report``
    the times too; returns the times."""
    ms, plain_ms = median_ms(kernel), median_ms(plain)
    lib_ms = median_ms(library) if library is not None else None
    b_ms, b_by = bound_ms(nbytes, ops, dtype)
    fields = dict(ms=ms, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=b_ms, bound_by=b_by)
    line = (f"{label}: rel_err {rel:.3e} abs_err {abs_err:.3e} kernel "
            f"{ms:.4f} ms plain {plain_ms:.4f} ms library "
            + (f"{lib_ms:.4f} ms ({library_name})" if lib_ms is not None
               else "none")
            + f" bound {b_ms:.4f} ms ({b_by}; {100 * b_ms / ms:.1f}% of it "
            "reached)")
    if nbytes < L2_BYTES:
        fields["ms_l2_flushed"] = median_ms(kernel, flush=True)
        line += f", L2 flushed {fields['ms_l2_flushed']:.4f} ms"
    if reference is not None:
        fields["reference"] = reference[0]
        fields["reference_ms"] = median_ms(reference[1])
        line += f"; {reference[0]}: {fields['reference_ms']:.4f} ms"
    print(line)
    res = RESULTS[key]
    res["max_abs_err"] = max(res["max_abs_err"], abs_err)
    if report:
        res.update(fields)
    return fields


def check_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA device")
    from pairwise_perturbation_tpu_torch import config
    config.apply_fp32_pins()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def build_kernels():
    from pairwise_perturbation_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"built {path.name} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print("  " + line.strip())
        elif "spill" in line and " 0 bytes spill stores, 0 bytes spill" \
                not in line:
            print("  " + line.strip())
    for name, report in ptxas_report(_build.build_log).items():
        if "_mma" in name:
            print(f"ptxas, tensor-core instance {name}: {report}")


def ptxas_report(log):
    """{kernel's mangled name: its stack, spill and register lines from
    ptxas -v, joined}."""
    reports, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            reports[name] = []
        elif name is not None and ("spill" in line or "Used" in line):
            reports[name].append(line.split(":", 1)[-1].strip()
                                 if "Used" in line else line.strip())
    return {k: "; ".join(v) for k, v in reports.items()}


def held_to_plain(label, got, want):
    """(abs_err, rel_err) of a kernel's output against its plain version;
    raises on non-finite values or a relative error above REL_TOL."""
    import torch
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite kernel output")
    abs_err = float((got - want).abs().max())
    rel = abs_err / float(want.abs().max())
    if not rel <= REL_TOL:
        raise AssertionError(f"{label}: relative error {rel:.3e} > {REL_TOL}")
    return abs_err, rel


def held_twice(label, fn, plain):
    """held_to_plain for two launches of ``fn`` that must agree bit for
    bit."""
    import torch
    got, again = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches differ")
    return held_to_plain(label, got, plain())


def device_ms_l2_flushed(what, fn, reps=25, clean=False):
    """Device ms per call of ``fn`` with the L2 flushed (``flush_l2``)
    before each call: torch.profiler's device time of the calls' own
    kernels, without the flush's."""
    from pairwise_perturbation_tpu_torch import phase_profile
    _, flush = phase_profile.profile(lambda: flush_l2(clean), "cuda", 3)

    def flushed():
        flush_l2(clean)
        fn()

    _, per = phase_profile.profile(flushed, "cuda", reps)
    own = {k: v for k, v in per.items() if k not in flush}
    ms = sum(own.values())
    print(f"  {what}, L2 flushed{' clean' if clean else ''}: device "
          f"{1e3 * ms:.1f} us per call "
          "(torch.profiler): " + ", ".join(
              f"{k[:48]} {1e3 * v:.1f} us" for k, v in own.items()))
    return ms


def mttkrp3_plan_label(mttkrp3, V, R, mode):
    """The launch plan of ``mode`` at V's shape, for a row's label (empty
    for a tree whose module has no plan)."""
    import torch
    if not hasattr(mttkrp3, "plan"):
        return ""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return f" {mttkrp3.plan(tuple(V.shape), R, mode, n_sm, mttkrp3.can_vec(V))}"


def compare_kernels():
    """K1-K3 against their plain versions on the card, every mode at every
    CHECK_SHAPES entry, two launches bit for bit equal; times reported at
    MAIN_SHAPE (with device times warm and with the L2 flushed, and the
    host time of a call) and at 512^3 (fields suffixed _512). The library
    call is the whole MTTKRP as one einsum."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = ("ijk,jr,kr->ir", "ijk,ir,kr->jr", "ijk,ir,jr->kr")
    for (I, J, K, R, offset) in CHECK_SHAPES:
        buf = torch.rand(I * J * K + offset, generator=gen, device="cuda")
        V = buf[offset:].view(I, J, K)
        Ws = [torch.rand((s, R), generator=gen, device="cuda")
              for s in (I, J, K)]
        main = (I, J, K, R) == MAIN_SHAPE and offset == 0
        big = (I, J, K, R) == BIG_SHAPE
        for mode in range(3):
            key = f"K{mode + 1}"
            label = (f"mode {mode} {I}x{J}x{K} R={R} data_ptr % 16 = "
                     f"{V.data_ptr() % 16}"
                     + mttkrp3_plan_label(mttkrp3, V, R, mode))

            def kernel(m=mode):
                return mttkrp3.mttkrp3_mode(V, Ws, m)

            def plain(m=mode):
                return mttkrp3.mttkrp3_mode_plain(V, Ws, m)

            abs_err, rel = held_twice(label, kernel, plain)
            others = [W for j, W in enumerate(Ws) if j != mode]

            def library(m=mode, o=others):
                return torch.einsum(specs[m], V, *o)

            fields = timed_row(
                key, label + " (bitwise repeat ok)", abs_err, rel, kernel,
                plain, library,
                tensor_bytes(V, *others) + 4 * V.shape[mode] * R,
                2 * V.numel() * R, library_name="torch.einsum", report=main)
            res = RESULTS[key]
            if main:
                res["device_ms"] = device_busy_ms("kernel", kernel)
                res["device_ms_l2_flushed"] = device_ms_l2_flushed(
                    "kernel", kernel)
                res["device_ms_l2_clean"] = device_ms_l2_flushed(
                    "kernel", kernel, clean=True)
                res["library_device_ms"] = device_busy_ms("torch.einsum",
                                                          library)
                res["host_us"] = host_us(kernel)
                print(f"  host per call: {res['host_us']:.1f} us")
            if big:
                res.update({f"{k}_512": fields[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms")})
                res["device_ms_512"] = device_busy_ms("kernel", kernel)
                res["library_device_ms_512"] = device_busy_ms(
                    "torch.einsum", library)
        del V, Ws, buf
        torch.cuda.empty_cache()


MID_SPECS = {"rank_minor": "pbm,br->pmr", "rank_major": "pbm,br->prm",
             "rank_outer": "pbm,br->rpm"}


def mid_library(V, W, mode, layout):
    """The one einsum that computes mid_contract's function (for bf16 V
    its output is bf16, not float32)."""
    import torch
    P = math.prod(V.shape[:mode])
    V3 = V.reshape(P, V.shape[mode], -1)
    Wd = W.to(V.dtype)
    spec = MID_SPECS[layout]
    return lambda: torch.einsum(spec, V3, Wd)


def path_label(path):
    """" path <path>" for a row's label (empty for none)."""
    return f" path {path}" if path else ""


def mid_path(mc, V, R, mode, layout, cols=256):
    """mid_contract's path at V for a row's label: its plan's (an older
    tree without plan_for has only the FMA template)."""
    if not hasattr(mc, "plan_for"):
        return "fma"
    return mc.plan_for(V, R, mode, layout, cols).path


def k5_plan(lc, V, R):
    """K5's launch plan at V (an older tree's plan takes can_vec and has
    no path)."""
    import torch
    if hasattr(lc, "plan_for"):
        return lc.plan_for(V, R)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return lc.plan(V.numel() // V.shape[-1], V.shape[-1], R, n_sm,
                   lc.can_vec(V))


def triple_paths(mc, lc, V, R):
    """The paths of K6's three launches at V: O1 and O2 are mid_contract
    rank-outer at modes 1 and 2, O3 is K5 on the (P B1 B2, M) view."""
    return (mid_path(mc, V, R, 1, "rank_outer"),
            mid_path(mc, V, R, 2, "rank_outer"),
            getattr(k5_plan(lc, V, R), "path", "fma"))


def add_device_ms(key, kernel, library, library_name, sfx=""):
    """torch.profiler device time of ``kernel`` and ``library`` into
    ``RESULTS[key]`` (fields suffixed ``sfx``)."""
    res = RESULTS[key]
    res["device_ms" + sfx] = device_busy_ms("kernel", kernel)
    res["library_device_ms" + sfx] = device_busy_ms(library_name, library)


def mid_bytes(V, W):
    """mid_contract's bytes: V and W read, the float32 output written."""
    return tensor_bytes(V, W) + 4 * (V.numel() // W.shape[0]) * W.shape[1]


def compare_chain_roots():
    """K4, K4' and K6 against their plain versions on the card, f32 and
    bf16 V; times reported at the first shape, f32."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import last_contract as lc
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc
    from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots as tr
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        lib_name = "torch.einsum" + (", bf16 out" if dname == "bfloat16"
                                     else "")
        for i, (shape, mode, R, offset) in enumerate(MID_CHECKS):
            V = torch.rand(math.prod(shape) + offset, generator=gen,
                           device="cuda").to(dtype)[offset:].view(shape)
            W = torch.rand((shape[mode], R), generator=gen, device="cuda")
            for key, layout in (("K4", "rank_minor"), ("K4'", "rank_major")):
                path = mid_path(mc, V, R, mode, layout)
                label = f"mid_contract {layout} {shape} mode {mode} R={R} " \
                        f"{dname} data_ptr % 16 = {V.data_ptr() % 16}" + \
                        path_label(path)

                def kernel(lo=layout):
                    return mc.mid_contract(V, W, mode, layout=lo)

                def plain(lo=layout):
                    return mc.mid_contract_plain(V, W, mode, layout=lo)

                abs_err, rel = held_twice(label, kernel, plain)
                library = mid_library(V, W, mode, layout)
                fields = timed_row(
                    key, label + " (bitwise repeat ok)", abs_err, rel, kernel,
                    plain, library, mid_bytes(V, W), 2 * V.numel() * R, dname,
                    lib_name, report=i == 0 and dtype == torch.float32)
                if i == 0:
                    sfx = "" if dtype == torch.float32 else "_bf16"
                    RESULTS[key]["path" + sfx] = path
                    add_device_ms(key, kernel, library, lib_name, sfx)
                    if sfx:
                        RESULTS[key].update({k + sfx: fields[k] for k in (
                            "ms", "plain_ms", "library_ms", "bound_ms")})
            del V, W
        for i, (shape, R) in enumerate(TRIPLE_CHECKS):
            V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            Ws = [torch.rand((s, R), generator=gen, device="cuda")
                  for s in shape[1:]]
            label = f"triple_roots {shape} R={R} {dname}" + (
                path_label(", ".join(
                    f"O{k + 1} {p}" for k, p in enumerate(triple_paths(
                        mc, lc, V, R))))
                if dtype == torch.bfloat16 else "")

            def kernel():
                return tr.triple_roots(V, *Ws)

            def plain():
                return tr.triple_roots_plain(V, *Ws)

            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{label}: two calls differ")
            errs = [held_to_plain(f"{label} O{k + 1}", g, w)
                    for k, (g, w) in enumerate(zip(got, plain()))]
            out_bytes = tensor_bytes(*got)
            del got, again
            library = triple_library(V, Ws)
            fields = timed_row(
                "K6", label + " (bitwise repeat ok)", max(e[0] for e in errs),
                max(e[1] for e in errs), kernel, plain, library,
                tensor_bytes(V, *Ws) + out_bytes, 6 * V.numel() * R, dname,
                "three torch.matmul calls, TF32 off"
                + (", bf16 out" if dname == "bfloat16" else ""),
                report=i == 0 and dtype == torch.float32)
            if i == 0:
                # the coil shape: device times, and the floor of a design
                # that reads V twice
                sfx = "" if dtype == torch.float32 else "_bf16"
                res = RESULTS["K6"]
                res["device_ms" + sfx], res["device_ms_by_launch" + sfx] = \
                    device_split_ms(f"K6 {dname}", kernel)
                res["library_device_ms" + sfx] = device_busy_ms(
                    f"three torch.matmul calls {dname}", library)
                res["bound_two_read_ms" + sfx] = bound_ms(
                    2 * tensor_bytes(V) + tensor_bytes(*Ws) + out_bytes,
                    6 * V.numel() * R, dname)[0]
                print(f"  K6 {dname}: one-read bound {fields['bound_ms']:.4f} "
                      f"ms, two-read floor {res['bound_two_read_ms' + sfx]:.4f}"
                      " ms")
                if sfx:
                    res.update({k + sfx: fields[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms")})
            del V, Ws
            torch.cuda.empty_cache()


def triple_library(V, Ws):
    """K6's yardstick: three torch.matmul calls over views of V (TF32 off;
    bf16 V: bf16 factors and bf16 outputs) that compute its three sums,
    without the permutes to rank-outer."""
    P, B1, B2, M = V.shape
    W1, W2, W3 = (W.to(V.dtype) for W in Ws)
    V1, V2, V3 = (V.reshape(P, B1, B2 * M), V.reshape(P * B1, B2, M),
                  V.reshape(-1, M))
    return lambda: (W1.T @ V1, W2.T @ V2, V3 @ W3)


def random_coo(shape, nnz, R, gen, seed, skewed=False):
    """A COO tensor of ``nnz`` uniform nonzeros (duplicates kept, as
    bench.py's fixture keeps them), uniform values and factors; with
    ``skewed`` mode 0's indices follow a Zipf law (a = 1.2) clipped to
    the mode's size."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch.ops import sparse
    cols = [torch.randint(0, s, (nnz,), generator=gen, device="cuda",
                          dtype=torch.int32) for s in shape]
    if skewed:
        z = np.random.default_rng(seed).zipf(1.2, nnz)
        cols[0] = torch.from_numpy(
            (np.minimum(z, shape[0]) - 1).astype(np.int32)).cuda()
    st = sparse.SparseTensor(torch.stack(cols, 1),
                             torch.rand(nnz, generator=gen, device="cuda"),
                             tuple(shape))
    Ws = [torch.rand((s, R), generator=gen, device="cuda") for s in shape]
    return st, Ws


def sparse_cli_input():
    """The COO tensor and initial factors of phase 6's CLI run, built as
    cli.cmd_test_als builds them (f32, on the card)."""
    import numpy as np
    from pairwise_perturbation_tpu_torch import cli
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils import flags, synth
    args = flags.build_parser().parse_args(SPARSE_CLI + ["-quiet"])
    flags.clamp(args)
    V = synth.make_tensor(args.tensor, args.dim, args.size, args.rank,
                          args.colmin, args.colmax, args.rationoise,
                          seed=args.seed, dtype=np.float32)
    st = cli._sparse_tensor(args, V, "cuda")
    return st, cp.init_factors(st.shape, args.rank, seed=args.seed,
                               device="cuda")


def coo_cases(gen):
    """(label, COO tensor, factors, whether its times are K7's reported
    ones) of every K7 check, built one at a time: the sparse CLI's input,
    then COO_CHECKS (times reported at the fixture)."""
    import torch
    yield ("sparse CLI input (Poisson 100^4)", *sparse_cli_input(), False)
    for i, (label, shape, nnz, R, skewed) in enumerate(COO_CHECKS):
        st, Ws = random_coo(shape, nnz, R, gen, seed=i, skewed=skewed)
        if skewed:
            top = int(torch.bincount(st.indices[:, 0]).max())
            print(f"{label}: heaviest mode-0 row holds {top} of {nnz} "
                  "nonzeros")
        yield label, st, Ws, i == 0


def coo_bytes(st, Ws, mode):
    """K7's bytes: the sorted indices of the other modes and the values
    read, the other modes' factors read once, the (s_mode, R) output
    written."""
    R = next(W for W in Ws if W is not None).shape[1]
    return (4 * st.nnz * st.ndim + 4 * R * st.shape[mode]
            + tensor_bytes(*(W for j, W in enumerate(Ws) if j != mode)))


# A 40-byte factor row (R = 10) starts 8-byte aligned, so it spans two
# 32-byte L2 sectors; K7 gathers one row per nonzero and factor.
L2_SECTORS_PER_ROW = 2


def l2_read_gbps(passes=16):
    """The L2's read rate as torch.sum sees it: bytes over device time of
    row sums that read a float32 tensor the 50 MB L2 holds (8 and 16 MB,
    512 rows) ``passes`` times over through a stride-0 view, 8192 rows
    summed in all; returns the higher rate."""
    import torch
    rates = []
    for mb in (8, 16):
        x = torch.rand((512, mb * 2**9), device="cuda")
        busy = device_busy_ms(
            f"row sums over {mb} MB held in L2, {passes} passes",
            lambda: x.expand(passes, *x.shape).sum(2))
        rates.append(passes * mb * 2**20 / busy / 1e6)
        print(f"  L2 read rate at {mb} MB: {rates[-1]:.0f} GB/s")
        del x
    return max(rates)


def k7_host(st, Ws, mode):
    """K7's host time per call at one case (microseconds): the wrapper's,
    and its C entry's alone (the two launches, from a built launch
    record; not in an older tree, whose K7 keeps no launch record);
    stored in ``RESULTS["K7"]``."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import _build
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp as coo
    wrapper = host_us(lambda: coo.coo_mttkrp(st, Ws, mode))
    RESULTS["K7"]["host_us"] = wrapper
    if not hasattr(coo, "launch_record"):
        print(f"  host per call: wrapper {wrapper:.1f} us")
        return
    stream = _build.current_stream(st.values.device)
    rec = coo.launch_record(st, Ws, mode, stream)
    out = torch.empty((st.shape[mode], rec.R), device="cuda")
    entry = host_us(lambda: rec.lib.pp_coo_mttkrp(
        rec.args, rec.ptrs, out.data_ptr(), stream))
    print(f"  host per call: wrapper {wrapper:.1f} us, its C entry alone "
          f"{entry:.1f} us, the rest (Python) {wrapper - entry:.1f} us")
    RESULTS["K7"]["entry_host_us"] = entry


def compare_coo():
    """K7 against its plain version on the card, every mode; times
    reported at the fixture's mode 0, with device times (torch.profiler)
    there, at the fixture's pair view (0, 1) and at NELL-2's mode 0. No
    single PyTorch call computes it: the reference is the kernel-off route
    (gather + f32 index_add_)."""
    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.ops import sparse
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp as coo
    gen = torch.Generator(device="cuda").manual_seed(2)
    res = RESULTS["K7"]

    def kernel_off(st, Ws, mode):
        with config.override(use_kernels=False):
            return sparse.mttkrp(st, Ws, mode)

    def check(name, st, Ws, mode, report=False, reference=None):
        R = next(W for W in Ws if W is not None).shape[1]
        abs_err, rel = held_twice(       # the first call builds the plan
            name, lambda: coo.coo_mttkrp(st, Ws, mode),
            lambda: coo.coo_mttkrp_plain(st, Ws, mode))
        return timed_row("K7", name + " (bitwise repeat ok)", abs_err, rel,
                         lambda: coo.coo_mttkrp(st, Ws, mode),
                         lambda: coo.coo_mttkrp_plain(st, Ws, mode), None,
                         coo_bytes(st, Ws, mode), st.nnz * R * st.ndim,
                         reference=reference, report=report)

    for label, st, Ws, timed in coo_cases(gen):
        R = Ws[0].shape[1]
        nell2 = label == "NELL-2 shape"
        l2_gbps = l2_read_gbps() if nell2 else None
        for mode in range(st.ndim):
            name = (f"coo_mttkrp {label} {st.shape} nnz={st.nnz} "
                    f"R={R} mode {mode}")
            report = timed and mode == 0
            fields = check(name, st, Ws, mode, report, reference=(
                "the kernel-off route, gather + f32 index_add_",
                lambda: kernel_off(st, Ws, mode)) if report else None)
            if report:
                res["device_ms"] = device_busy_ms(
                    "kernel", lambda: coo.coo_mttkrp(st, Ws, 0))
                device_busy_ms("plain",
                               lambda: coo.coo_mttkrp_plain(st, Ws, 0))
                k7_host(st, Ws, 0)
            if nell2 and mode == 0:
                res["nell2_ms"] = fields["ms"]
                res["nell2_device_ms"] = device_busy_ms(
                    "kernel", lambda: coo.coo_mttkrp(st, Ws, 0))
                sectors = 32 * L2_SECTORS_PER_ROW * st.nnz * (st.ndim - 1)
                res["l2_read_gbps"] = l2_gbps
                res["nell2_l2_floor_ms"] = sectors / l2_gbps / 1e6
                print(f"  L2 gather floor: {sectors / 1e9:.2f} GB of 32-byte "
                      f"sectors at {l2_gbps:.0f} GB/s = "
                      f"{res['nell2_l2_floor_ms']:.4f} ms (bytes bound "
                      f"{fields['bound_ms']:.4f} ms)")
        if timed:
            # the fixture's PP pair cache (0, 1): K7 on the fused view, one
            # mode of 40,000 rows of ~40 nonzeros, output mode 0
            pv, pf = sparse.pair_view(st, 0, 1), sparse.pair_factors(Ws, 0, 1)
            fields = check(f"coo_mttkrp {label} pair view (0, 1) {pv.shape} "
                           f"nnz={pv.nnz} R={R} mode 0", pv, pf, 0)
            res["pair_view_ms"] = fields["ms"]
            res["pair_view_device_ms"] = device_busy_ms(
                "kernel", lambda: coo.coo_mttkrp(pv, pf, 0))
            del pv, pf
        del st, Ws
        torch.cuda.empty_cache()


# (V shape, R, offset, dtype) of last_contract (K5): the coil-100 shape
# of bench_firstpair, a ragged (N, B), R above one rank chunk (32), the
# coil shape again with V's data 4 bytes past a 16-byte boundary (offset
# 1 float: scalar loads), and bf16 V at the coil shape (K6's O3), aligned
# (the mma path) and 2 bytes off (the fma path, scalar loads); then bf16
# at a ragged N with a last partial step (mma), a ragged B (fma) and R 40
# (mma, three rank chunks).
K5_CHECKS = [(COIL_SHAPE, 10, 0, "float32"), ((37, 1001), 7, 0, "float32"),
             ((64, 64, 1000), 40, 0, "float32"), (COIL_SHAPE, 10, 1, "float32"),
             (COIL_SHAPE, 10, 0, "bfloat16"), (COIL_SHAPE, 10, 1, "bfloat16"),
             ((37, 1000), 7, 0, "bfloat16"), ((37, 1001), 7, 0, "bfloat16"),
             ((64, 64, 1000), 40, 0, "bfloat16")]
# (P, B, M) views and R of S2/S5: the two coil-100 views of
# bench_midvariants (the first is also bench_rankpos's mode-1 view), a
# ragged shape (M odd: bf16 takes the fma path), R = 40 (bf16: the mma
# path with a partial column tile), and a ragged B and column tile with
# M % 8 == 0 (bf16: the mma path). Each in f32 and bf16 V.
VIEW_CHECKS = [((3, 128, 921600), 10), ((384, 128, 7200), 10),
               ((5, 37, 1001), 7), ((200, 200, 200), 40),
               ((5, 37, 1000), 7)]
# (P, B, M) of column_sum (S4): the two coil views and a ragged shape.
S4_CHECKS = [(3, 128, 921600), (384, 128, 7200), (5, 37, 1001)]


def compare_firstlevel():
    """Phase 3d: K5, S2, S4 and S5 (every block width) against their
    plain versions, two launches bit for bit equal; S1 and S3 are K4' at
    the coil view in f32 and bf16. Times reported at the coil shapes."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import column_sum as cs
    from pairwise_perturbation_tpu_torch.ops.kernels import last_contract as lc
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc
    gen = torch.Generator(device="cuda").manual_seed(6)
    for i, (shape, R, offset, dname) in enumerate(K5_CHECKS):
        buf = torch.rand(math.prod(shape) + offset, generator=gen,
                         device="cuda").to(getattr(torch, dname))
        V = buf[offset:].view(shape)
        W = torch.rand((shape[-1], R), generator=gen, device="cuda")
        V2, Wd = V.reshape(-1, shape[-1]), W.to(V.dtype)
        p = k5_plan(lc, V, R)
        label = (f"last_contract {shape} R={R} {dname} data_ptr % 16 = "
                 f"{V.data_ptr() % 16}"
                 + path_label(getattr(p, "path", "fma")
                              if dname == "bfloat16" else "")
                 + f" ({p.n_slices} slices of {p.slice_cols}, {p.blocks} "
                 f"blocks each, vec {p.vec})")
        abs_err, rel = held_twice(label, lambda: lc.last_contract(V, W),
                                  lambda: lc.last_contract_plain(V, W))
        fields = timed_row(
            "K5", label + " (bitwise repeat ok)", abs_err, rel,
            lambda: lc.last_contract(V, W),
            lambda: lc.last_contract_plain(V, W), lambda: V2 @ Wd,
            tensor_bytes(V, W) + 4 * V2.shape[0] * R, 2 * V.numel() * R,
            dname, "torch.matmul" + (", bf16 out" if dname == "bfloat16"
                                     else ""),
            report=i == 0)
        if offset == 0 and shape == COIL_SHAPE:
            sfx = "" if dname == "float32" else "_bf16"
            RESULTS["K5"]["device_ms" + sfx] = device_busy_ms(
                "kernel", lambda: lc.last_contract(V, W))
            RESULTS["K5"]["library_device_ms" + sfx] = device_busy_ms(
                "torch.matmul", lambda: V2 @ Wd)
            if sfx:
                RESULTS["K5"].update({k + sfx: fields[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms")})
        del V, W, V2, Wd, buf
    for i, (shape, R) in enumerate(VIEW_CHECKS):
        V3 = torch.rand(shape, generator=gen, device="cuda")
        W = torch.rand((shape[1], R), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            Vd = V3.to(dtype)
            dname = str(dtype).replace("torch.", "")
            bf16 = dtype == torch.bfloat16
            for layout in ("rank_major", "rank_outer"):
                for cols in mc.BLOCK_COLS:
                    label = (f"mid_contract {layout} cols={cols} {shape} "
                             f"R={R} {dname}"
                             + path_label(mid_path(mc, Vd, R, 1, layout,
                                                   cols)))

                    def kernel(lo=layout, c=cols):
                        return mc.mid_contract(Vd, W, 1, layout=lo,
                                               block_cols=c)

                    def plain(lo=layout):
                        return mc.mid_contract_plain(Vd, W, 1, layout=lo)

                    abs_err, rel = held_twice(label, kernel, plain)
                    # S1/S3: K4' at 256 columns; S2: rank-outer at 256;
                    # S5: rank-major at every width, f32
                    keys = ["S5"] if layout == "rank_major" and not bf16 \
                        else []
                    if cols == 256:
                        keys.append({"rank_outer": "S2"}.get(
                            layout, "S3" if bf16 else "S1"))
                    for key in keys:
                        lib_name = "torch.einsum" + (", bf16 out" if bf16
                                                     else "")
                        library = mid_library(Vd, W, 1, layout)
                        report = i == 0 and key != "S5" \
                            and (key == "S3") == bf16
                        fields = timed_row(
                            key, f"[{key}] {label} (bitwise repeat ok)",
                            abs_err, rel, kernel, plain, library,
                            mid_bytes(Vd, W), 2 * Vd.numel() * R, dname,
                            lib_name, report=report)
                        if report:
                            add_device_ms(key, kernel, library, lib_name)
                        elif i == 0 and key == "S2":
                            # S2 with bf16 V: K6's O1 and O2 launch
                            add_device_ms(key, kernel, library, lib_name,
                                          "_bf16")
                            RESULTS[key].update({k + "_bf16": fields[k] for k
                                                 in ("ms", "bound_ms")})
                        if key == "S5" and i < 2:
                            res = RESULTS["S5"].setdefault(
                                "ms_by_view_and_block_cols", {})
                            res[f"m{i + 1} cols={cols}"] = fields["ms"]
                            if i == 0 and fields["ms"] < RESULTS["S5"].get(
                                    "ms", math.inf):
                                RESULTS["S5"].update(fields, block_cols=cols)
            del Vd
        del V3, W
        torch.cuda.empty_cache()
    for i, shape in enumerate(S4_CHECKS):
        V3 = torch.rand(shape, generator=gen, device="cuda")
        label = f"column_sum {shape}"
        abs_err, rel = held_twice(label, lambda: cs.column_sum(V3),
                                  lambda: cs.column_sum_plain(V3))
        fields = timed_row(
            "S4", label + " (bitwise repeat ok)", abs_err, rel,
            lambda: cs.column_sum(V3), lambda: cs.column_sum_plain(V3),
            lambda: V3.sum(1, keepdim=True),
            tensor_bytes(V3) + 4 * shape[0] * shape[2], V3.numel(),
            library_name="torch.sum", report=i == 0)
        print(f"  column_sum reads {tensor_bytes(V3) / fields['ms'] / 1e6:.0f}"
              " GB/s")
        if i == 0:
            RESULTS["S4"]["device_ms"] = device_busy_ms(
                "kernel", lambda: cs.column_sum(V3))
            RESULTS["S4"]["library_device_ms"] = device_busy_ms(
                "torch.sum", lambda: V3.sum(1, keepdim=True))
            host, lib_host = (host_us(lambda: cs.column_sum(V3)),
                              host_us(lambda: V3.sum(1, keepdim=True)))
            print(f"  host per call: column_sum {host:.1f} us, torch.sum "
                  f"{lib_host:.1f} us")
            RESULTS["S4"].update(host_us=host, library_host_us=lib_host)
        if i == 1:
            RESULTS["S4"]["ms_m2_view"] = fields["ms"]
        del V3
        torch.cuda.empty_cache()


def run_scripts():
    """Phase 7: the ported benchmark scripts at the coil-100 shape, rank
    10, in this process. Each must return 0, and every launch of its run
    must belong to one of its rows; returns the launches of the rows of
    each script kernel (K5, S1-S5)."""
    import importlib
    from collections import Counter
    from pairwise_perturbation_tpu_torch.scripts import _bench
    launches = Counter()
    for name in SCRIPTS:
        mod = importlib.import_module(
            f"pairwise_perturbation_tpu_torch.scripts.{name}")
        print(f"--- {name}", flush=True)
        _bench.reset_launch_counts()
        t0 = time.perf_counter()
        rc, rows = mod.run([])
        totals = {k: n for k, n in _bench.launch_counts().items() if n}
        print(f"{name}: rc {rc} in {time.perf_counter() - t0:.3f} s, "
              f"launches {totals}")
        if rc != 0:
            raise AssertionError(f"{name} returned {rc}")
        summed = Counter()
        for row in rows:
            summed.update(row["launches"])
            if row.get("kernel") in SCRIPT_COUNTERS:
                launches[row["kernel"]] += row["launches"].get(
                    SCRIPT_COUNTERS[row["kernel"]], 0)
        if dict(summed) != totals:
            raise AssertionError(f"{name}: launches outside its rows "
                                 f"({dict(summed)} vs {totals})")
    return launches


def check_csv(rows, label):
    """Body rows of a CP CSV: the reference header, finite values, PP rows
    present and a gradnorm that decreased; prints a summary line."""
    if ",".join(rows[0]) != CSV_HEADER:
        raise AssertionError(f"{label}: CSV header {rows[0]}")
    body = [[float(x) for x in r] for r in rows[1:]]
    if not body or not all(math.isfinite(x) for r in body for x in r):
        raise AssertionError(f"{label}: CSV is empty or holds non-finite "
                             "values")
    n_pp = sum(1 for r in body if r[4] == 1)
    gn0, gn1 = body[0][2], body[-1][2]
    print(f"{label}: {len(body)} rows, {n_pp} PP rows, gradnorm "
          f"{gn0:.6e} -> {gn1:.6e}")
    if n_pp == 0:
        raise AssertionError(f"{label}: no PP rows: the PP phase never ran")
    if not gn1 < gn0:
        raise AssertionError(f"{label}: gradnorm did not decrease")
    return body


def run_cli_main_path():
    """test_als -model CP -pp 1 at 200^3 rank 10; returns launch counts."""
    from pairwise_perturbation_tpu_torch import cli
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    from pairwise_perturbation_tpu_torch.utils import tracing
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cp_pp_200.csv")
        # warm-up: CUDA context, cuBLAS/cuSOLVER handles and the kernels'
        # first launches, kept out of the phase times below
        t0 = time.perf_counter()
        cli.main(["test_als", "-tensor", "r", "-pp", "1", "-dim", "3",
                  "-size", "200", "-rank", "10", "-maxiter", "3",
                  "-pp_res_tol", "0.1", "-quiet", "-filename", out])
        print(f"warm-up run (3 sweeps): {time.perf_counter() - t0:.3f} s")
        tracing.reset()
        mttkrp3.reset_launch_counts()
        rc = cli.main(["test_als", "-model", "CP", "-tensor", "r", "-pp", "1",
                       "-dim", "3", "-size", "200", "-rank", "10",
                       "-maxiter", "40", "-resprint", "1",
                       "-pp_res_tol", "0.1", "-profile", "1",
                       "-filename", out])
        launches = dict(mttkrp3.LAUNCHES)
        with open(out) as fh:
            rows = list(csv.reader(fh))
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    check_csv(rows, "CLI main path")
    print(f"kernel launches {launches}")
    for mode, n in launches.items():
        if n <= 0:
            raise AssertionError(f"mode-{mode} kernel never launched on "
                                 "the main path")
    print_phase_times(tracing.stats())
    return launches


def cli_512(dtype, first, maxiter, out, *extra):
    """cli.main for test_als -model CP -pp 1 at 512^3 rank 10, V stored in
    ``dtype``, under use_kernels_first = ``first``; returns its code."""
    from pairwise_perturbation_tpu_torch import cli, config
    with config.override(use_kernels_first=first):
        return cli.main(["test_als", "-model", "CP", "-tensor", "r",
                         "-pp", "1", "-dim", "3", "-size", "512",
                         "-rank", "10", "-maxiter", str(maxiter),
                         "-pp_res_tol", "0.1", "-dtype", dtype, "-quiet",
                         "-filename", out, *extra])


def run_cli_512(dtype, first, beside=None):
    """The 512^3 CLI run of 20 sweeps, timed by phase. Returns (phase
    stats, K4 rank-minor launches, K4' rank-major launches); with the
    kernel on, each DT sweep's node (1, 2) is one rank-minor launch and
    nothing launches the rank-major layout."""
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    label = f"CLI 512^3 {dtype} use_kernels_first={first}"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"cp_pp_512_{dtype}.csv")
        tracing.reset()
        mid_contract.reset_launch_counts()
        with _bench.warm_launches() as warm:
            rc = cli_512(dtype, first, 20, out, "-resprint", "1",
                         "-profile", "1")
        minor = mid_contract.LAUNCHES["rank_minor"]
        major = mid_contract.LAUNCHES["rank_major"]
        with open(out) as fh:
            rows = list(csv.reader(fh))
    tracing.enable(False)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    check_csv(rows, label)
    stats = tracing.stats()
    if first:
        n_dt = stats.get("cp.dt_sweep", (0,))[0]
        held_apart(f"{label} K4 rank-minor (rank-major {major})", minor,
                   warm.get("mid_contract.rank_minor", 0), n_dt, 1,
                   "DT sweeps")
    print_phase_times(stats, beside)
    return stats, minor, major


PP_BENCH_ARGS = ["pp_bench", "-model", "CP", "-tensor", "r", "-dim", "3",
                 "-size", "512", "-rank", "10", "-maxiter", "3"]
BENCH_KINDS = ("DTtime", "PPfirst", "PPsecond")


def run_pp_bench(first):
    """``pp_bench -model CP`` at 512^3 rank 10, f32, maxiter 3, through the
    CLI under use_kernels_first = ``first``; checks the CSV (the
    reference's header, 3 [DTtime] rows then 3 [PPfirst]/[PPsecond]
    pairs, finite positive times) and K4's launches: one a DT sweep (the
    untimed one and the 3 timed) with the kernel on, none with it off.
    Returns ({row kind: median s}, K4 launches)."""
    from pairwise_perturbation_tpu_torch import cli, config
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "pp_bench_512.csv")
        mid_contract.reset_launch_counts()
        with config.override(use_kernels_first=first):
            rc = cli.main(PP_BENCH_ARGS + ["-quiet", "-filename", out])
        launches = mid_contract.LAUNCHES["rank_minor"]
        with open(out) as fh:
            rows = list(csv.reader(fh))
    if rc != 0:
        raise AssertionError(f"pp_bench returned {rc}")
    kinds = [r[0] for r in rows[1:]]
    times = [float(r[1]) for r in rows[1:]]
    if rows[0] != ["[timetype]", "[dtime]"] or kinds != (
            ["[DTtime]"] * 3 + ["[PPfirst]", "[PPsecond]"] * 3):
        raise AssertionError(f"pp_bench CSV: header {rows[0]}, rows {kinds}")
    if not all(math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"pp_bench times {times}")
    if launches != (4 if first else 0):
        raise AssertionError(f"pp_bench use_kernels_first={first}: K4 "
                             f"launched {launches} times, expected "
                             f"{4 if first else 0} (one a DT sweep)")
    med = {k: statistics.median(t for kind, t in zip(kinds, times)
                                if kind == f"[{k}]") for k in BENCH_KINDS}
    print(f"pp_bench 512^3 f32 use_kernels_first={first}: K4 launches "
          f"{launches}; medians " + ", ".join(
              f"[{k}] {1e3 * v:.3f} ms" for k, v in med.items()))
    return med, launches


def print_phase_times(stats, beside=None, names=CP_PHASES):
    for name in names:
        calls, secs, med = stats.get(name, (0, 0.0, float("nan")))
        line = (f"  {name:22s} calls {calls:4d} total {secs:.4f} s "
                f"median {1e3 * med:.3f} ms")
        if beside is not None:
            line += (f"  (kernel off: median "
                     f"{1e3 * beside.get(name, (0, 0.0, float('nan')))[2]:.3f}"
                     " ms)")
        print(line)


def run_coil_order4(dtype="float32", triple=False, beside=None,
                    partial=None):
    """Order-4 CP-PP on a seeded uniform tensor of the coil-100 shape,
    V stored in ``dtype``, with use_kernels_triple set to ``triple``; with
    ``partial`` (an update percentage) PP-partupdate (``test_als -pp 2``),
    whose CSV is checked. Returns (phase stats, K6 launches)."""
    import torch
    from pairwise_perturbation_tpu_torch import config, native
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.rand(COIL_SHAPE, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    Ws = cp.init_factors(COIL_SHAPE, 10, seed=0, device="cuda")
    split, _, _ = native.plan_tree_split_traffic(COIL_SHAPE, 10)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=5,
                      tree_split=split, update_percentage=partial or 1.0)
    tracing.reset()
    _bench.reset_launch_counts()
    tracing.enable()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "coil.csv")
        plot = PlotFile(out, echo=False) if partial else None
        t0 = time.perf_counter()
        with config.override(use_kernels_triple=triple), \
                _bench.warm_launches() as warm:
            res = cp.als_cp_pp(V, Ws, cfg, plot,
                               partial_update=partial is not None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if plot is not None:
            plot.close()
            with open(out) as fh:
                rows = list(csv.reader(fh))
    tracing.enable(False)
    counts = _bench.launch_counts()
    launches = counts["triple_roots.triple_roots"]
    stats = tracing.stats()
    gns = [h["gradnorm"] for h in res.history]
    n_pp = sum(1 for h in res.history if h["pp"] == 1)
    what = f"-pp 2 update_percentage {partial} " if partial else ""
    print(f"coil-shape {COIL_SHAPE} {dtype} R=10 split {split} {what}"
          f"use_kernels_triple={triple}: {res.iters} sweeps in {wall:.3f} s, "
          f"{len(gns)} logged rows, {n_pp} PP rows, "
          f"gradnorm {gns[0]:.6e} -> {gns[-1]:.6e}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(g) for g in gns + [res.diffV]):
        raise AssertionError("non-finite gradnorm or diffV")
    if not gns[-1] < gns[0]:
        raise AssertionError("gradnorm did not decrease")
    if partial:
        check_csv(rows, f"coil -pp 2 CSV ({dtype}, triple={triple})")
        if "cp.pp_sweep" in stats or not stats.get(
                "cp.pp_partupdate_sweep", (0,))[0]:
            raise AssertionError("-pp 2 ran no partial-update sweep, or a "
                                 "full PP sweep")
    if triple:
        n_builds = stats.get("cp.pp_cache_build", (0,))[0]
        print(f"every kernel launch of the run: "
              f"{ {k: n for k, n in counts.items() if n} }")
        # the warm build is the first build of the solve, reused
        held_apart("K6", launches, warm.get("triple_roots.triple_roots", 0),
                   n_builds, 1, "in-loop cache builds")
        # each K6 call: O1 and O2 by rank-outer mid_contract, O3 by K5
        if (counts["mid_contract.rank_outer"], counts[
                "last_contract.last_contract"]) != (2 * launches, launches):
            raise AssertionError("K6's inner launches differ from two "
                                 "rank-outer launches and one K5 a call")
    names = CP_PHASES
    if partial:
        names = ("cp.dt_sweep", "cp.pp_cache_build",
                 "cp.pp_partupdate_sweep", "cp.diagnostics")
    print_phase_times(stats, beside, names)
    return stats, launches


def run_partupdate(pp1_stats):
    """Phase 5c: PP-partupdate at the coil shape, f32, update percentage
    0.5 (2 of 4 modes a sweep), with the kernels' defaults and under
    use_kernels_triple; its sweep and cache-build medians beside phase
    5's -pp 1 run (``pp1_stats``). Returns K6's launches."""
    stats = {}
    launches = 0
    for triple in (False, True):
        stats[triple], n = run_coil_order4("float32", triple=triple,
                                           partial=0.5)
        launches += n

    def med(st, name):
        return 1e3 * st.get(name, (0, 0.0, float("nan")))[2]

    print("coil f32 medians, ms: " + "; ".join(
        f"triple={t}: cp.pp_partupdate_sweep "
        f"{med(stats[t], 'cp.pp_partupdate_sweep'):.3f}, cp.pp_cache_build "
        f"{med(stats[t], 'cp.pp_cache_build'):.3f}" for t in stats)
        + f"; -pp 1 (phase 5): cp.pp_sweep "
        f"{med(pp1_stats, 'cp.pp_sweep'):.3f}, cp.pp_cache_build "
        f"{med(pp1_stats, 'cp.pp_cache_build'):.3f}")
    return launches


RUN_512 = ["run", "-tensor", "r", "-dim", "3", "-size", "512", "-rank",
           "10"]


def check_run_csv(rows, label):
    """Body rows of a ``run`` CSV: the reference header, finite values, no
    PP rows, a sweep count that rises and a gradnorm that decreased."""
    if ",".join(rows[0]) != CSV_HEADER:
        raise AssertionError(f"{label}: CSV header {rows[0]}")
    body = [[float(x) for x in r] for r in rows[1:]]
    if len(body) < 2 or not all(math.isfinite(x) for r in body for x in r):
        raise AssertionError(f"{label}: CSV too short or holds non-finite "
                             "values")
    sweeps = [r[1] for r in body]
    if any(r[4] != 0 for r in body) or sweeps != sorted(set(sweeps)):
        raise AssertionError(f"{label}: PP rows or sweeps {sweeps}")
    print(f"{label}: {len(body)} rows, sweeps {sweeps[0]:g} -> "
          f"{sweeps[-1]:g}, gradnorm {body[0][2]:.6e} -> {body[-1][2]:.6e}")
    if not body[-1][2] < body[0][2]:
        raise AssertionError(f"{label}: gradnorm did not decrease")
    return body


def msdt_holdouts(order, n_steps, macro=False):
    """The hold-out of every MSDT step of a run from the start (the full
    rotation order-1, ..., 0, again); a macro step is a whole rotation."""
    per = order if macro else 1
    return [(order - 1 - k) % order for k in range(n_steps * per)]


def step_scope(stats):
    """(name, calls, median s) of the run's optimizer step scope."""
    (name, st), = [(n, v) for n, v in stats.items()
                   if n.endswith((".step", ".step_cycle"))]
    return name, st[0], st[2]


def msdt_holdout_medians(name, order):
    """{hold-out: median ms} of an MSDT run's steps (scope ``name``),
    printed."""
    from pairwise_perturbation_tpu_torch.utils import tracing
    times = tracing.samples(name)
    lefts = msdt_holdouts(order, len(times))
    med = {h: 1e3 * statistics.median(t for t, l in zip(times, lefts)
                                      if l == h)
           for h in sorted(set(lefts))}
    print(f"  {name} median by hold-out, ms: " + ", ".join(
        f"{h}: {m:.3f}" for h, m in med.items()))
    return med


def run_cli_run(pp, first, maxiter, *extra):
    """``run -pp pp`` through the CLI at 512^3 rank 10, f32, under
    use_kernels_first = ``first``, -profile 1; checks the CSV. Returns
    (phase stats, every kernel's launches)."""
    from pairwise_perturbation_tpu_torch import cli, config
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    label = f"run -pp {pp} 512^3 f32 use_kernels_first={first}"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run_512.csv")
        tracing.reset()
        _bench.reset_launch_counts()
        with config.override(use_kernels_first=first):
            rc = cli.main(RUN_512 + ["-pp", str(pp), "-maxiter",
                                     str(maxiter), "-resprint", "2",
                                     "-profile", "1", "-quiet", "-filename",
                                     out, *extra])
        counts = _bench.launch_counts()
        with open(out) as fh:
            rows = list(csv.reader(fh))
    tracing.enable(False)
    if rc != 0:
        raise AssertionError(f"{label}: cli.main returned {rc}")
    check_run_csv(rows, label)
    return tracing.stats(), counts


def run_512_optimizers():
    """Phase 8 at 512^3: Simple (K1-K3 once a step, in dtime, and once,
    once and twice a diagnostics row), then MSDT with use_kernels_first
    off and on (K4 once a step whose hold-out is mode 0, only when on).
    Returns ({kernel id: launches}, {label: (scope, median s)})."""
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
    stats, counts = run_cli_run(4, False, 8)
    _, steps, med = step_scope(stats)
    rows = stats["cp.diagnostics"][0]
    k = [counts[f"mttkrp3.{m}"] for m in range(3)]
    print(f"Simple: {steps} steps, {rows} diagnostics rows; K1-K3 "
          f"launches {k}, step median {1e3 * med:.3f} ms")
    if k != [steps + rows, steps + rows, steps + 2 * rows]:
        raise AssertionError("K1-K3 launches differ from one each a Simple "
                             "step and 1/1/2 a diagnostics row")
    launches = {f"K{m + 1}": n for m, n in enumerate(k)}
    medians = {"Simple 512^3": ("CPSimpleOptimizer.step", med)}
    launches["K4"] = 0
    for first in (False, True):
        stats, counts = run_cli_run(1, first, 6)
        name, steps, med = step_scope(stats)
        n = counts["mid_contract.rank_minor"]
        want = sum(1 for h in msdt_holdouts(3, steps) if h == 0) \
            if first else 0
        print(f"MSDT use_kernels_first={first}: {steps} steps, K4 launches "
              f"{n} (expected {want}), step median {1e3 * med:.3f} ms")
        msdt_holdout_medians(name, 3)
        if n != want or (first and n == 0):
            raise AssertionError("K4 launches differ from the MSDT steps "
                                 "whose hold-out is mode 0")
        launches["K4"] += n
        medians[f"MSDT 512^3 first={first}"] = (name, med)
    if mid_contract.LAUNCHES["rank_major"]:
        raise AssertionError("K4' launched on the run path")
    return launches, medians


def run_coil_optimizers():
    """Phase 8 at the coil shape, f32, rank 10, through ``cli.run_cpd``
    (the body of ``run``; the CLI makes cubic tensors only): DT, MSDT,
    DT-LR and MSDT-LR a few sweeps each, MSDT with -device_loop 1 (a
    rotation a step), and MSDT under use_kernels_first, where K4 serves
    every hold-out of mode 1. Returns (K4 launches, {label: (scope,
    median s)})."""
    import torch
    from pairwise_perturbation_tpu_torch import cli, config
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.rand(COIL_SHAPE, generator=gen, device="cuda")
    eligible = {m for m in range(3) if mid_contract.mid_contract_eligible(
        COIL_SHAPE, m, V.dtype, 10)}
    runs = [(0, False, False, 3), (1, False, False, 3), (2, False, False, 3),
            (3, False, False, 3), (1, False, True, 6), (1, True, False, 6)]
    k4 = 0
    medians = {}
    for pp, first, macro, maxiter in runs:
        label = (f"coil {cli.RUN_OPTIMIZERS[pp]}"
                 + (" -device_loop 1" if macro else "")
                 + (" use_kernels_first" if first else ""))
        Ws = cp.init_factors(COIL_SHAPE, 10, seed=0, device="cuda")
        tracing.reset()
        _bench.reset_launch_counts()
        tracing.enable()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "run_coil.csv")
            plot = PlotFile(out, echo=False)
            try:
                with config.override(use_kernels_first=first):
                    cli.run_cpd(V, Ws, pp, tol=0.0, maxiter=maxiter,
                                resprint=1, macro=macro, plot=plot)
                torch.cuda.synchronize()
            finally:
                plot.close()
                tracing.enable(False)
            with open(out) as fh:
                rows = list(csv.reader(fh))
        body = check_run_csv(rows, label)
        stats = tracing.stats()
        name, steps, med = step_scope(stats)
        n = _bench.launch_counts()["mid_contract.rank_minor"]
        want = 0
        if first:
            want = sum(1 for h in msdt_holdouts(4, steps, macro)
                       if h in eligible)
        print(f"  {name} {steps} calls, median {1e3 * med:.3f} ms; K4 "
              f"launches {n} (expected {want}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if n != want or (first and n == 0):
            raise AssertionError(f"{label}: K4 launches differ from the "
                                 "steps whose hold-out it admits")
        if pp in (1, 3) and not macro:
            msdt_holdout_medians(name, 4)
        if macro and body[1][1] - body[0][1] != 3.0:
            raise AssertionError(f"{label}: a rotation is not 3 sweeps")
        k4 += n
        medians[label] = (name, med)
    return k4, medians


def expected_coo_launches(stats, order):
    """K7 launches the sparse phase machine implies: ``order`` per exact
    sweep, order + 1 per diagnostics row (the gradnorm's MTTKRPs and the
    residual's) and order + C(order, 2) per PP cache build (the singles,
    then one per pair on its fused view); PP sweeps launch none."""
    return (order * stats.get("sparse.sweep", (0,))[0]
            + (order + 1) * stats.get("sparse.diagnostics", (0,))[0]
            + (order + math.comb(order, 2))
            * stats.get("sparse.pp_cache_build", (0,))[0])


def coo_warm_launches(order, pp):
    """K7 launches of a sparse CP engine's warm-ups (models/sparse_cp:
    cp.warm_run before the loop, out of dtime): one exact sweep, and for
    the PP engine one cache build, discarded."""
    return order + (order + math.comb(order, 2) if pp else 0)


def held_apart(label, total, warm, scoped, warm_want, what):
    """A kernel's launches in a run with its warm-ups' counted apart: the
    rest must be ``scoped`` (one a scope call of ``what``), the warm-ups'
    ``warm_want`` (models/cp.warm_run, before the loop), and the kernel
    must have launched."""
    print(f"{label}: {total} launches, {warm} in the warm-ups (expected "
          f"{warm_want}), {total - warm} in the loop ({scoped} {what})")
    if total - warm != scoped or warm != warm_want or total <= 0:
        raise AssertionError(f"{label}: launches {total} (warm-ups {warm})"
                             f" against {scoped} {what} and {warm_want}")


def run_sparse_cli():
    """test_als -model CP -issparse 1 -pp 1 on the folded Poisson tensor
    (100^4) at rank 10; returns the K7 launches of the run, its CSV rows
    and its phase stats."""
    from pairwise_perturbation_tpu_torch import cli
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    from pairwise_perturbation_tpu_torch.utils import tracing
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "sparse_p.csv")
        tracing.reset()
        coo_mttkrp.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(["test_als", *SPARSE_CLI, "-maxiter", "40",
                       "-resprint", "1", "-pp_res_tol", "0.1",
                       "-profile", "1", "-quiet", "-filename", out])
        wall = time.perf_counter() - t0
        launches = coo_mttkrp.LAUNCHES["coo_mttkrp"]
        with open(out) as fh:
            rows = list(csv.reader(fh))
    tracing.enable(False)
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    print(f"sparse CLI run (tensor build included): {wall:.3f} s")
    check_csv(rows, "sparse CLI -tensor p -dim 8 -size 10")
    stats = tracing.stats()
    want = expected_coo_launches(stats, 4)
    warm = coo_warm_launches(4, True)
    print(f"K7 launches {launches}, expected {want} (4 per exact sweep, "
          f"5 per diagnostics row, 10 per cache build) and {warm} in the "
          "warm-ups (a sweep and a cache build)")
    if not launches == want + warm or want <= 0:
        raise AssertionError("K7 launches differ from the phase machine's")
    print_phase_times(stats, names=SPARSE_PHASES)
    return launches, rows, stats


def run_sparse(st, shape, engine, maxiter, resprint, use_kernels,
               beside=None):
    """One sparse solve of ``engine`` (models/sparse_cp) from seeded
    factors, rank 10, with ``config.use_kernels`` set as given; checks
    finite output, a falling gradnorm and the K7 launch count, prints the
    phase medians and peak memory, returns the phase stats and the
    result."""
    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import cp, sparse_cp
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    from pairwise_perturbation_tpu_torch.utils import tracing
    Ws = cp.init_factors(shape, 10, seed=0, device="cuda")
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=maxiter,
                      resprint=resprint)
    tracing.reset()
    coo_mttkrp.reset_launch_counts()
    tracing.enable()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with config.override(use_kernels=use_kernels):
        res = getattr(sparse_cp, engine)(st, Ws, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracing.enable(False)
    stats = tracing.stats()
    launches = coo_mttkrp.LAUNCHES["coo_mttkrp"]
    gns = [h["gradnorm"] for h in res.history]
    n_pp = sum(1 for h in res.history if h["pp"] == 1)
    print(f"{engine} {shape} nnz={st.nnz} R=10 use_kernels={use_kernels}: "
          f"{res.iters} sweeps in {wall:.3f} s, {len(gns)} logged rows, "
          f"{n_pp} PP rows, gradnorm {gns[0]:.6e} -> {gns[-1]:.6e}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB,"
          f" K7 launches {launches}")
    if not all(math.isfinite(g) for g in gns + [res.diffV]):
        raise AssertionError("non-finite gradnorm or diffV")
    if not gns[-1] < gns[0]:
        raise AssertionError("gradnorm did not decrease")
    want = expected_coo_launches(stats, len(shape)) + coo_warm_launches(
        len(shape), engine == "als_cp_pp_sparse") if use_kernels else 0
    if launches != want:
        raise AssertionError(f"K7 launches {launches}, expected {want}")
    print_phase_times(stats, beside, names=SPARSE_PHASES)
    return stats, res


def sparse_fixture():
    """The sparse200_4_nnz1.6M tensor (seeded), with K7's setup built for
    every mode and every fused pair, so that no run below times a sort."""
    import torch
    from pairwise_perturbation_tpu_torch.ops import sparse
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    gen = torch.Generator(device="cuda").manual_seed(3)
    st, _ = random_coo(SPARSE_SHAPE, SPARSE_NNZ, 1, gen, seed=0)
    for mode in range(st.ndim):
        coo_mttkrp.plan(st, mode)
        for j in range(mode + 1, st.ndim):
            coo_mttkrp.plan(sparse.pair_view(st, mode, j), mode)
    return st


def run_sparse_full():
    """Phase 6b: sparse PP at the fixture, 20 sweeps, kernels off and on
    in turns (off, on, on, off; each "on" printed beside the last "off");
    plain sparse ALS to maxiter 3 at NELL-2's shape with K7. Each
    tensor's K7 setup is built before its runs. Returns the last
    kernel-off run's phase stats."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    gen = torch.Generator(device="cuda").manual_seed(4)
    st = sparse_fixture()
    off = None
    for on in (False, True, True, False):    # in turns: off, on, on, off
        stats, _ = run_sparse(st, SPARSE_SHAPE, "als_cp_pp_sparse", 20, 5,
                              on, beside=off if on else None)
        off = off if on else stats
    del st
    torch.cuda.empty_cache()
    st, _ = random_coo(NELL2_SHAPE, NELL2_NNZ, 1, gen, seed=0)
    for mode in range(len(NELL2_SHAPE)):
        coo_mttkrp.plan(st, mode)
    run_sparse(st, NELL2_SHAPE, "als_cp_sparse", 3, 3, True)
    del st
    torch.cuda.empty_cache()
    return off


def median_cache_build_ms(stats):
    return 1e3 * stats.get("sparse.pp_cache_build",
                           (0, 0.0, float("nan")))[2]


def check_same_rows(label, a, b, columns):
    """Raise unless rows ``a`` and ``b`` hold the same values in
    ``columns`` (indices or keys), row for row."""
    if len(a) != len(b) or any(x[c] != y[c] for x, y in zip(a, b)
                               for c in columns):
        raise AssertionError(f"{label}: the two runs differ")
    print(f"{label}: {len(a)} rows identical in {list(columns)}")


def run_sparse_repeat(off_stats):
    """Phase 6c: sparse PP with the kernels repeats bit for bit. The
    fixture's caches through K7 against the kernel-off route (rel
    REL_TOL) and across two builds; two fixture runs of sparse PP, 20
    sweeps, every sweep logged, from one seed; two Poisson CLI runs."""
    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops import sparse
    st = sparse_fixture()
    Ws = cp.init_factors(SPARSE_SHAPE, 10, seed=0, device="cuda")
    with config.override(use_kernels=False):
        want = sparse.build_pp_caches(st, Ws)
    got, again = sparse.build_pp_caches(st, Ws), sparse.build_pp_caches(st, Ws)
    for g, a, w in zip(got, again, want):
        for k in w:
            if not torch.equal(g[k], a[k]):
                raise AssertionError(f"cache {k}: two K7 builds differ")
            held_to_plain(f"cache {k}", g[k], w[k])
    print(f"PP caches at the fixture: {len(want[0])} singles and "
          f"{len(want[1])} pairs within {REL_TOL} of the kernel-off route, "
          "two K7 builds bit for bit equal")
    del got, again, want
    off_ms = median_cache_build_ms(off_stats)
    runs = []
    for k in range(2):
        stats, res = run_sparse(st, SPARSE_SHAPE, "als_cp_pp_sparse", 20, 1,
                                True, beside=off_stats)
        n_pp = sum(1 for h in res.history if h["pp"] == 1)
        print(f"fixture run {k + 1}: {n_pp} PP rows, cache build median "
              f"{median_cache_build_ms(stats):.3f} ms (6b kernel off: "
              f"{off_ms:.3f} ms)")
        if n_pp == 0:
            raise AssertionError(f"fixture run {k + 1} has no PP rows")
        runs.append(res.history)
    check_same_rows("sparse PP at the fixture", *runs,
                    ("iter", "gradnorm", "diffV", "pp"))
    del st
    torch.cuda.empty_cache()
    csvs = []
    for k in range(2):
        _, rows, stats = run_sparse_cli()
        n_pp = sum(1 for r in rows[1:] if float(r[4]) == 1)
        print(f"Poisson CLI run {k + 1}: {n_pp} PP rows, cache build median "
              f"{median_cache_build_ms(stats):.3f} ms")
        csvs.append(rows)
    dtime = csvs[0][0].index("[dtime]")
    check_same_rows("Poisson CLI CSV", *csvs,
                    [c for c in range(len(csvs[0][0])) if c != dtime])


TUCKER_HEADER = "[dim],[iter],[diffnorm],[tol],[pp_update],[diffV],[dtime]"
TUCKER_PHASES = ("tucker.hosvd", "tucker.dt_sweep", "tucker.pp_cache_build",
                 "tucker.pp_sweep", "tucker.diagnostics")
# The reference's Tucker rank vectors of coil-100 (o1) and time-lapse (o2)
# (test_ALS.cxx:366-380, as bench.py uses them). Time-lapse keeps its own
# mode order here: the port does not permute modes for the TPU's tiling.
COIL_TUCKER_RANKS = (3, 10, 10, 70)
TIMELAPSE_SHAPE, TIMELAPSE_RANKS = (33, 1344, 1024, 9), (10, 100, 100, 5)
# The CLI's 200^3 rank-10 runs (test_als -tensor r2, -pp_res_tol 0.3):
# r2's fit leaves a residual the float32 norm identity resolves. -tol 0
# asks for every sweep, but the reference's convergence test (diffnorm
# <= tol) still ends a run whose diffnorm reaches exactly 0.0, which a
# float32 run can; in float64 the r2 run takes all 20 sweeps, with PP
# phases between DT phases.
TUCKER_MAXITER = 20
TUCKER_CLI = ["test_als", "-model", "Tucker", "-dim", "3", "-size", "200",
              "-rank", "10", "-maxiter", str(TUCKER_MAXITER), "-resprint",
              "1", "-pp_res_tol", "0.3", "-tol", "0"]
TUCKER_BENCH_ARGS = ["pp_bench", "-model", "Tucker", "-tensor", "r", "-dim",
                     "3", "-size", "512", "-rank", "10", "-maxiter", "3"]
# Relative margins of float64 comparisons of two fits. A reconstruction
# residual (direct_residual) is resolved to ~1e-12 of itself at the coil
# shape. The CSV's diffV = sqrt(||V||^2 - ||core||^2) is resolved to ~1e-11
# of itself at 200^3 (tensor c's float64 rows spread by 1e-11), but only
# to ~1e-9 at the coil shape, whose ||V||^2 sums 354M terms.
F64_RECON_MARGIN, F64_DIFFV_MARGIN = 1e-11, 1e-10
# float32 against float64 Tucker-PP at the coil shape: the largest
# principal angle between the factor subspaces (sin) and the residuals'
# relative difference, both by float64 arithmetic.
F32_SUBSPACE_TOL, F32_RESIDUAL_TOL = 1e-4, 1e-6


def check_tucker_csv(rows, label, pp, fit=True, margin=0.0):
    """Body rows of a Tucker CSV: the reference header, finite values, PP
    rows present exactly when ``pp`` (unchecked when None) and, with
    ``fit``, a diffV at the last row no larger than at the first, times
    (1 + ``margin``); prints a summary line."""
    if ",".join(rows[0]) != TUCKER_HEADER:
        raise AssertionError(f"{label}: CSV header {rows[0]}")
    body = [[float(x) for x in r] for r in rows[1:]]
    if not body or not all(math.isfinite(x) for r in body for x in r):
        raise AssertionError(f"{label}: CSV is empty or holds non-finite "
                             "values")
    n_pp = sum(1 for r in body if r[4] == 1)
    diffV = [r[5] for r in body]
    print(f"{label}: {len(body)} rows (last iter {body[-1][1]:g}), {n_pp} "
          f"PP rows in {pp_phases(body)} PP phases, diffV {diffV[0]!r} -> "
          f"{diffV[-1]!r} (min {min(diffV)!r}, max {max(diffV)!r})")
    if pp is not None and bool(n_pp) != pp:
        raise AssertionError(f"{label}: {n_pp} PP rows")
    if fit and not diffV[-1] <= diffV[0] * (1.0 + margin):
        raise AssertionError(f"{label}: diffV rose")
    return body


def pp_phases(body):
    """The number of PP phases in a Tucker CSV's body: runs of PP rows."""
    flags = [0] + [int(r[4]) for r in body]
    return sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1))


def direct_residual(V, Ws):
    """||V - core x_i W_i|| with core = TTMc(V, W), by reconstruction in
    float64 (V and the factors upcast): no cancellation, unlike the
    diagnostics' norm identity, and no float32 rounding."""
    import torch
    from pairwise_perturbation_tpu_torch.ops import contract
    V = V.double()
    Ws = [W.double() for W in Ws]
    core = contract.ttmc(V, Ws)
    return float(torch.linalg.vector_norm(
        V - contract.ttmc(core, Ws, transpose=True)))


def subspace_sin(A, B):
    """The sine of the largest principal angle between the column spaces
    of two factors, in float64: the norm of B's part outside A's span (A
    re-orthonormalized, so a float32 factor's own rounding enters once,
    not under a square root)."""
    import torch
    Q = torch.linalg.qr(A.double())[0]
    B = B.double()
    return float(torch.linalg.matrix_norm(B - Q @ (Q.T @ B), ord=2))


def start_tucker_trace():
    """Reset the tracing scopes, the kernels' launch counts and the peak
    memory, and turn the scopes on."""
    import torch
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    tracing.reset()
    _bench.reset_launch_counts()
    tracing.enable()
    torch.cuda.reset_peak_memory_stats()


def tucker_report(label, smi, medians=None, names=TUCKER_PHASES):
    """Print the scope medians (``names``) of the run traced since
    start_tucker_trace (or ``medians``, {name: s}), its peak memory
    beside the card's name and power limit, and fail if any port kernel
    launched: the Tucker path reaches no kernel, in either package."""
    import torch
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    tracing.enable(False)
    calls = {}
    if medians is None:
        stats = tracing.stats()
        medians = {n: stats[n][2] for n in names if n in stats}
        calls = {n: tracing.samples(n) for n in medians}

    def few(n):
        # a median of up to 4 calls: the calls themselves
        t = calls.get(n, ())
        return " (calls " + ", ".join(f"{1e3 * x:.3f}" for x in t) + ")" \
            if 0 < len(t) <= 4 else ""

    print(f"  {label} ({smi}), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, medians: "
          + "; ".join(f"{n} {1e3 * t:.3f} ms{few(n)}"
                      for n, t in medians.items()))
    launched = {k: n for k, n in _bench.launch_counts().items() if n}
    print(f"  port kernel launches: {launched or 'none'}")
    if launched:
        raise AssertionError(f"{label}: a port kernel launched on the "
                             "Tucker path")
    return medians


def low_tucker_rank_tensor(shape, ranks, seed, noise=0.01):
    """A seeded core times orthonormal factors on the card, plus Gaussian
    noise of ``noise`` times the tensor's RMS (as the JAX package's
    test_tucker_pp_runs_and_matches_dt builds its tensor)."""
    import torch
    from pairwise_perturbation_tpu_torch.ops import contract
    gen = torch.Generator(device="cuda").manual_seed(seed)
    core = torch.randn(ranks, generator=gen, device="cuda")
    Ws = [torch.linalg.qr(torch.randn((s, r), generator=gen,
                                      device="cuda"))[0]
          for s, r in zip(shape, ranks)]
    V = contract.ttmc(core, Ws, transpose=True)
    scale = noise * float(torch.linalg.vector_norm(V)) / math.sqrt(V.numel())
    V.add_(torch.randn(shape, generator=gen, device="cuda").mul_(scale))
    return V


def timed_dt_sweeps(V, Ws, ranks, iters, n=10):
    """bench.py's Tucker DT timing (bench.py:442-470): one untimed sweep,
    then ``n`` chained sweeps (the factors their own sign references)
    under the tucker.dt_sweep scope. Returns (median s, factors)."""
    import statistics as st
    from pairwise_perturbation_tpu_torch.models import tucker
    from pairwise_perturbation_tpu_torch.utils import tracing
    Ws, _ = tucker.tucker_dt_sweep(V, list(Ws), list(Ws), ranks=ranks,
                                   use_sign=True, subspace_iters=iters)
    before = len(tracing.samples("tucker.dt_sweep"))
    for _ in range(n):
        Ws, _ = tracing.timed("tucker.dt_sweep", tucker.tucker_dt_sweep, V,
                              Ws, Ws, ranks=ranks, use_sign=True,
                              subspace_iters=iters)
    return st.median(tracing.samples("tucker.dt_sweep")[before:]), Ws


def run_tucker_coil(smi):
    """Phase 9a: Tucker at the coil-100 shape with its rank vector, on a
    seeded low-Tucker-rank tensor plus 1% noise. HOSVD three times (mode
    3, 7200 > HOSVD_EXACT_EIGH_MAX, on the randomized branch); Tucker-PP
    (pp_res_tol 0.1, AUTO extraction, 20 sweeps) with its CSV checked and
    its fit held by a float64 reconstruction, V in f64, f32 and stored in
    bf16, the f32 run held to the f64 run; then bench.py's timings: 10 DT
    sweeps at subspace_iters 0, 2 and AUTO, 5 cache builds and 10 PP
    sweeps from one build (exact and AUTO extraction). Returns {label:
    median s}."""
    import torch
    from pairwise_perturbation_tpu_torch.models import tucker
    from pairwise_perturbation_tpu_torch.utils import tracing
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile
    ranks = COIL_TUCKER_RANKS
    V = low_tucker_rank_tensor(COIL_SHAPE, ranks, seed=15)
    vn = float(torch.linalg.vector_norm(V))
    start_tucker_trace()
    for _ in range(3):
        core, Ws = tracing.timed("tucker.hosvd", tucker.hosvd, V, ranks)
    rel = math.sqrt(max(vn ** 2 - float(torch.linalg.vector_norm(core)) ** 2,
                        0.0)) / vn
    print(f"hosvd {COIL_SHAPE} ranks {ranks}: relative residual {rel:.4e} "
          "(1% noise); calls, ms: " + ", ".join(
              f"{1e3 * t:.3f}" for t in tracing.samples("tucker.hosvd")))
    if not rel < 0.05:
        raise AssertionError("HOSVD missed the tensor's Tucker subspace")
    out = {"coil hosvd": tucker_report("9a hosvd", smi)["tucker.hosvd"]}
    factors, resid = {}, {}
    for dtype in ("float64", "float32", "bfloat16"):
        label = f"9a Tucker-PP coil {dtype} V"
        Vd = V.to(getattr(torch, dtype))
        start_tucker_trace()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "tucker_coil.csv")
            plot = PlotFile(path, PlotFile.TUCKER_HEADER, echo=False)
            t0 = time.perf_counter()
            try:
                res = tucker.als_tucker_pp(
                    Vd, ranks, tucker.TuckerConfig(tol=0.0, pp_res_tol=0.1,
                                                   maxiter=20, resprint=1),
                    plot)
                torch.cuda.synchronize()
            finally:
                plot.close()
            wall = time.perf_counter() - t0
            with open(path) as fh:
                rows = list(csv.reader(fh))
        print(f"{label}: {res.iters} sweeps in {wall:.3f} s")
        # HOSVD fits this tensor to its noise: the sweeps gain ~4e-6 of
        # the residual from a float32 HOSVD and ~1e-9 from a float64 one.
        # No CSV resolves that (float32's norm identity moves diffV by 1e-1,
        # float64's by ~1e-9 here, bf16's clamps to 0), so every run's fit
        # is held by a float64 reconstruction instead: the run's factors
        # fit no worse than HOSVD's, up to F64_RECON_MARGIN.
        check_tucker_csv(rows, label, pp=True, fit=False)
        start = direct_residual(Vd, tucker.hosvd(Vd, ranks)[1])
        end = direct_residual(Vd, res.factors)
        print(f"{label}: ||V - V^|| by float64 reconstruction {start!r} "
              f"(HOSVD) -> {end!r}; the CSV's last diffV {res.diffV!r}")
        if not end <= start * (1.0 + F64_RECON_MARGIN):
            raise AssertionError(f"{label}: the fit got worse")
        meds = tucker_report(label, smi)
        out.update({f"coil PP run {dtype}: {n}": t for n, t in meds.items()})
        factors[dtype], resid[dtype] = res.factors, end
        del Vd
    # the float32 run against the float64 run on the same tensor: the same
    # factor subspaces and the same residual, to the stated tolerances
    sins = [subspace_sin(a, b) for a, b in zip(factors["float32"],
                                                factors["float64"])]
    r32 = resid["float32"]
    rel = abs(r32 - resid["float64"]) / resid["float64"]
    print(f"9a coil float32 vs float64 Tucker-PP: largest principal angle "
          f"sines by mode {', '.join(f'{x:.3e}' for x in sins)} (tol "
          f"{F32_SUBSPACE_TOL:g}); residuals {r32!r} vs {resid['float64']!r}"
          f", relative {rel:.3e} (tol {F32_RESIDUAL_TOL:g})")
    if max(sins) > F32_SUBSPACE_TOL or rel > F32_RESIDUAL_TOL:
        raise AssertionError("9a: float32 Tucker-PP left the float64 fit")
    del factors
    start_tucker_trace()
    meds = {}
    for iters in (0, 2, -1):
        meds[f"tucker.dt_sweep subspace_iters={iters}"], Wt = \
            timed_dt_sweeps(V, Ws, ranks, iters)
        if iters == 0:
            Wdt = Wt
    for _ in range(5):
        single, pair = tracing.timed("tucker.pp_cache_build",
                                     tucker.tucker_build_caches, V, Wdt)
    meds["tucker.pp_cache_build"] = statistics.median(
        tracing.samples("tucker.pp_cache_build"))
    zeros = [torch.zeros_like(w) for w in Wdt]
    for iters in (0, -1):
        cur, dc, _, _ = tucker.tucker_pp_sweep(single, pair, list(Wdt), Wdt,
                                               zeros, ranks=ranks,
                                               subspace_iters=iters)
        before = len(tracing.samples("tucker.pp_sweep"))
        for _ in range(10):
            cur, dc, _, _ = tracing.timed(
                "tucker.pp_sweep", tucker.tucker_pp_sweep, single, pair, cur,
                Wdt, dc, ranks=ranks, subspace_iters=iters)
        meds[f"tucker.pp_sweep subspace_iters={iters}"] = statistics.median(
            tracing.samples("tucker.pp_sweep")[before:])
    out.update({f"coil {n}": t for n, t in meds.items()})
    tucker_report("9a coil sweeps (10 each; 5 cache builds)", smi, meds)
    return out


def run_tucker_timelapse(smi):
    """Phase 9b: time-lapse's shape (33, 1344, 1024, 9) and rank vector,
    in the port's mode order (no TPU layout permutation), on bench.py's
    uniform x 255 tensor: HOSVD, then 10 DT sweeps under AUTO (bench.py's
    timelapse_tucker_dt_sweep_seconds_auto) and 10 with exact eigh.
    Returns {label: median s}."""
    import torch
    from pairwise_perturbation_tpu_torch.models import tucker
    from pairwise_perturbation_tpu_torch.utils import tracing
    gen = torch.Generator(device="cuda").manual_seed(7)
    V = torch.rand(TIMELAPSE_SHAPE, generator=gen, device="cuda").mul_(255.0)
    start_tucker_trace()
    core, Ws = tracing.timed("tucker.hosvd", tucker.hosvd, V,
                             TIMELAPSE_RANKS)
    meds = {"tucker.hosvd": tracing.samples("tucker.hosvd")[0]}
    for iters in (-1, 0):
        meds[f"tucker.dt_sweep subspace_iters={iters}"], _ = \
            timed_dt_sweeps(V, Ws, TIMELAPSE_RANKS, iters)
    tucker_report(f"9b time-lapse {TIMELAPSE_SHAPE} ranks {TIMELAPSE_RANKS}"
                  " (one HOSVD, 10 sweeps each)", smi, meds)
    return {f"time-lapse {n}": t for n, t in meds.items()}


def run_tucker_cli(smi):
    """Phase 9c: test_als -model Tucker through the CLI at 200^3 rank 10:
    tensor r2 at -pp 0 and -pp 1 in float32 and at -pp 1 in float64 (all
    20 sweeps, at least two PP phases), tensor c at -pp 1 in float32 and
    float64 (HOSVD fits c: its float64 diffV stays flat, so the float32
    run's moves are the norm identity's resolution); CSVs checked.
    pp_bench -model Tucker at 512^3 rank 10, maxiter 3: its header, row
    kinds and medians. Returns {label: median s}."""
    from pairwise_perturbation_tpu_torch import cli
    out = {}
    for tensor, pp, dtype in (("r2", 0, "float32"), ("r2", 1, "float32"),
                              ("r2", 1, "float64"), ("c", 1, "float32"),
                              ("c", 1, "float64")):
        label = (f"9c CLI test_als -model Tucker -tensor {tensor} -pp {pp} "
                 f"200^3 rank 10 {dtype}")
        start_tucker_trace()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "tucker_200.csv")
            rc = cli.main(TUCKER_CLI + ["-tensor", tensor, "-pp", str(pp),
                                        "-dtype", dtype, "-profile", "1",
                                        "-quiet", "-filename", path])
            with open(path) as fh:
                rows = list(csv.reader(fh))
        if rc != 0:
            raise AssertionError(f"{label}: cli.main returned {rc}")
        # tensor c in float32: the diffV rule is not resolved (see above)
        body = check_tucker_csv(rows, label, pp=bool(pp),
                                fit=(tensor, dtype) != ("c", "float32"),
                                margin=F64_DIFFV_MARGIN if dtype == "float64"
                                else 0.0)
        full = body[-1][1] == TUCKER_MAXITER
        if (tensor, dtype) == ("r2", "float64") and not (
                full and pp_phases(body) >= 2):
            raise AssertionError(f"{label}: {len(body)} rows, "
                                 f"{pp_phases(body)} PP phases")
        if not full and body[-1][2] != 0.0:
            raise AssertionError(f"{label}: ended at iter {body[-1][1]:g} "
                                 f"with diffnorm {body[-1][2]!r}")
        meds = tucker_report(label, smi)
        out.update({f"CLI {tensor} -pp {pp} {dtype}: {n}": t
                    for n, t in meds.items()})
    start_tucker_trace()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "tucker_bench.csv")
        rc = cli.main(TUCKER_BENCH_ARGS + ["-quiet", "-filename", path])
        with open(path) as fh:
            rows = list(csv.reader(fh))
    kinds = [r[0] for r in rows[1:]]
    times = [float(r[1]) for r in rows[1:]]
    if rc != 0 or rows[0] != ["[timetype]", "[dtime]"] or kinds != (
            ["[DTtime]"] * 3 + ["[PPfirst]", "[PPsecond]"] * 3) or not all(
                math.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"pp_bench -model Tucker: rc {rc}, header "
                             f"{rows[0]}, rows {kinds}, times {times}")
    meds = {k: statistics.median(t for kind, t in zip(kinds, times)
                                 if kind == f"[{k}]") for k in BENCH_KINDS}
    tucker_report("9c pp_bench -model Tucker 512^3 rank 10 (3 rows each)",
                  smi, meds)
    out.update({f"pp_bench 512^3 [{k}]": t for k, t in meds.items()})
    return out


SPARSE_TUCKER_PHASES = ("sparse_tucker.hosvd", "sparse_tucker.sweep",
                        "sparse_tucker.pp_cache_build",
                        "sparse_tucker.pp_sweep", "sparse_tucker.diagnostics")
# Phase 6's folded Poisson tensor (100^4). Its multilinear rank is 2 in
# every mode, so it is fitted at rank 1 (from rank 2 the fit is exact and
# diffV is round-off).
SPARSE_TUCKER_CLI = ["test_als", "-model", "Tucker", "-issparse", "1", "-pp",
                     "1", "-tensor", "p", "-dim", "8", "-size", "10",
                     "-rank", "1", "-maxiter", "20", "-resprint", "1",
                     "-pp_res_tol", "0.1", "-tol", "0"]


def run_sparse_tucker_cli(smi):
    """Phase 9d: test_als -model Tucker -issparse 1 -pp 1 on the Poisson
    100^4 tensor at rank 1 through the CLI, in float32 and float64, CSVs
    checked (the diffV rule in float64 only: the sweeps improve HOSVD's
    fit by ~1e-4, about the float32 norm identity's resolution). Returns
    {label: median s}."""
    from pairwise_perturbation_tpu_torch import cli
    out = {}
    for dtype in ("float32", "float64"):
        label = f"9d CLI sparse Tucker -pp 1 Poisson 100^4 rank 1 {dtype}"
        start_tucker_trace()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sparse_tucker.csv")
            rc = cli.main(SPARSE_TUCKER_CLI + ["-dtype", dtype, "-profile",
                                               "1", "-quiet", "-filename",
                                               path])
            with open(path) as fh:
                rows = list(csv.reader(fh))
        if rc != 0:
            raise AssertionError(f"{label}: cli.main returned {rc}")
        check_tucker_csv(rows, label, pp=True, fit=dtype == "float64",
                         margin=F64_DIFFV_MARGIN)
        meds = tucker_report(label, smi, names=SPARSE_TUCKER_PHASES)
        out.update({f"sparse CLI {dtype}: {n}": t for n, t in meds.items()})
    return out


# Sparse Tucker at a real rank: phase 6b's sparse200_4_nnz1.6M tensor
# (uniform nonzeros, no low multilinear rank) at rank 10 in every mode.
# Its factors keep drifting, so pp_res_tol 0.3: at 0.1 a run of 20 sweeps
# at this density may never enter PP.
SPARSE_TUCKER_RANK, SPARSE_TUCKER_PP_RES_TOL = 10, 0.3


def run_sparse_tucker_fixture(smi):
    """Phase 9d at rank 10: sparse Tucker-PP (als_tucker_pp_sparse, 20
    sweeps) on phase 6b's fixture in float32 and float64, CSVs checked
    (finite, diffV falling: at this residual the norm identity resolves
    the fit in both; PP rows printed, not required); then, from the
    float32 run's factors, 5 cache builds and 10 PP sweeps from one build,
    timed. Returns {label: median s}."""
    import torch
    from pairwise_perturbation_tpu_torch.models import sparse_tucker, tucker
    from pairwise_perturbation_tpu_torch.ops import sparse
    from pairwise_perturbation_tpu_torch.utils import tracing
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile
    ranks = (SPARSE_TUCKER_RANK,) * len(SPARSE_SHAPE)
    gen = torch.Generator(device="cuda").manual_seed(3)
    st32, _ = random_coo(SPARSE_SHAPE, SPARSE_NNZ, 1, gen, seed=0)
    name = f"sparse200_4_nnz1.6M rank {SPARSE_TUCKER_RANK}"
    out, Ws = {}, None
    for dtype in ("float32", "float64"):
        label = f"9d sparse Tucker-PP {name} {dtype}"
        st = sparse.SparseTensor(st32.indices,
                                 st32.values.to(getattr(torch, dtype)),
                                 st32.shape)
        start_tucker_trace()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sparse_tucker_fixture.csv")
            plot = PlotFile(path, PlotFile.TUCKER_HEADER, echo=False)
            t0 = time.perf_counter()
            try:
                res = sparse_tucker.als_tucker_pp_sparse(
                    st, ranks, tucker.TuckerConfig(
                        tol=0.0, pp_res_tol=SPARSE_TUCKER_PP_RES_TOL,
                        maxiter=20, resprint=1), plot)
                torch.cuda.synchronize()
            finally:
                plot.close()
            wall = time.perf_counter() - t0
            with open(path) as fh:
                rows = list(csv.reader(fh))
        print(f"{label}: {res.iters} sweeps in {wall:.3f} s")
        check_tucker_csv(rows, label, pp=None, margin=F64_DIFFV_MARGIN
                         if dtype == "float64" else 0.0)
        meds = tucker_report(label, smi, names=SPARSE_TUCKER_PHASES)
        out.update({f"sparse {name} {dtype}: {n}": t
                    for n, t in meds.items()})
        Ws = Ws or res.factors
        del st
    start_tucker_trace()
    for _ in range(5):
        single, pair = tracing.timed(
            "sparse_tucker.pp_cache_build",
            sparse_tucker.sparse_tucker_build_caches, st32, Ws)
    cur, dc, _, _ = tucker.tucker_pp_sweep(
        single, pair, list(Ws), Ws, [torch.zeros_like(w) for w in Ws],
        ranks=ranks, subspace_iters=0)
    for _ in range(10):
        cur, dc, _, _ = tracing.timed(
            "sparse_tucker.pp_sweep", tucker.tucker_pp_sweep, single, pair,
            cur, Ws, dc, ranks=ranks, subspace_iters=0)
    meds = tucker_report(f"9d {name} float32 (5 cache builds, 10 PP sweeps "
                         "from one)", smi, names=SPARSE_TUCKER_PHASES)
    out.update({f"sparse {name} timed: {n}": t for n, t in meds.items()})
    return out


def run_tucker(smi):
    """Phase 9 (9a-9d); prints every median it measured on one line."""
    meds = {}
    phase("9a. Tucker at the coil-100 shape, ranks (3, 10, 10, 70): HOSVD, "
          "Tucker-PP f64, f32 and bf16 V, timed DT and PP sweeps")
    meds.update(run_tucker_coil(smi))
    phase("9b. Tucker at time-lapse's shape (33, 1344, 1024, 9), ranks "
          "(10, 100, 100, 5), natural mode order: timed DT sweeps")
    meds.update(run_tucker_timelapse(smi))
    phase("9c. CLI test_als -model Tucker at 200^3 (r2 -pp 0, -pp 1, -pp 1 "
          "f64; c -pp 1 f32, f64), pp_bench -model Tucker at 512^3")
    meds.update(run_tucker_cli(smi))
    phase("9d. sparse CLI test_als -model Tucker -issparse 1 -pp 1, "
          "Poisson 100^4 rank 1, f32 and f64; sparse Tucker-PP on "
          "sparse200_4_nnz1.6M at rank 10, f32 and f64, timed")
    meds.update(run_sparse_tucker_cli(smi))
    meds.update(run_sparse_tucker_fixture(smi))
    print(f"Tucker medians, ms ({smi}): " + "; ".join(
        f"{k} {1e3 * t:.3f}" for k, t in meds.items()))


# ---------------------------------------------------------------------------
# Phase 10: run -issparse 1, the dataset loaders, checkpoints, device traces
# ---------------------------------------------------------------------------

# Rank 4: the folded Poisson tensor's mode unfoldings have a small rank,
# so at rank 8 or more the factors' Grams go singular after one step and
# the Cholesky-based optimizers give NaN from the second row on, in the
# JAX package as in the port (f32 and f64); at rank 5 MSDT-LR's gradnorm
# rises over 6 sweeps. Phase 10b runs rank 10 on the fixture.
RUN_SPARSE_P = ["run", "-tensor", "p", "-dim", "8", "-size", "10", "-rank",
                "4", "-issparse", "1"]
# One seeded uniform [0, 1) float64 binary in each dataset's file shape
# (utils/io.py): coil-100 (o1, 2.83 GB) and time-lapse (o2, 3.27 GB).
O1_FILE_SHAPE = (7200, 128, 128, 3)
O2_FILE_SHAPE = (9, 1024, 1344, 33)


def k7_expected(steps, rows, simple, order=4):
    """K7 launches of a ``run`` on a float32 COO tensor: ``order`` a
    Simple step (sparse_simple_sweep's MTTKRPs), none in a DT, MSDT or LR
    step (their chain tops are index_add_), order + 1 a diagnostics
    row."""
    return order * steps * simple + (order + 1) * rows


def run_sparse_optimizers_cli():
    """10a: ``run -issparse 1`` through cli.main on phase 6's Poisson
    100^4 tensor (82,000 nonzeros), rank 4, f32: -pp 0 to 4, then -pp 1
    -device_loop 1; every CSV checked and K7's launches counted. Returns
    (K7 launches, {label: (scope, median s)})."""
    from pairwise_perturbation_tpu_torch import cli
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    from pairwise_perturbation_tpu_torch.utils import tracing
    total, medians = 0, {}
    runs = [(pp, []) for pp in range(5)] + [(1, ["-device_loop", "1"])]
    for pp, extra in runs:
        label = (f"run -issparse 1 -pp {pp} ({cli.RUN_OPTIMIZERS[pp]}) "
                 + " ".join(extra)).strip()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "run_sparse.csv")
            tracing.reset()
            coo_mttkrp.reset_launch_counts()
            rc = cli.main(RUN_SPARSE_P + ["-pp", str(pp), "-maxiter", "6",
                                          "-resprint", "2", "-profile", "1",
                                          "-quiet", "-filename", out, *extra])
            launches = coo_mttkrp.LAUNCHES["coo_mttkrp"]
            with open(out) as fh:
                rows = list(csv.reader(fh))
        tracing.enable(False)
        if rc != 0:
            raise AssertionError(f"{label}: cli.main returned {rc}")
        check_run_csv(rows, label)
        stats = tracing.stats()
        name, steps, med = step_scope(stats)
        n_rows = stats["cp.diagnostics"][0]
        want = k7_expected(steps, n_rows, pp == 4)
        print(f"  {name} {steps} calls, median {1e3 * med:.3f} ms; "
              f"{n_rows} diagnostics rows; K7 launches {launches} "
              f"(expected {want})")
        if launches != want or n_rows != len(rows) - 1:
            raise AssertionError(f"{label}: K7 launches differ from 4 a "
                                 "Simple step and 5 a diagnostics row")
        total += launches
        medians[f"Poisson 100^4 {label[len('run -issparse 1 '):]}"] = \
            (name, med)
    return total, medians


def first_steps(st, Ws, use_kernels, n=3):
    """The factors after each of Simple's first ``n`` steps on ``st`` from
    ``Ws``, with config.use_kernels as given."""
    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import optimizers as opt
    o = opt.CPSimpleOptimizer(st.ndim, Ws[0].shape[1])
    o.configure(st, [w.clone() for w in Ws], 0.0)
    out = []
    with config.override(use_kernels=use_kernels):
        for _ in range(n):
            o.step()
            out.append([w.clone() for w in o.W])
    torch.cuda.synchronize()
    return out


def run_sparse_optimizers_fixture():
    """10b: cli.run_cpd (the body of ``run``) on phase 6b's
    sparse200_4_nnz1.6M tensor, rank 10, f32, all five optimizers, each
    step's median (``<Optimizer>.step`` scopes) and peak memory printed;
    Simple with use_kernels on and off, whose first three steps' factors
    agree with the same steps in float64: to REL_TOL with K7, to 10
    REL_TOL with the float32 index_add_. Returns (K7 launches, {label:
    (scope, median s)})."""
    import torch
    from pairwise_perturbation_tpu_torch import cli, config
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops import sparse
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    from pairwise_perturbation_tpu_torch.utils import tracing
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile
    st = sparse_fixture()
    W0 = cp.init_factors(SPARSE_SHAPE, 10, seed=0, device="cuda")
    # Both float32 routes against the same steps in float64: a float32
    # index_add_ sums ~8,000 nonzeros into each row in arbitrary order and
    # ends ~2e-4 off (on an H100, 1.6-2.7e-4 against K7's 0.9-1.2e-5), so
    # the two routes are held to float64, not to each other.
    ref = first_steps(sparse.SparseTensor(st.indices, st.values.double(),
                                          st.shape),
                      [w.double() for w in W0], False)
    for use_kernels in (True, False):
        for k, (a, b) in enumerate(zip(first_steps(st, W0, use_kernels),
                                       ref)):
            rel = max(float((x.double() - y).abs().max() / y.abs().max())
                      for x, y in zip(a, b))
            route = "K7" if use_kernels else "index_add_"
            print(f"Simple step {k + 1} with {route}: factors rel {rel:.3e}"
                  " to the float64 steps")
            if not rel <= (REL_TOL if use_kernels else 10 * REL_TOL):
                raise AssertionError(f"Simple's steps with {route} differ "
                                     "from the float64 steps")
    total, medians = 0, {}
    runs = [(pp, True) for pp in range(4)] + [(4, True), (4, False)]
    for pp, use_kernels in runs:
        label = (f"sparse200_4 {cli.RUN_OPTIMIZERS[pp]}"
                 + ("" if use_kernels else " use_kernels=False"))
        tracing.reset()
        coo_mttkrp.reset_launch_counts()
        tracing.enable()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "run_fixture.csv")
            plot = PlotFile(out, echo=False)
            try:
                with config.override(use_kernels=use_kernels):
                    cli.run_cpd(st, [w.clone() for w in W0], pp, tol=0.0,
                                maxiter=4, resprint=100, plot=plot)
                torch.cuda.synchronize()
            finally:
                plot.close()
                tracing.enable(False)
            with open(out) as fh:
                rows = list(csv.reader(fh))
        check_run_csv(rows, label)
        stats = tracing.stats()
        name, steps, med = step_scope(stats)
        launches = coo_mttkrp.LAUNCHES["coo_mttkrp"]
        want = k7_expected(steps, stats["cp.diagnostics"][0], pp == 4) \
            if use_kernels else 0
        print(f"  {name} {steps} calls, median {1e3 * med:.3f} ms; K7 "
              f"launches {launches} (expected {want}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if launches != want:
            raise AssertionError(f"{label}: K7 launches differ")
        total += launches
        medians[label] = (name, med)
    del st
    torch.cuda.empty_cache()
    return total, medians


def seeded_binary(path, file_shape, seed):
    """Write a seeded uniform [0, 1) float64 array of ``file_shape`` with
    the port's write_dense_binary, after printing the free space there;
    returns the array on the card."""
    import shutil
    import torch
    from pairwise_perturbation_tpu_torch.utils import io
    nbytes = 8 * math.prod(file_shape)
    free = shutil.disk_usage(os.path.dirname(path)).free
    print(f"{path}: {nbytes / 1e9:.2f} GB to write, {free / 1e9:.1f} GB "
          "free there")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    arr = torch.rand(file_shape, generator=gen, device="cuda",
                     dtype=torch.float64)
    t0 = time.perf_counter()
    io.write_dense_binary(path, arr.cpu().numpy())
    print(f"  written in {time.perf_counter() - t0:.3f} s")
    return arr


def cli_csv(argv, out):
    """cli.main on ``argv`` with -quiet and -filename ``out``; returns the
    CSV rows."""
    from pairwise_perturbation_tpu_torch import cli
    rc = cli.main(argv + ["-quiet", "-filename", out])
    if rc != 0:
        raise AssertionError(f"{' '.join(argv)}: cli.main returned {rc}")
    with open(out) as fh:
        return list(csv.reader(fh))


def run_o1(tmp):
    """10c: test_als -tensor o1 on a seeded coil-100-shaped binary: the
    loader's axes, CP-PP with -checkpoint under use_kernels_triple (K6
    once a cache build), then -resume from that checkpoint. Returns (K6
    launches, {label: seconds})."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch import config, native
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops import contract
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import io, tracing
    path = os.path.join(tmp, "coil-100.bin")
    arr = seeded_binary(path, O1_FILE_SHAPE, seed=10)
    t0 = time.perf_counter()
    V = io.load_coil100(path)
    load_s = time.perf_counter() - t0
    Vd = torch.from_numpy(V).cuda()
    if V.shape != COIL_SHAPE or not torch.equal(
            Vd, arr.permute(3, 2, 1, 0).float()):
        raise AssertionError("load_coil100 is not the file's array with "
                             "its axes reversed")
    del arr, V
    # its two parts: the file read and conversion, the axis reversal
    t0 = time.perf_counter()
    raw = io.read_dense_binary(path, O1_FILE_SHAPE)
    read_s = time.perf_counter() - t0
    np.ascontiguousarray(raw.transpose(3, 2, 1, 0))
    reverse_s = time.perf_counter() - t0 - read_s
    print(f"load_coil100 (f64 file -> f32, native loader "
          f"{'built' if native.available() else 'absent'}): {load_s:.3f} s "
          f"for {COIL_SHAPE}; read_dense_binary alone {read_s:.3f} s, the "
          f"axis reversal {reverse_s:.3f} s")
    del raw
    ck = os.path.join(tmp, "o1_ck")
    argv = ["test_als", "-model", "CP", "-tensor", "o1", "-tensorfile", path,
            "-rank", "10", "-pp", "1", "-pp_res_tol", "0.1", "-resprint",
            "1", "-profile", "1"]
    tracing.reset()
    _bench.reset_launch_counts()
    with config.override(use_kernels_triple=True), \
            _bench.warm_launches() as warm:
        rows = cli_csv(argv + ["-maxiter", "12", "-checkpoint", ck],
                       os.path.join(tmp, "o1.csv"))
    tracing.enable(False)
    check_csv(rows, "test_als -tensor o1 -pp 1 use_kernels_triple")
    k6 = _bench.launch_counts()["triple_roots.triple_roots"]
    stats = tracing.stats()
    builds = stats.get("cp.pp_cache_build", (0,))[0]
    held_apart("o1 K6", k6, warm.get("triple_roots.triple_roots", 0),
               builds, 1, "in-loop cache builds")
    ckpt = io.load_checkpoint(ck)
    Ws = [torch.from_numpy(f).cuda() for f in ckpt["factors"]]
    if [tuple(w.shape) for w in Ws] != [(s, 10) for s in COIL_SHAPE] or \
            ckpt["meta"] != dict(model="CP", tensor="o1"):
        raise AssertionError(f"o1 checkpoint: {[w.shape for w in Ws]}, "
                             f"{ckpt['meta']}")
    gn, _ = cp.cp_diagnostics(contract.norm_sq(Vd), Vd, Ws, 0.0)
    gn = float(gn)
    del Vd
    torch.cuda.empty_cache()
    resumed = cli_csv(argv + ["-maxiter", "2", "-resume", ck + ".npz"],
                      os.path.join(tmp, "o1_resumed.csv"))
    tracing.enable(False)
    first, last = float(resumed[1][2]), float(rows[-1][2])
    print(f"resumed from iteration {ckpt['iteration']}: first row "
          f"gradnorm {first:.9e}, the checkpoint's factors' {gn:.9e} "
          f"(rel {abs(first - gn) / gn:.3e}); the first run's last row "
          f"(one sweep before the checkpoint) {last:.9e}")
    if not abs(first - gn) <= 1e-5 * gn or resumed[1][1] != "0":
        raise AssertionError("the resumed run does not start from the "
                             "checkpoint's factors")
    os.remove(path)
    return k6, {"o1 load_coil100": load_s, "o1 read_dense_binary": read_s,
                "o1 axis reversal": reverse_s,
                **{f"o1 {n}": stats[n][2] for n in CP_PHASES if n in stats}}


def run_o2(tmp):
    """10d: test_als -model Tucker -tensor o2 -pp 0 on a seeded
    time-lapse-shaped binary, -checkpoint: the factors and core in the
    natural mode order, no kernel launched. Returns {label: seconds}."""
    import torch
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import io, tracing
    path = os.path.join(tmp, "time-lapse.bin")
    seeded_binary(path, O2_FILE_SHAPE, seed=11)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    V = io.load_time_lapse(path)
    load_s = time.perf_counter() - t0
    print(f"load_time_lapse: {load_s:.3f} s, {V.shape}")
    del V
    ck = os.path.join(tmp, "o2_ck")
    tracing.reset()
    before = _bench.launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows = cli_csv(["test_als", "-model", "Tucker", "-tensor", "o2",
                    "-tensorfile", path, "-pp", "0", "-maxiter", "2",
                    "-resprint", "1", "-profile", "1", "-checkpoint", ck],
                   os.path.join(tmp, "o2.csv"))
    tracing.enable(False)
    body = [[float(x) for x in r] for r in rows[1:]]
    if rows[0] != TUCKER_HEADER.split(",") or len(body) < 2 or not all(
            math.isfinite(x) for r in body for x in r):
        raise AssertionError(f"o2 Tucker CSV: {rows}")
    if _bench.launch_counts() != before:
        raise AssertionError("a port kernel launched on the o2 Tucker run")
    ckpt = io.load_checkpoint(ck)
    shapes = [f.shape for f in ckpt["factors"]]
    want = [(33, 10), (1344, 100), (1024, 100), (9, 5)]
    print(f"o2 Tucker checkpoint: factors {shapes}, core "
          f"{ckpt['core'].shape}, meta {ckpt['meta']}; {len(body)} rows, "
          f"diffV {body[0][5]:.6e} -> {body[-1][5]:.6e}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if shapes != want or ckpt["core"].shape != (10, 100, 100, 5) or \
            ckpt["meta"] != dict(model="Tucker", tensor="o2"):
        raise AssertionError("o2 checkpoint not in the natural mode order")
    os.remove(path)
    stats = tracing.stats()
    return {"o2 load_time_lapse": load_s,
            **{f"o2 {n}": stats[n][2] for n in TUCKER_PHASES if n in stats}}


def run_trace(tmp, smi):
    """10e: test_als at 200^3 rank 10 -pp 1 with -profile 1 -trace_dir:
    the trace names mttkrp3.cu's kernels (K1-K3 run in the diagnostics);
    the same run without -profile writes nothing. Returns K1-K3's
    launches {"K1": n, ...}."""
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    from pairwise_perturbation_tpu_torch.utils import tracing
    argv = ["test_als", "-tensor", "r", "-dim", "3", "-size", "200",
            "-rank", "10", "-pp", "1", "-maxiter", "6", "-resprint", "2",
            "-pp_res_tol", "0.1"]
    quiet = os.path.join(tmp, "no_profile")
    cli_csv(argv + ["-trace_dir", quiet], os.path.join(tmp, "t0.csv"))
    if os.path.exists(quiet) and os.listdir(quiet):
        raise AssertionError("-trace_dir without -profile wrote a trace")
    tdir = os.path.join(tmp, "traces")
    mttkrp3.reset_launch_counts()
    t0 = time.perf_counter()
    cli_csv(argv + ["-profile", "1", "-trace_dir", tdir],
            os.path.join(tmp, "t1.csv"))
    wall = time.perf_counter() - t0
    tracing.enable(False)
    launches = {f"K{m + 1}": n for m, n in mttkrp3.LAUNCHES.items()}
    files = os.listdir(tdir)
    if len(files) != 1:
        raise AssertionError(f"-trace_dir holds {files}")
    with open(os.path.join(tdir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    ours = sorted(k for k in kernels if "mttkrp3_" in k)
    print(f"trace {files[0]}: {len(events)} events, "
          f"{os.path.getsize(os.path.join(tdir, files[0])) / 1e6:.1f} MB, "
          f"run {wall:.3f} s ({smi}); {len(kernels)} kernel names, of "
          "mttkrp3.cu: "
          + "; ".join(k[:60] for k in ours) + f"; launches {launches}")
    need = ("mttkrp3_rows_kernel", "mttkrp3_minor_partial_kernel")
    if not all(any(n in k for k in ours) for n in need) or \
            min(launches.values()) <= 0 or not any(
                e.get("name") == "cli.test_als" for e in events):
        raise AssertionError("the trace lacks mttkrp3.cu's kernels or the "
                             "cli.test_als range")
    return launches


def run_phase10(smi):
    """Phase 10 (10a-10e); returns ({kernel id: launches}, medians)."""
    launches, meds = {}, {}
    phase("10a. run -issparse 1 -pp 0..4 and -pp 1 -device_loop 1 on the "
          "Poisson 100^4 tensor, rank 4, f32")
    launches["K7"], m = run_sparse_optimizers_cli()
    meds.update(m)
    phase("10b. cli.run_cpd on sparse200_4_nnz1.6M, rank 10, f32, five "
          "optimizers; Simple with use_kernels on and off")
    n, m = run_sparse_optimizers_fixture()
    launches["K7"] += n
    meds.update(m)
    print(f"run -issparse 1 step medians, ms ({smi}): " + "; ".join(
        f"{label}: {scope} {1e3 * med:.3f}"
        for label, (scope, med) in meds.items()))
    with tempfile.TemporaryDirectory() as tmp:
        phase("10c. test_als -tensor o1 from a seeded coil-100-shaped "
              "binary: load, -pp 1 -checkpoint under use_kernels_triple, "
              "-resume")
        launches["K6"], times = run_o1(tmp)
        phase("10d. test_als -model Tucker -tensor o2 -pp 0 -checkpoint "
              "from a seeded time-lapse-shaped binary")
        times.update(run_o2(tmp))
        print(f"dataset medians, ms ({smi}): " + "; ".join(
            f"{k} {1e3 * t:.3f}" for k, t in times.items()))
        phase("10e. test_als 200^3 -pp 1 -profile 1 -trace_dir: a "
              "torch.profiler trace naming mttkrp3.cu's kernels")
        launches.update(run_trace(tmp, smi))
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the parallel layer's nnz-sharded half, 2 ranks under torchrun
# ---------------------------------------------------------------------------

# One H100: the two ranks share cuda:0 over gloo, which stages every
# all_reduce through the host. Each cluster gets a time limit of its own.
MESH_RANKS = 2
CLUSTER_S = 300
# The sharded engines' runs at the fixture: CP-PP as phase 6b-6c runs it,
# Tucker-PP as phase 9d does (its PP rows printed, not required); 10
# sweeps each, every one logged.
MESH_CP_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=10, resprint=1)
MESH_TK_CFG = dict(tol=0.0, pp_res_tol=SPARSE_TUCKER_PP_RES_TOL, maxiter=10,
                   resprint=1)
# Sharded against one-rank factors after 10 sweeps (relative max-norm for
# CP, the largest principal angle's sine for Tucker): float64 round-off
# grown through the solves, and float32's through 10 sweeps of solves.
MESH_FACTOR_TOL = {"float64": 1e-8, "float32": 1e-3}
# Tucker at rank 10 on uniform nonzeros: the rank-10 subspaces are not
# determined in float32 (one rank's float32 factors are at a sine of 1.0
# from its float64 ones), and its DT <-> PP decisions vary from run to run
# even on one rank (index_add_ adds in no fixed order on the card), so
# float32 Tucker is held by its fit: the same logged iterations, every
# diffV within this relative distance of one rank's.
MESH_TUCKER_F32_DIFFV = 1e-5
# float64 functions against one process (index_add_ in both, summed in
# another order).
MESH_F64_TOL = 1e-10
MESH_PHASES = SPARSE_PHASES + ("mesh.all_reduce",)


def run_mesh_cluster(nproc, argv, label):
    """torchrun --standalone with ``nproc`` ranks (the worker's launcher:
    one thread a rank, SIGTERM then kill at CLUSTER_S); raises on a
    nonzero exit. Returns the output."""
    from pairwise_perturbation_tpu_torch.scripts import multiprocess_worker
    t0 = time.perf_counter()
    rc, out = multiprocess_worker.run_cluster(nproc, argv, CLUSTER_S)
    print(f"{label}: {nproc} ranks, exit {rc}, "
          f"{time.perf_counter() - t0:.1f} s (start-up included)")
    if rc != 0:
        raise AssertionError(f"{label}: torchrun exited {rc}\n{out[-6000:]}")
    return out


def worker_results(outdir, n=MESH_RANKS):
    import numpy as np
    return [dict(np.load(os.path.join(outdir, f"result_{r}.npz")))
            for r in range(n)]


def mesh_inputs(path, st, Ws, Ts, nell2, V, Wd):
    """The worker's inputs: the fixture's COO (K7 runs on each rank's
    shard), CP and Tucker factors, the engines' configurations, NELL-2's
    COO (plain ALS) and a dense 200^3 tensor (sharded_mttkrp)."""
    import numpy as np
    d = dict(indices=st.indices.cpu().numpy(), values=st.values.cpu().numpy(),
             shape=np.asarray(st.shape), cp_cfg=json.dumps(MESH_CP_CFG),
             tk_cfg=json.dumps(MESH_TK_CFG),
             tk_ranks=np.asarray([SPARSE_TUCKER_RANK] * st.ndim),
             als_indices=nell2.indices.cpu().numpy(),
             als_values=nell2.values.cpu().numpy(),
             als_shape=np.asarray(nell2.shape), als_rank=10,
             als_cfg=json.dumps(dict(tol=0.0, maxiter=3, resprint=3)),
             V=V.cpu().numpy(), mesh_shape=np.asarray([MESH_RANKS]))
    for name, fs in (("cp_W", Ws), ("tk_W", Ts), ("d_W", Wd)):
        for i, W in enumerate(fs):
            d[f"{name}{i}"] = W.cpu().numpy()
    np.savez(path, **d)


def check_ranks_equal(results, label, keys=None):
    """Every rank's digest of every result (or of ``keys``) is rank 0's."""
    import numpy as np
    ref = results[0]
    keys = keys or [k for k in ref if k.startswith("sha/")]
    for res in results[1:]:
        bad = [k for k in keys if not np.array_equal(res[k], ref[k])]
        if bad:
            raise AssertionError(f"{label}: ranks differ in {bad[:5]}")
    print(f"{label}: {len(keys)} results bit for bit equal on "
          f"{len(results)} ranks")


def held_errs(res, prefix, tol, label):
    """Raise unless every ``err/<prefix>...`` (the worker's distance from
    one process) is within ``tol``; return the largest."""
    errs = {k[4:]: float(v) for k, v in res.items()
            if k.startswith("err/" + prefix)}
    if not errs:
        raise AssertionError(f"{label}: no results under {prefix}")
    worst = max(errs, key=errs.get)
    print(f"{label}: {len(errs)} results, largest relative distance from "
          f"one process {errs[worst]:.3e} ({worst})")
    if not errs[worst] <= tol:
        raise AssertionError(f"{label}: {worst} {errs[worst]:.3e} > {tol}")
    return errs[worst]


def scope_line(stats, names=MESH_PHASES):
    """Medians in ms (count) of the scopes ``names`` in ``stats``."""
    return ", ".join(f"{n} {1e3 * stats[n][2]:.3f} ({stats[n][0]})"
                     for n in names if n in stats)


def one_rank_run(engine, st, W0, dtype, ranks=None):
    """The unsharded engine on the fixture (this process), from the same
    factors (CP) or its own sketch HOSVD (Tucker); returns (result, scope
    stats, wall s)."""
    import torch
    from pairwise_perturbation_tpu_torch.models import cp, sparse_cp
    from pairwise_perturbation_tpu_torch.models import sparse_tucker, tucker
    from pairwise_perturbation_tpu_torch.ops import sparse
    from pairwise_perturbation_tpu_torch.utils import tracing
    std = sparse.SparseTensor(st.indices, st.values.to(dtype), st.shape)
    tracing.reset()
    tracing.enable()
    t0 = time.perf_counter()
    if engine == "cp":
        res = sparse_cp.als_cp_pp_sparse(std, [W.to(dtype) for W in W0],
                                         cp.CPConfig(**MESH_CP_CFG))
    else:
        res = sparse_tucker.als_tucker_pp_sparse(
            std, ranks, tucker.TuckerConfig(**MESH_TK_CFG))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracing.enable(False)
    return res, tracing.stats(), wall


def factor_distance(A, B, tucker):
    """The largest over the modes of the relative max-norm difference
    (CP) or of the principal angle's sine (Tucker) between two runs'
    factors (host arrays or tensors)."""
    import torch
    errs = []
    for a, b in zip(A, B):
        a = torch.as_tensor(a).cuda().double()
        b = torch.as_tensor(b).cuda().double()
        errs.append(subspace_sin(a, b) if tucker
                    else float((a - b).abs().max() / a.abs().max()))
    return max(errs)


def held_engine(label, res_rank0, tag, d, one, stats_one, wall_one, smi,
                tucker=False, yardstick=None, names=None, tol=None,
                by_fit=None, same_iters=True):
    """A sharded engine run (rank 0's history and factors; every rank's
    are bitwise equal, checked apart) against the one-rank run: the same
    logged rows and DT <-> PP decisions (CP: PP rows present), factors
    within ``tol`` (default MESH_FACTOR_TOL; ``by_fit``, by default for
    float32 Tucker: the same logged iterations, or without
    ``same_iters`` as many rows ending at the same iteration, and diffV
    row for row within MESH_TUCKER_F32_DIFFV)
    (beside ``yardstick``, the one-rank float64 run's factors, for
    float32); medians of the scopes ``names`` (default the sparse
    engine's) printed side by side. Returns (the rank's scope stats, the
    failure or None)."""
    tol = tol or MESH_FACTOR_TOL
    hist = res_rank0[f"{tag}_hist/{d}"]
    want = [(h["iter"], h["pp"]) for h in one.history]
    got = [(int(r[0]), int(r[3])) for r in hist]
    n_pp = sum(p for _, p in got)
    mine = [res_rank0[f"{tag}_W/{d}/{i}"] for i in range(len(one.factors))]
    err = factor_distance(one.factors, mine, tucker)
    if by_fit is None:
        by_fit = tucker and d == "float32"
    fit = max(abs(r[2] - h["diffV"]) / h["diffV"]
              for r, h in zip(hist, one.history))
    line = (f"{label}: {len(got)} rows ({n_pp} PP), factors against one "
            f"rank: largest {'sine' if tucker else 'rel. difference'} "
            f"{err:.3e} ({'printed' if by_fit else 'tol'} "
            f"{tol[d]}); diffV rel. difference {fit:.3e}"
            + (f" (tol {MESH_TUCKER_F32_DIFFV})" if by_fit else ""))
    if yardstick is not None:
        line += (f"; against one rank's float64 run: 2 ranks "
                 f"{factor_distance(yardstick, mine, tucker):.3e}, 1 rank "
                 f"{factor_distance(yardstick, one.factors, tucker):.3e}")
    print(line)
    stats = json.loads(str(res_rank0[f"{tag}_stats/{d}"]))
    wall = float(res_rank0[f"{tag}_wall/{d}"])
    red = stats.get("mesh.all_reduce", (0, 0.0))
    names = names or (SPARSE_TUCKER_PHASES if tucker else SPARSE_PHASES)
    print(f"  2 ranks ({smi}): wall {wall:.3f} s, all_reduce {red[0]} calls "
          f"{red[1]:.3f} s ({100 * red[1] / wall:.1f}% of the wall); "
          f"medians ms: {scope_line(stats, names + ('mesh.all_reduce',))}")
    print(f"  1 rank: wall {wall_one:.3f} s; medians ms: "
          f"{scope_line(stats_one, names)}")
    if by_fit and ([i for i, _ in got] != [i for i, _ in want]
                   if same_iters else
                   (len(got), got[-1][0]) != (len(want), want[-1][0])):
        return stats, f"{label}: logged iterations {got}, one rank's {want}"
    if got != want:
        msg = f"{label}: logged (iter, pp) {got}, one rank's {want}"
        if not by_fit:
            return stats, msg
        print(f"  decisions differ (not held where the fit is): {msg}")
    if n_pp == 0 and not tucker:
        return stats, f"{label}: no PP rows"
    if by_fit and not fit <= MESH_TUCKER_F32_DIFFV:
        return stats, f"{label}: diffV off one rank's"
    if not by_fit and not err <= tol[d]:
        return stats, f"{label}: factors off one rank's"
    return stats, None


def run_mesh_engines(st, W0, results, smi):
    """11a's engine half: CP-PP (from ``W0``) and Tucker-PP with mesh=,
    f64 then f32, held to one-rank runs in this process; the K7 launches
    of each rank's CP f32 run against the phase machine. Every comparison
    is printed before the first failure raises. Returns the K7
    launches."""
    import torch
    k7, failures, f64 = 0, [], {}
    for dtype in ("float64", "float32"):
        tdt = getattr(torch, dtype)
        for tag, tucker in (("cp", False), ("tk", True)):
            one, stats_one, wall_one = one_rank_run(
                "tucker" if tucker else "cp", st, W0, tdt,
                (SPARSE_TUCKER_RANK,) * 4)
            name = "Tucker-PP" if tucker else "CP-PP"
            _, bad = held_engine(
                f"11a sparse {name} mesh=2 {dtype}", results[0], tag, dtype,
                one, stats_one, wall_one, smi, tucker, f64.get(tag))
            failures += [bad] if bad else []
            f64.setdefault(tag, [W.double() for W in one.factors])
            for key in (f"{tag}_W/{dtype}/0", f"{tag}_hist/{dtype}"):
                check_ranks_equal(results, f"11a {key}", [f"sha/{key}"])
        for r, res in enumerate(results):
            n = int(res[f"cp_k7/{dtype}"])
            want = expected_coo_launches(json.loads(str(
                res[f"cp_stats/{dtype}"])), 4) + coo_warm_launches(4, True) \
                if dtype == "float32" else 0
            if n != want:
                failures.append(f"11a CP {dtype} rank {r}: K7 launches {n}, "
                                f"expected {want}")
            k7 += n
            if int(res[f"tk_k7/{dtype}"]):
                failures.append("11a: a kernel launched on sparse Tucker")
        print(f"  K7 launches per rank (CP {dtype}): "
              f"{[int(r[f'cp_k7/{dtype}']) for r in results]}")
    if failures:
        raise AssertionError("; ".join(failures))
    return k7


def run_phase11(smi):
    """Phase 11 (11a-11e); returns {kernel id: launches}."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
        WORKER
    t_phase = time.perf_counter()
    launches = {}
    gen = torch.Generator(device="cuda").manual_seed(11)
    st = sparse_fixture()
    Ts = [torch.linalg.qr(torch.randn((s, SPARSE_TUCKER_RANK), generator=gen,
                                      device="cuda", dtype=torch.float64))[0]
          for s in SPARSE_SHAPE]
    Ws = cp.init_factors(SPARSE_SHAPE, 10, seed=0, dtype=torch.float64,
                         device="cuda")
    nell2, _ = random_coo(NELL2_SHAPE, NELL2_NNZ, 1, gen, seed=0)
    V = torch.rand(MAIN_SHAPE[:3], generator=gen, device="cuda")
    Wd = [torch.rand((s, MAIN_SHAPE[3]), generator=gen, device="cuda")
          for s in MAIN_SHAPE[:3]]
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "in.npz")
        mesh_inputs(inputs, st, Ws, Ts, nell2, V, Wd)
        del nell2
        torch.cuda.empty_cache()
        phase("11a. sharded sparse functions and engines at "
              "sparse200_4_nnz1.6M, rank 10, f32 and f64, 2 ranks over gloo "
              "on one card (with 11b and 11e in the same cluster)")
        run_mesh_cluster(MESH_RANKS, WORKER + [
            "--inputs", inputs, "--outdir", os.path.join(tmp, "a"),
            "--tasks", "functions,cp,tucker,als,dense"], "cluster A")
        a = worker_results(os.path.join(tmp, "a"))
        if {str(r["backend"]) for r in a} != {"gloo"}:
            raise AssertionError("two ranks on one card must use gloo")
        funcs = [k for k in a[0] if k.startswith("sha/") and k.split("/")[1]
                 in ("norm_sq", "mttkrp", "single", "pair", "ttmc", "tsingle",
                     "tpair", "gradnorm")]
        check_ranks_equal(a, "11a sharded functions", funcs)
        held_errs(a[0], "mttkrp/float32", REL_TOL,
                  "11a sharded_sparse_mttkrp (K7) f32")
        for pre in ("single/float32", "pair/float32", "ttmc/float32",
                    "tsingle/float32", "tpair/float32", "gradnorm/float32"):
            held_errs(a[0], pre, REL_TOL, f"11a {pre}")
        for pre in ("mttkrp/float64", "single/float64", "pair/float64",
                    "ttmc/float64", "tsingle/float64", "tpair/float64",
                    "gradnorm/float64", "norm_sq/float64"):
            held_errs(a[0], pre, MESH_F64_TOL, f"11a {pre}")
        launches["K7"] = run_mesh_engines(st, Ws, a, smi)
        phase("11b. plain sparse ALS with mesh= at NELL-2's shape and nnz, "
              "rank 10, maxiter 3, 2 ranks")
        for r, res in enumerate(a):
            stats = json.loads(str(res["als_stats"]))
            want = expected_coo_launches(stats, 3) + coo_warm_launches(
                3, False)
            n = int(res["als_k7"])
            red = stats.get("mesh.all_reduce", (0, 0.0))
            hist = res["als_hist"]
            print(f"11b rank {r} ({smi}): {int(res['als_nnz'])} nonzeros, "
                  f"wall {float(res['als_wall']):.3f} s, all_reduce "
                  f"{red[0]} calls {red[1]:.3f} s, peak memory "
                  f"{int(res['als_peak_bytes']) / 2**30:.2f} GiB, K7 {n} "
                  f"(expected {want}); gradnorm {hist[0, 1]:.6e} -> "
                  f"{hist[-1, 1]:.6e}; medians ms: {scope_line(stats)}")
            if n != want or not hist[-1, 1] < hist[0, 1]:
                raise AssertionError(f"11b rank {r}: K7 launches {n} (want "
                                     f"{want}) or gradnorm did not fall")
            launches["K7"] += n
        phase("11e. sharded_mttkrp at 200^3 f32 over 2 ranks (K1-K3 on each "
              "block)")
        held_errs(a[0], "smttkrp", REL_TOL, "11e sharded_mttkrp rank 0")
        held_errs(a[1], "smttkrp", REL_TOL, "11e sharded_mttkrp rank 1")
        for r, res in enumerate(a):
            blk = json.loads(str(res["block_launches"]))
            n = [blk[f"mttkrp3.{m}"] for m in range(3)]
            print(f"11e rank {r} block {res['spans'].tolist()}: K1-K3 "
                  f"launches {n}")
            if n != [1, 1, 1]:
                raise AssertionError(f"11e rank {r}: K1-K3 launches {n}")
            for m in range(3):
                launches[f"K{m + 1}"] = launches.get(f"K{m + 1}", 0) + 1
        del a
        phase("11a (repeat) and 11c: a second cluster: the f32 functions "
              "again, bit for bit; test_als -model Tucker -issparse 1 -pp 1 "
              "-mesh 2 at rank 1, f32 and f64, through cli.main in the "
              "world")
        tk_csv = {d: os.path.join(tmp, f"tk_{d}.csv")
                  for d in ("float32", "float64")}
        argv = [SPARSE_TUCKER_CLI + ["-dtype", d, "-mesh", "2", "-quiet",
                                     "-filename", tk_csv[d]]
                for d in tk_csv]
        b_in = os.path.join(tmp, "b.npz")
        with np.load(inputs) as data:
            np.savez(b_in, cli_argv=json.dumps(argv), **{
                k: data[k] for k in data.files
                if k in ("indices", "values", "shape") or
                k.startswith("cp_W")})
        run_mesh_cluster(MESH_RANKS, WORKER + [
            "--inputs", b_in, "--outdir", os.path.join(tmp, "b"),
            "--tasks", "functions,cli", "--dtypes", "float32"], "cluster B")
        b = worker_results(os.path.join(tmp, "b"))
        a0 = worker_results(os.path.join(tmp, "a"), 1)[0]
        k7_keys = [k for k in b[0] if k.startswith("sha/") and
                   k.split("/")[1] in ("mttkrp", "single", "pair",
                                       "gradnorm", "norm_sq")]
        check_ranks_equal([a0, b[0], b[1]], "11a K7 results, cluster A "
                          "rank 0 against both ranks of cluster B", k7_keys)
        if [int(x) for x in b[0]["cli_rc"]] != [0, 0]:
            raise AssertionError(f"11c: cli.main returned {b[0]['cli_rc']}")
        for d, path in tk_csv.items():
            with open(path) as fh:
                rows = list(csv.reader(fh))
            check_tucker_csv(rows, f"11c CLI sparse Tucker -mesh 2 {d}",
                             pp=True, fit=d == "float64",
                             margin=F64_DIFFV_MARGIN)
        phase("11c. torchrun -m pairwise_perturbation_tpu_torch.cli test_als "
              "-issparse 1 -pp 1 -mesh 2 (phase 6's run), 2 ranks")
        _, rows6, _ = run_sparse_cli()
        out6 = os.path.join(tmp, "cp_mesh2.csv")
        cli_args = ["-m", "pairwise_perturbation_tpu_torch.cli", "test_als",
                    *SPARSE_CLI, "-maxiter", "40", "-resprint", "1",
                    "-pp_res_tol", "0.1"]
        out = run_mesh_cluster(MESH_RANKS, cli_args + [
            "-mesh", "2", "-profile", "1", "-filename", out6], "11c CLI")
        if "backend=  gloo" not in out or "nnz split over 2" not in out:
            raise AssertionError("11c: no gloo banner or sharded COO line")
        with open(out6) as fh:
            rows = list(csv.reader(fh))
        check_csv(rows, "11c CLI -mesh 2 (Poisson 100^4 rank 10, f32)")
        gn0, gn0_one = float(rows[1][2]), float(rows6[1][2])
        rel0 = abs(gn0 - gn0_one) / gn0_one
        later = [abs(float(x[2]) - float(y[2])) / float(y[2])
                 for x, y in zip(rows[2:], rows6[2:])]
        print(f"11c [gradnorm] against phase 6's run: row 0 {rel0:.3e} "
              f"(held to {REL_TOL}); later rows up to "
              f"{max(later or [0.0]):.3e}, not held: the Poisson tensor's "
              "Grams at rank 10 are near singular, so the sharded sums' "
              "round-off moves the trajectory")
        if not rel0 <= REL_TOL:
            raise AssertionError("11c: row 0's gradnorm off phase 6's")
        phase("11d. a world of one on NCCL: torchrun --nproc_per_node 1, "
              "-mesh 1, against phase 6's run bit for bit")
        out1 = os.path.join(tmp, "cp_mesh1.csv")
        out = run_mesh_cluster(1, cli_args + ["-mesh", "1", "-filename",
                                              out1], "11d CLI")
        if "backend=  nccl" not in out:
            raise AssertionError("11d: a world of one on a card is not NCCL")
        with open(out1) as fh:
            rows1 = list(csv.reader(fh))
        check_same_rows("11d NCCL world of one against phase 6's run",
                        rows1[1:], rows6[1:], (1, 2, 4, 5))
    del st
    torch.cuda.empty_cache()
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the dense engines on a block-sharded V, 2 ranks under torchrun
# ---------------------------------------------------------------------------

# 12a: CP-PP at the coil shape (phase 5's seeded uniform tensor and
# factors), every sweep's diagnostics logged every 4; 12b: Tucker-PP at
# the coil shape (phase 9a's low-Tucker-rank tensor plus 1% noise).
DENSE_CP_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=12, resprint=4)
DENSE_TK_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=10, resprint=1)
# Sharded against one process from the same factors: CP's relative
# max-norm difference, Tucker's largest principal angle (sine), float64:
# round-off of sums in another order, grown through the solves. float32
# CP-PP at the coil shape is held by its fit: as many logged rows, ending
# at the same iteration, each diffV within MESH_TUCKER_F32_DIFFV of one
# process's. Its decisions and factors are not determined in float32 on
# this uniform tensor: a PP restart one sweep earlier on 2 ranks (the
# rows' iterations 9 and 10 apart) moved the factors 4.7e-2 apart, while
# both float32 runs lay 2.7-3.0e-2 from the float64 run's and every
# diffV agreed to 1.3e-6.
DENSE_FACTOR_TOL = {"float64": 1e-9, "float32": MESH_FACTOR_TOL["float32"]}
# 12c's CLI at 200^3 against the unsharded CLI: float64 to 1e-10 relative
# (the CLI tests' CLI_TOL), every decision the same; float32 rows to
# 5e-3 (sums over 4e6 entries in another order, grown through 20 sweeps)
# up to the first decision that differs, if one does.
DENSE_CLI_TOL = {"float64": 1e-10, "float32": 5e-3}
DENSE_CLI = ["test_als", "-model", "CP", "-tensor", "r", "-pp", "1", "-dim",
             "3", "-size", "200", "-rank", "10", "-maxiter", "20",
             "-resprint", "1", "-pp_res_tol", "0.1"]
DENSE_TK_PHASES = TUCKER_PHASES + ("mesh.all_reduce", "mesh.broadcast")


def dense_inputs(path, tmp, Vc, Wc, Vt):
    """Cluster A's inputs: the coil CP tensor and the Tucker tensor as
    float32 .npy files (each rank memory-maps its block), the CP factors,
    the engines' configurations, K6 on (use_kernels_triple)."""
    import numpy as np
    d = dict(dd_mesh=np.asarray([MESH_RANKS]),
             dc_vfile=os.path.join(tmp, "coil_cp.npy"),
             dc_cfg=json.dumps(DENSE_CP_CFG), dc_pp=np.asarray([1]),
             dc_config=json.dumps(dict(use_kernels_triple=True)),
             dt_vfile=os.path.join(tmp, "coil_tucker.npy"),
             dt_ranks=np.asarray(COIL_TUCKER_RANKS),
             dt_tk_cfg=json.dumps(DENSE_TK_CFG))
    np.save(d["dc_vfile"], Vc.cpu().numpy())
    np.save(d["dt_vfile"], Vt.cpu().numpy())
    for i, W in enumerate(Wc):
        d[f"dc_W{i}"] = W.cpu().numpy()
    np.savez(path, **d)


def dense_cp_one(V, Ws, dtype):
    """One process's coil CP-PP (the cluster's configuration, K6 on):
    (result, scope stats, wall s)."""
    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils import tracing
    tracing.reset()
    tracing.enable()
    t0 = time.perf_counter()
    with config.override(use_kernels_triple=True):
        res = cp.als_cp_pp(V.to(dtype), [W.to(dtype) for W in Ws],
                           cp.CPConfig(**DENSE_CP_CFG))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracing.enable(False)
    return res, tracing.stats(), wall


def run_dense_cp(a, Vc, Wc, smi):
    """12a: each rank's coil CP-PP against one process's, f64 then f32;
    each rank's K6 launches (one a cache build, f32) and K5's (K6's O3);
    K6 on rank 0's block against its plain version, twice bit for bit.
    Returns {kernel id: launches}."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots
    failures, launches, f64 = [], {"K5": 0, "K6": 0}, None
    for d in ("float64", "float32"):
        one, stats_one, wall_one = dense_cp_one(Vc, Wc, getattr(torch, d))
        _, bad = held_engine(f"12a dense CP-PP coil mesh=2 {d}", a[0],
                             "dcp1", d, one, stats_one, wall_one, smi,
                             yardstick=f64, names=CP_PHASES,
                             tol=DENSE_FACTOR_TOL, by_fit=d == "float32",
                             same_iters=d == "float64")
        failures += [bad] if bad else []
        f64 = f64 or [W.double() for W in one.factors]
        check_ranks_equal(a, f"12a {d}", [f"sha/dcp1_hist/{d}"] + [
            f"sha/dcp1_W/{d}/{i}" for i in range(4)])
        for r, res in enumerate(a):
            n = json.loads(str(res[f"dcp1_launches/{d}"]))
            stats = json.loads(str(res[f"dcp1_stats/{d}"]))
            builds = stats.get("cp.pp_cache_build", (0,))[0]
            warm = json.loads(str(res[f"dcp1_warm/{d}"]))
            k6, k5 = n["triple_roots.triple_roots"], \
                n["last_contract.last_contract"]
            w6, w5 = warm.get("triple_roots.triple_roots", 0), \
                warm.get("last_contract.last_contract", 0)
            print(f"  rank {r} {d}: {builds} in-loop cache builds, K6 "
                  f"launches {k6}, K5 (O3) {k5}, of them {w6} and {w5} in "
                  "the warm-up build (reused as the first); medians ms: "
                  f"{scope_line(stats, CP_PHASES + ('mesh.all_reduce',))}")
            want, wwant = (builds, 1) if d == "float32" else (0, 0)
            if not k6 - w6 == k5 - w5 == want or not w6 == w5 == wwant:
                failures.append(f"12a rank {r} {d}: K6 {k6}, K5 {k5}, "
                                f"warm {w6}, {w5}, cache builds {builds}")
            launches["K6"] += k6
            launches["K5"] += k5
    half = COIL_SHAPE[3] // MESH_RANKS
    block = Vc[..., :half].contiguous()
    Wb = [Wc[1].float(), Wc[2].float(), Wc[3][:half].float().contiguous()]
    err = held_twice(
        f"12a K6 on rank 0's block {tuple(block.shape)}",
        lambda: torch.cat([o.reshape(-1) for o in
                           triple_roots.triple_roots(block, *Wb)]),
        lambda: torch.cat([o.reshape(-1) for o in
                           triple_roots.triple_roots_plain(block, *Wb)]))
    print(f"12a K6 at rank 0's block {tuple(block.shape)}: max abs "
          f"{err[0]:.3e}, relative {err[1]:.3e} (tol {REL_TOL}), two "
          "launches bit for bit")
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def run_dense_tucker(a, Vt, smi):
    """12b: each rank's coil Tucker-PP against one process's from its own
    HOSVD (the same draws): float64 by the decisions and the factors'
    principal angles, float32 by a float64 reconstruction of the fit, as
    phase 9a holds it."""
    import torch
    from pairwise_perturbation_tpu_torch.models import tucker
    from pairwise_perturbation_tpu_torch.utils import tracing
    ranks = COIL_TUCKER_RANKS
    route = "matrix-free subspace iteration" \
        if COIL_SHAPE[3] > tucker.HOSVD_EXACT_EIGH_MAX else "assembled Gram"
    print(f"12b HOSVD of the sharded mode 3 ({COIL_SHAPE[3]} > "
          f"HOSVD_EXACT_EIGH_MAX {tucker.HOSVD_EXACT_EIGH_MAX}): {route}")
    failures = []
    for d in ("float64", "float32"):
        Vd = Vt.to(getattr(torch, d))
        start_tucker_trace()
        t0 = time.perf_counter()
        one = tucker.als_tucker_pp(Vd, ranks,
                                   tucker.TuckerConfig(**DENSE_TK_CFG))
        torch.cuda.synchronize()
        wall_one = time.perf_counter() - t0
        stats_one = tracing.stats()
        tracing.enable(False)
        check_ranks_equal(a, f"12b {d}", [f"sha/dtk_hist/{d}",
                                          f"sha/dtk_core/{d}"])
        hist = a[0][f"dtk_hist/{d}"]
        got = [(int(r[0]), int(r[3])) for r in hist]
        want = [(h["iter"], h["pp"]) for h in one.history]
        mine = [torch.from_numpy(a[0][f"dtk_W/{d}/{i}"]).cuda()
                for i in range(4)]
        sines = [subspace_sin(x, y) for x, y in zip(one.factors, mine)]
        label = f"12b dense Tucker-PP coil mesh=2 {d}"
        print(f"{label}: {len(got)} rows ({sum(p for _, p in got)} PP), "
              f"one process's {len(want)}; factor sines against one "
              f"process by mode {', '.join(f'{x:.3e}' for x in sines)}")
        if d == "float64":
            if got != want:
                failures.append(f"{label}: (iter, pp) {got}, one "
                                f"process's {want}")
            if not max(sines) <= DENSE_FACTOR_TOL[d]:
                failures.append(f"{label}: factors off one process's")
        else:
            start = direct_residual(Vd, tucker.hosvd(Vd, ranks)[1])
            end = direct_residual(Vd, mine)
            end_one = direct_residual(Vd, one.factors)
            print(f"{label}: ||V - V^|| by float64 reconstruction {start!r}"
                  f" (one process's HOSVD) -> {end!r} (2 ranks), one "
                  f"process's run {end_one!r}")
            if not end <= start * (1.0 + F64_RECON_MARGIN):
                failures.append(f"{label}: the fit got worse")
        for r, res in enumerate(a):
            stats = json.loads(str(res[f"dtk_stats/{d}"]))
            wall = float(res[f"dtk_wall/{d}"])
            red = stats.get("mesh.all_reduce", (0, 0.0))
            print(f"  rank {r} ({smi}): wall {wall:.3f} s, all_reduce "
                  f"{red[0]} calls {red[1]:.3f} s ({100 * red[1] / wall:.1f}%"
                  f" of the wall); medians ms: "
                  f"{scope_line(stats, DENSE_TK_PHASES)}")
            if any(json.loads(str(res[f"dtk_launches/{d}"])).values()):
                failures.append(f"12b rank {r}: a kernel launched on Tucker")
        print(f"  1 process: wall {wall_one:.3f} s; medians ms: "
              f"{scope_line(stats_one, TUCKER_PHASES)}")
        del Vd
    if failures:
        raise AssertionError("; ".join(failures))


def run_dense_cli(b, tmp, smi):
    """12c-12d: the 200^3 CLI -mesh 2 (f64, f32) against the unsharded
    CLI, K1-K3 per diagnostics row on each rank's (100, 200, 200) block,
    each held to its plain version there; pp_bench at 512^3 -mesh 2 with
    K4 on each rank's (256, 512, 512) block, held to its plain version.
    Returns {kernel id: launches}."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    launches = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    if [int(x) for x in b[0]["cli_rc"]] != [0, 0, 0]:
        raise AssertionError(f"12c-d: cli.main returned {b[0]['cli_rc']}")
    for k, d in enumerate(("float64", "float32")):
        mesh_rows = read_csv(os.path.join(tmp, f"cli200_{d}_mesh.csv"))
        one = cli_csv(DENSE_CLI + ["-dtype", d],
                      os.path.join(tmp, f"cli200_{d}_one.csv"))
        check_csv(mesh_rows, f"12c CLI 200^3 -mesh 2 {d}")
        tol = DENSE_CLI_TOL[d]
        pairs = list(zip(mesh_rows[1:], one[1:]))
        # rows up to the first decision that differs (float32 may part
        # there, as 12a's coil runs do; float64 must not)
        same = next((j for j, (x, y) in enumerate(pairs)
                     if (x[1], x[4]) != (y[1], y[4])), len(pairs))
        rel = max(abs(float(x[c]) - float(y[c])) / abs(float(y[c]))
                  for x, y in pairs[:max(same, 1)] for c in (2, 5))
        print(f"12c {d}: against the unsharded CLI, {len(pairs)} rows, "
              f"decisions identical in the first {same}, [gradnorm]/[diffV]"
              f" there within {rel:.3e} relative (tol {tol})")
        if len(mesh_rows) != len(one) or not rel <= tol or \
                (same < len(pairs) and d == "float64") or same < 2:
            raise AssertionError(f"12c {d}: off the unsharded CLI's CSV")
        n_rows = len(mesh_rows) - 1
        for r, res in enumerate(b):
            n = json.loads(str(res["cli_launches"]))[k]
            got = [n[f"mttkrp3.{m}"] for m in range(3)]
            want = [n_rows, n_rows, 2 * n_rows] if d == "float32" \
                else [0, 0, 0]
            print(f"12c rank {r} {d}: K1-K3 launches {got} on its block "
                  f"(100, 200, 200), expected {want} ({n_rows} rows)")
            if got != want:
                raise AssertionError(f"12c rank {r}: K1-K3 launches {got}")
            for m in range(3):
                launches[f"K{m + 1}"] += got[m]
    gen = torch.Generator(device="cuda").manual_seed(12)
    Vb = torch.rand((100, 200, 200), generator=gen, device="cuda")
    Ws = [torch.rand((s, 10), generator=gen, device="cuda")
          for s in Vb.shape]
    for m in range(3):
        err = held_twice(f"12c K{m + 1} at (100, 200, 200)",
                         lambda: mttkrp3.mttkrp3_mode(Vb, Ws, m),
                         lambda: mttkrp3.mttkrp3_mode_plain(Vb, Ws, m))
        print(f"12c K{m + 1} at rank 0's block (100, 200, 200): relative "
              f"{err[1]:.3e} (tol {REL_TOL}), two launches bit for bit")
    rows = read_csv(os.path.join(tmp, "bench512_mesh.csv"))
    kinds = [r[0] for r in rows[1:]]
    if kinds != ["[DTtime]"] * 3 + ["[PPfirst]", "[PPsecond]"] * 3 or \
            not all(float(r[1]) > 0 for r in rows[1:]):
        raise AssertionError(f"12d pp_bench -mesh 2 CSV: {rows}")
    med = {kd: statistics.median(float(r[1]) for r in rows[1:]
                                 if r[0] == f"[{kd}]") for kd in BENCH_KINDS}
    print(f"12d pp_bench 512^3 f32 -mesh 2 use_kernels_first ({smi}), rank "
          "0's rows: medians " + ", ".join(
              f"[{kd}] {1e3 * v:.3f} ms" for kd, v in med.items()))
    for r, res in enumerate(b):
        k4 = json.loads(str(res["cli_launches"]))[2]["mid_contract.rank_minor"]
        print(f"12d rank {r}: K4 launches {k4} on its block (256, 512, 512)"
              " (expected 4: one a DT sweep)")
        if k4 != 4:
            raise AssertionError(f"12d rank {r}: K4 launches {k4}")
        launches["K4"] += k4
    Vb = torch.rand((256, 512, 512), generator=gen, device="cuda")
    W0 = torch.rand((256, 10), generator=gen, device="cuda")
    err = held_twice("12d K4 at (256, 512, 512) mode 0",
                     lambda: mid_contract.mid_contract(Vb, W0, 0),
                     lambda: mid_contract.mid_contract_plain(Vb, W0, 0))
    print(f"12d K4 at rank 0's block (256, 512, 512), mode 0: relative "
          f"{err[1]:.3e} (tol {REL_TOL}), two launches bit for bit")
    return launches


def read_csv(path):
    with open(path) as fh:
        return list(csv.reader(fh))


def run_phase12(smi):
    """Phase 12 (12a-12e); returns {kernel id: launches}."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
        WORKER
    t_phase = time.perf_counter()
    launches = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    Vc = torch.rand(COIL_SHAPE, generator=gen, device="cuda")
    Wc = cp.init_factors(COIL_SHAPE, 10, seed=0, dtype=torch.float64,
                         device="cuda")
    Vt = low_tucker_rank_tensor(COIL_SHAPE, COIL_TUCKER_RANKS, seed=15)
    with tempfile.TemporaryDirectory() as tmp:
        phase("12a-b. the dense engines at the coil shape, V block-sharded "
              "over mode 3 (3600 a rank), 2 ranks over gloo on one card: "
              "CP-PP (use_kernels_triple) and Tucker-PP, f64 and f32")
        inputs = os.path.join(tmp, "in.npz")
        dense_inputs(inputs, tmp, Vc, Wc, Vt)
        run_mesh_cluster(MESH_RANKS, WORKER + [
            "--inputs", inputs, "--outdir", os.path.join(tmp, "a"),
            "--tasks", "dcp,dtucker"], "cluster A (dense)")
        a = worker_results(os.path.join(tmp, "a"))
        launches.update(run_dense_cp(a, Vc, Wc, smi))
        run_dense_tucker(a, Vt, smi)
        del a
        phase("12c-d. test_als -model CP -pp 1 -mesh 2 at 200^3 (f64, f32) "
              "and pp_bench -model CP -mesh 2 at 512^3 (use_kernels_first) "
              "through cli.main in one cluster")
        argv = [DENSE_CLI + ["-dtype", d, "-mesh", "2", "-quiet",
                             "-filename",
                             os.path.join(tmp, f"cli200_{d}_mesh.csv")]
                for d in ("float64", "float32")]
        argv.append(PP_BENCH_ARGS + ["-mesh", "2", "-quiet", "-filename",
                                     os.path.join(tmp, "bench512_mesh.csv")])
        b_in = os.path.join(tmp, "b.npz")
        np.savez(b_in, cli_argv=json.dumps(argv), cli_config=json.dumps(
            [{}, {}, dict(use_kernels_first=True)]))
        run_mesh_cluster(MESH_RANKS, WORKER + [
            "--inputs", b_in, "--outdir", os.path.join(tmp, "b"),
            "--tasks", "cli"], "cluster B (dense CLI)")
        launches.update(run_dense_cli(
            worker_results(os.path.join(tmp, "b")), tmp, smi))
        phase("12e. a world of one on NCCL: torchrun --nproc_per_node 1, "
              "test_als -tensor o1 -mesh 1 (read block by block), against "
              "the unsharded CLI on the same file")
        path = os.path.join(tmp, "coil-100.bin")
        seeded_binary(path, O1_FILE_SHAPE, seed=12)
        torch.cuda.empty_cache()
        o1 = ["test_als", "-model", "CP", "-tensor", "o1", "-tensorfile",
              path, "-rank", "10", "-pp", "1", "-pp_res_tol", "0.1",
              "-resprint", "1", "-maxiter", "12"]
        out1 = os.path.join(tmp, "o1_mesh1.csv")
        out = run_mesh_cluster(1, ["-m", "pairwise_perturbation_tpu_torch.cli",
                                   *o1, "-mesh", "1", "-filename", out1],
                               "12e CLI")
        if "backend=  nccl" not in out or "sharded read" not in out:
            raise AssertionError("12e: no NCCL banner or sharded read line")
        rows1 = read_csv(out1)
        rows = cli_csv(o1, os.path.join(tmp, "o1_one.csv"))
        check_csv(rows, "12e unsharded test_als -tensor o1")
        check_same_rows("12e NCCL world of one (-mesh 1) against the "
                        "unsharded CLI", rows1[1:], rows[1:], (0, 1, 2, 4, 5))
        print(f"12e [tol] (tol x ||V||): {rows1[1][3]} (||V|| of the block "
              f"on the card) and {rows[1][3]} (numpy on the host)")
    del Vc, Vt
    torch.cuda.empty_cache()
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: run -mesh 2, the five optimizers on a block-sharded V
# ---------------------------------------------------------------------------

# 13a: the chain optimizers through cli.run_cpd on each rank's block of
# the coil tensor (phase 5's seeded uniform tensor, V sharded over mode 3,
# 3600 a rank), f64 and f32; MSDT under use_kernels_first (K4 on the
# hold-outs it admits at the block's shape, f32).
RUN_MESH_SPECS = [
    dict(tag="dt", pp=0, maxiter=3, resprint=2),
    dict(tag="msdt", pp=1, maxiter=3, resprint=2,
         config=dict(use_kernels_first=True)),
    dict(tag="dtlr", pp=2, maxiter=4, resprint=2),
    dict(tag="msdtlr", pp=3, maxiter=4, resprint=2)]
# float64 factors against one process's: round-off of the blocks' sums in
# another order, grown through a few Cholesky solves and truncations.
# float32 is held by its fit: the logged diffV (exact diagnostics) of
# every row within RUN_MESH_F32_DIFFV of one process's.
RUN_MESH_FACTOR_TOL = 1e-9
RUN_MESH_F32_DIFFV = 1e-4
# 13b: the CLI in the same cluster: Simple at 512^3 f32 (K1-K3 on each
# rank's (256, 512, 512) block, a step and 1/1/2 a diagnostics row) and
# MSDT -device_loop 1 at 200^3 f64 (a rotation a step); 13c: a world of
# one on NCCL, MSDT-LR at 200^3 f32.
RUN_MESH_CLI = [
    RUN_512 + ["-pp", "4", "-maxiter", "4", "-resprint", "2", "-dtype",
               "float32"],
    ["run", "-tensor", "r", "-dim", "3", "-size", "200", "-rank", "10",
     "-pp", "1", "-device_loop", "1", "-maxiter", "6", "-resprint", "1",
     "-dtype", "float64"]]
RUN_MESH_CLI_TOL = {"float64": 1e-10, "float32": 5e-3}
RUN_WORLD1 = ["run", "-tensor", "r", "-dim", "3", "-size", "200", "-rank",
              "10", "-pp", "3", "-maxiter", "6", "-resprint", "1",
              "-dtype", "float32"]


def run_mesh_one(spec, V, Ws, dtype):
    """One process's cli.run_cpd of ``spec`` at the coil shape: (CPD,
    scope stats, K4 launches)."""
    import torch
    from pairwise_perturbation_tpu_torch import cli, config
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    tracing.reset()
    _bench.reset_launch_counts()
    tracing.enable()
    try:
        with config.override(**spec.get("config", {})):
            model = cli.run_cpd(V.to(dtype), [W.to(dtype) for W in Ws],
                                spec["pp"], tol=0.0, maxiter=spec["maxiter"],
                                resprint=spec["resprint"])
        torch.cuda.synchronize()
    finally:
        tracing.enable(False)
    return (model, tracing.stats(),
            _bench.launch_counts()["mid_contract.rank_minor"])


def run_mesh_optimizers(a, Vc, Wc, smi):
    """13a: each rank's coil runs against one process's; K4's launches on
    the MSDT run (f32) against its hold-outs, and K4 held to its plain
    version at rank 0's block. Returns K4's launches."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
    half = COIL_SHAPE[3] // MESH_RANKS
    block = COIL_SHAPE[:3] + (half,)
    eligible = {m for m in range(4) if mid_contract.mid_contract_eligible(
        block, m, torch.float32, 10)}
    failures, k4 = [], 0
    for d in ("float64", "float32"):
        for spec in RUN_MESH_SPECS:
            tag = spec["tag"]
            label = f"13a run -pp {spec['pp']} ({tag}) coil mesh=2 {d}"
            one, stats_one, k4_one = run_mesh_one(spec, Vc, Wc,
                                                  getattr(torch, d))
            check_ranks_equal(a, label, [f"sha/run_hist/{d}/{tag}"] + [
                f"sha/run/{d}/{tag}/W/{m}" for m in range(4)])
            hist = a[0][f"run_hist/{d}/{tag}"]
            want = [(h["sweeps"], h["diffV"]) for h in one.history]
            mine = [a[0][f"run/{d}/{tag}/W/{m}"][:COIL_SHAPE[m]]
                    for m in range(4)]
            dist = factor_distance(mine, one.W, False)
            rel = max(abs(r[2] - w[1]) / abs(w[1])
                      for r, w in zip(hist, want))
            print(f"{label}: {len(hist)} rows (one process {len(want)}), "
                  f"sweeps {hist[-1][0]:g}, diffV {hist[0][2]:.6e} -> "
                  f"{hist[-1][2]:.6e}; factors {dist:.3e} from one "
                  f"process's, diffV within {rel:.3e}")
            if [r[0] for r in hist] != [w[0] for w in want]:
                failures.append(f"{label}: logged sweeps differ")
            elif d == "float64" and not dist <= RUN_MESH_FACTOR_TOL:
                failures.append(f"{label}: factors {dist:.3e} off")
            elif d == "float32" and not rel <= RUN_MESH_F32_DIFFV:
                failures.append(f"{label}: diffV {rel:.3e} off")
            scope = [n for n in stats_one if n.endswith(".step")][0]
            for r, res in enumerate(a):
                stats = json.loads(str(res[f"run_stats/{d}/{tag}"]))
                n = json.loads(str(res[f"run_launches/{d}/{tag}"]))[
                    "mid_contract.rank_minor"]
                steps = stats[scope][0]
                want_k4 = sum(1 for h in msdt_holdouts(4, steps)
                              if h in eligible) \
                    if "config" in spec and d == "float32" else 0
                red = stats.get("mesh.all_reduce", (0, 0.0))
                wall = float(res[f"run_wall/{d}/{tag}"])
                print(f"  rank {r} ({smi}): {scope} {steps} steps, median "
                      f"{1e3 * stats[scope][2]:.3f} ms (one process "
                      f"{1e3 * stats_one[scope][2]:.3f}); all_reduce "
                      f"{red[0]} calls {red[1]:.3f} s of {wall:.3f} s; K4 "
                      f"{n} (expected {want_k4}; one process {k4_one}); "
                      f"peak {float(res[f'run_peak/{d}/{tag}']) / 2**30:.2f}"
                      " GiB")
                if n != want_k4 or ("config" in spec and d == "float32"
                                    and n == 0):
                    failures.append(f"{label} rank {r}: K4 launches {n}")
                k4 += n
    gen = torch.Generator(device="cuda").manual_seed(13)
    Vb = torch.rand(block, generator=gen, device="cuda")
    for m in sorted(eligible):
        W = torch.rand((block[m], 10), generator=gen, device="cuda")
        err = held_twice(f"13a K4 at {block} mode {m}",
                         lambda: mid_contract.mid_contract(Vb, W, m),
                         lambda: mid_contract.mid_contract_plain(Vb, W, m))
        print(f"13a K4 at rank 0's block {block}, mode {m}: relative "
              f"{err[1]:.3e} (tol {REL_TOL}), two launches bit for bit")
    if failures:
        raise AssertionError("; ".join(failures))
    return k4


def run_mesh_cli(a, tmp, smi):
    """13b: the cluster's CLI runs against the unsharded CLI's; K1-K3 on
    each rank's (256, 512, 512) block, held to their plain versions there.
    Returns {kernel id: launches}."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    launches = {"K1": 0, "K2": 0, "K3": 0}
    if [int(x) for x in a[0]["cli_rc"]] != [0] * len(RUN_MESH_CLI):
        raise AssertionError(f"13b: cli.main returned {a[0]['cli_rc']}")
    for k, argv in enumerate(RUN_MESH_CLI):
        d = argv[argv.index("-dtype") + 1]
        label = f"13b {' '.join(argv)} -mesh 2"
        mesh_rows = read_csv(os.path.join(tmp, f"run{k}_mesh.csv"))
        one = cli_csv(argv, os.path.join(tmp, f"run{k}_one.csv"))
        check_run_csv(mesh_rows, label)
        rel = max(abs(float(x[c]) - float(y[c])) / abs(float(y[c]))
                  for x, y in zip(mesh_rows[1:], one[1:]) for c in (2, 5))
        same = [r[1] for r in mesh_rows] == [r[1] for r in one]
        print(f"{label}: against the unsharded CLI, the same sweeps "
              f"{same}, [gradnorm]/[diffV] within {rel:.3e} relative (tol "
              f"{RUN_MESH_CLI_TOL[d]})")
        if not same or not rel <= RUN_MESH_CLI_TOL[d]:
            raise AssertionError(f"{label}: off the unsharded CLI's CSV")
        if "-pp" in argv and argv[argv.index("-pp") + 1] != "4":
            continue
        rows = len(mesh_rows) - 1
        for r, res in enumerate(a):
            n = json.loads(str(res["cli_launches"]))[k]
            got = [n[f"mttkrp3.{m}"] for m in range(3)]
            steps = got[0] - rows
            want = [steps + rows, steps + rows, steps + 2 * rows]
            print(f"13b rank {r}: K1-K3 launches {got} on its block (256, "
                  f"512, 512): {steps} Simple steps and {rows} rows "
                  f"(expected {want})")
            if got != want or steps <= 0:
                raise AssertionError(f"13b rank {r}: K1-K3 launches {got}")
            for m in range(3):
                launches[f"K{m + 1}"] += got[m]
    gen = torch.Generator(device="cuda").manual_seed(14)
    Vb = torch.rand((256, 512, 512), generator=gen, device="cuda")
    Ws = [torch.rand((s, 10), generator=gen, device="cuda")
          for s in Vb.shape]
    for m in range(3):
        err = held_twice(f"13b K{m + 1} at (256, 512, 512)",
                         lambda: mttkrp3.mttkrp3_mode(Vb, Ws, m),
                         lambda: mttkrp3.mttkrp3_mode_plain(Vb, Ws, m))
        print(f"13b K{m + 1} at rank 0's block (256, 512, 512): relative "
              f"{err[1]:.3e} (tol {REL_TOL}), two launches bit for bit")
    return launches


def run_phase13(smi):
    """Phase 13 (13a-13c); returns {kernel id: launches}."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
        WORKER
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    Vc = torch.rand(COIL_SHAPE, generator=gen, device="cuda")
    Wc = cp.init_factors(COIL_SHAPE, 10, seed=0, dtype=torch.float64,
                         device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        phase("13a-b. run -mesh 2, two ranks over gloo on one card: DT, "
              "MSDT (use_kernels_first), DT-LR and MSDT-LR at the coil "
              "shape through cli.run_cpd, f64 and f32; the CLI's Simple at "
              "512^3 and -device_loop 1 at 200^3")
        inputs = os.path.join(tmp, "in.npz")
        d = dict(dd_mesh=np.asarray([MESH_RANKS]),
                 dr_vfile=os.path.join(tmp, "coil.npy"),
                 dr_runs=json.dumps(RUN_MESH_SPECS),
                 cli_argv=json.dumps([
                     argv + ["-mesh", "2", "-quiet", "-filename",
                             os.path.join(tmp, f"run{k}_mesh.csv")]
                     for k, argv in enumerate(RUN_MESH_CLI)]))
        np.save(d["dr_vfile"], Vc.cpu().numpy())
        for i, W in enumerate(Wc):
            d[f"dr_W{i}"] = W.cpu().numpy()
        np.savez(inputs, **d)
        torch.cuda.empty_cache()
        run_mesh_cluster(MESH_RANKS, WORKER + [
            "--inputs", inputs, "--outdir", os.path.join(tmp, "a"),
            "--tasks", "drun,cli"], "13 cluster (run -mesh)")
        a = worker_results(os.path.join(tmp, "a"))
        launches = {"K4": run_mesh_optimizers(a, Vc, Wc, smi)}
        launches.update(run_mesh_cli(a, tmp, smi))
        del a
        phase("13c. a world of one on NCCL: torchrun --nproc_per_node 1, "
              "run -pp 3 -mesh 1 at 200^3 against the unsharded run")
        out1 = os.path.join(tmp, "world1.csv")
        out = run_mesh_cluster(1, ["-m", "pairwise_perturbation_tpu_torch.cli",
                                   *RUN_WORLD1, "-mesh", "1", "-filename",
                                   out1], "13c CLI")
        if "backend=  nccl" not in out:
            raise AssertionError("13c: no NCCL banner")
        rows = cli_csv(RUN_WORLD1, os.path.join(tmp, "world1_one.csv"))
        check_run_csv(rows, "13c unsharded run -pp 3")
        check_same_rows("13c NCCL world of one (run -mesh 1) against the "
                        "unsharded run", read_csv(out1)[1:], rows[1:],
                        (0, 1, 2, 3, 4, 5))
    del Vc
    torch.cuda.empty_cache()
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: test_als -pp 1 -device_loop 1, the device-resident phase loops
# ---------------------------------------------------------------------------

DEVICE_LOOP_CLI = ["test_als", "-model", "CP", "-tensor", "r", "-pp", "1",
                   "-dim", "3", "-size", "200", "-rank", "10", "-resprint",
                   "1", "-pp_res_tol", "0.1"]
# The device engine runs the host engine's sweep functions on the same
# inputs and takes the same decisions: its factors equal the host
# engine's bit for bit on the CPU (f64 and f32); on the card this
# tolerance (relative max-norm) is the check.
DEVICE_LOOP_FACTOR_TOL = 1e-5
DEVICE_PHASES = ("cp.dt_phase_device", "cp.pp_phase_device",
                 "cp.pp_cache_build", "cp.diagnostics")
# 14a's device engine again at these chunk sizes (sweeps issued between
# two pulls): [dtime], masked sweeps and pulls beside the default's.
DEVICE_LOOP_CHUNKS = (1, 4, 8)
# 14b at the coil shape: where the engines take another DT <-> PP
# decision (the host engine's gradnorm guard also holds the last DT
# sweep's estimate in its floor, the device engine's only its own
# phase's: JAX cp.py:556-575 and :852-866), the device engine is held by
# its fit: its last row's exact diffV within this relative distance of
# the host engine's.
DEVICE_LOOP_COIL_DIFFV = 1e-3


def count_syncs(fn):
    """(fn(), {source: syncs}) with torch.cuda.set_sync_debug_mode("warn"):
    each synchronizing CUDA call warns, and its source is the innermost
    frame of the port on the Python stack (else the innermost frame)."""
    import collections
    import traceback
    import warnings
    import torch
    counts = collections.Counter()
    root = os.path.dirname(os.path.abspath(__file__))

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if not f.filename.endswith("warnings.py")]
        own = [f for f in frames
               if "pairwise_perturbation_tpu_torch" in f.filename]
        f = (own or frames)[-1]
        name = os.path.relpath(f.filename, root)
        counts[f"{name}:{f.lineno} {(f.line or '').strip()[:48]}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, counts


def sync_line(counts, per=1):
    return f"{sum(counts.values()) / per:g} (" + "; ".join(
        f"{src}: {n / per:g}" for src, n in counts.most_common()) + ")"


def device_loop_syncs(label, V, Ws):
    """14c: syncs of one host-engine DT sweep, PP cache build and PP sweep
    and of the host engine's per-sweep ratio pull, beside one chunk of the
    device engine's DT and PP phases (per sweep), by source."""
    import torch
    from pairwise_perturbation_tpu_torch.models import cp
    chunk = cp.DEVICE_LOOP_CHUNK
    Ws = [W.clone() for W in Ws]
    cp.dt_sweep(V, Ws, 0.0, solver="svd")          # warm
    (W1, _), dt = count_syncs(lambda: cp.dt_sweep(V, Ws, 0.0, solver="svd"))
    (single, pair), build = count_syncs(lambda: cp.pp_build_caches(V, W1))
    dWs = [torch.zeros_like(W) for W in W1]
    _, pp = count_syncs(lambda: cp.pp_sweep(single, pair, W1, W1, dWs, 0.0,
                                            1.0, solver="svd"))
    _, pull = count_syncs(lambda: cp.factor_norm_ratios(W1, W1).cpu())
    _, ddt = count_syncs(lambda: cp.dt_phase_device(
        V, Ws, 0.0, 1e-30, 0.0, chunk, solver="svd", max_sweeps=chunk))
    _, dpp = count_syncs(lambda: cp.pp_phase_device(
        V, W1, 0.0, 1.0, 1e30, 0.0, chunk, gn_guard=0.0, solver="svd",
        max_sweeps=chunk))
    print(f"14c {label} syncs (set_sync_debug_mode warn), by source:\n"
          f"  host DT sweep {sync_line(dt)}\n"
          f"  host PP cache build {sync_line(build)}\n"
          f"  host PP sweep {sync_line(pp)}\n"
          f"  host per-sweep ratio pull {sync_line(pull)}\n"
          f"  device DT phase, per sweep of a {chunk}-sweep chunk "
          f"{sync_line(ddt, chunk)}\n"
          f"  device PP phase (its cache build included), per sweep of a "
          f"{chunk}-sweep chunk {sync_line(dpp, chunk)}")
    return dict(dt=dt, pp=pp, ddt=ddt, dpp=dpp)


def device_loop_report(label, eng, stats, counts, smi):
    """Medians of an engine's scopes, and for the device engine per-sweep
    times and pulls per phase."""
    if eng == "host":
        print(f"  {label} host engine ({smi}): " + scope_line(stats,
                                                              CP_PHASES))
        return
    phases = sum(stats.get(n, (0,))[0] for n in DEVICE_PHASES[:2])
    dt_ms = 1e3 * stats.get("cp.dt_phase_device", (0, 0.0))[1] / max(
        counts["dt_issued"], 1)
    pp_ms = 1e3 * (stats.get("cp.pp_phase_device", (0, 0.0))[1]
                   - stats.get("cp.pp_cache_build", (0, 0.0))[1]) / max(
        counts["pp_issued"], 1)
    print(f"  {label} device engine ({smi}): "
          + scope_line(stats, DEVICE_PHASES)
          + f"; DT sweeps issued {counts['dt_issued']} (masked "
          f"{counts['dt_masked']}), {dt_ms:.3f} ms an issued sweep; PP "
          f"sweeps issued {counts['pp_issued']} (masked "
          f"{counts['pp_masked']}), {pp_ms:.3f} ms an issued sweep (cache "
          f"builds aside); host pulls {counts['pulls']} in {phases} phases "
          f"({counts['pulls'] / max(phases, 1):.2f} a phase)")


def device_loop_cli(tmp, smi):
    """14a: the 200^3 CLI, f32, -device_loop 0 then 1 (each after a
    3-sweep warm-up): the same (iter, pp) rows, final factors (its
    -checkpoint) within DEVICE_LOOP_FACTOR_TOL, K1-K3 1/1/2 a logged row
    in both. Returns K1-K3's launches."""
    import numpy as np
    from pairwise_perturbation_tpu_torch import cli
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    from pairwise_perturbation_tpu_torch.utils import io, tracing
    runs = {}
    for loop in ("0", "1"):
        argv = DEVICE_LOOP_CLI + ["-device_loop", loop]
        cli_csv(argv + ["-maxiter", "3"], os.path.join(tmp, "warm.csv"))
        tracing.reset()
        mttkrp3.reset_launch_counts()
        cp.reset_device_loop_counts()
        ck = os.path.join(tmp, f"ck{loop}")
        rows = cli_csv(argv + ["-maxiter", "40", "-profile", "1",
                               "-checkpoint", ck],
                       os.path.join(tmp, f"dl{loop}.csv"))
        tracing.enable(False)
        check_csv(rows, f"14a test_als -pp 1 -device_loop {loop} 200^3 f32")
        runs[loop] = (rows, io.load_checkpoint(ck + ".npz")["factors"],
                      tracing.stats(), dict(mttkrp3.LAUNCHES),
                      dict(cp.DEVICE_LOOP_COUNTS))
    (r0, f0, s0, l0, _), (r1, f1, s1, l1, c1) = runs["0"], runs["1"]
    same = [(r[1], r[4]) for r in r0] == [(r[1], r[4]) for r in r1]
    dist = max(float(np.max(np.abs(a - b)) / np.max(np.abs(a)))
               for a, b in zip(f0, f1))
    print(f"14a: the same (iter, pp) rows {same} ({len(r0) - 1} rows, "
          f"{sum(1 for r in r0[1:] if r[4] == '1')} PP); final factors "
          f"{dist:.3e} apart (tol {DEVICE_LOOP_FACTOR_TOL}); [dtime] at the "
          f"last row {r0[-1][6]} s (-device_loop 0), {r1[-1][6]} s (1)")
    n_rows = len(r0) - 1
    for loop, launches in (("0", l0), ("1", l1)):
        got = [launches[m] for m in range(3)]
        # the phase engine warms the exact row statistics once (1/1/2)
        w = int(loop == "1")
        want = [n_rows + w, n_rows + w, 2 * (n_rows + w)]
        print(f"14a -device_loop {loop}: K1-K3 launches {got} (expected "
              f"{want}: 1/1/2 a logged row" + (", and the warm-up's)"
                                                  if w else ")"))
        if got != want:
            raise AssertionError(f"14a -device_loop {loop}: K1-K3 {got}")
    device_loop_report("14a 200^3", "host", s0, None, smi)
    device_loop_report("14a 200^3", "device", s1, c1, smi)
    if not same or not dist <= DEVICE_LOOP_FACTOR_TOL:
        raise AssertionError("14a: the engines' rows or factors differ")
    default = cp.DEVICE_LOOP_CHUNK
    try:
        for chunk in DEVICE_LOOP_CHUNKS:
            cp.DEVICE_LOOP_CHUNK = chunk
            cp.reset_device_loop_counts()
            rows = cli_csv(DEVICE_LOOP_CLI + ["-device_loop", "1",
                                              "-maxiter", "40"],
                           os.path.join(tmp, f"chunk{chunk}.csv"))
            c = cp.DEVICE_LOOP_COUNTS
            print(f"14a chunk of {chunk} sweeps ({smi}): [dtime] at the "
                  f"last row {rows[-1][6]} s; sweeps issued DT "
                  f"{c['dt_issued']} (masked {c['dt_masked']}), PP "
                  f"{c['pp_issued']} (masked {c['pp_masked']}); host pulls "
                  f"{c['pulls']}")
            if [r[:6] for r in rows] != [r[:6] for r in r1]:
                raise AssertionError(f"14a: chunk {chunk} changed the rows")
    finally:
        cp.DEVICE_LOOP_CHUNK = default
    return {f"K{m + 1}": l0[m] + l1[m] for m in range(3)}


def device_loop_coil(V, smi):
    """14b: the coil shape, f32, use_kernels_triple: als_cp_pp and
    als_cp_pp_device from the same factors; K6 (and K5 as its O3) once a
    cache build in both. Returns {kernel id: launches}."""
    import torch
    from pairwise_perturbation_tpu_torch import config, native
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    split, _, _ = native.plan_tree_split_traffic(COIL_SHAPE, 10)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=1,
                      tree_split=split)
    out, launches = {}, {"K5": 0, "K6": 0}
    for eng, fn in (("host", cp.als_cp_pp), ("device", cp.als_cp_pp_device)):
        Ws = cp.init_factors(COIL_SHAPE, 10, seed=0, device="cuda")
        with config.override(use_kernels_triple=True):
            fn(V, [W.clone() for W in Ws], cp.CPConfig(
                tol=0.0, pp_res_tol=0.1, maxiter=2, resprint=1,
                tree_split=split))                      # warm
            tracing.reset()
            _bench.reset_launch_counts()
            cp.reset_device_loop_counts()
            tracing.enable()
            t0 = time.perf_counter()
            with _bench.warm_launches() as warm:
                res = fn(V, Ws, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tracing.enable(False)
        stats, counts = tracing.stats(), _bench.launch_counts()
        builds = stats.get("cp.pp_cache_build", (0,))[0]
        k6, k5 = counts["triple_roots.triple_roots"], \
            counts["last_contract.last_contract"]
        print(f"14b coil {eng} engine: {len(res.history)} rows "
              f"({sum(h['pp'] for h in res.history)} PP), {res.iters} "
              f"sweeps in {wall:.3f} s")
        # one warm-up build each: the host engine's is its first build,
        # the phase engine's is discarded
        for kid, n, key in (("K6", k6, "triple_roots.triple_roots"),
                            ("K5", k5, "last_contract.last_contract")):
            held_apart(f"14b {eng} {kid}", n, warm.get(key, 0), builds, 1,
                       "in-loop cache builds")
        launches["K6"] += k6
        launches["K5"] += k5
        device_loop_report("14b coil", eng, stats,
                           dict(cp.DEVICE_LOOP_COUNTS), smi)
        out[eng] = res
    flags = {e: "".join(str(h["pp"]) for h in r.history)
             for e, r in out.items()}
    dist = factor_distance(out["host"].factors, out["device"].factors, False)
    dv = {e: r.history[-1]["diffV"] for e, r in out.items()}
    rel = abs(dv["device"] - dv["host"]) / dv["host"]
    print(f"14b: pp flags by row, host {flags['host']}, device "
          f"{flags['device']}; final factors {dist:.3e} apart; last "
          f"diffV host {dv['host']!r}, device {dv['device']!r} ({rel:.3e} "
          "apart)")
    if len(flags["host"]) != len(flags["device"]) or \
            "1" not in flags["device"]:
        raise AssertionError("14b: the engines' rows differ in number, or "
                             "the device engine ran no PP phase")
    if flags["host"] == flags["device"]:
        if not dist <= DEVICE_LOOP_FACTOR_TOL:
            raise AssertionError("14b: the same decisions, other factors")
    elif not rel <= DEVICE_LOOP_COIL_DIFFV:
        raise AssertionError("14b: other decisions and a worse fit")
    return launches


def run_phase14(smi):
    """Phase 14 (14a-14c); returns {kernel id: launches}."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils import synth
    t_phase = time.perf_counter()
    phase("14a. test_als -model CP -pp 1 -device_loop 1 beside -device_loop "
          f"0, 200^3 rank 10 f32 (chunks of {cp.DEVICE_LOOP_CHUNK} sweeps)")
    with tempfile.TemporaryDirectory() as tmp:
        launches = device_loop_cli(tmp, smi)
    phase("14b. the two engines at the coil shape, f32, use_kernels_triple")
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.rand(COIL_SHAPE, generator=gen, device="cuda")
    launches.update(device_loop_coil(V, smi))
    phase("14c. syncs per sweep by source, host and device engines")
    # the first switch into the warn mode reports itself once: spend it
    _, first = count_syncs(lambda: None)
    print(f"14c the counter's first use, nothing measured: "
          f"{sync_line(first)}")
    V200 = torch.from_numpy(synth.make_tensor("r", 3, 200, 10, seed=0,
                                              dtype=np.float32)).cuda()
    for label, X in (("200^3", V200), ("coil", V)):
        device_loop_syncs(label, X, cp.init_factors(X.shape, 10, seed=0,
                                                    device="cuda"))
    del V, V200
    torch.cuda.empty_cache()
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# ---------------------------------------------------------------------------
# Phase 15: the fused machines (test_als -device_loop 2), Tucker's device
# engines and bench_pp_e2e
# ---------------------------------------------------------------------------

# Body steps of 15d's single chunks (DT steps, a cache build, PP steps).
FUSED_PROBE_CHUNK = 24
FUSED_STEPS = ("cp.fused_dt_step", "cp.fused_build_step", "cp.fused_pp_step",
               "cp.diagnostics")
# 15c's Tucker runs: 20 sweeps from HOSVD, every row logged.
TUCKER_DEVICE_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=1)


def hist_rows(history, metric):
    """An engine's history as CSV-like rows (values by repr, as the CSV
    writes them; no dim, tol or dtime)."""
    return [["header"]] + [["", str(h["iter"]), repr(h[metric]), "",
                            str(h["pp"]), repr(h["diffV"]), ""]
                           for h in history]


# Why the engines' decisions may part, by model: CP's guard floor is
# seeded with the DT gradnorm in the fused machine and the host engine
# (which reads the last DT sweep's gradnorm first) and at inf in the
# phase engine; the fused Tucker machine caps a PP phase at 15 sweeps,
# the host and phase engines do not.
PART_REASONS = {
    "CP": "the fused machine and the host engine seed the PP guard's floor "
          "with the DT gradnorm, the phase engine at inf: JAX "
          "cp.py:1150-1156",
    "Tucker": "the fused Tucker machine caps a PP phase at 15 sweeps (JAX "
              "tucker.py:1081), the host and phase engines do not"}


def rows_beside_fused(label, rows, model="CP"):
    """Hold -device_loop 0's and 1's rows ({loop: CSV rows}) to 2's. The
    fused row L is the state after L sweeps, flagged by the sweep that
    made it; the host engine's row L is the same state, flagged by the
    phase about to run (so its flag at L - 1 is the fused one at L); the
    phase engine's row L is the state after L + 1 sweeps, flagged as the
    fused row L + 1. The decisions agree while the flags do; prints, for
    each engine, the rows compared, the largest relative difference of
    their two value columns and the first row whose flag parts (returned,
    None where none does)."""
    fused = {int(float(r[1])): r for r in rows["2"][1:]}
    parted = {}
    for loop, shift in (("0", 0), ("1", 1)):
        if loop not in rows:
            continue
        body = rows[loop][1:]
        by = {int(float(r[1])): r for r in body}
        first, n, rel = None, 0, 0.0
        for r in body:
            it = int(float(r[1]))
            want = fused.get(it + shift)
            if want is None:
                continue
            if want[4] != (r[4] if shift else by.get(it - 1, want)[4]):
                first = (it, r, want)
                break
            n += 1
            for c in (2, 5):
                a, b = float(r[c]), float(want[c])
                if a != b:
                    rel = max(rel, abs(a - b) / max(abs(b), 1e-300))
        if first is None and n < len(body) - 1:
            raise AssertionError(f"{label}: -device_loop {loop} has "
                                 f"{len(body)} rows, {n} beside the fused")
        parted[loop] = first
        line = (f"{label}: -device_loop {loop} beside 2: {n} rows with the "
                f"same decisions, values at most {rel:.3e} apart")
        if first is not None:
            it, r, want = first
            line += (f"; parts at its row {it}: {r[1:6]} against the fused "
                     f"row {want[1:6]} (from there other decisions; a "
                     f"likely reason: {PART_REASONS[model]})")
        print(line)
    return parted


def fused_cp_cli(tmp, smi):
    """15a: the 200^3 CLI, f32, -device_loop 0, 1 and 2 from the same
    factors (each after a 3-sweep warm-up): the rows beside the fused
    run's, final factors bit for bit where no row parts (else the last
    diffV within DEVICE_LOOP_COIL_DIFFV of the host engine's), K1-K3 1/1/2
    a logged row plus the final call; each engine again in reverse order
    (its [dtime], its rows unchanged); then -profile runs for ms a body
    step. Returns K1-K3's launches of the first runs."""
    import numpy as np
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    from pairwise_perturbation_tpu_torch.utils import io, tracing
    rows, factors, launches, counts = {}, {}, {}, {}
    for loop in ("0", "1", "2"):
        argv = DEVICE_LOOP_CLI + ["-device_loop", loop]
        cli_csv(argv + ["-maxiter", "3"], os.path.join(tmp, "warm.csv"))
        mttkrp3.reset_launch_counts()
        cp.reset_device_loop_counts()
        ck = os.path.join(tmp, f"f{loop}")
        rows[loop] = cli_csv(argv + ["-maxiter", "40", "-checkpoint", ck],
                             os.path.join(tmp, f"f{loop}.csv"))
        check_csv(rows[loop], f"15a test_als -pp 1 -device_loop {loop} "
                  "200^3 f32")
        factors[loop] = io.load_checkpoint(ck + ".npz")["factors"]
        launches[loop] = [mttkrp3.LAUNCHES[m] for m in range(3)]
        counts[loop] = dict(cp.DEVICE_LOOP_COUNTS)
    parted = rows_beside_fused("15a 200^3", rows)
    dist = {loop: max(float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                      for a, b in zip(factors[loop], factors["2"]))
            for loop in ("0", "1")}
    print("15a final factors against the fused run's: " + ", ".join(
        f"-device_loop {k} {d:.3e}" for k, d in dist.items())
        + "; [dtime] at the last row: " + ", ".join(
            f"-device_loop {k} {rows[k][-1][6]} s ({rows[k][-1][1]})"
            for k in rows) + f" ({smi})")
    for loop, first in parted.items():
        if first is None and dist[loop] != 0.0:
            raise AssertionError(f"15a: the same rows, other factors "
                                 f"(-device_loop {loop})")
        if first is not None:
            a, b = float(rows["2"][-1][5]), float(rows[loop][-1][5])
            print(f"15a -device_loop {loop}: last diffV {b!r}, fused {a!r}")
            if not abs(a - b) <= DEVICE_LOOP_COIL_DIFFV * b:
                raise AssertionError("15a: other decisions and another fit")
    for loop in rows:
        # the final exact call of the fused machine, and one warm-up of
        # the exact statistics in each device engine
        n = len(rows[loop]) - 1 + (loop == "2") + (loop != "0")
        want = [n, n, 2 * n]
        print(f"15a -device_loop {loop}: K1-K3 launches {launches[loop]} "
              f"(expected {want}: 1/1/2 a logged row"
              + (", the final exact call" if loop == "2" else "")
              + (" and the warm-up's)" if loop != "0" else ")"))
        if launches[loop] != want:
            raise AssertionError(f"15a: K1-K3 {launches[loop]}")
    # [dtime] again in turns (fused, phase, host), the same rows
    for loop in ("2", "1", "0"):
        again = cli_csv(DEVICE_LOOP_CLI + ["-device_loop", loop, "-maxiter",
                                           "40"],
                        os.path.join(tmp, "again.csv"))
        print(f"15a -device_loop {loop} again: [dtime] at the last row "
              f"{again[-1][6]} s ({smi})")
        if [r[:6] for r in again] != [r[:6] for r in rows[loop]]:
            raise AssertionError(f"15a -device_loop {loop}: a rerun "
                                 "changed the rows")
    c = counts["2"]
    sweeps = c["fused_dt"] + c["fused_pp"]
    print(f"15a fused body steps: DT {c['fused_dt']}, cache builds "
          f"{c['fused_build']}, PP {c['fused_pp']} in {c['fused_chunks']} "
          f"chunks; pulls {c['fused_pulls']} ({c['fused_pulls'] / sweeps:.2f}"
          f" a sweep; the phase engine's {counts['1']['pulls'] / sweeps:.2f},"
          " the host engine's 1 ratio pull a sweep)")
    for loop, names in (("0", CP_PHASES), ("1", DEVICE_PHASES),
                        ("2", FUSED_STEPS)):
        tracing.reset()
        cli_csv(DEVICE_LOOP_CLI + ["-device_loop", loop, "-maxiter", "40",
                                   "-profile", "1"],
                os.path.join(tmp, "profile.csv"))
        tracing.enable(False)
        print(f"15a -device_loop {loop} -profile 1 scope medians, ms "
              f"({smi}): " + scope_line(tracing.stats(), names))
    return {f"K{m + 1}": sum(l[m] for l in launches.values())
            for m in range(3)}


def fused_cp_coil(V, smi):
    """15b: the coil shape, f32, use_kernels_triple: cp.als_cp_pp and
    cp.als_cp_pp_fused from the same factors; K6 and K5 once a cache
    build in each; the rows beside each other, and the same factors where
    they never part, else the fit within DEVICE_LOOP_COIL_DIFFV. Returns
    {kernel id: launches}."""
    import torch
    from pairwise_perturbation_tpu_torch import config, native
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    split, _, _ = native.plan_tree_split_traffic(COIL_SHAPE, 10)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=1,
                      tree_split=split)
    out, launches = {}, {"K5": 0, "K6": 0}
    for eng, fn in (("0", cp.als_cp_pp), ("2", cp.als_cp_pp_fused)):
        Ws = cp.init_factors(COIL_SHAPE, 10, seed=0, device="cuda")
        with config.override(use_kernels_triple=True):
            fn(V, [W.clone() for W in Ws], cp.CPConfig(
                tol=0.0, pp_res_tol=0.1, maxiter=2, resprint=1,
                tree_split=split))                      # warm
            tracing.reset()
            _bench.reset_launch_counts()
            cp.reset_device_loop_counts()
            tracing.enable()
            t0 = time.perf_counter()
            with _bench.warm_launches() as warm:
                res = fn(V, Ws, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tracing.enable(False)
        stats, counts = tracing.stats(), _bench.launch_counts()
        c = dict(cp.DEVICE_LOOP_COUNTS)
        builds = c["fused_build"] if eng == "2" else \
            stats.get("cp.pp_cache_build", (0,))[0]
        k6, k5 = counts["triple_roots.triple_roots"], \
            counts["last_contract.last_contract"]
        print(f"15b coil -device_loop {eng}: {len(res.history)} rows "
              f"({sum(h['pp'] for h in res.history)} PP), {res.iters} sweeps "
              f"in {wall:.3f} s ({smi}); scope medians, ms: "
              + scope_line(stats, CP_PHASES if eng == "0" else FUSED_STEPS))
        # one warm-up build each: the host engine's is its first build,
        # the fused machine's (on a carry of its own) is discarded
        for kid, n, key in (("K6", k6, "triple_roots.triple_roots"),
                            ("K5", k5, "last_contract.last_contract")):
            held_apart(f"15b {eng} {kid}", n, warm.get(key, 0), builds, 1,
                       "in-loop cache builds")
        launches["K6"] += k6
        launches["K5"] += k5
        out[eng] = res
    rows = {e: hist_rows(r.history, "gradnorm") for e, r in out.items()}
    parted = rows_beside_fused("15b coil", rows)["0"]
    dist = factor_distance(out["0"].factors, out["2"].factors, False)
    a, b = out["2"].diffV, out["0"].diffV
    print(f"15b final factors {dist:.3e} apart; exact diffV of the final "
          f"factors: host {b!r}, fused {a!r} ({abs(a - b) / b:.3e} apart)")
    if parted is None and dist != 0.0:
        raise AssertionError("15b: the same rows, other factors")
    if parted is not None and not abs(a - b) <= DEVICE_LOOP_COIL_DIFFV * b:
        raise AssertionError("15b: other decisions and a worse fit")
    return launches


# The scopes of Tucker's engines, by -device_loop.
TUCKER_SCOPES = {
    "0": TUCKER_PHASES,
    "1": ("tucker.hosvd", "tucker.dt_phase_device", "tucker.pp_phase_device",
          "tucker.pp_cache_build", "tucker.diagnostics"),
    "2": ("tucker.hosvd", "tucker.fused_dt_step", "tucker.fused_build_step",
          "tucker.fused_pp_step", "tucker.diagnostics")}


def tucker_held(label, V, ranks, rows, factors):
    """15c's checks: the rows ({loop: CSV rows}) beside the fused run's;
    every engine's fit ({loop: factors}) by a float64 reconstruction no
    worse than HOSVD's (F64_RECON_MARGIN); the phase and fused engines'
    factors bit for bit where their decisions agree (both run maxiter + 1
    sweeps; the host engine stops at maxiter)."""
    import torch
    from pairwise_perturbation_tpu_torch.models import tucker
    parted = rows_beside_fused(label, rows, "Tucker")
    start = direct_residual(V, tucker.hosvd(V, ranks)[1])
    ends = {k: direct_residual(V, f) for k, f in factors.items()}
    print(f"{label}: ||V - V^|| by float64 reconstruction, HOSVD {start!r}; "
          + ", ".join(f"-device_loop {k} {e!r}" for k, e in ends.items()))
    for k, e in ends.items():
        if not e <= start * (1.0 + F64_RECON_MARGIN):
            raise AssertionError(f"{label} -device_loop {k}: worse fit")
    same = all(torch.equal(a, b) for a, b in zip(factors["1"],
                                                  factors["2"]))
    print(f"{label}: -device_loop 1 and 2 final factors bit for bit {same}")
    if parted["1"] is None and not same:
        raise AssertionError(f"{label}: the same decisions, other factors")


def tucker_device_coil(smi):
    """15c at the coil shape, ranks (3, 10, 10, 70), f32: phase 9a's
    seeded low-Tucker-rank tensor plus 1% noise, the three engines from
    HOSVD (each timed with its scopes, no port kernel launched)."""
    from pairwise_perturbation_tpu_torch.models import tucker
    V = low_tucker_rank_tensor(COIL_SHAPE, COIL_TUCKER_RANKS, seed=15)
    rows, factors = {}, {}
    for loop, fn in (("0", tucker.als_tucker_pp),
                     ("1", tucker.als_tucker_pp_device),
                     ("2", tucker.als_tucker_pp_fused)):
        label = f"15c Tucker coil -device_loop {loop}"
        start_tucker_trace()
        t0 = time.perf_counter()
        res = fn(V, COIL_TUCKER_RANKS, tucker.TuckerConfig(
            **TUCKER_DEVICE_CFG))
        wall = time.perf_counter() - t0
        print(f"{label}: {len(res.history)} rows "
              f"({sum(h['pp'] for h in res.history)} PP), {res.iters} "
              f"sweeps in {wall:.3f} s")
        tucker_report(label, smi, names=TUCKER_SCOPES[loop])
        rows[loop] = hist_rows(res.history, "diffnorm")
        factors[loop] = res.factors
    tucker_held("15c Tucker coil", V, COIL_TUCKER_RANKS, rows, factors)


def tucker_device_cli(tmp, smi):
    """15c: the 200^3 Tucker CLI (tensor r2, -pp 1, f32) under
    -device_loop 0, 1 and 2: CSVs checked, rows beside the fused run's,
    fits by a float64 reconstruction of the -checkpoint factors."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch.utils import io, synth
    rows, factors = {}, {}
    for loop in ("0", "1", "2"):
        label = ("15c CLI test_als -model Tucker -tensor r2 -device_loop "
                 f"{loop}")
        start_tucker_trace()
        ck = os.path.join(tmp, f"t{loop}")
        rows[loop] = cli_csv(TUCKER_CLI + ["-tensor", "r2", "-pp", "1",
                                           "-dtype", "float32",
                                           "-device_loop", loop,
                                           "-checkpoint", ck],
                             os.path.join(tmp, f"t{loop}.csv"))
        # the fused run's row 0 holds diffnorm inf (no earlier core norm),
        # as the JAX engine's does
        check_tucker_csv(rows[loop][:1] + rows[loop][1 + (loop == "2"):],
                         label, pp=True, fit=False)
        tucker_report(label, smi, names=TUCKER_SCOPES[loop])
        factors[loop] = [torch.from_numpy(w).cuda() for w in
                         io.load_checkpoint(ck + ".npz")["factors"]]
    V = torch.from_numpy(synth.make_tensor("r2", 3, 200, 10, seed=0,
                                           dtype=np.float32)).cuda()
    tucker_held("15c CLI 200^3", V, (10, 10, 10), rows, factors)


def fused_syncs(smi):
    """15d: one chunk of FUSED_PROBE_CHUNK body steps of each fused
    machine at 200^3 rank 10, f32, from its start (DT steps, a cache
    build, PP steps), under count_syncs: syncs per body step by source,
    the steps by kind and the pulls of the chunk; then the host loop's
    pulls a chunk (history, ring count, labels: 3)."""
    import numpy as np
    import torch
    from pairwise_perturbation_tpu_torch.models import cp, tucker
    from pairwise_perturbation_tpu_torch.ops import contract
    from pairwise_perturbation_tpu_torch.utils import synth
    V = torch.from_numpy(synth.make_tensor("r", 3, 200, 10, seed=0,
                                           dtype=np.float32)).cuda()
    Ws = cp.init_factors(V.shape, 10, seed=0, device="cuda")
    vn2 = contract.norm_sq(V)
    V2 = torch.from_numpy(synth.make_tensor("r2", 3, 200, 10, seed=0,
                                            dtype=np.float32)).cuda()
    for name, make, step in (
            ("CP", lambda: cp.pp_fused_init(V, Ws, 42, 12),
             lambda c: cp.pp_fused_chunk(
                 V, c, 0.0, 1.0, 0.1, 0.0, 40, 10.0,
                 chunk=FUSED_PROBE_CHUNK, resprint=1, n_slots=12,
                 V_norm_sq=vn2)),
            ("Tucker", lambda: tucker.tucker_fused_init(
                V2, tucker.hosvd(V2, (10, 10, 10))[1], (10, 10, 10), 42, 12,
                0.3),
             lambda c: tucker.tucker_fused_chunk(
                 V2, c, 0.0, 40, 0.9, 5e-3, ranks=(10, 10, 10),
                 chunk=FUSED_PROBE_CHUNK, resprint=1, n_slots=12))):
        step(make())                                    # warm
        carry = make()
        cp.reset_device_loop_counts()
        torch.cuda.synchronize()
        _, syncs = count_syncs(lambda: step(carry))
        c = cp.DEVICE_LOOP_COUNTS
        steps = c["fused_dt"] + c["fused_build"] + c["fused_pp"]
        print(f"15d fused {name} 200^3, one chunk of {steps} body steps "
              f"(DT {c['fused_dt']}, build {c['fused_build']}, PP "
              f"{c['fused_pp']}): syncs a body step "
              f"{sync_line(syncs, steps)}; register pulls {c['fused_pulls']}"
              " in the chunk (one a DT or PP step), and the host loop's 3 a "
              f"chunk (history, ring count, labels) ({smi})")


def run_bench_pp_e2e(tmp, smi):
    """15e: the ported bench_pp_e2e --quick on the card, writing only
    into ``tmp``: each config's DT and PP times to the target, the rule
    and pp_row_fraction; asserts finite rows (no claim on the speed-up).
    Returns {kernel id: launches} of the run."""
    from pairwise_perturbation_tpu_torch.scripts import _bench, bench_pp_e2e
    _bench.reset_launch_counts()
    out = os.path.join(tmp, "e2e")
    t0 = time.perf_counter()
    if bench_pp_e2e.main(["--quick", "--out", out]) != 0:
        raise AssertionError("bench_pp_e2e --quick failed")
    wall = time.perf_counter() - t0
    with open(os.path.join(out, "pp_e2e.json")) as fh:
        entries = json.load(fh)
    for name, e in sorted(entries.items()):
        print(f"15e {name} {e['shape']} rank {e['rank']}: DT "
              f"{e['dt_time_to_target']} s, PP {e['pp_time_to_target']} s to "
              f"{e['target_diffV']!r} ({e['fitness_rule']}); full runs DT "
              f"{e['dt_total_dtime']!r} s, PP {e['pp_total_dtime']!r} s "
              f"({e['dt_iters']}, {e['pp_iters']} sweeps); pp_row_fraction "
              f"{e['pp_row_fraction']:.3f}; speed-up {e['speedup']} ({smi})")
        if not (e["dt_rows_finite"] and e["pp_rows_finite"]):
            raise AssertionError(f"15e {name}: non-finite rows")
    if len(entries) != 4:
        raise AssertionError(f"15e: {sorted(entries)}")
    counts = _bench.launch_counts()
    print(f"15e: {wall:.1f} s; kernel launches "
          f"{ {k: n for k, n in counts.items() if n} or 'none'}")
    return {f"K{m + 1}": counts[f"mttkrp3.{m}"] for m in range(3)}


def run_phase15(smi):
    """Phase 15 (15a-15e); returns {kernel id: launches}."""
    import torch
    t_phase = time.perf_counter()
    phase("15a. test_als -model CP -pp 1 -device_loop 2 beside -device_loop "
          "0 and 1, 200^3 rank 10 f32")
    with tempfile.TemporaryDirectory() as tmp:
        launches = fused_cp_cli(tmp, smi)
    phase("15b. the fused machine beside the host engine at the coil shape, "
          "f32, use_kernels_triple")
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.rand(COIL_SHAPE, generator=gen, device="cuda")
    launches.update(fused_cp_coil(V, smi))
    del V
    torch.cuda.empty_cache()
    phase("15c. Tucker -device_loop 0, 1, 2: coil ranks (3, 10, 10, 70) and "
          "the 200^3 CLI, f32")
    tucker_device_coil(smi)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tucker_device_cli(tmp, smi)
    phase("15d. syncs per body step by source and pulls per chunk, fused CP "
          "and Tucker at 200^3")
    fused_syncs(smi)
    phase("15e. bench_pp_e2e --quick (DT against the fused machine)")
    with tempfile.TemporaryDirectory() as tmp:
        for kid, n in run_bench_pp_e2e(tmp, smi).items():
            launches[kid] += n
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# ---------------------------------------------------------------------------
# Phase 16: dtime's warm-ups (C12), the device engines under -mesh, -layouts
# ---------------------------------------------------------------------------

# 16a: each run in a fresh process, with the engines' warm-ups
# (models/cp.warm_run) and with each replaced by a no-op: the first DT
# step of a -device_loop 0 run must stay within C12_FIRST_STEP_MAX of the
# later DT steps' median.
C12_FIRST_STEP_MAX = 2.0
C12_CLI = ["test_als", "-model", "CP", "-tensor", "r", "-pp", "1", "-dim",
           "3", "-size", "200", "-rank", "10", "-maxiter", "30",
           "-resprint", "1", "-pp_res_tol", "0.1"]
# The fresh process: argv[1] is a JSON spec ("cli": test_als's argv, or
# "coil": CP-PP at the coil shape with use_kernels_triple; "warm": whether
# the warm-ups run). It times each warm-up by the function it warms and
# the kernels' library load, and prints one JSON line: the logged rows
# [iter, pp, dtime], those seconds, and the card's name.
C12_PROGRAM = r'''
import csv, json, os, sys, tempfile, time
spec = json.loads(sys.argv[1])
import torch
from pairwise_perturbation_tpu_torch import cli, config, native
from pairwise_perturbation_tpu_torch.models import cp
from pairwise_perturbation_tpu_torch.ops.kernels import _build
parts, loads = {}, []
real_warm, real_load = cp.warm_run, _build.load

def warm(fn, *a, **k):
    if not spec["warm"]:
        return None
    t0 = time.perf_counter()
    try:
        return real_warm(fn, *a, **k)
    finally:
        name = getattr(fn, "__name__", "?")
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0

def load():
    if _build._lib is not None:
        return _build._lib
    t0 = time.perf_counter()
    try:
        return real_load()
    finally:
        loads.append(time.perf_counter() - t0)

cp.warm_run, _build.load = warm, load
config.apply_fp32_pins()
if spec.get("cli"):
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "c12.csv")
        if cli.main(spec["cli"] + ["-quiet", "-filename", out]) != 0:
            raise SystemExit("test_als failed")
        with open(out) as fh:
            rows = [[float(r[1]), float(r[4]), float(r[6])]
                    for r in list(csv.reader(fh))[1:]]
else:
    shape = tuple(spec["coil"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.rand(shape, generator=gen, device="cuda")
    Ws = cp.init_factors(shape, 10, seed=0, device="cuda")
    split = native.plan_tree_split_traffic(shape, 10)[0]
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=1,
                      tree_split=split)
    with config.override(use_kernels_triple=True):
        res = cp.als_cp_pp(V, Ws, cfg)
    rows = [[h["iter"], h["pp"], h["dtime"]] for h in res.history]
print(json.dumps(dict(rows=rows, parts=parts, loads=loads,
                      card=torch.cuda.get_device_name(0))))
'''
# 16b: two ranks on the card, as phases 12-13 run them; the rows and
# factors of each sharded device engine held to one process's run.
DL_MESH_CP_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=1)
DL_MESH_COIL_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=10, resprint=1)
DL_MESH_TK_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=10, resprint=1)
DL_ENGINES = {"dcl1": "als_cp_pp_device", "dcl2": "als_cp_pp_fused",
              "dtl1": "als_tucker_pp_device", "dtl2": "als_tucker_pp_fused"}
# 16c: layouts off, then on; each run's last diffV within this of the off
# run's (float32; the copies change the order of no sum, but a contraction
# over a copy may round in another order).
LAYOUTS_DIFFV = 1e-3
LAYOUTS_512 = ["test_als", "-model", "CP", "-tensor", "r", "-dim", "3",
               "-size", "512", "-rank", "10", "-maxiter", "12",
               "-resprint", "1", "-pp_res_tol", "0.1"]


def c12_steps(rows):
    """(first DT step, median of the later DT steps, DT steps) of rows
    [iter, pp, dtime]: a DT row's step is its dtime less the row before's,
    where both are consecutive DT rows."""
    steps = [b[2] - a[2] for a, b in zip(rows, rows[1:])
             if a[1] == 0 and b[1] == 0 and b[0] == a[0] + 1]
    if len(steps) < 3:
        raise AssertionError(f"16a: {len(steps)} DT steps in {rows}")
    return steps[0], statistics.median(steps[1:]), len(steps)


def c12_fresh(spec):
    """C12_PROGRAM in a fresh process on ``spec``; its JSON line."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", C12_PROGRAM,
                          json.dumps(spec)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"16a fresh process {spec}: exit "
                             f"{out.returncode}\n{out.stderr[-4000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    got["wall"] = time.perf_counter() - t0
    return got


def run_c12(smi):
    """16a: the first DT step against the later ones, fresh processes,
    warm-ups on and off."""
    cases = [(f"200^3 -device_loop {loop}",
              dict(cli=C12_CLI + ["-device_loop", str(loop)]), loop == 0)
             for loop in (0, 1, 2)]
    cases.append(("coil use_kernels_triple -device_loop 0",
                  dict(coil=list(COIL_SHAPE)), True))
    failures = []
    for label, spec, held in cases:
        # without warm-ups only where the first step is held: the device
        # engines' rows share a phase's or a chunk's time
        res = {w: c12_fresh(dict(spec, warm=w))
               for w in ((False, True) if held else (True,))}
        f1, m1, n1 = c12_steps(res[True]["rows"])
        print(f"16a {label} ({smi}): first DT step {1e3 * f1:.3f} ms, "
              f"median of the later {n1 - 1} DT steps {1e3 * m1:.3f} ms "
              f"(ratio {f1 / m1:.2f}" + (f", held to {C12_FIRST_STEP_MAX})"
                                         if held else ", not held: rows "
                                         "share a phase's or a chunk's "
                                         "time)"))
        if held:
            f0, m0, _ = c12_steps(res[False]["rows"])
            print(f"  without warm-ups {1e3 * f0:.3f} / {1e3 * m0:.3f} ms "
                  f"(ratio {f0 / m0:.2f}): the warm-ups removed "
                  f"{1e3 * (f0 - f1):.3f} ms of the first step's excess "
                  f"{1e3 * (f0 - m0):.3f} ms")

        def ms(xs):
            return ", ".join(f"{1e3 * x:.3f}" for x in xs) or "not called"
        print("  warm-up seconds by function: " + ", ".join(
            f"{k} {1e3 * v:.3f} ms" for k, v in res[True]["parts"].items())
            + f"; _build.load() {ms(res[True]['loads'])} ms inside a "
            "warm-up" + (f", {ms(res[False]['loads'])} ms without warm-ups"
                         " (inside dtime)" if held else "")
            + "; process walls " + ", ".join(
                f"{r['wall']:.1f}" for r in res.values()) + " s")
        if held and not f1 <= C12_FIRST_STEP_MAX * m1:
            failures.append(f"16a {label}: first DT step {f1} s against "
                            f"the median {m1} s")
    if failures:
        raise AssertionError("; ".join(failures))


def dl_mesh_inputs(path, tmp, V, Ws, Vt=None, loops=(1, 2), config=None,
                   cfg=None, mesh=(MESH_RANKS,)):
    """A 16b cluster's inputs: V (and Tucker's Vt) as .npy files each rank
    memory-maps its block of, the CP factors, the device engines to run."""
    import numpy as np
    d = dict(dd_mesh=np.asarray(mesh), dc_vfile=os.path.join(tmp, "V.npy"),
             dc_cfg=json.dumps(cfg), dc_pp=np.asarray([], np.int64),
             dc_loops=np.asarray(loops),
             dc_config=json.dumps(config or {}))
    np.save(d["dc_vfile"], V.cpu().numpy())
    for i, W in enumerate(Ws):
        d[f"dc_W{i}"] = W.cpu().numpy()
    if Vt is not None:
        d.update(dt_vfile=os.path.join(tmp, "Vt.npy"),
                 dt_ranks=np.asarray(COIL_TUCKER_RANKS), dt_host=0,
                 dt_loops=np.asarray(loops),
                 dt_tk_cfg=json.dumps(DL_MESH_TK_CFG))
        np.save(d["dt_vfile"], Vt.cpu().numpy())
    np.savez(path, **d)


def dl_one(tag, V, Ws, d, cfg, over=None):
    """One process's run of the device engine ``tag`` (DL_ENGINES): its
    result, scope stats and wall seconds."""
    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import cp, tucker
    from pairwise_perturbation_tpu_torch.utils import tracing
    dtype = getattr(torch, d)
    tracing.reset()
    tracing.enable()
    t0 = time.perf_counter()
    with config.override(**(over or {})):
        if tag.startswith("dc"):
            res = getattr(cp, DL_ENGINES[tag])(
                V.to(dtype), [W.to(dtype) for W in Ws], cp.CPConfig(**cfg))
        else:
            res = getattr(tucker, DL_ENGINES[tag])(
                V.to(dtype), COIL_TUCKER_RANKS,
                tucker.TuckerConfig(**DL_MESH_TK_CFG))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracing.enable(False)
    return res, tracing.stats(), wall


def dl_held(label, res, tags, dtypes, V, Ws, cfg, smi, over=None, Vt=None):
    """Each device engine ``tags`` x ``dtypes`` of a cluster against one
    process's run: the ranks bit for bit, then held_engine (float64 by the
    rows and factors, float32 CP by the fit, float32 Tucker by the rows,
    the factor subspaces and a float64 reconstruction of the fit).
    Returns the failures."""
    failures = []
    for tag in tags:
        tucker = tag.startswith("dt")
        for d in dtypes:
            check_ranks_equal(res, f"{label} {tag} {d}",
                              [f"sha/{tag}_hist/{d}"] + [
                                  f"sha/{tag}_W/{d}/{i}"
                                  for i in range(len(Ws))])
            one, stats, wall = dl_one(tag, Vt if tucker else V, Ws, d, cfg,
                                      over)
            # float32 Tucker's CSV diffV (the norm identity) does not
            # resolve the fit at the coil shape: it is held as 9a holds
            # it, by the factor subspaces and a float64 reconstruction
            f32_tucker = tucker and d == "float32"
            label_e = f"{label} {DL_ENGINES[tag]} mesh=2 {d}"
            _, bad = held_engine(
                label_e, res[0], tag, d, one, stats, wall, smi,
                tucker=tucker,
                names=(TUCKER_SCOPES["1"] + TUCKER_SCOPES["2"][1:]) if tucker
                else DEVICE_PHASES + FUSED_STEPS,
                tol=dict(float32=F32_SUBSPACE_TOL) if f32_tucker
                else DENSE_FACTOR_TOL,
                by_fit=d == "float32" and not tucker, same_iters=False)
            failures += [bad] if bad else []
            if f32_tucker:
                import torch
                mine = [torch.from_numpy(res[0][f"{tag}_W/{d}/{i}"]).cuda()
                        for i in range(len(one.factors))]
                r2 = direct_residual(Vt, mine)
                r1 = direct_residual(Vt, one.factors)
                rel = abs(r2 - r1) / r1
                print(f"  ||V - V^|| by float64 reconstruction: 2 ranks "
                      f"{r2!r}, one process {r1!r}, relative {rel:.3e} (tol "
                      f"{F32_RESIDUAL_TOL:g})")
                if rel > F32_RESIDUAL_TOL:
                    failures.append(f"{label_e}: the fit left one "
                                    "process's")
    return failures


def run_dl_mesh(tmp, smi):
    """16b: the device engines on 2 ranks (200^3 CP f64 and f32, K1-K3 on
    each rank's block in the exact rows; the coil CP f32 with K6, and coil
    Tucker f32), a world of one on NCCL; returns {kernel id: launches}."""
    import torch
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
        WORKER
    launches = {"K1": 0, "K2": 0, "K3": 0, "K5": 0, "K6": 0}
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(16)
    V = torch.rand((200, 200, 200), generator=gen, device="cuda")
    Ws = cp.init_factors(V.shape, 10, seed=0, dtype=torch.float64,
                         device="cuda")
    inp = os.path.join(tmp, "c.npz")
    dl_mesh_inputs(inp, tmp, V, Ws, cfg=DL_MESH_CP_CFG)
    run_mesh_cluster(MESH_RANKS, WORKER + [
        "--inputs", inp, "--outdir", os.path.join(tmp, "c"), "--tasks",
        "dcp"], "16b cluster C (200^3 CP device engines)")
    c = worker_results(os.path.join(tmp, "c"))
    failures += dl_held("16b 200^3", c, ("dcl1", "dcl2"),
                        ("float64", "float32"), V, Ws, DL_MESH_CP_CFG, smi)
    for r, res in enumerate(c):
        for tag in ("dcl1", "dcl2"):
            n = json.loads(str(res[f"{tag}_launches/float32"]))
            k = [n[f"mttkrp3.{m}"] for m in range(3)]
            rows = len(res[f"{tag}_hist/float32"])
            # 1/1/2 a logged row, the warm-up's, and the fused machine's
            # final exact call
            w = rows + 1 + (tag == "dcl2")
            print(f"16b rank {r} {DL_ENGINES[tag]} f32: K1-K3 {k} on its "
                  f"block (100, 200, 200), expected {[w, w, 2 * w]}")
            if k != [w, w, 2 * w]:
                failures.append(f"16b rank {r} {tag}: K1-K3 {k}")
            for m in range(3):
                launches[f"K{m + 1}"] += k[m]
    for tag in ("dcl1", "dcl2"):
        stats = json.loads(str(c[0][f"{tag}_stats/float64"]))
        red = stats.get("mesh.all_reduce", (0, 0.0))
        print(f"16b {DL_ENGINES[tag]} 200^3 f64 rank 0 ({smi}): "
              f"mesh.all_reduce {red[0]} calls, {red[1]:.3f} s of "
              f"{float(c[0][f'{tag}_wall/float64']):.3f} s")
    del c
    phase("16b. world of one on NCCL: torchrun --nproc_per_node 1, the "
          "200^3 CP device engines f64 on a (1,) mesh, bit for bit")
    inp1 = os.path.join(tmp, "c1.npz")
    dl_mesh_inputs(inp1, tmp, V, Ws, cfg=DL_MESH_CP_CFG, mesh=(1,))
    out = run_mesh_cluster(1, WORKER + [
        "--inputs", inp1, "--outdir", os.path.join(tmp, "c1"), "--tasks",
        "dcp", "--dtypes", "float64"], "16b world of one")
    one = worker_results(os.path.join(tmp, "c1"), 1)[0]
    if str(one["backend"]) != "nccl":
        raise AssertionError(f"16b world of one: backend {one['backend']}")
    for tag in ("dcl1", "dcl2"):
        ref, _, _ = dl_one(tag, V, Ws, "float64", DL_MESH_CP_CFG)
        want = [[h["iter"], h["gradnorm"], h["diffV"], h["pp"]]
                for h in ref.history]
        got = one[f"{tag}_hist/float64"].tolist()
        stats = json.loads(str(one[f"{tag}_stats/float64"]))
        red = stats.get("mesh.all_reduce", (0, 0.0))
        print(f"16b world of one {DL_ENGINES[tag]}: rows bit for bit "
              f"{got == want} ({len(got)} rows); mesh.all_reduce "
              f"{red[0]} calls {red[1]:.3f} s")
        if got != want:
            failures.append(f"16b world of one {tag}: rows differ")
    del V
    torch.cuda.empty_cache()
    phase("16b. the coil shape on 2 ranks: CP device engines f32 with K6 "
          "(use_kernels_triple), Tucker's at ranks (3, 10, 10, 70) f32")
    Vc = torch.rand(COIL_SHAPE, generator=gen, device="cuda")
    Wc = cp.init_factors(COIL_SHAPE, 10, seed=0, dtype=torch.float64,
                         device="cuda")
    Vt = low_tucker_rank_tensor(COIL_SHAPE, COIL_TUCKER_RANKS, seed=16)
    over = dict(use_kernels_triple=True)
    inp = os.path.join(tmp, "d.npz")
    dl_mesh_inputs(inp, tmp, Vc, Wc, Vt, config=over, cfg=DL_MESH_COIL_CFG)
    run_mesh_cluster(MESH_RANKS, WORKER + [
        "--inputs", inp, "--outdir", os.path.join(tmp, "d"), "--tasks",
        "dcp,dtucker", "--dtypes", "float32"],
        "16b cluster D (coil device engines)")
    dres = worker_results(os.path.join(tmp, "d"))
    failures += dl_held("16b coil", dres, ("dcl1", "dcl2", "dtl1", "dtl2"),
                        ("float32",), Vc, Wc, DL_MESH_COIL_CFG, smi, over,
                        Vt)
    for r, res in enumerate(dres):
        for tag in ("dcl1", "dcl2"):
            n = json.loads(str(res[f"{tag}_launches/float32"]))
            warm = json.loads(str(res[f"{tag}_warm/float32"]))
            stats = json.loads(str(res[f"{tag}_stats/float32"]))
            builds = stats.get("cp.pp_cache_build", (0,))[0] \
                if tag == "dcl1" else stats.get("cp.fused_build_step",
                                                (0,))[0]
            for kid, key in (("K6", "triple_roots.triple_roots"),
                             ("K5", "last_contract.last_contract")):
                try:
                    held_apart(f"16b rank {r} {tag} {kid}", n[key],
                               warm.get(key, 0), builds, 1, "cache builds")
                except AssertionError as e:
                    failures.append(str(e))
                launches[kid] += n[key]
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def layouts_run(label, fn, smi):
    """One -layouts run: ``fn()`` -> (rows [iter, pp, diffV], DT sweep
    samples s) under the scopes, with the card's peak memory."""
    import torch
    from pairwise_perturbation_tpu_torch.utils import tracing
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tracing.reset()
    tracing.enable()
    try:
        rows, scope = fn()
    finally:
        tracing.enable(False)
    samples = tracing.samples(scope)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(samples[1:] or samples)
    print(f"16c {label} ({smi}): {len(rows)} rows, last diffV "
          f"{rows[-1][2]!r}; {scope} median {1e3 * med:.3f} ms "
          f"({len(samples)} calls); peak memory {peak:.2f} GiB")
    return rows, med, peak


def layouts_copy_ms(label, V, Ws, split, layouts, smi):
    """Device ms of one DT sweep and of its copy kernels (torch.profiler,
    device events only)."""
    from pairwise_perturbation_tpu_torch import phase_profile
    from pairwise_perturbation_tpu_torch.models import cp
    busy, per = phase_profile.profile(lambda: cp.dt_sweep(
        V, Ws, 0.0, root_split=split, layouts=layouts), "cuda", 5)
    copy = sum(v for k, v in per.items() if "copy" in k.lower())
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    print(f"16c {label} DT sweep ({smi}): device {busy:.3f} ms, copy "
          f"kernels {copy:.3f} ms ({100 * copy / busy:.1f}%); top kernels "
          + ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in top))
    return busy, copy


def run_layouts(tmp, smi):
    """16c: test_als -pp 0 and -pp 1 -device_loop 2 at the coil shape and
    at 512^3, f32, -layouts 0 then 1: DT sweep medians, the copy kernels'
    device ms, peak memory; each layouts-on run held to its off run by
    the last diffV."""
    import torch
    from pairwise_perturbation_tpu_torch import native
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops import contract
    failures = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.rand(COIL_SHAPE, generator=gen, device="cuda")
    split = native.plan_tree_split_traffic(COIL_SHAPE, 10)[0]
    W0 = cp.init_factors(COIL_SHAPE, 10, seed=0, device="cuda")
    modes = contract.chain_root_modes_dt(COIL_SHAPE, split)
    print(f"16c coil: tree split {split}, DT chain roots {modes}, PP chain "
          f"roots {contract.chain_root_modes_pp(COIL_SHAPE)}; a copy of V "
          f"is {V.numel() * 4 / 2**30:.2f} GiB")
    layouts_copy_ms("coil layouts off", V, W0, split, None, smi)
    copies = contract.prepare_layouts(V, modes)
    layouts_copy_ms("coil layouts on", V, W0, split, copies, smi)
    del copies     # the runs below make their own and report the peak
    for engine, scope in (("als_cp_dt", "cp.sweep"),
                          ("als_cp_pp_fused", "cp.fused_dt_step")):
        got = {}
        for on in (False, True):
            cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=12,
                              resprint=1, tree_split=split,
                              precompute_layouts=on)

            def fn():
                res = getattr(cp, engine)(V, [W.clone() for W in W0], cfg)
                return ([[h["iter"], h["pp"], h["diffV"]]
                         for h in res.history], scope)
            got[on] = layouts_run(f"coil {engine} layouts {int(on)}", fn,
                                  smi)
        a, b = got[True][0][-1][2], got[False][0][-1][2]
        print(f"16c coil {engine}: DT median {1e3 * got[False][1]:.3f} -> "
              f"{1e3 * got[True][1]:.3f} ms, peak {got[False][2]:.2f} -> "
              f"{got[True][2]:.2f} GiB, last diffV {abs(a - b) / b:.3e} "
              f"apart (tol {LAYOUTS_DIFFV})")
        if not abs(a - b) <= LAYOUTS_DIFFV * b:
            failures.append(f"16c coil {engine}: diffV {a} against {b}")
    del V
    torch.cuda.empty_cache()
    for extra, scope in ((["-pp", "0"], "cp.sweep"),
                         (["-pp", "1", "-device_loop", "2"],
                          "cp.fused_dt_step")):
        got = {}
        for on in ("0", "1"):
            def fn():
                rows = cli_csv(LAYOUTS_512 + extra + ["-layouts", on,
                                                      "-profile", "1"],
                               os.path.join(tmp, "layouts.csv"))
                return ([[float(r[1]), float(r[4]), float(r[5])]
                         for r in rows[1:]], scope)
            got[on] = layouts_run(f"512^3 {' '.join(extra)} -layouts {on}",
                                  fn, smi)
        a, b = got["1"][0][-1][2], got["0"][0][-1][2]
        print(f"16c 512^3 {' '.join(extra)}: DT median "
              f"{1e3 * got['0'][1]:.3f} -> {1e3 * got['1'][1]:.3f} ms, peak "
              f"{got['0'][2]:.2f} -> {got['1'][2]:.2f} GiB, last diffV "
              f"{abs(a - b) / b:.3e} apart (tol {LAYOUTS_DIFFV})")
        if not abs(a - b) <= LAYOUTS_DIFFV * b:
            failures.append(f"16c 512^3 {extra}: diffV {a} against {b}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    V = torch.rand((512, 512, 512), generator=gen, device="cuda")
    W5 = cp.init_factors(V.shape, 10, seed=0, device="cuda")
    layouts_copy_ms("512^3 layouts off", V, W5, None, None, smi)
    copies = contract.prepare_layouts(V, contract.chain_root_modes_dt(V.shape))
    layouts_copy_ms("512^3 layouts on", V, W5, None, copies, smi)
    del V, copies
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("; ".join(failures))


def run_phase16(smi):
    """Phase 16 (16a-16c); returns {kernel id: launches}."""
    t_phase = time.perf_counter()
    phase("16a. C12: the first DT step of a fresh process against the "
          "later DT steps, warm-ups on and off, f32")
    run_c12(smi)
    phase("16b. the device engines on a block-sharded V, 2 ranks over gloo "
          "on one card: CP -device_loop 1 and 2 at 200^3 (f64, f32)")
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_dl_mesh(tmp, smi)
    phase("16c. -layouts 1: mode-minor copies of V, coil and 512^3 f32, "
          "off then on")
    with tempfile.TemporaryDirectory() as tmp:
        run_layouts(tmp, smi)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches


# Rows of the table on the port's paths that this slice drives (the CLI
# main path, its 512^3 run with use_kernels_first, and the benchmark
# scripts); K6 serves the coil PP path and K7 the sparse path.
OFF_SLICE_PATH = ("K6", "K7")


KERNEL_PHASES = {
    "3": ("kernels vs plain vs library, bound (CUDA events, median of 25)",
          compare_kernels),
    "3b": ("chain-root kernels vs plain vs library, f32 and bf16 V",
           compare_chain_roots),
    "3c": ("sparse COO MTTKRP kernel (K7) vs plain", compare_coo),
    "3d": ("last_contract (K5), rank-outer (S2), column_sum (S4), block "
           "widths (S5), K4' at coil in f32 (S1) and bf16 (S3)",
           compare_firstlevel)}


def run_kernel_phases(names):
    """Phases 1, 2 and the named kernel phases; returns the card's name
    and power limit."""
    phase("1. device")
    smi = check_device()
    print(smi)
    phase("2. build")
    build_kernels()
    for name in names:
        title, fn = KERNEL_PHASES[name]
        phase(f"{name}. {title}")
        fn()
    return smi


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="run only phases 1, 2 and these kernel phases "
                         f"(comma-separated, of {', '.join(KERNEL_PHASES)},"
                         " 9 for Tucker, 10 for run -issparse 1, the "
                         "datasets, checkpoints and traces, 11 for the "
                         "nnz-sharded engines under torchrun, 12 for the "
                         "dense engines on a block-sharded V, 13 for run "
                         "-mesh, 14 for test_als -device_loop 1, 15 "
                         "for -device_loop 2, Tucker's device engines and "
                         "bench_pp_e2e, 16 for dtime's warm-ups, the device "
                         "engines under -mesh and -layouts 1)"
                         " and print their rows as one JSON line, without "
                         "the ok line: for timing two trees' kernels on one "
                         "card, run from the root of each in turns")
    args = ap.parse_args(argv)
    t_script = time.perf_counter()
    if args.phases is not None:
        names = args.phases.split(",")
        unknown = [n for n in names
                   if n not in KERNEL_PHASES
                   and n not in ("9", "10", "11", "12", "13", "14", "15",
                                 "16")]
        if unknown:
            ap.error(f"unknown phases {unknown}")
        smi = run_kernel_phases([n for n in names if n in KERNEL_PHASES])
        if "9" in names:
            run_tucker(smi)
        if "10" in names:
            print(f"phase 10 launches: {run_phase10(smi)}")
        if "11" in names:
            print(f"phase 11 launches: {run_phase11(smi)}")
        if "12" in names:
            print(f"phase 12 launches: {run_phase12(smi)}")
        if "13" in names:
            print(f"phase 13 launches: {run_phase13(smi)}")
        if "14" in names:
            print(f"phase 14 launches: {run_phase14(smi)}")
        if "15" in names:
            print(f"phase 15 launches: {run_phase15(smi)}")
        if "16" in names:
            print(f"phase 16 launches: {run_phase16(smi)}")
        print(json.dumps({"results": {k: v for k, v in RESULTS.items()
                                      if len(v) > 1}}))
        print(smi)
        return 0
    smi = run_kernel_phases(KERNEL_PHASES)
    import torch
    launches = {}
    phase("4. CLI test_als -model CP -pp 1, 200^3 rank 10")
    for m, n in run_cli_main_path().items():
        launches[f"K{m + 1}"] = n
    phase("4b. CLI at 512^3 rank 10, f32 and bf16, use_kernels_first off "
          "then on")
    # warm-up: the first calls at this shape and dtype, untimed, so that
    # neither side of the off/on pairs below carries them
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for d in ("float32", "bfloat16"):
            for first in (False, True):
                if cli_512(d, first, 3, os.path.join(tmp, "warm.csv")) != 0:
                    raise AssertionError("512^3 warm-up run failed")
    print(f"warm-up runs (4 x 3 sweeps): {time.perf_counter() - t0:.3f} s")
    launches["K4"] = major_512 = 0
    for d in ("float32", "bfloat16"):
        off = run_cli_512(d, first=False)[0]
        _, minor, major = run_cli_512(d, first=True, beside=off)
        launches["K4"] += minor
        major_512 += major
    if major_512 != 0:
        raise AssertionError("K4' (rank-major) launched on the 512^3 path, "
                             "which has no caller of it")
    phase("4c. pp_bench -model CP at 512^3 rank 10, f32, use_kernels_first "
          "off, on, on, off")
    bench = {False: [], True: []}
    for first in (False, True, True, False):
        med, n = run_pp_bench(first)
        bench[first].append(med)
        launches["K4"] += n
    print(f"pp_bench medians, ms (off: runs 1, 4; on: runs 2, 3), {smi}: "
          + "; ".join(f"[{k}] off " + ", ".join(
              f"{1e3 * m[k]:.3f}" for m in bench[False]) + " on " + ", ".join(
              f"{1e3 * m[k]:.3f}" for m in bench[True]) for k in BENCH_KINDS))
    phase("5. order-4 CP-PP at the coil-100 shape")
    off = {d: run_coil_order4(d)[0] for d in ("float32", "bfloat16")}
    phase("5b. coil-100 shape under use_kernels_triple, f32 and bf16")
    launches["K6"] = sum(run_coil_order4(d, triple=True, beside=off[d])[1]
                         for d in ("float32", "bfloat16"))
    # launches of the paths phases 5c, 8 and 10 drive, kept apart in the
    # line
    by_phase = {}
    phase("5c. PP-partupdate (test_als -pp 2, update_percentage 0.5) at the "
          "coil-100 shape, f32, kernels' defaults then use_kernels_triple")
    n = run_partupdate(off["float32"])
    launches["K6"] += n
    by_phase["K6"] = {"5c": n}
    phase("6. sparse CLI test_als -model CP -issparse 1 -pp 1, "
          "Poisson 100^4 rank 10")
    launches["K7"] = run_sparse_cli()[0]
    phase("6b. sparse PP at sparse200_4_nnz1.6M rank 10, kernels off and "
          "on in turns; plain sparse ALS at NELL-2's shape")
    off = run_sparse_full()
    phase("6c. sparse PP repeats with the kernels: fixture caches, two "
          "fixture runs, two Poisson CLI runs")
    run_sparse_repeat(off)
    phase("7. the ported benchmark scripts at the coil-100 shape, rank 10")
    launches.update(run_scripts())
    phase("8. run -pp 4 (Simple) and -pp 1 (MSDT, use_kernels_first off and "
          "on) at 512^3; run -pp 0-3, -device_loop 1 and MSDT with "
          "use_kernels_first at the coil-100 shape; f32, rank 10")
    run_launches, medians = run_512_optimizers()
    k4, coil_medians = run_coil_optimizers()
    run_launches["K4"] += k4
    medians.update(coil_medians)
    for kid, n in run_launches.items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["8"] = n
    print(f"run step medians, ms ({smi}): " + "; ".join(
        f"{label}: {scope} {1e3 * med:.3f}"
        for label, (scope, med) in medians.items()))
    run_tucker(smi)
    for kid, n in run_phase10(smi).items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["10"] = n
    for kid, n in run_phase11(smi).items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["11"] = n
    for kid, n in run_phase12(smi).items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["12"] = n
    for kid, n in run_phase13(smi).items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["13"] = n
    for kid, n in run_phase14(smi).items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["14"] = n
    for kid, n in run_phase15(smi).items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["15"] = n
    for kid, n in run_phase16(smi).items():
        launches[kid] += n
        by_phase.setdefault(kid, {})["16"] = n
    # K4' has no caller in the package; the scripts launch it as S1, S3
    # and S5.
    launches["K4'"] = launches["S1"] + launches["S3"] + launches["S5"]
    kernels = []
    for kid, (name, srcs, replaces) in TABLE.items():
        if launches.get(kid, 0) <= 0 or "ms" not in RESULTS[kid]:
            raise AssertionError(f"{kid} ({name}) was not launched on its "
                                 "path or not timed")
        srcs = (srcs,) if isinstance(srcs, str) else srcs
        kernels.append(dict(id=kid, name=name, route="cuda",
                            source=CSRC + srcs[0],
                            sources=[CSRC + src for src in srcs],
                            replaces=replaces,
                            launches=launches[kid],
                            launches_by_phase=by_phase.get(kid, {}),
                            on_main_path=kid not in OFF_SLICE_PATH,
                            **RESULTS[kid]))
    print(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s in all "
          f"({smi})")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pairwise_perturbation_tpu_torch) on
one NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing its own result lines; any failure prints the
traceback and exits nonzero:

1. Require CUDA (no CPU fallback), pin FP32 matmuls, print the card's
   name and power limit.
2. Build the CUDA kernels from ops/kernels/csrc with nvcc (sm_90a).
3. Hold each fused order-3 MTTKRP kernel (modes 0/1/2) against its plain
   PyTorch version on the card, and time both with CUDA events.
3b. The same for the chain-root kernels, float32 and bf16-stored V:
   mid_contract in its package layouts (K4 rank-minor, K4' rank-major)
   and triple_roots (K6).
3c. The sparse COO MTTKRP kernel (K7) against its plain version, every
   mode, on phase 6's own tensor and initial factors, at the
   sparse200_4_nnz1.6M fixture, the Pallas tests' two shapes, R = 40, a
   Zipf-skewed mode 0 (16M nonzeros) and NELL-2's shape with 76.9M
   uniform nonzeros; two launches must agree bit for bit.
3d. The last kernels, each against its plain version with two launches
   bit for bit equal: last_contract (K5), mid_contract's rank-outer
   layout (S2), column_sum (S4) and mid_contract rank-major at every
   block width (S5), at the coil-100 shapes of the scripts, ragged
   shapes and R = 40 (K5 also with V 4 bytes off 16-byte alignment, and
   its device time and torch.matmul's from torch.profiler); K4' at the
   coil shape in f32 (S1) and bf16 (S3).
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
5. Order-4 CP-PP at the coil-100 shape (3, 128, 128, 7200) f32, rank 10.
5b. The same shape, f32 and bf16 V, under
   ``config.override(use_kernels_triple=True)``: every PP cache build
   takes its three chain roots from one K6 launch.
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

The last three lines are a JSON line of every TPU kernel's row (K1-K7,
S1-S5), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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

CSRC = "pairwise_perturbation_tpu_torch/ops/kernels/csrc/"
PALLAS = "pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py:"
COO_REPLACES = "pairwise_perturbation_tpu/ops/kernels/coo_pallas.py:145"
# Every function of the repo that reaches pl.pallas_call: table id ->
# (JSON name, CUDA source, the pl.pallas_call it replaces).
TABLE = {
    "K1": ("mttkrp3_mode0", "mttkrp3.cu", PALLAS + "145"),
    "K2": ("mttkrp3_mode1", "mttkrp3.cu", PALLAS + "240"),
    "K3": ("mttkrp3_mode2", "mttkrp3.cu", PALLAS + "288"),
    "K4": ("mid_contract_rank_minor", "mid_contract.cu", PALLAS + "468"),
    "K4'": ("mid_contract_rank_major", "mid_contract.cu", PALLAS + "482"),
    "K5": ("last_contract", "last_contract.cu", PALLAS + "550"),
    "K6": ("triple_roots", "triple_roots.cu", PALLAS + "712"),
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
# (shape, mode, R) of mid_contract: DT node (1, 2) at 512^3, the coil
# shape's mode 1, a ragged shape, and R above one rank chunk (32).
MID_CHECKS = [((512, 512, 512), 0, 10), ((3, 128, 128, 7200), 1, 10),
              ((5, 40, 1000), 1, 7), ((200, 200, 200), 1, 40)]
# (shape, R) of triple_roots: the coil cache build, a ragged column tile,
# and R above one rank pass (16).
TRIPLE_CHECKS = [((3, 128, 128, 7200), 10), ((3, 16, 24, 1200), 5),
                 ((3, 64, 64, 2048), 40)]
# (I, J, K, R): the main path's two shapes, a ragged one, and R above one
# rank chunk (32).
CHECK_SHAPES = [(200, 200, 200, 10), (512, 512, 512, 10), (13, 37, 200, 7),
                (96, 96, 96, 40)]
MAIN_SHAPE = (200, 200, 200, 10)
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
              ("NELL-2 shape", NELL2_SHAPE, NELL2_NNZ, 10, False)]


def phase(name):
    print(f"\n=== {name}", flush=True)


_FLUSH = []


def flush_l2():
    """Overwrite the 50 MB L2 cache with a 256 MB store, so that the next
    launch reads its inputs from device memory."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2**20, device="cuda"))
    _FLUSH[0].zero_()


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


def compare_kernels():
    """K1-K3 against their plain versions on the card; times reported at
    MAIN_SHAPE. The library call is the whole MTTKRP as one einsum."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = ("ijk,jr,kr->ir", "ijk,ir,kr->jr", "ijk,ir,jr->kr")
    for (I, J, K, R) in CHECK_SHAPES:
        V = torch.rand((I, J, K), generator=gen, device="cuda")
        Ws = [torch.rand((s, R), generator=gen, device="cuda")
              for s in (I, J, K)]
        for mode in range(3):
            label = f"mode {mode} {I}x{J}x{K} R={R}"
            abs_err, rel = held_to_plain(
                label, mttkrp3.mttkrp3_mode(V, Ws, mode),
                mttkrp3.mttkrp3_mode_plain(V, Ws, mode))
            others = [W for j, W in enumerate(Ws) if j != mode]
            timed_row(f"K{mode + 1}", label, abs_err, rel,
                      lambda: mttkrp3.mttkrp3_mode(V, Ws, mode),
                      lambda: mttkrp3.mttkrp3_mode_plain(V, Ws, mode),
                      lambda: torch.einsum(specs[mode], V, *others),
                      tensor_bytes(V, *others) + 4 * V.shape[mode] * R,
                      2 * V.numel() * R, library_name="torch.einsum",
                      report=(I, J, K, R) == MAIN_SHAPE)
        del V, Ws


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


def mid_bytes(V, W):
    """mid_contract's bytes: V and W read, the float32 output written."""
    return tensor_bytes(V, W) + 4 * (V.numel() // W.shape[0]) * W.shape[1]


def compare_chain_roots():
    """K4, K4' and K6 against their plain versions on the card, f32 and
    bf16 V; times reported at the first shape, f32."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc
    from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots as tr
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        lib_name = "torch.einsum" + (", bf16 out" if dname == "bfloat16"
                                     else "")
        for i, (shape, mode, R) in enumerate(MID_CHECKS):
            V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            W = torch.rand((shape[mode], R), generator=gen, device="cuda")
            for key, layout in (("K4", "rank_minor"), ("K4'", "rank_major")):
                label = f"mid_contract {layout} {shape} mode {mode} R={R} " \
                        f"{dname}"

                def kernel(lo=layout):
                    return mc.mid_contract(V, W, mode, layout=lo)

                def plain(lo=layout):
                    return mc.mid_contract_plain(V, W, mode, layout=lo)

                abs_err, rel = held_to_plain(label, kernel(), plain())
                timed_row(key, label, abs_err, rel, kernel, plain,
                          mid_library(V, W, mode, layout), mid_bytes(V, W),
                          2 * V.numel() * R, dname, lib_name,
                          report=i == 0 and dtype == torch.float32)
            del V, W
        for i, (shape, R) in enumerate(TRIPLE_CHECKS):
            V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            Ws = [torch.rand((s, R), generator=gen, device="cuda")
                  for s in shape[1:]]
            got, want = tr.triple_roots(V, *Ws), tr.triple_roots_plain(V, *Ws)
            label = f"triple_roots {shape} R={R} {dname}"
            errs = [held_to_plain(f"{label} O{k + 1}", g, w)
                    for k, (g, w) in enumerate(zip(got, want))]
            out_bytes = tensor_bytes(*got)
            del got, want
            timed_row("K6", label, max(e[0] for e in errs),
                      max(e[1] for e in errs), lambda: tr.triple_roots(V, *Ws),
                      lambda: tr.triple_roots_plain(V, *Ws), None,
                      tensor_bytes(V, *Ws) + out_bytes, 6 * V.numel() * R,
                      dname, reference=("the einsum route, three einsums",
                                        lambda: tr.triple_roots_plain(V, *Ws)),
                      report=i == 0 and dtype == torch.float32)
            del V, Ws
            torch.cuda.empty_cache()


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


def compare_coo():
    """K7 against its plain version on the card, every mode; times
    reported at the fixture's mode 0. No single PyTorch call computes it:
    the reference is the kernel-off route (gather + f32 index_add_)."""
    import torch
    from pairwise_perturbation_tpu_torch import config, phase_profile
    from pairwise_perturbation_tpu_torch.ops import sparse
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp as coo
    gen = torch.Generator(device="cuda").manual_seed(2)

    def kernel_off(st, Ws, mode):
        with config.override(use_kernels=False):
            return sparse.mttkrp(st, Ws, mode)

    for label, st, Ws, timed in coo_cases(gen):
        R = Ws[0].shape[1]
        for mode in range(st.ndim):
            name = (f"coo_mttkrp {label} {st.shape} nnz={st.nnz} "
                    f"R={R} mode {mode}")
            abs_err, rel = held_twice(       # the first call builds the plan
                name, lambda: coo.coo_mttkrp(st, Ws, mode),
                lambda: coo.coo_mttkrp_plain(st, Ws, mode))
            report = timed and mode == 0
            # the sorted indices of the other modes and the values are
            # read, the factors of the other modes, the (s, R) output
            nbytes = (4 * st.nnz * st.ndim + 4 * R * st.shape[mode]
                      + tensor_bytes(*(W for j, W in enumerate(Ws)
                                       if j != mode)))
            timed_row("K7", name + " (bitwise repeat ok)", abs_err, rel,
                      lambda: coo.coo_mttkrp(st, Ws, mode),
                      lambda: coo.coo_mttkrp_plain(st, Ws, mode), None,
                      nbytes, st.nnz * R * st.ndim,
                      reference=("the kernel-off route, gather + f32 "
                                 "index_add_",
                                 lambda: kernel_off(st, Ws, mode))
                      if report else None, report=report)
            if report:
                for what, fn in (
                        ("kernel", lambda: coo.coo_mttkrp(st, Ws, 0)),
                        ("plain", lambda: coo.coo_mttkrp_plain(st, Ws, 0))):
                    busy, per = phase_profile.profile(fn, "cuda", 25)
                    print(f"  {what}: device busy {1e3 * busy:.1f} us per "
                          "call (torch.profiler): " + ", ".join(
                              f"{k[:48]} {1e3 * v:.1f} us"
                              for k, v in per.items()))
        del st, Ws
        torch.cuda.empty_cache()


# (V shape, R, offset) of last_contract (K5): the coil-100 shape of
# bench_firstpair, a ragged (N, B), R above one rank chunk (32), and the
# coil shape again with V's data 4 bytes past a 16-byte boundary (offset
# 1 float: scalar loads).
K5_CHECKS = [(COIL_SHAPE, 10, 0), ((37, 1001), 7, 0), ((64, 64, 1000), 40, 0),
             (COIL_SHAPE, 10, 1)]
# (P, B, M) views and R of S2/S5: the two coil-100 views of
# bench_midvariants (the first is also bench_rankpos's mode-1 view), a
# ragged shape, and R = 40.
VIEW_CHECKS = [((3, 128, 921600), 10), ((384, 128, 7200), 10),
               ((5, 37, 1001), 7), ((200, 200, 200), 40)]
# (P, B, M) of column_sum (S4): the two coil views and a ragged shape.
S4_CHECKS = [(3, 128, 921600), (384, 128, 7200), (5, 37, 1001)]


def compare_firstlevel():
    """Phase 3d: K5, S2, S4 and S5 (every block width) against their
    plain versions, two launches bit for bit equal; S1 and S3 are K4' at
    the coil view in f32 and bf16. Times reported at the coil shapes."""
    import torch
    from pairwise_perturbation_tpu_torch import phase_profile
    from pairwise_perturbation_tpu_torch.ops.kernels import column_sum as cs
    from pairwise_perturbation_tpu_torch.ops.kernels import last_contract as lc
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc
    gen = torch.Generator(device="cuda").manual_seed(6)
    for i, (shape, R, offset) in enumerate(K5_CHECKS):
        buf = torch.rand(math.prod(shape) + offset, generator=gen,
                         device="cuda")
        V = buf[offset:].view(shape)
        W = torch.rand((shape[-1], R), generator=gen, device="cuda")
        V2 = V.reshape(-1, shape[-1])
        p = lc.plan(V2.shape[0], shape[-1], R,
                    torch.cuda.get_device_properties(0).multi_processor_count,
                    shape[-1] % 4 == 0 and V.data_ptr() % 16 == 0)
        label = (f"last_contract {shape} R={R} data_ptr % 16 = "
                 f"{V.data_ptr() % 16} ({p.n_slices} slices of "
                 f"{p.slice_cols}, {p.blocks} blocks each, vec {p.vec})")
        abs_err, rel = held_twice(label, lambda: lc.last_contract(V, W),
                                  lambda: lc.last_contract_plain(V, W))
        timed_row("K5", label + " (bitwise repeat ok)", abs_err, rel,
                  lambda: lc.last_contract(V, W),
                  lambda: lc.last_contract_plain(V, W), lambda: V2 @ W,
                  tensor_bytes(V, W) + 4 * V2.shape[0] * R,
                  2 * V.numel() * R, library_name="torch.matmul",
                  report=i == 0)
        if i == 0:
            # device time alone: the events above also hold the host's
            # enqueue of each call
            for key, what, fn in (
                    ("device_ms", "kernel", lambda: lc.last_contract(V, W)),
                    ("library_device_ms", "torch.matmul", lambda: V2 @ W)):
                busy, per = phase_profile.profile(fn, "cuda", 25)
                RESULTS["K5"][key] = busy
                print(f"  {what}: device busy {1e3 * busy:.1f} us per call "
                      "(torch.profiler): " + ", ".join(
                          f"{k[:48]} {1e3 * v:.1f} us" for k, v in per.items()))
        del V, W, V2, buf
    for i, (shape, R) in enumerate(VIEW_CHECKS):
        V3 = torch.rand(shape, generator=gen, device="cuda")
        W = torch.rand((shape[1], R), generator=gen, device="cuda")
        dtypes = (torch.float32, torch.bfloat16) if i == 0 else \
            (torch.float32,)
        for dtype in dtypes:
            Vd = V3.to(dtype)
            dname = str(dtype).replace("torch.", "")
            bf16 = dtype == torch.bfloat16
            for layout in ("rank_major", "rank_outer"):
                for cols in mc.BLOCK_COLS:
                    label = (f"mid_contract {layout} cols={cols} {shape} "
                             f"R={R} {dname}")

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
                        fields = timed_row(
                            key, f"[{key}] {label} (bitwise repeat ok)",
                            abs_err, rel, kernel, plain,
                            mid_library(Vd, W, 1, layout), mid_bytes(Vd, W),
                            2 * Vd.numel() * R, dname,
                            "torch.einsum" + (", bf16 out" if bf16 else ""),
                            report=i == 0 and key != "S5"
                            and (key == "S3") == bf16)
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
    from pairwise_perturbation_tpu_torch.utils import tracing
    label = f"CLI 512^3 {dtype} use_kernels_first={first}"
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, f"cp_pp_512_{dtype}.csv")
        tracing.reset()
        mid_contract.reset_launch_counts()
        rc = cli_512(dtype, first, 20, out, "-resprint", "1", "-profile", "1")
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
        print(f"K4 rank-minor launches {minor}, rank-major {major}, "
              f"DT sweeps {n_dt}")
        if not minor == n_dt > 0:
            raise AssertionError("K4 launches differ from the DT sweeps")
    print_phase_times(stats, beside)
    return stats, minor, major


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


def run_coil_order4(dtype="float32", triple=False, beside=None):
    """Order-4 CP-PP on a seeded uniform tensor of the coil-100 shape,
    V stored in ``dtype``, with use_kernels_triple set to ``triple``.
    Returns (phase stats, K6 launches)."""
    import torch
    from pairwise_perturbation_tpu_torch import config, native
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots
    from pairwise_perturbation_tpu_torch.utils import tracing
    gen = torch.Generator(device="cuda").manual_seed(0)
    V = torch.rand(COIL_SHAPE, generator=gen, device="cuda").to(
        getattr(torch, dtype))
    Ws = cp.init_factors(COIL_SHAPE, 10, seed=0, device="cuda")
    split, _, _ = native.plan_tree_split_traffic(COIL_SHAPE, 10)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=5,
                      tree_split=split)
    tracing.reset()
    triple_roots.reset_launch_counts()
    tracing.enable()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with config.override(use_kernels_triple=triple):
        res = cp.als_cp_pp(V, Ws, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tracing.enable(False)
    launches = triple_roots.LAUNCHES["triple_roots"]
    stats = tracing.stats()
    gns = [h["gradnorm"] for h in res.history]
    n_pp = sum(1 for h in res.history if h["pp"] == 1)
    print(f"coil-shape {COIL_SHAPE} {dtype} R=10 split {split} "
          f"use_kernels_triple={triple}: {res.iters} sweeps in {wall:.3f} s, "
          f"{len(gns)} logged rows, {n_pp} PP rows, "
          f"gradnorm {gns[0]:.6e} -> {gns[-1]:.6e}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not all(math.isfinite(g) for g in gns + [res.diffV]):
        raise AssertionError("non-finite gradnorm or diffV")
    if not gns[-1] < gns[0]:
        raise AssertionError("gradnorm did not decrease")
    if triple:
        n_builds = stats.get("cp.pp_cache_build", (0,))[0]
        print(f"K6 launches {launches}, PP cache builds {n_builds}")
        if not launches == n_builds > 0:
            raise AssertionError("K6 launches differ from the cache builds")
    print_phase_times(stats, beside)
    return stats, launches


def expected_coo_launches(stats, order):
    """K7 launches the sparse phase machine implies: ``order`` per exact
    sweep, order + 1 per diagnostics row (the gradnorm's MTTKRPs and the
    residual's) and order + C(order, 2) per PP cache build (the singles,
    then one per pair on its fused view); PP sweeps launch none."""
    return (order * stats.get("sparse.sweep", (0,))[0]
            + (order + 1) * stats.get("sparse.diagnostics", (0,))[0]
            + (order + math.comb(order, 2))
            * stats.get("sparse.pp_cache_build", (0,))[0])


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
    print(f"K7 launches {launches}, expected {want} (4 per exact sweep, "
          "5 per diagnostics row, 10 per cache build)")
    if not launches == want > 0:
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
    want = expected_coo_launches(stats, len(shape)) if use_kernels else 0
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


# Rows of the table on the port's paths that this slice drives (the CLI
# main path, its 512^3 run with use_kernels_first, and the benchmark
# scripts); K6 serves the coil PP path and K7 the sparse path.
OFF_SLICE_PATH = ("K6", "K7")


def main() -> int:
    phase("1. device")
    smi = check_device()
    import torch
    print(smi)
    phase("2. build")
    build_kernels()
    phase("3. kernels vs plain vs library, bound (CUDA events, median of "
          "25)")
    compare_kernels()
    phase("3b. chain-root kernels vs plain vs library, f32 and bf16 V")
    compare_chain_roots()
    phase("3c. sparse COO MTTKRP kernel (K7) vs plain")
    compare_coo()
    phase("3d. last_contract (K5), rank-outer (S2), column_sum (S4), block "
          "widths (S5), K4' at coil in f32 (S1) and bf16 (S3)")
    compare_firstlevel()
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
    phase("5. order-4 CP-PP at the coil-100 shape")
    off = {d: run_coil_order4(d)[0] for d in ("float32", "bfloat16")}
    phase("5b. coil-100 shape under use_kernels_triple, f32 and bf16")
    launches["K6"] = sum(run_coil_order4(d, triple=True, beside=off[d])[1]
                         for d in ("float32", "bfloat16"))
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
    # K4' has no caller in the package; the scripts launch it as S1, S3
    # and S5.
    launches["K4'"] = launches["S1"] + launches["S3"] + launches["S5"]
    kernels = []
    for kid, (name, src, replaces) in TABLE.items():
        if launches.get(kid, 0) <= 0 or "ms" not in RESULTS[kid]:
            raise AssertionError(f"{kid} ({name}) was not launched on its "
                                 "path or not timed")
        kernels.append(dict(id=kid, name=name, route="cuda",
                            source=CSRC + src, replaces=replaces,
                            launches=launches[kid],
                            on_main_path=kid not in OFF_SLICE_PATH,
                            **RESULTS[kid]))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

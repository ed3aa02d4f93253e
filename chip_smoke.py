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
   mid_contract in both output layouts (K4 rank-minor, K4' rank-major)
   and triple_roots (K6).
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

The last two lines are a JSON summary of the kernels and
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
KERNEL_SOURCE = CSRC + "mttkrp3.cu"
PALLAS = "pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py:"
# The pl.pallas_call of each Pallas kernel the CUDA kernels replace.
REPLACES = {0: PALLAS + "145", 1: PALLAS + "240", 2: PALLAS + "288"}
# Chain-root kernels: JSON name -> (source, pl.pallas_call replaced).
ROOT_KERNELS = {"mid_contract_rank_minor": ("mid_contract.cu", "468"),
                "mid_contract_rank_major": ("mid_contract.cu", "482"),
                "triple_roots": ("triple_roots.cu", "712")}
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


def phase(name):
    print(f"\n=== {name}", flush=True)


def median_ms(fn, n=25, warmup=3):
    """Median device time of ``fn`` over ``n`` calls, each bracketed by
    CUDA events, after ``warmup`` untimed calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def compare_kernels():
    """Kernel vs plain on the card; returns per-mode results."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {m: dict(max_abs_err=0.0) for m in range(3)}
    for (I, J, K, R) in CHECK_SHAPES:
        V = torch.rand((I, J, K), generator=gen, device="cuda")
        Ws = [torch.rand((s, R), generator=gen, device="cuda")
              for s in (I, J, K)]
        for mode in range(3):
            label = f"mode {mode} {I}x{J}x{K} R={R}"
            abs_err, rel = held_to_plain(
                label, mttkrp3.mttkrp3_mode(V, Ws, mode),
                mttkrp3.mttkrp3_mode_plain(V, Ws, mode))
            ms = median_ms(lambda: mttkrp3.mttkrp3_mode(V, Ws, mode))
            plain_ms = median_ms(
                lambda: mttkrp3.mttkrp3_mode_plain(V, Ws, mode))
            print(f"{label}: rel_err {rel:.3e} abs_err {abs_err:.3e} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            res = results[mode]
            res["max_abs_err"] = max(res["max_abs_err"], abs_err)
            if (I, J, K, R) == MAIN_SHAPE:
                res["ms"], res["plain_ms"] = ms, plain_ms
        del V, Ws
    return results


def compare_chain_roots():
    """K4, K4' and K6 against their plain versions on the card, f32 and
    bf16 V; returns per-kernel results (times at the first shape, f32)."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc
    from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots as tr
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {k: dict(max_abs_err=0.0) for k in ROOT_KERNELS}

    def record(key, label, abs_err, rel, kernel_fn, plain_fn, main):
        ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
        print(f"{label}: rel_err {rel:.3e} abs_err {abs_err:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        res = results[key]
        res["max_abs_err"] = max(res["max_abs_err"], abs_err)
        if main:
            res["ms"], res["plain_ms"] = ms, plain_ms

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        for i, (shape, mode, R) in enumerate(MID_CHECKS):
            V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            W = torch.rand((shape[mode], R), generator=gen, device="cuda")
            for rank_minor in (True, False):
                key = ("mid_contract_rank_minor" if rank_minor
                       else "mid_contract_rank_major")
                label = f"{key} {shape} mode {mode} R={R} {dname}"

                def kernel(rm=rank_minor):
                    return mc.mid_contract(V, W, mode, rank_minor=rm)

                def plain(rm=rank_minor):
                    return mc.mid_contract_plain(V, W, mode, rank_minor=rm)

                abs_err, rel = held_to_plain(label, kernel(), plain())
                record(key, label, abs_err, rel, kernel, plain,
                       i == 0 and dtype == torch.float32)
            del V, W
        for i, (shape, R) in enumerate(TRIPLE_CHECKS):
            V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
            Ws = [torch.rand((s, R), generator=gen, device="cuda")
                  for s in shape[1:]]
            got, want = tr.triple_roots(V, *Ws), tr.triple_roots_plain(V, *Ws)
            label = f"triple_roots {shape} R={R} {dname}"
            errs = [held_to_plain(f"{label} O{k + 1}", g, w)
                    for k, (g, w) in enumerate(zip(got, want))]
            del got, want
            record("triple_roots", label, max(e[0] for e in errs),
                   max(e[1] for e in errs), lambda: tr.triple_roots(V, *Ws),
                   lambda: tr.triple_roots_plain(V, *Ws),
                   i == 0 and dtype == torch.float32)
            del V, Ws
            torch.cuda.empty_cache()
    return results


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


def print_phase_times(stats, beside=None):
    for name in ("cp.dt_sweep", "cp.pp_cache_build", "cp.pp_sweep",
                 "cp.diagnostics"):
        calls, secs, med = stats.get(name, (0, 0.0, float("nan")))
        line = (f"  {name:20s} calls {calls:4d} total {secs:.4f} s "
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


def main() -> int:
    phase("1. device")
    smi = check_device()
    import torch
    print(smi)
    phase("2. build")
    build_kernels()
    phase("3. kernels vs plain (CUDA events, median of 25)")
    results = compare_kernels()
    phase("3b. chain-root kernels vs plain, f32 and bf16 V (median of 25)")
    root_results = compare_chain_roots()
    phase("4. CLI test_als -model CP -pp 1, 200^3 rank 10")
    launches = run_cli_main_path()
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
    root_launches = {"mid_contract_rank_major": 0,
                     "mid_contract_rank_minor": 0}
    for d in ("float32", "bfloat16"):
        off = run_cli_512(d, first=False)[0]
        _, minor, major = run_cli_512(d, first=True, beside=off)
        root_launches["mid_contract_rank_minor"] += minor
        root_launches["mid_contract_rank_major"] += major
    if root_launches["mid_contract_rank_major"] != 0:
        raise AssertionError("K4' (rank-major) launched on the 512^3 path, "
                             "which has no caller of it")
    phase("5. order-4 CP-PP at the coil-100 shape")
    off = {d: run_coil_order4(d)[0] for d in ("float32", "bfloat16")}
    phase("5b. coil-100 shape under use_kernels_triple, f32 and bf16")
    root_launches["triple_roots"] = sum(
        run_coil_order4(d, triple=True, beside=off[d])[1]
        for d in ("float32", "bfloat16"))
    kernels = [dict(name=f"mttkrp3_mode{m}", route="cuda",
                    source=KERNEL_SOURCE, replaces=REPLACES[m],
                    launches=launches[m], **results[m]) for m in range(3)]
    # K4' (rank-major) has no caller on any path of the package: its count
    # from the 512^3 runs is 0, and phase 3b holds it to its plain version.
    kernels += [dict(name=name, route="cuda", source=CSRC + src,
                     replaces=PALLAS + line, launches=root_launches[name],
                     on_main_path=name != "mid_contract_rank_major",
                     **root_results[name])
                for name, (src, line) in ROOT_KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line driver of the port — ``test_als`` for CP, dense or sparse,
the counterpart of ``pairwise_perturbation_tpu/cli.py`` (lines 140-348)
and of the reference's ``./test_ALS`` (test_ALS.cxx); ``pp_bench`` for CP,
the counterpart of ``cli.cmd_pp_bench`` (lines 468-517) and of the
reference's ``./pp_bench`` (pp_bench.cxx:277-348).

    python -m pairwise_perturbation_tpu_torch.cli test_als -model CP \\
        -tensor r -pp 1 -dim 3 -size 200 -rank 10 -maxiter 40 -filename out.csv
    python -m pairwise_perturbation_tpu_torch.cli pp_bench -model CP \\
        -tensor r -dim 3 -size 512 -rank 10 -maxiter 3 -filename bench.csv

Runs on ``-device`` (default ``cuda``), in float32, float64 or the
mixed-precision ``bfloat16`` mode (V stored bf16; factors, Grams and
solves float32), on the synthetic zoo p/p2/c/r/r2, with -pp 0 (DT-ALS) or
-pp 1 (PP with DT preconditioning, host-driven phases). ``-issparse 1``
runs the COO engine (models/sparse_cp.py) on V's nonzeros instead: plain
ALS sweeps with -pp 0, PP with plain-ALS preconditioning with -pp 1. The
CSV has the reference's schema. ``pp_bench`` writes ``[timetype],[dtime]``
rows: ``[DTtime]`` (one DT sweep), ``[PPfirst]`` (a PP cache build and the
first PP sweep) and ``[PPsecond]`` (the next PP sweep on those caches),
``-maxiter`` of each kind, every one from the same initial factors.
Unlike the JAX package, the port never reorders V's modes for the TPU's
tiling (utils/layout.canonicalize), which is an identity for these cubic
tensors anyway. What is not ported yet is refused with the ROADMAP step
that brings it.
"""

from __future__ import annotations

import sys
import time

import numpy as np

def _unsupported(args, cmd):
    """The first requested feature the port does not have yet, or None."""
    if cmd == "run":
        return ("'run' is not ported yet (ROADMAP A11); the port has "
                "test_als and pp_bench")
    if cmd == "pp_bench":
        checks = [
            (args.model != "CP", "pp_bench -model Tucker is not ported yet "
             "(ROADMAP A10); the port's pp_bench has -model CP"),
            (bool(args.issparse), "pp_bench has no sparse engine "
             "(-issparse 1), in the JAX package either"),
        ]
    else:
        checks = [
            (bool(args.issparse) and args.model != "CP",
             "-model Tucker -issparse 1 (sparse Tucker) is not ported yet: "
             "it waits for Tucker (ROADMAP A10) and then the Tucker half of "
             "A13"),
            (args.model != "CP",
             "-model Tucker is not ported yet (ROADMAP A10)"),
            (bool(args.issparse) and args.pp not in (0, 1),
             "-issparse 1 takes -pp 0 or 1: -pp 2 (PP-partupdate, ROADMAP "
             "A9) has no sparse engine, in the JAX package either"),
            (args.pp not in (0, 1),
             "-pp 2 (PP-partupdate) is not ported yet (ROADMAP A9)"),
        ]
    checks += [
        (bool(args.mesh), "-mesh is not ported yet (ROADMAP A15)"),
        (args.device_loop >= 1,
         "-device_loop >= 1 is not ported yet (ROADMAP A14); "
         "use -device_loop 0"),
        (bool(args.layouts), "-layouts 1 is not ported (ROADMAP A16)"),
        (args.tensor in ("o1", "o2"),
         f"-tensor {args.tensor}: the dataset loaders are not ported yet "
         "(ROADMAP A16)"),
        (bool(args.checkpoint or args.resume),
         "-checkpoint/-resume are not ported yet (ROADMAP A16)"),
        (bool(args.trace_dir),
         "-trace_dir (device traces) is not ported yet (ROADMAP A16)"),
    ]
    for bad, msg in checks:
        if bad:
            return msg
    return None


def _print_banner(args):
    if args.quiet:
        return
    print(f"  model=  {args.model}  tensor=  {args.tensor}  pp=  {args.pp}")
    print(f"  dim=  {args.dim}  size=  {args.size}  rank=  {args.rank}")
    print(f"  tolerance=  {args.tol}  restarttol=  {args.pp_res_tol}")
    print(f"  lambda=  {args.lam}  magnitude=  {args.magni}"
          f"  filename=  {args.filename}")
    print(f"  timelimit=  {args.timelimit}  maxiter=  {args.maxiter}"
          f"  resprint=  {args.resprint}")
    print(f"  dtype=  {args.dtype}  device=  {args.device}")


def _planned_split(args, shape):
    """Native-planner binary-tree root split (None = reference midpoint)."""
    if not args.planner:
        return None
    from pairwise_perturbation_tpu_torch import native
    split, best_t, mid_t = native.plan_tree_split_traffic(
        tuple(int(s) for s in shape), int(args.rank))
    if split == (len(shape) - 1) // 2:
        return None
    if not args.quiet and mid_t == mid_t and best_t == best_t and mid_t > 0:
        print(f"  planner: root split {split} "
              f"(modeled traffic saving {100 * (mid_t - best_t) / mid_t:.1f}%"
              " vs midpoint)")
    return split


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("-device cuda: no CUDA device is available "
                         "(use -device cpu for a CPU run)")
    return dev


def _synthetic(args):
    """The synthetic tensor of -tensor/-dim/-size/-rank as numpy, and the
    factor dtype (-dtype bfloat16 stores only V in bf16, JAX
    cli.py:24-38)."""
    import torch
    from pairwise_perturbation_tpu_torch.utils import synth
    np_dtype = np.float64 if args.dtype == "float64" else np.float32
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    V = synth.make_tensor(args.tensor, args.dim, args.size, args.rank,
                          args.colmin, args.colmax, args.rationoise,
                          seed=args.seed, dtype=np_dtype)
    return V, dtype


def _dense(args, V, device):
    """V on ``device``, stored in bf16 under -dtype bfloat16."""
    import torch
    X = torch.from_numpy(V).to(device)
    return X.to(torch.bfloat16) if args.dtype == "bfloat16" else X


def cmd_test_als(args) -> int:
    from pairwise_perturbation_tpu_torch.models import cp, sparse_cp
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile

    device = _device(args.device)
    _print_banner(args)
    V, dtype = _synthetic(args)
    Vnorm = float(np.linalg.norm(V.ravel()))  # of the f32 values, unrounded
    if not args.quiet:
        print(f"Vnorm= {Vnorm}")
    if args.issparse:
        X = _sparse_tensor(args, V, device)
        solve = (sparse_cp.als_cp_sparse, sparse_cp.als_cp_pp_sparse)[args.pp]
        split = None
    else:
        X = _dense(args, V, device)
        solve = (cp.als_cp_dt, cp.als_cp_pp)[args.pp]
        split = _planned_split(args, X.shape)
    t0 = time.perf_counter()
    Ws = cp.init_factors(X.shape, args.rank, seed=args.seed, dtype=dtype,
                         device=device)
    cfg = cp.CPConfig(tol=args.tol * Vnorm, pp_res_tol=args.pp_res_tol,
                      lam=args.lam, ratio_step=args.magni,
                      maxiter=args.maxiter, timelimit=args.timelimit,
                      resprint=args.resprint, tree_split=split)
    plot = PlotFile(args.filename, PlotFile.CP_HEADER, echo=not args.quiet)
    try:
        res = solve(X, Ws, cfg, plot)
    finally:
        plot.close()
    if not args.quiet:
        print(f"\nIter = {res.iters} Final grad norm {res.gradnorm:E}")
        print(f"experiment took {time.perf_counter() - t0:.6f} seconds")
    return 0


def _synced(V):
    """Wait for ``V``'s device: each timed window of pp_bench ends here."""
    import torch
    if V.device.type == "cuda":
        torch.cuda.synchronize(V.device)


def pp_bench_cp(V, W0, lam, magni, maxiter, split=None, plot=None):
    """The CP body of pp_bench (JAX cli.py:482-517): one untimed DT sweep,
    then ``maxiter`` [DTtime] rows of one DT sweep each; one untimed cache
    build, then ``maxiter`` pairs of rows: [PPfirst] a cache build and the
    first PP sweep from zero dWs, [PPsecond] the next PP sweep on those
    caches. Every row starts from a copy of ``W0`` (solver "svd", root
    split ``split``) and its window ends in a device synchronize. Rows go
    to ``plot`` (a PlotFile, or None). Returns the factors each row kind
    ended with, at its last row: {"DTtime": ..., "PPfirst": ...,
    "PPsecond": ...}."""
    import torch
    from pairwise_perturbation_tpu_torch.models import cp

    def row(kind, seconds):
        if plot is not None:
            plot.bench_row(kind, seconds)

    def fresh():
        return [w.clone() for w in W0]

    last = {}
    Ws, _ = cp.dt_sweep(V, fresh(), lam, solver="svd", root_split=split)
    _synced(V)
    for _ in range(maxiter):
        Ws = fresh()
        t0 = time.perf_counter()
        Ws, _ = cp.dt_sweep(V, Ws, lam, solver="svd", root_split=split)
        _synced(V)
        row("DTtime", time.perf_counter() - t0)
        last["DTtime"] = Ws
    cp.pp_build_caches(V, fresh())
    _synced(V)
    for _ in range(maxiter):
        Ws = fresh()
        t0 = time.perf_counter()
        single, pair = cp.pp_build_caches(V, Ws)
        W_init = list(Ws)
        dWs = [torch.zeros_like(w) for w in Ws]
        Ws, dWs, _ = cp.pp_sweep(single, pair, Ws, W_init, dWs, lam, magni,
                                 solver="svd")
        _synced(V)
        t1 = time.perf_counter()
        row("PPfirst", t1 - t0)
        Ws2, _, _ = cp.pp_sweep(single, pair, Ws, W_init, dWs, lam, magni,
                                solver="svd")
        _synced(V)
        row("PPsecond", time.perf_counter() - t1)
        last["PPfirst"], last["PPsecond"] = Ws, Ws2
    return last


def cmd_pp_bench(args) -> int:
    """Per-sweep timing of CP (pp_bench.cxx:277-348): [DTtime] rows from
    1-sweep DT runs, then [PPfirst]/[PPsecond] from 1-sweep PP runs, all
    from identical factors, as the JAX package's ``cmd_pp_bench``."""
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile

    device = _device(args.device)
    _print_banner(args)
    V, dtype = _synthetic(args)
    X = _dense(args, V, device)
    W0 = cp.init_factors(X.shape, args.rank, seed=args.seed, dtype=dtype,
                         device=device)
    split = _planned_split(args, X.shape)
    plot = PlotFile(args.filename, PlotFile.BENCH_HEADER,
                    echo=not args.quiet)
    try:
        pp_bench_cp(X, W0, args.lam, args.magni, args.maxiter, split, plot)
    finally:
        plot.close()
    return 0


def _sparse_tensor(args, V, device):
    """-issparse 1: the COO of V's nonzeros for the sparse engine
    (models/sparse_cp.py), as the JAX package's _cmd_test_als_sparse
    (cli.py:297-348) builds it. With -dtype bfloat16 the COO values are
    V's bf16-rounded values stored in float32, as the JAX package stores
    them."""
    import torch
    from pairwise_perturbation_tpu_torch.ops import sparse

    if args.dtype == "bfloat16":
        V = torch.from_numpy(V).to(torch.bfloat16).float().numpy()
    st = sparse.from_dense(V, device=device)
    density = st.nnz / float(np.prod(st.shape))
    if not args.quiet:
        print(f"  sparse COO: nnz= {st.nnz}  density= {density:.4f}")
        if density > 0.25:
            print("  WARNING: tensor is dense-ish; the dense engine "
                  "(-issparse 0) will be faster")
    return st


def main(argv=None) -> int:
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.utils import flags, tracing
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = "test_als"
    if argv and argv[0] in ("test_als", "run", "pp_bench"):
        cmd = argv.pop(0)
    parser = flags.build_parser(f"pairwise_perturbation_tpu_torch.cli {cmd}")
    args = parser.parse_args(argv)
    flags.clamp(args)
    why = _unsupported(args, cmd)
    if why:
        raise SystemExit(why)
    config.apply_fp32_pins()
    if args.profile:
        tracing.enable()
    rc = (cmd_pp_bench if cmd == "pp_bench" else cmd_test_als)(args)
    if args.profile:
        print("\n" + tracing.report())
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

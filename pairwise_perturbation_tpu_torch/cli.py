"""Command-line driver of the port — ``test_als`` for dense CP, the
counterpart of ``pairwise_perturbation_tpu/cli.py`` (lines 140-295) and of
the reference's ``./test_ALS`` (test_ALS.cxx).

    python -m pairwise_perturbation_tpu_torch.cli test_als -model CP \\
        -tensor r -pp 1 -dim 3 -size 200 -rank 10 -maxiter 40 -filename out.csv

Runs on ``-device`` (default ``cuda``), in float32, float64 or the
mixed-precision ``bfloat16`` mode (V stored bf16; factors, Grams and
solves float32), on the synthetic zoo p/p2/c/r/r2, with -pp 0 (DT-ALS) or
-pp 1 (PP with DT preconditioning, host-driven phases). The CSV has the
reference's schema.
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
    if cmd != "test_als":
        step = {"run": "A11", "pp_bench": "A12"}[cmd]
        return (f"'{cmd}' is not ported yet (ROADMAP {step}); "
                "the port has test_als")
    checks = [
        (args.model != "CP", "-model Tucker is not ported yet (ROADMAP A10)"),
        (args.pp not in (0, 1),
         "-pp 2 (PP-partupdate) is not ported yet (ROADMAP A9)"),
        (bool(args.issparse),
         "-issparse (COO engine) is not ported yet (ROADMAP A13)"),
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


def cmd_test_als(args) -> int:
    import torch
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils import synth
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile

    device = _device(args.device)
    _print_banner(args)
    np_dtype = np.float64 if args.dtype == "float64" else np.float32
    # factor dtype; -dtype bfloat16 stores only V in bf16 (JAX cli.py:24-38)
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    V = synth.make_tensor(args.tensor, args.dim, args.size, args.rank,
                          args.colmin, args.colmax, args.rationoise,
                          seed=args.seed, dtype=np_dtype)
    Vnorm = float(np.linalg.norm(V.ravel()))  # of the f32 values, unrounded
    if not args.quiet:
        print(f"Vnorm= {Vnorm}")
    V = torch.from_numpy(V).to(device)
    if args.dtype == "bfloat16":
        V = V.to(torch.bfloat16)
    t0 = time.perf_counter()
    Ws = cp.init_factors(V.shape, args.rank, seed=args.seed, dtype=dtype,
                         device=device)
    cfg = cp.CPConfig(tol=args.tol * Vnorm, pp_res_tol=args.pp_res_tol,
                      lam=args.lam, ratio_step=args.magni,
                      maxiter=args.maxiter, timelimit=args.timelimit,
                      resprint=args.resprint,
                      tree_split=_planned_split(args, V.shape))
    plot = PlotFile(args.filename, PlotFile.CP_HEADER, echo=not args.quiet)
    try:
        if args.pp == 0:
            res = cp.als_cp_dt(V, Ws, cfg, plot)
        else:
            res = cp.als_cp_pp(V, Ws, cfg, plot)
    finally:
        plot.close()
    if not args.quiet:
        print(f"\nIter = {res.iters} Final grad norm {res.gradnorm:E}")
        print(f"experiment took {time.perf_counter() - t0:.6f} seconds")
    return 0


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
    rc = cmd_test_als(args)
    if args.profile:
        print("\n" + tracing.report())
    return rc


if __name__ == "__main__":
    raise SystemExit(main())

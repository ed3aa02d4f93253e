"""Flag surface compatible with the reference drivers.

Copy of ``pairwise_perturbation_tpu/utils/flags.py`` with the same names
and defaults (tests/test_torch_cli.py pins them equal), plus ``-device``.
The reference parses single-dash long options with a hand-rolled scan
(getCmdOption, test_ALS.cxx:14-20). The full surface (SURVEY.md section 5):

-model -tensor -pp -update_percentage_pp -dim -size -rank -updaterank
-issparse -resprint -randomsvd -tol -pp_res_tol -lambda -magni -filename
-tensorfile -colmin -colmax -rationoise -timelimit -maxiter

plus the JAX package's additions (-dtype, -mesh, -seed, -checkpoint,
-resume, -device_loop, -layouts, -profile, -trace_dir, ...) and -device.
Flags that the JAX package ignores on a path (-device_loop or -layouts 1
there, for example) are accepted by the parser and refused by the CLI,
with the reason.
Defaults and clamping follow test_ALS.cxx:64-196 / run.cxx:67-214.
"""

from __future__ import annotations

import argparse


def build_parser(prog: str = "pairwise_perturbation_tpu_torch"
                 ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-model", default="CP", choices=["CP", "Tucker"])
    p.add_argument("-tensor", default="p",
                   help="p | p2 | c | r | r2 | o1 (coil-100) | o2 "
                        "(time-lapse), the last two read from -tensorfile")
    p.add_argument("-pp", type=int, default=0,
                   help="test_als: 0 DT, 1 PP, 2 PP-partupdate; "
                        "run: 0 DT, 1 MSDT, 2 DT-LR, 3 MSDT-LR, 4 Simple")
    p.add_argument("-update_percentage_pp", type=float, default=1.0)
    p.add_argument("-dim", type=int, default=8)
    p.add_argument("-size", type=int, default=10)
    p.add_argument("-rank", type=int, default=0, help="0 -> size//2")
    p.add_argument("-updaterank", type=int, default=1)
    p.add_argument("-randomsvd", type=int, default=0)
    p.add_argument("-issparse", type=int, default=0,
                   help="1: COO sparse engine (test_als -model CP or Tucker "
                        "-pp 0/1; run, every optimizer)")
    p.add_argument("-resprint", type=int, default=10)
    p.add_argument("-tol", type=float, default=1e-10,
                   help="relative tolerance; multiplied by ||V||")
    p.add_argument("-pp_res_tol", type=float, default=1e-2)
    p.add_argument("-lambda", dest="lam", type=float, default=0.0)
    p.add_argument("-magni", type=float, default=1.0,
                   help="PP damping ratio_step")
    p.add_argument("-filename", default="out.csv")
    p.add_argument("-tensorfile", default="test")
    p.add_argument("-colmin", type=float, default=0.5)
    p.add_argument("-colmax", type=float, default=0.9)
    p.add_argument("-rationoise", type=float, default=0.01)
    p.add_argument("-timelimit", type=float, default=5e3)
    p.add_argument("-maxiter", type=int, default=250)
    p.add_argument("-dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"],
                   help="float32 | float64 | bfloat16 (V stored bf16; "
                        "factors, Grams and solves float32)")
    p.add_argument("-mesh", default="",
                   help="N or AxB: one torchrun rank per mesh device; "
                        "dense V block-sharded over its largest modes "
                        "(test_als, pp_bench, run), or with -issparse 1 an "
                        "nnz-sharded COO over a 1D mesh (test_als)")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-checkpoint", default="",
                   help="test_als: write the final factors (and Tucker's "
                        "core) to this path + .npz")
    p.add_argument("-resume", default="",
                   help="dense CP test_als: start from this checkpoint's "
                        "factors")
    p.add_argument("-device_loop", type=int, default=0,
                   help="run: >= 1 steps MSDT and MSDT-LR (-pp 1, 3) a "
                        "full MSDT rotation per call (macro steps, as the "
                        "JAX package's); test_als CP -pp 1 and Tucker "
                        "-pp >= 1: 1 the device-resident phase loops, 2 "
                        "the fused machine")
    p.add_argument("-tucker_subspace", type=int, default=-1)
    p.add_argument("-tucker_pp_skip", type=float, default=0.0)
    p.add_argument("-msdt_min_holdout", type=int, default=0,
                   help="run MSDT(-LR): hold out only modes of size >= "
                        "this (0 = reference rotation)")
    p.add_argument("-planner", type=int, default=1,
                   help="1 (default): binary-tree root split chosen by the "
                        "native traffic planner (native/planner.cpp); "
                        "0: reference midpoint split")
    p.add_argument("-layouts", type=int, default=0,
                   help="1: mode-minor copies of V for the first-level "
                        "contractions (contract.prepare_layouts; |V| of "
                        "device memory each); dense CP test_als -pp 0, and "
                        "-pp 1 with -device_loop 1 or 2")
    p.add_argument("-quiet", action="store_true")
    p.add_argument("-profile", type=int, default=0,
                   help="1: per-phase host timer scopes (synchronized; adds "
                        "overhead) + tracing report at exit")
    p.add_argument("-trace_dir", default="",
                   help="with -profile 1: write a torch.profiler trace "
                        "(Chrome-trace JSON) of the command here")
    p.add_argument("-device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def clamp(args) -> None:
    """Range clamping as in test_ALS.cxx:76-196."""
    if args.rank <= 0:
        args.rank = max(args.size // 2, 1)
    args.pp = max(args.pp, 0)
    if not (0.0 < args.update_percentage_pp <= 1.0):
        args.update_percentage_pp = 1.0
    if args.maxiter < 0:
        args.maxiter = 5000
    if args.timelimit < 0:
        args.timelimit = 5e3
    if not (0 <= args.tol <= 1):
        args.tol = 1e-10
    if not (0 <= args.pp_res_tol <= 1):
        args.pp_res_tol = 1e-2
    if args.lam < 0:
        args.lam = 0.0
    if args.magni < 0:
        args.magni = 1.0

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
Flags whose code is not ported yet are accepted by the parser and
refused by the CLI with the ROADMAP step that brings them.
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
                   help="p | p2 | c | r | r2 (o1/o2 datasets not ported)")
    p.add_argument("-pp", type=int, default=0,
                   help="0 DT, 1 PP (2 PP-partupdate not ported)")
    p.add_argument("-update_percentage_pp", type=float, default=1.0)
    p.add_argument("-dim", type=int, default=8)
    p.add_argument("-size", type=int, default=10)
    p.add_argument("-rank", type=int, default=0, help="0 -> size//2")
    p.add_argument("-updaterank", type=int, default=1)
    p.add_argument("-randomsvd", type=int, default=0)
    p.add_argument("-issparse", type=int, default=0,
                   help="1: COO sparse engine (test_als -model CP)")
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
    p.add_argument("-mesh", default="", help="device mesh: not ported")
    p.add_argument("-seed", type=int, default=0)
    p.add_argument("-checkpoint", default="",
                   help="factor checkpoints: not ported")
    p.add_argument("-resume", default="",
                   help="resume from checkpoint: not ported")
    p.add_argument("-device_loop", type=int, default=0,
                   help="device-resident phase machines: not ported; "
                        "only 0 (host-driven phases) runs")
    p.add_argument("-tucker_subspace", type=int, default=-1)
    p.add_argument("-tucker_pp_skip", type=float, default=0.0)
    p.add_argument("-msdt_min_holdout", type=int, default=0)
    p.add_argument("-planner", type=int, default=1,
                   help="1 (default): binary-tree root split chosen by the "
                        "native traffic planner (native/planner.cpp); "
                        "0: reference midpoint split")
    p.add_argument("-layouts", type=int, default=0,
                   help="mode-minor copies of V: not ported (the port never "
                        "canonicalizes mode order either; that is TPU tiling "
                        "and an identity for the cubic synthetic tensors)")
    p.add_argument("-quiet", action="store_true")
    p.add_argument("-profile", type=int, default=0,
                   help="1: per-phase host timer scopes (synchronized; adds "
                        "overhead) + tracing report at exit")
    p.add_argument("-trace_dir", default="",
                   help="device traces: not ported")
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

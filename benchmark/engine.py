"""The system under test: the fit engines of ``pairwise_perturbation_tpu_torch``
that ``cli.cmd_test_als`` routes a cell's flags to, driven one fit at a
time. The only module of the benchmark that imports the port.

The flags are the configuration's (model, rank, tolerance, iteration cap,
dtype) followed by the traffic mix's, parsed and clamped by the port's
own ``utils/flags``, so the program's defaults follow; a flag set that
the CLI refuses is refused here with its reason. The engine, its
``CPConfig`` / ``TuckerConfig`` and the tree split (``cli._planned_split``)
are chosen as ``cmd_test_als`` chooses them. The CLI itself is not
called, since it rebuilds V on the host on every call.
"""

from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.models import cp, tucker
from pairwise_perturbation_tpu_torch.utils import flags, tracing


@dataclass
class Fit:
    """What one fit returned: its factors (and Tucker's core), the
    stopping metric it reported (CP gradnorm, Tucker diffnorm), its
    diffV, its sweeps, whether it met its tolerance, and its wall
    seconds."""
    factors: List[torch.Tensor]
    core: Optional[torch.Tensor]
    metric: float
    diffV: float
    iters: int
    converged: bool
    seconds: float

    @property
    def finite(self) -> bool:
        return math.isfinite(self.metric) and math.isfinite(self.diffV) \
            and all(bool(torch.isfinite(W).all()) for W in self.factors)


def fp32_pins(precision: str) -> None:
    """The port's float32 pins (TF32 off), as its CLI sets them; the
    ``tf32`` control lifts them afterwards."""
    config.apply_fp32_pins()
    if precision == "tf32":
        torch.set_float32_matmul_precision("high")
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True


def argv_of(conf: dict, traffic: dict, precision: str) -> List[str]:
    argv = ["-model", conf["model"], "-rank", str(conf.get("rank", 0)),
            "-tol", repr(float(conf["tol"])),
            "-maxiter", str(int(conf["maxiter"])),
            "-dtype", conf["dtype"], "-quiet"]
    argv += [str(a) for a in traffic["flags"]]
    if precision == "bf16v":
        argv += ["-dtype", "bfloat16"]
    return argv


class Engine:
    """One configuration under one traffic mix on one V."""

    def __init__(self, conf: dict, traffic: dict, V: torch.Tensor,
                 precision: str = "fp32"):
        args = flags.build_parser().parse_args(argv_of(conf, traffic,
                                                       precision))
        flags.clamp(args)
        why = cli._unsupported(args, "test_als")
        if why or args.mesh or args.issparse:
            raise SystemExit(why or "the benchmark drives dense, unsharded "
                             "test_als engines")
        self.args = args
        self.model = args.model
        self.dtype = torch.float64 if args.dtype == "float64" \
            else torch.float32
        self.V = V.to(torch.bfloat16) if args.dtype == "bfloat16" else V
        self.shape = tuple(V.shape)
        # ||V|| of the values the engine reads, as cmd_test_als takes it
        vnorm = float(torch.linalg.vector_norm(V, dtype=torch.float64))
        self.split = None
        if self.model == "CP":
            self.split = cli._planned_split(args, self.shape)
            self.solve = (
                cp.als_cp_dt,
                (cp.als_cp_pp, cp.als_cp_pp_device, cp.als_cp_pp_fused)[
                    min(args.device_loop, 2)],
                functools.partial(cp.als_cp_pp, partial_update=True))[
                min(args.pp, 2)]
            self.cfg = cp.CPConfig(
                tol=args.tol * vnorm, pp_res_tol=args.pp_res_tol,
                lam=args.lam, ratio_step=args.magni, maxiter=args.maxiter,
                timelimit=args.timelimit, resprint=args.resprint,
                update_percentage=args.update_percentage_pp,
                tree_split=self.split,
                precompute_layouts=bool(args.layouts))
        else:
            self.ranks = tuple(int(r) for r in conf["ranks"])
            self.solve = tucker.als_tucker if args.pp == 0 else (
                tucker.als_tucker_pp, tucker.als_tucker_pp_device,
                tucker.als_tucker_pp_fused)[min(args.device_loop, 2)]
            self.cfg = tucker.TuckerConfig(
                tol=args.tol * vnorm, pp_res_tol=args.pp_res_tol,
                maxiter=args.maxiter, timelimit=args.timelimit,
                resprint=args.resprint, subspace_iters=args.tucker_subspace,
                pp_quiet_frac=args.tucker_pp_skip)

    def fit(self, fit_seed: int) -> Fit:
        """One fit to the engine's own stopping rule, from
        ``cp.init_factors(seed=fit_seed)`` (CP) or the engine's HOSVD
        (Tucker), ended by a device sync."""
        t0 = time.perf_counter()
        if self.model == "CP":
            Ws = cp.init_factors(self.shape, self.args.rank, seed=fit_seed,
                                 dtype=self.dtype, device=self.V.device)
            res = self.solve(self.V, Ws, self.cfg)
            metric, core = res.gradnorm, None
        else:
            res = self.solve(self.V, self.ranks, self.cfg)
            metric, core = res.diffnorm, res.core
        if self.V.is_cuda:
            torch.cuda.synchronize()
        return Fit(list(res.factors), core, float(metric), float(res.diffV),
                   int(res.iters), bool(res.converged),
                   time.perf_counter() - t0)


def scopes():
    """The port's scope statistics: {name: (calls, seconds, median)} and
    {name: [seconds of each call]}."""
    stats = tracing.stats()
    return stats, {n: tracing.samples(n) for n in stats}


def enable_scopes(wrap) -> None:
    """Turn the port's tracing scopes on, each call of
    ``tracing.timed`` going through ``wrap(timed, name, fn, *a, **kw)``."""
    timed = tracing.timed

    def wrapped(name, fn, *a, **kw):
        return wrap(timed, name, fn, *a, **kw)
    tracing.timed = wrapped
    tracing.reset()
    tracing.enable()

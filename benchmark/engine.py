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

A cell on N > 1 cards runs one rank a card, each a process started with
torchrun's environment. Its traffic's ``-mesh`` has N devices; each rank
joins the world (:func:`join`), holds its zero-padded block of V on the
layout that ``cmd_test_als`` plans under ``-mesh``, and the engine runs
as that command runs it there: ``mesh_layout`` in the config, ||V|| from
the blocks' squared norms, the initial factors drawn at the global shape
and then sharded, and each fit's factors unsharded whole.
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
from pairwise_perturbation_tpu_torch.ops import contract
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
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


def parsed(conf: dict, traffic: dict, precision: str, chips: int):
    """The cell's ``test_als`` flags, parsed and clamped by the port;
    refused with the reason where the CLI refuses them, where they ask
    for the sparse engines, or where ``-mesh`` does not give one rank to
    each of the cell's ``chips`` cards."""
    args = flags.build_parser().parse_args(argv_of(conf, traffic,
                                                   precision))
    flags.clamp(args)
    why = cli._unsupported(args, "test_als")
    if why or args.issparse:
        raise SystemExit(why or "the benchmark drives dense test_als "
                         "engines")
    devices = math.prod(cli._mesh_shape(args)) if args.mesh else 1
    if devices != chips or (args.mesh and chips == 1):
        raise SystemExit(
            f"-mesh {args.mesh or '(none)'} has {devices} device(s) and the "
            f"cell asks for {chips} card(s): a cell on N > 1 cards takes "
            "a -mesh of N devices, one rank a card; a one-card cell runs "
            "unsharded, without -mesh")
    return args


def join(conf: dict, traffic: dict, precision: str, chips: int,
         device: str):
    """This rank's device and the layout of the configuration's shape on
    the traffic's ``-mesh``, once the rank has joined the torchrun world
    (``parallel/mesh.distributed_init``: NCCL with a card a rank, gloo
    under ``cpu``) and the mesh is made, as ``cmd_test_als`` plans it."""
    args = parsed(conf, traffic, precision, chips)
    dev = pmesh.distributed_init(device)
    return dev, cli._plan(args, tuple(int(s) for s in conf["shape"]), dev)


def leave() -> None:
    """Leave the torchrun world, if this process joined one."""
    pmesh.distributed_close()


class Engine:
    """One configuration under one traffic mix on one V: the whole V, or
    under ``layout`` (:func:`join`) this rank's block of it."""

    def __init__(self, conf: dict, traffic: dict, V: torch.Tensor,
                 precision: str = "fp32", layout=None):
        chips = 1 if layout is None else math.prod(layout.mesh.shape)
        args = parsed(conf, traffic, precision, chips)
        self.args = args
        self.model = args.model
        self.layout = layout
        self.dtype = torch.float64 if args.dtype == "float64" \
            else torch.float32
        self.V = V.to(torch.bfloat16) if args.dtype == "bfloat16" else V
        if layout is None:
            self.shape = tuple(V.shape)
            # ||V|| of the values the engine reads, as cmd_test_als takes it
            vnorm = float(torch.linalg.vector_norm(V, dtype=torch.float64))
        else:
            self.shape = layout.orig_shape
            vnorm = float(torch.sqrt(contract.norm_sq(V, layout)))
        self.split = None
        if self.model == "CP":
            self.split = cli._planned_split(
                args, self.shape if layout is None else layout.padded_shape)
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
                tree_split=self.split, mesh_layout=layout,
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
                pp_quiet_frac=args.tucker_pp_skip, mesh_layout=layout)

    def fit(self, fit_seed: int) -> Fit:
        """One fit to the engine's own stopping rule, from
        ``cp.init_factors(seed=fit_seed)`` (CP) or the engine's HOSVD
        (Tucker), ended by a device sync. Under a layout the initial
        factors are drawn at the global shape and sharded, and the fit's
        factors come back whole."""
        t0 = time.perf_counter()
        if self.model == "CP":
            Ws = cp.init_factors(self.shape, self.args.rank, seed=fit_seed,
                                 dtype=self.dtype, device=self.V.device)
            if self.layout is not None:
                Ws = pmesh.shard_factors(Ws, self.layout)
            res = self.solve(self.V, Ws, self.cfg)
            metric, core = res.gradnorm, None
        else:
            res = self.solve(self.V, self.ranks, self.cfg)
            metric, core = res.diffnorm, res.core
        if self.V.is_cuda:
            torch.cuda.synchronize()
        factors = list(res.factors)
        if self.layout is not None:
            factors = [torch.from_numpy(W) for W in
                       pmesh.unshard_factors(factors, self.layout)]
        return Fit(factors, core, float(metric), float(res.diffV),
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

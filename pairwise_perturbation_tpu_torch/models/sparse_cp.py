"""Sparse CP-ALS solvers (COO tensors): plain ALS and pairwise
perturbation — port of ``pairwise_perturbation_tpu/models/sparse_cp.py``
(lines 31-192).

Reference: the ``-issparse`` path of the legacy drivers, which runs the
same alsCP / alsCP_PP algorithms on sparse CTF tensors
(test_ALS.cxx:126-131, 229). As in the JAX package, the exact phase is
PLAIN ALS (one exact sparse MTTKRP per mode, ops/sparse.mttkrp), not the
dimension tree, whose dense first-level intermediates would defeat sparse
storage. PP sweeps are the dense engine's (models/cp.pp_sweep), since the
caches are dense either way; only cache builds and exact sweeps touch the
nonzeros.

Each sweep is eager PyTorch on the tensors' device, and the phase machine
runs on the host, as in models/cp.py. Before the loop, in excluded time,
the engines run one sparse sweep (and the PP engine one cache build,
discarded) through cp.warm_run, where the JAX package runs its
``warm_compile`` (sparse_cp.py:102-103, 138-141); its ``calibrate_rtt``
has no counterpart here.

``mesh=`` (a 1D ``DeviceMesh``, parallel/mesh.py) runs the engine on an
nnz-sharded COO, one process per rank, as the JAX package's ``mesh``
does: ``st`` is this rank's shard (parallel/mesh.shard_coo), every
MTTKRP, cache build and ||V||^2 sums the ranks' partials with one
all_reduce, the residual goes through the all-reduced last-mode MTTKRP
and contract.cp_residual_norm (JAX sparse_cp.py:65-71), and the time
limit is rank 0's clock, broadcast. Every other decision reads
all-reduced values, so the ranks take the same path with bitwise equal
factors.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pairwise_perturbation_tpu_torch.models import cp as cpm
from pairwise_perturbation_tpu_torch.ops import contract, solve
from pairwise_perturbation_tpu_torch.ops import sparse as sp
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
from pairwise_perturbation_tpu_torch.utils import tracing
from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile, SweepClock


def _mttkrp(st, Ws, mode, mesh):
    if mesh is None:
        return sp.mttkrp(st, Ws, mode)
    return pmesh.sharded_sparse_mttkrp(st, Ws, mode, mesh)


def norm_sq(st, mesh=None):
    """||V||^2 of the whole tensor: summed over the ranks under ``mesh``."""
    return sp.norm_sq(st) if mesh is None else \
        pmesh.sharded_sparse_norm_sq(st, mesh)


def sparse_simple_sweep(st, Ws, lam, rcond=None, *, solver: str = "svd",
                        normalize: bool = True, mesh=None):
    """One plain ALS sweep with exact sparse MTTKRPs (alsCP body,
    als_CP.cxx:66-99, V sparse); under ``mesh`` each MTTKRP is the
    ranks' partials summed (parallel/mesh.sharded_sparse_mttkrp)."""
    Ws = list(Ws)
    for i in range(st.ndim):
        M = _mttkrp(st, Ws, i, mesh)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam)
        Ws[i] = solve.solve(M, S, method=solver, rcond=rcond)
    if normalize:
        Ws = contract.normalize_factors(Ws)
    return Ws


def sparse_pp_build_caches(st, Ws, mesh=None):
    """PP singles and rank-major pairs from the nonzeros."""
    if mesh is not None:
        return pmesh.sharded_sparse_pp_caches(st, list(Ws), mesh)
    return sp.build_pp_caches(st, list(Ws))


def sparse_diagnostics(V_norm_sq, st, Ws, lam=None, mesh=None):
    """(exact gradnorm, exact diffV) against the sparse tensor."""
    if mesh is not None:
        gn = pmesh.sharded_sparse_gradnorm(st, list(Ws), mesh, regul=lam)
        M_last = pmesh.sharded_sparse_mttkrp(st, list(Ws), st.ndim - 1,
                                             mesh)
        return gn, contract.cp_residual_norm(V_norm_sq, M_last, list(Ws))
    gn = sp.cp_gradnorm(st, list(Ws), regul=lam)
    dv = sp.cp_residual_norm(V_norm_sq, st, list(Ws))
    return gn, dv


def _diag_and_log(V_norm_sq, st, Ws, lam, clock, plot, it, tol, pp_flag,
                  history, mesh=None):
    """Exact diagnostics with excluded time, one CSV row; queued sweep
    work is synced before the excluded window opens."""
    cpm._sync()
    with clock.exclude():
        gn, diffV = tracing.timed("sparse.diagnostics", sparse_diagnostics,
                                  V_norm_sq, st, Ws, lam, mesh)
        gn, diffV = float(gn), float(diffV)
    dtime = pmesh.agreed_dtime(clock, mesh, st.values.device)
    if plot is not None:
        plot.row(st.shape[0], it, gn, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, gradnorm=gn, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return gn, diffV, dtime


def _sweep(st, Ws, cfg: cpm.CPConfig, mesh):
    return tracing.timed("sparse.sweep", sparse_simple_sweep, st, Ws,
                         cfg.lam, cfg.rcond, solver=cfg.solver, mesh=mesh)


def _ratios(Ws, dWs):
    return cpm.factor_norm_ratios(Ws, dWs).cpu().numpy()


def als_cp_sparse(st, Ws, cfg: cpm.CPConfig,
                  plot: Optional[PlotFile] = None,
                  clock: Optional[SweepClock] = None,
                  mesh=None) -> cpm.CPResult:
    """Plain sparse ALS (alsCP with a sparse V); ``mesh``: ``st`` is this
    rank's shard of an nnz-sharded COO (see the module docstring)."""
    Ws = list(Ws)
    if mesh is not None:
        pmesh.check_1d(mesh)
    V_norm_sq = norm_sq(st, mesh)
    clock = clock or SweepClock()
    with clock.exclude():
        cpm.warm_run(sparse_simple_sweep, st, Ws, cfg.lam, cfg.rcond,
                     solver=cfg.solver, mesh=mesh)
    history: list = []
    gn, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    while it <= cfg.maxiter:
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, st, Ws, cfg.lam, clock, plot, it, cfg.tol, 0,
                history, mesh)
            if gn < cfg.tol:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        Ws = _sweep(st, Ws, cfg, mesh)
        it += 1
    return cpm.CPResult(Ws, gn, diffV, it, converged, history)


def als_cp_pp_sparse(st, Ws, cfg: cpm.CPConfig,
                     plot: Optional[PlotFile] = None,
                     clock: Optional[SweepClock] = None,
                     mesh=None) -> cpm.CPResult:
    """Sparse PP: the exact phase is plain sparse sweeps with dW tracking
    (exit to PP when every mode is quiet); the PP phase is the dense
    engine's pp_sweep on sparse-built caches, with the reference's restart
    tolerance and 15-sweep cap (alsCP_PP, als_CP.cxx:1082-1137).
    ``mesh``: ``st`` is this rank's shard (see the module docstring)."""
    Ws = list(Ws)
    if mesh is not None:
        pmesh.check_1d(mesh)
    V_norm_sq = norm_sq(st, mesh)
    clock = clock or SweepClock()
    with clock.exclude():
        cpm.warm_run(sparse_simple_sweep, st, Ws, cfg.lam, cfg.rcond,
                     solver=cfg.solver, mesh=mesh)
        cpm.warm_run(sparse_pp_build_caches, st, Ws, mesh)
    history: list = []
    gn, diffV = float("inf"), float("inf")
    it = 0
    while it <= cfg.maxiter and gn > cfg.tol:
        # ---- exact phase (alsCP_DT_sub role) ----
        W_prev = [torch.zeros_like(W) for W in Ws]
        quiet = False
        while it <= cfg.maxiter:
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                gn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, cfg.lam, clock, plot, it, cfg.tol, 0,
                    history, mesh)
                if gn < cfg.tol or dtime > cfg.timelimit:
                    return cpm.CPResult(Ws, gn, diffV, it, gn < cfg.tol,
                                        history)
            Ws = _sweep(st, Ws, cfg, mesh)
            dWs = [W - Wp for W, Wp in zip(Ws, W_prev)]
            W_prev = list(Ws)
            ratios = _ratios(Ws, dWs)
            it += 1
            if int(np.sum(np.abs(ratios) < cfg.pp_res_tol)) == len(Ws):
                quiet = True
                break
        if not quiet or it > cfg.maxiter:
            break
        # ---- PP phase (alsCP_PP_sub) ----
        single, pair = tracing.timed("sparse.pp_cache_build",
                                     sparse_pp_build_caches, st, Ws, mesh)
        W_init = list(Ws)
        dWs = [torch.zeros_like(W) for W in Ws]
        pp_sweeps = 0
        while it <= cfg.maxiter and pp_sweeps < cfg.pp_cache_sweeps:
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                gn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, cfg.lam, clock, plot, it, cfg.tol, 1,
                    history, mesh)
                if gn < cfg.tol or dtime > cfg.timelimit:
                    return cpm.CPResult(Ws, gn, diffV, it, gn < cfg.tol,
                                        history)
            Ws, dWs, _ = tracing.timed(
                "sparse.pp_sweep", cpm.pp_sweep, single, pair, Ws, W_init,
                dWs, cfg.lam, cfg.ratio_step, cfg.rcond, solver=cfg.solver)
            it += 1
            pp_sweeps += 1
            if int(np.sum(np.abs(_ratios(Ws, dWs)) > cfg.pp_res_tol)) > 0:
                break  # restart -> back to the exact phase
    return cpm.CPResult(Ws, gn, diffV, it, gn < cfg.tol, history)

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
runs on the host, as in models/cp.py. The JAX package's ``mesh`` argument
(nnz-sharded COO, ROADMAP A15), ``warm_compile`` and ``calibrate_rtt``
have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pairwise_perturbation_tpu_torch.models import cp as cpm
from pairwise_perturbation_tpu_torch.ops import contract, solve
from pairwise_perturbation_tpu_torch.ops import sparse as sp
from pairwise_perturbation_tpu_torch.utils import tracing
from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile, SweepClock


def sparse_simple_sweep(st, Ws, lam, rcond=None, *, solver: str = "svd",
                        normalize: bool = True):
    """One plain ALS sweep with exact sparse MTTKRPs (alsCP body,
    als_CP.cxx:66-99, V sparse)."""
    Ws = list(Ws)
    for i in range(st.ndim):
        M = sp.mttkrp(st, Ws, i)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam)
        Ws[i] = solve.solve(M, S, method=solver, rcond=rcond)
    if normalize:
        Ws = contract.normalize_factors(Ws)
    return Ws


def sparse_pp_build_caches(st, Ws):
    """PP singles and rank-major pairs from the nonzeros."""
    return sp.build_pp_caches(st, list(Ws))


def sparse_diagnostics(V_norm_sq, st, Ws, lam=None):
    """(exact gradnorm, exact diffV) against the sparse tensor."""
    gn = sp.cp_gradnorm(st, list(Ws), regul=lam)
    dv = sp.cp_residual_norm(V_norm_sq, st, list(Ws))
    return gn, dv


def _diag_and_log(V_norm_sq, st, Ws, lam, clock, plot, it, tol, pp_flag,
                  history):
    """Exact diagnostics with excluded time, one CSV row; queued sweep
    work is synced before the excluded window opens."""
    cpm._sync()
    with clock.exclude():
        gn, diffV = tracing.timed("sparse.diagnostics", sparse_diagnostics,
                                  V_norm_sq, st, Ws, lam)
        gn, diffV = float(gn), float(diffV)
    dtime = clock.dtime()
    if plot is not None:
        plot.row(st.shape[0], it, gn, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, gradnorm=gn, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return gn, diffV, dtime


def _sweep(st, Ws, cfg: cpm.CPConfig):
    return tracing.timed("sparse.sweep", sparse_simple_sweep, st, Ws,
                         cfg.lam, cfg.rcond, solver=cfg.solver)


def _ratios(Ws, dWs):
    return cpm.factor_norm_ratios(Ws, dWs).cpu().numpy()


def als_cp_sparse(st, Ws, cfg: cpm.CPConfig,
                  plot: Optional[PlotFile] = None,
                  clock: Optional[SweepClock] = None) -> cpm.CPResult:
    """Plain sparse ALS (alsCP with a sparse V)."""
    Ws = list(Ws)
    V_norm_sq = sp.norm_sq(st)
    clock = clock or SweepClock()
    history: list = []
    gn, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    while it <= cfg.maxiter:
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, st, Ws, cfg.lam, clock, plot, it, cfg.tol, 0,
                history)
            if gn < cfg.tol:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        Ws = _sweep(st, Ws, cfg)
        it += 1
    return cpm.CPResult(Ws, gn, diffV, it, converged, history)


def als_cp_pp_sparse(st, Ws, cfg: cpm.CPConfig,
                     plot: Optional[PlotFile] = None,
                     clock: Optional[SweepClock] = None) -> cpm.CPResult:
    """Sparse PP: the exact phase is plain sparse sweeps with dW tracking
    (exit to PP when every mode is quiet); the PP phase is the dense
    engine's pp_sweep on sparse-built caches, with the reference's restart
    tolerance and 15-sweep cap (alsCP_PP, als_CP.cxx:1082-1137)."""
    Ws = list(Ws)
    V_norm_sq = sp.norm_sq(st)
    clock = clock or SweepClock()
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
                    history)
                if gn < cfg.tol or dtime > cfg.timelimit:
                    return cpm.CPResult(Ws, gn, diffV, it, gn < cfg.tol,
                                        history)
            Ws = _sweep(st, Ws, cfg)
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
                                     sparse_pp_build_caches, st, Ws)
        W_init = list(Ws)
        dWs = [torch.zeros_like(W) for W in Ws]
        pp_sweeps = 0
        while it <= cfg.maxiter and pp_sweeps < cfg.pp_cache_sweeps:
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                gn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, cfg.lam, clock, plot, it, cfg.tol, 1,
                    history)
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

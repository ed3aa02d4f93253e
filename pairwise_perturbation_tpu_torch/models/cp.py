"""CP-ALS solvers: plain, dimension-tree (DT) and pairwise perturbation
(PP) — port of the host-driven half of
``pairwise_perturbation_tpu/models/cp.py`` (lines 50-300, 408-662).

- :func:`als_cp`    <-> ``alsCP`` (als_CP.cxx:20-115)
- :func:`als_cp_dt` <-> ``alsCP_DT`` (als_CP.cxx:127-320)
- :func:`als_cp_pp` <-> ``alsCP_PP`` = ``alsCP_DT_sub`` <-> ``alsCP_PP_sub``
                        state machine (als_CP.cxx:418-833, 1082-1137)

Each sweep (DT sweep, PP cache build, PP sweep) is eager PyTorch on the
tensors' device; the DT <-> PP phase machine, restart tolerances and CSV
logging run on the host at per-sweep granularity, reading a few scalars
per sweep. There is no compile step to warm up and no relay round-trip to
calibrate, so the JAX package's ``warm_compile`` and ``calibrate_rtt``
have no counterpart.

Numerics: factor updates solve W S = M with S the Hadamard-of-Grams R x R
matrix; ``solver='svd'`` matches the legacy engine, ``solver='chol'`` the
second-gen optimizers. Residual diagnostics use the norm identity (one
exact MTTKRP) and are excluded from ``dtime`` like the reference's
(als_CP.cxx:480-482).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops import contract, dimtree, solve
from pairwise_perturbation_tpu_torch.utils import tracing
from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile, SweepClock


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclass
class CPConfig:
    tol: float = 1e-10            # absolute gradnorm tolerance (driver passes tol*||V||)
    pp_res_tol: float = 1e-2      # PP restart tolerance (tol_init)
    lam: float = 0.0              # ridge regularization lambda
    ratio_step: float = 1.0       # PP damping (magni)
    maxiter: int = 250
    timelimit: float = 5e3
    resprint: int = 10
    solver: str = "svd"           # 'svd' (legacy) | 'chol' (second-gen)
    pp_cache_sweeps: int = 15     # hard cap per PP cache build (als_CP.cxx:667)
    # Gradnorm-growth guard: force a PP restart (back to DT) when the
    # per-sweep gradnorm rises above gn_guard x the phase's running
    # minimum, or a factor moves by far more than its own norm in one
    # sweep (the JAX package's guard, cp.py:556-575). 0 disables.
    gn_guard: float = 10.0
    # Binary-tree root split (None = reference midpoint, common.cxx:252).
    # The CLI sets this from the native planner (native/planner.cpp).
    tree_split: object = None
    # Per-run pseudo-inverse cutoff override; None = config default.
    rcond: object = None


@dataclass
class CPResult:
    factors: List
    gradnorm: float
    diffV: float
    iters: int
    converged: bool
    history: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def dt_sweep(V, Ws, lam, rcond=None, *, solver: str = "svd",
             normalize: bool = True, root_split: int = None):
    """One full DT-ALS sweep: per-mode MTTKRP from the binary dimension tree,
    S assembly, gradient, solve. Returns (Ws_new, grads).

    Mirrors the per-iteration body of alsCP_DT (als_CP.cxx:215-303),
    including cache freshness: tree nodes are built on first use and reused
    for later modes even after earlier factors updated.
    """
    order = V.ndim
    sweep = dimtree.BinaryTreeSweep(V, Ws, root_split=root_split)
    grads = [None] * order
    for i in range(order):
        M = sweep.mttkrp(i)
        S = contract.hadamard_gram(sweep.factors, skip_mode=i, regul=lam)
        grads[i] = contract.gradsubprob(M, S, sweep.factors[i])
        sweep.factors[i] = solve.solve(M, S, method=solver, rcond=rcond)
    Ws = sweep.factors
    if normalize:
        Ws = contract.normalize_factors(Ws)
    return Ws, grads


def simple_sweep(V, Ws, lam, rcond=None, *, solver: str = "svd",
                 normalize: bool = True):
    """One plain ALS sweep with exact per-mode MTTKRP (alsCP body,
    als_CP.cxx:66-99). For an order-3 f32 V each MTTKRP is the fused
    kernel (contract.mttkrp)."""
    order = V.ndim
    Ws = list(Ws)
    grads = [None] * order
    for i in range(order):
        M = contract.mttkrp(V, Ws, i)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam)
        grads[i] = contract.gradsubprob(M, S, Ws[i])
        Ws[i] = solve.solve(M, S, method=solver, rcond=rcond)
    if normalize:
        Ws = contract.normalize_factors(Ws)
    return Ws, grads


def pp_build_caches(V, Ws):
    """Build PP pair + single caches (als_CP.cxx:667-695)."""
    return contract.build_pp_caches(V, Ws)


def pp_sweep(single, pair, Ws, W_init, dWs, lam, ratio_step, rcond=None,
             *, solver: str = "svd", normalize: bool = True):
    """One PP sweep (als_CP.cxx:753-825): per mode, first-order-corrected
    MTTKRP from the caches, S from *current* factors, damped solve.
    Returns (Ws_new, dWs_new, grads)."""
    order = len(Ws)
    Ws = list(Ws)
    dWs = list(dWs)
    grads = [None] * order
    for i in range(order):
        M = contract.pp_correct_mttkrp(single[i], pair, dWs, i)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam)
        grads[i] = contract.gradsubprob(M, S, Ws[i])
        if solver == "svd":
            Ws[i], dWs[i] = solve.svd_solve_mod(M, W_init[i], S, ratio_step,
                                                rcond)
        else:
            Ws[i], dWs[i] = _chol_solve_mod(M, W_init[i], S, ratio_step)
    if normalize:
        Ws = contract.normalize_factors(Ws)
    return Ws, dWs, grads


def _chol_solve_mod(M, W_init, S, ratio_step):
    dW = ratio_step * (solve.cholesky_solve(M, S) - W_init)
    return W_init + dW, dW


def factor_norm_ratios(Ws, dWs):
    """||dW_i|| / ||W_i|| for all modes (restart checks,
    als_CP.cxx:594-603, 659-664)."""
    return torch.stack([torch.linalg.vector_norm(dW)
                        / torch.linalg.vector_norm(W)
                        for W, dW in zip(Ws, dWs)])


def ratios_and_gradnorm(Ws, dWs, grads):
    """[factor_norm_ratios..., gradnorm-of-grads] in one tensor, so the PP
    host loop reads both (restart check + gradnorm guard) in one pull."""
    gn = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    r = factor_norm_ratios(Ws, dWs)
    return torch.cat([r, gn[None].to(r.dtype)])


def cp_diagnostics(V_norm_sq, V, Ws, lam=None):
    """(gradnorm, diffV), both EXACT at the current iterate: gradnorm from
    fresh per-mode MTTKRPs (contract.cp_gradnorm) and diffV via the norm
    identity with a fresh exact MTTKRP. Exact recomputation keeps the
    logged gradnorm on one scale across the DT and PP phases.

    bf16-stored V is upcast to the factor dtype first (JAX cp.py:295-296):
    the mixed-precision rule would otherwise round the factors to bf16 as
    well, and the norm identity's cancellation then clamps diffV to 0.
    Order 3 then reaches the f32 MTTKRP kernels."""
    if V.dtype == torch.bfloat16:
        V = V.to(Ws[0].dtype)
    gn = contract.cp_gradnorm(V, list(Ws), regul=lam)
    M_last = contract.mttkrp(V, Ws, len(Ws) - 1)
    diffV = contract.cp_residual_norm(V_norm_sq, M_last, Ws)
    return gn, diffV


# ---------------------------------------------------------------------------
# Host-side drivers
# ---------------------------------------------------------------------------


def init_factors(shape: Sequence[int], R: int, seed: int = 0, dtype=None,
                 device="cuda"):
    """Deterministic uniform(0,1) factor init from a seeded CPU
    ``torch.Generator`` (the same numbers on every device). It does not
    reproduce the JAX package's ``jax.random`` factors; parity tests pass
    those in through utils.interop instead."""
    if dtype is None:
        dtype = config.default_dtype()
    gen = torch.Generator().manual_seed(int(seed))
    return [torch.rand((s, R), generator=gen, dtype=dtype).to(device)
            for s in shape]


def _sync():
    """Wait for queued device work. CUDA launches are asynchronous, so a
    sweep's time is only known after this; CPU tensors are already done."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _diag_and_log(V_norm_sq, V, Ws, lam, clock, plot, it, tol, pp_flag,
                  history):
    """Run EXACT diagnostics with excluded time, log a CSV row, return
    scalars. Queued sweep work is synced BEFORE the excluded window opens,
    so it counts toward dtime."""
    _sync()
    with clock.exclude():
        gn, diffV = tracing.timed("cp.diagnostics", cp_diagnostics,
                                  V_norm_sq, V, Ws, lam)
        gn, diffV = float(gn), float(diffV)
    dtime = clock.dtime()
    if plot is not None:
        plot.row(V.shape[0], it, gn, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, gradnorm=gn, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return gn, diffV, dtime


def als_cp(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None) -> CPResult:
    """Plain ALS (exact MTTKRP each mode). Reference: alsCP (als_CP.cxx:20-115)."""
    return _als_generic(V, Ws, cfg, plot, sweep_fn=simple_sweep)


def als_cp_dt(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None,
              clock: Optional[SweepClock] = None) -> CPResult:
    """DT-ALS. Reference: alsCP_DT (als_CP.cxx:127-320)."""
    def sweep_fn(V, Ws, lam, rcond, solver):
        return dt_sweep(V, Ws, lam, rcond, solver=solver,
                        root_split=cfg.tree_split)
    return _als_generic(V, Ws, cfg, plot, sweep_fn=sweep_fn, clock=clock)


def _als_generic(V, Ws, cfg: CPConfig, plot, sweep_fn, clock=None) -> CPResult:
    Ws = list(Ws)
    V_norm_sq = contract.norm_sq(V)
    clock = clock or SweepClock()
    history: list = []
    gn, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    while it <= cfg.maxiter:
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, cfg.lam, clock, plot, it, cfg.tol, 0,
                history)
            if gn < cfg.tol:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        Ws, _ = tracing.timed("cp.sweep", sweep_fn, V, Ws, cfg.lam,
                              cfg.rcond, solver=cfg.solver)
        it += 1
    return CPResult(Ws, gn, diffV, it, converged, history)


def _dt_sub(V, Ws, dWs, cfg: CPConfig, plot, clock, state, V_norm_sq):
    """DT sweeps as PP preconditioner. Reference: alsCP_DT_sub
    (als_CP.cxx:418-612). Returns (Ws, dWs, exit_reason)."""
    order = V.ndim
    W_prev = [torch.zeros_like(W) for W in Ws]
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, cfg.lam, clock, plot, it, cfg.tol, 0,
                state["history"])
            state["last_logged"] = it
            state["gradnorm"], state["diffV"] = gn, diffV
            if gn < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
        Ws, grads = tracing.timed("cp.dt_sweep", dt_sweep, V, Ws, cfg.lam,
                                  cfg.rcond, solver=cfg.solver,
                                  root_split=cfg.tree_split)
        state["grads"] = grads
        dWs = [W - Wp for W, Wp in zip(Ws, W_prev)]
        W_prev = list(Ws)
        ratios = factor_norm_ratios(Ws, dWs).cpu().numpy()
        state["iter"] = it + 1
        if int(np.sum(np.abs(ratios) < cfg.pp_res_tol)) == order:
            return Ws, dWs, "quiet"
    return Ws, dWs, "maxiter"


def _pp_sub(V, Ws, dWs, cfg: CPConfig, plot, clock, state, V_norm_sq):
    """PP sweeps. Reference: alsCP_PP_sub (als_CP.cxx:621-833)."""
    init_iter = state["iter"]
    W_init = None
    single = pair = None
    gn_floor = float("inf")  # running min for the gradnorm-growth guard
    Ws_pre, dWs_pre = Ws, dWs  # pre-sweep state (guard revert target)
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        if cfg.gn_guard and state["grads"] is not None:
            rg = ratios_and_gradnorm(Ws, dWs, state["grads"]).cpu().numpy()
            ratios, gn_est = rg[:-1], float(rg[-1])
            # revert guards: gradnorm growth OR a factor that moved by
            # >> its own norm in one sweep (a last-mode solve explosion
            # is invisible to gn_est)
            if gn_est > cfg.gn_guard * gn_floor or \
                    float(np.max(np.abs(ratios))) \
                    > max(5.0 * cfg.pp_res_tol, 0.5):
                # discard the blown sweep and restart from the last
                # healthy iterate; the discarded sweep does not consume
                # an iteration — EXCEPT when its iteration number was
                # already logged (rewinding would duplicate CSV rows)
                if state.get("last_logged") != it - 1:
                    state["iter"] = it - 1
                return Ws_pre, dWs_pre, "restart"
            gn_floor = min(gn_floor, gn_est)
        else:
            ratios = factor_norm_ratios(Ws, dWs).cpu().numpy()
        num_dw_break = int(np.sum(np.abs(ratios) > cfg.pp_res_tol))
        if (it - init_iter) % cfg.pp_cache_sweeps == 0 or num_dw_break > 0:
            if num_dw_break > 0 or it != init_iter:
                return Ws, dWs, "restart"
            W_init = list(Ws)
            dWs = [torch.zeros_like(W) for W in Ws]
            single, pair = tracing.timed("cp.pp_cache_build",
                                         pp_build_caches, V, Ws)
        if it % cfg.resprint == 0 or it == cfg.maxiter or it == init_iter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, cfg.lam, clock, plot, it, cfg.tol, 1,
                state["history"])
            state["last_logged"] = it
            state["gradnorm"], state["diffV"] = gn, diffV
            if gn < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
        Ws_pre, dWs_pre = Ws, dWs
        Ws, dWs, grads = tracing.timed(
            "cp.pp_sweep", pp_sweep, single, pair, Ws, W_init, dWs, cfg.lam,
            cfg.ratio_step, cfg.rcond, solver=cfg.solver)
        state["grads"] = grads
        state["iter"] = it + 1
    return Ws, dWs, "maxiter"


def als_cp_pp(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None,
              partial_update: bool = False,
              clock: Optional[SweepClock] = None) -> CPResult:
    """Outer DT <-> PP loop. Reference: alsCP_PP (als_CP.cxx:1082-1137)."""
    if partial_update:
        raise NotImplementedError(
            "PP-partupdate (-pp 2) is not ported yet (ROADMAP A9)")
    Ws = list(Ws)
    V_norm_sq = contract.norm_sq(V)
    clock = clock or SweepClock()
    state = dict(iter=0, grads=None, gradnorm=float("inf"),
                 diffV=float("inf"), history=[])
    dWs = [torch.zeros_like(W) for W in Ws]
    reason = None
    while state["gradnorm"] > cfg.tol and state["iter"] <= cfg.maxiter:
        Ws, dWs, reason = _dt_sub(V, Ws, dWs, cfg, plot, clock, state,
                                  V_norm_sq)
        if reason in ("converged", "timelimit", "maxiter"):
            break
        Ws, dWs, reason = _pp_sub(V, Ws, dWs, cfg, plot, clock, state,
                                  V_norm_sq)
        if reason in ("converged", "timelimit", "maxiter"):
            break
    return CPResult(Ws, state["gradnorm"], state["diffV"], state["iter"],
                    reason == "converged", state["history"])

"""CP-ALS solvers: plain, dimension-tree (DT), pairwise perturbation (PP)
and PP with partial updates — port of the host-driven half of
``pairwise_perturbation_tpu/models/cp.py`` (lines 50-300, 408-662).

- :func:`als_cp`    <-> ``alsCP`` (als_CP.cxx:20-115)
- :func:`als_cp_dt` <-> ``alsCP_DT`` (als_CP.cxx:127-320)
- :func:`als_cp_pp` <-> ``alsCP_PP`` = ``alsCP_DT_sub`` <-> ``alsCP_PP_sub``
                        state machine (als_CP.cxx:418-833, 1082-1137);
                        with ``partial_update``, ``alsCP_PP_partupdate``
                        (als_CP.cxx:852-1073, 1146-1207)

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

``CPConfig.mesh_layout`` (a parallel/mesh.ShardedLayout, the JAX
package's name) runs the engines on a block-sharded V, one process per
mesh device: V and the factors passed in are this rank's blocks
(parallel/mesh.shard_tensor, shard_factors), and every sweep function
takes the layout as ``layout=``. Each places its own all_reduces through
the mesh's hooks (a leaf MTTKRP, a Gram, a norm, a corrected PP term),
so every decision of the phase machine reads values that are bitwise
equal on every rank, and the time limit reads rank 0's clock. Without a
layout every hook is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops import contract, dimtree, solve
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
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
    update_percentage: float = 1.0  # PP-partupdate: share of modes solved
    pp_cache_sweeps: int = 15     # hard cap per PP cache build (als_CP.cxx:667)
    # Gradnorm-growth guard: force a PP restart (back to DT) when the
    # per-sweep gradnorm rises above gn_guard x the phase's running
    # minimum, or a factor moves by far more than its own norm in one
    # sweep (the JAX package's guard, cp.py:556-575). 0 disables.
    gn_guard: float = 10.0
    # pp_bench timing mode (the JAX package's cp.py:68): als_cp_pp runs one
    # PP phase straight from the given factors, with no DT preconditioning
    # and no restart checks, then returns.
    bench: bool = False
    # Binary-tree root split (None = reference midpoint, common.cxx:252).
    # The CLI sets this from the native planner (native/planner.cpp).
    tree_split: object = None
    # Per-run pseudo-inverse cutoff override; None = config default.
    rcond: object = None
    # ShardedLayout of a -mesh run (parallel/mesh.plan_layout): V and the
    # factors are this rank's blocks; None = unsharded.
    mesh_layout: object = None


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
             normalize: bool = True, root_split: int = None, layout=None):
    """One full DT-ALS sweep: per-mode MTTKRP from the binary dimension tree,
    S assembly, gradient, solve. Returns (Ws_new, grads).

    Mirrors the per-iteration body of alsCP_DT (als_CP.cxx:215-303),
    including cache freshness: tree nodes are built on first use and reused
    for later modes even after earlier factors updated. ``layout``: V and
    Ws are this rank's blocks; the grads are row blocks.
    """
    order = V.ndim
    sweep = dimtree.BinaryTreeSweep(V, Ws, root_split=root_split,
                                    layout=layout)
    grads = [None] * order
    for i in range(order):
        M = sweep.mttkrp(i)
        S = contract.hadamard_gram(sweep.factors, skip_mode=i, regul=lam,
                                   layout=layout)
        grads[i] = contract.gradsubprob(M, S, sweep.factors[i])
        sweep.factors[i] = solve.solve(M, S, method=solver, rcond=rcond)
    Ws = sweep.factors
    if normalize:
        Ws = contract.normalize_factors(Ws, layout)
    return Ws, grads


def simple_sweep(V, Ws, lam, rcond=None, *, solver: str = "svd",
                 normalize: bool = True, layout=None):
    """One plain ALS sweep with exact per-mode MTTKRP (alsCP body,
    als_CP.cxx:66-99). For an order-3 f32 V each MTTKRP is the fused
    kernel (contract.mttkrp)."""
    order = V.ndim
    Ws = list(Ws)
    grads = [None] * order
    for i in range(order):
        M = contract.mttkrp(V, Ws, i, layout=layout)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam, layout=layout)
        grads[i] = contract.gradsubprob(M, S, Ws[i])
        Ws[i] = solve.solve(M, S, method=solver, rcond=rcond)
    if normalize:
        Ws = contract.normalize_factors(Ws, layout)
    return Ws, grads


def pp_build_caches(V, Ws, layout=None):
    """Build PP pair + single caches (als_CP.cxx:667-695); under
    ``layout`` through parallel/mesh.constrained_pp_caches (JAX
    cp.py:537-591), each cache summed over the sharded modes it
    contracted."""
    if layout is not None:
        return pmesh.constrained_pp_caches(V, Ws, layout)
    return contract.build_pp_caches(V, Ws)


def pp_sweep(single, pair, Ws, W_init, dWs, lam, ratio_step, rcond=None,
             *, solver: str = "svd", normalize: bool = True, layout=None):
    """One PP sweep (als_CP.cxx:753-825): per mode, first-order-corrected
    MTTKRP from the caches, S from *current* factors, damped solve.
    Returns (Ws_new, dWs_new, grads)."""
    order = len(Ws)
    Ws = list(Ws)
    dWs = list(dWs)
    grads = [None] * order
    for i in range(order):
        M = contract.pp_correct_mttkrp(single[i], pair, dWs, i, layout)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=lam, layout=layout)
        grads[i] = contract.gradsubprob(M, S, Ws[i])
        if solver == "svd":
            Ws[i], dWs[i] = solve.svd_solve_mod(M, W_init[i], S, ratio_step,
                                                rcond)
        else:
            Ws[i], dWs[i] = _chol_solve_mod(M, W_init[i], S, ratio_step)
    if normalize:
        Ws = contract.normalize_factors(Ws, layout)
    return Ws, dWs, grads


def _chol_solve_mod(M, W_init, S, ratio_step):
    dW = ratio_step * (solve.cholesky_solve(M, S) - W_init)
    return W_init + dW, dW


def pp_partupdate_sweep(single, pair, Ws, W_init, dWs, dMs, Ms, ms_set,
                        rel_perturbe, grads, lam, ratio_step,
                        *, update_size: int, solver: str = "svd",
                        layout=None):
    """One PP partial-update sweep (alsCP_PP_partupdate_sub,
    als_CP.cxx:852-1073; JAX cp.py:188-254).

    Solves only the ``update_size`` modes with the largest relative
    perturbation ||dM_i||/||M_i|| (als_CP.cxx:992-1001), propagating each
    solve's dW into the other modes' dM accumulators at once
    (als_CP.cxx:1037-1053). The JAX package picks each slot's mode on the
    device with ``lax.switch``; the port ranks on the host, with one pull
    of the ranking per sweep. The sort is stable: ``rel_perturbe`` starts
    at zeros, so the first sweep's ties go to the lower mode index, as in
    the JAX package. The solve takes the configured cutoff (no ``rcond``),
    as the JAX package's branch does.

    State: dMs (accumulated corrections), Ms (the last M of each mode),
    ms_set (a host tuple of bools: which modes have been solved since the
    phase began) and rel_perturbe. Returns all of it updated, and the
    per-mode grads (a mode not solved keeps its grad). ``layout``: each
    solve's corrections are summed over its mode's axis (one all_reduce
    for all of them) and the norms of ``rel_perturbe`` over the rows, so
    every rank ranks the modes alike."""
    order = len(Ws)
    Ws, dWs, dMs, Ms = list(Ws), list(dWs), list(dMs), list(Ms)
    grads, ms_set = list(grads), list(ms_set)
    ranked = torch.argsort(-rel_perturbe, stable=True).tolist()
    for b in ranked[:update_size]:
        M = single[b] + dMs[b]
        S = contract.hadamard_gram(Ws, skip_mode=b, regul=lam, layout=layout)
        grads[b] = contract.gradsubprob(M, S, Ws[b])
        if solver == "svd":
            Ws[b], dWs[b] = solve.svd_solve_mod(M, W_init[b], S, ratio_step)
        else:
            Ws[b], dWs[b] = _chol_solve_mod(M, W_init[b], S, ratio_step)
        Ms[b] = M
        others = [ii for ii in range(order) if ii != b]
        # each term contracts mode b: one all_reduce over b's axis
        terms = pmesh.row_sum([contract._einsum(
            "Zab,bZ->aZ", pair[(ii, b)], dWs[b]) if ii < b else
            contract._einsum("Zab,aZ->bZ", pair[(b, ii)], dWs[b])
            for ii in others], [b] * len(others), layout)
        for ii, t in zip(others, terms):
            dMs[ii] = dMs[ii] + t
        dMs[b] = torch.zeros_like(dMs[b])
        ms_set[b] = True
    zero = torch.zeros((), dtype=rel_perturbe.dtype,
                       device=rel_perturbe.device)
    n = contract.factor_norms(list(dMs) + list(Ms), layout,
                              [k % order for k in range(2 * order)])
    rel = torch.stack([
        (n[i] / torch.clamp(n[order + i], min=1e-30)).to(rel_perturbe.dtype)
        if ms_set[i] else zero for i in range(order)])
    Ws = contract.normalize_factors(Ws, layout)
    return Ws, dWs, dMs, Ms, tuple(ms_set), rel, grads


def factor_norm_ratios(Ws, dWs, layout=None):
    """||dW_i|| / ||W_i|| for all modes (restart checks,
    als_CP.cxx:594-603, 659-664); ``layout``: of the whole factors
    (contract.factor_norms, one buffer per axis)."""
    order = len(Ws)
    n = contract.factor_norms(list(dWs) + list(Ws), layout,
                              [k % order for k in range(2 * order)])
    return torch.stack([n[i] / n[order + i] for i in range(order)])


def ratios_and_gradnorm(Ws, dWs, grads, layout=None):
    """[factor_norm_ratios..., gradnorm-of-grads] in one tensor, so the PP
    host loop reads both (restart check + gradnorm guard) in one pull
    (under ``layout`` after one all_reduce per axis)."""
    order = len(Ws)
    n = contract.factor_norms(
        list(dWs) + list(Ws), layout, [k % order for k in range(2 * order)],
        sums=[(torch.sum(g * g), k) for k, g in enumerate(grads)])
    r = torch.stack([n[i] / n[order + i] for i in range(order)])
    gn = torch.sqrt(sum(n[2 * order:]))
    return torch.cat([r, gn[None].to(r.dtype)])


def cp_diagnostics(V_norm_sq, V, Ws, lam=None, layout=None):
    """(gradnorm, diffV), both EXACT at the current iterate: gradnorm from
    fresh per-mode MTTKRPs (contract.cp_gradnorm) and diffV via the norm
    identity with a fresh exact MTTKRP. Exact recomputation keeps the
    logged gradnorm on one scale across the DT and PP phases.

    bf16-stored V is upcast to the factor dtype first (JAX cp.py:295-296):
    the mixed-precision rule would otherwise round the factors to bf16 as
    well, and the norm identity's cancellation then clamps diffV to 0.
    Order 3 then reaches the f32 MTTKRP kernels; under ``layout`` on
    this rank's block, each MTTKRP summed over the other sharded modes
    (parallel/mesh.sharded_mttkrp's reduction)."""
    if V.dtype == torch.bfloat16:
        V = V.to(Ws[0].dtype)
    gn = contract.cp_gradnorm(V, list(Ws), regul=lam, layout=layout)
    M_last = contract.mttkrp(V, Ws, len(Ws) - 1, layout=layout)
    diffV = contract.cp_residual_norm(V_norm_sq, M_last, Ws, layout)
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
                  history, layout=None):
    """Run EXACT diagnostics with excluded time, log a CSV row, return
    scalars. Queued sweep work is synced BEFORE the excluded window opens,
    so it counts toward dtime. Under ``layout`` the time limit reads rank
    0's clock, and the CSV's dimension column is the unsharded tensor's
    (padding excluded, as one process writes it)."""
    _sync()
    with clock.exclude():
        gn, diffV = tracing.timed("cp.diagnostics", cp_diagnostics,
                                  V_norm_sq, V, Ws, lam, layout)
        gn, diffV = float(gn), float(diffV)
    dtime = pmesh.agreed_dtime(clock, None if layout is None else layout.mesh,
                               V.device)
    if plot is not None:
        plot.row(V.shape[0] if layout is None else layout.orig_shape[0], it,
                 gn, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, gradnorm=gn, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return gn, diffV, dtime


def als_cp(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None) -> CPResult:
    """Plain ALS (exact MTTKRP each mode). Reference: alsCP (als_CP.cxx:20-115)."""
    def sweep_fn(V, Ws, lam, rcond, solver):
        return simple_sweep(V, Ws, lam, rcond, solver=solver,
                            layout=cfg.mesh_layout)
    return _als_generic(V, Ws, cfg, plot, sweep_fn=sweep_fn)


def als_cp_dt(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None,
              clock: Optional[SweepClock] = None) -> CPResult:
    """DT-ALS. Reference: alsCP_DT (als_CP.cxx:127-320)."""
    def sweep_fn(V, Ws, lam, rcond, solver):
        return dt_sweep(V, Ws, lam, rcond, solver=solver,
                        root_split=cfg.tree_split, layout=cfg.mesh_layout)
    return _als_generic(V, Ws, cfg, plot, sweep_fn=sweep_fn, clock=clock)


def _als_generic(V, Ws, cfg: CPConfig, plot, sweep_fn, clock=None) -> CPResult:
    Ws = list(Ws)
    V_norm_sq = contract.norm_sq(V, cfg.mesh_layout)
    clock = clock or SweepClock()
    history: list = []
    gn, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    while it <= cfg.maxiter:
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, cfg.lam, clock, plot, it, cfg.tol, 0,
                history, cfg.mesh_layout)
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
    layout = cfg.mesh_layout
    W_prev = [torch.zeros_like(W) for W in Ws]
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        if it % cfg.resprint == 0 or it == cfg.maxiter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, cfg.lam, clock, plot, it, cfg.tol, 0,
                state["history"], layout)
            state["last_logged"] = it
            state["gradnorm"], state["diffV"] = gn, diffV
            if gn < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
        Ws, grads = tracing.timed("cp.dt_sweep", dt_sweep, V, Ws, cfg.lam,
                                  cfg.rcond, solver=cfg.solver,
                                  root_split=cfg.tree_split, layout=layout)
        state["grads"] = grads
        dWs = [W - Wp for W, Wp in zip(Ws, W_prev)]
        W_prev = list(Ws)
        ratios = factor_norm_ratios(Ws, dWs, layout).cpu().numpy()
        state["iter"] = it + 1
        if int(np.sum(np.abs(ratios) < cfg.pp_res_tol)) == order:
            return Ws, dWs, "quiet"
    return Ws, dWs, "maxiter"


def _pp_sub(V, Ws, dWs, cfg: CPConfig, plot, clock, state, V_norm_sq,
            partial_update: bool = False):
    """PP sweeps. Reference: alsCP_PP_sub (als_CP.cxx:621-833) /
    alsCP_PP_partupdate_sub (als_CP.cxx:852-1073)."""
    order = V.ndim
    layout = cfg.mesh_layout
    init_iter = state["iter"]
    W_init = None
    single = pair = None
    # partial-update state (als_CP.cxx:886-898): dMs zeroed at the cache
    # build, the rest made at the phase's first sweep
    dMs = Ms = ms_set = rel_perturbe = None
    update_size = max(int(order * cfg.update_percentage), 1) \
        if partial_update else order
    gn_floor = float("inf")  # running min for the gradnorm-growth guard
    Ws_pre, dWs_pre = Ws, dWs  # pre-sweep state (guard revert target)
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        num_dw_break = 0
        if not cfg.bench:  # pp_bench timing mode runs no restart checks
            if cfg.gn_guard and state["grads"] is not None:
                rg = ratios_and_gradnorm(Ws, dWs, state["grads"],
                                         layout).cpu().numpy()
                ratios, gn_est = rg[:-1], float(rg[-1])
                # revert guards: gradnorm growth OR a factor that moved by
                # >> its own norm in one sweep (a last-mode solve explosion
                # is invisible to gn_est)
                if gn_est > cfg.gn_guard * gn_floor or \
                        float(np.max(np.abs(ratios))) \
                        > max(5.0 * cfg.pp_res_tol, 0.5):
                    # discard the blown sweep and restart from the last
                    # healthy iterate; the discarded sweep does not
                    # consume an iteration — EXCEPT when its iteration
                    # number was already logged (rewinding would
                    # duplicate CSV rows)
                    if state.get("last_logged") != it - 1:
                        state["iter"] = it - 1
                    return Ws_pre, dWs_pre, "restart"
                gn_floor = min(gn_floor, gn_est)
            else:
                ratios = factor_norm_ratios(Ws, dWs, layout).cpu().numpy()
            num_dw_break = int(np.sum(np.abs(ratios) > cfg.pp_res_tol))
        if (it - init_iter) % cfg.pp_cache_sweeps == 0 or num_dw_break > 0:
            if num_dw_break > 0 or it != init_iter:
                return Ws, dWs, "restart"
            W_init = list(Ws)
            dWs = [torch.zeros_like(W) for W in Ws]
            single, pair = tracing.timed("cp.pp_cache_build",
                                         pp_build_caches, V, Ws, layout)
            if partial_update:
                dMs = [torch.zeros_like(W) for W in Ws]
        if it % cfg.resprint == 0 or it == cfg.maxiter or it == init_iter:
            gn, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, cfg.lam, clock, plot, it, cfg.tol, 1,
                state["history"], layout)
            state["last_logged"] = it
            state["gradnorm"], state["diffV"] = gn, diffV
            if gn < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
        Ws_pre, dWs_pre = Ws, dWs
        if not partial_update:
            Ws, dWs, grads = tracing.timed(
                "cp.pp_sweep", pp_sweep, single, pair, Ws, W_init, dWs,
                cfg.lam, cfg.ratio_step, cfg.rcond, solver=cfg.solver,
                layout=layout)
        else:
            if Ms is None:
                Ms = [torch.zeros_like(W) for W in Ws]
                ms_set = (False,) * order
                rel_perturbe = torch.zeros(
                    order, dtype=torch.float32
                    if Ws[0].dtype == torch.bfloat16 else Ws[0].dtype,
                    device=Ws[0].device)
            grads = state["grads"] or [torch.zeros_like(W) for W in Ws]
            (Ws, dWs, dMs, Ms, ms_set, rel_perturbe,
             grads) = tracing.timed(
                "cp.pp_partupdate_sweep", pp_partupdate_sweep,
                single, pair, Ws, W_init, dWs, dMs, Ms, ms_set,
                rel_perturbe, grads, cfg.lam, cfg.ratio_step,
                update_size=update_size, solver=cfg.solver, layout=layout)
        state["grads"] = grads
        state["iter"] = it + 1
    return Ws, dWs, "maxiter"


def als_cp_pp(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None,
              partial_update: bool = False,
              clock: Optional[SweepClock] = None) -> CPResult:
    """Outer DT <-> PP loop. Reference: alsCP_PP (als_CP.cxx:1082-1137) /
    alsCP_PP_partupdate (als_CP.cxx:1146-1207): with ``partial_update``
    each PP sweep solves only the ``cfg.update_percentage`` share of the
    modes that moved most (:func:`pp_partupdate_sweep`)."""
    Ws = list(Ws)
    V_norm_sq = contract.norm_sq(V, cfg.mesh_layout)
    clock = clock or SweepClock()
    state = dict(iter=0, grads=None, gradnorm=float("inf"),
                 diffV=float("inf"), history=[])
    dWs = [torch.zeros_like(W) for W in Ws]
    reason = None
    while state["gradnorm"] > cfg.tol and state["iter"] <= cfg.maxiter:
        if not cfg.bench:
            Ws, dWs, reason = _dt_sub(V, Ws, dWs, cfg, plot, clock, state,
                                      V_norm_sq)
            if reason in ("converged", "timelimit", "maxiter"):
                break
        Ws, dWs, reason = _pp_sub(V, Ws, dWs, cfg, plot, clock, state,
                                  V_norm_sq, partial_update=partial_update)
        if reason in ("converged", "timelimit", "maxiter") or cfg.bench:
            break
    return CPResult(Ws, state["gradnorm"], state["diffV"], state["iter"],
                    reason == "converged", state["history"])

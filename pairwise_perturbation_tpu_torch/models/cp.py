"""CP-ALS solvers: plain, dimension-tree (DT), pairwise perturbation (PP)
and PP with partial updates — port of
``pairwise_perturbation_tpu/models/cp.py``.

- :func:`als_cp`    <-> ``alsCP`` (als_CP.cxx:20-115)
- :func:`als_cp_dt` <-> ``alsCP_DT`` (als_CP.cxx:127-320)
- :func:`als_cp_pp` <-> ``alsCP_PP`` = ``alsCP_DT_sub`` <-> ``alsCP_PP_sub``
                        state machine (als_CP.cxx:418-833, 1082-1137);
                        with ``partial_update``, ``alsCP_PP_partupdate``
                        (als_CP.cxx:852-1073, 1146-1207)
- :func:`als_cp_pp_device` and :func:`als_cp_pp_fused`: the same machine
                        with its loop state on the device, a phase a call
                        or a chunk of body steps a call (JAX
                        cp.py:665-1375; ``-device_loop 1`` and ``2``)

Each sweep (DT sweep, PP cache build, PP sweep) is eager PyTorch on the
tensors' device; the DT <-> PP phase machine, restart tolerances and CSV
logging run on the host at per-sweep granularity, reading a few scalars
per sweep. Nothing is compiled, but the first call of a sweep function in
a process pays first-use costs all the same: cuBLAS and cuSOLVER handles
and workspaces, the caching allocator's first blocks, the kernels' build
and load (ops/kernels/_build.load). The JAX package keeps its compile
out of ``dtime`` by running each sweep function once before its loop
(``warm_compile``); the port runs them once the same way
(:func:`warm_run`), at the same places, inside the clock's excluded
window, and its device engines start their clocks after the warm-ups, as
the JAX engines do. There is no relay round-trip, so ``calibrate_rtt``
has no counterpart.

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
    # Mode-minor copies of V (contract.prepare_layouts) for the DT tree's
    # and the PP caches' chain roots, made once before the loop; read by
    # als_cp_dt and the device engines, as in the JAX package (-layouts 1).
    precompute_layouts: bool = False


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
             normalize: bool = True, root_split: int = None, layout=None,
             layouts=None):
    """One full DT-ALS sweep: per-mode MTTKRP from the binary dimension tree,
    S assembly, gradient, solve. Returns (Ws_new, grads).

    Mirrors the per-iteration body of alsCP_DT (als_CP.cxx:215-303),
    including cache freshness: tree nodes are built on first use and reused
    for later modes even after earlier factors updated. ``layout``: V and
    Ws are this rank's blocks; the grads are row blocks. ``layouts``:
    mode-minor copies of V for the tree's first contractions.
    """
    order = V.ndim
    sweep = dimtree.BinaryTreeSweep(V, Ws, root_split=root_split,
                                    layout=layout, layouts=layouts)
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


def pp_build_caches(V, Ws, layout=None, layouts=None):
    """Build PP pair + single caches (als_CP.cxx:667-695); under
    ``layout`` through parallel/mesh.constrained_pp_caches (JAX
    cp.py:537-591), each cache summed over the sharded modes it
    contracted. ``layouts``: mode-minor copies of V for the chain roots
    (K6 then serves none of them)."""
    if layout is not None:
        return pmesh.constrained_pp_caches(V, Ws, layout, layouts)
    return contract.build_pp_caches(V, Ws, layouts=layouts)


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


def warm_run(fn, *args, **kwargs):
    """Call ``fn`` once and wait for the card: the counterpart of the JAX
    package's ``warm_compile`` (cp.py:331-351). An engine calls it on its
    run's own inputs before its loop, inside the clock's excluded window
    (or before it starts its clock), so that what a process pays at the
    first call of a sweep function stays out of ``dtime``. Returns
    ``fn``'s result, which most callers discard.

    Unlike ``warm_compile`` it lets an exception raise: a warm-up that
    fails is a fault of the run, not something to hide. It draws no
    random numbers of its own (every draw of the port is an argument,
    and the callers pass the real call's). It records no tracing scope
    and leaves DEVICE_LOOP_COUNTS as they were; the kernels it reaches
    count their launches, as every launch counts."""
    counts = dict(DEVICE_LOOP_COUNTS)
    with tracing.paused():
        out = fn(*args, **kwargs)
        _sync()
    DEVICE_LOOP_COUNTS.update(counts)
    return out


def _root_modes(V, cfg: CPConfig, pp: bool):
    """The modes whose mode-minor copies ``-layouts 1`` makes: the DT
    tree's chain roots, and with ``pp`` the PP caches' too (JAX
    cp.py:445-452, 916-921), planned on the padded global shape under
    -mesh."""
    shape = contract.plan_shape(V, cfg.mesh_layout)
    modes = set(contract.chain_root_modes_dt(shape, cfg.tree_split))
    if pp:
        modes |= set(contract.chain_root_modes_pp(shape))
    return sorted(modes)


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
    """DT-ALS. Reference: alsCP_DT (als_CP.cxx:127-320). With
    ``cfg.precompute_layouts`` the tree's chain roots read mode-minor
    copies of V, made before the loop in excluded time."""
    layouts = {}

    def sweep_fn(V, Ws, lam, rcond, solver):
        return dt_sweep(V, Ws, lam, rcond, solver=solver,
                        root_split=cfg.tree_split, layout=cfg.mesh_layout,
                        layouts=layouts.get("V"))

    def setup():
        if cfg.precompute_layouts:
            layouts["V"] = contract.prepare_layouts(
                V, _root_modes(V, cfg, pp=False))
    return _als_generic(V, Ws, cfg, plot, sweep_fn=sweep_fn, clock=clock,
                        setup=setup)


def _als_generic(V, Ws, cfg: CPConfig, plot, sweep_fn, clock=None,
                 setup=None) -> CPResult:
    """The loop of :func:`als_cp` and :func:`als_cp_dt`: ``setup()`` and
    one warm sweep (:func:`warm_run`, JAX cp.py:460-461) in excluded
    time, then sweeps with a logged row every ``resprint``."""
    Ws = list(Ws)
    V_norm_sq = contract.norm_sq(V, cfg.mesh_layout)
    clock = clock or SweepClock()
    with clock.exclude():
        if setup is not None:
            setup()
        warm_run(sweep_fn, V, Ws, cfg.lam, cfg.rcond, solver=cfg.solver)
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
    (als_CP.cxx:418-612). Returns (Ws, dWs, exit_reason).

    The first DT phase of a solve runs one warm DT sweep and its ratio
    pull in excluded time (JAX cp.py:485-486 warms the sweep at every
    phase entry, where only the first compiles; here only the first pays
    a first-use cost)."""
    order = V.ndim
    layout = cfg.mesh_layout
    W_prev = [torch.zeros_like(W) for W in Ws]
    if not state.get("dt_warmed"):
        with clock.exclude():
            warm_run(_warm_dt, V, Ws, cfg, layout)
        state["dt_warmed"] = True
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


def _warm_dt(V, Ws, cfg: CPConfig, layout):
    """A DT sweep of the host engine and the pull of its restart ratios,
    as the loop runs them; the results are discarded."""
    Ws2, _ = dt_sweep(V, Ws, cfg.lam, cfg.rcond, solver=cfg.solver,
                      root_split=cfg.tree_split, layout=layout)
    factor_norm_ratios(Ws2, [a - b for a, b in zip(Ws2, Ws)],
                       layout).cpu()


def _warm_pp(caches, Ws, cfg: CPConfig, layout):
    """A PP sweep on ``caches`` from ``Ws`` and the pull of its restart
    ratios and gradnorm, as the loop runs them; the results are
    discarded."""
    Ws2, dWs2, grads = pp_sweep(*caches, Ws, Ws,
                                [torch.zeros_like(W) for W in Ws], cfg.lam,
                                cfg.ratio_step, cfg.rcond, solver=cfg.solver,
                                layout=layout)
    ratios_and_gradnorm(Ws2, dWs2, grads, layout).cpu()


def _pp_sub(V, Ws, dWs, cfg: CPConfig, plot, clock, state, V_norm_sq,
            partial_update: bool = False):
    """PP sweeps. Reference: alsCP_PP_sub (als_CP.cxx:621-833) /
    alsCP_PP_partupdate_sub (als_CP.cxx:852-1073).

    Once a solve, in excluded time (JAX cp.py:531-549): a warm cache build
    (under ``layout`` the constrained one), kept in
    ``state["warm_caches"]`` and used as the phase's first build, since
    the factors do not change in between (JAX cp.py:584-586); and without
    ``partial_update`` one warm PP sweep on it, with its ratio pull."""
    order = V.ndim
    layout = cfg.mesh_layout
    init_iter = state["iter"]
    if not state.get("pp_warmed"):
        with clock.exclude():
            warm = warm_run(pp_build_caches, V, Ws, layout)
            if not partial_update and warm is not None:
                warm_run(_warm_pp, warm, Ws, cfg, layout)
        state["warm_caches"] = warm
        state["pp_warmed"] = True
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
            warm = state.pop("warm_caches", None)
            if warm is not None:
                single, pair = warm     # built from these very factors
            else:
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


# ---------------------------------------------------------------------------
# Device-resident phase loops (JAX cp.py:665-1008; test_als -device_loop 1)
# ---------------------------------------------------------------------------
#
# The host drivers above pull the restart ratios after every sweep. These
# keep a whole DT or PP phase's loop state on the device instead: the sweep
# count, the quiet/broke flag, the gradnorm estimate and its floor, the
# history buffer and the factor snapshot ring. JAX runs the phase as one
# lax.while_loop; eager PyTorch has no device-side loop, so the host issues
# sweeps in chunks of DEVICE_LOOP_CHUNK and reads nothing of the state
# inside a chunk. Each sweep evaluates the while-loop's condition on the
# device and applies its updates through torch.where(active, new, old), so
# a sweep issued after the stop changes nothing (it costs device time, and
# is counted). After each chunk one pull of (active, sweep count) decides
# whether to issue another. The R x R solves still synchronize the card
# (ops/solve.py: torch.linalg.eigh under solver "svd"), so a phase is not
# free of host syncs; it reads no loop state back inside a chunk.

#: Sweeps issued per chunk of a device-resident phase before the host
#: reads the loop's ``active`` flag: at most DEVICE_LOOP_CHUNK - 1 masked
#: sweeps a phase, one pull a chunk. Two, since a masked sweep costs a
#: sweep: DT phases at 200^3 end after about two sweeps, and chunks of 4
#: and 8 masked 24 and 84 of 65 and 125 issued sweeps on an H100
#: (chip_smoke.py phase 14a; PERF.md section 5).
DEVICE_LOOP_CHUNK = 2

#: Host pulls of loop state (a chunk's flag, a phase's history, ring count
#: and labels, its last gradnorm), and by phase kind the sweeps issued and
#: the sweeps masked (issued after the stop) by the device-resident phase
#: loops since the last reset; of the fused machines, the body steps by
#: kind, the chunks and the pulls (a step's register, a chunk's history,
#: ring count and labels).
DEVICE_LOOP_COUNTS = dict(pulls=0, dt_issued=0, dt_masked=0, pp_issued=0,
                          pp_masked=0, fused_dt=0, fused_build=0, fused_pp=0,
                          fused_chunks=0, fused_pulls=0)


def reset_device_loop_counts():
    for k in DEVICE_LOOP_COUNTS:
        DEVICE_LOOP_COUNTS[k] = 0


def _pull(x, key: str = "pulls"):
    """One host read of device loop state, counted under ``key``."""
    DEVICE_LOOP_COUNTS[key] += 1
    return x.cpu()


def _in_dtype(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as the JAX engine's jnp.asarray(x,
    dtype) scalars are (V's dtype for lam and the tolerances)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _row_sums(grads, more=(), layout=None):
    """The squared norms of the (row-block) ``grads``, then the ``more``
    (tensor, mode) sums over a factor's rows, each summed over its mode's
    axis under ``layout`` (one all_reduce per axis for all of them)."""
    order = len(grads)
    return pmesh.row_sum([torch.sum(g * g) for g in grads]
                         + [t for t, _ in more],
                         list(range(order)) + [m for _, m in more], layout)


def _sweep_norm_stats(V_norm_sq, Ws, grads, lam, layout=None):
    """The DT phase's cheap per-sweep (gradnorm, diffV): the exact-solve
    identity ||V - V^||^2 = ||V||^2 - <S_last, W_last^T W_last> (phase
    control only; logged rows are recomputed exactly). ``layout``: the
    grads' norms and the last Gram summed over the rows."""
    order = len(Ws)
    sums = _row_sums(grads, [(contract.gram(Ws[order - 1]), order - 1)],
                     layout)
    gn = torch.sqrt(sum(sums[:order]))
    S_last = contract.hadamard_gram(Ws, skip_mode=order - 1, regul=lam,
                                    layout=layout)
    vhat_sq = torch.sum(S_last * sums[order])
    return gn, torch.sqrt(torch.clamp(V_norm_sq - vhat_sq, min=0.0))


def _exact_row_stats(V, V_norm_sq, Ws, lam, layout=None):
    """EXACT (gradnorm, diffV) of a logged row (:func:`cp_diagnostics`),
    in the factors' dtype."""
    gn, diffV = cp_diagnostics(V_norm_sq, V, list(Ws), lam, layout)
    return gn.to(Ws[0].dtype), diffV.to(Ws[0].dtype)


def _pp_sweep_norm_stats(V_norm_sq, single, pair, Ws, dWs, grads,
                         layout=None):
    """The PP phase's per-sweep (gradnorm, diffV estimate): the norm
    identity with the PP-corrected last-mode MTTKRP, first-order accurate
    in dW and free of V passes (JAX cp.py:711-733 says why the DT
    shortcut drifts here). ``layout``: the grads' norms and the inner
    product summed over the rows."""
    order = len(Ws)
    M_last = contract.pp_correct_mttkrp(single[order - 1], pair, dWs,
                                        order - 1, layout)
    sums = _row_sums(grads, [(torch.sum(M_last * Ws[order - 1]),
                              order - 1)], layout)
    gn = torch.sqrt(sum(sums[:order]))
    S_all = contract.hadamard_gram(Ws, skip_mode=-1, layout=layout)
    return gn, torch.sqrt(torch.clamp(V_norm_sq - 2.0 * sums[order]
                                      + torch.sum(S_all), min=0.0))


def _snap_ring_init(Ws, n_slots: int):
    """Empty factor-snapshot ring on the factors' device: (snaps, labels,
    count)."""
    slots = max(n_slots, 1)
    dev = Ws[0].device
    return ([torch.zeros((slots,) + tuple(W.shape), dtype=W.dtype,
                         device=dev) for W in Ws],
            torch.full((slots,), -1, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _ring_overflow(sn: int, n_slots: int, what: str):
    """Warn when a ring counted more logged rows than it has slots (its
    overflow rows keep the in-loop estimates), as the JAX engines do."""
    if sn > n_slots:
        import warnings
        warnings.warn(f"{what} snapshot ring overflow: {sn} logged rows > "
                      f"{n_slots} slots; {sn - n_slots} rows fall back to "
                      "in-loop estimates")


def _logged(it: int, resprint: int, log_mark: int) -> bool:
    """Whether the host logs global iteration ``it`` (a ring snapshot)."""
    return bool(resprint) and (it % resprint == 0 or it == log_mark)


def _record(st, j, on, row, Ws2, it0, resprint, log_mark, n_slots, snaps,
            labels):
    """Sweep ``j``'s history row and, on a logged iteration, its factor
    snapshot (JAX cp.py:740-757), written where ``on``. A stopped loop
    changes nothing, so while it runs its sweep count is the issue index
    ``j``, and its ring count the logged iterations issued before: the
    host knows every index, and no index is read back."""
    if j < len(st["hist"]):
        st["hist"][j] = torch.where(on, row, st["hist"][j])
    if n_slots and _logged(it0 + j, resprint, log_mark):
        slot = min(st["slot"], n_slots - 1)
        for s, w in zip(snaps, Ws2):
            s[slot] = torch.where(on, w, s[slot])
        labels[slot] = torch.where(on, it0 + j, labels[slot])
        st["count"] = st["count"] + on
        st["slot"] += 1


def _issue_chunks(sweep, st, budget: int, kind: str) -> int:
    """Issue ``sweep(j)`` for j = 0, 1, ... in chunks of DEVICE_LOOP_CHUNK,
    at most ``budget`` in all, pulling (st["on"], st["k"]) after each
    chunk; returns k, the sweeps that ran. ``st["on"]`` starts true (k = 0,
    nothing quiet or broken, the gradnorm estimate infinite), and each
    sweep keeps it the JAX while-loop's condition. ``kind`` ("dt" or "pp")
    names the phase in DEVICE_LOOP_COUNTS."""
    issued, n = 0, 0
    while issued < budget:
        for j in range(issued, min(issued + DEVICE_LOOP_CHUNK, budget)):
            sweep(j)
        issued = min(issued + DEVICE_LOOP_CHUNK, budget)
        flag, n = (int(x) for x in _pull(torch.stack([st["on"], st["k"]])))
        if not flag:
            break
    DEVICE_LOOP_COUNTS[f"{kind}_issued"] += issued
    DEVICE_LOOP_COUNTS[f"{kind}_masked"] += issued - n
    return n


def _loop_state(Ws, max_sweeps: int, n_slots: int, **extra):
    """The loop state both phases start from: k = 0, ``on``, the factors,
    zero dWs, an infinite gradnorm estimate, the history buffer and the
    ring's counts (the snapshots and labels are returned apart)."""
    dev = Ws[0].device
    inf = torch.full((), float("inf"), dtype=Ws[0].dtype, device=dev)
    st = dict(k=torch.zeros((), dtype=torch.int64, device=dev),
              on=torch.ones((), dtype=torch.bool, device=dev), Ws=list(Ws),
              dWs=[torch.zeros_like(W) for W in Ws], gn=inf,
              hist=torch.zeros((max_sweeps, 2), dtype=Ws[0].dtype,
                               device=dev), slot=0, **extra)
    snaps, labels, st["count"] = _snap_ring_init(Ws, n_slots)
    return st, snaps, labels


def _commit(st, on, **new):
    """Each ``new`` value replaces the state's where ``on``; k counts the
    sweep."""
    for key, x in new.items():
        st[key] = [torch.where(on, a, b) for a, b in zip(x, st[key])] \
            if isinstance(x, list) else torch.where(on, x, st[key])
    st["k"] = st["k"] + on


def dt_phase_device(V, Ws, lam, tol_init, gn_tol, it_budget: int, it0=0,
                    log_mark=-1, *, solver: str = "svd",
                    max_sweeps: int = 256, resprint: int = 0,
                    root_split: int = None, n_slots: int = 0, layout=None,
                    layouts=None, V_norm_sq=None):
    """DT sweeps with their loop on the device until every mode is quiet
    (||dW||/||W|| < tol_init, alsCP_DT_sub:594-605), the gradnorm
    estimate falls below gn_tol, or ``it_budget`` sweeps ran (JAX
    cp.py:760-823).

    Sweep k is global iteration it0 + k; the rows the host will log
    ((it0 + k) % resprint == 0, or == log_mark) snapshot the factors into
    a ring of ``n_slots``. ``hist`` rows hold :func:`_sweep_norm_stats`'
    estimates. Returns (n_sweeps, Ws, dWs, gn, quiet, hist[max_sweeps, 2],
    snaps, labels, count): n_sweeps a host int (pulled with the last
    chunk's flag), the rest device tensors, as the JAX while-loop's.

    ``layout`` (-mesh): V and Ws are this rank's blocks; the flag is
    computed from all-reduced values, so every rank issues the same
    sweeps, and the ring holds this rank's blocks. ``layouts``: mode-minor
    copies of V. ``V_norm_sq``: ||V||^2 if known (else computed)."""
    if V_norm_sq is None:
        V_norm_sq = contract.norm_sq(V, layout)
    st, snaps, labels = _loop_state(
        Ws, max_sweeps, n_slots, W_prev=[torch.zeros_like(W) for W in Ws],
        quiet=torch.zeros((), dtype=torch.bool, device=V.device))

    def sweep(j):
        on = st["on"]
        Ws2, grads = dt_sweep(V, st["Ws"], lam, solver=solver,
                              root_split=root_split, layout=layout,
                              layouts=layouts)
        dWs2 = [a - b for a, b in zip(Ws2, st["W_prev"])]
        quiet2 = torch.all(torch.abs(factor_norm_ratios(Ws2, dWs2, layout))
                           < tol_init)
        gn2, diffV = _sweep_norm_stats(V_norm_sq, Ws2, grads, lam, layout)
        gn2 = gn2.to(st["gn"].dtype)
        _record(st, j, on, torch.stack([gn2, diffV.to(gn2.dtype)]), Ws2,
                it0, resprint, log_mark, n_slots, snaps, labels)
        _commit(st, on, Ws=Ws2, W_prev=Ws2, dWs=dWs2, gn=gn2, quiet=quiet2)
        st["on"] = on & ~quiet2 & (gn2 >= gn_tol)

    n = _issue_chunks(sweep, st, it_budget, "dt")
    return (n, st["Ws"], st["dWs"], st["gn"], st["quiet"], st["hist"], snaps,
            labels, st["count"])


def pp_phase_device(V, Ws, lam, ratio_step, tol_init, gn_tol,
                    it_budget: int, it0=0, log_mark=-1, gn_guard=10.0, *,
                    solver: str = "svd", max_sweeps: int = 15,
                    resprint: int = 0, n_slots: int = 0, layout=None,
                    layouts=None, V_norm_sq=None):
    """Build the PP caches (:func:`pp_build_caches`: K6, with K5 as its
    O3, under ``use_kernels_triple``), then PP sweeps with their loop on
    the device until the restart tolerance trips (any ||dW||/||W|| >
    tol_init, alsCP_PP_sub:656-671), the gradnorm estimate falls below
    gn_tol, or ``it_budget`` sweeps ran (JAX cp.py:826-880).

    The guard (``gn_guard`` > 0): a sweep whose gradnorm estimate passes
    gn_guard x the phase's running minimum, or whose largest ratio passes
    max(5 tol_init, 0.5), is reverted (factors, dWs, gn, diffV) and ends
    the phase. Logging as :func:`dt_phase_device`; ``hist`` holds
    :func:`_pp_sweep_norm_stats`' estimates; ``layout``, ``layouts`` and
    ``V_norm_sq`` as there (the build is the constrained one). Returns
    (n_sweeps, Ws, dWs, gn, hist, snaps, labels, count)."""
    if V_norm_sq is None:
        V_norm_sq = contract.norm_sq(V, layout)
    single, pair = tracing.timed("cp.pp_cache_build", pp_build_caches, V,
                                 list(Ws), layout, layouts)
    W_init = list(Ws)
    bound = max(_in_dtype(5.0 * tol_init, V.dtype), 0.5)
    st, snaps, labels = _loop_state(Ws, max_sweeps, n_slots)
    st["dv_prev"] = st["gn_floor"] = st["gn"]

    def sweep(j):
        on = st["on"]
        Ws2, dWs2, grads = pp_sweep(single, pair, st["Ws"], W_init,
                                    st["dWs"], lam, ratio_step, solver=solver,
                                    layout=layout)
        ratios = torch.abs(factor_norm_ratios(Ws2, dWs2, layout))
        broke2 = torch.any(ratios > tol_init)
        gn2, diffV = _pp_sweep_norm_stats(V_norm_sq, single, pair, Ws2,
                                          dWs2, grads, layout)
        gn2, diffV = gn2.to(st["gn"].dtype), diffV.to(st["gn"].dtype)
        if gn_guard > 0:
            blown = (gn2 > gn_guard * st["gn_floor"]) | \
                (torch.max(ratios) > bound)
            Ws2 = [torch.where(blown, a, b) for a, b in zip(st["Ws"], Ws2)]
            dWs2 = [torch.where(blown, a, b)
                    for a, b in zip(st["dWs"], dWs2)]
            gn2 = torch.where(blown, st["gn"], gn2)
            diffV = torch.where(blown, st["dv_prev"], diffV)
            broke2 = broke2 | blown
        _record(st, j, on, torch.stack([gn2, diffV]), Ws2, it0, resprint,
                log_mark, n_slots, snaps, labels)
        _commit(st, on, Ws=Ws2, dWs=dWs2, gn=gn2, dv_prev=diffV,
                gn_floor=torch.minimum(st["gn_floor"], gn2))
        st["on"] = on & ~broke2 & (gn2 >= gn_tol)

    n = _issue_chunks(sweep, st, it_budget, "pp")
    return (n, st["Ws"], st["dWs"], st["gn"], st["hist"], snaps, labels,
            st["count"])


def _warm_phases(V, V_norm_sq, Ws, lam, ratio_step, *, solver, root_split,
                 layout, layouts):
    """Each function the phase loops' sweeps call, once, on the initial
    factors; the results are discarded."""
    Ws2, grads = dt_sweep(V, Ws, lam, solver=solver, root_split=root_split,
                          layout=layout, layouts=layouts)
    factor_norm_ratios(Ws2, Ws2, layout)
    _sweep_norm_stats(V_norm_sq, Ws2, grads, lam, layout)
    single, pair = pp_build_caches(V, Ws, layout, layouts)
    Ws3, dWs3, grads = pp_sweep(single, pair, Ws, Ws,
                                [torch.zeros_like(W) for W in Ws], lam,
                                ratio_step, solver=solver, layout=layout)
    _pp_sweep_norm_stats(V_norm_sq, single, pair, Ws3, dWs3, grads, layout)
    _exact_row_stats(V, V_norm_sq, Ws, lam, layout)


def als_cp_pp_device(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None,
                     clock: Optional[SweepClock] = None) -> CPResult:
    """Device-resident DT <-> PP solver (``test_als -pp 1 -device_loop
    1``; JAX cp.py:882-1008): the phase machine of :func:`als_cp_pp`, one
    :func:`dt_phase_device` or :func:`pp_phase_device` call a phase.

    Per-sweep rows come from the phases' history buffers, ``dtime``
    interpolated within each phase. A logged row's diagnostics are
    recomputed EXACTLY from the ring's snapshot inside the clock's
    excluded window (K1-K3 for an order-3 float32 V); unlogged rows keep
    the estimates. lam and the tolerances are rounded to V's dtype, as
    the JAX engine's scalars are; no ``rcond`` is passed on, as there.

    Before the first phase the engine makes the mode-minor copies of
    ``cfg.precompute_layouts`` and runs each function the phases call
    once on the initial factors (:func:`warm_run`), then restarts the
    clock (JAX cp.py:916-940: zero-budget phases compile there). Under
    ``cfg.mesh_layout`` V and Ws are this rank's blocks, every flag the
    host reads is all-reduced, the time limit reads rank 0's clock, and
    the CSV's dimension column is the unsharded tensor's. Scopes
    ``cp.dt_phase_device`` and ``cp.pp_phase_device`` time each phase;
    DEVICE_LOOP_COUNTS counts its pulls and masked sweeps."""
    Ws = list(Ws)
    clock = clock or SweepClock()
    layout = cfg.mesh_layout
    mesh = None if layout is None else layout.mesh
    dim = V.shape[0] if layout is None else layout.orig_shape[0]
    lam = _in_dtype(cfg.lam, V.dtype)
    tol_init = _in_dtype(cfg.pp_res_tol, V.dtype)
    gn_tol = _in_dtype(cfg.tol, V.dtype)
    gn_guard = _in_dtype(cfg.gn_guard, Ws[0].dtype)
    V_norm_sq = contract.norm_sq(V, layout)
    layouts = contract.prepare_layouts(V, _root_modes(V, cfg, pp=True)) \
        if cfg.precompute_layouts else None
    warm_run(_warm_phases, V, V_norm_sq, Ws, lam, cfg.ratio_step,
             solver=cfg.solver, root_split=cfg.tree_split, layout=layout,
             layouts=layouts)
    clock.reset()
    history: list = []
    it = 0
    gn = diffV = float("inf")
    # snapshot ring slots: enough for every logged row of one phase
    n_slots = (cfg.maxiter // max(cfg.resprint, 1)) + 3
    mark = cfg.maxiter
    common = dict(solver=cfg.solver, resprint=cfg.resprint, n_slots=n_slots,
                  layout=layout, layouts=layouts, V_norm_sq=V_norm_sq)

    def now():
        return pmesh.agreed_dtime(clock, mesh, V.device)

    def log_phase(hist, n, pp_flag, t_start, t_end, snaps, labels, count):
        nonlocal it, gn, diffV
        h = _pull(hist)[:n].tolist()
        exact = {}
        with clock.exclude():
            sn = int(_pull(count))
            _ring_overflow(sn, n_slots, "phase")
            if sn > 0:
                labels_h = _pull(labels).tolist()
                for slot in range(min(sn, n_slots)):
                    g, d = tracing.timed("cp.diagnostics", _exact_row_stats,
                                         V, V_norm_sq, [s[slot] for s in snaps],
                                         lam, layout)
                    exact[labels_h[slot]] = (float(g), float(d))
        for row_i in range(n):
            dt_row = t_start + (t_end - t_start) * (row_i + 1) / max(n, 1)
            gn, diffV = h[row_i]
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                gn, diffV = exact.get(it, (gn, diffV))
                if plot is not None:
                    plot.row(dim, it, gn, cfg.tol, pp_flag, diffV, dt_row)
                history.append(dict(iter=it, gradnorm=gn, diffV=diffV,
                                    dtime=dt_row, pp=pp_flag))
            it += 1

    while it <= cfg.maxiter:
        t0 = now()
        n, Ws, dWs, gn_d, _, hist, snaps, labels, count = tracing.timed(
            "cp.dt_phase_device", dt_phase_device, V, Ws, lam, tol_init,
            gn_tol, cfg.maxiter + 1 - it, it, mark,
            max_sweeps=cfg.maxiter + 1, root_split=cfg.tree_split, **common)
        t1 = now()
        log_phase(hist, n, 0, t0, t1, snaps, labels, count)
        gn_dt = float(_pull(gn_d))
        if gn_dt < cfg.tol or it > cfg.maxiter or t1 > cfg.timelimit:
            gn = gn_dt
            break
        t0 = now()
        n, Ws, dWs, gn_d, hist, snaps, labels, count = tracing.timed(
            "cp.pp_phase_device", pp_phase_device, V, Ws, lam,
            cfg.ratio_step, tol_init, gn_tol,
            min(cfg.pp_cache_sweeps, cfg.maxiter + 1 - it), it, mark,
            gn_guard, max_sweeps=cfg.pp_cache_sweeps, **common)
        t1 = now()
        log_phase(hist, n, 1, t0, t1, snaps, labels, count)
        gn = float(_pull(gn_d))
        if gn < cfg.tol or t1 > cfg.timelimit:
            break
    return CPResult(Ws, gn, diffV, it, gn < cfg.tol, history)


# ---------------------------------------------------------------------------
# The fused DT <-> PP machine (JAX cp.py:1010-1375; test_als -device_loop 2)
# ---------------------------------------------------------------------------
#
# The whole outer machine of alsCP_PP (als_CP.cxx:1082-1137) as one carry
# with a phase register: 0 a DT sweep (every ratio below tol_init -> 1),
# 1 a PP cache build (-> 2; a body step that is no iteration), 2 a PP
# sweep (a ratio above tol_init, the pp_cap-th sweep since the build or
# the guard -> 0). JAX runs ``chunk`` body steps as one lax.while_loop
# over a lax.switch. Eager PyTorch has no device-side switch, and running
# the three branches masked would pay a DT sweep, a cache build and a PP
# sweep every step, so the device decides and the host dispatches: each
# DT or PP step writes the next phase and the stop flag into a register
# on the card, and the host reads it in one counted pull before it issues
# the next step (a build step's successor is always a PP step: no pull).
# From that sequence the host keeps the iteration, the PP sweeps since
# the build and the ring's slot itself; the factors, dWs, W_init, the
# caches, the gradnorm estimate and its guard floor, the history and the
# snapshot ring stay on the card, read once a chunk as in JAX.
#
# This is not one dispatch a chunk: the R x R solves still synchronize
# the card (torch.linalg.eigh in ops/solve.py, 3-4 times a sweep), and a
# chunk cannot be captured as a CUDA graph while they do. The register
# pull costs one more sync a step.

#: Body steps of the fused machine between two reads of its history
#: (the JAX CLI's chunk).
FUSED_CHUNK = 64

def _pair_keys(order: int):
    return [(i, j) for i in range(order) for j in range(i + 1, order)]


def pp_fused_init(V, Ws, max_hist: int, n_slots: int = 0):
    """The initial carry of :func:`pp_fused_chunk` (JAX cp.py:1035-1061):
    host ints (``it`` the completed sweeps, ``age`` the PP sweeps since
    the build, ``slot`` the ring's next slot, and ``phase`` and ``stop``,
    the host's last read of the device's register ``reg``) and device
    tensors (the factors, W_prev, dWs, W_init, the caches, made at the
    first build, the gradnorm estimate ``gn`` and the guard floor, the
    history ``hist[it] = [gn, diffV, pp_flag]`` and the snapshot ring:
    ``snaps``, ``labels``, ``count``)."""
    Ws = list(Ws)
    dev, dtype = Ws[0].device, Ws[0].dtype
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    snaps, labels, count = _snap_ring_init(Ws, n_slots)
    return dict(it=0, age=0, slot=0, phase=0, stop=False,
                reg=torch.zeros(2, dtype=torch.int64, device=dev), Ws=Ws,
                W_prev=[torch.zeros_like(W) for W in Ws],
                dWs=[torch.zeros_like(W) for W in Ws], W_init=list(Ws),
                single=None, pair=None, gn=inf, gn_floor=inf,
                hist=torch.zeros((max_hist, 3), dtype=dtype, device=dev),
                snaps=snaps, labels=labels, count=count)


def _fused_row(c, it2, gn2, dv2, pp_flag, Ws2, resprint, maxiter, n_slots):
    """Sweep ``it2``'s history row and, on a row the host will log
    (it2 % resprint == 0, or it2 >= maxiter), its factor snapshot (JAX
    cp.py:1093-1111). The host knows it2 and the slot: nothing is read
    back."""
    idx = min(it2, c["hist"].shape[0] - 1)
    c["hist"][idx] = torch.stack([gn2, dv2, torch.full_like(gn2, pp_flag)])
    if resprint and n_slots and (it2 % resprint == 0 or it2 >= maxiter):
        slot = min(c["slot"], n_slots - 1)
        for s, w in zip(c["snaps"], Ws2):
            s[slot] = w
        # fill_ takes the label as a kernel argument; an item assignment
        # would copy it from the host and synchronize
        c["labels"][slot].fill_(it2)
        c["count"] = c["count"] + 1
        c["slot"] += 1


def _fused_register(c, phase2, stop2):
    """Write the next phase and the stop flag into the device register
    and read both in one counted pull."""
    c["reg"] = torch.stack([phase2.to(torch.int64), stop2.to(torch.int64)])
    c["phase"], stop = _pull(c["reg"], "fused_pulls").tolist()
    c["stop"] = bool(stop)


def _drain_ring(c, clock, n_slots: int, diag):
    """After a chunk: the history rows (host lists) and {label:
    diag(snapshot factors)} of the ring's snapshots, the diagnostics
    inside the clock's excluded window; then the ring is reset (JAX
    cp.py:1318-1348)."""
    rows = _pull(c["hist"], "fused_pulls").tolist()
    by_label = {}
    with clock.exclude():
        n = int(_pull(c["count"], "fused_pulls"))
        _ring_overflow(n, n_slots, "fused")
        if n > 0:
            labels = _pull(c["labels"], "fused_pulls").tolist()
            for slot in range(min(n, len(labels))):
                by_label[labels[slot]] = diag([s[slot] for s in c["snaps"]])
    if n > 0:
        c["count"] = torch.zeros_like(c["count"])
        c["slot"] = 0
    return rows, by_label


def pp_fused_chunk(V, carry, lam, ratio_step, tol_init, gn_tol, maxiter: int,
                   gn_guard=0.0, rcond=None, *, solver: str = "svd",
                   chunk: int = FUSED_CHUNK, resprint: int = 10,
                   pp_cap: int = 15, root_split: int = None,
                   n_slots: int = 0, V_norm_sq=None, layout=None,
                   layouts=None):
    """Advance the fused machine by up to ``chunk`` body steps, or to the
    stop (JAX cp.py:1064-1222); returns the carry, updated in place.

    The sweep taking ``it -> it + 1`` writes ``hist[it + 1]``, the
    estimates of the post-sweep state (:func:`_sweep_norm_stats` after a
    DT sweep, :func:`_pp_sweep_norm_stats` after a PP sweep). A cache
    build (:func:`pp_build_caches`: K6, with K5 as its O3, under
    ``use_kernels_triple``) zeroes dWs, anchors W_init and seeds the
    guard floor with the DT gradnorm estimate (JAX cp.py:1150-1156; the
    phase engine's floor starts at inf). The guard (``gn_guard`` > 0)
    reverts a PP sweep whose estimate passes gn_guard x the floor, or
    whose largest ratio passes max(5 tol_init, 0.5); its row keeps
    ``hist[it]``'s diffV. A PP step that returns to DT zeroes W_prev.
    The run stops at gn < gn_tol or it > maxiter. ``layout`` (-mesh): V
    and the carry's factors are this rank's blocks, the caches the
    constrained ones, and the register is written from all-reduced
    values, so every rank issues the same steps. ``layouts``: mode-minor
    copies of V. Scopes ``cp.fused_dt_step``, ``cp.fused_build_step`` and
    ``cp.fused_pp_step`` time the body steps; DEVICE_LOOP_COUNTS counts
    them and the pulls."""
    c = carry
    if V_norm_sq is None:
        V_norm_sq = contract.norm_sq(V, layout)
    bound = max(_in_dtype(5.0 * tol_init, c["gn"].dtype), 0.5)
    dtype = c["gn"].dtype

    def dt_step():
        Ws2, grads = dt_sweep(V, c["Ws"], lam, rcond, solver=solver,
                              root_split=root_split, layout=layout,
                              layouts=layouts)
        dWs2 = [a - b for a, b in zip(Ws2, c["W_prev"])]
        quiet = torch.all(torch.abs(factor_norm_ratios(Ws2, dWs2, layout))
                          < tol_init)
        gn2, dv2 = _sweep_norm_stats(V_norm_sq, Ws2, grads, lam, layout)
        gn2, dv2 = gn2.to(dtype), dv2.to(dtype)
        it2 = c["it"] + 1
        _fused_row(c, it2, gn2, dv2, 0.0, Ws2, resprint, maxiter, n_slots)
        stop2 = (gn2 < gn_tol) | (it2 > maxiter)
        c.update(it=it2, Ws=Ws2, W_prev=Ws2, dWs=dWs2, gn=gn2)
        _fused_register(c, torch.where(quiet & ~stop2, 1, 0), stop2)

    def build_step():
        c["single"], c["pair"] = pp_build_caches(V, c["Ws"], layout,
                                                 layouts)
        c.update(phase=2, age=0, dWs=[torch.zeros_like(W) for W in c["Ws"]],
                 W_init=list(c["Ws"]), gn_floor=c["gn"])

    def pp_step():
        Ws, dWs = c["Ws"], c["dWs"]
        Ws2, dWs2, grads = pp_sweep(c["single"], c["pair"], Ws, c["W_init"],
                                    dWs, lam, ratio_step, rcond,
                                    solver=solver, layout=layout)
        ratios = torch.abs(factor_norm_ratios(Ws2, dWs2, layout))
        broke = torch.any(ratios > tol_init)
        gn2, dv2 = _pp_sweep_norm_stats(V_norm_sq, c["single"], c["pair"],
                                        Ws2, dWs2, grads, layout)
        gn2, dv2 = gn2.to(dtype), dv2.to(dtype)
        it, age2 = c["it"], c["age"] + 1
        if gn_guard > 0:
            blown = (gn2 > gn_guard * c["gn_floor"]) | \
                (torch.max(ratios) > bound)
            Ws2 = [torch.where(blown, a, b) for a, b in zip(Ws, Ws2)]
            dWs2 = [torch.where(blown, a, b) for a, b in zip(dWs, dWs2)]
            gn2 = torch.where(blown, c["gn"], gn2)
            dv2 = torch.where(blown, c["hist"][min(it, c["hist"].shape[0]
                                                   - 1), 1], dv2)
            broke = broke | blown
        _fused_row(c, it + 1, gn2, dv2, 1.0, Ws2, resprint, maxiter,
                   n_slots)
        stop2 = (gn2 < gn_tol) | (it + 1 > maxiter)
        c.update(it=it + 1, age=age2, Ws=Ws2, dWs=dWs2, gn=gn2,
                 gn_floor=torch.minimum(c["gn_floor"], gn2))
        _fused_register(c, torch.where(broke | (age2 >= pp_cap), 0, 2),
                        stop2)
        if c["phase"] == 0:
            # DT starts from W_prev = 0 (alsCP_DT_sub), so its first
            # sweep never reads as quiet
            c["W_prev"] = [torch.zeros_like(W) for W in Ws2]

    steps = {0: ("dt", dt_step), 1: ("build", build_step), 2: ("pp", pp_step)}
    DEVICE_LOOP_COUNTS["fused_chunks"] += 1
    for _ in range(chunk):
        if c["stop"]:
            break
        kind, step = steps[c["phase"]]
        DEVICE_LOOP_COUNTS[f"fused_{kind}"] += 1
        tracing.timed(f"cp.fused_{kind}_step", step)
    return c


def _warm_fused(V, Ws, chunk_args, chunk_kw):
    """One DT step, one cache build and one PP step of the fused machine
    on a carry of its own, thrown away after (JAX cp.py:1282-1291 runs
    the chunk on a stopped carry to compile it)."""
    c = pp_fused_init(V, Ws, 3, 1)
    pp_fused_chunk(V, c, *chunk_args, **dict(chunk_kw, chunk=1, n_slots=1))
    c.update(phase=1, stop=False)
    pp_fused_chunk(V, c, *chunk_args, **dict(chunk_kw, chunk=2, n_slots=1))


def als_cp_pp_fused(V, Ws, cfg: CPConfig, plot: Optional[PlotFile] = None,
                    clock: Optional[SweepClock] = None,
                    chunk: int = FUSED_CHUNK) -> CPResult:
    """The fused DT <-> PP solver (``test_als -pp 1 -device_loop 2``; JAX
    cp.py:1225-1375): :func:`pp_fused_chunk` until the stop, the time
    limit, iteration maxiter + 1 or a chunk that made no progress.

    After each chunk the host pulls the history, the ring's count and
    labels, computes EXACT (gradnorm, diffV) by :func:`cp_diagnostics`
    (K1-K3 for an order-3 float32 V) from each snapshot inside the clock's
    excluded window, warns if the ring overflowed (its rows then keep the
    estimates), and resets the ring. Rows are logged where label %
    resprint == 0 or label == maxiter, each ``dtime`` interpolated across
    its chunk; the iteration-0 row and the final result are exact too.
    lam, ratio_step, the tolerances, gn_guard and ``cfg.rcond`` (passed
    on, unlike the phase engine) are rounded to the factors' dtype, as
    the JAX engine's scalars are. Before the first chunk, in excluded
    time: the mode-minor copies of ``cfg.precompute_layouts``, the carry,
    a warm DT step, cache build and PP step on a carry thrown away, and a
    warm :func:`cp_diagnostics` (:func:`warm_run`; JAX cp.py:1277-1293).
    ``cfg.mesh_layout`` as in :func:`als_cp_pp_device`."""
    Ws = list(Ws)
    clock = clock or SweepClock()
    layout = cfg.mesh_layout
    mesh = None if layout is None else layout.mesh
    dim = V.shape[0] if layout is None else layout.orig_shape[0]
    dtype = Ws[0].dtype
    lam = _in_dtype(cfg.lam, dtype)
    ratio_step = _in_dtype(cfg.ratio_step, dtype)
    tol_init = _in_dtype(cfg.pp_res_tol, dtype)
    gn_tol = _in_dtype(cfg.tol, dtype)
    gn_guard = _in_dtype(cfg.gn_guard, dtype)
    rcond = None if cfg.rcond is None else _in_dtype(cfg.rcond, dtype)
    V_norm_sq = contract.norm_sq(V, layout)
    max_hist = cfg.maxiter + 2
    # the ring covers one chunk's logged rows: drained after every chunk
    n_slots = min(cfg.maxiter // max(cfg.resprint, 1) + 4,
                  chunk // max(cfg.resprint, 1) + 4)
    history: list = []

    def exact(Ws_):
        gn_, dv_ = tracing.timed("cp.diagnostics", cp_diagnostics,
                                 V_norm_sq, V, Ws_, lam, layout)
        return float(gn_), float(dv_)

    def now():
        return pmesh.agreed_dtime(clock, mesh, V.device)

    with clock.exclude():
        layouts = contract.prepare_layouts(V, _root_modes(V, cfg, pp=True)) \
            if cfg.precompute_layouts else None
        chunk_args = (lam, ratio_step, tol_init, gn_tol, cfg.maxiter,
                      gn_guard, rcond)
        chunk_kw = dict(solver=cfg.solver, chunk=chunk, resprint=cfg.resprint,
                        pp_cap=cfg.pp_cache_sweeps, root_split=cfg.tree_split,
                        n_slots=n_slots, V_norm_sq=V_norm_sq, layout=layout,
                        layouts=layouts)
        carry = pp_fused_init(V, Ws, max_hist, n_slots)
        warm_run(_warm_fused, V, Ws, chunk_args, chunk_kw)
        warm_run(exact, Ws)
        gn, diffV = exact(Ws)
    t_prev = now()
    if plot is not None:
        plot.row(dim, 0, gn, cfg.tol, 0, diffV, t_prev)
    history.append(dict(iter=0, gradnorm=gn, diffV=diffV, dtime=t_prev,
                        pp=0))

    prev_it = 0
    while True:
        pp_fused_chunk(V, carry, *chunk_args, **chunk_kw)
        it_now, stop = carry["it"], carry["stop"]
        _sync()
        t_now = now()
        if it_now > prev_it:
            rows_all, by_label = _drain_ring(carry, clock, n_slots, exact)
            for off, label in enumerate(range(prev_it + 1, it_now + 1)):
                dt_row = t_prev + (t_now - t_prev) * (off + 1) / (
                    it_now - prev_it)
                gn, diffV, ppf = rows_all[label]
                ppf = int(ppf > 0.5)
                gn, diffV = by_label.get(label, (gn, diffV))
                if label % cfg.resprint == 0 or label == cfg.maxiter:
                    if plot is not None:
                        plot.row(dim, label, gn, cfg.tol, ppf, diffV, dt_row)
                    history.append(dict(iter=label, gradnorm=gn,
                                        diffV=diffV, dtime=dt_row, pp=ppf))
        done = stop or it_now > cfg.maxiter or t_now > cfg.timelimit \
            or it_now == prev_it
        prev_it, t_prev = it_now, t_now
        if done:
            break
    Ws_f = carry["Ws"]
    with clock.exclude():
        gn, diffV = exact(Ws_f)
    return CPResult(Ws_f, gn, diffV, prev_it, gn < cfg.tol, history)

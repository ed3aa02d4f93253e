"""Sparse Tucker-ALS solvers (COO tensors): HOOI and pairwise perturbation
— port of ``pairwise_perturbation_tpu/models/sparse_tucker.py``.

Reference: the ``-issparse`` path of the legacy Tucker driver, which runs
alsTucker / alsTucker_PP on sparse CTF tensors (test_ALS.cxx:229,
364-396). As in the JAX package:

- an exact sweep contracts ONE mode of the nonzeros (ops/sparse.ttm_dense,
  the mode that shrinks the tensor most) and finishes each TTMc densely;
- HOSVD is a randomized range sketch of each mode's unfolding computed on
  the nonzeros (ops/sparse.mode_subspace_sketch and a power pass), the
  sparse analogue of the reference's randomized_svd
  (common.cxx:691-708); HOOI corrects it;
- PP cache builds densify through memoized sparse TTMs
  (ops/sparse.build_ttmc_caches) and the PP sweep is the dense engine's
  (models/tucker.tucker_pp_sweep), since caches and factors are dense.

Each sweep is eager PyTorch on the tensors' device and the phase machine
runs on the host. After the HOSVD, in excluded time, the engines run one
HOOI sweep (and the PP engine one cache build, discarded) through
cp.warm_run, where the JAX package warms them (sparse_tucker.py:141-148,
190-199). The sketch matrices, drawn with ``jax.random`` there,
are arguments here (``omegas``), drawn by default by
ops/sparse.sketch_rows.

``mesh=`` (a 1D ``DeviceMesh``, parallel/mesh.py) runs the engines on an
nnz-sharded COO, one process per rank, as the JAX package's ``mesh``
does: ``st`` is this rank's shard (parallel/mesh.shard_coo), and every
TTMc, cache build and ||V||^2 sums the ranks' partials with one
all_reduce. The sketch HOSVD runs on ``init_st``, the unsharded COO
(JAX sparse_tucker.py:143-144), on rank 0 alone, and its factors are
broadcast, so the ranks start from the same bits (``index_add_`` on the
card adds in no fixed order). The time limit is rank 0's clock,
broadcast; every other decision reads all-reduced values.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pairwise_perturbation_tpu_torch.models import cp as cpm
from pairwise_perturbation_tpu_torch.models import tucker as tkm
from pairwise_perturbation_tpu_torch.ops import contract, solve
from pairwise_perturbation_tpu_torch.models.sparse_cp import norm_sq
from pairwise_perturbation_tpu_torch.ops import sparse as sp
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
from pairwise_perturbation_tpu_torch.utils import tracing
from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile, SweepClock


def _sp_ttmc(st, Ws, skip_mode, mesh=None):
    """Sparse-first TTMc; under ``mesh`` the ranks' partials summed
    (parallel/mesh.sharded_sparse_ttmc)."""
    if mesh is not None:
        return pmesh.sharded_sparse_ttmc(st, list(Ws), skip_mode, mesh)
    return sp.ttmc(st, list(Ws), skip_mode=skip_mode)


def sparse_hooi_sweep(st, Ws, sign_refs, *, ranks: Tuple[int, ...],
                      use_sign: bool, mesh=None):
    """One HOOI sweep with a sparse-first TTMc per mode (alsTucker body,
    als_Tucker.cxx:148-163, V sparse), exact eigh. Returns (Ws_new,
    core)."""
    order = st.ndim
    Ws = list(Ws)
    Y_end = None
    for i in range(order):
        Y = _sp_ttmc(st, Ws, i, mesh)
        if i == order - 1:
            Y_end = Y
        ref = sign_refs[i] if use_sign else None
        Ws[i] = tkm._factor_from_Y(Y, i, ranks[i], ref, warm=sign_refs[i],
                                   subspace_iters=0)
    return Ws, contract.ttmc_contract_mode(Y_end, Ws[-1], order - 1)


def sparse_tucker_build_caches(st, Ws, mesh=None):
    """Tucker PP caches from the nonzeros (dense layouts)."""
    if mesh is not None:
        return pmesh.sharded_sparse_ttmc_caches(st, list(Ws), mesh)
    return sp.build_ttmc_caches(st, list(Ws))


def sparse_tucker_diagnostics(V_norm_sq, st, Ws, core_prev_norm, mesh=None):
    """(core norm, diffnorm, diffV) with an exact sparse-TTMc core."""
    cn = torch.linalg.vector_norm(_sp_ttmc(st, Ws, -1, mesh))
    diffnorm = torch.abs(cn - core_prev_norm)
    diffV = torch.sqrt(torch.clamp(V_norm_sq - cn * cn, min=0.0))
    return cn, diffnorm, diffV


# The sketch's oversampling and power passes (JAX sparse_tucker.py:91-92).
SKETCH_OVERSAMPLE = 8
SKETCH_POWER_ITERS = 1


def hosvd_sparse(st, ranks, omegas: Optional[Sequence] = None):
    """Randomized sparse HOSVD (JAX sparse_tucker.py:91-114): per mode a
    range sketch of the unfolding with k = min(r + SKETCH_OVERSAMPLE, s)
    columns, SKETCH_POWER_ITERS power passes, and the leading r left
    singular vectors of the small sketch, sign-fixed. ``omegas[i]`` is
    mode i's (nnz, k) per-nonzero sketch rows (a parity test passes the
    JAX package's); by default ops/sparse.sketch_rows draws them, seeded
    with the mode's index. Returns (core, Ws)."""
    Ws: List = []
    for i in range(st.ndim):
        r = int(ranks[i])
        k = min(r + SKETCH_OVERSAMPLE, st.shape[i])
        rows = omegas[i] if omegas is not None else sp.sketch_rows(st, i, k,
                                                                   i)
        B = sp.mode_subspace_sketch(st, i, rows.to(st.values.device))
        for _ in range(SKETCH_POWER_ITERS):
            Q, _ = torch.linalg.qr(B)
            B = sp.mode_power_iter(st, i, Q)
        U, _, _ = torch.linalg.svd(B, full_matrices=False)
        Ws.append(solve.fix_sign_columns(U[:, :r]))
    return sp.ttmc(st, Ws, skip_mode=-1), Ws


def _diag_and_log(V_norm_sq, st, Ws, cn_prev, clock, plot, it, tol,
                  pp_flag, history, mesh=None):
    cpm._sync()
    with clock.exclude():
        cn, dn, diffV = tracing.timed(
            "sparse_tucker.diagnostics", sparse_tucker_diagnostics,
            V_norm_sq, st, Ws, cn_prev, mesh)
        cn, dn, diffV = float(cn), float(dn), float(diffV)
    dtime = pmesh.agreed_dtime(clock, mesh, st.values.device)
    if plot is not None:
        plot.row(st.shape[0], it, dn, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, diffnorm=dn, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return cn, dn, diffV, dtime


def _init(st, ranks, Ws, omegas, mesh=None, init_st=None):
    """The starting factors: the given ones, or the randomized sparse
    HOSVD (timed) of ``init_st`` (default ``st``). Under ``mesh`` the
    HOSVD needs ``init_st``, runs on rank 0 and is broadcast."""
    if Ws is not None:
        return list(Ws)
    if mesh is None:
        return tracing.timed("sparse_tucker.hosvd", hosvd_sparse,
                             init_st if init_st is not None else st, ranks,
                             omegas)[1]
    if init_st is None:
        raise ValueError("sharded sparse Tucker starts from Ws or from the "
                         "HOSVD of init_st, the unsharded COO")
    if pmesh.rank() == 0:
        Ws = tracing.timed("sparse_tucker.hosvd", hosvd_sparse, init_st,
                           ranks, omegas)[1]
    else:
        Ws = [torch.empty((s, r), dtype=st.dtype, device=st.values.device)
              for s, r in zip(st.shape, ranks)]
    return pmesh.broadcast(Ws, mesh)


def _logged(it: int, cfg) -> bool:
    return it % cfg.resprint == 0 or it == cfg.maxiter


def als_tucker_sparse(st, ranks, cfg: tkm.TuckerConfig,
                      plot: Optional[PlotFile] = None,
                      Ws: Optional[List] = None,
                      clock: Optional[SweepClock] = None,
                      mesh=None,
                      omegas: Optional[Sequence] = None,
                      init_st=None) -> tkm.TuckerResult:
    """Plain sparse HOOI (alsTucker, als_Tucker.cxx:120-176, V sparse)
    from the randomized sparse HOSVD (its sketch rows ``omegas``) or from
    ``Ws``. ``mesh``: ``st`` is this rank's shard and ``init_st`` the
    unsharded COO the HOSVD starts from (see the module docstring)."""
    ranks = tuple(int(r) for r in ranks)
    if mesh is not None:
        pmesh.check_1d(mesh)
    V_norm_sq = norm_sq(st, mesh)
    clock = clock or SweepClock()
    with clock.exclude():
        Ws = _init(st, ranks, Ws, omegas, mesh, init_st)
        cpm.warm_run(sparse_hooi_sweep, st, Ws, list(Ws), ranks=ranks,
                     use_sign=True, mesh=mesh)
    history: list = []
    cn_prev = 0.0
    dn, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    core = None
    while it <= cfg.maxiter:
        if _logged(it, cfg):
            cn_prev, dn, diffV, dtime = _diag_and_log(
                V_norm_sq, st, Ws, cn_prev, clock, plot, it, cfg.tol, 0,
                history, mesh)
            if dn < cfg.tol and it > 0:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        Ws, core = tracing.timed("sparse_tucker.sweep", sparse_hooi_sweep,
                                 st, Ws, list(Ws), ranks=ranks,
                                 use_sign=True, mesh=mesh)
        it += 1
    if core is None:
        core = _sp_ttmc(st, Ws, -1, mesh)
    return tkm.TuckerResult(Ws, core, dn, diffV, it, converged, history)


def als_tucker_pp_sparse(st, ranks, cfg: tkm.TuckerConfig,
                         plot: Optional[PlotFile] = None,
                         Ws: Optional[List] = None,
                         clock: Optional[SweepClock] = None,
                         mesh=None, omegas: Optional[Sequence] = None,
                         init_st=None) -> tkm.TuckerResult:
    """Sparse Tucker PP (alsTucker_PP, als_Tucker.cxx:906-962, V sparse):
    an exact phase of sparse HOOI sweeps with dW tracking and sign fixing
    (from a zero W_prev) until every factor moves less than tol_init; a PP
    phase of the dense engine's tucker_pp_sweep on sparse-built caches,
    at most 15 sweeps, until a factor drifts past tol_init; tol_init x0.9
    while above its floor after each PP phase. ``mesh`` and ``init_st``
    as in :func:`als_tucker_sparse`."""
    ranks = tuple(int(r) for r in ranks)
    if mesh is not None:
        pmesh.check_1d(mesh)
    V_norm_sq = norm_sq(st, mesh)
    clock = clock or SweepClock()
    with clock.exclude():
        Ws = _init(st, ranks, Ws, omegas, mesh, init_st)
        cpm.warm_run(sparse_hooi_sweep, st, Ws, list(Ws), ranks=ranks,
                     use_sign=True, mesh=mesh)
        cpm.warm_run(sparse_tucker_build_caches, st, Ws, mesh)
    history: list = []
    cn_prev = 0.0
    dn, diffV = float("inf"), float("inf")
    tol_init = cfg.pp_res_tol
    it = 0
    core = None

    def result():
        c = core if core is not None else _sp_ttmc(st, Ws, -1, mesh)
        return tkm.TuckerResult(Ws, c, dn, diffV, it, dn < cfg.tol, history)

    while it <= cfg.maxiter and not (dn < cfg.tol and it > 0):
        # exact phase (alsTucker_DT_sub's role)
        W_prev = [torch.zeros_like(W) for W in Ws]
        quiet = False
        while it <= cfg.maxiter:
            if _logged(it, cfg):
                cn_prev, dn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, cn_prev, clock, plot, it, cfg.tol, 0,
                    history, mesh)
                if (dn < cfg.tol and it > 0) or dtime > cfg.timelimit:
                    return result()
            Ws, core = tracing.timed("sparse_tucker.sweep",
                                     sparse_hooi_sweep, st, Ws, list(Ws),
                                     ranks=ranks, use_sign=True, mesh=mesh)
            dWs = [W - Wp for W, Wp in zip(Ws, W_prev)]
            W_prev = list(Ws)
            ratios = cpm.factor_norm_ratios(Ws, dWs).cpu().numpy()
            it += 1
            if int(np.sum(np.abs(ratios) < tol_init)) == len(Ws):
                quiet = True
                break
        if not quiet or it > cfg.maxiter:
            break
        # PP phase (alsTucker_PP_sub)
        single, pair = tracing.timed("sparse_tucker.pp_cache_build",
                                     sparse_tucker_build_caches, st, Ws, mesh)
        W_init = list(Ws)
        dWs = [torch.zeros_like(W) for W in Ws]
        pp_sweeps = 0
        while it <= cfg.maxiter and pp_sweeps < 15:
            if _logged(it, cfg):
                cn_prev, dn, diffV, dtime = _diag_and_log(
                    V_norm_sq, st, Ws, cn_prev, clock, plot, it, cfg.tol, 1,
                    history, mesh)
                if (dn < cfg.tol and it > 0) or dtime > cfg.timelimit:
                    return result()
            Ws, dWs, core, _ = tracing.timed(
                "sparse_tucker.pp_sweep", tkm.tucker_pp_sweep, single, pair,
                Ws, W_init, dWs, ranks=ranks, subspace_iters=0)
            it += 1
            pp_sweeps += 1
            ratios = cpm.factor_norm_ratios(Ws, dWs).cpu().numpy()
            if int(np.sum(np.abs(ratios) > tol_init)) > 0:
                break  # restart: back to the exact phase
        if tol_init > tkm.TOL_INIT_FLOOR:
            tol_init *= tkm.TOL_INIT_DECAY
    return result()

"""Tucker decomposition: HOSVD init, HOOI, dimension-tree ALS and
pairwise-perturbation ALS with SVD sign-fixing — port of
``pairwise_perturbation_tpu/models/tucker.py``.

- :func:`hosvd`         <-> ``hosvd`` / ``get_factor_matrices`` /
                            ``get_core_tensor`` (als_Tucker.cxx:12-70)
- :func:`als_tucker`    <-> ``alsTucker`` (HOOI, als_Tucker.cxx:120-176) and
                            ``alsTucker_DT`` (als_Tucker.cxx:240-424)
- :func:`als_tucker_pp` <-> ``alsTucker_PP`` = ``alsTucker_DT_sub`` <->
                            ``alsTucker_PP_sub`` with the tol_init *= 0.9
                            decay (als_Tucker.cxx:476-962)

A factor update takes the leading r_i left singular vectors of the mode-i
unfolding of Y = TTMc(V, W, skip=i) through a Gram matrix and its eigh,
on the smaller side of the unfolding. Column signs are aligned with the
previous factors so that PP's dW perturbations mean something
(als_Tucker.cxx:632-643, 874-885). Diagnostics use ||V - core x W||^2 =
||V||^2 - ||core||^2 (orthonormal W, core = TTMc(V, W)) instead of a
reconstruction (als_Tucker.cxx:296-311).

Each sweep is eager PyTorch on the tensors' device and the DT <-> PP
phase machine runs on the host, as in models/cp.py: the sweep functions
are warmed once before their loops, where the JAX package warms them
(cp.warm_run, in excluded time; the device engines restart their clocks
after it), and there is no relay round-trip calibration. Where the JAX
package branches on the
device (``lax.cond`` in :func:`tucker_pp_sweep`) the port branches on the
host, and reads the device only when the branch can go the other way.
Every ``jax.random`` draw is an argument here (the randomized HOSVD's
starting bases), drawn by default from seeded CPU ``torch.Generator``s.

``TuckerConfig.mesh_layout`` (the JAX package's name) runs the engines on
a block-sharded V, one process per mesh device (parallel/mesh.py), as
models/cp.py does: V is this rank's block, the factors of sharded modes
are row blocks, and the sweep functions take the layout as ``layout=``.
A TTMc leaf, the core and each PP cache (parallel/mesh.
constrained_ttmc_caches) are summed over the sharded modes they
contracted, Grams and norms over the rows. A sharded mode's factor is
extracted on the small side of its unfolding from reduced Grams, with
the sign fix gathered along the axis; on the mode side the unfolding's
rows are gathered first. HOSVD's Gram of a sharded mode is applied
matrix-free on the subspace route and assembled block by block on the
exact route (see :func:`hosvd`).

:func:`als_tucker_pp_device` and :func:`als_tucker_pp_fused` (``-device_loop
1`` and ``2``) keep the machine's loop state on the device, as
models/cp.py's engines do, on a sharded V as well.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pairwise_perturbation_tpu_torch.models import cp as cpm
from pairwise_perturbation_tpu_torch.ops import contract, dimtree, solve
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
from pairwise_perturbation_tpu_torch.utils import tracing
from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile, SweepClock


# After each PP phase the restart tolerance tol_init shrinks by this factor
# while it is above the floor (als_Tucker.cxx:947-948).
TOL_INIT_DECAY = 0.9
TOL_INIT_FLOOR = 5e-3


@dataclass
class TuckerConfig:
    tol: float = 1e-10
    pp_res_tol: float = 1e-2
    maxiter: int = 250
    timelimit: float = 5e3
    resprint: int = 1
    # Factor extraction: -1 = AUTO (warm-started subspace iteration where
    # the eigh side is large, see _resolve_subspace_iters; exact eigh
    # otherwise), 0 = always exact (reference semantics), > 0 = that many
    # subspace iterations.
    subspace_iters: int = -1
    # Quiet-mode extraction skip inside PP sweeps (tucker_pp_sweep); 0 =
    # off, the reference's semantics and the default.
    pp_quiet_frac: float = 0.0
    # ShardedLayout of a -mesh run (parallel/mesh.plan_layout); None =
    # unsharded.
    mesh_layout: object = None


@dataclass
class TuckerResult:
    factors: List
    core: object
    diffnorm: float
    diffV: float
    iters: int
    converged: bool
    history: list = field(default_factory=list)


class TuckerBinaryTreeSweep:
    """Lazy binary-tree TTMc cache: node (lo, hi) is V with every mode
    outside [lo, hi] contracted with its factor (axis positions kept).
    Mirrors ``ttmc_map_DT`` (als_Tucker.cxx:178-230), top-level nodes
    built from V. ``layout``: planned on the padded global shape, each
    leaf summed over the sharded modes it contracted (nodes stay
    partial)."""

    def __init__(self, V, factors: Sequence, layout=None):
        self.V = V
        self.factors = list(factors)
        self.order = V.ndim
        self.parent = dimtree.binary_parent_map(self.order)
        self.layout = layout
        self.priority = contract.contraction_priority(
            contract.plan_shape(V, layout))
        self._memo: Dict[Tuple[int, int], object] = {}

    def node(self, lo: int, hi: int):
        key = (lo, hi)
        if key in self._memo:
            return self._memo[key]
        plo, phi = self.parent[key]
        T = self.V if (plo, phi) == (0, self.order - 1) \
            else self.node(plo, phi)
        to_contract = [m for m in range(plo, phi + 1) if not lo <= m <= hi]
        for m in contract.order_by_priority(to_contract, self.priority):
            T = contract.ttmc_contract_mode(T, self.factors[m], m)
        self._memo[key] = T
        return T

    def ttmc(self, i: int):
        """Y_i: every mode but i contracted."""
        return pmesh.reduce_modes([self.node(i, i)], self.layout, (i,))[0]


# ---------------------------------------------------------------------------
# Sweeps
# ---------------------------------------------------------------------------


def _topk_subspace(G, r: int, Q0, iters: int):
    """Top eigenpairs of the PSD ``G`` (a matrix, or a function Q -> G Q)
    by subspace iteration from the start basis ``Q0``, then Rayleigh-Ritz.
    Returns (W[m, q], lam[q]) descending, q = Q0's width (the caller keeps
    r of them)."""
    if isinstance(G, torch.Tensor):
        G = G.__matmul__
    Q, _ = torch.linalg.qr(G(Q0))
    for _ in range(max(iters - 1, 0)):
        Q, _ = torch.linalg.qr(G(Q))
    B = Q.T @ G(Q)
    Wk, lam = solve.truncated_eigh(B, B.shape[0])
    return Q @ Wk, lam


# AUTO thresholds (subspace_iters == -1): exact eigh below a Gram side of
# 256, two warm-started iterations at and above it, with the basis kept
# overdetermined (2r <= side). PP sweeps perturb the Y their warm basis
# came from, so they take one iteration from a side of 64.
AUTO_SUBSPACE_MIN_SIDE = 256
AUTO_SUBSPACE_ITERS = 2
PP_AUTO_SUBSPACE_MIN_SIDE = 64
PP_AUTO_SUBSPACE_ITERS = 1


def _resolve_subspace_iters(subspace_iters: int, side: int, r: int,
                            pp: bool = False) -> int:
    """The AUTO sentinel (-1) as a per-mode number of iterations: the
    subspace path for large eigh sides, exact eigh (0) otherwise; ``pp``
    takes the PP-phase thresholds."""
    if subspace_iters >= 0:
        return subspace_iters
    min_side = PP_AUTO_SUBSPACE_MIN_SIDE if pp else AUTO_SUBSPACE_MIN_SIDE
    iters = PP_AUTO_SUBSPACE_ITERS if pp else AUTO_SUBSPACE_ITERS
    if side >= min_side and 2 * r <= side:
        return iters
    return 0


def _factor_from_Y(Y, i: int, r: int, sign_ref=None, warm=None,
                   subspace_iters: int = 0, pp: bool = False, layout=None):
    """Leading r left singular vectors of the mode-i unfolding A (s_i, m)
    of Y, from a Gram matrix and its eigh (JAX tucker.py:185-234):

    - r <= m < s_i: the small side, G = A^T A (m x m), U = A W
      diag(1/sigma), with 1/sigma zeroed below 1e-12 of the largest
      eigenvalue (near-null directions would otherwise scale rounding
      noise into garbage columns);
    - otherwise (r > m included): the mode side, G = A A^T, whose
      orthonormal completion supplies any columns past m.

    With ``subspace_iters`` (resolved by :func:`_resolve_subspace_iters`)
    > 0 and a ``warm`` basis the eigh is warm-started subspace iteration.
    Column signs are fixed, then matched to ``sign_ref`` when given.

    ``layout`` with mode i sharded: Y, ``sign_ref``, ``warm`` and the
    result are this rank's row blocks of mode i, and s_i is the padded
    global size. The small side sums A^T A and A^T warm over the axis
    (one all_reduce); the mode side gathers A's rows (and the references'),
    extracts as one process would and keeps this rank's block."""
    sharded = pmesh.is_sharded(layout, i)
    s_i = layout.padded_shape[i] if sharded else Y.shape[i]
    m = Y.numel() // Y.shape[i]
    if sharded and not r <= m < s_i:
        lo, hi = layout.span(i)

        def full(x):
            return None if x is None else pmesh.gather_rows(x, i, layout)
        U = _factor_from_Y(pmesh.gather_rows(Y, i, layout, dim=i), i, r,
                           full(sign_ref), full(warm), subspace_iters, pp)
        return U[lo:hi].contiguous()
    side = m if r <= m < s_i else s_i
    subspace_iters = _resolve_subspace_iters(subspace_iters, side, r, pp)
    fast = subspace_iters > 0 and warm is not None
    if r <= m < s_i:
        A = Y.movedim(i, 0).reshape(Y.shape[i], m)
        G = A.T @ A
        if fast and r < m:
            G, Q0 = pmesh.row_sum([G, A.T @ warm], [i, i],
                                  layout if sharded else None)
            W, lam = _topk_subspace(G, r, Q0, subspace_iters)
        else:
            if sharded:
                G = pmesh.row_sum([G], [i], layout)[0]
            W, lam = solve.truncated_eigh(G, r)
        floor = 1e-12 * torch.clamp(lam[0], min=1e-30)
        inv_sigma = torch.where(lam > floor,
                                torch.rsqrt(torch.maximum(lam, floor)),
                                torch.zeros_like(lam))
        U = (A @ W) * inv_sigma[None, :]
    else:
        G = contract.mode_gram(Y, i)
        if fast and r < s_i:
            U, _ = _topk_subspace(G, r, warm, subspace_iters)
        else:
            U, _ = solve.truncated_eigh(G, r)
    U = solve.fix_sign_columns(U, layout, i)
    if sign_ref is not None:
        U = solve.sign_match(U, sign_ref, layout, i)
    return U


def _core_from_Y(Y_end, W_last, order: int, layout):
    """The core: the last mode's Y contracted with its factor, summed over
    that mode's axis where it is sharded."""
    core = contract.ttmc_contract_mode(Y_end, W_last, order - 1)
    return pmesh.row_sum([core], [order - 1], layout)[0]


def tucker_dt_sweep(V, Ws, sign_refs, *, ranks: Tuple[int, ...],
                    use_sign: bool, subspace_iters: int = 0, layout=None):
    """One DT Tucker sweep: per mode the tree's TTMc, Gram, eigh and sign
    fix; the core from the last mode's Y (als_Tucker.cxx:342-408,
    568-645). ``sign_refs`` are the warm bases (and the sign references
    with ``use_sign``). Returns (Ws_new, core)."""
    order = V.ndim
    sweep = TuckerBinaryTreeSweep(V, Ws, layout)
    Y_end = None
    for i in range(order):
        Y = sweep.ttmc(i)
        if i == order - 1:
            Y_end = Y
        ref = sign_refs[i] if use_sign else None
        sweep.factors[i] = _factor_from_Y(Y, i, ranks[i], ref,
                                          warm=sign_refs[i],
                                          subspace_iters=subspace_iters,
                                          layout=layout)
    Ws = sweep.factors
    return Ws, _core_from_Y(Y_end, Ws[-1], order, layout)


def tucker_hooi_sweep(V, Ws, *, ranks: Tuple[int, ...], layout=None):
    """One plain HOOI sweep (alsTucker body, als_Tucker.cxx:148-163): a
    full TTMc per mode. Returns (Ws_new, core)."""
    Ws = list(Ws)
    for i in range(V.ndim):
        Ws[i] = _factor_from_Y(
            contract.ttmc(V, Ws, skip_mode=i, layout=layout), i, ranks[i],
            layout=layout)
    return Ws, contract.ttmc(V, Ws, skip_mode=-1, layout=layout)


def tucker_build_caches(V, Ws, layout=None):
    """Tucker PP caches (als_Tucker.cxx:744-760); under ``layout``
    through parallel/mesh.constrained_ttmc_caches."""
    if layout is not None:
        return pmesh.constrained_ttmc_caches(V, Ws, layout)
    return contract.build_ttmc_caches(V, Ws)


def tucker_pp_sweep(single, pair, Ws, W_init, dWs, quiet_tol: float = 0.0,
                    age: int = 0, *, ranks: Tuple[int, ...],
                    subspace_iters: int = 0, layout=None):
    """One PP Tucker sweep (als_Tucker.cxx:823-891): per mode the
    corrected TTMc from the caches, the factor update (AUTO resolved with
    the PP thresholds, warm-started from ``W_init``), the sign fix
    against ``W_init`` and the cumulative dW. Returns (Ws_new, dWs_new,
    core, stationary).

    Quiet-mode skip: with ``quiet_tol`` > 0 and ``age`` > 0 (not the
    first sweep after a cache build), a mode whose other factors have all
    drifted less than ``quiet_tol`` (relative norm, at the sweep's start)
    since the build keeps its factor and computes no TTMc or extraction;
    the last mode's TTMc is always computed, for the core. ``stationary``
    (a Python bool) says every mode was skipped. The JAX package decides
    this with ``lax.cond`` on the device; here it is a host branch, and
    the drift vector is read (once) only when a mode can be quiet."""
    order = len(Ws)
    Ws, dWs = list(Ws), list(dWs)
    quiet = [False] * order
    if quiet_tol > 0 and age > 0:
        n = contract.factor_norms(list(dWs) + list(Ws), layout,
                                  [k % order for k in range(2 * order)])
        rel = torch.stack([n[k] / torch.clamp(n[order + k], min=1e-30)
                           for k in range(order)]).cpu().numpy()
        tol = rel.dtype.type(quiet_tol)
        for i in range(order):
            quiet[i] = bool(np.max(np.where(np.arange(order) == i, 0, rel))
                            < tol)
    Y_end = None
    for i in range(order):
        if i == order - 1 or not quiet[i]:
            Y = contract.pp_correct_ttmc(single[i], pair, dWs, i, layout)
            if i == order - 1:
                Y_end = Y
        if not quiet[i]:
            Ws[i] = _factor_from_Y(Y, i, ranks[i], W_init[i], warm=W_init[i],
                                   subspace_iters=subspace_iters, pp=True,
                                   layout=layout)
        dWs[i] = Ws[i] - W_init[i]
    core = _core_from_Y(Y_end, Ws[-1], order, layout)
    return Ws, dWs, core, all(quiet)


def tucker_diagnostics(V_norm_sq, V, Ws, core_prev_norm, layout=None):
    """(core, core norm, diffnorm, diffV), diffV^2 = ||V||^2 - ||core||^2
    (orthonormal factors)."""
    core = contract.ttmc(V, Ws, skip_mode=-1, layout=layout)
    cn = torch.linalg.vector_norm(core)
    diffnorm = torch.abs(cn - core_prev_norm)
    diffV = torch.sqrt(torch.clamp(V_norm_sq - cn * cn, min=0.0))
    return core, cn, diffnorm, diffV


# ---------------------------------------------------------------------------
# HOSVD
# ---------------------------------------------------------------------------


# Exact eigh up to this Gram side; above it a randomized, 2x oversampled
# subspace iteration (4 iterations), from which HOOI self-corrects.
HOSVD_EXACT_EIGH_MAX = 4096
# The randomized start basis of mode i is drawn from seed HOSVD_SEED + i,
# as the JAX package keys it jax.random.PRNGKey(17 + i).
HOSVD_SEED = 17


def hosvd_draw(shape, dtype, mode: int):
    """The port's (s_i, q) standard-normal start basis of mode ``mode``,
    from a CPU ``torch.Generator`` seeded with HOSVD_SEED + mode (the
    same numbers on every device)."""
    gen = torch.Generator().manual_seed(HOSVD_SEED + mode)
    return torch.randn(shape, generator=gen, dtype=dtype)


def _unfolding(V, i: int):
    """V's mode-i unfolding (rows of mode i), in V's compute dtype (float32
    for bf16 V, whose values it holds exactly)."""
    if V.dtype == torch.bfloat16:
        V = V.float()
    return V.movedim(i, 0).reshape(V.shape[i], -1)


def _gram_apply(V, i: int, layout):
    """Q -> G Q for the Gram G of the sharded mode i, matrix-free:
    G Q = V_(i) (V_(i)^T Q). ``Q`` is whole (padded s_i rows) and
    replicated; V_(i)^T Q is summed over i's axis (a sum over rows), the
    product over the axes of the other sharded modes, and the result's
    row blocks are gathered, so every rank gets the same whole G Q."""
    A = _unfolding(V, i)
    lo, hi = layout.span(i)

    def apply(Q):
        P = pmesh.row_sum([A.T @ Q[lo:hi]], [i], layout)[0]
        GQ = pmesh.reduce_modes([A @ P], layout, (i,))[0]
        return pmesh.gather_rows(GQ, i, layout)
    return apply


def _assembled_gram(V, i: int, layout):
    """The whole Gram of the sharded mode i: each rank of i's axis
    broadcasts its block of the unfolding in turn, every rank forms its
    rows of G against it, and one zero-filled all_reduce over every
    sharded axis assembles G (and sums the other sharded modes'
    partials). V moves once, a block at a time."""
    A = _unfolding(V, i)
    lo, hi = layout.span(i)
    b = hi - lo
    s_i = layout.padded_shape[i]
    G = torch.zeros((s_i, s_i), dtype=A.dtype, device=A.device)
    for c in range(s_i // b):
        G[lo:hi, c * b:(c + 1) * b] = A @ pmesh.broadcast_block(
            A, i, layout, c).T
    return pmesh.reduce_modes([G], layout)[0]


def hosvd(V, ranks: Sequence[int], Q0s: Optional[Sequence] = None,
          layout=None):
    """HOSVD initialization (als_Tucker.cxx:66-70; JAX tucker.py:371-394).
    Returns (core, factors).

    Mode i's factor is the top r_i eigenvectors of its Gram matrix: by
    eigh where s_i <= HOSVD_EXACT_EIGH_MAX or 2 r_i >= s_i, else by
    :func:`_topk_subspace` (4 iterations) from an (s_i, 2 r_i) normal
    start basis, ``Q0s[i]`` when given (a parity test passes the JAX
    package's draw), else :func:`hosvd_draw`'s.

    ``layout``: V is this rank's block and s_i the padded global size
    (the JAX package's GSPMD run sees the padded V). An unsharded mode's
    Gram is summed over the sharded axes. A sharded mode's Gram needs
    rows of other ranks: on the subspace route it is applied matrix-free
    (:func:`_gram_apply`, one reduction of an (other modes, 2 r_i) matrix
    per product), on the exact route assembled block by block
    (:func:`_assembled_gram`); either way the whole factor is replicated,
    its signs fixed, and this rank keeps its row block."""
    ranks = tuple(int(r) for r in ranks)
    shape = contract.plan_shape(V, layout)
    # the Grams' dtype (mode_gram of bf16 V accumulates in float32)
    dtype = torch.float32 if V.dtype == torch.bfloat16 else V.dtype
    Ws = []
    for i in range(V.ndim):
        sharded = pmesh.is_sharded(layout, i)
        s_i = shape[i]
        q = min(2 * ranks[i], s_i)
        subspace = s_i > HOSVD_EXACT_EIGH_MAX and q < s_i
        if sharded and subspace:
            G = _gram_apply(V, i, layout)
        elif sharded:
            G = _assembled_gram(V, i, layout)
        else:
            G = pmesh.reduce_modes([contract.mode_gram(V, i)], layout,
                                   (i,))[0]
        if subspace:
            Q0 = Q0s[i] if Q0s is not None else hosvd_draw((s_i, q), dtype,
                                                           i)
            U, _ = _topk_subspace(G, ranks[i], Q0.to(V.device, dtype),
                                  iters=4)
            U = U[:, :ranks[i]]
        else:
            U, _ = solve.truncated_eigh(G, ranks[i])
        U = solve.fix_sign_columns(U)
        if sharded:
            lo, hi = layout.span(i)
            U = U[lo:hi].contiguous()
        Ws.append(U)
    return contract.ttmc(V, Ws, skip_mode=-1, layout=layout), Ws


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


def _diag_and_log(V_norm_sq, V, Ws, core_prev_norm, clock, plot, it, tol,
                  pp_flag, history, layout=None):
    """Exact diagnostics in an excluded window, one CSV row. Queued sweep
    work is synced before the window opens, so it counts toward dtime;
    under ``layout`` the time limit reads rank 0's clock."""
    cpm._sync()
    with clock.exclude():
        core, cn, diffnorm, diffV = tracing.timed(
            "tucker.diagnostics", tucker_diagnostics,
            V_norm_sq, V, Ws, core_prev_norm, layout)
        cn, diffnorm, diffV = float(cn), float(diffnorm), float(diffV)
    dtime = pmesh.agreed_dtime(clock, None if layout is None else layout.mesh,
                               V.device)
    if plot is not None:
        plot.row(V.shape[0] if layout is None else layout.orig_shape[0], it,
                 diffnorm, tol, pp_flag, diffV, dtime)
    history.append(dict(iter=it, diffnorm=diffnorm, diffV=diffV, dtime=dtime,
                        pp=pp_flag))
    return core, cn, diffnorm, diffV, dtime


def _logged(it: int, cfg: TuckerConfig) -> bool:
    """Whether iteration ``it`` logs a diagnostics row."""
    return (it % cfg.resprint == 0 and it != 0) or it == 1 \
        or it == cfg.maxiter


def _init(V, ranks, Ws, layout=None):
    """(core, factors): HOSVD (timed) when ``Ws`` is None, else the given
    factors (this rank's blocks under ``layout``) and their core."""
    if Ws is None:
        return tracing.timed("tucker.hosvd", hosvd, V, ranks, layout=layout)
    Ws = list(Ws)
    return contract.ttmc(V, Ws, skip_mode=-1, layout=layout), Ws


def als_tucker(V, ranks, cfg: TuckerConfig,
               plot: Optional[PlotFile] = None,
               Ws: Optional[List] = None, use_tree: bool = True,
               clock: Optional[SweepClock] = None) -> TuckerResult:
    """Tucker ALS from HOSVD (test_ALS.cxx:386-395): DT sweeps with
    ``use_tree`` (alsTucker_DT, als_Tucker.cxx:240-424), plain HOOI
    sweeps without (alsTucker, als_Tucker.cxx:120-176)."""
    ranks = tuple(int(r) for r in ranks)
    layout = cfg.mesh_layout
    V_norm_sq = contract.norm_sq(V, layout)
    core, Ws = _init(V, ranks, Ws, layout)
    clock = clock or SweepClock()
    with clock.exclude():
        if use_tree:
            cpm.warm_run(tucker_dt_sweep, V, Ws, Ws, ranks=ranks,
                         use_sign=False, subspace_iters=cfg.subspace_iters,
                         layout=layout)
        else:
            cpm.warm_run(tucker_hooi_sweep, V, Ws, ranks=ranks,
                         layout=layout)
    history: list = []
    core_prev_norm = torch.linalg.vector_norm(core)
    diffnorm, diffV = float("inf"), float("inf")
    it = 0
    converged = False
    while it <= cfg.maxiter:
        if _logged(it, cfg):
            core, core_prev_norm, diffnorm, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, core_prev_norm, clock, plot, it, cfg.tol, 0,
                history, layout)
            if diffnorm < cfg.tol:
                converged = True
                break
            if dtime > cfg.timelimit:
                break
        if use_tree:
            Ws, core = tracing.timed(
                "tucker.dt_sweep", tucker_dt_sweep, V, Ws, Ws, ranks=ranks,
                use_sign=False, subspace_iters=cfg.subspace_iters,
                layout=layout)
        else:
            Ws, core = tracing.timed("tucker.hooi_sweep", tucker_hooi_sweep,
                                     V, Ws, ranks=ranks, layout=layout)
        it += 1
    return TuckerResult(Ws, core, diffnorm, diffV, it, converged, history)


def _tucker_dt_sub(V, Ws, dWs, ranks, cfg, plot, clock, state, V_norm_sq):
    """alsTucker_DT_sub (als_Tucker.cxx:476-669). The phase starts from a
    zero W_prev, which is both the first sweep's sign reference (a zero
    reference negates every column, solve.sign_match) and its warm basis
    (under AUTO, a side of 256 or more starts from qr(G @ 0)), as in the
    JAX package (tucker.py:479, 497-498). The first DT phase of a solve
    runs one warm sweep and its ratio pull in excluded time (JAX
    tucker.py:480-482)."""
    order = V.ndim
    layout = cfg.mesh_layout
    W_prev = [torch.zeros_like(W) for W in Ws]
    if not state.get("dt_warmed"):
        with clock.exclude():
            cpm.warm_run(_warm_dt, V, Ws, ranks, cfg, layout)
        state["dt_warmed"] = True
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        if _logged(it, cfg):
            core, cn, diffnorm, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, state["core_prev_norm"], clock, plot, it,
                cfg.tol, 0, state["history"], layout)
            state.update(core=core, core_prev_norm=cn, diffnorm=diffnorm,
                         diffV=diffV)
            if diffnorm < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
        Ws_new, core = tracing.timed(
            "tucker.dt_sweep", tucker_dt_sweep, V, Ws, W_prev, ranks=ranks,
            use_sign=True, subspace_iters=cfg.subspace_iters, layout=layout)
        state["core"] = core
        dWs = [W - Wp for W, Wp in zip(Ws_new, W_prev)]
        W_prev = list(Ws_new)
        Ws = Ws_new
        ratios = cpm.factor_norm_ratios(Ws, dWs, layout).cpu().numpy()
        state["iter"] = it + 1
        if int(np.sum(np.abs(ratios) < state["tol_init"])) == order:
            return Ws, dWs, "quiet"
    return Ws, dWs, "maxiter"


def _warm_dt(V, Ws, ranks, cfg, layout):
    """A DT sweep of the host engine from a zero W_prev and the pull of
    its restart ratios, as the loop runs them; the results are
    discarded."""
    zeros = [torch.zeros_like(W) for W in Ws]
    Ws2, _ = tucker_dt_sweep(V, Ws, zeros, ranks=ranks, use_sign=True,
                             subspace_iters=cfg.subspace_iters, layout=layout)
    cpm.factor_norm_ratios(Ws2, Ws2, layout).cpu()


def _tucker_pp_sub(V, Ws, dWs, ranks, cfg, plot, clock, state, V_norm_sq):
    """alsTucker_PP_sub (als_Tucker.cxx:679-896): a cache build at the
    phase's first sweep, PP sweeps until a factor drifts past tol_init
    (restart), the quiet-skip stationarity exit, convergence or the
    limits. Once a solve, in excluded time: a warm cache build, used as
    the phase's first build, and a warm PP sweep on it (JAX
    tucker.py:520-532, :546-548)."""
    layout = cfg.mesh_layout
    init_iter = state["iter"]
    W_init = single = pair = None
    build_it = init_iter
    if not state.get("pp_warmed"):
        with clock.exclude():
            warm = cpm.warm_run(tucker_build_caches, V, Ws, layout)
            if warm is not None:
                cpm.warm_run(tucker_pp_sweep, *warm, Ws, Ws,
                             [torch.zeros_like(W) for W in Ws], ranks=ranks,
                             subspace_iters=cfg.subspace_iters,
                             layout=layout)
        state["warm_caches"] = warm
        state["pp_warmed"] = True
    while state["iter"] <= cfg.maxiter:
        it = state["iter"]
        ratios = cpm.factor_norm_ratios(Ws, dWs, layout).cpu().numpy()
        num_dw_break = int(np.sum(np.abs(ratios) > state["tol_init"]))
        if it == init_iter or num_dw_break > 0:
            if num_dw_break > 0:
                return Ws, dWs, "restart"
            W_init = list(Ws)
            dWs = [torch.zeros_like(W) for W in Ws]
            build_it = it
            warm = state.pop("warm_caches", None)
            if warm is not None:
                single, pair = warm     # built from these very factors
            else:
                single, pair = tracing.timed("tucker.pp_cache_build",
                                             tucker_build_caches, V, Ws,
                                             layout)
        if _logged(it, cfg) or it == init_iter:
            core, cn, diffnorm, diffV, dtime = _diag_and_log(
                V_norm_sq, V, Ws, state["core_prev_norm"], clock, plot, it,
                cfg.tol, 1, state["history"], layout)
            state.update(core=core, core_prev_norm=cn, diffnorm=diffnorm,
                         diffV=diffV)
            if diffnorm < cfg.tol:
                return Ws, dWs, "converged"
            if dtime > cfg.timelimit:
                return Ws, dWs, "timelimit"
            if it == cfg.maxiter:
                return Ws, dWs, "maxiter"
        Ws, dWs, core, stationary = tracing.timed(
            "tucker.pp_sweep", tucker_pp_sweep, single, pair, Ws, W_init,
            dWs, cfg.pp_quiet_frac * state["tol_init"], it - build_it,
            ranks=ranks, subspace_iters=cfg.subspace_iters, layout=layout)
        state["core"] = core
        state["iter"] = it + 1
        if cfg.pp_quiet_frac and stationary:
            # every mode skipped: this cache's PP fixed point is reached
            return Ws, dWs, "restart"
    return Ws, dWs, "maxiter"


def als_tucker_pp(V, ranks, cfg: TuckerConfig,
                  plot: Optional[PlotFile] = None,
                  Ws: Optional[List] = None,
                  clock: Optional[SweepClock] = None) -> TuckerResult:
    """The outer Tucker DT <-> PP loop with the tol_init decay (x0.9 while
    above the 5e-3 floor) after each PP phase (alsTucker_PP,
    als_Tucker.cxx:906-962)."""
    ranks = tuple(int(r) for r in ranks)
    V_norm_sq = contract.norm_sq(V, cfg.mesh_layout)
    core, Ws = _init(V, ranks, Ws, cfg.mesh_layout)
    clock = clock or SweepClock()
    state = dict(iter=0, core=core,
                 core_prev_norm=torch.linalg.vector_norm(core),
                 diffnorm=float("inf"), diffV=float("inf"),
                 tol_init=cfg.pp_res_tol, history=[])
    dWs = [torch.zeros_like(W) for W in Ws]
    reason = None
    while state["diffnorm"] > cfg.tol and state["iter"] <= cfg.maxiter:
        Ws, dWs, reason = _tucker_dt_sub(V, Ws, dWs, ranks, cfg, plot,
                                         clock, state, V_norm_sq)
        if reason in ("converged", "timelimit", "maxiter"):
            break
        Ws, dWs, reason = _tucker_pp_sub(V, Ws, dWs, ranks, cfg, plot, clock,
                                         state, V_norm_sq)
        if reason in ("converged", "timelimit", "maxiter"):
            break
        if state["tol_init"] > TOL_INIT_FLOOR:
            state["tol_init"] *= TOL_INIT_DECAY
    return TuckerResult(Ws, state["core"], state["diffnorm"], state["diffV"],
                        state["iter"], reason == "converged",
                        state["history"])


# ---------------------------------------------------------------------------
# Device-resident phase loops (JAX tucker.py:627-849; -device_loop 1)
# ---------------------------------------------------------------------------
#
# As models/cp.py's (cp.dt_phase_device, cp.pp_phase_device): a phase's
# loop state stays on the device, the host issues sweeps in chunks of
# cp.DEVICE_LOOP_CHUNK through cp._issue_chunks, each sweep evaluates the
# JAX while-loop's condition on the device and commits through
# torch.where, and one pull a chunk reads the flag.


def _core_stats(V_norm_sq, core, cn_prev):
    """(||core||, |that - cn_prev|, diffV) of a sweep's core."""
    cn = torch.linalg.vector_norm(core)
    return cn, torch.abs(cn - cn_prev), torch.sqrt(
        torch.clamp(V_norm_sq - cn * cn, min=0.0))


def tucker_dt_phase_device(V, Ws, tol_init, diff_tol, it_budget: int, *,
                           ranks: Tuple[int, ...], max_sweeps: int = 256,
                           subspace_iters: int = 0, layout=None,
                           V_norm_sq=None):
    """DT Tucker sweeps (sign-matched to the previous sweep's factors, the
    first to zeros) with their loop on the device until every mode is
    quiet (||dW||/||W|| < tol_init), the core-norm change falls below
    ``diff_tol``, or ``it_budget`` sweeps ran (JAX tucker.py:633-671).
    Returns (n_sweeps, Ws, dWs, core, diffnorm, quiet, hist[max_sweeps,
    2]), hist rows [diffnorm, diffV] (exact: a DT sweep's core is).
    ``layout`` (-mesh): V and Ws are this rank's blocks, the cores are
    summed over the ranks and the ratios all-reduced, so the flag is the
    same on every rank. ``V_norm_sq``: ||V||^2 if known."""
    if V_norm_sq is None:
        V_norm_sq = contract.norm_sq(V, layout)
    core0 = contract.ttmc(V, list(Ws), skip_mode=-1, layout=layout)
    st, _, _ = cpm._loop_state(
        Ws, max_sweeps, 0, W_prev=[torch.zeros_like(W) for W in Ws],
        cn=torch.linalg.vector_norm(core0), core=core0,
        quiet=torch.zeros((), dtype=torch.bool, device=V.device))
    st["dn"] = st["gn"]

    def sweep(j):
        on = st["on"]
        Ws2, core2 = tucker_dt_sweep(V, st["Ws"], st["W_prev"], ranks=ranks,
                                     use_sign=True,
                                     subspace_iters=subspace_iters,
                                     layout=layout)
        dWs2 = [a - b for a, b in zip(Ws2, st["W_prev"])]
        quiet2 = torch.all(torch.abs(cpm.factor_norm_ratios(Ws2, dWs2,
                                                            layout))
                           < tol_init)
        cn, dn2, diffV = _core_stats(V_norm_sq, core2, st["cn"])
        cpm._record(st, j, on, torch.stack([dn2, diffV]).to(st["dn"].dtype),
                    Ws2, 0, 0, -1, 0, None, None)
        cpm._commit(st, on, Ws=Ws2, W_prev=Ws2, dWs=dWs2, cn=cn, dn=dn2,
                    quiet=quiet2, core=core2)
        st["on"] = on & ~quiet2 & (dn2 >= diff_tol)

    n = cpm._issue_chunks(sweep, st, it_budget, "dt")
    return n, st["Ws"], st["dWs"], st["core"], st["dn"], st["quiet"], \
        st["hist"]


def tucker_pp_phase_device(V, Ws, tol_init, diff_tol, it_budget: int,
                           it0: int = 0, quiet_tol: float = 0.0, *,
                           ranks: Tuple[int, ...], max_sweeps: int = 64,
                           subspace_iters: int = 0, resprint: int = 0,
                           n_slots: int = 0, layout=None, V_norm_sq=None):
    """Build the Tucker PP caches, then PP sweeps with their loop on the
    device until a factor drifts past tol_init, the sweep is stationary
    (every mode quiet-skipped: :func:`tucker_pp_sweep`'s host bool, ORed
    into the flag), the core-norm change falls below ``diff_tol``, or
    ``it_budget`` sweeps ran (JAX tucker.py:674-731). The quiet skip's age
    is the sweep's issue index. A sweep's core is the PP-corrected one;
    sweep k snapshots the factors into the ring where (it0 + k) %
    resprint == 0 (no maxiter mark, unlike CP's). ``layout`` and
    ``V_norm_sq`` as in :func:`tucker_dt_phase_device` (the build is the
    constrained one, the stationary bool read from all-reduced drifts).
    Returns (n_sweeps, Ws, dWs, core, diffnorm, hist, snaps, labels,
    count)."""
    if V_norm_sq is None:
        V_norm_sq = contract.norm_sq(V, layout)
    single, pair = tracing.timed("tucker.pp_cache_build",
                                 tucker_build_caches, V, list(Ws), layout)
    W_init = list(Ws)
    core0 = contract.ttmc(V, list(Ws), skip_mode=-1, layout=layout)
    st, snaps, labels = cpm._loop_state(
        Ws, max_sweeps, n_slots, cn=torch.linalg.vector_norm(core0),
        core=core0)
    st["dn"] = st["gn"]

    def sweep(j):
        on = st["on"]
        Ws2, dWs2, core2, stationary = tucker_pp_sweep(
            single, pair, st["Ws"], W_init, st["dWs"], quiet_tol, j,
            ranks=ranks, subspace_iters=subspace_iters, layout=layout)
        broke2 = torch.any(torch.abs(cpm.factor_norm_ratios(Ws2, dWs2,
                                                            layout))
                           > tol_init) | stationary
        cn, dn2, diffV = _core_stats(V_norm_sq, core2, st["cn"])
        cpm._record(st, j, on, torch.stack([dn2, diffV]).to(st["dn"].dtype),
                    Ws2, it0, resprint, -1, n_slots, snaps, labels)
        cpm._commit(st, on, Ws=Ws2, dWs=dWs2, cn=cn, dn=dn2, core=core2)
        st["on"] = on & ~broke2 & (dn2 >= diff_tol)

    n = cpm._issue_chunks(sweep, st, it_budget, "pp")
    return (n, st["Ws"], st["dWs"], st["core"], st["dn"], st["hist"], snaps,
            labels, st["count"])


def _exact_core_norm(V, Ws, layout=None):
    """||TTMc(V, W)|| of a snapshot, as a host float (the core summed over
    the ranks under ``layout``)."""
    return float(torch.linalg.vector_norm(tracing.timed(
        "tucker.diagnostics", contract.ttmc, V, list(Ws), skip_mode=-1,
        layout=layout)))


def _warm_phases(V, V_norm_sq, Ws, ranks, subspace_iters, layout):
    """Each function the Tucker phase loops call, once, on the initial
    factors; the results are discarded."""
    zeros = [torch.zeros_like(W) for W in Ws]
    _, core = tucker_dt_sweep(V, Ws, zeros, ranks=ranks, use_sign=True,
                              subspace_iters=subspace_iters, layout=layout)
    cpm.factor_norm_ratios(Ws, Ws, layout)
    _core_stats(V_norm_sq, core, torch.linalg.vector_norm(core))
    single, pair = tucker_build_caches(V, Ws, layout)
    tucker_pp_sweep(single, pair, Ws, Ws, zeros, ranks=ranks,
                    subspace_iters=subspace_iters, layout=layout)
    _exact_core_norm(V, Ws, layout)


def als_tucker_pp_device(V, ranks, cfg: TuckerConfig,
                         plot: Optional[PlotFile] = None,
                         Ws: Optional[List] = None,
                         clock: Optional[SweepClock] = None) -> TuckerResult:
    """Device-resident Tucker DT <-> PP machine (``test_als -model Tucker
    -pp 1 -device_loop 1``; JAX tucker.py:734-849): the phase machine of
    :func:`als_tucker_pp`, one :func:`tucker_dt_phase_device` or
    :func:`tucker_pp_phase_device` call a phase, tol_init decayed by
    TOL_INIT_DECAY (to TOL_INIT_FLOOR) after each PP phase.

    Rows come from the phases' history buffers, ``dtime`` interpolated
    within each phase. A DT row carries its exact core norm; a logged PP
    row's core norm is recomputed EXACTLY from the ring's snapshot inside
    the clock's excluded window, its diffV from it, and its diffnorm
    against the latest exact norm of an earlier logged row. A PP phase's
    maxiter row, which the ring does not snapshot, keeps the estimates
    (as in JAX). tol_init and the tolerances are rounded to V's dtype, as
    the JAX engine's scalars are. After HOSVD the engine runs each
    function the phases call once (cp.warm_run) and restarts the clock,
    as the JAX engine does after its zero-budget phases (tucker.py:757-
    771). Under ``cfg.mesh_layout`` V is this rank's block (HOSVD the
    sharded one), every flag the host reads comes from all-reduced
    values, the time limit reads rank 0's clock, and the CSV's dimension
    column is the unsharded tensor's."""
    ranks = tuple(int(r) for r in ranks)
    layout = cfg.mesh_layout
    mesh = None if layout is None else layout.mesh
    dim = V.shape[0] if layout is None else layout.orig_shape[0]
    core, Ws = _init(V, ranks, Ws, layout)
    clock = clock or SweepClock()
    V_norm_sq = contract.norm_sq(V, layout)
    vn2 = float(V_norm_sq)
    cpm.warm_run(_warm_phases, V, V_norm_sq, Ws, ranks, cfg.subspace_iters,
                 layout)
    clock.reset()
    tol_init = cfg.pp_res_tol
    diff_tol = cpm._in_dtype(cfg.tol, V.dtype)
    history: list = []
    it = 0
    dn = diffV = float("inf")
    # snapshot ring slots: enough for every logged row of one PP phase
    n_slots = cfg.maxiter // max(cfg.resprint, 1) + 3
    cn_by_it: dict = {}     # exact core norms of logged rows
    common = dict(ranks=ranks, max_sweeps=cfg.maxiter + 1,
                  subspace_iters=cfg.subspace_iters, layout=layout,
                  V_norm_sq=V_norm_sq)

    def now():
        return pmesh.agreed_dtime(clock, mesh, V.device)

    def log(hist, n, pp_flag, t0, t1, ring=None):
        nonlocal it, dn, diffV
        h = cpm._pull(hist)[:n].tolist()
        exact = {}
        if ring is not None:
            snaps, labels, count = ring
            with clock.exclude():
                sn = int(cpm._pull(count))
                cpm._ring_overflow(sn, n_slots, "phase")
                if sn > 0:
                    labels_h = cpm._pull(labels).tolist()
                    for slot in range(min(sn, n_slots)):
                        exact[labels_h[slot]] = _exact_core_norm(
                            V, [s[slot] for s in snaps], layout)
        for i in range(n):
            dn, diffV = h[i]
            dt_row = t0 + (t1 - t0) * (i + 1) / max(n, 1)
            if it % cfg.resprint == 0 or it == cfg.maxiter:
                if it in exact:
                    cn_s = cn_by_it[it] = exact[it]
                    diffV = float(np.sqrt(max(vn2 - cn_s * cn_s, 0.0)))
                    prev = [v for k, v in cn_by_it.items() if k < it]
                    if prev:
                        dn = abs(cn_s - prev[-1])
                elif pp_flag == 0:
                    cn_by_it[it] = float(np.sqrt(max(vn2 - diffV * diffV,
                                                     0.0)))
                if plot is not None:
                    plot.row(dim, it, dn, cfg.tol, pp_flag, diffV, dt_row)
                history.append(dict(iter=it, diffnorm=dn, diffV=diffV,
                                    dtime=dt_row, pp=pp_flag))
            it += 1

    while it <= cfg.maxiter:
        t0 = now()
        n, Ws, dWs, core, dn_d, _, hist = tracing.timed(
            "tucker.dt_phase_device", tucker_dt_phase_device, V, Ws,
            cpm._in_dtype(tol_init, V.dtype), diff_tol, cfg.maxiter + 1 - it,
            **common)
        t1 = now()
        log(hist, n, 0, t0, t1)
        dn_dt = float(cpm._pull(dn_d))
        if dn_dt < cfg.tol or it > cfg.maxiter or t1 > cfg.timelimit:
            dn = dn_dt
            break
        t0 = now()
        n, Ws, dWs, core, dn_d, hist, *ring = tracing.timed(
            "tucker.pp_phase_device", tucker_pp_phase_device, V, Ws,
            cpm._in_dtype(tol_init, V.dtype), diff_tol, cfg.maxiter + 1 - it,
            it, cpm._in_dtype(cfg.pp_quiet_frac * tol_init, V.dtype),
            resprint=cfg.resprint, n_slots=n_slots, **common)
        t1 = now()
        log(hist, n, 1, t0, t1, ring)
        dn = float(cpm._pull(dn_d))
        if dn < cfg.tol or t1 > cfg.timelimit:
            break
        if tol_init > TOL_INIT_FLOOR:
            tol_init *= TOL_INIT_DECAY
    return TuckerResult(Ws, core, dn, diffV, it, dn < cfg.tol, history)


# ---------------------------------------------------------------------------
# The fused Tucker machine (JAX tucker.py:852-1184; -device_loop 2)
# ---------------------------------------------------------------------------
#
# cp.pp_fused_chunk's design for alsTucker_PP (als_Tucker.cxx:906-962):
# phase 0 a DT sweep, 1 a TTMc cache build, 2 a PP sweep; the device
# writes the next phase and the stop flag, the host reads them in one
# pull a DT or PP step and issues the next step. tol_init rides in the
# carry and decays on each PP -> DT transition; the PP cache cap is 15.

#: The fused Tucker machine's PP sweeps per cache build (JAX
#: tucker.py:1081 hard-codes it).
TUCKER_PP_CAP = 15


def _tucker_pair_keys(order: int):
    return [(i, j) for i in range(order) for j in range(i + 1, order)]


def tucker_fused_init(V, Ws, ranks, max_hist: int, n_slots: int = 0,
                      tol_init: float = 1e-2, layout=None):
    """The initial carry of :func:`tucker_fused_chunk` (JAX
    tucker.py:865-895, with tol_init, which the JAX solver appends): the
    host ints of cp.pp_fused_init and ``tol_init``, and device tensors:
    the factors, W_prev, dWs, W_init, the caches (made at the first
    build), the core and its norm ``cn``, the core-norm change ``dn``,
    the history ``hist[it] = [dn, diffV, pp_flag]`` and the ring; the core
    summed over the ranks under ``layout``."""
    c = cpm.pp_fused_init(V, Ws, max_hist, n_slots)
    c["core"] = contract.ttmc(V, list(Ws), skip_mode=-1, layout=layout)
    c["cn"] = torch.linalg.vector_norm(c["core"])
    c["dn"] = c.pop("gn")
    del c["gn_floor"]
    c["tol_init"] = tol_init
    return c


def tucker_fused_chunk(V, carry, diff_tol, maxiter: int, decay, floor,
                       quiet_frac: float = 0.0, *, ranks: Tuple[int, ...],
                       subspace_iters: int = 0, chunk: int = cpm.FUSED_CHUNK,
                       resprint: int = 1, pp_cap: int = TUCKER_PP_CAP,
                       n_slots: int = 0, V_norm_sq=None, layout=None):
    """Advance the fused Tucker machine by up to ``chunk`` body steps, or
    to the stop (JAX tucker.py:898-1030); returns the carry, updated in
    place. Rows hold the sweep's own core-norm statistics (exact after a
    DT sweep, PP-corrected after a PP sweep); rows the host will log
    (label % resprint == 0, or label >= maxiter) snapshot the factors. A
    PP sweep returns to DT when a factor drifts past tol_init, the sweep
    is stationary, or it is the pp_cap-th since the build; then W_prev is
    zeroed and tol_init decays by ``decay`` while above ``floor``. The
    run stops at a core-norm change below ``diff_tol`` or it > maxiter.
    ``layout`` (-mesh): this rank's blocks, the register written from
    all-reduced values. Scopes ``tucker.fused_{dt,build,pp}_step``."""
    c = carry
    if V_norm_sq is None:
        V_norm_sq = contract.norm_sq(V, layout)
    dtype = c["dn"].dtype

    def stats(core2, it2, pp_flag, Ws2):
        cn, dn2, diffV = _core_stats(V_norm_sq, core2, c["cn"])
        dn2, diffV = dn2.to(dtype), diffV.to(dtype)
        cpm._fused_row(c, it2, dn2, diffV, pp_flag, Ws2, resprint, maxiter,
                       n_slots)
        c.update(it=it2, cn=cn, dn=dn2, core=core2)
        return (dn2 < diff_tol) | (it2 > maxiter)

    def dt_step():
        Ws2, core2 = tucker_dt_sweep(V, c["Ws"], c["W_prev"], ranks=ranks,
                                     use_sign=True,
                                     subspace_iters=subspace_iters,
                                     layout=layout)
        dWs2 = [a - b for a, b in zip(Ws2, c["W_prev"])]
        quiet = torch.all(torch.abs(cpm.factor_norm_ratios(Ws2, dWs2,
                                                           layout))
                          < c["tol_init"])
        stop2 = stats(core2, c["it"] + 1, 0.0, Ws2)
        c.update(Ws=Ws2, W_prev=Ws2, dWs=dWs2)
        cpm._fused_register(c, torch.where(quiet & ~stop2, 1, 0), stop2)

    def build_step():
        c["single"], c["pair"] = tucker_build_caches(V, c["Ws"], layout)
        c.update(phase=2, age=0, dWs=[torch.zeros_like(W) for W in c["Ws"]],
                 W_init=list(c["Ws"]))

    def pp_step():
        tol = c["tol_init"]
        Ws2, dWs2, core2, stationary = tucker_pp_sweep(
            c["single"], c["pair"], c["Ws"], c["W_init"], c["dWs"],
            cpm._in_dtype(quiet_frac * tol, dtype), c["age"], ranks=ranks,
            subspace_iters=subspace_iters, layout=layout)
        broke = torch.any(torch.abs(cpm.factor_norm_ratios(Ws2, dWs2,
                                                           layout))
                          > tol) | stationary
        c["age"] += 1
        stop2 = stats(core2, c["it"] + 1, 1.0, Ws2)
        c.update(Ws=Ws2, dWs=dWs2)
        cpm._fused_register(c, torch.where(broke | (c["age"] >= pp_cap), 0,
                                           2), stop2)
        if c["phase"] == 0:
            c["W_prev"] = [torch.zeros_like(W) for W in Ws2]
            if tol > floor:
                # the decay on PP -> DT (als_Tucker.cxx:947-948), in the
                # factors' dtype
                c["tol_init"] = cpm._in_dtype(tol * decay, dtype)

    steps = {0: ("dt", dt_step), 1: ("build", build_step), 2: ("pp", pp_step)}
    cpm.DEVICE_LOOP_COUNTS["fused_chunks"] += 1
    for _ in range(chunk):
        if c["stop"]:
            break
        kind, step = steps[c["phase"]]
        cpm.DEVICE_LOOP_COUNTS[f"fused_{kind}"] += 1
        tracing.timed(f"tucker.fused_{kind}_step", step)
    return c


def _warm_fused(V, Ws, ranks, tol_init, chunk_args, chunk_kw, layout):
    """One DT step, one cache build and one PP step of the fused Tucker
    machine on a carry of its own, thrown away after (JAX
    tucker.py:1086-1095 runs the chunk on a stopped carry)."""
    c = tucker_fused_init(V, Ws, ranks, 3, 1, tol_init, layout)
    tucker_fused_chunk(V, c, *chunk_args, **dict(chunk_kw, chunk=1, n_slots=1))
    c.update(phase=1, stop=False)
    tucker_fused_chunk(V, c, *chunk_args, **dict(chunk_kw, chunk=2, n_slots=1))


def als_tucker_pp_fused(V, ranks, cfg: TuckerConfig,
                        plot: Optional[PlotFile] = None,
                        Ws: Optional[List] = None,
                        clock: Optional[SweepClock] = None,
                        chunk: int = cpm.FUSED_CHUNK) -> TuckerResult:
    """The fused Tucker DT <-> PP solver (``test_als -model Tucker -pp 1
    -device_loop 2``; JAX tucker.py:1033-1184): :func:`tucker_fused_chunk`
    until the stop, the time limit, iteration maxiter + 1 or a chunk that
    made no progress.

    After each chunk the host pulls the history and the ring, computes
    each snapshot's EXACT core norm inside the clock's excluded window,
    and resets the ring. A logged row takes its exact diffV, and its
    exact diffnorm where the row before it has an exact norm too
    (resprint 1); the iteration-0 row (diffnorm inf) and the final diffV
    are exact. The tolerances are rounded to the factors' dtype, as the
    JAX engine's scalars are. The clock starts as :func:`als_tucker_pp`'s
    does, after HOSVD; the carry, a warm DT step, cache build and PP step
    on a carry thrown away, and a warm exact core norm (cp.warm_run) run
    in excluded time (JAX tucker.py:1086-1095). ``cfg.mesh_layout`` as in
    :func:`als_tucker_pp_device`."""
    ranks = tuple(int(r) for r in ranks)
    layout = cfg.mesh_layout
    mesh = None if layout is None else layout.mesh
    dim = V.shape[0] if layout is None else layout.orig_shape[0]
    core, Ws = _init(V, ranks, Ws, layout)
    clock = clock or SweepClock()
    dtype = Ws[0].dtype
    V_norm_sq = contract.norm_sq(V, layout)
    vn2 = float(V_norm_sq)
    max_hist = cfg.maxiter + 2
    # the ring covers one chunk's logged rows: drained after every chunk
    n_slots = min(cfg.maxiter // max(cfg.resprint, 1) + 4,
                  chunk // max(cfg.resprint, 1) + 4)
    history: list = []

    def diff_v(cn):
        return float(np.sqrt(max(vn2 - cn * cn, 0.0)))

    def now():
        return pmesh.agreed_dtime(clock, mesh, V.device)

    with clock.exclude():
        tol_init = cpm._in_dtype(cfg.pp_res_tol, dtype)
        chunk_args = (cpm._in_dtype(cfg.tol, dtype), cfg.maxiter,
                      cpm._in_dtype(TOL_INIT_DECAY, dtype),
                      cpm._in_dtype(TOL_INIT_FLOOR, dtype),
                      cpm._in_dtype(cfg.pp_quiet_frac, dtype))
        chunk_kw = dict(ranks=ranks, subspace_iters=cfg.subspace_iters,
                        chunk=chunk, resprint=cfg.resprint, n_slots=n_slots,
                        V_norm_sq=V_norm_sq, layout=layout)
        carry = tucker_fused_init(V, Ws, ranks, max_hist, n_slots, tol_init,
                                  layout)
        cpm.warm_run(_warm_fused, V, Ws, ranks, tol_init, chunk_args,
                     chunk_kw, layout)
        cpm.warm_run(_exact_core_norm, V, Ws, layout)
        cn0 = float(torch.linalg.vector_norm(core))
        diffV = diff_v(cn0)
    dn = float("inf")
    t_prev = now()
    if plot is not None:
        plot.row(dim, 0, dn, cfg.tol, 0, diffV, t_prev)
    history.append(dict(iter=0, diffnorm=dn, diffV=diffV, dtime=t_prev,
                        pp=0))

    prev_it = 0
    cn_by_label = {0: cn0}  # exact core norms, for exact diffnorm rows
    while True:
        tucker_fused_chunk(V, carry, *chunk_args, **chunk_kw)
        it_now, stop = carry["it"], carry["stop"]
        cpm._sync()
        t_now = now()
        if it_now > prev_it:
            rows_all, exact = cpm._drain_ring(
                carry, clock, n_slots,
                lambda Ws_: _exact_core_norm(V, Ws_, layout))
            cn_by_label.update(exact)
            for off, label in enumerate(range(prev_it + 1, it_now + 1)):
                dt_row = t_prev + (t_now - t_prev) * (off + 1) / (
                    it_now - prev_it)
                dn, diffV, ppf = rows_all[label]
                ppf = int(ppf > 0.5)
                if label in exact:
                    diffV = diff_v(exact[label])
                    if label - 1 in cn_by_label:
                        dn = abs(cn_by_label[label] - cn_by_label[label - 1])
                if label % cfg.resprint == 0 or label == cfg.maxiter:
                    if plot is not None:
                        plot.row(dim, label, dn, cfg.tol, ppf, diffV, dt_row)
                    history.append(dict(iter=label, diffnorm=dn,
                                        diffV=diffV, dtime=dt_row, pp=ppf))
        done = stop or it_now > cfg.maxiter or t_now > cfg.timelimit \
            or it_now == prev_it
        prev_it, t_prev = it_now, t_now
        if done:
            break
    Ws_f = carry["Ws"]
    with clock.exclude():
        diffV = diff_v(_exact_core_norm(V, Ws_f, layout))
    return TuckerResult(Ws_f, carry["core"], dn, diffV, prev_it,
                        dn < cfg.tol, history)

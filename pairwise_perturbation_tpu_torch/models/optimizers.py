"""Second-generation optimizer framework: CPD and its optimizer policies —
port of ``pairwise_perturbation_tpu/models/optimizers.py``.

- :class:`Decomposition`      <-> src/decomposition.h:8-36
- :class:`CPD`                <-> src/CP.h / src/CP.cxx (the ``als`` loop)
- :class:`CPSimpleOptimizer`  <-> src/optimizer/cp_simple_optimizer.{h,cxx}
- :class:`CPDTOptimizer`      <-> src/optimizer/cp_dt_optimizer.{h,cxx}
                                  (two-subtree dimension tree, 0.5 sweeps
                                  a step)
- :class:`CPMSDTOptimizer`    <-> src/optimizer/cp_msdt_optimizer.{h,cxx}
                                  (multi-sweep DT, (N-1)/N sweeps a step,
                                  arXiv:2010.12056)
- :class:`CPDTLROptimizer`    <-> src/optimizer/cp_dt_lr_optimizer.{h,cxx}
- :class:`CPMSDTLROptimizer`  <-> src/optimizer/cp_msdt_lr_optimizer.{h,cxx}

Each step is eager PyTorch on V's device; the factor and state rotation
stays on the host. The JAX package compiles one computation per
(left_index, positions) signature; the port compiles nothing. V may be a
COO :class:`~pairwise_perturbation_tpu_torch.ops.sparse.SparseTensor`
(``run -issparse 1``, run.cxx:137-140): its chain tops are one
fused-index ``index_add_`` (``sparse.ttm_dense``), the rest of each chain
is dense, and Simple's sweep and the diagnostics are the sparse engine's
(models/sparse_cp.py).

``run -mesh`` (``CPD.init(..., layout=)``) runs every optimizer on a
block-sharded dense V, one process per mesh device (parallel/mesh.py):
V and the factors are this rank's blocks, the chain tops stay partial
sums over a sharded hold-out, each leaf MTTKRP is summed over the other
sharded modes and each Gram over its rows (the hooks of
parallel/collectives.py), and the low-rank kit sums its small Grams over
the rows of the mode it factors (ops/solve.py). Every decision reads
values that are bitwise equal on every rank.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.models import cp, sparse_cp
from pairwise_perturbation_tpu_torch.ops import contract, dimtree, solve
from pairwise_perturbation_tpu_torch.ops import sparse
from pairwise_perturbation_tpu_torch.parallel import collectives
from pairwise_perturbation_tpu_torch.utils import tracing
from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile, SweepClock


def rotation_indexes(left_index: int, order: int) -> Tuple[int, ...]:
    """indexes = [left+1 .. order-1, 0 .. left-1]
    (cp_msdt_optimizer.cxx:update_indexes)."""
    return tuple(list(range(left_index + 1, order)) + list(range(left_index)))


def _sparse_top(st, W, left_index: int):
    """V x_left W for a COO V: ``sparse.ttm_dense`` (remaining modes
    ascending, then rank) permuted to indexes order + rank, as a view."""
    order = st.ndim
    T = sparse.ttm_dense(st, W, left_index, rank_last=True)
    ascending = [m for m in range(order) if m != left_index]
    perm = [ascending.index(m) for m in rotation_indexes(left_index, order)]
    return T.permute(perm + [len(ascending)])


def chain_top(V, W_left, *, left_index: int, layout=None):
    """First-level contraction V x W[left_index], axes in indexes order +
    rank (mttkrp_map_init, cp_msdt_optimizer.cxx:111-144), through
    :meth:`dimtree.ChainTreeSweep.top` (the mid_contract kernel for an
    eligible hold-out under ``config.use_kernels_first``); for a COO V,
    one fused-index ``index_add_`` over the nonzeros. ``layout``: of this
    rank's block, a partial sum where the hold-out's mode is sharded."""
    order = V.ndim
    if isinstance(V, sparse.SparseTensor):
        return _sparse_top(V, W_left, left_index)
    sweep = dimtree.ChainTreeSweep(
        V, [W_left if i == left_index else None for i in range(order)],
        rotation_indexes(left_index, order), left_index, layout=layout)
    return sweep.top()


def chain_step(V, top, Ws, lam, *, left_index: int,
               positions: Tuple[int, ...], solver: str = "chol",
               layout=None):
    """Process tree positions in order: per-position MTTKRP from the chain
    tree, S assembly, gradient, solve (CPDTOptimizer::step /
    CPMSDTOptimizer::step). Returns (Ws_new, grads_by_position).
    ``layout``: V, ``top`` and Ws are this rank's blocks; each leaf M is
    summed over the other sharded modes and each Gram over its rows, so
    the solves are row-wise on this rank's rows."""
    indexes = rotation_indexes(left_index, V.ndim)
    sweep = dimtree.ChainTreeSweep(V, Ws, indexes, left_index, top=top,
                                   layout=layout)
    grads = []
    for pos in positions:
        M = sweep.mttkrp(pos)
        i = indexes[pos]
        S = contract.hadamard_gram(sweep.factors, skip_mode=i, regul=lam,
                                   layout=layout)
        grads.append(contract.gradsubprob(M, S, sweep.factors[i]))
        sweep.factors[i] = solve.solve(M, S, method=solver)
    return sweep.factors, grads


def chain_step_lr(V, top, Ws, lam, old_W_lr, X=None, *, left_index: int,
                  positions: Tuple[int, ...], solver: str, lr_pos: int,
                  update_rank: int, lr_from_old: bool, layout=None):
    """Like :func:`chain_step`, but position ``lr_pos`` is solved as a
    rank-``update_rank`` *update*: (U, s, VT) of dW = M pinv(S) - A with
    A = ``old_W_lr`` (MSDT-LR) or the current factor (DT-LR), and
    W <- A + U s VT (cp_dt_lr_optimizer.cxx:202-215,
    cp_msdt_lr_optimizer.cxx:246-256). ``X``: the randomized SVD's test
    matrix, None for the exact truncation. Returns (Ws_new, grads,
    (U, s, VT)). ``layout``: as :func:`chain_step`; U is this rank's rows
    of the low-rank mode (ops/solve.py's kit sums its Grams over them)."""
    indexes = rotation_indexes(left_index, V.ndim)
    sweep = dimtree.ChainTreeSweep(V, Ws, indexes, left_index, top=top,
                                   layout=layout)
    grads = []
    lr_usv = None
    for pos in positions:
        M = sweep.mttkrp(pos)
        i = indexes[pos]
        S = contract.hadamard_gram(sweep.factors, skip_mode=i, regul=lam,
                                   layout=layout)
        grads.append(contract.gradsubprob(M, S, sweep.factors[i]))
        if pos == lr_pos:
            A = old_W_lr if lr_from_old else sweep.factors[i]
            U, s, VT = solve.rankR_update_cholesky(M, A, S, update_rank, X,
                                                   layout, i)
            sweep.factors[i] = A + (U * s) @ VT
            lr_usv = (U, s, VT)
        else:
            sweep.factors[i] = solve.solve(M, S, method=solver)
    return sweep.factors, grads, lr_usv


def lr_update_cache(V, cache, U, s, VT, *, left_index: int, layout=None):
    """cache + (V x_left (U s)) x VT: the low-rank refresh of a cached
    first-level contraction (update_cached_tensor,
    cp_dt_lr_optimizer.cxx:128-158 / cp_msdt_lr_optimizer.cxx:112-157),
    O(s^N * update_rank) in place of O(s^N * R). For a COO V, the x_left
    contraction is one fused-index ``index_add_`` over the nonzeros.
    ``layout`` runs nothing: U holds this rank's rows of the hold-out's
    mode, so V x_left (U s) is a partial sum exactly where the cached top
    is one, and the refreshed top stays this rank's partial."""
    if isinstance(V, sparse.SparseTensor):
        T = _sparse_top(V, U * s, left_index)
    else:
        order = V.ndim
        T, rem = contract.contract_mode_kr(V, tuple(range(order)), False,
                                           U * s, left_index)
        perm = [rem.index(m) for m in rotation_indexes(left_index, order)]
        T = T.permute(perm + [len(rem)])
    return cache + torch.tensordot(T, VT, dims=([T.ndim - 1], [0]))


def chain_step_lr_fused(V, cache, U, s, VT, Ws, lam, old_W_lr, X=None, *,
                        left_index: int, positions: Tuple[int, ...],
                        solver: str, lr_pos: int, update_rank: int,
                        lr_from_old: bool, layout=None):
    """The low-rank cache refresh, then :func:`chain_step_lr` on it. The
    JAX package fuses the two into one computation so XLA can stream the
    refreshed top into the first MTTKRP; eager PyTorch has nothing to
    fuse, so this is plain composition. Returns (top, Ws_new, grads,
    usv)."""
    top = lr_update_cache(V, cache, U, s, VT, left_index=left_index,
                          layout=layout)
    Ws2, grads, usv = chain_step_lr(
        V, top, Ws, lam, old_W_lr, X, left_index=left_index,
        positions=positions, solver=solver, lr_pos=lr_pos,
        update_rank=update_rank, lr_from_old=lr_from_old, layout=layout)
    return top, Ws2, grads, usv


def msdt_cycle(V, Ws, lam, *, lefts: Tuple[int, ...], solver: str = "chol",
               layout=None):
    """One full MSDT rotation, the hold-outs ``lefts`` in turn (all
    ``order`` modes, or the restricted rotation of ``min_holdout_size``):
    the same as that many CPMSDTOptimizer.step() calls
    (cp_msdt_optimizer.cxx:173-208). The JAX package fuses the rotation
    into one device computation; here it is a host loop over the
    hold-outs. ``layout``: as :func:`chain_step`."""
    order = V.ndim
    grads = None
    for left in lefts:
        top = chain_top(V, Ws[left], left_index=left, layout=layout)
        Ws, grads = chain_step(V, top, Ws, lam, left_index=left,
                               positions=tuple(range(order - 1)),
                               solver=solver, layout=layout)
    return Ws, grads


# ---------------------------------------------------------------------------
# Decomposition / CPD
# ---------------------------------------------------------------------------


class Decomposition:
    """Base decomposition holding V, the factor list and sizes/ranks
    (src/decomposition.h:8-36)."""

    def __init__(self, order: int, sizes, ranks):
        self.order = order
        self.sizes = [sizes] * order if np.isscalar(sizes) else list(sizes)
        self.ranks = [ranks] * order if np.isscalar(ranks) else list(ranks)
        self.V = None
        self.W: Optional[List] = None

    def init(self, V, W: Sequence):
        assert V.ndim == self.order
        for i in range(self.order):
            assert V.shape[i] == self.sizes[i]
            assert tuple(W[i].shape) == (self.sizes[i], self.ranks[i])
        self.V = V
        self.W = list(W)


class CPOptimizer:
    """Base optimizer: holds V, W and lambda (cp_als_optimizer.{h,cxx}).
    ``layout`` (``run -mesh``, parallel/mesh.py): V and W are this rank's
    blocks, and every step passes the layout on to its chain functions."""

    def __init__(self, order: int, rank: int):
        self.order = order
        self.rank = rank
        self.V = None
        self.W: Optional[List] = None
        self.lam = 0.0
        self.grads = None
        self.layout = None

    def configure(self, V, W: List, lam: float = 0.0, layout=None):
        self.V = V
        self.W = W
        self.lam = lam
        self.grads = None
        self.layout = layout

    def _lam(self, dtype) -> float:
        """lambda rounded to ``dtype``, as the JAX package's steps take
        it (V's dtype: bf16-stored V rounds it to bf16)."""
        return cp._in_dtype(self.lam, dtype)

    def step(self) -> float:
        raise NotImplementedError


class CPSimpleOptimizer(CPOptimizer):
    """One sweep of exact per-mode MTTKRPs (cp_simple_optimizer.cxx:step):
    ``cp.simple_sweep``, whose MTTKRPs of an order-3 float32 V are the
    fused kernels (K1-K3) on the card; for a COO V
    ``sparse_cp.sparse_simple_sweep``, whose MTTKRPs of float32 values
    are the COO kernel (K7), and no gradients."""

    def step(self) -> float:
        if isinstance(self.V, sparse.SparseTensor):
            self.W = sparse_cp.sparse_simple_sweep(
                self.V, self.W, self._lam(self.W[0].dtype), solver="chol",
                normalize=False)
            self.grads = None
            return 1.0
        self.W, self.grads = cp.simple_sweep(
            self.V, self.W, self._lam(self.W[0].dtype), solver="chol",
            normalize=False, layout=self.layout)
        return 1.0


class CPMSDTOptimizer(CPOptimizer):
    """Multi-sweep dimension tree: rotate left_index by -1 each step and
    update the other N-1 modes (cp_msdt_optimizer.cxx).

    Opt-in (``min_holdout_size > 0``, the JAX package's extension): hold
    out only modes of size >= min_holdout_size. Holding out a tiny mode m
    pays a first-level intermediate of ~|V|*R/s_m elements; every step
    still updates order-1 modes, only the schedule changes, so this
    departs from cp_msdt_optimizer.cxx and is off by default.
    """

    def __init__(self, order: int, rank: int, min_holdout_size: int = 0):
        super().__init__(order, rank)
        self.left_index = order  # the first update_indexes gives order-1
        self.min_holdout_size = min_holdout_size
        self.holdouts: Optional[Tuple[int, ...]] = None

    def configure(self, V, W: List, lam: float = 0.0, layout=None):
        super().configure(V, W, lam, layout)
        # the padded global sizes under a layout, as the JAX package's
        # sharded V reports them (JAX optimizers.py:312)
        shape = V.shape if layout is None else layout.padded_shape
        eligible = tuple(m for m in range(self.order)
                         if shape[m] >= self.min_holdout_size)
        self.holdouts = eligible if eligible else tuple(range(self.order))

    def _next_left(self) -> int:
        self.left_index = self._peek_next_left()
        return self.left_index

    def _peek_next_left(self) -> int:
        """The next hold-out of the (possibly restricted) rotation, without
        committing it."""
        order = self.order
        if self.holdouts is None or len(self.holdouts) == order:
            return (self.left_index + order - 1) % order
        below = [m for m in self.holdouts if m < self.left_index]
        return max(below) if below else max(self.holdouts)

    def _cycle_lefts(self) -> Tuple[int, ...]:
        """The hold-outs of one full rotation from the current state
        (left_index is restored; :meth:`step_cycle` commits it)."""
        saved = self.left_index
        lefts = tuple(self._next_left()
                      for _ in range(len(self.holdouts or range(self.order))))
        self.left_index = saved
        return lefts

    def step(self) -> float:
        order = self.order
        left = self._next_left()
        top = chain_top(self.V, self.W[left], left_index=left,
                        layout=self.layout)
        self.W, self.grads = chain_step(
            self.V, top, self.W, self._lam(self.V.dtype), left_index=left,
            positions=tuple(range(order - 1)), solver="chol",
            layout=self.layout)
        return (order - 1) / order

    def step_cycle(self) -> float:
        """One full rotation per call (``run -device_loop 1``): the same
        steps as :meth:`step` repeated, left_index ending where the
        rotation's last step leaves it."""
        lefts = self._cycle_lefts()
        self.W, self.grads = msdt_cycle(self.V, self.W,
                                        self._lam(self.V.dtype), lefts=lefts,
                                        solver="chol", layout=self.layout)
        self.left_index = lefts[-1]
        return len(lefts) * (self.order - 1) / self.order


class CPDTOptimizer(CPOptimizer):
    """Two-subtree dimension tree: alternates a first subtree updating the
    modes at positions special_index..N-2 of indexes1 and a second subtree
    updating positions 0..special_index of indexes2; each step is 0.5
    sweeps (cp_dt_optimizer.cxx)."""

    def __init__(self, order: int, rank: int):
        super().__init__(order, rank)
        self.left_index1 = order - 1
        self.left_index2 = (self.left_index1 + order - 1) % order
        self.special_index = 0
        self.first_subtree = True

    def _positions(self) -> Tuple[int, ...]:
        n = self.order - 1
        if self.first_subtree:
            return tuple(range(self.special_index, n))
        return tuple(range(0, self.special_index + 1))

    def step(self) -> float:
        left = self.left_index1 if self.first_subtree else self.left_index2
        top = chain_top(self.V, self.W[left], left_index=left,
                        layout=self.layout)
        self.W, self.grads = chain_step(
            self.V, top, self.W, self._lam(self.V.dtype), left_index=left,
            positions=self._positions(), solver="chol", layout=self.layout)
        self.first_subtree = not self.first_subtree
        return 0.5


class _RandomSVD:
    """The randomized SVD's test matrices, drawn from a seeded CPU
    ``torch.Generator`` and moved to the factors' device (the JAX package
    splits a ``jax.random`` key per step; torch cannot reproduce those
    bits). Nothing is drawn for the exact truncation."""

    def __init__(self, randomsvd: bool, seed: int):
        self.randomsvd = randomsvd
        self.gen = torch.Generator().manual_seed(int(seed))

    def draw(self, rank: int, update_rank: int, like):
        if not self.randomsvd:
            return None
        return torch.rand((rank, update_rank), generator=self.gen,
                          dtype=like.dtype).to(like.device)


class CPDTLROptimizer(CPDTOptimizer):
    """DT with a low-rank update of the cached first-level contraction
    (cp_dt_lr_optimizer.cxx). After warm-up, the big V x W contraction is
    replaced by cache += V x_left (U s VT), with (U, s, VT) the rank-r
    factorization of the last factor update."""

    def __init__(self, order: int, rank: int, update_rank: int,
                 randomsvd: bool = False, num_subiteration: int = 5,
                 seed: int = 0):
        super().__init__(order, rank)
        self.update_rank = update_rank
        self.randomsvd = randomsvd
        self.num_subiteration = num_subiteration
        self.count_subiteration = 0
        self.low_rank_decomp = False
        self.cached = {True: None, False: None}   # per-subtree caches
        self.usv = None
        self._rsvd = _RandomSVD(randomsvd, seed)

    def _lr_kw(self, left, positions, lr_pos):
        return dict(left_index=left, positions=positions, solver="chol",
                    lr_pos=lr_pos, update_rank=self.update_rank,
                    layout=self.layout)

    def step(self) -> float:
        order = self.order
        left = self.left_index1 if self.first_subtree else self.left_index2
        lam = self._lam(self.V.dtype)
        positions = self._positions()
        do_lr = self.count_subiteration >= 1
        lr_pos = (positions[-1] if self.first_subtree else positions[0]) \
            if do_lr else -1
        refresh = self.low_rank_decomp and self.count_subiteration > 1
        indexes = rotation_indexes(left, order)
        if refresh:
            # a refresh step is always an LR step too (count > 1 implies
            # do_lr)
            U, s, VT = self.usv
            X = self._rsvd.draw(self.rank, self.update_rank, self.W[0])
            top, self.W, self.grads, self.usv = chain_step_lr_fused(
                self.V, self.cached[self.first_subtree], U, s, VT, self.W,
                lam, self.W[indexes[lr_pos]], X, lr_from_old=False,
                **self._lr_kw(left, positions, lr_pos))
            self.cached[self.first_subtree] = top
            self.low_rank_decomp = True
        elif do_lr:
            top = chain_top(self.V, self.W[left], left_index=left,
                            layout=self.layout)
            self.cached[self.first_subtree] = top
            X = self._rsvd.draw(self.rank, self.update_rank, self.W[0])
            self.W, self.grads, self.usv = chain_step_lr(
                self.V, top, self.W, lam, self.W[indexes[lr_pos]], X,
                lr_from_old=False, **self._lr_kw(left, positions, lr_pos))
            self.low_rank_decomp = True
        else:
            top = chain_top(self.V, self.W[left], left_index=left,
                            layout=self.layout)
            self.cached[self.first_subtree] = top
            self.W, self.grads = chain_step(
                self.V, top, self.W, lam, left_index=left,
                positions=positions, solver="chol", layout=self.layout)
        if not self.first_subtree:
            self.count_subiteration += 1
        if (self.count_subiteration == self.num_subiteration
                and not self.first_subtree):
            # rotate special_index and reset the LR state
            # (cp_dt_lr_optimizer.cxx:219-232)
            self.special_index = (self.special_index + 1) % (order - 1)
            self.count_subiteration = 0
            self.low_rank_decomp = False
            if self.special_index != 0:
                self.left_index1 = (self.left_index1 + order - 1) % order
                self.left_index2 = (self.left_index2 + order - 1) % order
            else:
                self.left_index1 = order - 1
                self.left_index2 = (self.left_index1 + order - 1) % order
        self.first_subtree = not self.first_subtree
        return 0.5


class CPMSDTLROptimizer(CPMSDTOptimizer):
    """MSDT with per-mode cached first contractions and their low-rank
    refresh (cp_msdt_lr_optimizer.cxx)."""

    def __init__(self, order: int, rank: int, update_rank: int,
                 randomsvd: bool = False, seed: int = 0,
                 min_holdout_size: int = 0):
        super().__init__(order, rank, min_holdout_size=min_holdout_size)
        self.update_rank = update_rank
        self.randomsvd = randomsvd
        self.low_rank_decomp = False
        self.is_cached = [False] * order
        self.cached_tensors: List = [None] * order
        self.old_W: List = [None] * order
        self.usv = None
        self._rsvd = _RandomSVD(randomsvd, seed)

    def step(self) -> float:
        order = self.order
        left = self._next_left()
        lam = self._lam(self.V.dtype)
        positions = tuple(range(order - 1))
        indexes = rotation_indexes(left, order)
        # The low-rank update targets the NEXT hold-out: the usv made here
        # refreshes that mode's cached chain top at the start of the next
        # step, so both must refer to the same mode. In the full rotation
        # that is indexes[positions[-1]] (cp_msdt_lr_optimizer.cxx:246-256);
        # under the restricted rotation (min_holdout_size) it can be any
        # position (JAX optimizers.py:500-512).
        lr_mode = self._peek_next_left()
        do_lr = lr_mode in indexes and self.is_cached[lr_mode]
        refresh = self.low_rank_decomp and self.is_cached[left]
        lr_kw = dict(left_index=left, positions=positions, solver="chol",
                     lr_pos=indexes.index(lr_mode) if do_lr else -1,
                     update_rank=self.update_rank, lr_from_old=True,
                     layout=self.layout)
        if refresh and do_lr:
            U, s, VT = self.usv
            X = self._rsvd.draw(self.rank, self.update_rank, self.W[0])
            top, self.W, self.grads, self.usv = chain_step_lr_fused(
                self.V, self.cached_tensors[left], U, s, VT, self.W, lam,
                self.old_W[lr_mode], X, **lr_kw)
            self.cached_tensors[left] = top
            self.old_W[left] = self.W[left]
            self.low_rank_decomp = True
            return (order - 1) / order
        if refresh:
            U, s, VT = self.usv
            top = lr_update_cache(self.V, self.cached_tensors[left], U, s,
                                  VT, left_index=left, layout=self.layout)
        else:
            top = chain_top(self.V, self.W[left], left_index=left,
                            layout=self.layout)
            self.is_cached[left] = True
        self.cached_tensors[left] = top
        self.old_W[left] = self.W[left]
        if do_lr:
            X = self._rsvd.draw(self.rank, self.update_rank, self.W[0])
            self.W, self.grads, self.usv = chain_step_lr(
                self.V, top, self.W, lam, self.old_W[lr_mode], X, **lr_kw)
            self.low_rank_decomp = True
        else:
            self.W, self.grads = chain_step(
                self.V, top, self.W, lam, left_index=left,
                positions=positions, solver="chol", layout=self.layout)
            self.usv = None
            self.low_rank_decomp = False
        return (order - 1) / order


def _warm_card(W: Sequence):
    """What the first step of a run pays once per process, on R x R and
    (n, R) operands in the factors' dtype and device: the eigh, Cholesky
    and SVD solvers (cuSOLVER's handle and workspace), a matmul (cuBLAS's),
    and the kernels' library when a ``use_kernels*`` flag can reach it on
    a card (ops/kernels/_build.load). Nothing is drawn at random, and
    nothing of the run's state changes."""
    R = W[0].shape[1]
    dtype = torch.float32 if W[0].dtype == torch.bfloat16 else W[0].dtype
    A = W[0].T @ W[0] + torch.eye(R, dtype=dtype, device=W[0].device)
    torch.linalg.eigh(A)
    torch.linalg.cholesky_ex(A)
    torch.linalg.svd(A)
    c = config.get()
    if W[0].device.type == "cuda" and (c.use_kernels or c.use_kernels_first
                                       or c.use_kernels_triple):
        from pairwise_perturbation_tpu_torch.ops.kernels import _build
        _build.load()


class CPD(Decomposition):
    """CP decomposition over an optimizer policy
    (src/CP.cxx:111-187)."""

    def __init__(self, order: int, sizes, rank, optimizer: CPOptimizer):
        super().__init__(order, sizes, rank)
        self.optimizer = optimizer
        self.gradnorm = float("inf")
        self.history: list = []
        self.layout = None

    def init(self, V, W: Sequence, lam: float = 0.0, layout=None):
        """``layout`` (``run -mesh``): V and W are this rank's blocks, and
        ``sizes`` their block sizes."""
        super().init(V, W)
        self.layout = layout
        self.optimizer.configure(self.V, self.W, lam, layout)

    def als(self, tol: float, timelimit: float, maxsweep: int,
            resprint: int, plot: Optional[PlotFile] = None,
            macro: bool = False) -> bool:
        """The ALS loop (src/CP.cxx:111-187). Logs a CSV row (its
        iteration column is the float count of sweeps) every ``resprint``
        steps, at the start and from ``maxsweep`` sweeps on; the exact
        diagnostics run after a sync, in a window excluded from dtime.
        With ``macro`` and an optimizer that has ``step_cycle`` (MSDT),
        each step is a full rotation. Each step is a tracing scope
        ``<Optimizer>.step`` (or ``.step_cycle``).

        Every step counts toward dtime. The JAX package excludes steps
        that block the host beyond 50 ms, up to 3 per mode, as compiles;
        the port compiles nothing, and on an H100 a hold-out-0 MSDT step
        at the coil shape does 49-55 ms of real work, so that rule would
        drop real steps. Instead, before the clock starts, :func:`
        _warm_card` pays the first-use costs the steps would (the R x R
        solvers, a matmul, the kernels' load). A COO V takes the sparse
        engine's norm and diagnostics (models/sparse_cp.py).

        Under the layout of :meth:`init` the norm and the diagnostics are
        summed over the ranks' blocks (``cp.cp_diagnostics(layout=)``),
        the time limit reads rank 0's clock (every rank leaves at the
        same row) and the CSV's dimension column is the unsharded
        tensor's, as ``models/cp.py``'s engines write it."""
        V, layout = self.V, self.layout
        if isinstance(V, sparse.SparseTensor):
            V_norm_sq, diagnostics = (sparse.norm_sq(V),
                                      sparse_cp.sparse_diagnostics)
        else:
            V_norm_sq = contract.norm_sq(V, layout)

            def diagnostics(*a):
                return cp.cp_diagnostics(*a, layout=layout)
        dim = V.shape[0] if layout is None else layout.orig_shape[0]
        mesh = None if layout is None else layout.mesh
        clock = SweepClock()
        with clock.exclude():
            cp.warm_run(_warm_card, self.optimizer.W)
        opt = self.optimizer
        macro = macro and hasattr(opt, "step_cycle")
        fn = opt.step_cycle if macro else opt.step
        scope = f"{type(opt).__name__}.{'step_cycle' if macro else 'step'}"
        iters = 0
        sweeps = 0.0
        history = []
        while int(sweeps) <= maxsweep:
            if iters % resprint == 0 or sweeps >= maxsweep or sweeps == 0:
                cp._sync()
                with clock.exclude():
                    gn, dV = tracing.timed(
                        "cp.diagnostics", diagnostics, V_norm_sq, V,
                        opt.W, opt._lam(opt.W[0].dtype))
                    self.gradnorm, diffV = float(gn), float(dV)
                dtime = collectives.agreed_dtime(clock, mesh, opt.W[0].device)
                if plot is not None:
                    plot.row(dim, sweeps, self.gradnorm, tol, 0, diffV,
                             dtime)
                history.append(dict(sweeps=sweeps, gradnorm=self.gradnorm,
                                    diffV=diffV, dtime=dtime))
                if self.gradnorm < tol or dtime > timelimit:
                    break
            sweeps += tracing.timed(scope, fn)
            self.W = opt.W
            iters += 1
        self.history = history
        return self.gradnorm < tol

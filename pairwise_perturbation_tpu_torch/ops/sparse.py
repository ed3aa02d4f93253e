"""Sparse (COO) tensor operations for CP and Tucker ALS — port of
``pairwise_perturbation_tpu/ops/sparse.py``.

- storage is COO: ``indices[nnz, N]`` (int32, as the JAX package stores
  it) and ``values[nnz]``, on the tensors' device;
- the exact MTTKRP gathers factor rows, forms the Khatri-Rao product on
  the nonzeros and scatter-adds it into the mode's rows;
- PP caches contract the same nonzeros with a fused output index
  ``i * s_j + j`` (int64 here; the JAX package forms it in int32), into
  the dense rank-major caches ``(R, s_i, s_j)`` that
  ``contract.build_pp_caches`` makes, so the PP sweep is the dense
  engine's (``models/cp.pp_sweep``). Only cache builds and exact sweeps
  touch the nonzeros.

The JAX package routes its gathers and scatters through one-hot matmuls
below ``ONEHOT_BUDGET_ELEMS`` (sparse.py:90-155), a workaround for slow
scatter on the TPU. That routing is not ported: the plain route here is
``index_select`` + ``index_add_``, and the exact MTTKRP of a float32
tensor goes to the COO kernel module (``ops/kernels/coo_mttkrp.py``, K7)
when ``config.get().use_kernels`` is set.

The PP caches of a float32 tensor under ``use_kernels`` are K7's too: a
single M_i is the exact MTTKRP of mode i, and a pair T_ij is the MTTKRP
of the fused view (:func:`pair_view`), in which modes i and j are one
mode of size s_i * s_j indexed ``i * s_j + j``. K7 sums in an order fixed
by its plan, with no atomics, so a cache build repeats bit for bit. Its
products per nonzero run in mode order (v * W_0 * W_1 ...), where the
JAX build multiplies prefix * mid * suffix; the two round differently,
within the tests' float32 tolerance.

Sparse Tucker (:func:`ttm_dense` and what builds on it) contracts one
mode of the nonzeros into a dense tensor with a fused-index
``index_add_`` (the JAX package's ``segment_sum``; its fused indices are
int32 there, int64 here) and finishes the chain densely; no kernel
serves it, in either package.

Determinism: ``index_add_`` on CUDA adds with float atomics, so the plain
route (kernels off, or a dtype other than float32) varies from run to run
in the last bits on the card; on the CPU it is deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops import contract


@dataclass
class SparseTensor:
    """COO tensor: ``indices[nnz, order]``, ``values[nnz]``. ``plans``
    caches, built on first use, the COO kernel's per-mode sort (key: the
    mode; ops/kernels/coo_mttkrp.plan) and each fused pair view with its
    own sort (key: ``("pair", i, j)``; :func:`pair_view`)."""
    indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, ...]
    plans: Dict[object, object] = field(default_factory=dict, repr=False,
                                        compare=False)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def nnz(self):
        return self.values.shape[0]

    @property
    def dtype(self):
        return self.values.dtype


def from_dense(V, tol: float = 0.0, device="cuda") -> SparseTensor:
    """COO of the entries with |v| > tol of a dense host array, in
    ``np.argwhere``'s C order, as the JAX package builds it, so that sums
    over the nonzeros run in the same order."""
    Vh = np.asarray(V)
    idx = np.argwhere(np.abs(Vh) > tol).astype(np.int32)
    vals = Vh[tuple(idx.T)]
    return SparseTensor(torch.from_numpy(idx).to(device),
                        torch.from_numpy(vals).to(device),
                        tuple(int(s) for s in Vh.shape))


def to_dense(st: SparseTensor):
    """Dense tensor of ``st``; duplicate coordinates add up."""
    out = torch.zeros(st.shape, dtype=st.dtype, device=st.values.device)
    return out.index_put_(tuple(st.indices.long().T), st.values,
                          accumulate=True)


def norm_sq(st: SparseTensor):
    """||V||^2, accumulated in float32 for bf16 values."""
    v = st.values.float() if st.dtype == torch.bfloat16 else st.values
    return torch.dot(v, v)


def _gather_rows(W, idx):
    """W[idx, :]."""
    return W.index_select(0, idx)


def _gathered_kr(st: SparseTensor, Ws: Sequence, skip: Tuple[int, ...]):
    """values * prod_{j not in skip} W_j[idx_j, :]  -> (nnz, R); the
    skipped factors are not read (they may be None)."""
    W0 = next(W for j, W in enumerate(Ws) if j not in skip)
    prod = st.values[:, None] * torch.ones((1, W0.shape[1]), dtype=W0.dtype,
                                           device=W0.device)
    for j in range(st.ndim):
        if j in skip:
            continue
        prod = prod * _gather_rows(Ws[j], st.indices[:, j])
    return prod


def _scatter_rows(prod, idx, n_segments: int):
    """sum_n prod[n, :] into rows idx[n] of an (n_segments, R) output;
    rows no nonzero reaches stay zero."""
    out = torch.zeros((n_segments, prod.shape[1]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, idx, prod)


def _contiguous(Ws: Sequence):
    """``Ws`` itself when every factor is contiguous (K7's usual case: no
    new list, no copy), else contiguous copies where needed."""
    if all(W.is_contiguous() for W in Ws):
        return Ws
    return [W.contiguous() for W in Ws]


def _kernel_route(st: SparseTensor) -> bool:
    """Whether the MTTKRP and the PP caches of ``st`` go to K7."""
    return config.get().use_kernels and st.dtype == torch.float32


def mttkrp(st: SparseTensor, Ws: Sequence, mode: int):
    """Exact sparse MTTKRP: M[i, r] = sum_nnz v * prod_{j != mode} W_j.

    A float32 tensor with ``config.get().use_kernels`` goes to the COO
    kernel module (K7), which launches its CUDA kernel for a CUDA tensor
    (or raises) and runs its plain version for a CPU one; everything else
    takes the plain gather + ``index_add_`` (the JAX package's 'segment'
    route; its 'onehot' route, one-hot matmuls for the TPU's matrix
    unit, is not ported)."""
    if _kernel_route(st):
        from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
        return coo_mttkrp.coo_mttkrp(st, _contiguous(Ws), mode)
    prod = _gathered_kr(st, Ws, (mode,))
    return _scatter_rows(prod, st.indices[:, mode], st.shape[mode])


def _scatter_pair(st: SparseTensor, prod, i: int, j: int):
    """Fused-index (int64) scatter of ``prod`` into the rank-major pair
    cache (R, s_i, s_j)."""
    fused = st.indices[:, i].long() * st.shape[j] + st.indices[:, j].long()
    flat = _scatter_rows(prod, fused, st.shape[i] * st.shape[j])
    return flat.reshape(st.shape[i], st.shape[j], -1).permute(2, 0, 1) \
        .contiguous()


# Fused pair sizes from here on do not fit K7's int32 indices.
FUSED_LIMIT = 2 ** 31


def pair_view(st: SparseTensor, i: int, j: int) -> SparseTensor:
    """The tensor with modes i < j fused: mode i becomes one mode of size
    s_i * s_j with index ``i * s_j + j`` (formed in int64, stored in
    int32) and mode j is dropped, so the order is N - 1 (an order-2
    tensor gets a mode of size 1 in its place, since K7 takes order 2 and
    up). It shares ``st``'s values. Its MTTKRP of mode i with
    :func:`pair_factors` is the pair cache T_ij, rows in fused order.
    Built once and cached in ``st.plans[("pair", i, j)]``, where its own
    ``plans`` keep its K7 sort; a fused size of 2^31 or more raises."""
    key = ("pair", i, j)
    if key in st.plans:
        return st.plans[key]
    size = st.shape[i] * st.shape[j]
    if size >= FUSED_LIMIT:
        raise ValueError(
            f"fused pair ({i}, {j}) of shape {st.shape} has {size} rows, "
            f"2^31 or more: K7's int32 indices cannot hold it")
    idx = st.indices
    fused = idx[:, i].long() * st.shape[j] + idx[:, j].long()
    cols = [fused if m == i else idx[:, m] for m in range(st.ndim) if m != j]
    shape = [size if m == i else st.shape[m] for m in range(st.ndim)
             if m != j]
    if st.ndim == 2:
        cols.append(torch.zeros_like(fused))
        shape.append(1)
    view = SparseTensor(torch.stack([c.to(torch.int32) for c in cols], 1),
                        st.values, tuple(shape))
    st.plans[key] = view
    return view


def pair_factors(Ws: Sequence, i: int, j: int):
    """The factors of :func:`pair_view`'s modes: every mode's but i's and
    j's, with None for the fused mode i, which its MTTKRP never reads (and
    a row of ones for an order-2 tensor's added mode)."""
    fs = [None if m == i else W for m, W in enumerate(Ws) if m != j]
    if len(Ws) == 2:
        fs.append(torch.ones((1, Ws[0].shape[1]), dtype=Ws[0].dtype,
                             device=Ws[0].device))
    return fs


def pair_cache(st: SparseTensor, Ws: Sequence, i: int, j: int):
    """PP pair cache T_{ij} (rank-major, (R, s_i, s_j)) from the nonzeros
    (Build_mttkrp_map semantics, als_CP.cxx:352-409, with V sparse): K7 on
    the fused view where :func:`mttkrp` would take K7, else the plain
    gather + fused-index scatter."""
    if not _kernel_route(st):
        return _scatter_pair(st, _gathered_kr(st, Ws, (i, j)), i, j)
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    flat = coo_mttkrp.coo_mttkrp(
        pair_view(st, i, j), pair_factors(_contiguous(Ws), i, j),
        i)
    return flat.reshape(st.shape[i], st.shape[j], -1).permute(2, 0, 1) \
        .contiguous()


def build_pp_caches(st: SparseTensor, Ws: Sequence):
    """All PP caches from the sparse tensor: singles M_i (s_i, R) and
    rank-major pairs T_{ij} (R, s_i, s_j), the layout of
    contract.build_pp_caches.

    A float32 tensor under ``use_kernels`` takes K7: one launch per
    single (:func:`mttkrp`) and one per pair (:func:`pair_cache`), N +
    N(N-1)/2 in all. Otherwise, prefix/suffix reuse as in the JAX package
    (sparse.py:185-230): prefix_k = v * prod_{j<k} W_j[idx_j] and
    suffix_k = prod_{j>=k} W_j[idx_j] are formed once, and each pair
    (i, j) product is prefix_i * mid(i..j) * suffix_{j+1} with mid
    accumulated along j — O(N^2) elementwise (nnz, R) products instead of
    O(N^3)."""
    order = st.ndim
    if _kernel_route(st):
        return ({i: mttkrp(st, Ws, i) for i in range(order)},
                {(i, j): pair_cache(st, Ws, i, j) for i in range(order)
                 for j in range(i + 1, order)})
    R = Ws[0].shape[1]
    rows = [_gather_rows(Ws[j], st.indices[:, j]) for j in range(order)]
    ones = torch.ones((st.nnz, R), dtype=Ws[0].dtype, device=Ws[0].device)
    prefix = [st.values[:, None] * ones]          # prefix[k]: v * prod_{j<k}
    for k in range(order):
        prefix.append(prefix[k] * rows[k])
    suffix = [None] * (order + 1)                 # suffix[k]: prod_{j>=k}
    suffix[order] = ones
    for k in reversed(range(order)):
        suffix[k] = suffix[k + 1] * rows[k]

    single = {i: _scatter_rows(prefix[i] * suffix[i + 1], st.indices[:, i],
                               st.shape[i])
              for i in range(order)}
    pair = {}
    for i in range(order):
        mid = prefix[i]                            # v * prod_{j<i}
        for j in range(i + 1, order):
            pair[(i, j)] = _scatter_pair(st, mid * suffix[j + 1], i, j)
            mid = mid * rows[j]                    # absorb mode j
    return single, pair


def cp_gradnorm(st: SparseTensor, Ws: Sequence, regul=None):
    """Exact CP gradient norm against the sparse tensor (one exact MTTKRP
    per mode)."""
    total = 0.0
    for i in range(st.ndim):
        M = mttkrp(st, Ws, i)
        S = contract.hadamard_gram(Ws, skip_mode=i, regul=regul)
        g = contract.gradsubprob(M, S, Ws[i])
        total = total + torch.sum(g * g)
    return torch.sqrt(total)


def cp_residual_norm(V_norm_sq, st: SparseTensor, Ws: Sequence):
    """||V - [[W]]|| via the norm identity with a fresh sparse MTTKRP."""
    M_last = mttkrp(st, Ws, st.ndim - 1)
    return contract.cp_residual_norm(V_norm_sq, M_last, list(Ws))


# ---------------------------------------------------------------------------
# Sparse Tucker (-issparse 1 -model Tucker)
#
# One mode of the nonzeros is contracted with its factor by a fused-index
# scatter-add, into a DENSE tensor with that mode reduced to its rank (the
# intermediate the dense engine's own chain makes after one step); the
# rest of the chain is dense. The first mode is the one that shrinks the
# tensor most (s_m / r_m).
# ---------------------------------------------------------------------------


def _fused_index(st: SparseTensor, modes: Sequence[int]):
    """Row-major fused index (int64) of the nonzeros over ``modes``."""
    fused = torch.zeros(st.nnz, dtype=torch.int64, device=st.indices.device)
    for m in modes:
        fused = fused * st.shape[m] + st.indices[:, m].long()
    return fused


def ttm_dense(st: SparseTensor, W, mode: int, rank_last: bool = False):
    """V x_mode W^T as a DENSE tensor: ``mode``'s axis reduced to W's rank
    in place (or, with ``rank_last``, the remaining modes ascending and
    the rank axis last: the dimension-tree first-level layout). One
    gather and one fused-index ``index_add_`` (JAX sparse.py:248-272)."""
    others = [m for m in range(st.ndim) if m != mode]
    vals = st.values[:, None] * _gather_rows(W, st.indices[:, mode])
    n_seg = int(np.prod([st.shape[m] for m in others]))
    flat = _scatter_rows(vals, _fused_index(st, others), n_seg)
    out = flat.reshape(tuple(st.shape[m] for m in others) + (W.shape[1],))
    return out if rank_last else out.movedim(-1, mode)


def _best_contract_mode(st: SparseTensor, ranks, keep) -> int:
    """The mode outside ``keep`` with the largest reduction s_m / r_m (the
    first on a tie)."""
    cands = [m for m in range(st.ndim) if m not in keep]
    return max(cands, key=lambda m: st.shape[m] / max(ranks[m], 1))


def _dense_rest(T, Ws: Sequence, skip: Sequence[int]):
    """The dense TTMc chain over every mode not in ``skip``, ascending."""
    for m in range(T.ndim):
        if m not in skip:
            T = contract.ttmc_contract_mode(T, Ws[m], m)
    return T


def ttmc(st: SparseTensor, Ws: Sequence, skip_mode: int = -1):
    """Sparse TTMc over every mode except ``skip_mode``: one sparse TTM on
    the best-reducing mode, then the dense chain (contract.ttmc's
    semantics, als_Tucker.cxx:76-110 with V sparse)."""
    keep = () if skip_mode < 0 else (skip_mode,)
    m0 = _best_contract_mode(st, [W.shape[1] for W in Ws], keep)
    return _dense_rest(ttm_dense(st, Ws[m0], m0), Ws, keep + (m0,))


def build_ttmc_caches(st: SparseTensor, Ws: Sequence):
    """Tucker PP caches from the sparse tensor, in contract.build_ttmc_caches'
    layouts (kept modes full, contracted modes rank-sized), so the PP
    sweep is the dense engine's. Each cache densifies through one sparse
    TTM (the best-reducing mode outside its kept set), memoized across the
    caches of the build, and finishes densely (Build_ttmc_map,
    als_Tucker.cxx:426-466)."""
    ranks = [W.shape[1] for W in Ws]
    memo = {}

    def cache(keep):
        m0 = _best_contract_mode(st, ranks, keep)
        if m0 not in memo:
            memo[m0] = ttm_dense(st, Ws[m0], m0)
        return _dense_rest(memo[m0], Ws, keep + (m0,))

    order = st.ndim
    single = {i: cache((i,)) for i in range(order)}
    pair = {(i, j): cache((i, j))
            for i in range(order) for j in range(i + 1, order)}
    return single, pair


def _columns(st: SparseTensor, mode: int):
    """(inverse, count): each nonzero's column of the mode-``mode``
    unfolding, compacted to the populated columns in ascending fused
    order (int64 fused index, ``torch.unique``), and their count."""
    fused = _fused_index(st, [m for m in range(st.ndim) if m != mode])
    uniq, inv = torch.unique(fused, sorted=True, return_inverse=True)
    return inv, max(int(uniq.numel()), 1)


def sketch_rows(st: SparseTensor, mode: int, k: int, seed: int):
    """The port's per-nonzero rows of the sketch matrix Omega (uniform in
    [-1, 1)) for mode ``mode``: one row per populated column of the
    unfolding, drawn from a CPU ``torch.Generator`` seeded with ``seed``
    and gathered to the nonzeros, so nonzeros that share a column share
    their row and no (prod of other modes, k) Omega is formed. The JAX
    package hashes the column's index tuple instead (a fold_in chain); its
    rows can be passed to :func:`mode_subspace_sketch` in place of these."""
    inv, n_cols = _columns(st, mode)
    gen = torch.Generator().manual_seed(int(seed))
    omega = torch.rand((n_cols, k), generator=gen, dtype=st.values.dtype)
    return (2.0 * omega - 1.0).to(st.values.device).index_select(0, inv)


def mode_subspace_sketch(st: SparseTensor, mode: int, omega_rows):
    """Randomized range sketch B = unfold(V) Omega of the mode-``mode``
    unfolding, computed on the nonzeros: ``omega_rows`` holds each
    nonzero's row of Omega (nnz, k) (:func:`sketch_rows`, or the JAX
    package's draw). QR of B spans the leading subspace (the sparse
    replacement of the Gram + eigh HOSVD, als_Tucker.cxx:12-23)."""
    return _scatter_rows(st.values[:, None] * omega_rows,
                         st.indices[:, mode], st.shape[mode])


def mode_power_iter(st: SparseTensor, mode: int, U):
    """One (A A^T) U pass of the mode unfolding A on the nonzeros: A^T U
    over the populated columns only (compacted, int64 fused index), then
    A (A^T U); two scatter-adds (JAX sparse.py:356-386)."""
    inv, n_cols = _columns(st, mode)
    idx = st.indices[:, mode]
    P = _scatter_rows(st.values[:, None] * _gather_rows(U, idx), inv,
                      n_cols)
    return _scatter_rows(st.values[:, None] * _gather_rows(P, inv), idx,
                         st.shape[mode])

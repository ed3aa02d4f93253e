"""Sparse (COO) tensor operations for CP-ALS — port of the CP half of
``pairwise_perturbation_tpu/ops/sparse.py`` (lines 36-230, 389-405).

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

Determinism: ``index_add_`` on CUDA adds with float atomics, so the plain
route's sums vary from run to run in the last bits (ROADMAP C6); on the
CPU it is deterministic. The PP pair and single caches are built by this
plain route on every device: no TPU kernel exists for them.
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
    caches the COO kernel's per-mode sort (ops/kernels/coo_mttkrp.plan),
    built on first use."""
    indices: torch.Tensor
    values: torch.Tensor
    shape: Tuple[int, ...]
    plans: Dict[int, object] = field(default_factory=dict, repr=False,
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
    """values * prod_{j not in skip} W_j[idx_j, :]  -> (nnz, R)."""
    R = Ws[0].shape[1]
    prod = st.values[:, None] * torch.ones((1, R), dtype=Ws[0].dtype,
                                           device=Ws[0].device)
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


def mttkrp(st: SparseTensor, Ws: Sequence, mode: int):
    """Exact sparse MTTKRP: M[i, r] = sum_nnz v * prod_{j != mode} W_j.

    A float32 tensor with ``config.get().use_kernels`` goes to the COO
    kernel module (K7), which launches its CUDA kernel for a CUDA tensor
    (or raises) and runs its plain version for a CPU one; everything else
    takes the plain gather + ``index_add_`` (the JAX package's 'segment'
    route; its 'onehot' route is not ported, ROADMAP A13)."""
    if config.get().use_kernels and st.dtype == torch.float32:
        from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
        return coo_mttkrp.coo_mttkrp(st, [W.contiguous() for W in Ws], mode)
    prod = _gathered_kr(st, Ws, (mode,))
    return _scatter_rows(prod, st.indices[:, mode], st.shape[mode])


def _scatter_pair(st: SparseTensor, prod, i: int, j: int):
    """Fused-index (int64) scatter of ``prod`` into the rank-major pair
    cache (R, s_i, s_j)."""
    fused = st.indices[:, i].long() * st.shape[j] + st.indices[:, j].long()
    flat = _scatter_rows(prod, fused, st.shape[i] * st.shape[j])
    return flat.reshape(st.shape[i], st.shape[j], -1).permute(2, 0, 1) \
        .contiguous()


def pair_cache(st: SparseTensor, Ws: Sequence, i: int, j: int):
    """PP pair cache T_{ij} (rank-major, (R, s_i, s_j)) from the nonzeros
    (Build_mttkrp_map semantics, als_CP.cxx:352-409, with V sparse)."""
    return _scatter_pair(st, _gathered_kr(st, Ws, (i, j)), i, j)


def build_pp_caches(st: SparseTensor, Ws: Sequence):
    """All PP caches from the sparse tensor: singles M_i (s_i, R) and
    rank-major pairs T_{ij} (R, s_i, s_j), the layout of
    contract.build_pp_caches.

    Prefix/suffix reuse as in the JAX package (sparse.py:185-230):
    prefix_k = v * prod_{j<k} W_j[idx_j] and suffix_k = prod_{j>=k}
    W_j[idx_j] are formed once, and each pair (i, j) product is
    prefix_i * mid(i..j) * suffix_{j+1} with mid accumulated along j —
    O(N^2) elementwise (nnz, R) products instead of O(N^3)."""
    order = st.ndim
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

"""Sparse COO MTTKRP: the hand-written CUDA kernel and its plain PyTorch
version.

    M[i, r] = sum_n v_n * prod_{j != mode} W_j[idx_j[n], r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/coo_pallas.py``:
``coo_mttkrp`` and its Pallas kernel ``_kernel`` (K7), which builds the
gathers and the scatter as one-hot matmuls in VMEM. The CUDA kernel
(``csrc/coo_mttkrp.cu``) computes the same sum without one-hots and
without atomics, so that two runs agree bit for bit:

- setup, once per tensor and mode (:func:`plan`, cached on the tensor):
  a stable sort of the nonzeros by their mode index, stored as sorted
  copies of the indices (transposed, one contiguous row per mode) and of
  the values, and a split of the sorted nonzeros into chunks of at most
  ``CHUNK`` that never cross a row (:func:`chunk_plan`);
- launch 1: one warp per chunk gathers the factor rows, forms the
  products and reduces them in a fixed order into one (R,) partial;
- launch 2: one warp per row sums its chunks' partials in a fixed order.
  Rows no nonzero reaches come out as exact zeros.

The source's header says what bounds the kernel and where the factors
live.

:func:`coo_mttkrp`, called by ``sparse.mttkrp``, launches the kernel for a
CUDA tensor, or raises; it takes the plain version
(:func:`coo_mttkrp_plain`) only for a tensor on the CPU. Each launch (both
passes) adds one to ``LAUNCHES["coo_mttkrp"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence

import torch

from pairwise_perturbation_tpu_torch.ops import sparse
from pairwise_perturbation_tpu_torch.ops.kernels import _build

# Kernel launches, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"coo_mttkrp": 0}

# Nonzeros per chunk (one warp's share in launch 1), the largest order the
# kernel takes (csrc/coo_mttkrp.cu kMaxOrder), and the shared memory the
# factors may take: half of the 227 KB a block can have, so that two
# blocks fit on an SM. Larger factors are read through L2.
CHUNK = 256
MAX_ORDER = 16
SMEM_CAP = 116224


class CooPlan(NamedTuple):
    """The sorted nonzeros of one mode and their chunks."""
    idxT: torch.Tensor           # (order, nnz) int32, sorted by the mode
    values: torch.Tensor         # (nnz,), sorted the same way
    chunk_ptr: torch.Tensor      # (n_chunks + 1,) int64 starts, then nnz
    row_chunk_ptr: torch.Tensor  # (s_mode + 1,) int64: row r's chunks


def reset_launch_counts() -> None:
    LAUNCHES["coo_mttkrp"] = 0


def coo_mttkrp_plain(st, Ws: Sequence, mode: int):
    """Plain PyTorch version; what the kernel is held to. The products are
    the sparse engine's own (``sparse._gathered_kr``: the factors' dtype,
    mode order, as the kernel forms them); the scatter (``index_add_``)
    accumulates in float64 and the result is cast back. A float32
    accumulator would not serve as the oracle: one row may hold millions
    of nonzeros, and summing 4M float32 products into one float32 row lost
    0.4% of the sum to rounding (CPU measurement), far above the kernel's
    tolerance."""
    prod = sparse._gathered_kr(st, Ws, (mode,))
    out = torch.zeros((st.shape[mode], prod.shape[1]), dtype=torch.float64,
                      device=prod.device)
    return out.index_add_(0, st.indices[:, mode], prod.double()) \
        .to(prod.dtype)


def chunk_plan(counts, chunk: int = CHUNK):
    """(chunk_ptr, row_chunk_ptr) of nonzeros sorted by row, with
    ``counts[r]`` nonzeros in row r: row r is cut into ceil(counts[r] /
    chunk) chunks of at most ``chunk`` nonzeros, so no chunk crosses a
    row. ``chunk_ptr`` holds every chunk's first sorted position and then
    nnz; row r owns chunks ``row_chunk_ptr[r]`` to ``row_chunk_ptr[r + 1]``
    (none for an empty row)."""
    counts = counts.to(torch.int64)
    dev = counts.device
    per_row = (counts + chunk - 1) // chunk
    row_chunk_ptr = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                                device=dev)
    row_chunk_ptr[1:] = torch.cumsum(per_row, 0)
    row_ptr = torch.zeros_like(row_chunk_ptr)
    row_ptr[1:] = torch.cumsum(counts, 0)
    row_of = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), per_row)
    n_chunks = row_of.numel()
    local = torch.arange(n_chunks, device=dev) - row_chunk_ptr[row_of]
    chunk_ptr = torch.empty(n_chunks + 1, dtype=torch.int64, device=dev)
    chunk_ptr[:-1] = row_ptr[row_of] + local * chunk
    chunk_ptr[-1] = row_ptr[-1]
    return chunk_ptr, row_chunk_ptr


def plan(st, mode: int) -> CooPlan:
    """The kernel's setup for ``mode``: built on first use on the tensor's
    device and cached in ``st.plans``. Checks every index against the
    shape once, here, since the kernel reads factor rows by index."""
    if mode in st.plans:
        return st.plans[mode]
    idx = st.indices
    lo, hi = idx.min(0).values, idx.max(0).values
    shape = torch.tensor(st.shape, device=idx.device)
    if bool((lo < 0).any()) or bool((hi >= shape.to(hi.dtype)).any()):
        raise ValueError(f"COO indices out of range of shape {st.shape}")
    rows = idx[:, mode]
    perm = torch.argsort(rows, stable=True)
    counts = torch.bincount(rows, minlength=st.shape[mode])
    p = CooPlan(idx.index_select(0, perm).T.to(torch.int32).contiguous(),
                st.values.index_select(0, perm).contiguous(),
                *chunk_plan(counts))
    st.plans[mode] = p
    return p


def _check(st, Ws: Sequence, mode: int):
    order = len(st.shape)
    if not 0 <= mode < order:
        raise ValueError(f"mode {mode} out of range for order {order}")
    if order < 2 or order > MAX_ORDER or len(Ws) != order:
        raise ValueError(f"order 2..{MAX_ORDER} with one factor per mode "
                         f"expected, got order {order} and {len(Ws)} "
                         "factors")
    if st.indices.ndim != 2 or tuple(st.indices.shape) != (st.nnz, order):
        raise ValueError(f"indices of shape {tuple(st.indices.shape)}, "
                         f"expected ({st.nnz}, {order})")
    if st.nnz == 0:
        raise ValueError("the kernel needs at least one nonzero")
    # the mode's own factor is never read: it may be None (a fused pair
    # mode, sparse.pair_factors); any other is checked
    given = [(m, W) for m, W in enumerate(Ws)
             if not (m == mode and W is None)]
    W1 = Ws[1 if mode == 0 else 0]
    R = W1.shape[1] if W1.ndim == 2 else -1
    for m, W in given:
        if W.ndim != 2 or tuple(W.shape) != (st.shape[m], R) or R <= 0:
            raise ValueError(f"factor {m} has shape {tuple(W.shape)}, "
                             f"expected ({st.shape[m]}, R)")
    dev = st.values.device
    for name, t in [("values", st.values), ("indices", st.indices)] + [
            (f"factor {m}", W) for m, W in given]:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             "every operand on the values' CUDA device")
    if st.dtype != torch.float32:
        raise TypeError(f"values are {st.dtype}; the kernel takes float32")
    for m, W in given:
        if W.dtype != torch.float32:
            raise TypeError(f"factor {m} is {W.dtype}; the kernel takes "
                            "float32")
        if not W.is_contiguous():
            raise ValueError(f"factor {m} is not contiguous")
    return R


def smem_bytes(shape: Sequence[int], R: int, mode: int) -> int:
    """Shared memory of launch 1: every factor but the mode's, when they
    fit under SMEM_CAP; 0 (factors read through L2) otherwise."""
    n = 4 * R * sum(s for m, s in enumerate(shape) if m != mode)
    return n if n <= SMEM_CAP else 0


def coo_mttkrp(st, Ws: Sequence, mode: int):
    """Sparse MTTKRP of ``mode``: (st.shape[mode], R). ``Ws[mode]`` is
    never read and may be None.

    CPU tensors go to the plain version; CUDA tensors launch the kernel on
    the current stream (float32 values and contiguous float32 factors) or
    raise. The first call for a mode builds its :func:`plan`."""
    if st.values.device.type == "cpu":
        return coo_mttkrp_plain(st, Ws, mode)
    R = _check(st, Ws, mode)
    p = plan(st, mode)
    order, dev = len(st.shape), st.values.device
    n_chunks = p.chunk_ptr.numel() - 1
    partial = torch.empty((n_chunks, R), dtype=torch.float32, device=dev)
    out = torch.empty((st.shape[mode], R), dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * order)(*(0 if W is None else W.data_ptr()
                                       for W in Ws))
    sizes = (ctypes.c_int64 * order)(*st.shape)
    lib = _build.load()
    code = lib.pp_coo_mttkrp(
        p.idxT.data_ptr(), p.values.data_ptr(), ptrs, sizes, order, mode,
        st.nnz, R, p.chunk_ptr.data_ptr(), n_chunks,
        p.row_chunk_ptr.data_ptr(), partial.data_ptr(), out.data_ptr(),
        smem_bytes(st.shape, R, mode),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "coo_mttkrp launch")
    LAUNCHES["coo_mttkrp"] += 1
    return out

"""Device-mesh layer on ``torch.distributed`` — port of
``pairwise_perturbation_tpu/parallel/mesh.py``, the replacement for CTF's
distributed tensor runtime (SURVEY.md section 2.6).

The JAX package runs one controller over a mesh of devices and lets
``shard_map`` and GSPMD place the collectives. Here each mesh device is a
process of its own, started by ``torchrun`` and joined by
``init_process_group`` (:func:`distributed_init`). The mesh is a
``DeviceMesh`` with the JAX package's axis names (``x``, ``x1``, ...).
Each rank holds only its own shard as a plain local tensor, and every
``psum`` of the JAX package is an explicit ``dist.all_reduce(SUM)`` over
the mesh's group, or over a sub-mesh group of a 2D layout.

Backend rule (printed in the CLI banner):

- ``nccl`` when every rank of a host has a card of its own;
- ``gloo`` on the CPU, or when a host has more ranks than cards (one
  H100 and two ranks: NCCL refuses two ranks on one card). The tensors
  stay on the card and gloo stages the reduction through the host.

Only ``all_reduce`` and ``broadcast`` are used: they are the collectives
gloo takes on CUDA tensors (PyTorch's backend table marks
``all_gather``, ``reduce_scatter`` and the rest CPU-only for gloo). So
:func:`unshard_factors` gathers rows by an ``all_reduce`` of a zero-filled
full-height matrix, which is exact (x + 0 = x).

Two halves, as in the JAX package:

- dense layouts (:func:`plan_layout`, :func:`shard_tensor`,
  :func:`shard_factors`, :func:`unshard_factors`, :func:`sharded_mttkrp`,
  :func:`constrained_pp_caches`, :func:`constrained_ttmc_caches`): V
  block-sharded over its largest modes, zero-padded to a multiple of the
  axis (padding is invisible to ALS: the padded slices of V are zero, so
  padded rows of every MTTKRP and factor stay zero). Each rank holds its
  block of V, the row blocks of the factors of sharded modes and the
  whole factors of the others. The dense engines (models/cp.py,
  models/tucker.py) take the layout as ``mesh_layout`` in their configs,
  and their sweep functions as ``layout=``; where the JAX package lets
  GSPMD place the collectives, each engine calls the reduction hooks
  of parallel/collectives.py, which this module re-exports
  (:func:`reduce_parts`, :func:`reduce_modes`, :func:`row_sum`,
  :func:`gather_rows`, :func:`gather_blocks`, :func:`broadcast_block`),
  every one the identity for ``layout=None``, by three rules: a
  contraction over a sharded mode leaves a partial sum, summed at the
  smallest tensor that holds it (an MTTKRP or TTMc leaf, a cache, a
  corrected term), never at an intermediate that still holds a mode of
  V; a sum over the rows of a row-sharded factor (a Gram, a norm, an
  inner product) is a partial too, reduced as the small result; every
  decision reads reduced values. Planning (contraction order, the tree's
  root split) reads the padded global shape, the CSV's dimension column
  the unsharded one.
  Tucker's sharded mode needs rows of other ranks twice: HOSVD's Gram of
  that mode is assembled block by block (:func:`broadcast_block`, exact
  eigh route) or applied matrix-free (subspace route,
  models/tucker.hosvd), and a factor extracted on the mode side gathers
  its unfolding's rows (:func:`gather_rows`);
- the nnz-sharded COO (:func:`shard_coo` and the ``sharded_sparse_*``
  functions): each rank contracts its block of the nonzeros into a
  replicated dense output, and one ``all_reduce`` sums the partials
  (scatter-adds commute with the nnz split). The sparse engines
  (models/sparse_cp.py, models/sparse_tucker.py) take it as ``mesh=``.

Every rank must make the same decisions, so everything the ranks hold in
common is either all-reduced (bitwise equal on every rank) or computed
from all-reduced values by deterministic local operations.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pairwise_perturbation_tpu_torch.ops import contract
from pairwise_perturbation_tpu_torch.ops import sparse as sp
# The collectives and the dense engines' reduction hooks live in a leaf
# module (the ops layer imports them); they are this module's API too.
from pairwise_perturbation_tpu_torch.parallel.collectives import (
    _coordinate, _reduce_buffer, agreed_dtime, all_reduce, axis_sizes,
    broadcast, broadcast_block, broadcast_scalar, gather_blocks,
    gather_rows, is_sharded, reduce_parts, reduce_modes, row_sum)

# What torchrun sets in every rank's environment (env:// rendezvous).
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched() -> bool:
    """Whether this process was started by ``torchrun`` (its rendezvous
    environment is set)."""
    return all(os.environ.get(k) for k in _TORCHRUN_ENV)


def world_size() -> int:
    """The torchrun world's size, 1 outside torchrun."""
    return int(os.environ["WORLD_SIZE"]) if launched() else 1


def rank() -> int:
    """This process's rank in the joined world, 0 outside one."""
    return dist.get_rank() if dist.is_initialized() else 0


def backend_for(device_type: str, ranks_on_host: int, cards: int) -> str:
    """The backend rule: ``nccl`` when every rank of a host has a card of
    its own, ``gloo`` on the CPU or when ranks share a card."""
    if device_type == "cuda" and ranks_on_host <= cards:
        return "nccl"
    return "gloo"


def distributed_init(device: str = "cuda") -> torch.device:
    """Join the torchrun world (replaces MPI_Init + CTF ``World``,
    test_ALS.cxx:58-60) and return this rank's device.

    Without torchrun's environment it is a no-op and returns ``device``.
    Under torchrun a CUDA rank takes ``cuda:{LOCAL_RANK % device_count}``
    and the backend follows :func:`backend_for`. A failed bring-up
    raises: running quietly on 1/N of the machine while looking healthy
    is never an option."""
    dev = torch.device(device)
    if not launched():
        return dev
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    cards = 0
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("distributed_init: a CUDA rank found no "
                               "CUDA device (use -device cpu)")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend_for(dev.type, on_host, cards)
    try:
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"multi-process bring-up failed (backend {backend}, rank "
            f"{os.environ['RANK']} of {os.environ['WORLD_SIZE']}, "
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}): "
            f"{e}") from e
    return dev


def backend() -> str:
    """The joined world's backend, or "none" outside one."""
    return dist.get_backend() if dist.is_initialized() else "none"


def distributed_close() -> None:
    """Leave the world (destroy the default process group), if joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def default_axis_names(ndim: int) -> Tuple[str, ...]:
    """The JAX package's axis names: x, x1, x2, ... (mesh.py:79-81)."""
    return tuple(f"x{i}" if i else "x" for i in range(ndim))


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Optional[Sequence[str]] = None,
              device_type: str = "cpu"):
    """A ``DeviceMesh`` over the joined world, one rank per device, in
    row-major rank order (as JAX's ``Mesh`` reshapes its devices).
    Default: every rank on one axis ``x``. ``device_type`` is the ranks'
    device type (``cuda`` or ``cpu``)."""
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    mesh_shape = tuple(int(s) for s in (mesh_shape or (n,)))
    axis_names = tuple(axis_names or default_axis_names(len(mesh_shape)))
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh shape {mesh_shape} needs {math.prod(mesh_shape)}"
                         f" ranks; the world has {n}")
    mesh = init_device_mesh(device_type, mesh_shape,
                            mesh_dim_names=axis_names)
    # one collective per axis opens its group's communicator now, at
    # set-up: NCCL opens it at the first collective (over a second)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device_type == "cuda" else torch.device("cpu")
    for axis in axis_names:
        _reduce_buffer(torch.zeros(1, device=dev), mesh.get_group(axis))
    return mesh


@dataclass
class ShardedLayout:
    """Static layout decision: which tensor mode maps to which mesh axis."""
    mesh: object
    mode_axis: dict            # tensor mode -> mesh axis name
    padded_shape: Tuple[int, ...]
    orig_shape: Tuple[int, ...]

    def v_spec(self) -> Tuple[Optional[str], ...]:
        """V's partition spec: each mode's axis name, or None."""
        return tuple(self.mode_axis.get(m)
                     for m in range(len(self.padded_shape)))

    def w_spec(self, mode: int) -> Tuple[Optional[str], None]:
        return (self.mode_axis.get(mode), None)

    def span(self, mode: int) -> Tuple[int, int]:
        """(start, stop) of this rank's block of ``mode`` in the padded
        index space: the contiguous span ``NamedSharding`` gives the
        device at this rank's mesh coordinate."""
        axis = self.mode_axis.get(mode)
        p = self.padded_shape[mode]
        if axis is None:
            return 0, p
        b = p // axis_sizes(self.mesh)[axis]
        c = _coordinate(self.mesh, axis)
        return c * b, (c + 1) * b


def plan_layout(shape: Sequence[int], mesh,
                modes: Optional[Sequence[int]] = None) -> ShardedLayout:
    """Map the largest tensor modes onto the mesh axes (largest mode to
    the largest axis), as JAX mesh.py:102-118 does: chosen once, so MTTKRP
    partials stay local until one reduction."""
    shape = tuple(int(s) for s in shape)
    axes = sorted(axis_sizes(mesh).items(), key=lambda kv: -kv[1])
    if modes is None:
        order_by_size = sorted(range(len(shape)), key=lambda m: -shape[m])
        modes = order_by_size[:len(axes)]
    mode_axis = {}
    padded = list(shape)
    for (axis, k), m in zip(axes, modes):
        mode_axis[m] = axis
        padded[m] = ((shape[m] + k - 1) // k) * k
    return ShardedLayout(mesh, mode_axis, tuple(padded), shape)


def _padded_block(X, spans, device=None, dtype=None):
    """The block of ``X`` (a tensor, or a numpy array or memmap, of which
    only the block is read) at ``spans`` in the padded index space, as a
    contiguous tensor on ``device``, zero beyond X's extent."""
    src = tuple(slice(min(lo, s), min(hi, s))
                for (lo, hi), s in zip(spans, X.shape))
    part = X[src]
    if not isinstance(part, torch.Tensor):
        part = torch.from_numpy(np.ascontiguousarray(part, dtype=dtype))
    out = torch.zeros([hi - lo for lo, hi in spans], dtype=part.dtype,
                      device=device if device is not None else part.device)
    out[tuple(slice(0, sl.stop - sl.start) for sl in src)] = part
    return out


def shard_tensor(V, layout: ShardedLayout, device=None):
    """This rank's zero-padded block of V (a tensor or a host array)."""
    return _padded_block(V, [layout.span(m) for m in range(V.ndim)], device)


def shard_factors(Ws: Sequence, layout: ShardedLayout, device=None):
    """Row blocks of the factors of sharded modes (zero-padded), whole
    factors of the others."""
    return [_padded_block(W, [layout.span(m), (0, W.shape[1])], device)
            for m, W in enumerate(Ws)]


def unshard_factors(Ws: Sequence, layout: ShardedLayout) -> List[np.ndarray]:
    """Every rank's copy of the full factors as host arrays, padding rows
    stripped: a sharded factor's blocks are placed in a zero-filled
    full-height matrix and summed over its axis (one all_reduce)."""
    out = []
    for m, W in enumerate(Ws):
        axis = layout.mode_axis.get(m)
        if axis is not None:
            full = torch.zeros((layout.padded_shape[m], W.shape[1]),
                               dtype=W.dtype, device=W.device)
            lo, hi = layout.span(m)
            full[lo:hi] = W
            W = all_reduce([full], layout.mesh, (axis,))[0]
        out.append(W[:layout.orig_shape[m]].cpu().numpy())
    return out


# ---------------------------------------------------------------------------
# Explicit-collective dense MTTKRP and PP caches
# ---------------------------------------------------------------------------


def sharded_mttkrp(V, Ws: Sequence, mode: int, layout: ShardedLayout):
    """MTTKRP of this rank's block of V with its factor blocks
    (contract.mttkrp: K1-K3 on an order-3 float32 block on the card),
    then one all_reduce over the axes of the other sharded modes. Returns
    this rank's row block of the (padded) result."""
    return contract.mttkrp(V, list(Ws), mode, layout=layout)


def _constrained(single, pair, layout: ShardedLayout):
    """Caches keyed by the modes they keep, each summed over the axes of
    the sharded modes it contracted away (caches with the same axes share
    one all_reduce)."""
    order = len(layout.padded_shape)
    keys = [(i,) for i in single] + list(pair)
    xs = [single[k[0]] if len(k) == 1 else pair[k] for k in keys]
    out = dict(zip(keys, reduce_parts(
        [(x, [m for m in range(order) if m not in k])
         for k, x in zip(keys, xs)], layout)))
    return {i: out[(i,)] for i in single}, {k: out[k] for k in pair}


def constrained_pp_caches(V, Ws: Sequence, layout: ShardedLayout,
                          layouts=None):
    """PP caches of this rank's block (contract.build_pp_caches, planned
    on the padded global shape; ``layouts``: mode-minor copies of the
    block), each summed over the axes of the sharded modes it contracted
    away, so it keeps the blocks of the modes it retains: the layout JAX's
    sharding constraints pin (mesh.py:196-220), the rank axis
    replicated."""
    return _constrained(*contract.build_pp_caches(
        V, list(Ws), shape=layout.padded_shape, layouts=layouts), layout)


def constrained_ttmc_caches(V, Ws: Sequence, layout: ShardedLayout):
    """Tucker's PP caches of this rank's block (contract.build_ttmc_caches,
    planned on the padded global shape), each summed over the axes of the
    sharded modes it contracted away: the layout JAX tucker.py:975-981 and
    :1065-1070 pin (a cache keeps the blocks of its uncontracted modes;
    its contracted axes are rank-sized and replicated)."""
    return _constrained(*contract.build_ttmc_caches(
        V, list(Ws), shape=layout.padded_shape), layout)


# ---------------------------------------------------------------------------
# Mesh-sharded COO tensors (sparse V distributed by nonzeros)
# ---------------------------------------------------------------------------
#
# The reference's sparse CTF tensors are distributed over the MPI world
# like the dense ones (test_ALS.cxx:126-131, 229). Here the COO arrays are
# split by nonzero index (the only long axis); each rank contracts its
# nonzeros into replicated dense outputs (factor-sized matrices, pair
# caches), and one all_reduce sums them: scatter-adds commute with the nnz
# split, so the partials are exact.


def _coo_axis(mesh) -> str:
    return mesh.mesh_dim_names[0]


def check_1d(mesh) -> None:
    """Refuse a mesh of more than one axis for the nnz-sharded COO."""
    sizes = axis_sizes(mesh)
    if math.prod(sizes.values()) != sizes[_coo_axis(mesh)]:
        raise ValueError("shard_coo expects a 1D mesh (nnz axis only); "
                         f"got mesh shape {sizes}")


def shard_coo(st, mesh, axis: str = None):
    """This rank's block of a SparseTensor's nonzeros: the nnz axis is
    zero-padded to a multiple of the axis size (padding entries carry
    value 0 at index 0, contributing nothing to any reduction) and cut
    into contiguous blocks, as JAX's ``P(axis)`` cuts it. The shard has
    the global shape and K7 plans of its own."""
    check_1d(mesh)
    axis = axis or _coo_axis(mesh)
    n = axis_sizes(mesh)[axis]
    blk = -(-st.nnz // n)
    c = _coordinate(mesh, axis)
    lo, hi = min(c * blk, st.nnz), min((c + 1) * blk, st.nnz)
    pad = blk - (hi - lo)
    # cat copies even when pad is 0: the shard holds no view of the
    # whole COO, which the caller may free
    idx = torch.cat([st.indices[lo:hi], st.indices.new_zeros((pad, st.ndim))])
    val = torch.cat([st.values[lo:hi], st.values.new_zeros(pad)])
    return sp.SparseTensor(idx, val, st.shape)


def _cache_items(single, pair):
    keys = [(i,) for i in sorted(single)] + sorted(pair)
    return keys, [single[k[0]] if len(k) == 1 else pair[k] for k in keys]


def _reduced_caches(single, pair, mesh):
    keys, xs = _cache_items(single, pair)
    out = dict(zip(keys, all_reduce(xs, mesh)))
    return ({i: out[(i,)] for i in single}, {k: out[k] for k in pair})


def sharded_sparse_norm_sq(st, mesh):
    """||V||^2 over every rank's nonzeros (ops/sparse.norm_sq summed)."""
    return all_reduce([sp.norm_sq(st)], mesh)[0]


def sharded_sparse_mttkrp(st, Ws: Sequence, mode: int, mesh):
    """Exact sparse MTTKRP of this rank's nonzeros (ops/sparse.mttkrp:
    K7 for float32 under use_kernels), then one all_reduce."""
    return all_reduce([sp.mttkrp(st, list(Ws), mode)], mesh)[0]


def sharded_sparse_pp_caches(st, Ws: Sequence, mesh):
    """PP caches of this rank's nonzeros (ops/sparse.build_pp_caches: K7
    for float32 under use_kernels), all summed by one all_reduce:
    Build_mttkrp_map on a distributed sparse CTF tensor
    (als_CP.cxx:352-409)."""
    return _reduced_caches(*sp.build_pp_caches(st, list(Ws)), mesh)


def sharded_sparse_ttmc(st, Ws: Sequence, skip_mode: int, mesh):
    """Sparse-first TTMc of this rank's nonzeros (ops/sparse.ttmc, linear
    in the values), then one all_reduce: the Tucker analogue of
    :func:`sharded_sparse_mttkrp`."""
    return all_reduce([sp.ttmc(st, list(Ws), skip_mode=skip_mode)],
                      mesh)[0]


def sharded_sparse_ttmc_caches(st, Ws: Sequence, mesh):
    """Tucker PP caches of this rank's nonzeros
    (ops/sparse.build_ttmc_caches), all summed by one all_reduce
    (Build_ttmc_map on a distributed sparse tensor,
    als_Tucker.cxx:426-466)."""
    return _reduced_caches(*sp.build_ttmc_caches(st, list(Ws)), mesh)


def sharded_sparse_gradnorm(st, Ws: Sequence, mesh, regul=None):
    """Exact CP gradnorm over the sharded nonzeros: every mode's partial
    MTTKRP, one all_reduce for all of them, then the gradient assembly
    on the replicated factors."""
    Ms = all_reduce([sp.mttkrp(st, list(Ws), i) for i in range(st.ndim)],
                    mesh)
    total = 0.0
    for i, M in enumerate(Ms):
        S = contract.hadamard_gram(list(Ws), skip_mode=i, regul=regul)
        g = contract.gradsubprob(M, S, Ws[i])
        total = total + torch.sum(g * g)
    return torch.sqrt(total)

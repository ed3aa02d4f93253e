"""The collectives and reduction hooks of the parallel layer: a leaf
module (torch.distributed, tracing and nothing of the ops layer), so that
ops/contract.py, ops/dimtree.py and ops/solve.py import it at their top
while parallel/mesh.py, which imports ops/contract.py, re-exports it.

Every hook takes a dense layout (parallel/mesh.ShardedLayout: its
``mesh``, ``mode_axis``, ``padded_shape`` and ``span``) or None, and is
the identity for None: the unsharded path runs no collective. Only
``all_reduce`` and ``broadcast`` are used (parallel/mesh.py says why).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from pairwise_perturbation_tpu_torch.utils import tracing

if TYPE_CHECKING:
    from pairwise_perturbation_tpu_torch.parallel.mesh import \
        ShardedLayout

def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object with its
    ``mesh_dim_names`` and ``shape`` (the layout planner reads no more,
    so it runs without a process group)."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))


def _coordinate(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return int(mesh.get_coordinate()[list(mesh.mesh_dim_names).index(axis)])


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _reduce_buffer(buf, group) -> None:
    """SUM ``buf`` in place over ``group``: the one place an all_reduce of
    this module runs."""
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)


def _flat(tensors: Sequence):
    """One contiguous buffer holding ``tensors`` in turn."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, tensors: Sequence):
    """``flat`` cut back into tensors of the shapes of ``tensors``."""
    return [c.view(t.shape)
            for c, t in zip(flat.split([t.numel() for t in tensors]),
                            tensors)]


def _all_reduce(tensors: Sequence, mesh, axes: Sequence[str]):
    flat = _flat(tensors)
    for axis in axes:
        _reduce_buffer(flat, mesh.get_group(axis))
    return _unflat(flat, tensors)


def all_reduce(tensors: Sequence, mesh, axes: Optional[Sequence[str]] = None):
    """The sums of ``tensors`` over the mesh axes ``axes`` (default: every
    axis), as new tensors, bitwise equal on every rank. The tensors travel
    in one buffer, so each axis costs one collective whatever their
    number (the JAX package's psum of a pytree). Scope
    ``mesh.all_reduce``."""
    axes = tuple(mesh.mesh_dim_names if axes is None else axes)
    return tracing.timed("mesh.all_reduce", _all_reduce, list(tensors),
                         mesh, axes)


def broadcast(tensors: Sequence, mesh):
    """``tensors`` as rank 0 holds them, on every rank (one collective;
    every rank passes tensors of the same shapes and dtypes)."""
    flat = _flat(tensors)
    dist.broadcast(flat, src=0)
    return _unflat(flat, tensors)


def broadcast_scalar(x: float, mesh, device) -> float:
    """Rank 0's value of the host number ``x``, on every rank: a decision
    on a host clock (the time limit) is taken once for all."""
    return float(broadcast([torch.tensor([x], dtype=torch.float64,
                                         device=device)], mesh)[0])


# ---------------------------------------------------------------------------
# Reduction hooks of the dense engines (each the identity for layout=None)
# ---------------------------------------------------------------------------


def reduce_parts(parts: Sequence, layout: Optional[ShardedLayout]):
    """``parts`` is a sequence of (tensor, modes): each tensor a partial
    sum over this rank's blocks of ``modes`` (the modes it contracted or
    summed over). Returns the tensors summed over the axes of the sharded
    modes among them (:func:`is_sharded`; a tensor with none is returned
    as it is). Tensors
    with the same axes and dtype travel in one buffer: one all_reduce per
    axis. Scope ``mesh.all_reduce``."""
    out = [x for x, _ in parts]
    if layout is None:
        return out
    groups: Dict[tuple, list] = {}
    for k, (x, modes) in enumerate(parts):
        axes = tuple(layout.mode_axis[m] for m in layout.mode_axis
                     if m in modes and is_sharded(layout, m))
        if axes:
            groups.setdefault((axes, x.dtype), []).append(k)
    for (axes, _), ks in groups.items():
        for k, y in zip(ks, all_reduce([out[k] for k in ks], layout.mesh,
                                       axes)):
            out[k] = y
    return out


def reduce_modes(tensors: Sequence, layout: Optional[ShardedLayout],
                 keep: Sequence[int] = ()):
    """Rule 1: ``tensors`` contracted V over every mode outside ``keep``
    (an MTTKRP or TTMc leaf, a core with ``keep=()``): summed over the axes
    of the sharded modes outside ``keep``."""
    if layout is None:
        return list(tensors)
    others = [m for m in range(len(layout.padded_shape)) if m not in keep]
    return reduce_parts([(t, others) for t in tensors], layout)


def row_sum(tensors: Sequence, modes: Sequence[int],
            layout: Optional[ShardedLayout]):
    """Rule 2: ``tensors[k]`` summed over the rows of a factor of mode
    ``modes[k]`` (a Gram, a squared norm, an inner product): summed over
    that mode's axis where it is sharded."""
    return reduce_parts([(t, (m,)) for t, m in zip(tensors, modes)], layout)


def is_sharded(layout: Optional[ShardedLayout], mode: int) -> bool:
    """Whether ``mode`` is split over ranks: mapped to an axis of more
    than one rank (over an axis of one, every rank holds it whole, and a
    sum over that axis is the value itself, so no hook reduces it: a
    world of one computes as one process does, bit for bit)."""
    return layout is not None and mode in layout.mode_axis and \
        axis_sizes(layout.mesh)[layout.mode_axis[mode]] > 1


def gather_rows(x, mode: int, layout: Optional[ShardedLayout], dim: int = 0):
    """The whole padded extent of ``mode`` along ``dim`` of ``x``, from
    every rank's block: placed in a zero-filled tensor and summed over the
    mode's axis (exact: x + 0 = x), bitwise equal on the axis's ranks.
    ``x`` itself where the mode is not sharded."""
    if not is_sharded(layout, mode):
        return x
    shape = list(x.shape)
    shape[dim] = layout.padded_shape[mode]
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    lo, hi = layout.span(mode)
    full.narrow(dim, lo, hi - lo).copy_(x)
    return all_reduce([full], layout.mesh, (layout.mode_axis[mode],))[0]


def gather_blocks(x, mode: int, layout: ShardedLayout):
    """(n, *x.shape): every rank's ``x`` along the axis of the sharded
    ``mode`` (n ranks), in coordinate order (zero-filled all_reduce)."""
    axis = layout.mode_axis[mode]
    full = torch.zeros((axis_sizes(layout.mesh)[axis],) + tuple(x.shape),
                       dtype=x.dtype, device=x.device)
    full[_coordinate(layout.mesh, axis)] = x
    return all_reduce([full], layout.mesh, (axis,))[0]


def broadcast_block(x, mode: int, layout: ShardedLayout, c: int):
    """The ``x`` of the rank at coordinate ``c`` along the axis of the
    sharded ``mode`` (with this rank's other coordinates), on every rank
    of that axis: one broadcast over the axis's group. Every rank passes
    a tensor of the same shape and dtype."""
    mesh, axis = layout.mesh, layout.mode_axis[mode]
    coord = [int(v) for v in mesh.get_coordinate()]
    coord[list(mesh.mesh_dim_names).index(axis)] = c
    src = int(mesh.mesh[tuple(coord)])
    x = x.contiguous().clone() if dist.get_rank() == src else \
        torch.empty_like(x, memory_format=torch.contiguous_format)
    tracing.timed("mesh.broadcast", dist.broadcast, x, src,
                  group=mesh.get_group(axis))
    return x


def agreed_dtime(clock, mesh, device) -> float:
    """The clock's dtime, rank 0's under ``mesh`` (broadcast outside the
    timed window), so that every rank takes the time limit's exit at the
    same row; the clock's own outside a mesh (``mesh=None``)."""
    dtime = clock.dtime()
    if mesh is None:
        return dtime
    with clock.exclude():
        return broadcast_scalar(dtime, mesh, device)

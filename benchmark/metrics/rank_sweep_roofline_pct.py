"""Roofline share of an exact DT sweep on rank 0's block of V
(contractions and kernels): the least time the H100 could take for one
sweep's work on the block, times the ``cp.dt_sweep`` calls in the scoped
stretch, over the device-busy time inside their profiler ranges.

The work is counted from the rank's zero-padded block (``r.block_shape``)
as the operation needs it, whatever implements it, as
``exact_sweep_roofline_pct`` counts the whole V on one card: the block
read once, the rank's factors read and written once, and the operations
of the binary dimension tree's contractions at the planned root split,
each node's chain in its cheapest order. The port's sweep reads the
block twice (each of the tree's two top nodes starts with a contraction
of the block), so its own ceiling is about half of the bound. The
all-reduces of the sweep and the rank-sized solves are left out, so the
count is a lower bound and the share cannot pass 100% unless time is
missed."""

import itertools
import math

SCOPES = ("cp.dt_sweep",)


def tree(order, split=None):
    """{(lo, hi): parent} of every non-root node of the binary tree."""
    parent = {}

    def rec(lo, hi, s=None):
        if lo == hi:
            return
        mid = (lo + hi) // 2 if s is None else s
        for child in ((lo, mid), (mid + 1, hi)):
            parent[child] = (lo, hi)
            rec(*child)
    rec(0, order - 1, split)
    return parent


def chain_flops(dims, modes, rank):
    """Least operations to contract ``modes`` of a tensor of ``dims``
    (mode -> size), each against a rank-R factor column (a rank axis is
    added by the first contraction from the block)."""
    best = math.inf
    for perm in itertools.permutations(modes):
        d, total = dict(dims), 0.0
        for m in perm:
            total += 2.0 * math.prod(d.values()) * rank
            del d[m]
        best = min(best, total)
    return best


def counts(r):
    """(operations, bytes) of one exact sweep on the rank's block."""
    shape, R = tuple(r.block_shape), r.rank
    flops = 0.0
    for (lo, hi), (plo, phi) in tree(len(shape), r.split).items():
        dims = {m: shape[m] for m in range(plo, phi + 1)}
        flops += chain_flops(dims, [m for m in dims if not lo <= m <= hi], R)
    nbytes = r.itemsize * (math.prod(shape) + 2 * sum(s * R for s in shape))
    return flops, nbytes


def read(r):
    if r.model != "CP" or not r.block_shape:
        return None
    n, busy_s = r.ranges.get("cp.dt_sweep", (0, 0.0))
    if not n or busy_s <= 0:
        return None
    least, bound = r.peaks.least_time_s(*counts(r))
    r.notes["rank_sweep_roofline_pct"] = bound
    return 100.0 * n * least / busy_s

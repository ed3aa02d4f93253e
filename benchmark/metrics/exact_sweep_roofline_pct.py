"""Roofline share of the cell's exact sweep (contractions and kernels):
the least time the H100 could take for one sweep, times the sweeps in
the profiled stretch, over the device-busy time inside the sweep scope's
profiler ranges.

The sweep's work is counted from the shapes, as the operation needs it,
whatever implements it: V read once, the factors read and written once;
the operations of the binary dimension tree's contractions at the
planned root split (deeper levels at the midpoint, as the port's
``dimtree.binary_parent_map`` and the reference's
Construct_Dimension_Tree build it), each node's chain in its cheapest
order; for Tucker also each mode's Gram on the smaller side of its
unfolding and the core. Rank-sized solves and eigh are left out, so the
count is a lower bound and the share cannot pass 100% unless time is
missed."""

import itertools
import math

SCOPES = ("cp.dt_sweep", "cp.sweep", "tucker.dt_sweep")


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


def chain_flops(dims, modes, new, rank=None):
    """Least operations to contract ``modes`` of a tensor of ``dims``
    (mode -> size), mode m going to size new[m] (Tucker) or, with
    ``rank``, being summed against a rank-R factor column (CP; a rank
    axis is added by the first contraction from V)."""
    best = math.inf
    for perm in itertools.permutations(modes):
        d, total = dict(dims), 0.0
        for m in perm:
            size = math.prod(d.values())
            if rank is None:
                total += 2.0 * size * new[m]
                d[m] = new[m]
            else:
                total += 2.0 * size * rank
                del d[m]
        best = min(best, total)
    return best


def cp_counts(shape, R, split, itemsize):
    order = len(shape)
    flops = 0.0
    for (lo, hi), (plo, phi) in tree(order, split).items():
        dims = {m: shape[m] for m in range(plo, phi + 1)}
        gone = [m for m in dims if not lo <= m <= hi]
        flops += chain_flops(dims, gone, None, rank=R)
    nbytes = itemsize * (math.prod(shape) + 2 * sum(s * R for s in shape))
    return flops, nbytes


def tucker_counts(shape, ranks, itemsize):
    order = len(shape)
    flops = 0.0
    for (lo, hi), (plo, phi) in tree(order).items():
        dims = {m: (shape[m] if plo <= m <= phi else ranks[m])
                for m in range(order)}
        gone = [m for m in range(plo, phi + 1) if not lo <= m <= hi]
        flops += chain_flops(dims, gone, ranks)
    for n in range(order):
        s, r = shape[n], ranks[n]
        m = math.prod(ranks) // r
        flops += 2.0 * s * m * m + 2.0 * s * m * r if r <= m < s \
            else 2.0 * s * s * m
    flops += 2.0 * shape[-1] * ranks[-1] * (math.prod(ranks) // ranks[-1])
    nbytes = itemsize * (math.prod(shape) + 2 * sum(
        s * r for s, r in zip(shape, ranks)) + math.prod(ranks))
    return flops, nbytes


def counts(r):
    """(operations, bytes) of one exact sweep of the cell."""
    if r.model == "CP":
        return cp_counts(r.shape, r.rank, r.split, r.itemsize)
    return tucker_counts(r.shape, r.ranks, r.itemsize)


def read(r):
    for name in SCOPES:
        n, busy_s = r.ranges.get(name, (0, 0.0))
        if n and busy_s > 0:
            least, bound = r.peaks.least_time_s(*counts(r))
            r.notes["exact_sweep_roofline_pct"] = bound
            return 100.0 * n * least / busy_s
    return None

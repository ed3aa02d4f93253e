"""Roofline share of the PP cache build (contractions and kernels): the
least time the H100 could take for one build, times the builds in the
profiled stretch, over the device-busy time inside the
``cp.pp_cache_build`` / ``tucker.pp_cache_build`` profiler ranges.

Counted from the shapes, as the operation needs it: V read once, the
caches written once (every pair (i, j): V contracted with all factors but
modes i and j, and every single mode; CP keeps a rank axis, Tucker
contracted modes at their ranks), the factors read once. Operations:
three first-level contractions of V, the fewest that root every pair
(a root that drops mode k serves the pairs without k, and no pair
contains three modes), each dropping one of the three cheapest modes;
deeper contractions are left out, so the count is a lower bound."""

import math

SCOPES = ("cp.pp_cache_build", "tucker.pp_cache_build")


def cp_counts(shape, R, itemsize):
    order = len(shape)
    size = math.prod(shape)
    flops = 3 * 2.0 * size * R
    pairs = sum(shape[i] * shape[j] * R for i in range(order)
                for j in range(i + 1, order))
    singles = sum(s * R for s in shape)
    nbytes = itemsize * (size + pairs + 2 * singles)
    return flops, nbytes


def tucker_counts(shape, ranks, itemsize):
    order = len(shape)
    size = math.prod(shape)
    flops = 2.0 * size * sum(sorted(ranks)[:3])
    rest = math.prod(ranks)
    pairs = sum(shape[i] * shape[j] * rest // (ranks[i] * ranks[j])
                for i in range(order) for j in range(i + 1, order))
    singles = sum(s * rest // r for s, r in zip(shape, ranks))
    factors = sum(s * r for s, r in zip(shape, ranks))
    nbytes = itemsize * (size + pairs + singles + factors)
    return flops, nbytes


def counts(r):
    """(operations, bytes) of one PP cache build of the cell."""
    if r.model == "CP":
        return cp_counts(r.shape, r.rank, r.itemsize)
    return tucker_counts(r.shape, r.ranks, r.itemsize)


def read(r):
    for name in SCOPES:
        n, busy_s = r.ranges.get(name, (0, 0.0))
        if n and busy_s > 0:
            least, bound = r.peaks.least_time_s(*counts(r))
            r.notes["pp_build_roofline_pct"] = bound
            return 100.0 * n * least / busy_s
    return None

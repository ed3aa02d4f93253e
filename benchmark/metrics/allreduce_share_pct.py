"""Share of the fits' device time inside the collectives (collectives):
device-busy seconds inside the profiler ranges of the ``mesh.all_reduce``
span over those inside ``cp.fit``'s, rank 0's, from the scoped stretch.
An NCCL all-reduce kernel runs from the moment its rank reaches the
collective until every rank has, so the share holds the card's wait for
the slowest rank as well as the transfer. The factors' gather after each
fit (a few all-reduces of factor rows) lies outside ``cp.fit`` and counts
here too. A run on one card has no such range and reads nothing."""

SCOPES = ("cp.fit", "mesh.all_reduce")


def read(r):
    n, collectives = r.ranges.get("mesh.all_reduce", (0, 0.0))
    _, fits = r.ranges.get("cp.fit", (0, 0.0))
    if not n or fits <= 0:
        return None
    return 100.0 * collectives / fits

"""Share of the fits' seconds in eigh and svd (contractions and
kernels): the ``solve.eigh`` span (each eigh or svd of ops/solve.py
outside the warm-ups, HOSVD's included) over the ``cp.fit`` /
``tucker.fit`` spans, both from the scoped stretch on. ``solve.eigh``
is nested in the sweeps and adds no sync to them: a sample is the
card's time from reaching the factorization to the host's return from
it (two CUDA events), so it holds the factorization and its own wait,
not the work queued before it."""

FITS = ("cp.fit", "tucker.fit")
PARTS = ("solve.eigh",)


def read(r):
    total = sum(r.stats[n][1] for n in FITS if n in r.stats)
    if total <= 0 or not any(n in r.stats for n in PARTS):
        return None
    return 100.0 * sum(r.stats[n][1] for n in PARTS if n in r.stats) / total

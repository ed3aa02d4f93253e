"""Share of the fits' seconds in their warm-ups (engine): the ``warmup``
span (each ``cp.warm_run``: a sweep function once on the fit's own
inputs, then a device sync) over the ``cp.fit`` / ``tucker.fit`` spans,
both from the scoped stretch on."""

FITS = ("cp.fit", "tucker.fit")
PARTS = ("warmup",)


def read(r):
    total = sum(r.stats[n][1] for n in FITS if n in r.stats)
    if total <= 0 or not any(n in r.stats for n in PARTS):
        return None
    return 100.0 * sum(r.stats[n][1] for n in PARTS if n in r.stats) / total

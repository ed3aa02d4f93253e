"""Share of the fits' seconds in their diagnostics rows (engine): the
``cp.diagnostics`` / ``tucker.diagnostics`` spans (each logged row's
exact gradnorm or core norm, and diffV) over the ``cp.fit`` /
``tucker.fit`` spans, both from the scoped stretch on."""

FITS = ("cp.fit", "tucker.fit")
PARTS = ("cp.diagnostics", "tucker.diagnostics")


def read(r):
    total = sum(r.stats[n][1] for n in FITS if n in r.stats)
    if total <= 0 or not any(n in r.stats for n in PARTS):
        return None
    return 100.0 * sum(r.stats[n][1] for n in PARTS if n in r.stats) / total

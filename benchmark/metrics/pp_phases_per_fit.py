"""PP phases per fit (engine): the port's ``cp.pp_phase`` /
``tucker.pp_phase`` counters (a PP phase that took its caches, built or
the warm-up's) over the calls of the ``cp.fit`` / ``tucker.fit`` spans.
Each phase costs a cache build, and its restart a return to exact
sweeps."""

PHASES = ("cp.pp_phase", "tucker.pp_phase")
FITS = ("cp.fit", "tucker.fit")


def read(r):
    fits = sum(r.stats[n][0] for n in FITS if n in r.stats)
    if not fits:
        return None
    return sum(r.stats[n][0] for n in PHASES if n in r.stats) / fits

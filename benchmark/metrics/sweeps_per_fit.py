"""Sweeps per fit (engine layer): the mean of each fit's ``iters`` over
the traced window's fits. Moves ``fit_s``: a fit's time is its sweeps
times their cost."""


def read(r):
    if not r.fits:
        return None
    return sum(f.iters for f in r.fits) / len(r.fits)

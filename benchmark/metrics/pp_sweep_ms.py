"""Median milliseconds of a PP sweep (engine steps): the ``cp.pp_sweep``
or ``tucker.pp_sweep`` scope, each call ended by a device sync."""

import statistics

SCOPES = ("cp.pp_sweep", "tucker.pp_sweep")


def read(r):
    for name in SCOPES:
        if r.samples.get(name):
            return 1e3 * statistics.median(r.samples[name])
    return None

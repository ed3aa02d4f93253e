"""Median milliseconds of the cell's exact sweep (engine steps): the
``cp.dt_sweep`` scope of the CP-PP engine, ``cp.sweep`` of DT-ALS
(``als_cp_dt``), ``tucker.dt_sweep`` of both Tucker engines. Each call
ends in a device sync, so a sample is the sweep's whole time."""

import statistics

SCOPES = ("cp.dt_sweep", "cp.sweep", "tucker.dt_sweep")


def read(r):
    for name in SCOPES:
        if r.samples.get(name):
            return 1e3 * statistics.median(r.samples[name])
    return None

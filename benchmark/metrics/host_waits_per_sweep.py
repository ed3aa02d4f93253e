"""Host waits per sweep (engine steps): the port's counters of the times
the host waits for the card, ``wait.solve`` (an eigh or svd of
ops/solve.py), ``wait.pull`` (a device-to-host read of a host engine)
and ``wait.sync`` (an explicit device sync), over the calls of every
sweep scope. A warm-up's waits count and its sweeps do not, as the fit
pays for the one and the scopes leave out the other. Counted from the
scoped stretch on; a program without the counters reads nothing."""

WAITS = ("wait.solve", "wait.pull", "wait.sync")
SWEEPS = ("cp.dt_sweep", "cp.sweep", "cp.pp_sweep", "cp.pp_partupdate_sweep",
          "tucker.dt_sweep", "tucker.hooi_sweep", "tucker.pp_sweep")


def read(r):
    sweeps = sum(r.stats[n][0] for n in SWEEPS if n in r.stats)
    if not sweeps or not any(n in r.stats for n in WAITS):
        return None
    return sum(r.stats[n][0] for n in WAITS if n in r.stats) / sweeps

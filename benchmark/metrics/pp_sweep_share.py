"""Share of the sweeps that are PP sweeps (engine layer): calls of the
``cp.pp_sweep`` / ``tucker.pp_sweep`` scopes over the calls of every
sweep scope, from the port's tracing scopes."""

EXACT = ("cp.dt_sweep", "cp.sweep", "tucker.dt_sweep")
PP = ("cp.pp_sweep", "tucker.pp_sweep")


def read(r):
    pp = sum(r.stats[n][0] for n in PP if n in r.stats)
    exact = sum(r.stats[n][0] for n in EXACT if n in r.stats)
    if pp + exact == 0:
        return None
    return 100.0 * pp / (pp + exact)

"""MiB that rank 0's all-reduces carry per sweep (collectives): the
port's ``mesh.all_reduce_bytes`` counter (each all-reduce's buffer) over
the calls of every sweep scope, from the scoped stretch on. It holds the
sweeps' own reductions and those of the diagnostics rows, the restart
checks, the PP cache builds and the factors' gather after each fit; a
warm-up's bytes count and its sweeps do not, as the fit pays for the
one. A program without the counter reads nothing."""

BYTES = "mesh.all_reduce_bytes"
SWEEPS = ("cp.dt_sweep", "cp.sweep", "cp.pp_sweep", "cp.pp_partupdate_sweep",
          "tucker.dt_sweep", "tucker.hooi_sweep", "tucker.pp_sweep")


def read(r):
    sweeps = sum(r.stats[n][0] for n in SWEEPS if n in r.stats)
    if not sweeps or BYTES not in r.stats:
        return None
    return r.stats[BYTES][0] / 2 ** 20 / sweeps

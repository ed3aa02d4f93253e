"""Share of the traced stretch (tracing scopes off, so no added syncs)
in which no kernel or copy ran on the card: one minus the union of the
device intervals over the stretch's wall time."""


def read(r):
    if r.busy_s is None or r.busy_s <= 0 or not r.window_s:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)

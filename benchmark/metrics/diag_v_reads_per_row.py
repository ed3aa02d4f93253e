"""First-level reads of V a CP diagnostics row makes (engine): the port's
``cp.diag_v_reads`` counter (the first-level reads of V that its
contractions counted while a row ran: 2 where its N exact MTTKRPs come
from one dimension tree, N where an order-3 float32 V takes a fused
kernel a mode) over the calls of the ``cp.diagnostics`` span. Counted
from the scoped stretch on; a program without the counter reads
nothing."""

READS = "cp.diag_v_reads"
ROWS = "cp.diagnostics"


def read(r):
    rows = r.stats[ROWS][0] if ROWS in r.stats else 0
    if not rows or READS not in r.stats:
        return None
    return r.stats[READS][0] / rows

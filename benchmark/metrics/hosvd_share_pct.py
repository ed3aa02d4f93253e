"""Share of the Tucker fits' seconds in their HOSVD (engine): the
``tucker.hosvd`` span over the ``tucker.fit`` spans, both from the scoped
stretch on."""

FITS = ("tucker.fit",)
PARTS = ("tucker.hosvd",)


def read(r):
    total = sum(r.stats[n][1] for n in FITS if n in r.stats)
    if total <= 0 or not any(n in r.stats for n in PARTS):
        return None
    return 100.0 * sum(r.stats[n][1] for n in PARTS if n in r.stats) / total

"""Peak device memory of the window in GiB: ``torch.cuda.
max_memory_allocated()`` after ``reset_peak_memory_stats()`` at the
window's start."""


def read(r):
    if not r.peak_bytes:
        return None
    return r.peak_bytes / 2 ** 30

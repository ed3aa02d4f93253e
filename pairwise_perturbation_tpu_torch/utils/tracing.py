"""Named host-side timer scopes and device traces — port of the JAX
package's ``utils/tracing.py`` (``timer``, ``timed``, ``report``,
``device_trace``, ``annotate``), which replaces CTF's ``Timer`` /
``Timer_epoch`` scopes (common.cxx:136-137).

Usage:

    with timer("SVD_solve"):
        ...
    print(report())

    with device_trace("traces/"):     # torch.profiler, Chrome-trace JSON
        with annotate("sweep"):       # a named range in that trace
            run_sweep()
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch

_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_samples: Dict[str, List[float]] = defaultdict(list)
_enabled: bool = False


def enable(on: bool = True) -> None:
    """Turn profiling scopes on (the CLI's ``-profile 1``)."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """No scope records inside (the engines' warm-ups, which are no
    phase of the run)."""
    global _enabled
    was, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = was


@contextlib.contextmanager
def timer(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _times[name] += time.perf_counter() - t0
        _counts[name] += 1


def timed(name: str, fn, *args, **kwargs):
    """Call ``fn`` under a named timer scope when profiling is enabled.

    CUDA launches return before the card finishes, so the scope ends
    with ``torch.cuda.synchronize()``: profile mode trades a per-call sync
    for true per-phase wall times. When disabled this is a plain call."""
    if not _enabled:
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    _times[name] += dt
    _counts[name] += 1
    _samples[name].append(dt)
    return out


def report() -> str:
    """CTF-style dump of accumulated timer scopes."""
    lines = ["%-30s %10s %10s" % ("timer", "calls", "seconds")]
    for name in sorted(_times, key=lambda n: -_times[n]):
        lines.append("%-30s %10d %10.4f" % (name, _counts[name], _times[name]))
    return "\n".join(lines)


def stats() -> Dict[str, tuple]:
    """{name: (calls, total seconds, median seconds per call)}; the median
    covers the ``timed`` calls, NaN for scopes entered only by ``timer``."""
    return {n: (_counts[n], _times[n],
                statistics.median(_samples[n]) if _samples[n]
                else float("nan"))
            for n in _times}


def samples(name: str) -> List[float]:
    """The seconds of each ``timed`` call of scope ``name``, in call
    order."""
    return list(_samples.get(name, ()))


def reset() -> None:
    _times.clear()
    _counts.clear()
    _samples.clear()


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[str]:
    """``torch.profiler`` over the region: host activity, and the card's
    kernels and copies when a card is present. On exit the trace is
    written to ``logdir`` (made if missing) as Chrome-trace JSON,
    ``trace.<pid>.<ms>.json``, which chrome://tracing and Perfetto open.
    Yields the file's path."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"trace.{os.getpid()}.{int(time.time() * 1e3)}.json")
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range in :func:`device_trace`'s trace and, on a card, an
    NVTX range."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()

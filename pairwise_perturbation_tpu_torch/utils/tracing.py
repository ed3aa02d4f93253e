"""Named host-side spans, counters and device traces — port of the JAX
package's ``utils/tracing.py`` (``timed``, ``report``, ``device_trace``,
``annotate``), which replaces CTF's ``Timer`` / ``Timer_epoch`` scopes
(common.cxx:136-137).

A span is a call through :func:`timed`, or of a function under
:func:`span`. What it records depends on the state:

- scopes on (:func:`enable`, the CLI's ``-profile 1``): the call ends in
  a device sync and its wall seconds are a sample of the span's name;
- scopes off while a ``torch.profiler`` records: the call runs inside a
  ``record_function`` range of the span's name, with no sync and no
  sample, so each engine step is a host range on the profiler's clock,
  the clock that timestamps the card's kernels in the same trace;
- neither: a plain call.

A span that runs inside another (an eigh of a sweep) is a call through
:func:`nested`: the same, except that with the scopes on it adds no
sync. Its sample is the call's time on the device's own clock, from a
pair of CUDA events around it, read when the spans are read; so the
enclosing span's sample holds the same syncs with it as without it.

Inside :func:`paused` (the engines' warm-ups) a span records nothing and
opens no range.

A counter (:func:`count`) adds to an integer: always on, with the scopes
on or off and inside :func:`paused`; it holds no tensor and never
synchronizes. The engines count the host's waits (``wait.solve``: an
eigh or svd of ops/solve.py; ``wait.pull``: a device-to-host read of a
host engine; ``wait.sync``: an explicit device sync) and their PP phases
(``cp.pp_phase``, ``tucker.pp_phase``); ops/contract.py counts each
first-level contraction of V over a non-minor mode by what served it
(``contract.first_kernel``: the mid_contract kernel;
``contract.first_einsum``: torch.einsum), each first-level read of V
whatever served it (``contract.v_reads``; models/cp.py counts a
diagnostics row's share of them as ``cp.diag_v_reads``) and each later
chain step of a rank-carrying intermediate (``contract.step_kernel``:
the chain_step kernel; ``contract.step_einsum``: torch.einsum);
parallel/collectives.py
counts its all_reduces, their bytes and its broadcasts
(``mesh.all_reduce_count``, ``mesh.all_reduce_bytes``,
``mesh.broadcast_count``). :func:`stats` and :func:`report`
list spans and counters; :func:`reset` clears both.

Usage:

    enable()
    W = timed("solve", fn, M, S)
    count("wait.pull")
    print(report())

    with device_trace("traces/"):     # torch.profiler, Chrome-trace JSON
        with annotate("sweep"):       # a named range in that trace
            run_sweep()
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import torch
from torch.autograd import profiler as _profiler

_times: Dict[str, float] = defaultdict(float)
_counts: Dict[str, int] = defaultdict(int)
_samples: Dict[str, List[float]] = defaultdict(list)
# (name, start event, end event) of the nested spans not yet read
_pending: List[tuple] = []
_PENDING_MAX = 4096
_enabled: bool = False
_paused: bool = False


def enable(on: bool = True) -> None:
    """Turn profiling scopes on (the CLI's ``-profile 1``)."""
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """No span records or opens a range inside (the engines' warm-ups,
    which are no phase of the run); counters still count."""
    global _enabled, _paused
    was = _enabled, _paused
    _enabled, _paused = False, True
    try:
        yield
    finally:
        _enabled, _paused = was


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counted(name: str) -> int:
    """The counter ``name`` as it stands (0 if never counted); no sync."""
    return _counts.get(name, 0)


def timed(name: str, fn, *args, **kwargs):
    """Call ``fn`` as the span ``name``.

    Scopes on: CUDA launches return before the card finishes, so the
    span ends with ``torch.cuda.synchronize()``: profile mode trades a
    per-call sync for true per-phase wall times. Scopes off under a
    ``torch.profiler`` recording: a ``record_function`` range of the
    name. Otherwise, and inside :func:`paused`, a plain call."""
    if _enabled:
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        _record(name, time.perf_counter() - t0)
        return out
    if not _profiler._is_profiler_enabled or _paused:
        return fn(*args, **kwargs)
    with torch.profiler.record_function(name):
        return fn(*args, **kwargs)


def nested(name: str, fn, *args, **kwargs):
    """Call ``fn`` as the span ``name`` inside another span's call.

    As :func:`timed`, except with the scopes on: no sync. Where the first
    argument is a CUDA tensor the sample is the device's time from
    reaching the call to the host's return from it, by a pair of CUDA
    events read when the spans are read, so the queued work before the
    call is not in it; otherwise it is the call's wall time. The call is
    not made through :func:`timed`, so a wrapper installed over
    :func:`timed` does not see it."""
    if _enabled:
        if not getattr(args[0] if args else None, "is_cuda", False):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _record(name, time.perf_counter() - t0)
            return out
        stream = torch.cuda.current_stream(args[0].device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(*args, **kwargs)
        end.record(stream)
        _counts[name] += 1
        _pending.append((name, start, end))
        if len(_pending) > _PENDING_MAX:
            _settle()
        return out
    if not _profiler._is_profiler_enabled or _paused:
        return fn(*args, **kwargs)
    with torch.profiler.record_function(name):
        return fn(*args, **kwargs)


def _record(name: str, seconds: float) -> None:
    _times[name] += seconds
    _counts[name] += 1
    _samples[name].append(seconds)


def _settle() -> None:
    """Read the nested spans' event pairs into their samples."""
    for name, start, end in _pending:
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
        _times[name] += seconds
        _samples[name].append(seconds)
    _pending.clear()


def span(name: str):
    """Decorator: each call of the function is the span ``name``, through
    the module's :func:`timed` as it stands at the call."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            return timed(name, fn, *args, **kwargs)
        return call
    return wrap


def report() -> str:
    """CTF-style dump of the accumulated spans, then the counters."""
    _settle()
    lines = ["%-30s %10s %10s" % ("timer", "calls", "seconds")]
    for name in sorted(_times, key=lambda n: -_times[n]):
        lines.append("%-30s %10d %10.4f" % (name, _counts[name], _times[name]))
    counters = sorted(n for n in _counts if n not in _times)
    if counters:
        lines.append("%-30s %10s" % ("counter", "count"))
        lines += ["%-30s %10d" % (n, _counts[n]) for n in counters]
    return "\n".join(lines)


def stats() -> Dict[str, tuple]:
    """{name: (calls, total seconds, median seconds per call)} of each
    span that recorded; a counter is (count, 0.0, NaN)."""
    _settle()
    return {n: (_counts[n], _times.get(n, 0.0),
                statistics.median(_samples[n]) if _samples.get(n)
                else float("nan"))
            for n in _counts}


def samples(name: str) -> List[float]:
    """The seconds of each ``timed`` call of scope ``name``, in call
    order."""
    _settle()
    return list(_samples.get(name, ()))


def reset() -> None:
    _pending.clear()
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

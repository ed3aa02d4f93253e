"""Reduction of a ``torch.profiler`` trace to the numbers the per-layer
readers take: device busy time, busy time inside named host ranges,
kernel totals and idle gaps by what the host was doing.

:func:`busy` is a frozen copy of the port's ``phase_profile.busy_us``
(the length of a union of intervals; benchmark/tests pins the two
equal)."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import torch

# profiler bookkeeping that is no device work (phase_profile's list)
PROFILER_OVERHEAD = ("Activity Buffer Request",)


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(union: List[List[float]], starts: List[float], lo: float,
            hi: float) -> float:
    """Length of ``union`` (disjoint, sorted; ``starts`` its starts)
    inside [lo, hi]."""
    total = 0.0
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    while i < len(union) and union[i][0] < hi:
        s, e = union[i]
        total += max(0.0, min(e, hi) - max(s, lo))
        i += 1
    return total


def profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


class Stretch:
    """One profiled stretch of the window, reduced once it has ended.
    Times are in seconds."""

    def __init__(self, prof, wall_s: float, range_names=()):
        cuda = torch.autograd.DeviceType.CUDA
        dev, host = [], []
        for e in prof.events():
            if e.device_type != cuda:
                host.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name not in PROFILER_OVERHEAD and \
                    not getattr(e, "is_user_annotation", False):
                dev.append((e.time_range.start, e.time_range.end, e.name))
        # a host range (record_function) is mirrored on the device's
        # timeline from its first kernel to its last: no device work
        host_names = {n for _, _, n in host}
        dev = [d for d in dev if d[2] not in host_names]
        self.wall_s = wall_s
        self.union = merged((s, e) for s, e, _ in dev)
        self.starts = [s for s, _ in self.union]
        self.busy_s = busy((s, e) for s, e, _ in dev) / 1e6
        per_kernel: Dict[str, float] = defaultdict(float)
        for s, e, name in dev:
            per_kernel[name] += (e - s) / 1e6
        self.kernels = dict(per_kernel)
        # device busy seconds inside each named host range, and its count
        self.ranges: Dict[str, Tuple[int, float]] = {}
        for name in range_names:
            spans = [(s, e) for s, e, n in host if n == name]
            if spans:
                self.ranges[name] = (len(spans), sum(
                    overlap(self.union, self.starts, s, e)
                    for s, e in spans) / 1e6)
        self._host = host

    def idle_gaps(self, min_us: float = 5.0) -> Dict[str, float]:
        """Seconds of device idle between the stretch's first and last
        device activity, summed by the innermost host operation running
        at each gap's middle ("python" where none is)."""
        gaps = [(end + (start - end) / 2, start - end)
                for (_, end), (start, _) in zip(self.union, self.union[1:])
                if start - end >= min_us]
        host = sorted(self._host, key=lambda h: (h[0], -h[1]))
        out: Dict[str, float] = defaultdict(float)
        stack: List[Tuple[float, float, str]] = []
        i = 0
        for mid, length in sorted(gaps):
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] <= host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            out[stack[-1][2] if stack else "python"] += length / 1e6
        return dict(out)


def top(d: Dict[str, float], n: int = 10, chars: int = 0) -> List[list]:
    """The ``n`` largest entries, names cut to ``chars`` (0: whole)."""
    return [[k[:chars] if chars else k, v]
            for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]

"""The device trace of a window: torch.profiler's device intervals on the
host's clock, their union, and the breakdown of the result line.

The union replaces ``chip_smoke.py`` ``busy_share``'s sum of event
times, which counts twice the time in which two streams overlap.
"""
from __future__ import annotations

import time
from collections import defaultdict


def kind_of(name: str) -> str:
    """The kind of a device event by its name: a copy by direction, a
    fill, or a kernel."""
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return "htod"
        if "DtoH" in name:
            return "dtoh"
        return "dtod"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union(intervals, lo: float = float("-inf"), hi: float = float("inf")):
    """The merged intervals of [(t0, t1), ...] clipped to [lo, hi]."""
    out = []
    for t0, t1 in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if t1 <= t0:
            continue
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1][1] = t1
        else:
            out.append([t0, t1])
    return out


def union_seconds(intervals, lo: float = float("-inf"),
                  hi: float = float("inf")) -> float:
    return sum(b - a for a, b in union(intervals, lo, hi))


def gaps(merged, lo: float, hi: float):
    """The idle gaps [(t0, t1), ...] of merged intervals within [lo, hi]."""
    out = []
    t = lo
    for a, b in merged:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


class DeviceTrace:
    """Device events of one traced window on the host's perf_counter clock:
    ``events`` [(name, kind, t0, t1)], the window [lo, hi]."""

    def __init__(self, events, lo: float, hi: float):
        self.events = events
        self.lo, self.hi = lo, hi

    def intervals(self, kinds=None):
        return [(t0, t1) for (_n, k, t0, t1) in self.events
                if kinds is None or k in kinds]

    def busy_s(self, kinds=None) -> float:
        return union_seconds(self.intervals(kinds), self.lo, self.hi)

    def seconds(self, kind: str) -> float:
        """The summed time of the events of one kind inside the window."""
        return sum(min(t1, self.hi) - max(t0, self.lo)
                   for (_n, k, t0, t1) in self.events
                   if k == kind and t1 > self.lo and t0 < self.hi)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def breakdown(self, spans, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host spans that cover their middle."""
        by = defaultdict(float)
        for name, _k, t0, t1 in self.events:
            by[name[:80]] += max(0.0, min(t1, self.hi) - max(t0, self.lo))
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        idle = []
        for a, b in gaps(union(self.intervals(), self.lo, self.hi),
                         self.lo, self.hi):
            mid = (a + b) / 2
            names = sorted({s[0] for s in spans if s[1] <= mid <= s[2]})
            idle.append(("+".join(names) or "no span", b - a))
        idle.sort(key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle[:n]]}


class Profiler:
    """torch.profiler over a window, with its device events mapped onto
    the host's perf_counter clock by a marker fill launched on an idle
    card at a known host time. It records the device's activity alone:
    recording every host operator of the program's threads would slow
    the host, whose spans the per-layer metrics read in the same run."""

    def __init__(self, torch):
        self.torch = torch
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(activities=[act.CUDA])
        self.mark = None

    def start(self) -> None:
        torch = self.torch
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark = time.perf_counter()
        torch.empty(1 << 20, dtype=torch.int32, device="cuda").fill_(7)
        torch.cuda.synchronize()

    def stop(self, lo: float, hi: float) -> DeviceTrace:
        torch = self.torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        dev = [e for e in self.prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if not dev:
            return DeviceTrace([], lo, hi)
        first = min(dev, key=lambda e: e.time_range.start)
        offset = first.time_range.start * 1e-6 - self.mark
        events = [(e.name, kind_of(e.name),
                   e.time_range.start * 1e-6 - offset,
                   e.time_range.end * 1e-6 - offset) for e in dev
                  if e is not first]
        return DeviceTrace(events, lo, hi)

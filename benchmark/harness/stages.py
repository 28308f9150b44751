"""The program's own stage spans and counters (``uvg266_tpu_torch.trace``)
read over a window of a benchmark cell, and the device's idle time of a
traced window put down to the stages open during it.

The benchmark's own runs (``benchmark/run.py``) leave the program's tracer
off and read none of this. ``benchmark/stage_trace.py`` switches it on
around a cell's window with ``traced_windows()``, which leaves the records
as ``run.program``; ``program_metrics(run)``, ``idle_by_stage`` and
``report(run)`` then read them. A program without the tracer (an older
checkout) leaves ``run.program`` None, and every reader here then returns
None.
"""
from __future__ import annotations

import statistics
import threading

from . import entries
from .trace import gaps, union, union_seconds


def program_tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from uvg266_tpu_torch import trace
    except ImportError:
        return None
    return trace


def traced_windows(tracer) -> list:
    """Wrap the window of every entry loop of ``entries.ENTRIES`` in the
    program's tracer: on from the window's first call (after
    ``run.t_start``) until its frames are done, its records then left on
    the run as ``run.program``. Returns the list each traced run is added
    to; ``untraced()`` puts the entry loops back."""
    runs: list = []
    for name, cls in list(entries.ENTRIES.items()):
        def window(self, run, _window=cls.window):
            tracer.start()
            try:
                _window(self, run)
            finally:
                run.program = tracer.stop()
                runs.append(run)
        entries.ENTRIES[name] = type(cls.__name__, (cls,),
                                     {"window": window, "_untraced": cls})
    return runs


def untraced() -> None:
    """Undo ``traced_windows``."""
    for name, cls in list(entries.ENTRIES.items()):
        entries.ENTRIES[name] = getattr(cls, "_untraced", cls)


def _seconds(spans):
    return [(s.t0 * 1e-9, s.t1 * 1e-9) for s in spans]


def _overlap(a, b) -> float:
    """The seconds two merged, sorted interval lists share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _idle(dtrace):
    lo, hi = dtrace.lo, dtrace.hi
    return gaps(union(dtrace.intervals(), lo, hi), lo, hi)


def idle_by_stage(dtrace, program) -> dict:
    """{span name: seconds of the window's device idle time during which
    a span of that name was open on some thread, "none": idle seconds
    with no span open}."""
    lo, hi = dtrace.lo, dtrace.hi
    idle = _idle(dtrace)
    out = {}
    for name in sorted({s.name for s in program.spans}):
        out[name] = _overlap(idle, union(
            _seconds(s for s in program.spans if s.name == name), lo, hi))
    total = sum(b - a for a, b in idle)
    out["none"] = total - _overlap(idle, union(_seconds(program.spans),
                                               lo, hi))
    return out


def window_frames(run):
    """The frames the window started, or None where nothing can be read."""
    if getattr(run, "program", None) is None or not run.in_window:
        return None
    return run.in_window


def span_ms_per_frame(run, names):
    """The wall ms of the spans named ``names`` (a tuple of names, or a
    prefix ending in '.'), of the window's frames, per frame."""
    frames = window_frames(run)
    if frames is None:
        return None

    def named(n):
        return n in names if isinstance(names, tuple) else \
            n.startswith(names)
    ns = sum(s.t1 - s.t0 for s in run.program.spans
             if s.frame in frames and named(s.name))
    return ns * 1e-6 / len(frames)


def counter_per_frame(run, name):
    """Counter ``name``'s total over the window's frames, per frame."""
    frames = window_frames(run)
    if frames is None:
        return None
    return sum(v[1] for (f, n), v in run.program.counters.items()
               if n == name and f in frames) / len(frames)


def host_wait_share(run):
    """Over the self times (a span's time less its children's) of the
    window's frames' spans but the waits on another worker: wall less
    thread CPU time, over wall. The definition is the program's own
    (``trace.offcpu``), the one its CLI's ``offcpu_ms`` reads."""
    frames = window_frames(run)
    tracer = program_tracer()
    if frames is None or tracer is None:
        return None
    off, wall = tracer.offcpu([s for s in run.program.spans
                               if s.frame in frames])
    return off / wall if wall > 0 else None


def idle_attributed(run):
    """The share of the traced window's device idle time that some program
    span covers."""
    tr = run.trace
    if getattr(run, "program", None) is None or tr is None:
        return None
    idle = _idle(tr)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    return _overlap(idle, union(_seconds(run.program.spans), tr.lo,
                                tr.hi)) / total


def program_metrics(run) -> dict:
    """{name: value}: the program's stage readings of the window, per
    frame the window started; a reading that finds nothing is left out.
    The names are those PERF.md's list of layers gives them."""
    rdoq = counter_per_frame(run, "rdoq")
    to_device = counter_per_frame(run, "to_device_bytes")
    out = {
        "search_wait_ms": span_ms_per_frame(run, ("search.wait",)),
        "partition_dp_ms": span_ms_per_frame(run, ("partition.dp",)),
        "finalize_ms": span_ms_per_frame(run, ("finalize",)),
        "loop_filter_ms": span_ms_per_frame(run, "filter."),
        "entropy_ms": span_ms_per_frame(run, ("entropy",)),
        "host_me_ms": span_ms_per_frame(run, ("me.fullpel", "me.qpel")),
        "rdoq_ms": None if rdoq is None else rdoq * 1e-6,
        "host_wait_share": host_wait_share(run),
        "idle_attributed": idle_attributed(run),
        "to_device_mb": None if to_device is None else to_device * 1e-6,
    }
    return {k: v for k, v in out.items() if v is not None}


def coverage(run, tid=None) -> dict:
    """{call: {"median", "least", "n"}}: over the benchmark's calls of the
    window, the share of each call's time that the program's top-level
    spans cover: those of the frame an ``encode_frame`` call returned, or
    those of the thread ``tid`` (the caller's, by default) that ran
    ``feed`` and ``flush``, taken together as "feed+flush"."""
    tid = threading.get_ident() if tid is None else tid
    done_at = {t: g for g, t in run.done.items()}
    top = [s for s in run.program.spans if s.parent is None]
    by_frame: dict = {}
    for s in top:
        by_frame.setdefault(s.frame, []).append((s.t0 * 1e-9, s.t1 * 1e-9))
    mine = _seconds(s for s in top if s.tid == tid)
    shares: dict = {}
    for name, t0, t1 in run.spans:
        if t1 <= t0:
            continue
        if name == "encode_frame" and t1 in done_at:
            key, iv = name, by_frame.get(done_at[t1], [])
        elif name in ("feed", "flush"):
            key, iv = "feed+flush", mine
        else:
            continue
        shares.setdefault(key, []).append(union_seconds(iv, t0, t1)
                                          / (t1 - t0))
    return {k: {"median": statistics.median(v), "least": min(v),
                "n": len(v)} for k, v in shares.items()}


def report(run) -> dict | None:
    """The window's frames by stage, for the traced result line: per frame
    started, each span name's wall and thread-CPU ms and calls
    (``stages``), each counter's calls and total (``counters``: ns, or
    bytes for a ``*_bytes``), the finalize's paths, the top-level spans'
    thread CPU ms, and ``coverage``."""
    frames = window_frames(run)
    if frames is None:
        return None
    n = len(frames)
    spans = [s for s in run.program.spans if s.frame in frames]
    by: dict = {}
    paths: dict = {}
    for s in spans:
        d = by.setdefault(s.name, [0, 0, 0])
        d[0] += s.t1 - s.t0
        d[1] += s.cpu
        d[2] += 1
        if s.name == "finalize":
            p = s.attrs.get("path")
            paths[p] = paths.get(p, 0) + 1
    counters: dict = {}
    for (f, name), (calls, total) in run.program.counters.items():
        if f in frames:
            c = counters.setdefault(name, [0, 0])
            c[0] += calls
            c[1] += total
    return {"frames": n,
            "stages": {k: {"wall_ms": v[0] * 1e-6 / n,
                           "cpu_ms": v[1] * 1e-6 / n, "calls": v[2] / n}
                       for k, v in sorted(by.items())},
            "top_cpu_ms": sum(s.cpu for s in spans if s.parent is None)
            * 1e-6 / n,
            "counters": {k: {"calls": v[0] / n, "total": v[1] / n}
                         for k, v in sorted(counters.items())},
            "finalize_paths": paths,
            "coverage": coverage(run)}

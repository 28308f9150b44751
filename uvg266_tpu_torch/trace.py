"""Frame-stage spans and counters of the encoder, kept in memory.

Off by default. ``start()`` switches it on and clears what an earlier
run left; ``stop()`` switches it off and returns the ``Records``. With it
off, a site costs one check of ``ENABLED`` and gets the shared no-op
context manager back: no clock read, no allocation, no lock.

A span (``span(name, frame)``) records its name; the frame it belongs to
(``FrameState.num``; a span given none takes its parent's); the thread;
its parent, the span open on the same thread when it opened; ``t0`` and
``t1`` from ``time.perf_counter_ns()`` (the clock the benchmark maps the
device trace onto); the thread's CPU time over it from
``time.thread_time_ns()``; and a few attributes. A span never stays open
across a ``yield`` of the frame generators, which may resume on another
thread.

A counter (``count(name, n)``, or ``timed(name)``, which adds the
nanoseconds of its block) goes to the frame of the innermost span open on
its thread, as ``[calls, total]`` under ``(frame, name)``. Counters:

- ``to_device_bytes``: host arrays copied to the device
  (``SliceEncoder._to_device``), bytes;
- ``from_device_bytes``: device results copied back (``_fetch_async``),
  bytes;
- ``rdoq``, ``intra_recon``, ``inter_recon``, ``merge_screen``, ``amvp``:
  the Python finalize by tool, nanoseconds (``rdoq`` also inside the
  recon counters);
- ``intra_native``, ``intra_python``: the Python finalize's intra CUs
  that the C++ recon reconstructed, and those it did not, one a CU;
- ``rdoq_native``: Python ``rdoq_levels`` calls that the C++ rdoq
  decided, one a call.

Spans, by the stage they time (``control/encoder.py`` unless named):
``search.dispatch`` (enqueueing a frame's device search),
``search.resolve`` (turning its result into CTU trees), ``search.wait``
(blocked on the device's result), ``partition.dp``
(``control/partition.py``), ``me.fullpel`` (the host full-pel search),
``me.qpel`` (K8's leaf refinement), ``finalize`` (reconstruction; its
attribute ``path`` is ``native_intra``, ``native_inter``, ``dual`` or
``python``), ``filter.deblock``, ``filter.sao``, ``filter.alf``,
``entropy`` and ``pipe.wait`` (``Encoder`` waiting on its entropy
worker).
"""
from __future__ import annotations

import itertools
import threading
import time

ENABLED = False
# spans that wait on another worker: ``offcpu`` leaves them out
WAITS = ("search.wait", "pipe.wait")
# counters of events, one a call (the others add nanoseconds or bytes)
EVENTS = ("intra_native", "intra_python", "rdoq_native")

_LOCK = threading.Lock()
_LOCAL = threading.local()
_IDS = itertools.count(1)
_SPANS: list = []
_COUNTERS: dict = {}


class Span:
    """One closed span (times in ns)."""

    __slots__ = ("id", "name", "frame", "tid", "parent", "t0", "t1", "cpu",
                 "attrs")

    def __init__(self, id, name, frame, tid, parent, t0, t1, cpu, attrs):
        self.id = id
        self.name = name
        self.frame = frame
        self.tid = tid
        self.parent = parent
        self.t0 = t0
        self.t1 = t1
        self.cpu = cpu
        self.attrs = attrs

    def __repr__(self):
        return (f"Span({self.name!r}, frame={self.frame}, tid={self.tid}, "
                f"parent={self.parent}, {(self.t1 - self.t0) / 1e6:.3f} ms)")


class Records:
    """What a traced run left: ``spans`` [Span] in the order they closed,
    ``counters`` {(frame, name): [calls, total]}."""

    def __init__(self, spans, counters):
        self.spans = spans
        self.counters = counters


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOOP = _Noop()


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Open:
    __slots__ = ("id", "name", "frame", "parent", "t0", "c0", "attrs",
                 "stack")

    def __init__(self, name, frame, attrs):
        self.name = name
        self.frame = frame
        self.attrs = attrs

    def set(self, **attrs):
        """Attributes known only inside the span (``frame`` among them)."""
        if "frame" in attrs:
            self.frame = attrs.pop("frame")
        self.attrs.update(attrs)

    def __enter__(self):
        st = self.stack = _stack()
        top = st[-1] if st else None
        self.parent = top.id if top is not None else None
        if self.frame is None and top is not None:
            self.frame = top.frame
        self.id = next(_IDS)
        st.append(self)
        self.c0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.c0
        self.stack.pop()
        rec = Span(self.id, self.name, self.frame, threading.get_ident(),
                   self.parent, self.t0, t1, cpu, self.attrs)
        with _LOCK:
            _SPANS.append(rec)
        return False


def span(name: str, frame=None):
    """A context manager that records a span while the tracer is on; its
    ``set(**attrs)`` adds attributes."""
    if not ENABLED:
        return NOOP
    return _Open(name, frame, {})


def _add(name: str, calls: int, total: int) -> None:
    st = _stack()
    key = (st[-1].frame if st else None, name)
    with _LOCK:
        c = _COUNTERS.get(key)
        if c is None:
            _COUNTERS[key] = [calls, total]
        else:
            c[0] += calls
            c[1] += total


def count(name: str, n: int) -> None:
    """Add one call of ``n`` to counter ``name`` while the tracer is on."""
    if ENABLED:
        _add(name, 1, int(n))


class _Timed:
    __slots__ = ("name", "t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _add(self.name, 1, time.perf_counter_ns() - self.t0)
        return False


def timed(name: str):
    """A context manager that adds a call and its nanoseconds to counter
    ``name`` while the tracer is on (no span: it parents nothing)."""
    if not ENABLED:
        return NOOP
    return _Timed(name)


def open_spans() -> list:
    """The names of the spans open on the calling thread, outermost
    first."""
    return [s.name for s in getattr(_LOCAL, "stack", ())]


def start() -> None:
    """Clear the records and switch the tracer on."""
    global ENABLED
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
    ENABLED = True


def stop() -> Records:
    """Switch the tracer off; returns everything recorded since
    ``start()`` (spans still open then are not in it)."""
    global ENABLED
    ENABLED = False
    with _LOCK:
        out = Records(list(_SPANS), dict(_COUNTERS))
        _SPANS.clear()
        _COUNTERS.clear()
    return out


def drain(frame) -> Records:
    """Take the records of one frame out, leaving the rest (the CLI's
    per-frame stats, so that the records do not grow over a stream)."""
    with _LOCK:
        mine = [s for s in _SPANS if s.frame == frame]
        _SPANS[:] = [s for s in _SPANS if s.frame != frame]
        keys = [k for k in _COUNTERS if k[0] == frame]
        counters = {k: _COUNTERS.pop(k) for k in keys}
    return Records(mine, counters)


def offcpu(spans) -> tuple:
    """(off, wall) in ns over the spans' self times (a span's time less
    its children's), the waits (``WAITS``) left out: ``off`` is wall less
    thread CPU time, the time a stage spent off the CPU (the GIL, or
    descheduled) while it had work to do. The CLI's ``offcpu_ms`` and the
    benchmark's ``host_wait_share`` (off over wall) both read this."""
    own = {s.id: [s.t1 - s.t0, s.cpu] for s in spans}
    for s in spans:
        p = own.get(s.parent)
        if p is not None:
            p[0] -= s.t1 - s.t0
            p[1] -= s.cpu
    off = wall = 0
    for s in spans:
        if s.name not in WAITS:
            w, c = own[s.id]
            wall += w
            off += max(0, w - c)
    return off, wall


def summary(recs: Records) -> dict:
    """One frame's records as the CLI's ``--stats-file`` line carries
    them: ``stage_ms`` {span name: wall ms, summed over its spans; nested
    stages count in their parents too}, ``offcpu_ms`` (``offcpu``),
    ``tool_ms`` {timed counter: ms}, ``bytes`` {"to_device",
    "from_device": bytes} and ``calls`` {event counter: calls}."""
    stage: dict = {}
    for s in recs.spans:
        stage[s.name] = stage.get(s.name, 0) + s.t1 - s.t0
    tool: dict = {}
    nbytes: dict = {}
    events: dict = {}
    for (_frame, name), (calls, total) in recs.counters.items():
        if name.endswith("_bytes"):
            key = name[:-len("_bytes")]
            nbytes[key] = nbytes.get(key, 0) + total
        elif name in EVENTS:
            events[name] = events.get(name, 0) + calls
        else:
            tool[name] = tool.get(name, 0) + total
    return {"stage_ms": {k: round(v / 1e6, 3)
                         for k, v in sorted(stage.items())},
            "offcpu_ms": round(offcpu(recs.spans)[0] / 1e6, 3),
            "tool_ms": {k: round(v / 1e6, 3) for k, v in sorted(tool.items())},
            "bytes": dict(sorted(nbytes.items())),
            "calls": dict(sorted(events.items()))}

"""The port's frame-stage tracer (uvg266_tpu_torch.trace) on the CPU.

Off, it records nothing. On, an all-intra batch through
``dispatch_frames_search`` + ``encode_frame`` on three threads and a
``--preset medium`` low-delay stream through ``Encoder.feed/flush`` give
every stage span of every frame, under the frame's number, with the
parents and threads the stages run on; no span is open across a ``yield``
of the frame generators; the access units and reconstructions equal those
of an untraced run; the span clock is ``time.perf_counter``'s. The CLI's
``--stats-file`` lines carry each frame's ``stage_ms``, ``offcpu_ms``,
``tool_ms`` and ``bytes``.
"""
import json
import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from uvg266_tpu_torch import trace
from uvg266_tpu_torch.control.encoder import (Encoder, FramePlanes,
                                              SliceEncoder)
from uvg266_tpu_torch.control.params import EncoderControl, FrameState
from uvg266_tpu_torch.tools import encode as tenc
from uvg266_tpu_torch.tools.encode import cli_config

W, H = 128, 80


@pytest.fixture(autouse=True)
def _one_thread_tracer_off():
    """One intra-op thread a test (parallel workers share the cores), and
    the tracer off before and after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.stop()
    yield
    trace.stop()
    torch.set_num_threads(n)


def _frames(n, seed=5):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    out = []
    for i in range(n):
        yi = np.roll(y, 2 * i, axis=1)
        out.append(FramePlanes(yi, yi[::2, ::2].copy(), yi[1::2, ::2].copy()))
    return out


@pytest.fixture
def no_span_across_yield(monkeypatch):
    """Wrap the frame generators: each time one yields, the spans open on
    the thread that resumed it are those that were open before."""
    bad = []

    def checked(fn):
        def gen(*args, **kw):
            g = fn(*args, **kw)
            while True:
                before = trace.open_spans()
                try:
                    v = next(g)
                except StopIteration:
                    return
                if trace.open_spans() != before:
                    bad.append((fn.__name__, before, trace.open_spans()))
                yield v
        return gen
    monkeypatch.setattr(SliceEncoder, "encode_frame_gen",
                        checked(SliceEncoder.encode_frame_gen))
    monkeypatch.setattr(Encoder, "_encode_ld_gen",
                        checked(Encoder._encode_ld_gen))
    return bad


def test_the_tracer_off_records_nothing():
    assert not trace.ENABLED
    assert trace.span("x", 1) is trace.NOOP
    assert trace.timed("rdoq") is trace.NOOP
    cfg = cli_config(["-p", "1", "--preset", "ultrafast", "-q", "30"], W, H)
    enc = Encoder(cfg, device="cpu")
    for f in _frames(2):
        enc.feed(f)
    enc.flush()
    trace.count("to_device_bytes", 10)
    rec = trace.stop()
    assert rec.spans == [] and rec.counters == {}


def test_span_times_lie_between_clock_reads():
    trace.start()
    a = time.perf_counter()
    with trace.span("outer", 7) as sp:
        b = time.perf_counter()
        with trace.span("inner"):
            trace.count("to_device_bytes", 64)
            with trace.timed("rdoq"):
                pass
        c = time.perf_counter()
        sp.set(path="x")
    d = time.perf_counter()
    with trace.span("late") as sp2:
        sp2.set(frame=9)
    rec = trace.stop()
    by = {s.name: s for s in rec.spans}
    o, i = by["outer"], by["inner"]
    assert a <= o.t0 * 1e-9 <= b <= i.t0 * 1e-9 <= i.t1 * 1e-9 <= c \
        <= o.t1 * 1e-9 <= d
    assert i.parent == o.id and o.parent is None
    assert i.frame == 7 and o.attrs == {"path": "x"}
    assert by["late"].frame == 9
    assert 0 <= o.cpu <= o.t1 - o.t0 + 10**6
    assert rec.counters[(7, "to_device_bytes")] == [1, 64]
    calls, ns = rec.counters[(7, "rdoq")]
    assert calls == 1 and 0 <= ns <= i.t1 - i.t0
    # off the CPU: each span's own time (the outer less the inner)
    own = ((o.t1 - o.t0) - (i.t1 - i.t0), o.cpu - i.cpu)
    assert trace.offcpu([o, i]) == (
        max(0, own[0] - own[1]) + max(0, (i.t1 - i.t0) - i.cpu),
        o.t1 - o.t0)


def _ai_batches(traced):
    """Three workers, each its own SliceEncoder, one batch of three frames
    each through dispatch_frames_search, then encode_frame(prefetch=)."""
    cfg = cli_config(["-p", "1", "--preset", "ultrafast", "-q", "30"], W, H)
    ctrl = EncoderControl(cfg)
    encs = [SliceEncoder(cfg, ctrl, device="cpu") for _ in range(3)]
    frames = _frames(9)
    out, tids = {}, {}

    def work(k):
        idx = [k + 3 * j for j in range(3)]
        rs = encs[k].dispatch_frames_search(
            [FrameState(num=g, qp=30) for g in idx],
            [frames[g] for g in idx])
        for g, r in zip(idx, rs):
            au, rec = encs[k].encode_frame(FrameState(num=g, qp=30),
                                           frames[g], prefetch=r)
            out[g] = (bytes(au), rec.y.copy(), rec.u.copy())
            tids[g] = threading.get_ident()
    if traced:
        trace.start()
    a = time.perf_counter()
    threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    b = time.perf_counter()
    return out, tids, (trace.stop() if traced else None), (a, b)


def _same(x, y):
    assert sorted(x) == sorted(y)
    for g in x:
        assert x[g][0] == y[g][0], g
        for p, q in zip(x[g][1:], y[g][1:]):
            assert np.array_equal(p, q), g


def test_all_intra_batches_on_three_threads(no_span_across_yield):
    plain, _, _, _ = _ai_batches(False)
    out, tids, rec, (a, b) = _ai_batches(True)
    _same(plain, out)
    assert not no_span_across_yield
    spans = defaultdict(list)
    for s in rec.spans:
        spans[s.frame].append(s)
        assert a <= s.t0 * 1e-9 <= s.t1 * 1e-9 <= b
    byid = {s.id: s for s in rec.spans}
    covered = set()
    for g in range(9):
        names = defaultdict(list)
        for s in spans[g]:
            names[s.name].append(s)
        for n in ("search.resolve", "partition.dp", "finalize",
                  "filter.deblock", "entropy"):
            assert len(names[n]) == 1, (g, n, names.keys())
        # the first frame resolved waits for the batch's one copy
        assert len(names["search.wait"]) == (g < 3)
        res = names["search.resolve"][0]
        for n in ("search.wait", "partition.dp"):
            assert all(byid[s.parent] is res for s in names[n])
        for n in ("search.resolve", "finalize", "filter.deblock",
                  "entropy"):
            assert names[n][0].parent is None
            assert names[n][0].tid == tids[g]
        assert names["finalize"][0].attrs["path"] == "native_intra"
        for d in names["search.dispatch"]:
            covered.update(d.attrs["frames"])
            assert d.tid == tids[g]
            assert rec.counters[(g, "from_device_bytes")][0] == 1
    # one dispatch span a batch, under its first frame, naming all three
    assert covered == set(range(9))
    assert sum(v[1] for (g, k), v in rec.counters.items()
               if k == "to_device_bytes") == 9 * W * H * 4


def _ld_stream(traced):
    cfg = cli_config(["--preset", "medium", "--gop", "lp", "-q", "27"], W, H)
    enc = Encoder(cfg, device="cpu")
    outs = []
    if traced:
        trace.start()
    for f in _frames(6):
        outs += enc.feed(f)
    outs += enc.flush()
    rec = trace.stop() if traced else None
    return {fs.num: (bytes(au), r.y.copy(), r.u.copy())
            for au, r, fs, _refs, _src in outs}, rec


def test_low_delay_medium_stream(no_span_across_yield):
    plain, _ = _ld_stream(False)
    out, rec = _ld_stream(True)
    _same(plain, out)
    assert not no_span_across_yield
    main = threading.get_ident()
    byid = {s.id: s for s in rec.spans}
    spans = defaultdict(lambda: defaultdict(list))
    for s in rec.spans:
        spans[s.frame][s.name].append(s)
    assert sorted(spans) == list(range(6))
    entropy_threads = set()
    for g in range(6):
        names = spans[g]
        for n in ("search.dispatch", "search.resolve", "search.wait",
                  "partition.dp", "finalize", "filter.deblock",
                  "filter.sao", "entropy"):
            assert names[n], (g, n)
        res = names["search.resolve"]
        assert len(res) == 1 and res[0].parent is None
        for n in ("search.wait", "partition.dp"):
            assert byid[names[n][0].parent] is res[0]
        for n in ("search.dispatch", "search.resolve", "finalize",
                  "filter.deblock", "filter.sao"):
            assert all(s.tid == main and s.parent is None
                       for s in names[n]), (g, n)
        assert names["finalize"][0].attrs["path"] == "python"
        assert rec.counters[(g, "rdoq")][0] > 0
        entropy_threads.add(names["entropy"][0].tid)
        if g == 0:
            continue
        # P frames: stage D's screen and the host ME's dispatch
        assert len(names["search.dispatch"]) == 2
        assert byid[names["me.fullpel"][0].parent].name == "search.dispatch"
        assert byid[names["me.qpel"][0].parent] is res[0]
        for k in ("inter_recon", "merge_screen", "amvp"):
            calls, ns = rec.counters[(g, k)]
            assert calls > 0 and ns > 0
    # frame N-2's entropy runs on the worker while N-1 is finalized
    assert len(entropy_threads) == 2 and main in entropy_threads
    waits = [s for s in rec.spans if s.name == "pipe.wait"]
    assert waits and all(s.tid == main for s in waits)
    assert all(spans[s.frame]["entropy"][0].tid != main for s in waits)


def test_cli_stats_file_carries_the_stages(tmp_path):
    clip = tmp_path / "in.yuv"
    with open(clip, "wb") as fh:
        for f in _frames(3):
            for p in (f.y, f.u, f.v):
                fh.write(p.tobytes())
    stats = tmp_path / "stats.jsonl"
    assert tenc.main(["-i", str(clip), "--input-res", f"{W}x{H}",
                      "-o", str(tmp_path / "o.vvc"), "--gop", "lp",
                      "--preset", "medium", "--device", "cpu",
                      "--stats-file", str(stats)]) == 0
    lines = [json.loads(line) for line in stats.read_text().splitlines()]
    assert [x["num"] for x in lines] == [0, 1, 2]
    for x in lines:
        st = x["stage_ms"]
        for n in ("search.dispatch", "search.resolve", "finalize",
                  "entropy"):
            assert st[n] > 0, (x["num"], n)
        assert x["offcpu_ms"] >= 0
        # the Python finalize (rdoq on: medium) by tool, and the copies
        tools = {"rdoq", "intra_recon"} if x["num"] == 0 else \
            {"rdoq", "intra_recon", "inter_recon", "merge_screen", "amvp"}
        assert set(x["tool_ms"]) == tools, x["num"]
        assert all(v > 0 for v in x["tool_ms"].values())
        assert x["tool_ms"]["rdoq"] < st["finalize"]
        assert set(x["bytes"]) == {"to_device", "from_device"}
        assert all(v > 0 for v in x["bytes"].values())
    # the CLI switched the tracer off and drained every frame
    assert not trace.ENABLED
    rec = trace.stop()
    assert rec.spans == []

"""``harness/stages.py``'s readings of the program's own spans and
counters on synthetic runs, and ``stage_trace.py``'s traced run of each
cell on the CPU, whose line then carries every program reading."""
import sys
from types import SimpleNamespace

import pytest

from harness import entries, stages, trace

MS = 1_000_000                   # ns
NEW = ("search_wait_ms", "partition_dp_ms", "finalize_ms", "loop_filter_ms",
       "entropy_ms", "host_me_ms", "rdoq_ms", "host_wait_share",
       "idle_attributed", "to_device_mb")


def _span(id, name, frame, t0_s, t1_s, cpu_s=None, parent=None, tid=1):
    return SimpleNamespace(id=id, name=name, frame=frame, tid=tid,
                           parent=parent, t0=int(t0_s * 1e9),
                           t1=int(t1_s * 1e9),
                           cpu=int((t1_s - t0_s if cpu_s is None else cpu_s)
                                   * 1e9), attrs={})


def _program():
    spans = [
        _span(1, "search.resolve", 1, 0.5, 3.0, cpu_s=1.0),
        _span(2, "search.wait", 1, 2.5, 2.8, cpu_s=0.3, parent=1),
        _span(3, "finalize", 2, 4.0, 7.0, cpu_s=3.0, tid=2),
        _span(4, "filter.deblock", 1, 8.0, 8.5),
        _span(5, "filter.sao", 1, 8.5, 8.6),
        _span(6, "entropy", 2, 9.0, 9.2, tid=2),
    ]
    counters = {(1, "rdoq"): [3, 6 * MS], (2, "rdoq"): [1, 1 * MS],
                (1, "to_device_bytes"): [2, 3_000_000],
                (None, "to_device_bytes"): [1, 5]}
    return SimpleNamespace(spans=spans, counters=counters)


def _run(in_window=(1, 2), program=True):
    tr = trace.DeviceTrace([("k", "kernel", 1.0, 2.0),
                            ("k", "kernel", 5.0, 6.0)], 0.0, 10.0)
    return SimpleNamespace(in_window=set(in_window), trace=tr,
                           program=_program() if program else None)


def test_idle_is_put_down_to_the_stages_open_during_it():
    run = _run()
    by = stages.idle_by_stage(run.trace, run.program)
    # idle: [0, 1], [2, 5], [6, 10]: 8 s
    assert by["search.resolve"] == pytest.approx(0.5 + 1.0)
    assert by["search.wait"] == pytest.approx(0.3)
    assert by["finalize"] == pytest.approx(1.0 + 1.0)
    assert by["filter.deblock"] == pytest.approx(0.5)
    assert by["entropy"] == pytest.approx(0.2)
    assert by["none"] == pytest.approx(8.0 - 1.5 - 2.0 - 0.6 - 0.2)
    assert stages.idle_attributed(run) == pytest.approx(4.3 / 8)


def test_the_readings_count_the_windows_frames():
    read = stages.program_metrics(_run())
    assert set(read) == set(NEW)
    assert read["search_wait_ms"] == pytest.approx(300 / 2)
    assert read["finalize_ms"] == pytest.approx(3000 / 2)
    assert read["loop_filter_ms"] == pytest.approx(600 / 2)
    assert read["entropy_ms"] == pytest.approx(200 / 2)
    assert read["partition_dp_ms"] == 0.0
    assert read["host_me_ms"] == 0.0
    assert read["rdoq_ms"] == pytest.approx(7 / 2)
    assert read["to_device_mb"] == pytest.approx(3 / 2)
    # self times: the resolve 2.5 - 0.3 s of wall on 1.0 - 0.3 s of CPU;
    # the wait left out; the rest on the CPU throughout
    wall = 2.2 + 3.0 + 0.5 + 0.1 + 0.2
    assert read["host_wait_share"] == pytest.approx(1.5 / wall)
    # frame 2 left the window: only frame 1's records count
    one = stages.program_metrics(_run(in_window=(1,)))
    assert one["finalize_ms"] == 0.0
    assert one["rdoq_ms"] == pytest.approx(6.0)
    assert one["host_wait_share"] == pytest.approx(1.5 / 2.8)
    # a program without the tracer leaves nothing to read
    assert stages.program_metrics(_run(program=False)) == {}
    assert stages.program_metrics(
        SimpleNamespace(in_window=set(), trace=None)) == {}


def test_the_report_splits_the_windows_frames_by_stage():
    run = _run()
    run.program.spans[2].attrs = {"path": "python"}
    # frame 1 returned by an encode_frame call over [0, 4]: its top-level
    # spans (the resolve, 0.5-3.0) cover 2.5 s of it; frame 2's call over
    # [3.5, 9.5] is covered by its finalize and entropy, 3.2 of 6 s
    run.spans = [("dispatch", 0.0, 0.5), ("encode_frame", 0.0, 4.0),
                 ("encode_frame", 3.5, 9.5)]
    run.done = {1: 4.0, 2: 9.5}
    rep = stages.report(run)
    assert rep["frames"] == 2
    assert rep["stages"]["finalize"] == pytest.approx(
        {"wall_ms": 1500.0, "cpu_ms": 1500.0, "calls": 0.5})
    assert rep["stages"]["search.wait"]["cpu_ms"] == pytest.approx(150.0)
    assert rep["top_cpu_ms"] == pytest.approx((1.0 + 3.0 + 0.5 + 0.1
                                               + 0.2) * 1e3 / 2)
    assert rep["counters"] == {"rdoq": {"calls": 2.0, "total": 3.5 * MS},
                               "to_device_bytes": {"calls": 1.0,
                                                   "total": 1.5e6}}
    assert rep["finalize_paths"] == {"python": 1}
    cov = rep["coverage"]["encode_frame"]
    assert cov["n"] == 2 and cov["least"] == pytest.approx(3.2 / 6)
    assert cov["median"] == pytest.approx((2.5 / 4 + 3.2 / 6) / 2)
    # feed and flush: the top-level spans of the thread that called them
    run.spans = [("feed", 0.0, 4.0), ("flush", 8.0, 9.0)]
    cov = stages.coverage(run, tid=1)["feed+flush"]
    assert cov["n"] == 2 and cov["least"] == pytest.approx(0.6)
    assert cov["median"] == pytest.approx((2.5 / 4 + 0.6) / 2)
    assert stages.report(_run(program=False)) is None


def test_the_tracer_cost_pairs_alternate_the_tracer():
    import stage_trace
    assert stage_trace.order([5, 6, 7], pairs=True) == [
        (5, True), (5, False), (6, False), (6, True), (7, True), (7, False)]
    assert stage_trace.order([5, 6], pairs=False) == [(5, True), (6, True)]
    ns = stage_trace.sites(number=100)
    assert set(ns) == {"empty_ns"} | {f"{k}_{s}_ns" for k in (
        "span", "timed", "count") for s in ("off", "on")}
    from uvg266_tpu_torch import trace as program_trace
    assert not program_trace.ENABLED


def test_a_program_without_the_tracer_is_read_as_none(monkeypatch):
    import uvg266_tpu_torch
    assert stages.program_tracer() is not None
    monkeypatch.setitem(sys.modules, "uvg266_tpu_torch.trace", None)
    monkeypatch.delattr(uvg266_tpu_torch, "trace")
    assert stages.program_tracer() is None


@pytest.mark.parametrize("name", ["ultrafast_1080p.ai_pipelined",
                                  "medium_480p.ld"])
def test_a_traced_run_reports_the_program_readings(name):
    import stage_trace
    small = {"ultrafast_1080p.ai_pipelined": {"width": 136, "height": 72},
             "medium_480p.ld": {"width": 136, "height": 80}}[name]
    line = stage_trace.one(name, 2**35 + 3, 2.0, True, True, device="cpu",
                           overrides=small)
    assert line["correct"] and line["tracer"] == 1
    read = line["program"]
    # the device's idle time needs a card's trace
    assert set(read) == set(NEW) - {"idle_attributed"}
    assert "idle_by_stage" not in line
    assert all(v >= 0 for v in read.values())
    assert 0 < read["finalize_ms"]
    assert 0 <= read["host_wait_share"] <= 1
    if name == "medium_480p.ld":
        assert read["host_me_ms"] > 0 and read["rdoq_ms"] > 0
    # the stages by frame, and the top-level spans cover most of each of
    # the benchmark's calls into the program
    rep = line["stages"]
    assert rep["stages"]["finalize"]["wall_ms"] > 0
    call = {"medium_480p.ld": "feed+flush"}.get(name, "encode_frame")
    assert rep["coverage"][call]["median"] > 0.75, rep["coverage"]
    from uvg266_tpu_torch import trace as program_trace
    assert not program_trace.ENABLED
    # the entry loops are put back: a run without the tracer records none
    assert not any(hasattr(c, "_untraced")
                   for c in entries.ENTRIES.values())
    bare = stage_trace.one(name, 2**35 + 3, 1.0, False, False,
                           device="cpu", overrides=small)
    assert bare["correct"] and "program" not in bare

"""A cell of the benchmark run with the program's own tracer
(``uvg266_tpu_torch.trace``) on over its window, and what the tracer costs.

    python3 benchmark/stage_trace.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 51] [--trace 0|1] [--pairs]
    python3 benchmark/stage_trace.py --sites

Each seed runs in a process of its own, as ``benchmark/run.py`` runs it,
with the tracer switched on from the window's start until its frames are
done (``harness/stages.py`` ``traced_windows``). Prints one JSON line a
run: ``fps``, ``setup_s``, the process's CPU seconds a frame,
``frame_ms_p95`` and ``dispatch_ms`` where the run reads them, ``correct``,
and the program's readings: ``program`` (``stages.program_metrics``),
``stages`` (``stages.report``: each stage's wall and thread-CPU ms a
frame, the counters, the finalize's paths, and how much of the
benchmark's ``encode_frame`` or ``feed``/``flush`` calls the top-level
spans cover) and, with ``--trace 1`` (torch.profiler on, as the
benchmark's traced run), ``idle_by_stage``.

``--pairs`` runs each seed twice, once with the tracer and once without,
the order alternated from pair to pair: the tracer's cost while it
records. ``--sites`` times one site of each kind (``timeit``, best of
five) with the tracer off and on, less an empty statement, in ns.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

KEEP = ("fps", "setup_s", "frame_ms_p95", "dispatch_ms")


def order(seeds, pairs: bool) -> list:
    """[(seed, tracer on)]: each seed once with the tracer, or, with
    ``pairs``, a pair each, the tracer on first in every other pair."""
    if not pairs:
        return [(seed, True) for seed in seeds]
    out = []
    for i, seed in enumerate(seeds):
        first = i % 2 == 0
        out += [(seed, first), (seed, not first)]
    return out


def one(workload: str, seed: int, seconds: float, trace: bool,
        tracer_on: bool, **run_kw) -> dict:
    """One run in this process; its line. ``run_kw`` go to ``run_cell``
    (the tests' device and small sizes)."""
    from harness import cli, spec, stages
    t_proc = cli.process_start()
    import torch
    torch.set_num_threads(1)
    tracer = stages.program_tracer() if tracer_on else None
    runs = stages.traced_windows(tracer) if tracer is not None else []
    try:
        cell = spec.Cell(spec.benchmark(), workload)
        out = cli.run_cell(cell, seed, seconds, trace, t_proc=t_proc,
                           **run_kw)
    finally:
        stages.untraced()
    m = out["metrics"]
    line = {"workload": workload, "seed": seed, "trace": int(trace),
            "tracer": int(tracer is not None), "correct": out["correct"],
            "process_cpu_s_per_frame":
                out["host"]["process_cpu_s_per_frame"]}
    line.update({k: m[k]["value"] for k in KEEP if k in m})
    if runs:
        run = runs[0]
        line["program"] = stages.program_metrics(run)
        if run.trace is not None:
            line["idle_by_stage"] = stages.idle_by_stage(run.trace,
                                                         run.program)
        line["stages"] = stages.report(run)
    return line


def sites(number: int = 200_000) -> dict:
    """ns a site: each kind of site with the tracer off and on, less the
    empty statement's own ns."""
    import timeit
    from uvg266_tpu_torch import trace

    stmts = {"span": "with trace.span('x', 1):\n    pass",
             "timed": "with trace.timed('x'):\n    pass",
             "count": "trace.count('x', 8)"}

    def ns(stmt):
        return min(timeit.repeat(stmt, number=number, repeat=5,
                                 globals={"trace": trace})) / number * 1e9
    empty = ns("pass")
    out = {"empty_ns": empty}
    for state in ("off", "on"):
        if state == "on":
            trace.start()
        for k, stmt in stmts.items():
            out[f"{k}_{state}_ns"] = ns(stmt) - empty
        if state == "on":
            trace.stop()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/stage_trace.py")
    p.add_argument("--sites", action="store_true")
    p.add_argument("--workload")
    p.add_argument("--seeds")
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--pairs", action="store_true",
                   help="each seed with the tracer and without it")
    p.add_argument("--one", type=int, choices=(0, 1), default=None,
                   help="run one seed here: 1 with the tracer, 0 without")
    a = p.parse_args(argv)
    if a.sites:
        print(json.dumps(sites()), flush=True)
        return 0
    if a.workload is None or a.seeds is None:
        p.error("--workload and --seeds are needed without --sites")
    seeds = [int(s) for s in a.seeds.split(",")]
    if a.one is not None:
        print(json.dumps(one(a.workload, seeds[0], a.seconds,
                             bool(a.trace), bool(a.one))), flush=True)
        return 0
    rc = 0
    for seed, on in order(seeds, a.pairs):
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--workload",
             a.workload, "--seeds", str(seed), "--seconds", str(a.seconds),
             "--trace", str(a.trace), "--one", str(int(on))],
            stdout=subprocess.PIPE, text=True)
        lines = r.stdout.strip().splitlines()
        print(lines[-1] if r.returncode == 0 and lines else json.dumps(
            {"seed": seed, "tracer": int(on), "rc": r.returncode}),
            flush=True)
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())

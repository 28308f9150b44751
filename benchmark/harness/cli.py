"""``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json``.

Set-up makes the cell's frame pool from the seed on the card, builds the
program's ``Config`` from the configuration's and the traffic mix's CLI
flags, and warms the cell's own path (the first run in a checkout builds
the port's kernels into ``uvg266_tpu_torch/build/`` and its host library
into ``uvg266_tpu_torch/native/``). The window then runs for ``--seconds``;
with ``--trace 1`` under torch.profiler. Once it has closed, the peak
memory is read, the program's state is freed, and the drawn frames are
checked against the reference. Standard error ends with each number
compared beside its limit; standard output ends with the result line.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from . import entries, spec, verify
from .clip import make_pool

FORBIDDEN = ("jax", "jaxlib", "flax", "uvg266_tpu")


def process_start() -> float:
    """The epoch second this process started (from /proc), or now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def program_config(cell: spec.Cell, overrides: dict | None = None):
    """The Config the port's CLI builds for the configuration's and the
    traffic mix's flags at the configuration's size."""
    from uvg266_tpu_torch.tools.encode import cli_config
    c = {**cell.config, **(overrides or {})}
    flags = list(c["flags"]) + list(cell.traffic["flags"]) + [
        "-q", str(cell.traffic["qp"]),
        "--input-bitdepth", str(c["bitdepth"])]
    return cli_config(flags, int(c["width"]), int(c["height"])), c


class BuildClock:
    """The seconds spent in the program's builds (nvcc of its kernels, g++
    of its host library) while it is installed: a checkout's first run
    builds inside set-up, and this tells that part apart."""

    def __init__(self):
        from uvg266_tpu_torch import kernels, native
        self.seconds = 0.0
        self._orig = [(kernels, "build", kernels.build),
                      (native, "_build_lib", native._build_lib)]
        for mod, name, fn in self._orig:
            setattr(mod, name, self._timed(fn))

    def _timed(self, fn):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        return timed

    def close(self) -> float:
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)
        return self.seconds


def host_line(cpu0: float, cpu1: float, frames: int) -> dict:
    """The process's CPU seconds over the window, in all and per frame
    done: where the wall moves and these move with it, the same work took
    the host longer."""
    cpu = cpu1 - cpu0
    return {"process_cpu_s": cpu,
            "process_cpu_s_per_frame": cpu / max(frames, 1)}


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             t_proc: float | None = None, keep_aus: bool = False,
             control=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``overrides`` replace keys of the configuration (the tests' small
    sizes); ``keep_aus`` keeps every access unit under ``aus``; with
    ``control`` (a torch dtype) the check reads the control in the
    program's place (``benchmark/control.py``)."""
    import torch

    from uvg266_tpu_torch import kernels
    t_proc = process_start() if t_proc is None else t_proc
    cuda = device != "cpu"
    parts = [("imports", time.time())]
    clock = BuildClock()
    if cuda:
        torch.zeros(1, device=device)
        parts.append(("cuda context", time.time()))
    cfg, conf = program_config(cell, overrides)
    traffic = cell.traffic
    pool = make_pool(int(conf["width"]), int(conf["height"]),
                     int(traffic["pool"]), seed, device)
    parts.append(("pool", time.time()))
    first = int(traffic.get("warm_frames", 0))
    want = verify.draw(traffic, seed, first, seconds)
    entry = entries.ENTRIES[traffic["entry"]](cfg, traffic, pool, device,
                                              want, seed)
    parts.append(("encoders", time.time()))
    entry.warm()
    if cuda:
        torch.cuda.synchronize()
    parts.append(("warm-up", time.time()))
    build_s = clock.close()
    setup_parts, prev = {}, t_proc
    for k, v in parts:
        setup_parts[k] = v - prev
        prev = v
    setup_parts["builds (within the above)"] = build_s
    print("set-up parts (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup_parts.items()), file=sys.stderr)
    run = entries.Run()
    run.config = conf
    run.aus = {} if keep_aus else None
    prof = None
    if trace and cuda:
        from .trace import Profiler
        prof = Profiler(torch)
        prof.start()
    launches0 = sum(kernels.LAUNCHES.values())
    cpu0 = time.process_time()
    run.t_start = time.perf_counter()
    run.setup_s = time.time() - t_proc
    run.t_end = run.t_start + seconds
    entry.window(run)
    if cuda:
        torch.cuda.synchronize()
    run.t_stop = time.perf_counter()
    host = host_line(cpu0, time.process_time(), len(run.done))
    print("host over the window: " + ", ".join(
        f"{k} {v:.4f}" for k, v in host.items()), file=sys.stderr)
    if prof is not None:
        run.trace = prof.stop(run.t_start, run.t_stop)
    run.launches = sum(kernels.LAUNCHES.values()) - launches0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    decisions = entry.decisions(run)
    entry.close()
    del entry
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    for m in cell.metrics(trace):
        value = spec.reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = verify.numbers(decisions, want, run.first, run.done, pool,
                            run.source, conf, traffic, device,
                            cost_dtype=control, stages=run.stages)
    ok, checks = verify.verdict(result, traffic)
    started = len(run.in_window)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": peak}
    out = {"correct": ok, "attempted": started,
           "failed": sum(1 for g in run.in_window if g not in run.done),
           "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown(run.spans)
    if keep_aus:
        out["aus"] = run.aus
    out["setup_parts"] = setup_parts
    out["host"] = host
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    t_proc = process_start()
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.Cell(spec.benchmark(), args.workload)
    import torch
    # one process with few threads: torch's own pool does no work here
    # that pays for the cores it takes from the program's host threads
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_proc=t_proc)
    found = forbidden_modules()
    if found:
        print("benchmark: the run loaded " + ", ".join(found)
              + ": no result", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0

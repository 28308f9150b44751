"""The harness on the CPU: cells found by their files, the modules a run
loads, the trace arithmetic, and the two entry loops against the port's
own CPU bytes."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from harness import cli, spec, trace, work

BENCH = spec.BENCH_DIR
ROOT = spec.ROOT
SMALL = {"ultrafast_1080p.ai_pipelined": {"width": 136, "height": 72},
         "medium_480p.ld": {"width": 136, "height": 80}}


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a metric, each a new file named
    in BENCHMARK.json, run through the harness unchanged."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    b = spec.benchmark()
    conf = dict(spec.load_json(os.path.join(BENCH, "configs",
                                            "ultrafast_1080p.json")))
    conf.update(width=72, height=64, flags=["--preset", "superfast"])
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(conf))
    traffic = spec.load_json(os.path.join(BENCH, "traffic",
                                          "ai_pipelined.json"))
    traffic.update(workers=2, batch=2, qp=30, check_frames=2,
                   check_rate=0)
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    b["configs"].append({"name": "dummy_cfg", "source": "a test",
                         "file": "benchmark/configs/dummy_cfg.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy_cfg.dummy_mix",
                           "config": "dummy_cfg", "traffic": "dummy_mix",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "frames_done", "unit": "frames",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["dummy_cfg.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.Cell(spec.benchmark(str(tmp_path)), "dummy_cfg.dummy_mix",
                     str(bench))
    assert cell.config["flags"] == ["--preset", "superfast"]
    out = cli.run_cell(cell, 2**40 + 5, 2.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["metrics"]["frames_done"]["value"] >= 4
    assert set(out["metrics"]) == {"fps", "setup_s", "frames_done"}
    assert list(out)[-1] == "checks"


def _modules(code):
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_the_reference_none_of_the_port():
    top = _modules(
        "import sys, json; sys.path[:0] = ['benchmark', '.']\n"
        "from harness import cli, spec\n"
        "cell = spec.Cell(spec.benchmark(), 'medium_480p.ld')\n"
        "cli.run_cell(cell, 3, 1.0, False, device='cpu',"
        " overrides={'width': 72, 'height': 64})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"jax", "jaxlib", "flax", "uvg266_tpu"} & set(top)
    assert "uvg266_tpu_torch" in top
    ref = _modules(
        "import sys, json; sys.path[:0] = ['benchmark']\n"
        "import numpy as np, torch\n"
        "import reference.check, reference.inter as ri\n"
        "import reference.rdoq as rr, reference.search as rs\n"
        "from harness import verify, work, trace, clip, spec\n"
        "pool = clip.make_pool(72, 64, 2, 5, 'cpu')\n"
        "y = pool[0][0]\n"
        "s = rs.search_frame(y, 27, screen=True)\n"
        "reference.check.tree_from_dp(s, 72, 64, 27)\n"
        "src = torch.from_numpy(y.astype(np.int64))\n"
        "ref = torch.from_numpy(pool[1][0].astype(np.int64))\n"
        "ri.leaf_seg(src, [ref], [(8, 8, 16, 16, 0, (16, -16))], 8)\n"
        "d = [(16, 16, 0, 0, 16, 16, 4, 4)]\n"
        "ri.me_rd(src, [ref], d, np.zeros((1, 16, 2), np.int64),\n"
        "         np.zeros((1, 16)), 27, 8, 57.0, torch.ones(4))\n"
        "rr.rdoq_levels(np.arange(64).reshape(8, 8) * 9, 27, 8, 57.0)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not {"jax", "jaxlib", "flax", "uvg266_tpu",
                "uvg266_tpu_torch"} & set(ref)


def test_the_interval_union_counts_overlap_once():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 11.0)]
    assert trace.union_seconds(iv) == pytest.approx(4.0)
    assert trace.union_seconds(iv, 0.5, 3.5) == pytest.approx(2.0)
    merged = trace.union(iv, 0.0, 5.0)
    assert trace.gaps(merged, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    ev = [("k1", "kernel", 0.0, 1.0), ("Memcpy HtoD (Pageable -> Device)",
                                       "htod", 0.5, 1.5),
          ("k2", "kernel", 2.0, 2.5)]
    t = trace.DeviceTrace(ev, 0.0, 4.0)
    assert t.busy_s() == pytest.approx(2.0)
    assert t.busy_s({"kernel"}) == pytest.approx(1.5)
    assert t.seconds("htod") == pytest.approx(1.0)
    bd = t.breakdown([("encode_frame", 2.4, 4.0), ("dispatch", 1.5, 2.0)])
    assert bd["idle_gaps"][0] == ["encode_frame", pytest.approx(1.5)]
    assert bd["idle_gaps"][1] == ["dispatch", pytest.approx(0.5)]
    assert trace.kind_of("Memcpy DtoH (Device -> Pinned)") == "dtoh"
    assert trace.kind_of("Memset (Device)") == "memset"


def test_the_roofline_arithmetic():
    assert work.dct_ops(8) == 8 + 2 * 16 + work.dct_ops(4)
    nbytes, ops = work.intra_search_work(64, 64)
    # one block of each size and the 4 + 16 + 64 smaller ones
    assert ops == sum(work.class_ops((64 // s) ** 2, s)
                      for s in (64, 32, 16, 8))
    assert nbytes == 64 * 64 + (1 + 4 + 16 + 64) * 8
    assert work.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
    assert work.least_seconds(1.0, 67e12) == pytest.approx(1.0)
    read = spec.reader("intra_search_roofline")

    class Run:
        config = {"width": 64, "height": 64, "bitdepth": 8}
        in_window = set(range(10))
        trace = trace.DeviceTrace([("k", "kernel", 0.0, 1e-3)], 0.0, 1.0)
    want = 100 * 10 * work.least_seconds(nbytes, ops) / 1e-3
    assert read(Run) == pytest.approx(want)


def _port_ai_bytes(cfg, frames, qp):
    from uvg266_tpu_torch.control.encoder import FramePlanes, SliceEncoder
    from uvg266_tpu_torch.control.params import EncoderControl, FrameState
    se = SliceEncoder(cfg, EncoderControl(cfg), device="cpu")
    return [bytes(se.encode_frame(FrameState(num=g, qp=qp),
                                  FramePlanes(*f))[0])
            for g, f in enumerate(frames)]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_entry_loops_write_the_ports_cpu_bytes(name):
    from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes

    from harness.clip import make_pool, order
    cell = spec.Cell(spec.benchmark(), name)
    if "rdoq_every" in cell.traffic:
        # a small picture makes few rdoq calls: sample more of them
        cell.traffic = {**cell.traffic, "rdoq_every": 3}
    out = cli.run_cell(cell, 2**33 + 1, 2.0, False, device="cpu",
                       overrides=SMALL[name], keep_aus=True)
    assert out["correct"], out["checks"]
    cfg, conf = cli.program_config(cell, SMALL[name])
    t = cell.traffic
    pool = make_pool(conf["width"], conf["height"], t["pool"], 2**33 + 1,
                     "cpu")
    aus = out["aus"]
    how = t.get("order", "cycle")
    if t["entry"] == "pipelined":
        n = max(aus) + 1
        frames = [pool[order(g, len(pool), how)] for g in range(n)]
        want = _port_ai_bytes(cfg, frames, t["qp"])
        assert len(aus) >= 3
        for g, au in aus.items():
            assert au == want[g], g
    else:
        enc = Encoder(cfg, device="cpu")
        want = {}
        for i in range(max(aus) + 1):
            for au, _r, fs, _refs, _s in enc.feed(
                    FramePlanes(*pool[order(i, len(pool), how)])):
                want[fs.num] = bytes(au)
        for au, _r, fs, _refs, _s in enc.flush():
            want[fs.num] = bytes(au)
        assert len(aus) >= 2
        for g, au in aus.items():
            assert au == want[g], g


def test_run_py_refuses_to_measure_without_a_card():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "medium_480p.ld", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "no result" in r.stderr


def test_the_pool_is_made_from_the_seed():
    from harness.clip import make_pool, order
    a = make_pool(64, 32, 3, 2**40, "cpu")
    b = make_pool(64, 32, 3, 2**40, "cpu")
    c = make_pool(64, 32, 3, 2**40 + 1, "cpu")
    assert all((x == y).all() for fa, fb in zip(a, b) for x, y in zip(fa, fb))
    assert any((x != y).any() for fa, fc in zip(a, c) for x, y in zip(fa, fc))
    assert a[0][0].shape == (32, 64) and a[0][1].shape == (16, 32)
    assert a[0][0].dtype == np.uint8
    assert [order(i, 4, "pingpong") for i in range(8)] == [0, 1, 2, 3, 2, 1,
                                                          0, 1]


def test_the_check_draws_across_the_whole_window():
    from harness import verify
    t = {"check_frames": 4, "check_rate": 0.6, "qp_rule": "lowdelay4",
         "intra_period": 64, "qp": 27}
    for seed in (3, 2**31 + 5, 2**40 + 1):
        got = sorted(verify.draw(t, seed, 3, 51.0))
        assert len(got) == 4
        span = int(0.6 * 51.0)
        for j, g in enumerate(got):
            assert 3 + j * span // 4 <= g < 3 + (j + 1) * span // 4 + 1
        assert all(g % 64 for g in got)
    assert verify.draw(t, 7, 3, 51.0) == verify.draw(t, 7, 3, 51.0)
    t.update(check_rate=0)
    assert verify.draw(t, 7, 3, 51.0) == {3, 4, 5, 6}

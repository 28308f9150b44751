"""The kernel loader under host threads: several threads that first need a
kernel at once (the mesh encoders' runs, the CLI's --threads) build its
source once and share one loaded library. nvcc is a stub script here that
counts its runs and writes an empty output after a pause, and the library
load is a stand-in: the CPU has neither nvcc nor a card."""
import os
import sys
import threading

import torch

import pytest

from uvg266_tpu_torch import kernels

N_THREADS = 8


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A fake nvcc that logs each run to ``runs``; kernels build into
    tmp_path. Returns the log's path."""
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(runs)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "time.sleep(0.3)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_LIBS", {})
    return runs


def _together(fn):
    """fn() on N_THREADS threads released at once -> their results."""
    start = threading.Barrier(N_THREADS)
    out = [None] * N_THREADS
    errs = []

    def work(i):
        start.wait()
        try:
            out[i] = fn()
        except BaseException as e:      # noqa: BLE001 (reported below)
            errs.append(e)
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "a thread did not finish"
    assert not errs, errs
    return out


def test_build_runs_once_across_threads(stub_nvcc):
    _together(lambda: kernels.build(["predict67"]))
    assert stub_nvcc.read_text().splitlines() == [
        os.path.join(kernels.CSRC, "predict67.cu")]
    assert os.path.exists(kernels.lib_path("predict67"))


def test_load_builds_and_loads_once_across_threads(stub_nvcc, monkeypatch):
    loaded = []

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)

        def __getattr__(self, name):
            return type("Entry", (), {})()

    monkeypatch.setattr(kernels.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels.ctypes, "CDLL", FakeLib)
    # two kernels of one source (refs_blocks lives in refs_blocks_grid.cu)
    got = _together(lambda: (kernels._load("refs_blocks"),
                             kernels._load("refs_blocks_grid")))
    assert stub_nvcc.read_text().splitlines() == [
        os.path.join(kernels.CSRC, "refs_blocks_grid.cu")]
    assert loaded == [kernels.lib_path("refs_blocks")] * 2
    assert all(g[0] is got[0][0] and g[1] is got[0][1] for g in got)


def test_launch_counts_lose_no_update_across_threads(monkeypatch):
    """Launches counted from many threads at once, in all and by card (a
    shortened switch interval makes a lost read-modify-write likely
    without the lock)."""
    n_threads, n_each = 16, 2000
    monkeypatch.setattr(kernels, "_load",
                        lambda name: (lambda *a: 0, lambda rc: b""))
    stream = type("Stream", (), {"cuda_stream": 0})()
    monkeypatch.setattr(kernels.torch.cuda, "current_stream",
                        lambda device=None: stream)
    before = kernels.LAUNCHES["satd67"]
    before_cpu = kernels.LAUNCHES_BY_DEVICE.get("cpu", {}).get("satd67", 0)
    start = threading.Barrier(n_threads)

    def work():
        start.wait()
        for _ in range(n_each):
            kernels.launch("satd67", torch.device("cpu"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "a thread did not finish"
    finally:
        sys.setswitchinterval(old)
    assert kernels.LAUNCHES["satd67"] - before == n_threads * n_each
    # and by card, under the same lock
    assert kernels.LAUNCHES_BY_DEVICE["cpu"]["satd67"] - before_cpu == \
        n_threads * n_each
    kernels.LAUNCHES["satd67"] = before
    kernels.LAUNCHES_BY_DEVICE["cpu"]["satd67"] = before_cpu

"""The port's CLI (uvg266_tpu_torch.tools.encode) and the bdrate copy.

The CLI is the JAX package's CLI with --device in place of --tpu: for the
same arguments it must write the same bytes as the JAX CLI (both run
in-process through main(argv); the port with --device cpu), for an
all-intra clip, a low-delay clip and the all-intra host frame pipeline
(--threads 2). Its summary line is what tools/bdrate.py parses: run_ours
shells out to the port CLI and reads the bits and PSNR back. bd_rate and
synth_clip of the port's bdrate copy equal the reference's exactly on fixed
inputs (tolerance 0)."""
import os

import numpy as np
import pytest
import torch

from uvg266_tpu_torch.tools import bdrate as tb
from uvg266_tpu_torch.tools import encode as tenc

W, H, N = 192, 128, 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread a test, so that parallel test workers (and the
    mesh's host threads) do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "clip.yuv")
    tb.write_yuv(tb.synth_clip(W, H, N, 7), path)
    return path


@pytest.mark.parametrize("tail", [["-p", "1"], ["--gop", "lp"],
                                  ["-p", "1", "--threads", "2"]],
                         ids=["all-intra", "low-delay", "all-intra-threads"])
def test_cli_bytes_equal_jax_cli(clip, tmp_path, tail, capsys):
    pytest.importorskip("jax")
    from uvg266_tpu.tools import encode as jenc
    base = ["-i", clip, "--input-res", f"{W}x{H}", "-q", "32", "-n", str(N)]
    want, got = str(tmp_path / "jax.vvc"), str(tmp_path / "port.vvc")
    assert jenc.main(base + ["-o", want] + tail) == 0
    jax_out = capsys.readouterr().out
    assert tenc.main(base + ["-o", got, "--device", "cpu"] + tail) == 0
    port_out = capsys.readouterr().out
    with open(want, "rb") as a, open(got, "rb") as b:
        stream = b.read()
        assert len(stream) > 100 and stream == a.read()
    # the summary line bdrate parses: same bits and PSNR
    assert tb._parse_summary(port_out) == tb._parse_summary(jax_out)


def test_cli_defaults_to_the_card(clip, tmp_path):
    args = ["-i", clip, "--input-res", f"{W}x{H}", "-n", "1",
            "-o", str(tmp_path / "x.vvc")]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.main(args)


def test_bdrate_run_ours_parses_the_port_cli(clip, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    bits, psnr_y = tb.run_ours(clip, W, H, 2, 37, ["-p", "1"], device="cpu")
    assert bits > 0 and 20.0 < psnr_y < 60.0


def test_bdrate_helpers_equal_reference():
    from uvg266_tpu.tools import bdrate as jb
    for args in ((64, 48, 3, 7), (96, 32, 2, 3)):
        for a, b in zip(tb.synth_clip(*args), jb.synth_clip(*args)):
            for pa, pb in zip(a, b):
                assert pa.dtype == pb.dtype and np.array_equal(pa, pb)
    curves = [([1000, 1800, 3300, 6000], [32.1, 34.9, 37.6, 40.2],
               [950, 1700, 3200, 5900], [32.0, 35.0, 37.8, 40.1]),
              ([500, 900, 1500], [30.0, 33.0, 36.0],
               [520, 950, 1450], [30.2, 33.1, 35.7])]
    for c in curves:
        assert tb.bd_rate(*c) == jb.bd_rate(*c)
    with pytest.raises(ValueError):
        tb.bd_rate([1, 2], [30, 31], [1, 2], [40, 41])
    text = " Processed 3 frames, 4616 bits AVG PSNR Y 36.5180 U 40 V 40\n"
    assert tb._parse_summary(text) == jb._parse_summary(text) == (4616,
                                                                  36.518)
    assert tb.CONFIGS == jb.CONFIGS


def test_bdrate_refuses_a_missing_reference_binary(tmp_path, capsys):
    missing = str(tmp_path / "no-uvg266")
    assert tb.main(["--ref-bin", missing, "--frames", "1"]) == 1
    assert "not found" in capsys.readouterr().out
    from uvg266_tpu_torch.tools import conformance_fuzz as cf
    assert cf.main(["--ref-bin", missing, "--iters", "1"]) == 2
    assert not os.path.exists(missing)

#!/usr/bin/env python3
"""Per-frame digests of chip_smoke.py phase 12's encodes, made on the CPU.

    python3 tools/ctc_digests.py [--jobs 3] [--only LABEL ...]

Runs every encode of chip_smoke.CTC (the reference's 1920x1080
configurations and the 3840x2160 10-bit batch) twice on the CPU: through
the port (uvg266_tpu_torch, device="cpu": the kernels' plain versions) and
through the JAX package (JAX_PLATFORMS=cpu, one jit cache per bit depth).
It writes tests/vectors/torch_ctc_digests.json, for each encode its
configuration, clip, entry point, both packages' per-frame digests and
their seconds, and exits 1 if the two packages' access units or recon
differ on a frame of an encode that REFERENCE_DIFFERS does not explain
(where it does, the entry says which frames differ and why). ``--only``
recomputes the named encodes and keeps the others from the existing file.
Each encode runs in a process of its own (``--jobs`` at a time); with the
default 3 the whole file takes about 30 minutes on 8 cores (the port's
3840x2160 batch alone about 12) and up to 20 GB of memory.

The reference runs the 3840x2160 batch one frame a batch (its jitted
search of three such frames holds every intermediate at once); the port
runs it as chip_smoke.py does, three frames in one batch. Neither the port
nor chip_smoke.py imports this script.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

FIXTURE = os.path.join(ROOT, cs.CTC_FIXTURE)
# frames a dispatch_frames_search batch of the reference takes, where it
# differs from the port's
REF_BATCH = {"2160p ai10 q22": 1}
# the order the port's jobs start in (the longest first; the reference's
# in reverse)
ORDER = ("2160p ai10 q22", "1080p ra8 q27", "1080p ld10 q27",
         "1080p default q27", "1080p lowdelay q22", "1080p lowdelay q37",
         "1080p allintra q22", "1080p allintra q37")
# encodes whose P frames the two packages code differently, and why: the
# entry keeps both packages' digests, the card is held to the port's
REFERENCE_DIFFERS = {
    "1080p ld10 q27": (
        "K9a's full-pel cost b2 - 2 corr + r2 in float32: at 10 bits each "
        "term reaches 2.7e8 (an ulp of 16-32) while the SSD it leaves is "
        "hundreds, so the cost's low bits are rounding. The reference sums "
        "corr and r2 in its float32 convolution's order; the port rounds "
        "exact integer sums once. On this P frame 928 of 8040 16x16 and "
        "102 of 32400 8x8 blocks take another full-pel MV, and on equal "
        "MVs K6's float32 costs differ by up to one ulp "
        "(tools/k9a_rounding.py); each package's cost lies within its "
        "rounding of the exact SSD (tests/test_torch_e2e_sizes.py; "
        "ROADMAP queue 3)"),
}
_REF_CACHES: dict = {}


def jax_api():
    """The JAX package's classes for chip_smoke.ctc_encode."""
    from uvg266_tpu.control.encoder import Encoder, FramePlanes, SliceEncoder
    from uvg266_tpu.control.params import EncoderControl, FrameState
    return {"Encoder": Encoder, "SliceEncoder": SliceEncoder,
            "FramePlanes": FramePlanes, "EncoderControl": EncoderControl,
            "FrameState": FrameState}


def jax_config(cfg):
    """The JAX package's Config with every field of the port's ``cfg``."""
    from uvg266_tpu.cfg import Config
    return Config(**{f.name: getattr(cfg, f.name)
                     for f in dataclasses.fields(cfg)})


def digests(pkg, label, w=None, h=None, n=None, batch=None):
    """Per-frame digests of phase-12 encode ``label`` (at w x h and over
    its first n frames if given) through ``pkg``: "port" (device="cpu") or
    "jax" (the reference on the CPU, with the jit cache of the encode's
    bit depth)."""
    cfg = cs.ctc_config(label, w, h)
    frames = cs.ctc_clip(cfg.width, cfg.height, n or cs.CTC[label][2],
                         cfg.input_bitdepth)
    entry = cs.CTC[label][3]
    if pkg == "port":
        return cs.frame_digests(
            cs.ctc_encode(cs.port_api("cpu"), cfg, frames, entry, batch), cfg)
    import uvg266_tpu.control.encoder as ref_encoder
    saved = ref_encoder._JIT_CACHE
    ref_encoder._JIT_CACHE = _REF_CACHES.setdefault(cfg.input_bitdepth, {})
    try:
        return cs.frame_digests(cs.ctc_encode(
            jax_api(), jax_config(cfg), frames, entry, batch), cfg)
    finally:
        ref_encoder._JIT_CACHE = saved


def _job(label, pkg, threads):
    """One encode in a process of its own -> (label, pkg, digests, s)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import torch
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    got = digests(pkg, label,
                  batch=REF_BATCH.get(label) if pkg == "jax" else None)
    return label, pkg, got, time.perf_counter() - t0


def versions():
    import jax
    import numpy
    import torch
    return {"python": platform.python_version(), "numpy": numpy.__version__,
            "torch": torch.__version__, "jax": jax.__version__}


def differing_frames(port, ref):
    """The frames whose digests differ between the packages."""
    return [i for i, (a, b) in enumerate(zip(port, ref)) if a != b]


def disagreements(label, port, ref):
    """Where the two packages' digests of ``label`` differ and no reason
    is recorded (REFERENCE_DIFFERS)."""
    n = cs.CTC[label][2]
    if len(port) != n or len(ref) != n:
        return [f"{label}: {len(port)} and {len(ref)} frames of {n}"]
    if label in REFERENCE_DIFFERS:
        return []
    return [f"{label} frame {i}: port {port[i]} != JAX {ref[i]}"
            for i in differing_frames(port, ref)]


def entry_record(label, port, ref, secs):
    """The fixture's entry for one encode."""
    cfg = cs.ctc_config(label)
    name, qp, n, entry, w, h = cs.CTC[label]
    out = {"configuration": name, "qp": qp, "frames": n, "entry": entry,
           "width": w, "height": h, "bitdepth": cfg.input_bitdepth,
           "config": dataclasses.asdict(cfg),
           "reference_batch": REF_BATCH.get(label, n if entry == "batch"
                                            else None),
           "seconds": secs, "port": port, "jax": ref}
    differ = differing_frames(port, ref)
    if differ:
        out["reference_differs"] = {"frames": differ,
                                    "why": REFERENCE_DIFFERS[label]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--only", nargs="*", choices=sorted(cs.CTC))
    args = ap.parse_args(argv)
    labels = [k for k in ORDER if not args.only or k in args.only]
    threads = max(1, (os.cpu_count() or 8) // args.jobs)
    # the two largest encodes (the 3840x2160 batch) first and last
    jobs = ([(k, "port", threads) for k in labels]
            + [(k, "jax", threads) for k in reversed(labels)])
    got: dict = {}
    with multiprocessing.get_context("spawn").Pool(
            args.jobs, maxtasksperchild=1) as pool:
        for label, pkg, dg, secs in pool.imap_unordered(_star, jobs):
            got.setdefault(label, {})[pkg] = (dg, secs)
            print(f"{label} {pkg}: {len(dg)} frames in {secs:.1f} s",
                  flush=True)
    old = {}
    if os.path.exists(FIXTURE):
        with open(FIXTURE) as fh:
            old = json.load(fh)["encodes"]
    encodes, bad = {}, []
    for label in cs.CTC:
        if label in got:
            (port, sp), (ref, sj) = got[label]["port"], got[label]["jax"]
            bad += disagreements(label, port, ref)
            encodes[label] = entry_record(label, port, ref,
                                          {"port": round(sp, 1),
                                           "jax": round(sj, 1)})
        elif label in old:
            encodes[label] = old[label]
    out = {
        "made_by": "tools/ctc_digests.py",
        "clip": "uvg266_tpu_torch/tools/bdrate.py synth_clip(w, h, n, "
                "seed=7) (BDRATE_1080p.json's clip), planes as int32 "
                "shifted left by bitdepth - 8",
        "seed": 7,
        "port": "uvg266_tpu_torch, device='cpu' (the kernels' plain "
                "versions)",
        "reference": "uvg266_tpu with JAX_PLATFORMS=cpu, one jit cache "
                     "per bit depth",
        "digests": "au: SHA-256 of the access unit; recon: chip_smoke.py "
                   "recon_digest (the planes with dtype and shape); "
                   "rec_out: SHA-256 of what the CLI's --rec-out writes",
        "versions": versions(),
        "encodes": encodes,
    }
    with open(FIXTURE, "w") as fh:
        json.dump(out, fh, indent=1, default=str)
        fh.write("\n")
    print(f"wrote {FIXTURE}: {len(encodes)} encodes", flush=True)
    for b in bad:
        print(f"DISAGREE {b}", flush=True)
    return 1 if bad else 0


def _star(job):
    return _job(*job)


if __name__ == "__main__":
    sys.exit(main())

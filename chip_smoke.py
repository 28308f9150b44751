#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (uvg266_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each (or a few), any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build of the CUDA kernels from uvg266_tpu_torch/csrc/ (one nvcc per
     source, all at once), with the build time;
  3. each kernel of the all-intra search (K1 refs_blocks_grid, K2
     predict67, K3 satd67, K4 rd_cost), at the shapes of an 832x480 frame
     (the four classes 64x64 .. 8x8), held against its plain PyTorch
     version on the same card inputs (the frame, random and edge inputs at
     8 and 10 bits): integer outputs equal, rd costs equal (both sides run
     the same float32 operations in the same order: tolerance 0). Times
     from CUDA events, launches per frame and the least time the card
     could take (bytes over 3.35 TB/s or operations over 67 T/s);
  4. the main path: Encoder(cfg, device="cuda").feed/flush of a 10-frame
     832x480 all-intra QP22 clip (bench.py's configuration); every kernel
     counter must equal 4 x frames; wall fps and device busy time;
  5. the first frame encoded again on the CPU (plain versions): its access
     unit must be byte-identical to the card's;
  6. a 192x128 clip encoded on the card decodes through the port's oracle
     decoder to the encoder's reconstruction;
  7. a JSON line with each kernel's numbers, then the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

It imports nothing of JAX or the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

W, H, FRAMES, QP = 832, 480, 10, 22
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
OPS_PER_S = 67e12             # H100 SXM float32 rate outside the tensor cores,
                              # the table's entry nearest to int32 ALU work
REPLACES = {
    "refs_blocks_grid": "uvg266_tpu/ops/intra_batch.py:619",
    "predict67": "uvg266_tpu/ops/intra_batch.py:420",
    "satd67": "uvg266_tpu/ops/intra_batch.py:521",
    "rd_cost": "uvg266_tpu/ops/rd_cost.py:78",
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def synth_clip(w=W, h=H, frames=FRAMES):
    """bench.py's synthetic clip (seed 7), at any size."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(frames):
        y = (xx * 0.3 + yy * 0.2 + 40 * np.sin((xx + 3 * t) / 16.0)
             + 30 * np.cos((yy - 2 * t) / 11.0)
             + 20 * ((xx // 32 + yy // 32 + t) % 2))
        y = np.clip(y + rng.integers(-6, 6, (h, w)), 0, 255).astype(np.int32)
        u = np.clip(128 + 20 * np.sin((xx[::2, ::2] + 5 * t) / 24.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
        v = np.clip(128 + 20 * np.cos((yy[::2, ::2] + 4 * t) / 21.0)
                    + rng.integers(-3, 3, (h // 2, w // 2)), 0, 255).astype(np.int32)
        out.append((y, u, v))
    return out


def bench_config(Config, w=W, h=H):
    return Config(width=w, height=h, qp=QP, gop_len=0, intra_period=1,
                  sao_type=3, alf_type=0, deblock_enable=True,
                  rdoq_enable=False, signhide_enable=True, dep_quant=False,
                  wpp=False)


def time_ms(torch, fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def work(name, B, w, h, H_, W_):
    """(bytes, operations) the function must move/do for one class:
    each input read once, each output written once."""
    hw = w * h
    if name == "refs_blocks_grid":
        return (H_ * W_ + B * (780 + hw)) * 4, B * 2 * 195 * 4
    if name == "predict67":
        tables = 67 * hw * 12 + 67 * 8 + (w + h) * 4
        return B * 780 * 4 + tables + B * 67 * hw * 4, B * 67 * hw * 12
    if name == "satd67":
        n = 8 if (w >= 8 and h >= 8) else 4
        per = 1 + 2 * (n.bit_length() - 1) + 2
        return B * 67 * hw * 4 + B * hw * 4 + B * 67 * 4, B * 67 * hw * per
    # rd_cost: satds, the winning prediction and the source in; 12 B out;
    # four w*h*max(w,h) multiply-add passes
    return (B * 67 * 4 + 2 * B * hw * 4 + w * w + h * h + 67 * 4 + 16
            + B * 12, B * 2 * 2 * hw * (w + h))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: torch.cuda.is_available() is false")
    import uvg266_tpu_torch  # noqa: F401  (sets the TF32 policy)
    from uvg266_tpu_torch import kernels
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import (Encoder, FramePlanes,
                                                  SliceEncoder)
    from uvg266_tpu_torch.control.params import EncoderControl
    from uvg266_tpu_torch.control.partition import (PartitionSearch,
                                                    qp_to_lambda)
    from uvg266_tpu_torch.ops import intra_batch as ib
    from uvg266_tpu_torch.ops import rd_cost as rc
    from uvg266_tpu_torch.ops.tables import device_tables, frame_tables
    from uvg266_tpu_torch.oracle.decoder import decode_au

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # --- 1. the card --------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"phase 1 card: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, count {torch.cuda.device_count()}",
          flush=True)

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    secs = kernels.build()
    print(f"phase 2 build: {time.perf_counter() - t0:.3f} s wall, per kernel "
          + ", ".join(f"{k} {v:.3f} s" for k, v in secs.items()), flush=True)
    for name in kernels.SIGNATURES:
        usage = [ln.strip() for ln in kernels.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"  ptxas {name}: {' | '.join(usage)}", flush=True)

    # --- 3. each kernel against its plain version ---------------------------
    cfg = bench_config(Config)
    ctrl = EncoderControl(cfg)
    frames = synth_clip()
    probe = SliceEncoder(cfg, ctrl, device=dev)
    entries = probe._fused_entries(PartitionSearch(ctrl, cfg, qp=QP))
    classes = [(w, h, g) for (_k, w, h, _p, g) in entries]
    print("phase 3 classes: " + ", ".join(
        f"{w}x{h} B={g[4] * g[5]}" for (w, h, g) in classes), flush=True)
    gen = torch.Generator(device=dev).manual_seed(1234)
    err = dict.fromkeys(REPLACES, 0.0)
    ms = dict.fromkeys(REPLACES, 0.0)
    plain_ms = dict.fromkeys(REPLACES, 0.0)
    bytes_ = dict.fromkeys(REPLACES, 0)
    ops = dict.fromkeys(REPLACES, 0)
    checks = 0

    def same(name, what, a, b):
        nonlocal checks
        checks += 1
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name} {what}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        d = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        err[name] = max(err[name], d)
        if d != 0.0:
            fail(f"{name} {what}: kernel and plain version differ by {d}")

    frame_src = torch.from_numpy(frames[0][0]).to(dev)
    for (w, h, g) in classes:
        B = g[4] * g[5]
        for bd in (8, 10):
            mx = (1 << bd) - 1
            tabs = device_tables(w, h, bd, "cuda")
            planes = {"rand": torch.randint(0, mx + 1, (H, W), generator=gen,
                                            device=dev, dtype=torch.int32),
                      "edge": (((torch.arange(H, device=dev)[:, None] // 8
                                 + torch.arange(W, device=dev)[None] // 8) % 2)
                               * mx).to(torch.int32)}
            if bd == 8:
                planes["frame"] = frame_src
            for tag, src in planes.items():
                what = f"{w}x{h} {bd}-bit {tag}"
                refs, blocks = ib.refs_blocks_grid(src, w, h, g)
                pr, pb = ib.refs_blocks_grid_plain(src, w, h, g)
                same("refs_blocks_grid", what + " refs", refs, pr)
                same("refs_blocks_grid", what + " blocks", blocks, pb)
                ref_sets = {tag: refs}
                if tag == "rand":
                    ref_sets["rand refs"] = torch.randint(
                        0, mx + 1, refs.shape, generator=gen, device=dev,
                        dtype=torch.int32)
                for rtag, rr in ref_sets.items():
                    preds = ib.predict67(rr, tabs)
                    same("predict67", f"{w}x{h} {bd}-bit {rtag}", preds,
                         ib.predict67_plain(rr, tabs))
                    pairs = [(preds, blocks)]
                    if tag == "edge":
                        # largest residuals: int32 wrap of the 10-bit SSD
                        pairs.append((torch.zeros_like(preds),
                                      torch.full_like(blocks, mx)))
                    for k, (pp, bb) in enumerate(pairs):
                        wt = f"{w}x{h} {bd}-bit {rtag} #{k}"
                        satds = ib.satd67(pp, bb)
                        same("satd67", wt, satds, ib.satd67_plain(pp, bb))
                        for qp in (22, 37):
                            qps = qp + 6 * (bd - 8)
                            lam = float(np.float32(qp_to_lambda(qp)))
                            ft = frame_tables(qp, "cuda")
                            args = (pp, bb, satds, qps, lam, ft["wts"],
                                    ft["mode_bits"], tabs, bd)
                            got = rc.rd_cost(*args)
                            want = rc.rd_cost_plain(*args)
                            for o, (a, b) in zip(("best", "rd", "satd"),
                                                 zip(got, want)):
                                same("rd_cost", f"{wt} qp{qp} {o}", a, b)
        # times at the frame's inputs (8 bits, QP22), once per class
        tabs = device_tables(w, h, 8, "cuda")
        ft = frame_tables(QP, "cuda")
        lam = float(np.float32(qp_to_lambda(QP)))
        refs, blocks = ib.refs_blocks_grid(frame_src, w, h, g)
        preds = ib.predict67(refs, tabs)
        satds = ib.satd67(preds, blocks)
        rd_args = (preds, blocks, satds, QP, lam, ft["wts"], ft["mode_bits"],
                   tabs, 8)
        runs = {
            "refs_blocks_grid": (lambda: ib.refs_blocks_grid(frame_src, w, h, g),
                                 lambda: ib.refs_blocks_grid_plain(frame_src, w, h, g)),
            "predict67": (lambda: ib.predict67(refs, tabs),
                          lambda: ib.predict67_plain(refs, tabs)),
            "satd67": (lambda: ib.satd67(preds, blocks),
                       lambda: ib.satd67_plain(preds, blocks)),
            "rd_cost": (lambda: rc.rd_cost(*rd_args),
                        lambda: rc.rd_cost_plain(*rd_args)),
        }
        for name, (kern, plain) in runs.items():
            k_ms = time_ms(torch, kern, 20)
            p_ms = time_ms(torch, plain, 3)
            b, o = work(name, B, w, h, H, W)
            ms[name] += k_ms
            plain_ms[name] += p_ms
            bytes_[name] += b
            ops[name] += o
            bound = max(b / HBM_BYTES_PER_S, o / OPS_PER_S) * 1e3
            print(f"  {name} {w}x{h}: {k_ms:.4f} ms kernel, {p_ms:.4f} ms "
                  f"plain, bound {bound:.4f} ms ({b} B, {o} ops)", flush=True)
        del refs, blocks, preds, satds, rd_args, runs
    print(f"phase 3 kernels: {checks} comparisons, all equal", flush=True)

    # --- 4. the main path ---------------------------------------------------
    clip = [FramePlanes(*f) for f in frames]
    warm = Encoder(cfg, device=dev)          # native build, tables, buffers
    for f in clip[:2]:
        warm.feed(f)
    warm.flush()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    enc = Encoder(cfg, device=dev)
    outs = []
    for f in clip:
        outs.extend(enc.feed(f))
    outs.extend(enc.flush())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if len(outs) != FRAMES:
        fail(f"main path returned {len(outs)} of {FRAMES} frames")
    for name, n in launches.items():
        if n != 4 * FRAMES:
            fail(f"main path launched {name} {n} times, expected {4 * FRAMES}")
    for au, rec, _fs, _refs, _src in outs:
        if not au or rec.y.shape != (H, W) or not np.isfinite(rec.y).all():
            fail("main path produced an empty AU or a malformed recon")
    total_bytes = sum(len(o[0]) for o in outs)
    print(f"phase 4 main path: {FRAMES} frames {W}x{H} QP{QP} in {wall:.3f} s "
          f"= {FRAMES / wall:.3f} fps wall, {total_bytes} bytes, launches "
          + json.dumps(launches), flush=True)
    prof_act = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=prof_act) as prof:
        t0 = time.perf_counter()
        enc2 = Encoder(cfg, device=dev)
        for f in clip:
            enc2.feed(f)
        enc2.flush()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.name] = busy.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(busy.values())
    if busy_ms > 0:
        top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
        print(f"  device busy {busy_ms:.3f} ms of {pwall * 1e3:.3f} ms "
              f"profiled wall ({busy_ms / (pwall * 1e3):.4f} busy share); "
              + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top), flush=True)
    else:
        print("  device busy: not measured (the profiler saw no device "
              "events)", flush=True)

    # --- 5. the card against the CPU ----------------------------------------
    cpu = Encoder(cfg, device="cpu")
    cpu_out = cpu.feed(clip[0]) + cpu.flush()
    if cpu_out[0][0] != outs[0][0]:
        fail("frame 0: the card's access unit differs from the CPU's")
    if not np.array_equal(cpu_out[0][1].y, outs[0][1].y):
        fail("frame 0: the card's recon differs from the CPU's")
    print(f"phase 5 card vs CPU: frame 0 access unit byte-identical "
          f"({len(outs[0][0])} bytes)", flush=True)

    # --- 6. a small clip through the oracle decoder -------------------------
    scfg = bench_config(Config, 192, 128)
    senc = Encoder(scfg, device=dev)
    sout = []
    for f in synth_clip(192, 128, 2):
        sout.extend(senc.feed(FramePlanes(*f)))
    sout.extend(senc.flush())
    for au, rec, fs, _refs, _src in sout:
        dec, info = decode_au(au, scfg, senc.ctrl, fs)
        if not info["headers_ok"] or info["checksum_ok"] is not True:
            fail(f"oracle: headers_ok {info['headers_ok']}, checksum_ok "
                 f"{info['checksum_ok']}")
        for p in ("y", "u", "v"):
            if not np.array_equal(getattr(dec, p), getattr(rec, p)):
                fail(f"oracle: decoded {p} differs from the encoder's recon")
    print(f"phase 6 oracle: {len(sout)} frames 192x128 decode to the "
          "encoder's recon", flush=True)

    # --- 7. results ---------------------------------------------------------
    rows = []
    for name in REPLACES:
        t_bytes = bytes_[name] / HBM_BYTES_PER_S
        t_ops = ops[name] / OPS_PER_S
        rows.append({
            "name": name, "route": "cuda",
            "source": f"uvg266_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": err[name],
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

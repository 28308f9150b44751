"""CLI encoder: raw YUV 4:2:0 -> VVC Annex-B bitstream.

The user-facing analogue of the reference CLI (uvg266's encmain.c,
cli.c): uvg266-compatible core options, the same as the JAX package's
uvg266_tpu.tools.encode. The search runs on the CUDA device unless
--device cpu asks for the kernels' plain versions.

Usage:
  python -m uvg266_tpu_torch.tools.encode -i in.yuv --input-res 352x288 \
      -o out.vvc [--qp 27] [--frames 10] [--preset ultrafast] [--verify] \
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..cfg import Config
from ..consts import SliceType
from ..control.encoder import Encoder, FramePlanes
from ..oracle.decoder import decode_au


def parse_y4m_header(f):
    """Parse a YUV4MPEG2 stream header; returns (w, h, bitdepth)
    (encmain.c:349-421)."""
    hdr = b""
    while not hdr.endswith(b"\n"):
        c = f.read(1)
        if not c:
            raise ValueError("truncated y4m header")
        hdr += c
    fields = hdr.decode().strip().split(" ")
    if fields[0] != "YUV4MPEG2":
        raise ValueError("not a y4m stream")
    w = h = 0
    bitdepth = 8
    for tok in fields[1:]:
        if tok.startswith("W"):
            w = int(tok[1:])
        elif tok.startswith("H"):
            h = int(tok[1:])
        elif tok.startswith("C"):
            if tok.startswith("C420p10"):
                bitdepth = 10
            elif not tok.startswith("C420"):
                raise ValueError(f"unsupported y4m chroma '{tok}'")
    if not (w and h):
        raise ValueError("y4m header missing W/H")
    return w, h, bitdepth


def read_y4m_frames(path: str, max_frames: int | None):
    """Yield FramePlanes from a .y4m file (FRAME-delimited)."""
    with open(path, "rb") as f:
        w, h, bitdepth = parse_y4m_header(f)
        ysz, csz = w * h, (w // 2) * (h // 2)
        dt = np.uint8 if bitdepth == 8 else np.dtype("<u2")
        bpp = 1 if bitdepth == 8 else 2
        n = 0
        while max_frames is None or n < max_frames:
            line = b""
            while not line.endswith(b"\n"):
                c = f.read(1)
                if not c:
                    return
                line += c
            if not line.startswith(b"FRAME"):
                raise ValueError("bad y4m frame marker")
            raw = f.read((ysz + 2 * csz) * bpp)
            if len(raw) < (ysz + 2 * csz) * bpp:
                return
            y = np.frombuffer(raw, dtype=dt, count=ysz).reshape(h, w)
            u = np.frombuffer(raw, dtype=dt, count=csz,
                              offset=ysz * bpp).reshape(h // 2, w // 2)
            v = np.frombuffer(raw, dtype=dt, count=csz,
                              offset=(ysz + csz) * bpp).reshape(h // 2, w // 2)
            yield FramePlanes(y.astype(np.int32), u.astype(np.int32),
                              v.astype(np.int32))
            n += 1


def read_yuv_frames(path: str, w: int, h: int, max_frames: int | None,
                    bitdepth: int = 8):
    """Yield FramePlanes from a planar YUV420 file, 8-bit or 10-bit LE
    (yuv_io.c:49)."""
    ysz, csz = w * h, (w // 2) * (h // 2)
    dt = np.uint8 if bitdepth == 8 else np.dtype("<u2")
    bpp = 1 if bitdepth == 8 else 2
    frame_bytes = (ysz + 2 * csz) * bpp
    with open(path, "rb") as f:
        n = 0
        while max_frames is None or n < max_frames:
            raw = f.read(frame_bytes)
            if len(raw) < frame_bytes:
                return
            y = np.frombuffer(raw, dtype=dt, count=ysz).reshape(h, w)
            u = np.frombuffer(raw, dtype=dt, count=csz,
                              offset=ysz * bpp).reshape(h // 2, w // 2)
            v = np.frombuffer(raw, dtype=dt, count=csz,
                              offset=(ysz + csz) * bpp).reshape(h // 2, w // 2)
            yield FramePlanes(y.astype(np.int32), u.astype(np.int32),
                              v.astype(np.int32))
            n += 1


def psnr(a: np.ndarray, b: np.ndarray, bitdepth: int = 8) -> float:
    mx = (1 << bitdepth) - 1
    mse = ((a.astype(np.int64) - b.astype(np.int64)) ** 2).mean()
    return 10 * np.log10(mx * mx / max(mse, 1e-12))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="uvg266-gpu")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--input-res", default=None,
                   help="WxH (not needed for .y4m input)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-q", "--qp", type=int, default=22)
    p.add_argument("-n", "--frames", type=int, default=None)
    p.add_argument("-p", "--period", type=int, default=64,
                   help="intra period; 1 = all intra (uvg266 -p)")
    p.add_argument("--ref", type=int, default=1, help="number of reference frames")
    p.add_argument("--input-bitdepth", type=int, default=8, choices=(8, 10))
    p.add_argument("--bitrate", type=int, default=0,
                   help="target bitrate (bps); 0 = fixed QP")
    p.add_argument("--me", default="hexbs",
                   choices=("hexbs", "full"),
                   help="integer ME: hexbs = host C++ hexagon search "
                        "with predictor seeding (default), full = dense "
                        "device search")
    p.add_argument("--me-steps", type=int, default=-1,
                   help="hexbs iteration / range cap (-1 = auto 32)")
    p.add_argument("--vaq", type=int, default=0,
                   help="variance adaptive quantization strength "
                        "(per-CTU QP offsets via cu_qp_delta)")
    p.add_argument("--rc-algorithm", default="lambda",
                   choices=("lambda", "oba"),
                   help="rate control model (R-lambda or frame-level OBA)")
    p.add_argument("--gop", default="lp",
                   help="GOP structure: lp (low-delay) or ra8 (B-pyramid)")
    p.add_argument("--no-psnr", action="store_true")
    p.add_argument("--verify", action="store_true",
                   help="decode each AU with the conformance oracle")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run the search kernels on the CUDA device "
                        "(default; fails without one) or their plain "
                        "PyTorch versions on the CPU")
    p.add_argument("--closed-loop", action="store_true",
                   help="sequential reference-faithful mode search")
    p.add_argument("--tiles", default=None, metavar="CxR",
                   help="tile grid, e.g. 2x2 (uvg266 --tiles); each tile "
                        "is an independent CABAC substream")
    p.add_argument("--slices", default=None, choices=["tiles"],
                   help="put each tile in its own slice NAL "
                        "(requires --tiles)")
    p.add_argument("--wpp", action="store_true",
                   help="wavefront parallel processing substreams")
    p.add_argument("--rdoq", action="store_true",
                   help="rate-distortion optimized quantization")
    p.add_argument("--alf", nargs="?", const="on", default=None,
                   choices=("on", "full"),
                   help="adaptive loop filter; 'full' adds CC-ALF")
    p.add_argument("--cclm", action="store_true",
                   help="cross-component linear model chroma prediction")
    p.add_argument("--btt", action="store_true",
                   help="binary-tree partition search (one MTT level)")
    p.add_argument("--trskip", action="store_true",
                   help="transform skip (screen content; up to 8x8 TUs)")
    p.add_argument("--lfnst", action="store_true",
                   help="low-frequency non-separable secondary transform")
    p.add_argument("--mip", action="store_true",
                   help="matrix-based intra prediction")
    p.add_argument("--isp", action="store_true",
                   help="intra sub-partitions (2/4 sequential luma sub-TUs)")
    p.add_argument("--mts", choices=["off", "intra", "inter", "both",
                                     "implicit"], default=None,
                   help="multiple transform selection (DST7/DCT8 sets)")
    p.add_argument("--ibc", type=int, choices=[0, 1, 2], default=None,
                   help="intra block copy (2 = with hash search)")
    p.add_argument("--lmcs", action="store_true",
                   help="luma mapping with chroma scaling (reshaper)")
    p.add_argument("--jccr", action="store_true",
                   help="joint Cb-Cr residual coding")
    p.add_argument("--mrl", action="store_true",
                   help="multi-reference-line intra prediction")
    p.add_argument("--dual-tree", action="store_true",
                   help="separate luma/chroma coding trees in intra slices")
    p.add_argument("--preset", default=None,
                   choices=("ultrafast", "superfast", "veryfast", "faster",
                            "fast", "medium", "slow", "slower", "veryslow",
                            "placebo"),
                   help="tool preset (uvg266 --preset); explicit tool "
                        "flags override the preset. Tools the framework "
                        "does not implement yet (ISP) are dropped from "
                        "the preset with a warning")
    p.add_argument("--sao", default="full",
                   choices=("off", "edge", "band", "full"),
                   help="sample adaptive offset mode (uvg266 --sao)")
    p.add_argument("--no-sao", action="store_true",
                   help="disable SAO (alias for --sao off)")
    p.add_argument("--no-deblock", action="store_true",
                   help="disable the deblocking filter")
    p.add_argument("--deblock", default="0:0", metavar="BETA:TC",
                   help="deblock offsets beta:tc (uvg266 --deblock)")
    p.add_argument("--no-tmvp", action="store_true",
                   help="disable temporal motion vector prediction")
    p.add_argument("--no-signhide", action="store_true",
                   help="disable sign-data hiding")
    p.add_argument("--scaling-list", default="off",
                   choices=("off", "custom", "default"),
                   help="quant matrices: built-in defaults or --cqmfile")
    p.add_argument("--cqmfile", default=None,
                   help="custom quant matrix file (HM/uvg266 format)")
    p.add_argument("--dep-quant", action="store_true",
                   help="dependent quantization (trellis; experimental "
                        "rate model)")
    p.add_argument("--rec-out", default=None,
                   help="write the reconstruction as planar YUV to this "
                        "path (encmain.c recon output)")
    p.add_argument("--stats-file", default=None,
                   help="write per-frame stats (JSON lines: poc, type, qp, "
                        "bits, PSNR, the host's ms by stage and by tool, the "
                        "bytes copied to and from the device) to this "
                        "path")
    p.add_argument("--threads", type=int, default=1,
                   help="host frame-pipeline width for all-intra encodes "
                        "(the OWF analogue; native phases release the GIL)")
    return p


def build_config(args: argparse.Namespace, w: int, h: int) -> Config:
    """The Config the CLI encodes a w x h input with: the preset's tools
    (filtered to implemented Config fields), then the explicit flags."""
    db_beta, db_tc = (int(t) for t in args.deblock.split(":"))
    all_intra = args.period == 1
    ra = args.gop == "ra8" and not all_intra
    kw = {}
    if args.preset:
        import dataclasses

        from ..cfg import PRESETS
        valid = {f.name for f in dataclasses.fields(Config)}
        for k, v in PRESETS[args.preset].items():
            if k in valid:
                kw[k] = v
    # explicit flags win over the preset baseline
    if args.no_sao or args.sao != "full":
        kw["sao_type"] = 0 if args.no_sao else             {"off": 0, "edge": 1, "band": 2, "full": 3}[args.sao]
    elif "sao_type" not in kw:
        kw["sao_type"] = 3
    if args.alf is not None:
        kw["alf_type"] = {"on": 1, "full": 2}[args.alf]
    if args.cclm:
        kw["cclm"] = 1
    if args.dual_tree:
        kw["dual_tree"] = 1
    if args.btt:
        kw["max_btt_depth"] = (1, 1, 1)
    if args.trskip:
        kw["trskip_enable"] = True
        kw["trskip_max_size"] = 3
    if args.lfnst:
        kw["lfnst"] = True
    if args.mip:
        kw["mip"] = True
    if args.isp:
        kw["isp"] = True
    if args.mts is not None:
        kw["mts"] = {"off": 0, "intra": 1, "inter": 2, "both": 3,
                     "implicit": 4}[args.mts]
    if args.ibc is not None:
        kw["ibc"] = args.ibc
    if args.mrl:
        kw["mrl"] = True
    if args.jccr:
        kw["jccr"] = 1
    if args.lmcs:
        kw["lmcs_enable"] = True
    if args.no_deblock:
        kw["deblock_enable"] = False
    else:
        kw.setdefault("deblock_enable", True)
    kw["deblock_beta"] = db_beta
    kw["deblock_tc"] = db_tc
    if args.rdoq:
        kw["rdoq_enable"] = True
    elif "rdoq_enable" not in kw:
        kw["rdoq_enable"] = False
    if args.dep_quant:
        kw["dep_quant"] = True
    if args.no_signhide or kw.get("dep_quant"):
        kw["signhide_enable"] = False
    elif "signhide_enable" not in kw:
        kw["signhide_enable"] = True
    if args.scaling_list != "off":
        kw["scaling_list"] = {"custom": 1, "default": 2}[args.scaling_list]
    if args.slices == "tiles":
        kw["slices"] = 1
    if args.wpp:
        kw["wpp"] = True
    else:
        # Config defaults wpp on (the uvg266 default); the CLI keeps it
        # opt-in unless a preset asks for it
        kw.setdefault("wpp", False)
    if ra:
        kw["ref_frames"] = 4
    elif args.ref != 1:
        kw["ref_frames"] = args.ref
    else:
        kw.setdefault("ref_frames", args.ref)
    cfg = Config(width=w, height=h, qp=args.qp,
                 input_bitdepth=args.input_bitdepth,
                 gop_len=0 if all_intra else (8 if ra else 4),
                 gop_lowdelay=not ra, intra_period=args.period,
                 bipred=1 if ra else 0,
                 tmvp_enable=not all_intra and not args.no_tmvp,
                 target_bitrate=args.bitrate,
                 vaq=args.vaq,
                 ime_algorithm=0 if args.me == "hexbs" else 2,
                 me_max_steps=args.me_steps,
                 stats_audit=bool(args.stats_file),
                 rc_algorithm=args.rc_algorithm,
                 cqmfile=args.cqmfile,
                 **kw)
    if args.tiles:
        tc, tr = (int(t) for t in args.tiles.split("x"))
        cfg.tiles_width_count = tc
        cfg.tiles_height_count = tr
    return cfg


def cli_config(flags: list, w: int, h: int) -> Config:
    """The Config ``uvg266-gpu <flags>`` encodes a w x h input with
    (flags without the input and output)."""
    args = _parser().parse_args(["-i", "in.yuv", "-o", "out.vvc", *flags])
    return build_config(args, w, h)


def main(argv=None) -> int:
    p = _parser()
    args = p.parse_args(argv)
    if args.scaling_list == "custom" and not args.cqmfile:
        p.error("--scaling-list=custom does not work without "
                "--cqmfile=<FILE>")
    if args.scaling_list == "custom":
        from ..ops.scaling_lists import ScalingLists
        try:
            ScalingLists.from_file(args.cqmfile)
        except (OSError, ValueError) as e:
            p.error(f"--cqmfile: {e}")

    is_y4m = args.input.endswith(".y4m")
    if is_y4m:
        with open(args.input, "rb") as f:
            w, h, y4m_bd = parse_y4m_header(f)
        args.input_bitdepth = y4m_bd
    else:
        if not args.input_res:
            p.error("--input-res is required for raw YUV input")
        try:
            w, h = (int(t) for t in args.input_res.split("x"))
        except ValueError:
            p.error(f"--input-res must be WxH, got '{args.input_res}'")
    try:
        _beta, _tc = (int(t) for t in args.deblock.split(":"))
    except ValueError:
        p.error(f"--deblock must be BETA:TC, got '{args.deblock}'")
    if args.tiles:
        try:
            _cols, _rows = (int(t) for t in args.tiles.split("x"))
        except ValueError:
            p.error(f"--tiles must be CxR, got '{args.tiles}'")
    cfg = build_config(args, w, h)
    all_intra = args.period == 1
    enc = Encoder(cfg, device=args.device)
    enc.slice_enc.open_loop = not args.closed_loop

    t0 = time.time()
    total_bits = 0
    n = 0
    psnrs = []
    from ..control.encoder import RefLists
    dec_dpb: dict = {}
    dec_aps: dict = {}

    stats_f = open(args.stats_file, "w") if args.stats_file else None
    if stats_f is not None:
        from .. import trace
        trace.start()
    rec_f = open(args.rec_out, "wb") if args.rec_out else None

    def frame_source():
        if is_y4m:
            return read_y4m_frames(args.input, args.frames)
        return read_yuv_frames(args.input, w, h, args.frames,
                               args.input_bitdepth)

    def handle(result):
        nonlocal total_bits, n
        au, rec, fs, rl, src = result
        out.write(au)
        total_bits += len(au) * 8
        if stats_f is not None:
            import json
            bd = cfg.input_bitdepth
            line = {
                "poc": fs.poc, "num": fs.num,
                "type": "I" if fs.slicetype == SliceType.I
                else ("B" if fs.slicetype == 0 else "P"),
                "qp": fs.qp, "bits": len(au) * 8,
                "psnr_y": round(psnr(rec.y[:h, :w], src.y, bd), 4),
            }
            # per-CTU QP + bits (cu_qp_delta streams: VAQ / per-LCU RC;
            # the reference's --stats-file-prefix analog,
            # rate_control.c:107-116)
            ctu_qps = getattr(fs, "ctu_qps", None)
            if ctu_qps is not None:
                line["ctu_qp"] = [int(q) for q in ctu_qps]
            ctu_bits = getattr(fs, "ctu_bits", None)
            if ctu_bits is not None:
                line["ctu_bits"] = [int(b) for b in ctu_bits]
            # bits audit: model-estimated coefficient bits vs the real
            # CABAC AU bits (est/actual drift localizes calibration bugs
            # like the equal-QP LD inflation; round-2 ask #1b)
            est = getattr(fs, "est_coeff_bits", None)
            if est is not None:
                line["est_coeff_bits"] = round(est, 1)
                line["est_vs_actual"] = round(est / max(len(au) * 8, 1), 4)
            # the frame's stage spans and counters (uvg266_tpu_torch.trace),
            # taken out of the tracer so that its records do not grow
            line.update(trace.summary(trace.drain(fs.num)))
            stats_f.write(json.dumps(line) + "\n")
        if args.verify:
            pocs0 = [fs.poc - d for d in fs.ref_pocs_neg]
            pocs1 = [fs.poc + d for d in fs.ref_pocs_pos] or list(pocs0)
            if fs.slicetype == SliceType.I:
                dec_dpb.clear()
            orl = RefLists(l0=[dec_dpb[q] for q in pocs0],
                           l1=[dec_dpb[q] for q in pocs1],
                           pocs0=pocs0, pocs1=pocs1)
            dec_rec, info = decode_au(au, cfg, enc.ctrl, fs, refs=orl,
                                      aps_pool=dec_aps)
            assert info["checksum_ok"], f"poc {fs.poc}: oracle checksum FAILED"
            assert np.array_equal(dec_rec.y, rec.y), f"poc {fs.poc}: recon mismatch"
            dec_dpb[fs.poc] = dec_rec
        if rec_f is not None:
            bd = cfg.input_bitdepth
            dt = np.uint8 if bd == 8 else np.dtype("<u2")
            for pl, (ph, pw) in ((rec.y, (h, w)), (rec.u, (h // 2, w // 2)),
                                 (rec.v, (h // 2, w // 2))):
                if pl is not None:
                    rec_f.write(pl[:ph, :pw].astype(dt).tobytes())
        if not args.no_psnr:
            bd = cfg.input_bitdepth
            psnrs.append((psnr(rec.y[:h, :w], src.y, bd),
                          psnr(rec.u[:h // 2, :w // 2], src.u, bd),
                          psnr(rec.v[:h // 2, :w // 2], src.v, bd)))
        n += 1

    with open(args.output, "wb") as out:
        if all_intra and args.threads > 1:
            # host frame pipeline: N workers encode independent intra
            # frames concurrently (native phases release the GIL); one
            # SliceEncoder per worker, results written back in order
            from concurrent.futures import ThreadPoolExecutor

            from ..control.encoder import FramePlanes, SliceEncoder
            from ..control.params import FrameState
            nw = args.threads
            workers = [enc.slice_enc] + [SliceEncoder(cfg, enc.ctrl,
                                                      device=args.device)
                                         for _ in range(nw - 1)]
            srcs = list(frame_source())

            def encode_one(idx_src):
                i, src = idx_src
                e = workers[i % nw]
                fs = FrameState(num=i, qp=cfg.qp)
                pre = e.dispatch_frame_search(fs, src)
                au, rec = e.encode_frame(fs, src, prefetch=pre)
                return (au, rec, fs, RefLists([], [], [], []), src)

            with ThreadPoolExecutor(nw) as ex:
                for result in ex.map(encode_one, enumerate(srcs)):
                    handle(result)
        else:
            for i, src in enumerate(frame_source()):
                for result in enc.feed(src):
                    handle(result)
            for result in enc.flush():
                handle(result)
    dt = time.time() - t0
    if stats_f is not None:
        trace.stop()
        stats_f.close()
    if rec_f is not None:
        rec_f.close()
    if n == 0:
        print("no frames read", file=sys.stderr)
        return 1
    print(f" Processed {n} frames, {total_bits} bits",
          f"AVG PSNR Y {np.mean([p[0] for p in psnrs]):2.4f}"
          f" U {np.mean([p[1] for p in psnrs]):2.4f}"
          f" V {np.mean([p[2] for p in psnrs]):2.4f}" if psnrs else "")
    print(f" Total time: {dt:.3f} s ({n / dt:.3f} fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""In-repo conformance oracle: decode the encoder's bitstream back to pixels.

No VTM binary exists in this environment (the reference's e2e oracle,
tests/util.sh:53), so this module plays that role: it parses the produced
Annex-B stream with an independent spec-mirror CABAC/syntax decoder
(shared context model, separate parsing logic), reconstructs the frame,
and checks the decoded-picture-hash SEI. Tests assert the reconstruction
matches the encoder's exactly.

Header NALs (SPS/PPS/slice header) are verified by byte comparison against
regenerated writers; full header *parsing* is a later milestone.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.bitwriter import (Bitstream, BitstreamReader,
                                   strip_emulation_prevention)
from ..bitstream.cabac import CabacDecoder
from ..consts import LCU_WIDTH, NalType
from ..control.encoder import FramePlanes, reconstruct_intra_cu
from ..control.params import EncoderControl, FrameState
from ..hls import headers
from ..hls.coding_tree import CodingTreeReader


@dataclass
class Nal:
    type: int
    temporal_id: int
    payload: bytes      # raw payload (escapes NOT yet removed)


def split_nals(data: bytes) -> list[Nal]:
    """Split an Annex-B byte stream into NAL units."""
    nals = []
    i = 0
    n = len(data)
    starts = []
    while i + 3 <= n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # trim trailing zero_bytes belonging to the next start code
        while e > s and data[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        hdr0, hdr1 = data[s], data[s + 1]
        nals.append(Nal(type=(hdr1 >> 3) & 31, temporal_id=(hdr1 & 7) - 1,
                        payload=data[s + 2:e]))
    return nals


def _escaped_len(payload: bytes, rbsp_len: int) -> int:
    """Escaped-domain byte count consuming exactly rbsp_len RBSP bytes."""
    zeros = 0
    consumed = 0
    i = 0
    while consumed < rbsp_len and i < len(payload):
        b = payload[i]
        if zeros >= 2 and b == 0x03 and i + 1 < len(payload) \
                and payload[i + 1] <= 0x03:
            zeros = 0
            i += 1
            continue
        zeros = zeros + 1 if b == 0 else 0
        consumed += 1
        i += 1
    return i


def expected_parameter_sets(ctrl: EncoderControl) -> bytes:
    bs = Bitstream()
    headers.write_parameter_sets(bs, ctrl)
    return bs.bytes()


def decode_au(data: bytes, cfg, ctrl: EncoderControl, fs: FrameState,
              refs: list | None = None,
              aps_pool: dict | None = None):
    """Decode one access unit; returns (recon FramePlanes, info dict).

    refs: DPB (list of FramePlanes) for P slices, list-0 order.
    aps_pool: persistent {aps_id: AlfFrameParams} across AUs — required
    to decode sequences using encode-side temporal ALF APS reuse."""
    from ..control.encoder import RefLists
    refs = refs or []
    if isinstance(refs, list):
        rl = RefLists.from_single(refs, fs)
    else:
        rl = refs
    nals = split_nals(data)
    info = {"nal_types": [n.type for n in nals], "checksum_ok": None,
            "headers_ok": True, "scaling_aps": False}

    # verify parameter sets byte-exact (first AU)
    if any(n.type == NalType.SPS_NUT for n in nals):
        exp = expected_parameter_sets(ctrl)
        got = Bitstream()
        for n in nals:
            if n.type in (NalType.SPS_NUT, NalType.PPS_NUT):
                got.write_byte_raw(0)
                got.write_byte_raw(0)
                got.write_byte_raw(0)
                got.write_byte_raw(1)
                got.write_byte_raw(0)
                got.write_byte_raw((n.type << 3) + n.temporal_id + 1)
                for b in n.payload:
                    got.write_byte_raw(b)
        info["headers_ok"] = got.bytes() == exp

    slice_nal = next(n for n in nals
                     if n.type <= NalType.GDR_NUT)  # VCL NAL
    rbsp = strip_emulation_prevention(slice_nal.payload)

    # verify the slice header by regeneration, then locate the CABAC payload
    tiles_mode = ctrl.tiles_enable
    wpp_mode = cfg.wpp and ctrl.height_in_lcu > 1 and not tiles_mode
    multi_sub = wpp_mode or tiles_mode
    n_tiles = cfg.tiles_width_count * cfg.tiles_height_count
    hdr_bs = Bitstream()
    if not multi_sub:
        headers.write_slice_header(hdr_bs, ctrl, fs)
        hdr_bytes = strip_emulation_prevention(hdr_bs.bytes())
        if rbsp[:len(hdr_bytes)] != hdr_bytes:
            raise ValueError("slice header mismatch vs regenerated header")
    else:
        # fixed part only; entry points are parsed below
        headers.write_slice_header_fixed(hdr_bs, ctrl, fs)
        nbits = hdr_bs.tell()
        hdr_bs.align_zero()
        nfull = nbits // 8
        probe_prefix = strip_emulation_prevention(hdr_bs.bytes())[:nfull]
        if rbsp[:nfull] != probe_prefix:
            raise ValueError("slice header (fixed part) mismatch")
        hdr_bytes = b""

    is_intra_slice = fs.slicetype == 2
    ref_pocs = [rl.pocs0, rl.pocs1]
    wpp = wpp_mode
    entry_lengths = None
    if multi_sub:
        # parse entry point offsets from the slice header tail
        rd = BitstreamReader(rbsp)
        rd.pos = 0
        # skip over the fixed header part by regenerating it without the
        # entry-point fields and measuring its bit length
        probe = Bitstream()
        headers.write_slice_header_fixed(probe, ctrl, fs)
        rd.pos = probe.tell()
        num_subs = n_tiles if tiles_mode else ctrl.height_in_lcu
        offset_len = rd.read_ue() + 1
        entry_lengths = [rd.read(offset_len) + 1 for _ in range(num_subs - 1)]
        # rbsp_trailing_bits: stop bit then zero padding to the boundary
        # (consuming it explicitly matters when the offsets end exactly on
        # a byte boundary — the stop bit then occupies a whole extra byte)
        if rd.read_bit() != 1:
            raise ValueError("missing rbsp stop bit after entry points")
        rd.byte_align()
        hdr_rbsp_len = rd.pos // 8
        # locate header end in the escaped payload
        hdr_esc_len = _escaped_len(slice_nal.payload, hdr_rbsp_len)
        payload_esc = slice_nal.payload[hdr_esc_len:]
        # split substreams in the escaped domain
        bounds = []
        pos = 0
        for ln in entry_lengths:
            bounds.append((pos, pos + ln))
            pos += ln
        bounds.append((pos, len(payload_esc)))
        subs = [strip_emulation_prevention(payload_esc[a:b])
                for (a, b) in bounds]
    dec = CabacDecoder(BitstreamReader(
        subs[0] if multi_sub else rbsp[len(hdr_bytes):]))
    dec.init_contexts(fs.qp, fs.slicetype)
    from ..control.inter_cand import TmvpCtx
    tmvp = TmvpCtx.from_reflists(rl, fs.poc) if cfg.tmvp_enable else None
    reader = CodingTreeReader(dec, cfg, ctrl, is_irap=fs.is_irap,
                              is_intra_slice=is_intra_slice,
                              num_ref=(len(rl.l0), len(rl.l1)),
                              ref_pocs=ref_pocs,
                              is_b_slice=fs.slicetype == 0, tmvp=tmvp)
    qp_delta_on = getattr(ctrl, "qp_delta_enabled", False)
    if qp_delta_on:
        reader.enable_qp_delta(fs.qp)
    if tiles_mode:
        reader.cu_map.set_tile_map(ctrl)

    w, h = ctrl.in_width, ctrl.in_height
    rec = FramePlanes(
        np.zeros((h, w), dtype=np.int32),
        np.zeros((h >> 1, w >> 1), dtype=np.int32) if ctrl.chroma_format else None,
        np.zeros((h >> 1, w >> 1), dtype=np.int32) if ctrl.chroma_format else None,
    )
    coded_mask = np.zeros((-(-h // 4), -(-w // 4)), dtype=bool)
    chroma_mask_c = np.zeros_like(coded_mask)   # dual-tree chroma pass
    chroma_cus: list = []                       # dual-tree chroma-tree CUs

    from ..bitstream.ctx_tables import OFF as CTX_OFF
    from ..control.encoder import reconstruct_inter_cu
    from ..control.sao import decode_sao_ctu
    sao_luma: list = []
    sao_chroma: list = []
    all_cus = []

    # ALF: coefficients come from the parsed APS NAL; slice-level enables
    # mirror the (byte-verified) slice header; CTU flags are CABAC-decoded
    alf_p = None
    lmcs_ctx = None
    wl_hl = ctrl.width_in_lcu * ctrl.height_in_lcu
    aps_nal = None
    for n in nals:
        if n.type != NalType.PREFIX_APS_NUT:
            continue
        ard = BitstreamReader(strip_emulation_prevention(n.payload))
        aps_type = ard.read(3)
        if aps_type == 1:
            # LMCS APS: rebuild the normative LUTs purely from the bits
            from ..hls.header_parse import parse_lmcs_aps
            from ..ops.lmcs import LmcsFrameCtx, build_luts
            ard = BitstreamReader(strip_emulation_prevention(n.payload))
            laps = parse_lmcs_aps(ard)
            luts = build_luts(laps.bin_cw(ctrl.bitdepth), ctrl.bitdepth,
                              crs_offset=laps.crs_offset)
            lmcs_ctx = LmcsFrameCtx(luts, rec.y, cfg.width, cfg.height)
        elif aps_type == 2:
            # scaling-list APS: parse and apply for this AU's dequant
            from ..hls.scaling_list_syntax import parse_scaling_aps
            ard = BitstreamReader(strip_emulation_prevention(n.payload))
            sl_parsed = parse_scaling_aps(ard)
            # replay dequant uses the PARSED matrices: a syntax bug
            # surfaces as a checksum mismatch, not a silent pass
            ctrl.scaling_lists = sl_parsed
            info["scaling_aps"] = True
        elif aps_type == 0:
            aps_nal = n
    if aps_nal is not None:
        from ..hls.alf_syntax import parse_alf_aps
        ard = BitstreamReader(strip_emulation_prevention(aps_nal.payload))
        alf_p = parse_alf_aps(ard, ctrl.chroma_format != 0)
        if aps_pool is not None:
            # keep a pristine copy for later temporal-reuse AUs
            import copy as _copy
            aps_pool[alf_p.aps_id] = _copy.copy(alf_p)
    elif fs.alf is not None and fs.alf.luma_enabled:
        # temporal APS reuse: no ALF APS in this AU — the coefficients
        # come from a previously transmitted APS (alf.c:78-102 pool)
        if aps_pool is None or fs.alf.aps_id not in aps_pool:
            raise ValueError(
                f"AU references ALF APS id {fs.alf.aps_id} but no "
                f"aps_pool was provided to decode_au")
        import copy as _copy
        alf_p = _copy.copy(aps_pool[fs.alf.aps_id])
    if alf_p is not None:
        src_p = fs.alf
        alf_p.luma_enabled = bool(src_p and src_p.luma_enabled)
        alf_p.cb_enabled = bool(src_p and src_p.cb_enabled)
        alf_p.cr_enabled = bool(src_p and src_p.cr_enabled)
        alf_p.cc_cb_enabled = bool(src_p and src_p.cc_cb_enabled)
        alf_p.cc_cr_enabled = bool(src_p and src_p.cc_cr_enabled)
        alf_p.ctu_flags_y = np.zeros(wl_hl, dtype=bool)
        alf_p.ctu_flags_cb = np.zeros(wl_hl, dtype=bool)
        alf_p.ctu_flags_cr = np.zeros(wl_hl, dtype=bool)
        alf_p.cc_flags_cb = np.zeros(wl_hl, dtype=bool)
        alf_p.cc_flags_cr = np.zeros(wl_hl, dtype=bool)

    def decode_one_ctu(cx, cy, x_rel=None, y_rel=None, tile_rect=None):
        if cfg.sao_type:
            decode_sao_ctu(dec, CTX_OFF, cx, cy, ctrl.width_in_lcu,
                           sao_luma, sao_chroma,
                           ctrl.chroma_format != 0, ctrl.bitdepth,
                           x_rel=x_rel, y_rel=y_rel)
        if alf_p is not None:
            from ..hls.alf_syntax import decode_alf_ctu
            decode_alf_ctu(dec, CTX_OFF, cy * ctrl.width_in_lcu + cx,
                           ctrl.width_in_lcu, alf_p,
                           ctrl.chroma_format != 0)
        dual = bool(cfg.dual_tree) and fs.slicetype == 2 \
            and not ctrl.tiles_enable \
            and not (cfg.wpp and ctrl.height_in_lcu > 1)
        if dual:
            node = reader.decode_ctu(cx * LCU_WIDTH, cy * LCU_WIDTH,
                                     tree_type=1)
            for leaf in node.leaves():
                reconstruct_intra_cu(leaf.cu, rec, coded_mask, ctrl,
                                     fs.qp, parts="luma", lmcs=lmcs_ctx)
                all_cus.append(leaf.cu)
            node_c = reader.decode_ctu(cx * LCU_WIDTH, cy * LCU_WIDTH,
                                       tree_type=2)
            for leaf in node_c.leaves():
                reconstruct_intra_cu(leaf.cu, rec, coded_mask, ctrl,
                                     fs.qp, parts="chroma",
                                     jccr_sign=fs.jccr_sign, lmcs=lmcs_ctx,
                                     chroma_mask=chroma_mask_c)
                chroma_cus.append(leaf.cu)
            return
        node = reader.decode_ctu(cx * LCU_WIDTH, cy * LCU_WIDTH)
        for leaf in node.leaves():
            cu_qp = leaf.cu.qp if qp_delta_on else fs.qp
            if leaf.cu.type == 1:
                reconstruct_intra_cu(leaf.cu, rec, coded_mask, ctrl, cu_qp,
                                     tile_rect=tile_rect,
                                     jccr_sign=fs.jccr_sign, lmcs=lmcs_ctx)
            elif leaf.cu.type == 3:
                from ..control.encoder import reconstruct_ibc_cu
                reconstruct_ibc_cu(leaf.cu, rec, coded_mask, ctrl, cu_qp)
            else:
                reconstruct_inter_cu(leaf.cu, rec, coded_mask, ctrl,
                                     cu_qp, rl, lmcs=lmcs_ctx)
            all_cus.append(leaf.cu)

    if tiles_mode:
        # tile scan: per-tile substream with fresh contexts (no inheritance)
        if cfg.sao_type:
            sao_luma = [None] * (ctrl.width_in_lcu * ctrl.height_in_lcu)
            sao_chroma = [None] * (ctrl.width_in_lcu * ctrl.height_in_lcu)
        for t in range(n_tiles):
            if t > 0:
                dec = CabacDecoder(BitstreamReader(subs[t]))
                dec.init_contexts(fs.qp, fs.slicetype)
                reader.dec = dec
                reader.sc.c = dec
            reader.cu_map.cur_tile = t
            if hasattr(reader, "hmvp"):
                reader.hmvp.cur_tile = t
            tile_rect = ctrl.tile_bounds_px(t)
            col0 = tile_rect[0] // LCU_WIDTH
            row0 = tile_rect[1] // LCU_WIDTH
            for (cx, cy) in ctrl.tile_ctus(t):
                decode_one_ctu(cx, cy, x_rel=cx - col0, y_rel=cy - row0,
                               tile_rect=tile_rect)
            if not dec.decode_bin_trm():
                raise ValueError(f"expected end_of_tile bin, tile {t}")
    else:
        snapshot = None
        for cty in range(ctrl.height_in_lcu):
            if wpp and cty > 0:
                dec = CabacDecoder(BitstreamReader(subs[cty]))
                dec.init_contexts(fs.qp, fs.slicetype)
                if snapshot is not None:
                    dec.load_ctx(snapshot)
                reader.dec = dec
                reader.sc.c = dec
            for ctx_ in range(ctrl.width_in_lcu):
                decode_one_ctu(ctx_, cty)
                if wpp and ctx_ == 0:
                    snapshot = dec.save_ctx()
            if wpp:
                if not dec.decode_bin_trm():
                    raise ValueError(f"expected end_of_subset bin, row {cty}")
        if not wpp and not dec.decode_bin_trm():
            raise ValueError("expected end_of_slice terminate bin")

    # LMCS: inverse-map the recon luma before the loop filters
    if lmcs_ctx is not None:
        rec.y[:] = lmcs_ctx.luts.inv_lut[rec.y]

    if cfg.deblock_enable:
        from ..native import deblock_frame_native
        qp4_map = cqp_lut = None
        if qp_delta_on:
            h4, w4 = -(-h // 4), -(-w // 4)
            qp4_map = np.zeros((h4, w4), dtype=np.int32)
            for cu in all_cus:
                qp4_map[cu.y // 4:(cu.y + cu.h) // 4,
                        cu.x // 4:(cu.x + cu.w) // 4] = cu.qp
            cqp_lut = [ctrl.get_chroma_qp(q) for q in range(64)]
        deblock_frame_native(rec, all_cus, fs.qp, ctrl.get_chroma_qp(fs.qp),
                             cfg.deblock_beta, cfg.deblock_tc, ctrl.bitdepth,
                             ref_pocs=ref_pocs,
                             cus_chroma=chroma_cus or None,
                             qp_map=qp4_map, cqp_lut=cqp_lut)
    if cfg.sao_type:
        from ..control.sao import sao_apply_frame
        sao_apply_frame(rec, sao_luma, sao_chroma, ctrl, ctrl.bitdepth)
    if alf_p is not None:
        from ..control.alf import alf_apply_frame, cc_alf_apply
        pre_alf_luma = rec.y.copy() \
            if (alf_p.cc_cb_enabled or alf_p.cc_cr_enabled) else None
        alf_apply_frame(rec, alf_p, ctrl, ctrl.bitdepth)
        if pre_alf_luma is not None:
            cc_alf_apply(rec, pre_alf_luma, alf_p, ctrl, ctrl.bitdepth)

    if cfg.tmvp_enable:
        # attach the motion field so chained oracle decodes derive TMVP
        # from their own reconstruction (not the encoder's)
        from ..control.inter_cand import build_motion_field
        rec.motion = build_motion_field(reader.cu_map, rl.pocs0, rl.pocs1)

    # checksum SEI
    for n in nals:
        if n.type == NalType.SUFFIX_SEI_NUT:
            pl = strip_emulation_prevention(n.payload)
            if pl[0] == 132:
                planes = [p for p in (rec.y, rec.u, rec.v) if p is not None]
                hash_type = pl[2]
                per = 16 if hash_type == 0 else 4
                ok = True
                off = 4
                for p in planes:
                    exp_ck = headers.image_md5(p, ctrl.bitdepth)                         if hash_type == 0                         else headers.image_checksum(p, ctrl.bitdepth)
                    ok &= bytes(pl[off:off + per]) == exp_ck
                    off += per
                info["checksum_ok"] = ok
    info["cus"] = all_cus + chroma_cus
    return rec, info

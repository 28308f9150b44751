"""VVC high-level syntax *parsers*: SPS, PPS, slice header (with embedded
picture header), mirroring the writers in `headers.py` field-for-field.

These make the oracle parse headers from bits instead of regenerating and
byte-comparing them, and let the oracle decode bitstreams produced by OTHER
encoders (the reference binary) — the strongest conformance evidence
available without a VTM binary.  Syntax order follows the reference writers
(uvg266 src/encoder_state-bitstream.c: SPS :454, PPS :734, picture
header :1009, ref pic list :1145, slice header :1248); only the feature
envelope both encoders can emit is supported — anything else raises
UnsupportedStream rather than mis-parsing silently.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..bitstream.bitwriter import BitstreamReader
from ..consts import ChromaFormat, NalType, SliceType


class UnsupportedStream(ValueError):
    """Stream uses a syntax feature outside the supported envelope."""


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise UnsupportedStream(what)


@dataclass
class ParsedSps:
    chroma_format: int = 1
    ctu_size: int = 64
    width: int = 0
    height: int = 0
    conf_win: tuple = (0, 0, 0, 0)      # left, right, top, bottom (units)
    bitdepth: int = 8
    wpp: bool = False
    entry_points: bool = False
    poc_lsb_bits: int = 4
    max_dpb: int = 1
    max_reorder: int = 0
    min_qt_size: tuple = (4, 4, 4)      # (intra, inter, chroma)
    max_btt_depth: tuple = (0, 0, 0)
    max_bt_size: tuple = (64, 64, 64)
    max_tt_size: tuple = (64, 64, 64)
    dual_tree: int = 0
    max_tr_64: bool = True
    trskip: bool = False
    trskip_max_size: int = 2
    bdpcm: bool = False
    mts_intra: bool = False
    mts_inter: bool = False
    lfnst: bool = False
    jccr: int = 0
    qp_table_start_minus26: int = 0
    qp_table_in_minus1: tuple = ()
    qp_table_out: tuple = ()
    sao: bool = False
    alf: bool = False
    ccalf: bool = False
    lmcs: bool = False
    ref_wraparound: int = 0
    tmvp: bool = False
    amvr: int = 0
    max_merge: int = 6
    log2_parallel_merge_level: int = 2
    isp: bool = False
    mrl: bool = False
    mip: bool = False
    cclm: int = 0
    ibc: int = 0
    scaling_list: bool = False
    dep_quant: bool = False
    signhide: bool = False
    timing: tuple = (0, 0)              # (num_units_in_tick, time_scale)
    intra_smoothing_disabled: bool = False


@dataclass
class ParsedLmcsAps:
    """LMCS APS payload (reshape.c code_lmcs_aps:1360): per-bin codeword
    deltas from OrgCW = (1 << bitdepth) / 16, plus the chroma residual
    scaling offset."""
    min_bin: int = 0
    max_bin: int = 15
    deltas: tuple = ()
    crs_offset: int = 0
    chroma_present: bool = True

    def bin_cw(self, bitdepth: int):
        import numpy as np
        org = (1 << bitdepth) // 16
        cw = np.zeros(16, dtype=np.int64)
        for i, d in enumerate(self.deltas):
            cw[self.min_bin + i] = org + d
        return cw


def parse_lmcs_aps(rd: BitstreamReader) -> ParsedLmcsAps:
    """Parse an LMCS APS RBSP positioned at aps_params_type."""
    _expect(rd.read(3) == 1, "APS type is not LMCS")
    rd.read(5)                          # adaptation_parameter_set_id
    chroma = bool(rd.read(1))           # aps_chroma_present_flag
    min_bin = rd.read_ue()
    max_bin = 15 - rd.read_ue()
    _expect(0 <= min_bin <= max_bin <= 15, "LMCS bin range")
    nbits = rd.read_ue() + 1
    deltas = []
    for _ in range(min_bin, max_bin + 1):
        a = rd.read(nbits)
        if a and rd.read(1):
            a = -a
        deltas.append(a)
    crs = 0
    if chroma:
        crs = rd.read(3)
    if crs and rd.read(1):
        crs = -crs
    return ParsedLmcsAps(min_bin, max_bin, tuple(deltas), crs, chroma)


def parse_ptl(rd: BitstreamReader) -> None:
    rd.read(7)                          # general_profile_idc
    rd.read(1)                          # tier
    rd.read(8)                          # level
    rd.read(3)                          # frame_only, multilayer, gci
    rd.byte_align()
    sub_level_present = rd.read(1)      # sub_layer_level_present (1 sublayer)
    rd.byte_align()
    if sub_level_present:
        raise UnsupportedStream("sub_layer_level_present")
    n_sub_profiles = rd.read(8)
    for _ in range(n_sub_profiles):
        rd.read(32)


def parse_sps(rd: BitstreamReader) -> ParsedSps:
    s = ParsedSps()
    _expect(rd.read(4) == 0, "sps_id != 0")
    _expect(rd.read(4) == 0, "vps_id != 0")
    _expect(rd.read(3) == 1, "max_sub_layers != 2")
    s.chroma_format = rd.read(2)
    s.ctu_size = 1 << (rd.read(2) + 5)
    _expect(s.ctu_size == 64, "CTU size != 64")
    if rd.read(1):                      # ptl_dpb_hrd_params_present
        parse_ptl(rd)
    _expect(rd.read(1) == 0, "gdr_enabled")
    _expect(rd.read(1) == 0, "ref_pic_resampling")
    s.width = rd.read_ue()
    s.height = rd.read_ue()
    if rd.read(1):                      # conformance window
        s.conf_win = (rd.read_ue(), rd.read_ue(), rd.read_ue(), rd.read_ue())
    _expect(rd.read(1) == 0, "subpic_info_present")
    s.bitdepth = rd.read_ue() + 8
    s.wpp = bool(rd.read(1))
    s.entry_points = bool(rd.read(1))
    s.poc_lsb_bits = rd.read(4) + 4
    _expect(rd.read(1) == 0, "poc_msb_cycle")
    _expect(rd.read(2) == 0, "extra_ph_bits")
    _expect(rd.read(2) == 0, "extra_sh_bits")
    _expect(rd.read(1) == 0, "sublayer_dpb_params")
    s.max_dpb = rd.read_ue() + 1
    s.max_reorder = rd.read_ue()
    rd.read_ue()                        # max_latency_increase_plus1
    _expect(rd.read_ue() == 0, "min CB size != 4")
    _expect(rd.read(1) == 0, "partition_constraints_override")

    def _read_mtt():
        min_qt = 1 << (rd.read_ue() + 2)
        btt_depth = rd.read_ue()
        bt = tt = min_qt
        if btt_depth:
            bt = min_qt << rd.read_ue()
            tt = min_qt << rd.read_ue()
        return min_qt, btt_depth, bt, tt

    qt_i, d_i, bt_i, tt_i = _read_mtt()
    qt_c, d_c, bt_c, tt_c = qt_i, d_i, bt_i, tt_i
    if s.chroma_format != ChromaFormat.CSP_400:
        s.dual_tree = rd.read(1)
    if s.dual_tree:
        qt_c, d_c, bt_c, tt_c = _read_mtt()
    qt_p, d_p, bt_p, tt_p = _read_mtt()
    s.min_qt_size = (qt_i, qt_p, qt_c)
    s.max_btt_depth = (d_i, d_p, d_c)
    s.max_bt_size = (bt_i, bt_p, bt_c)
    s.max_tt_size = (tt_i, tt_p, tt_c)
    s.max_tr_64 = bool(rd.read(1))
    s.trskip = bool(rd.read(1))
    if s.trskip:
        s.trskip_max_size = rd.read_ue() + 2
        s.bdpcm = bool(rd.read(1))
        _expect(not s.bdpcm, "BDPCM")
    if rd.read(1):                      # sps_mts_enabled_flag
        s.mts_intra = bool(rd.read(1))
        s.mts_inter = bool(rd.read(1))
    s.lfnst = bool(rd.read(1))
    if s.chroma_format != ChromaFormat.CSP_400:
        s.jccr = rd.read(1)
        _expect(rd.read(1) == 1, "per-plane chroma QP tables")
        s.qp_table_start_minus26 = rd.read_se()
        npts = rd.read_ue() + 1
        in_v, out_v = [], []
        for _ in range(npts):
            iv = rd.read_ue()
            ov = rd.read_ue() ^ iv
            in_v.append(iv)
            out_v.append(ov)
        s.qp_table_in_minus1 = tuple(in_v)
        s.qp_table_out = tuple(out_v)
    s.sao = bool(rd.read(1))
    s.alf = bool(rd.read(1))
    if s.alf and s.chroma_format != ChromaFormat.CSP_400:
        s.ccalf = bool(rd.read(1))
    s.lmcs = bool(rd.read(1))
    _expect(rd.read(1) == 0, "weighted_pred")
    _expect(rd.read(1) == 0, "weighted_bipred")
    _expect(rd.read(1) == 0, "long_term_ref_pics")
    _expect(rd.read(1) == 0, "idr_rpl_present")
    _expect(rd.read(1) == 0, "rpl1_same_as_rpl0")
    _expect(rd.read_ue() == 0, "ref pic lists in SPS")
    _expect(rd.read_ue() == 0, "ref pic lists in SPS (l1)")
    s.ref_wraparound = rd.read(1)
    s.tmvp = bool(rd.read(1))
    if s.tmvp:
        _expect(rd.read(1) == 0, "SbTMVP")
    s.amvr = rd.read(1)
    _expect(rd.read(1) == 0, "BDOF")
    _expect(rd.read(1) == 0, "SMVD")
    _expect(rd.read(1) == 0, "DMVR")
    _expect(rd.read(1) == 0, "MMVD")
    s.max_merge = 6 - rd.read_ue()
    _expect(rd.read(1) == 0, "SBT")
    _expect(rd.read(1) == 0, "affine")
    _expect(rd.read(1) == 0, "BCW")
    _expect(rd.read(1) == 0, "CIIP")
    if s.max_merge >= 2:
        _expect(rd.read(1) == 0, "GPM")
    s.log2_parallel_merge_level = rd.read_ue() + 2
    s.isp = bool(rd.read(1))
    s.mrl = bool(rd.read(1))
    s.mip = bool(rd.read(1))
    if s.chroma_format != ChromaFormat.CSP_400:
        s.cclm = rd.read(1)
    if s.chroma_format == ChromaFormat.CSP_420:
        rd.read(1)                      # chroma_horizontal_collocated
        rd.read(1)                      # chroma_vertical_collocated
    _expect(rd.read(1) == 0, "palette")
    if s.trskip:
        _expect(rd.read_ue() == 0, "internal bitdepth delta")
    s.ibc = rd.read(1)
    if s.ibc:
        rd.read_ue()                    # six_minus_max_num_ibc_merge_cand
    _expect(rd.read(1) == 0, "LADF")
    s.scaling_list = bool(rd.read(1))
    s.dep_quant = bool(rd.read(1))
    s.signhide = bool(rd.read(1))
    _expect(rd.read(1) == 0, "virtual boundaries")
    if rd.read(1):                      # timing/hrd present
        num_units = rd.read(32)
        time_scale = rd.read(32)
        s.timing = (num_units, time_scale)
        _expect(rd.read(1) == 0, "nal_hrd_params")
        _expect(rd.read(1) == 0, "vcl_hrd_params")
        _expect(rd.read(1) == 0, "sublayer_cpb_params")
        if rd.read(1):                  # fixed_pic_rate_general_flag
            rd.read_ue()                # elemental_duration_in_tc_minus1
    _expect(rd.read(1) == 0, "field_seq")
    if rd.read(1):                      # sps_vui_parameters_present_flag
        vui_size = rd.read_ue() + 1     # sps_vui_payload_size_minus1
        while rd.pos % 8:
            rd.read(1)                  # sps_vui_alignment_zero_bit
        for _ in range(vui_size):       # byte-aligned vui_payload
            rd.read(8)
    if rd.read(1):                      # sps_extension_flag
        _expect(rd.read(1) == 1, "non-range SPS extension")
        rd.read(7)
        rd.read(4)
        s.intra_smoothing_disabled = bool(rd.read(1))
        rd.read(4)
    _expect(rd.read_bit() == 1, "SPS rbsp stop bit")
    return s


@dataclass
class ParsedPps:
    width: int = 0
    height: int = 0
    tiles: bool = False
    tile_cols: tuple = ()
    tile_rows: tuple = ()
    loop_filter_across_tiles: bool = True
    init_qp: int = 26
    cu_qp_delta: bool = False
    deblock: bool = True
    deblock_beta: int = 0
    deblock_tc: int = 0


def parse_pps(rd: BitstreamReader) -> ParsedPps:
    p = ParsedPps()
    _expect(rd.read(6) == 0, "pps_id != 0")
    _expect(rd.read(4) == 0, "pps sps_id != 0")
    _expect(rd.read(1) == 0, "mixed_nalu_types")
    p.width = rd.read_ue()
    p.height = rd.read_ue()
    _expect(rd.read(1) == 0, "PPS conformance window")
    _expect(rd.read(1) == 0, "scaling window")
    _expect(rd.read(1) == 0, "output_flag_present")
    no_partition = rd.read(1)
    _expect(rd.read(1) == 0, "subpic_id_mapping")
    if not no_partition:
        p.tiles = True
        _expect(rd.read(2) == 1, "pps_log2_ctu_size != 64")
        ncols = rd.read_ue() + 1
        nrows = rd.read_ue() + 1
        p.tile_cols = tuple(rd.read_ue() + 1 for _ in range(ncols))
        p.tile_rows = tuple(rd.read_ue() + 1 for _ in range(nrows))
        if ncols * nrows > 1:
            p.loop_filter_across_tiles = bool(rd.read(1))
            _expect(rd.read(1) == 1, "non-rect slices")
            _expect(rd.read(1) == 1, "multiple slices per subpic")
            rd.read(1)                  # loop_filter_across_slices
    _expect(rd.read(1) == 0, "cabac_init_present")
    _expect(rd.read_ue() == 0, "default active refs l0")
    _expect(rd.read_ue() == 0, "default active refs l1")
    _expect(rd.read(1) == 0, "rpl1_idx_present")
    _expect(rd.read(1) == 0, "pps_weighted_pred")
    _expect(rd.read(1) == 0, "pps_weighted_bipred")
    if rd.read(1):                      # pps_ref_wraparound
        rd.read_ue()
    p.init_qp = rd.read_se() + 26
    p.cu_qp_delta = bool(rd.read(1))
    _expect(rd.read(1) == 0, "chroma_tool_offsets")
    if rd.read(1):                      # deblocking_filter_control_present
        _expect(rd.read(1) == 0, "deblock override")
        p.deblock = not rd.read(1)
        if p.deblock:
            p.deblock_beta = rd.read_se()
            p.deblock_tc = rd.read_se()
    if p.tiles:
        _expect(rd.read(1) == 0, "rpl_info_in_ph")
        _expect(rd.read(1) == 0, "sao_info_in_ph")
        _expect(rd.read(1) == 0, "alf_info_in_ph")
        _expect(rd.read(1) == 0, "qp_delta_info_in_ph")
    _expect(rd.read(1) == 0, "picture_header_extension")
    _expect(rd.read(1) == 0, "slice_header_extension")
    _expect(rd.read(1) == 0, "pps_extension")
    _expect(rd.read_bit() == 1, "PPS rbsp stop bit")
    return p


def config_from_headers(sps: ParsedSps, pps: ParsedPps):
    """Build a Config matching the parsed parameter sets, for driving
    EncoderControl / CodingTreeReader during decode."""
    from ..cfg import Config
    # writer emits (in - real) >> 1 (offsets in 2-sample units, 4:2:0)
    cw = sps.conf_win
    real_w = sps.width - (cw[1] << 1)
    real_h = sps.height - (cw[3] << 1)
    mts = (1 if sps.mts_intra else 0) | (2 if sps.mts_inter else 0)
    cfg = Config(
        width=real_w, height=real_h,
        input_bitdepth=sps.bitdepth,
        input_format=sps.chroma_format,
        qp=pps.init_qp,
        wpp=sps.wpp,
        min_qt_size=sps.min_qt_size,
        max_btt_depth=sps.max_btt_depth,
        max_bt_size=sps.max_bt_size,
        max_tt_size=sps.max_tt_size,
        dual_tree=sps.dual_tree,
        trskip_enable=sps.trskip,
        trskip_max_size=sps.trskip_max_size,
        mts=mts,
        lfnst=sps.lfnst,
        jccr=sps.jccr,
        sao_type=3 if sps.sao else 0,
        alf_type=(2 if sps.ccalf else 1) if sps.alf else 0,
        lmcs_enable=sps.lmcs,
        tmvp_enable=sps.tmvp,
        amvr=sps.amvr,
        max_merge=sps.max_merge,
        log2_parallel_merge_level=sps.log2_parallel_merge_level,
        isp=sps.isp,
        mrl=sps.mrl,
        mip=sps.mip,
        cclm=sps.cclm,
        ibc=sps.ibc,
        scaling_list=2 if sps.scaling_list else 0,
        dep_quant=sps.dep_quant,
        signhide_enable=sps.signhide,
        ref_wraparound=sps.ref_wraparound,
        intra_smoothing_disabled=sps.intra_smoothing_disabled,
        deblock_enable=pps.deblock,
        deblock_beta=pps.deblock_beta,
        deblock_tc=pps.deblock_tc,
        tiles_width_count=len(pps.tile_cols) if pps.tiles else 1,
        tiles_height_count=len(pps.tile_rows) if pps.tiles else 1,
        framerate_num=sps.timing[1] or 25,
        framerate_denom=sps.timing[0] or 1,
    )
    # chroma QP table consistency: our dequant derives the table from cfg;
    # verify the parsed points reproduce it rather than silently diverging
    if sps.chroma_format != ChromaFormat.CSP_400:
        if (cfg.qp_table_start_minus26 != sps.qp_table_start_minus26
                or tuple(cfg.delta_qp_in_val_minus1) != sps.qp_table_in_minus1
                or tuple(cfg.delta_qp_out_val) != sps.qp_table_out):
            raise UnsupportedStream(
                f"chroma QP table mismatch: stream start="
                f"{sps.qp_table_start_minus26} in={sps.qp_table_in_minus1} "
                f"out={sps.qp_table_out}")
    return cfg


@dataclass
class ParsedSliceHeader:
    is_idr: bool = False
    is_irap: bool = False
    inter_allowed: bool = False
    poc_lsb: int = 0
    slicetype: int = SliceType.I
    qp: int = 26
    scaling_aps_id: int = -1
    lmcs_enabled: bool = False
    lmcs_aps_id: int = 0
    lmcs_chroma_scale: bool = False
    tmvp_in_ph: bool = False
    jccr_sign: int = 0
    alf_luma: bool = False
    alf_cb: bool = False
    alf_cr: bool = False
    alf_cc_cb: bool = False
    alf_cc_cr: bool = False
    alf_aps_luma: tuple = ()            # luma ALF APS ids
    alf_aps_chroma: int = 0
    alf_aps_cc_cb: int = 0
    alf_aps_cc_cr: int = 0
    sao_luma: bool = False
    sao_chroma: bool = False
    dep_quant: bool = False
    signhide: bool = False
    ref_neg: tuple = ()                 # delta POCs (positive = past)
    ref_pos: tuple = ()
    collocated_l0: bool = True
    entry_lengths: list = field(default_factory=list)
    payload_bit_pos: int = 0            # bit offset of CABAC payload in RBSP


def _parse_rpl(rd: BitstreamReader, copy_rpl1: bool,
               slicetype: int) -> tuple[tuple, tuple]:
    """Mirror of headers.write_ref_pic_list."""
    def one_list(sign_negative: bool):
        n = rd.read_ue()
        out, last = [], 0
        for _ in range(n):
            d = rd.read_ue()
            dpoc = d + last + 1 if True else 0
            # writer: put_ue(dpoc - last - 1) when dpoc != 0 else put_ue(0);
            # dpoc==0 never occurs for temporal refs
            sign = rd.read(1)
            _expect(sign == (1 if sign_negative else 0),
                    "unexpected strp sign")
            out.append(dpoc)
            last = dpoc
        return tuple(out)

    neg = one_list(True)
    if copy_rpl1:
        neg2 = one_list(True)
        _expect(neg2 == neg, "rpl1 != rpl0 in lowdelay stream")
        pos = ()
    else:
        pos = one_list(False)
    if (slicetype != SliceType.I and len(neg) > 1) or len(pos) > 1:
        _expect(rd.read(1) == 1, "num_ref_idx_active_override == 0")
        if len(neg) > 1:
            for _ in range(2 if copy_rpl1 else 1):
                rd.read_ue()            # num_ref_idx_active_minus1
        if not copy_rpl1 and len(pos) > 1:
            rd.read_ue()
    return neg, pos


def parse_slice_header(rd: BitstreamReader, sps: ParsedSps, pps: ParsedPps,
                       nal_type: int, num_substreams: int = 1,
                       copy_rpl1: bool | None = None) -> ParsedSliceHeader:
    """Parse a slice header (with embedded picture header) from the RBSP.

    `rd` must be positioned at the start of the slice RBSP. `num_substreams`
    is the WPP-row / tile count used to size the entry-point list.
    `copy_rpl1`: whether the stream writes RPL1 as a copy of RPL0 (lowdelay
    GOP with bipred); None = infer (try both is not possible, default False).
    """
    sh = ParsedSliceHeader()
    sh.is_idr = nal_type in (NalType.IDR_W_RADL, NalType.IDR_N_LP)
    sh.is_irap = nal_type in (NalType.IDR_W_RADL, NalType.IDR_N_LP,
                              NalType.CRA_NUT, NalType.GDR_NUT)
    _expect(rd.read(1) == 1, "picture header not in slice header")
    # --- picture header ---
    gdr_or_irap = rd.read(1)
    rd.read(1)                          # ph_non_ref_pic_flag
    if gdr_or_irap:
        _expect(rd.read(1) == 0, "GDR picture")
    sh.inter_allowed = bool(rd.read(1))
    intra_allowed = True
    if sh.inter_allowed:
        intra_allowed = bool(rd.read(1))
    _expect(rd.read_ue() == 0, "ph pps_id != 0")
    sh.poc_lsb = rd.read(sps.poc_lsb_bits)
    if pps.cu_qp_delta:
        rd.read_ue()                    # ph_cu_qp_delta_subdiv (intra)
    if sps.lmcs:
        sh.lmcs_enabled = bool(rd.read(1))      # ph_lmcs_enabled_flag
        if sh.lmcs_enabled:
            sh.lmcs_aps_id = rd.read(2)         # ph_lmcs_aps_id
            if sps.chroma_format != ChromaFormat.CSP_400:
                sh.lmcs_chroma_scale = bool(rd.read(1))
    if sps.scaling_list:
        if rd.read(1):
            sh.scaling_aps_id = rd.read(3)
    if sh.inter_allowed:
        if pps.cu_qp_delta:
            rd.read_ue()                # ph_cu_qp_delta_subdiv (inter)
        if sps.tmvp:
            sh.tmvp_in_ph = bool(rd.read(1))
        rd.read(1)                      # ph_mvd_l1_zero_flag
    if sps.jccr and sps.chroma_format != ChromaFormat.CSP_400:
        sh.jccr_sign = rd.read(1)
    # --- slice header proper ---
    if not sh.is_idr:
        sh.slicetype = rd.read_ue()
    else:
        sh.slicetype = SliceType.I
    if sh.is_irap:
        rd.read(1)                      # sh_no_output_of_prior_pics_flag
    if sps.alf:
        sh.alf_luma = bool(rd.read(1))
        if sh.alf_luma:
            n_aps = rd.read(3)
            sh.alf_aps_luma = tuple(rd.read(3) for _ in range(n_aps))
            if sps.chroma_format != ChromaFormat.CSP_400:
                sh.alf_cb = bool(rd.read(1))
                sh.alf_cr = bool(rd.read(1))
                if sh.alf_cb or sh.alf_cr:
                    sh.alf_aps_chroma = rd.read(3)
            if sps.ccalf:
                sh.alf_cc_cb = bool(rd.read(1))
                if sh.alf_cc_cb:
                    sh.alf_aps_cc_cb = rd.read(3)
                sh.alf_cc_cr = bool(rd.read(1))
                if sh.alf_cc_cr:
                    sh.alf_aps_cc_cr = rd.read(3)
    if not sh.is_idr:
        if copy_rpl1 is None:
            copy_rpl1 = False
        sh.ref_neg, sh.ref_pos = _parse_rpl(rd, copy_rpl1, sh.slicetype)
    if sh.slicetype != SliceType.I and sps.tmvp:
        if sh.slicetype == SliceType.B:
            sh.collocated_l0 = bool(rd.read(1))
        if len(sh.ref_neg) > 1:
            _expect(rd.read_ue() == 0, "collocated_ref_idx != 0")
    sh.qp = pps.init_qp + rd.read_se()
    if sps.sao:
        sh.sao_luma = bool(rd.read(1))
        if sps.chroma_format != ChromaFormat.CSP_400:
            sh.sao_chroma = bool(rd.read(1))
    if sps.dep_quant:
        sh.dep_quant = bool(rd.read(1))
    if sps.signhide and not sh.dep_quant:
        sh.signhide = bool(rd.read(1))
    if sps.trskip and not sh.signhide and not sh.dep_quant:
        _expect(rd.read(1) == 0, "ts_residual_coding_disabled")
    if sps.entry_points and num_substreams > 1:
        offset_len = rd.read_ue() + 1
        sh.entry_lengths = [rd.read(offset_len) + 1
                            for _ in range(num_substreams - 1)]
    _expect(rd.read_bit() == 1, "slice header rbsp stop bit")
    rd.byte_align()
    sh.payload_bit_pos = rd.pos
    return sh

"""VVC high-level syntax writers: NAL header, SPS, PPS, PH, slice header, SEI.

Field-for-field parity with the reference writers for the supported feature
set (uvg266 src/encoder_state-bitstream.c: PTL :82, SPS :454,
PPS :734, picture header :1009, ref pic list :1145, slice header :1248,
checksum SEI :1419; nal.c:43 for the NAL header).  At matched configs these
produce byte-identical parameter sets to the reference, which the test suite
verifies against captured reference output.
"""
from __future__ import annotations


from ..bitstream.bitwriter import Bitstream
from ..cfg import Config
from ..consts import LCU_WIDTH, TR_MAX_LOG2_SIZE, ChromaFormat, NalType, SliceType
from ..control.params import EncoderControl, FrameState


def _log2(x: int) -> int:
    return x.bit_length() - 1


def nal_write(bs: Bitstream, nal_type: int, temporal_id: int = 0,
              long_start_code: bool = True) -> None:
    """Start code + 2-byte VVC NAL unit header (nal.c:43-84)."""
    if long_start_code:
        bs.write_byte_raw(0)
    bs.write_byte_raw(0)
    bs.write_byte_raw(0)
    bs.write_byte_raw(1)
    # forbidden_zero(1) + reserved(1) + layer_id(6) == 0
    bs.write_byte_raw(0)
    # nal_unit_type(5) + temporal_id_plus1(3)
    bs.write_byte_raw((nal_type << 3) + temporal_id + 1)
    bs.zerocount = 0


def write_ptl(bs: Bitstream, ctrl: EncoderControl) -> None:
    """profile_tier_level (encoder_state-bitstream.c:82-247)."""
    bs.put(1, 7)                      # general_profile_idc: Main10
    bs.put(1 if ctrl.cfg.high_tier else 0, 1)
    bs.put(105, 8)                    # general_level_idc (6.3)
    bs.put(0, 1)                      # ptl_frame_only_constraint_flag
    bs.put(0, 1)                      # ptl_multilayer_enabled_flag
    bs.put(0, 1)                      # gci_present_flag
    bs.align_zero()
    bs.put(0, 1)                      # sub_layer_level_present_flag
    bs.align_zero()
    bs.put(1, 8)                      # ptl_num_sub_profiles
    bs.put(0, 32)                     # general_sub_profile_idc


def _max_dpb_size(cfg: Config) -> int:
    # encoder_state-bitstream.c:249-259; gop table handled once GOP lands
    if cfg.gop_len == 0:
        return cfg.ref_frames + 1
    from ..gop import get_gop_config
    gop = get_gop_config(cfg)
    mx = 1
    for g in gop:
        mx = max(mx, len(g.ref_neg) + len(g.ref_pos) + 1)
    return mx


def _max_reorder(cfg: Config) -> int:
    return 0 if cfg.gop_lowdelay else max(cfg.gop_len - 1, 0)


def write_sps(bs: Bitstream, ctrl: EncoderControl) -> None:
    cfg = ctrl.cfg
    bs.put(0, 4)  # sps_decoding_parameter_set_id (sps id)
    bs.put(0, 4)  # sps_video_parameter_set_id
    bs.put(1, 3)  # sps_max_sub_layers_minus1
    bs.put(ctrl.chroma_format, 2)
    bs.put(_log2(LCU_WIDTH) - 5, 2)  # sps_log2_ctu_size_minus5
    bs.put(1, 1)  # sps_ptl_dpb_hrd_params_present_flag
    write_ptl(bs, ctrl)
    bs.put(0, 1)  # gdr_enabled_flag
    bs.put(0, 1)  # ref_pic_resampling_enabled_flag
    bs.put_ue(ctrl.in_width)
    bs.put_ue(ctrl.in_height)
    conf_win = (ctrl.in_width != ctrl.real_width or ctrl.in_height != ctrl.real_height)
    bs.put(1 if conf_win else 0, 1)
    if conf_win:
        bs.put_ue(0)
        bs.put_ue((ctrl.in_width - ctrl.real_width) >> 1)
        bs.put_ue(0)
        bs.put_ue((ctrl.in_height - ctrl.real_height) >> 1)
    bs.put(0, 1)  # subpic_info_present_flag
    bs.put_ue(ctrl.bitdepth - 8)
    bs.put(1 if cfg.wpp else 0, 1)  # sps_entropy_coding_sync_enabled_flag
    bs.put(1 if (ctrl.tiles_enable or cfg.wpp) else 0, 1)  # entry_point_offsets
    bs.put(ctrl.poc_lsb_bits - 4, 4)
    bs.put(0, 1)  # sps_poc_msb_flag
    bs.put(0, 2)  # num_extra_ph_bits_bytes
    bs.put(0, 2)  # num_extra_sh_bits_bytes
    bs.put(0, 1)  # sps_sublayer_dpb_params_flag
    max_buffer = _max_dpb_size(cfg)
    max_reorder = _max_reorder(cfg)
    if max_buffer - 1 < max_reorder:
        max_buffer = max_reorder + 1
    bs.put_ue(max_buffer - 1)
    bs.put_ue(max_reorder)
    bs.put_ue(0)  # sps_max_latency_increase_plus1

    bs.put_ue(0)  # log2_min_luma_coding_block_size_minus2 (4x4, MIN_SIZE-2)
    bs.put(0, 1)  # partition_constraints_override_enabled_flag
    bs.put_ue(_log2(cfg.min_qt_size[0]) - 2)
    bs.put_ue(cfg.max_btt_depth[0])
    if cfg.max_btt_depth[0]:
        bs.put_ue(_log2(cfg.max_bt_size[0]) - _log2(cfg.min_qt_size[0]))
        bs.put_ue(_log2(cfg.max_tt_size[0]) - _log2(cfg.min_qt_size[0]))
    if ctrl.chroma_format != ChromaFormat.CSP_400:
        bs.put(cfg.dual_tree, 1)
    if cfg.dual_tree:
        bs.put_ue(_log2(cfg.min_qt_size[2]) - 2)
        bs.put_ue(cfg.max_btt_depth[2])
        if cfg.max_btt_depth[2]:
            bs.put_ue(_log2(cfg.max_bt_size[2]) - _log2(cfg.min_qt_size[2]))
            bs.put_ue(_log2(cfg.max_tt_size[2]) - _log2(cfg.min_qt_size[2]))
    bs.put_ue(_log2(cfg.min_qt_size[1]) - 2)
    bs.put_ue(cfg.max_btt_depth[1])
    if cfg.max_btt_depth[1]:
        bs.put_ue(_log2(cfg.max_bt_size[1]) - _log2(cfg.min_qt_size[1]))
        bs.put_ue(_log2(cfg.max_tt_size[1]) - _log2(cfg.min_qt_size[1]))
    # LCU_WIDTH > 32:
    bs.put(1 if (TR_MAX_LOG2_SIZE - 5) else 0, 1)  # max_luma_transform_size_64

    bs.put(1 if cfg.trskip_enable else 0, 1)
    if cfg.trskip_enable:
        bs.put_ue(cfg.trskip_max_size - 2)
        bs.put(0, 1)  # sps_bdpcm_enabled_flag
    mts = cfg.mts
    bs.put(1 if mts else 0, 1)
    if mts:
        bs.put(1 if mts in (1, 3) else 0, 1)  # explicit intra
        bs.put(1 if mts in (2, 3) else 0, 1)  # explicit inter
    bs.put(1 if cfg.lfnst else 0, 1)
    if ctrl.chroma_format != ChromaFormat.CSP_400:
        bs.put(cfg.jccr, 1)
        bs.put(1, 1)  # same_qp_table_for_chroma
        bs.put_se(cfg.qp_table_start_minus26)
        bs.put_ue(cfg.qp_table_length_minus1)
        for j in range(cfg.qp_table_length_minus1 + 1):
            bs.put_ue(cfg.delta_qp_in_val_minus1[j])
            bs.put_ue(cfg.delta_qp_out_val[j] ^ cfg.delta_qp_in_val_minus1[j])
    bs.put(1 if cfg.sao_type else 0, 1)
    bs.put(1 if cfg.alf_type else 0, 1)
    if cfg.alf_type and ctrl.chroma_format != ChromaFormat.CSP_400:
        bs.put(1 if cfg.alf_type == 2 else 0, 1)  # ccalf
    bs.put(1 if cfg.lmcs_enable else 0, 1)
    bs.put(0, 1)  # sps_weighted_pred_flag
    bs.put(0, 1)  # sps_weighted_bipred_flag
    bs.put(0, 1)  # long_term_ref_pics_flag
    bs.put(0, 1)  # sps_idr_rpl_present_flag
    bs.put(0, 1)  # rpl1_copy_from_rpl0_flag
    bs.put_ue(0)  # num_ref_pic_lists_in_sps[0]
    bs.put_ue(0)  # num_ref_pic_lists_in_sps[1]
    bs.put(cfg.ref_wraparound, 1)
    bs.put(1 if cfg.tmvp_enable else 0, 1)
    if cfg.tmvp_enable:
        bs.put(0, 1)  # sps_sbtmvp_enabled_flag
    bs.put(cfg.amvr, 1)
    bs.put(0, 1)  # sps_bdof
    bs.put(0, 1)  # sps_smvd
    bs.put(0, 1)  # sps_dmvr
    bs.put(0, 1)  # sps_mmvd
    bs.put_ue(6 - cfg.max_merge)
    bs.put(0, 1)  # sps_sbt
    bs.put(0, 1)  # sps_affine
    bs.put(0, 1)  # sps_bcw
    bs.put(0, 1)  # sps_ciip
    if cfg.max_merge >= 2:
        bs.put(0, 1)  # sps_gpm
    bs.put_ue(cfg.log2_parallel_merge_level - 2)
    bs.put(1 if cfg.isp else 0, 1)
    bs.put(1 if cfg.mrl else 0, 1)
    bs.put(1 if cfg.mip else 0, 1)
    if ctrl.chroma_format != ChromaFormat.CSP_400:
        bs.put(cfg.cclm, 1)
    if ctrl.chroma_format == ChromaFormat.CSP_420:
        bs.put(0, 1)  # chroma_horizontal_collocated
        bs.put(0, 1)  # chroma_vertical_collocated
    bs.put(0, 1)  # sps_palette_enabled_flag
    if cfg.trskip_enable:
        bs.put_ue(0)  # internal_bit_depth_minus_input_bit_depth
    bs.put(1 if cfg.ibc else 0, 1)
    if cfg.ibc:
        bs.put_ue(6 - 6)  # six_minus_max_num_ibc_merge_cand (IBC_MRG_MAX=6)
    bs.put(0, 1)  # sps_ladf_enabled_flag
    # the reference hardcodes 0 even while applying matrices
    # (encoder_state-bitstream.c:691); signaled honestly here
    bs.put(1 if cfg.scaling_list else 0, 1)  # scaling_list_enabled_flag
    bs.put(1 if cfg.dep_quant else 0, 1)
    bs.put(1 if cfg.signhide_enable else 0, 1)
    bs.put(0, 1)  # sps_virtual_boundaries_enabled_flag
    # timing info is present whenever a framerate is configured (encoder.c:646)
    timing = cfg.framerate_num > 0
    bs.put(1 if timing else 0, 1)  # sps_timing_hrd_params_present_flag
    if timing:
        bs.put(cfg.framerate_denom, 32)  # num_units_in_tick
        bs.put(cfg.framerate_num, 32)    # time_scale
        bs.put(0, 1)  # general_nal_hrd_parameters_present_flag
        bs.put(0, 1)  # general_vcl_hrd_parameters_present_flag
        bs.put(0, 1)  # sps_sublayer_cpb_params_present_flag
        bs.put(1, 1)  # fixed_pic_rate_general_flag
        bs.put_ue(0)  # elemental_duration_in_tc_minus1
    bs.put(0, 1)  # sps_field_seq_flag
    vui_on = bool(cfg.vui_sar_width and cfg.vui_sar_height) \
        or cfg.vui_overscan or cfg.vui_fullrange \
        or cfg.vui_frame_field_info
    bs.put(1 if vui_on else 0, 1)  # sps_vui_parameters_present_flag
    if vui_on:
        # sps_vui_payload_size_minus1 + alignment + byte-aligned payload
        # (VVC 7.3.2.4; the reference's writer at encoder_state-
        # bitstream.c:346 is upstream-disabled — this follows the spec)
        payload = _vui_payload(cfg)
        bs.put_ue(len(payload) - 1)
        while bs.tell() % 8:
            bs.put(1, 1)      # sps_vui_alignment_zero_bit (=1 per spec)
        for b in payload:
            bs.put(b, 8)
    # SPS extension (range extension only when intra smoothing disabled)
    ext = cfg.intra_smoothing_disabled
    bs.put(1 if ext else 0, 1)
    if ext:
        bs.put(1, 1)   # sps_range_extension_flag
        bs.put(0, 7)   # multilayer + 6bits
        bs.put(0, 4)   # rotation/context/ext-precision/ts-rice flags
        bs.put(1, 1)   # intra_smoothing_disabled_flag
        bs.put(0, 4)   # remaining range-extension flags
    bs.rbsp_trailing_bits()


_SAR_TABLE = [(1, 1, 1), (12, 11, 2), (10, 11, 3), (16, 11, 4),
              (40, 33, 5), (24, 11, 6), (20, 11, 7), (32, 11, 8),
              (80, 33, 9), (18, 11, 10), (15, 11, 11), (64, 33, 12),
              (160, 99, 13), (4, 3, 14), (3, 2, 15), (2, 1, 16)]


def _vui_payload(cfg) -> bytes:
    """Byte-aligned vui_payload (VVC 7.3.7 general_vui_parameters +
    payload alignment; reference field set, encoder_state-bitstream.c:
    346-420)."""
    vb = Bitstream()
    vb.put(1 if cfg.source_scan_type == 0 else 0, 1)  # vui_progressive
    vb.put(0, 1)   # vui_interlaced_source_flag
    vb.put(0, 1)   # vui_non_packed_constraint_flag
    vb.put(0, 1)   # vui_non_projected_constraint_flag
    if cfg.vui_sar_width > 0 and cfg.vui_sar_height > 0:
        idc = 255
        for (sw, sh, i) in _SAR_TABLE:
            if sw == cfg.vui_sar_width and sh == cfg.vui_sar_height:
                idc = i
                break
        vb.put(1, 1)            # vui_aspect_ratio_info_present_flag
        vb.put(1, 1)            # vui_aspect_ratio_constant_flag
        vb.put(idc, 8)
        if idc == 255:
            vb.put(cfg.vui_sar_width, 16)
            vb.put(cfg.vui_sar_height, 16)
    else:
        vb.put(0, 1)
    if cfg.vui_overscan > 0:
        vb.put(1, 1)            # vui_overscan_info_present_flag
        vb.put(cfg.vui_overscan - 1, 1)
    else:
        vb.put(0, 1)
    if cfg.vui_fullrange:
        vb.put(1, 1)            # vui_colour_description_present_flag
        vb.put(2, 8)            # colour_primaries (unspecified)
        vb.put(2, 8)            # transfer_characteristics
        vb.put(2, 8)            # matrix_coeffs
        vb.put(1, 1)            # vui_full_range_flag
    else:
        vb.put(0, 1)
    vb.put(0, 1)                # vui_chroma_loc_info_present_flag
    if vb.tell() % 8:
        vb.put(1, 1)            # vui_payload_bit_equal_to_one
        while vb.tell() % 8:
            vb.put(0, 1)
    return bytes(vb.buf)


def write_aud(bs: Bitstream, fs) -> None:
    """Access unit delimiter (encoder_state-bitstream.c:60-74)."""
    nal_write(bs, NalType.AUD_NUT, 0, long_start_code=True)
    bs.put(1, 1)                # aud_irap_or_gdr_au_flag
    pic_type = 0 if fs.slicetype == 2 else (1 if fs.slicetype == 1 else 2)
    bs.put(pic_type, 3)
    bs.rbsp_trailing_bits()


def write_pic_timing_sei(bs: Bitstream, fs) -> None:
    """Picture timing SEI (frame-field info,
    encoder_state-bitstream.c:939-973; progressive source)."""
    nal_write(bs, NalType.PREFIX_SEI_NUT, 0, long_start_code=False)
    bs.put(1, 8)                # payload_type = pic_timing
    bs.put(1, 8)                # payload_size
    bs.put(0, 4)                # pic_struct: progressive
    bs.put(1, 2)                # source_scan_type: progressive
    bs.put(0, 1)                # duplicate_flag
    bs.put(1, 1)                # payload alignment stop bit
    bs.rbsp_trailing_bits()


def write_pps(bs: Bitstream, ctrl: EncoderControl, tiles_col_width=None,
              tiles_row_height=None) -> None:
    cfg = ctrl.cfg
    bs.put(0, 6)  # pps_pic_parameter_set_id
    bs.put(0, 4)  # pps_seq_parameter_set_id
    bs.put(0, 1)  # mixed_nalu_types_in_pic_flag
    bs.put_ue(ctrl.in_width)
    bs.put_ue(ctrl.in_height)
    bs.put(0, 1)  # conformance_window_flag (SPS only)
    bs.put(0, 1)  # scaling_window_flag
    bs.put(0, 1)  # output_flag_present_flag
    bs.put(0 if ctrl.tiles_enable else 1, 1)  # pps_no_pic_partition_flag
    bs.put(0, 1)  # subpic_id_mapping_in_pps_flag
    if ctrl.tiles_enable:
        bs.put(_log2(LCU_WIDTH) - 5, 2)
        bs.put_ue(cfg.tiles_width_count - 1)
        bs.put_ue(cfg.tiles_height_count - 1)
        for w in tiles_col_width:
            bs.put_ue(w - 1)
        for h in tiles_row_height:
            bs.put_ue(h - 1)
        if cfg.tiles_width_count * cfg.tiles_height_count > 1:
            # unlike the reference (encoder_state-bitstream.c:788) we allow
            # loop filtering across tile boundaries: our deblock/SAO run
            # frame-global, which avoids tile seams at no conformance cost
            bs.put(1, 1)  # pps_loop_filter_across_tiles_enabled_flag
            bs.put(1, 1)  # rect_slice_flag
            bs.put(1, 1)  # single_slice_per_subpic
            bs.put(0, 1)  # loop_filter_across_slices
    bs.put(0, 1)   # pps_cabac_init_present_flag
    bs.put_ue(0)   # num_ref_idx_default_active_minus1[0]
    bs.put_ue(0)   # num_ref_idx_default_active_minus1[1]
    bs.put(0, 1)   # pps_rpl1_idx_present_flag
    bs.put(0, 1)   # pps_weighted_pred_flag
    bs.put(0, 1)   # pps_weighted_bipred_flag
    bs.put(cfg.ref_wraparound, 1)
    if cfg.ref_wraparound:
        bs.put_ue(0)
    bs.put_se(cfg.qp - 26)  # pps_init_qp_minus26
    # pps_cu_qp_delta_enabled_flag: enabled for RC / VAQ streams
    # (encoderstate.c:1882-1886, encoder_state-bitstream.c:812)
    bs.put(1 if getattr(ctrl, "qp_delta_enabled", False) else 0, 1)
    bs.put(0, 1)   # pps_chroma_tool_offsets_present_flag
    bs.put(1, 1)   # pps_deblocking_filter_control_present_flag
    bs.put(0, 1)   # pps_deblocking_filter_override_enabled_flag
    bs.put(0 if cfg.deblock_enable else 1, 1)
    if cfg.deblock_enable:
        bs.put_se(cfg.deblock_beta)
        bs.put_se(cfg.deblock_tc)
    if ctrl.tiles_enable:
        bs.put(0, 1)  # rpl_info_in_ph
        bs.put(0, 1)  # sao_info_in_ph
        bs.put(0, 1)  # alf_info_in_ph
        bs.put(0, 1)  # qp_delta_info_in_ph
    bs.put(0, 1)  # picture_header_extension
    bs.put(0, 1)  # slice_header_extension
    bs.put(0, 1)  # pps_extension_flag
    bs.rbsp_trailing_bits()


def write_picture_header(bs: Bitstream, ctrl: EncoderControl, fs: FrameState) -> None:
    cfg = ctrl.cfg
    if fs.is_idr:
        bs.put(1, 1)  # ph_gdr_or_irap_pic_flag
        bs.put(0, 1)  # ph_non_ref_pic_flag
        bs.put(0, 1)  # ph_gdr_pic_flag
        bs.put(0, 1)  # ph_inter_slice_allowed_flag
    else:
        bs.put(0, 1)
        bs.put(0, 1)
        bs.put(1, 1)  # ph_inter_slice_allowed_flag
        bs.put(1, 1)  # ph_intra_slice_allowed_flag
    bs.put_ue(0)  # ph_pic_parameter_set_id
    poc_lsb = fs.poc & ((1 << ctrl.poc_lsb_bits) - 1)
    bs.put(poc_lsb, ctrl.poc_lsb_bits)
    if fs.max_qp_delta_depth >= 0:
        bs.put_ue(fs.max_qp_delta_depth)
    # (alf per-picture info only with alf_info_in_ph_flag — not used)
    if cfg.lmcs_enable:
        # reshape.c / encoder_state-bitstream.c:1105-1117: per-picture
        # enable + APS id 0 + chroma residual scale flag
        lmcs = getattr(fs, "lmcs", None)
        bs.put(1 if lmcs is not None else 0, 1)  # ph_lmcs_enabled_flag
        if lmcs is not None:
            bs.put(0, 2)                         # ph_lmcs_aps_id
            if ctrl.chroma_format != ChromaFormat.CSP_400:
                bs.put(1 if lmcs.chroma_adj else 0, 1)
    if cfg.scaling_list:
        bs.put(1, 1)   # ph_explicit_scaling_list_enabled_flag
        bs.put(1, 3)   # ph_scaling_list_aps_id (APS id 1)
    if not fs.is_idr:
        if fs.max_qp_delta_depth >= 0:
            bs.put_ue(fs.max_qp_delta_depth)
        if cfg.tmvp_enable:
            bs.put(1, 1)  # ph_pic_temporal_mvp_enabled_flag
        bs.put(0, 1)  # ph_mvd_l1_zero_flag
    if cfg.jccr and ctrl.chroma_format != ChromaFormat.CSP_400:
        bs.put(fs.jccr_sign, 1)


def write_ref_pic_list(bs: Bitstream, ctrl: EncoderControl, fs: FrameState) -> None:
    """Reference picture list syntax (encoder_state-bitstream.c:1145-1246)."""
    cfg = ctrl.cfg
    ref_neg = list(fs.ref_pocs_neg)
    ref_pos = list(fs.ref_pocs_pos)
    copy_rpl1 = (cfg.gop_lowdelay or cfg.gop_len == 0) and bool(cfg.bipred)
    for _ in range(1 + (1 if copy_rpl1 else 0)):
        bs.put_ue(len(ref_neg))
        last_poc = 0
        for dpoc in ref_neg:  # dpoc = poc - ref_poc > 0
            bs.put_ue(dpoc - last_poc - 1 if dpoc else 0)
            if dpoc + 1:
                bs.put(1, 1)  # strp_entry_sign_flag (negative)
            last_poc = dpoc
    if not copy_rpl1:
        bs.put_ue(len(ref_pos))
        last_poc = 0
        for dpoc in ref_pos:
            bs.put_ue(dpoc - last_poc - 1 if dpoc else 0)
            if dpoc + 1:
                bs.put(0, 1)
            last_poc = dpoc
    if (fs.slicetype != SliceType.I and len(ref_neg) > 1) or len(ref_pos) > 1:
        bs.put(1, 1)  # num_ref_idx_active_override_flag
        if len(ref_neg) > 1:
            for _ in range(1 + (1 if copy_rpl1 else 0)):
                bs.put_ue(len(ref_neg) - 1)
        if not copy_rpl1 and len(ref_pos) > 1:
            bs.put_ue(len(ref_pos) - 1)


def write_slice_header_fixed(bs: Bitstream, ctrl: EncoderControl,
                             fs: FrameState) -> None:
    """Slice header up to (excluding) the entry-point fields."""
    cfg = ctrl.cfg
    bs.put(1, 1)  # picture_header_in_slice_header_flag
    write_picture_header(bs, ctrl, fs)
    if not fs.is_idr:
        bs.put_ue(fs.slicetype)
    if fs.is_irap:
        bs.put(0, 1)  # sh_no_output_of_prior_pics_flag
    if cfg.alf_type:
        from .alf_syntax import write_slice_alf
        write_slice_alf(bs, fs.alf,
                        ctrl.chroma_format != ChromaFormat.CSP_400,
                        cc_alf=cfg.alf_type == 2)
    if not fs.is_idr:
        write_ref_pic_list(bs, ctrl, fs)
    if fs.slicetype != SliceType.I and cfg.tmvp_enable:
        if fs.slicetype == SliceType.B:
            bs.put(1, 1)  # sh_collocated_from_l0_flag
        if len(fs.ref_pocs_neg) > 1:
            bs.put_ue(0)  # sh_collocated_ref_idx
    bs.put_se(fs.qp - cfg.qp)  # sh_qp_delta
    if cfg.sao_type:
        bs.put(1, 1)
        if ctrl.chroma_format != ChromaFormat.CSP_400:
            bs.put(1, 1)
    if cfg.dep_quant:
        bs.put(1, 1)
    if cfg.signhide_enable and not cfg.dep_quant:
        bs.put(1, 1)
    if cfg.trskip_enable and not cfg.signhide_enable and not cfg.dep_quant:
        bs.put(0, 1)  # sh_ts_residual_coding_disabled_flag


def write_slice_header(bs: Bitstream, ctrl: EncoderControl, fs: FrameState,
                       entry_point_lengths: list[int] | None = None) -> None:
    """Slice header with embedded picture header
    (encoder_state-bitstream.c:1248-1416)."""
    cfg = ctrl.cfg
    write_slice_header_fixed(bs, ctrl, fs)
    if ctrl.tiles_enable or cfg.wpp:
        eps = entry_point_lengths or []
        num_offsets = len(eps) - 1
        if num_offsets > 0:
            offset_len = _log2(max(eps)) + 1
            bs.put_ue(offset_len - 1)
            for ln in eps[:-1]:
                bs.put(ln - 1, offset_len)
    bs.rbsp_trailing_bits()


def write_lmcs_aps(bs: Bitstream, luts, has_chroma: bool) -> None:
    """LMCS APS RBSP (reshape.c code_lmcs_aps:1360 +
    uvg_encode_lmcs_adaptive_parameter_set:1395): per-bin codeword deltas
    from OrgCW = (1 << bitdepth) / 16, in bitdepth units."""
    bs.put(1, 3)   # aps_params_type = LMCS_APS
    bs.put(0, 5)   # adaptation_parameter_set_id
    bs.put(1 if has_chroma else 0, 1)  # aps_chroma_present_flag
    org_cw = (1 << luts.bitdepth) // 16
    deltas = [int(luts.bin_cw[i]) - org_cw
              for i in range(luts.min_bin, luts.max_bin + 1)]
    max_abs = max((abs(d) for d in deltas), default=0)
    nbits = max(1, max_abs.bit_length())
    bs.put_ue(luts.min_bin)                   # lmcs_min_bin_idx
    bs.put_ue(15 - luts.max_bin)              # lmcs_delta_max_bin_idx
    bs.put_ue(nbits - 1)                      # lmcs_delta_cw_prec_minus1
    for d in deltas:
        bs.put(abs(d), nbits)                 # lmcs_delta_abs_cw[i]
        if d != 0:
            bs.put(1 if d < 0 else 0, 1)      # lmcs_delta_sign_cw_flag[i]
    crs = int(luts.crs_offset)
    if has_chroma:
        bs.put(abs(crs), 3)                   # lmcs_delta_abs_crs
    if abs(crs) > 0:
        bs.put(1 if crs < 0 else 0, 1)        # lmcs_delta_sign_crs_flag
    bs.put(0, 1)   # aps_extension_flag
    bs.rbsp_trailing_bits()


def write_parameter_sets(bs: Bitstream, ctrl: EncoderControl) -> None:
    nal_write(bs, NalType.SPS_NUT, 0, True)
    write_sps(bs, ctrl)
    nal_write(bs, NalType.PPS_NUT, 0, True)
    if ctrl.tiles_enable:
        col_w = [b - a for a, b in zip(ctrl.tile_col_bd, ctrl.tile_col_bd[1:])]
        row_h = [b - a for a, b in zip(ctrl.tile_row_bd, ctrl.tile_row_bd[1:])]
        write_pps(bs, ctrl, col_w, row_h)
    else:
        write_pps(bs, ctrl)


def image_checksum(plane, bitdepth: int = 8) -> bytes:
    """VVC decoded-picture-hash 'checksum' over one plane
    (strategies/generic/nal-generic.c:68-93)."""
    import numpy as np
    h, w = plane.shape
    x = np.arange(w, dtype=np.uint32)
    y = np.arange(h, dtype=np.uint32)[:, None]
    mask = ((x & 0xFF) ^ (y & 0xFF) ^ (x >> 8) ^ (y >> 8)).astype(np.uint32) & 0xFF
    data = plane.astype(np.uint32)
    checksum = int(((data & 0xFF) ^ mask).sum())
    if bitdepth > 8:
        checksum += int((((data >> 8) & 0xFF) ^ mask).sum())
    checksum &= 0xFFFFFFFF
    return bytes([(checksum >> 24) & 0xFF, (checksum >> 16) & 0xFF,
                  (checksum >> 8) & 0xFF, checksum & 0xFF])


def image_md5(plane, bitdepth: int = 8) -> bytes:
    """MD5 over the row-major sample bytes of one plane
    ((bd+7)/8 bytes per sample, little-endian;
    strategies/generic/nal-generic.c array_md5_generic:41)."""
    import hashlib

    import numpy as np
    if bitdepth <= 8:
        data = plane.astype(np.uint8).tobytes()
    else:
        data = plane.astype("<u2").tobytes()
    return hashlib.md5(data).digest()


def write_checksum_sei(bs: Bitstream, planes, chroma_format: int,
                       bitdepth: int = 8, hash_type: int = 2) -> None:
    """Suffix SEI with decoded picture hash: hash_type 2 = checksum,
    0 = MD5 (encoder_state-bitstream.c:1419-1466)."""
    nal_write(bs, NalType.SUFFIX_SEI_NUT, 0, False)
    bs.put(132, 8)  # sei_type: decoded_picture_hash
    num_colors = 1 if chroma_format == ChromaFormat.CSP_400 else 3
    per = 16 if hash_type == 0 else 4
    bs.put(2 + num_colors * per, 8)  # size
    bs.put(hash_type, 8)
    bs.put(1 if num_colors == 1 else 0, 1)
    bs.put(0, 7)
    for i in range(num_colors):
        ck = image_md5(planes[i], bitdepth) if hash_type == 0             else image_checksum(planes[i], bitdepth)
        for b in ck:
            bs.put(b, 8)
    bs.align()
    bs.rbsp_trailing_bits()

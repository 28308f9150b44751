"""ALF syntax: APS payload, slice-header fields, per-CTU CABAC flags.

Behavioral parity with the reference:
- APS: alf.c encoder_state_write_adaptation_parameter_set:1547,
  encode_alf_aps_flags:1452, encode_alf_aps_filter:1415
- slice header fields: encoder_state-bitstream.c:1283-1325
- CTU flags: alf.c uvg_encode_alf_bits:1365, code_alf_ctu_enable_flag:1147,
  code_alf_ctu_filter_index:1209, code_alf_ctu_alternative_ctu:1255

This encoder always signals its own (single) APS: the CTU filter index
is therefore use_latest=1 with no fixed-filter fallback signaled.
"""
from __future__ import annotations

import numpy as np

from ..control.alf import NUM_CLASSES, AlfFrameParams

ALF_NUM_FIXED_FILTER_SETS = 16


def _ceil_log2(x: int) -> int:
    return (x - 1).bit_length()


def _write_cc_coeffs(bs, coef) -> None:
    """CC-ALF coefficient coding: 3-bit mapped magnitude (0 or
    1+floor(log2)) + sign (encode_alf_aps_filter, alf.c:1521-1540)."""
    for i in range(7):
        c = int(coef[i])
        if c == 0:
            bs.put(0, 3)
        else:
            bs.put(1 + (abs(c).bit_length() - 1), 3)
            bs.put(1 if c < 0 else 0, 1)


def write_alf_aps(bs, p: AlfFrameParams, has_chroma: bool) -> None:
    """ALF APS RBSP payload (after the NAL header)."""
    bs.put(0, 3)   # aps_params_type = ALF_APS
    bs.put(p.aps_id & 31, 5)   # adaptation_parameter_set_id
    bs.put(1 if has_chroma else 0, 1)  # aps_chroma_present_flag
    luma_new = p.luma_enabled
    chroma_new = has_chroma and (p.cb_enabled or p.cr_enabled)
    bs.put(1 if luma_new else 0, 1)    # alf_luma_new_filter
    if has_chroma:
        bs.put(1 if chroma_new else 0, 1)  # alf_chroma_new_filter
        bs.put(1 if p.cc_cb_enabled else 0, 1)  # alf_cc_cb_filter_signal
        bs.put(1 if p.cc_cr_enabled else 0, 1)  # alf_cc_cr_filter_signal
    if luma_new:
        clip = int(getattr(p, "luma_clip", 0))
        bs.put(1 if clip else 0, 1)  # alf_luma_clip
        bs.put_ue(p.num_filters - 1)
        if p.num_filters > 1:
            length = _ceil_log2(p.num_filters)
            for i in range(NUM_CLASSES):
                bs.put(int(p.filter_map[i]), length)
        for f in range(p.num_filters):
            for i in range(12):
                c = int(p.luma_coeffs[f, i])
                bs.put_ue(abs(c))
                if c != 0:
                    bs.put(1 if c < 0 else 0, 1)
        if clip:
            # alf_luma_clip_idx u(2) per filter coefficient position
            # (alf.c:1446; uniform index in this encoder)
            for f in range(p.num_filters):
                for i in range(12):
                    bs.put(clip, 2)
    if chroma_new:
        bs.put(0, 1)   # alf_nonlinear_enable_flag_chroma
        bs.put_ue(0)   # alf_chroma_num_alts_minus1
        for i in range(6):
            c = int(p.chroma_coeffs[i])
            bs.put_ue(abs(c))
            if c != 0:
                bs.put(1 if c < 0 else 0, 1)
    for enabled, coef in ((p.cc_cb_enabled, p.cc_cb_coeffs),
                          (p.cc_cr_enabled, p.cc_cr_coeffs)):
        if enabled:
            bs.put_ue(0)          # alf_cc_*_filters_signalled_minus1
            _write_cc_coeffs(bs, coef)
    bs.put(0, 1)   # aps_extension_flag
    bs.rbsp_trailing_bits()


def parse_alf_aps(rd, has_chroma: bool) -> AlfFrameParams:
    """Parse an ALF APS RBSP (spec-mirror of write_alf_aps)."""
    p = AlfFrameParams()
    aps_type = rd.read(3)
    assert aps_type == 0, "not an ALF APS"
    p.aps_id = rd.read(5)
    rd.read(1)             # chroma present
    luma_new = rd.read_bit()
    chroma_new = 0
    cc_cb = cc_cr = 0
    if has_chroma:
        chroma_new = rd.read_bit()
        cc_cb = rd.read_bit()
        cc_cr = rd.read_bit()
    if luma_new:
        clip_flag = rd.read_bit()
        p.num_filters = rd.read_ue() + 1
        p.filter_map = np.zeros(NUM_CLASSES, dtype=np.int32)
        if p.num_filters > 1:
            length = _ceil_log2(p.num_filters)
            for i in range(NUM_CLASSES):
                p.filter_map[i] = rd.read(length)
        p.luma_coeffs = np.zeros((p.num_filters, 12), dtype=np.int32)
        for f in range(p.num_filters):
            for i in range(12):
                a = rd.read_ue()
                if a:
                    s = rd.read_bit()
                    a = -a if s else a
                p.luma_coeffs[f, i] = a
        if clip_flag:
            clips = np.zeros((p.num_filters, 12), dtype=np.int32)
            for f in range(p.num_filters):
                for i in range(12):
                    clips[f, i] = rd.read(2)
            uniq = np.unique(clips)
            if len(uniq) == 1:
                # uniform clip (this encoder's own streams)
                p.luma_clip = int(uniq[0])
            else:
                # reference nonlinear ALF: per-filter per-tap indices
                p.luma_clip_taps = clips
        p.luma_enabled = True
    if chroma_new:
        nonlinear_c = rd.read_bit()     # alf_nonlinear_enable_flag_chroma
        n_alts = rd.read_ue() + 1       # alf_chroma_num_alts_minus1
        p.num_chroma_alts = n_alts
        p.chroma_alts = np.zeros((n_alts, 6), dtype=np.int32)
        p.chroma_clip = np.zeros((n_alts, 6), dtype=np.int32) \
            if nonlinear_c else None
        for alt in range(n_alts):
            for i in range(6):
                a = rd.read_ue()
                if a:
                    s = rd.read_bit()
                    a = -a if s else a
                p.chroma_alts[alt, i] = a
            if nonlinear_c:
                for i in range(6):
                    p.chroma_clip[alt, i] = rd.read(2)
        p.chroma_coeffs = p.chroma_alts[0].copy()
    for which in ("cb", "cr"):
        if (cc_cb if which == "cb" else cc_cr):
            n = rd.read_ue() + 1
            assert n == 1
            coef = np.zeros(7, dtype=np.int64)
            for i in range(7):
                m = rd.read(3)
                if m:
                    sgn = rd.read_bit()
                    v = 1 << (m - 1)
                    coef[i] = -v if sgn else v
            if which == "cb":
                p.cc_cb_coeffs = coef
            else:
                p.cc_cr_coeffs = coef
    return p


def write_slice_alf(bs, p: AlfFrameParams | None, has_chroma: bool,
                    cc_alf: bool = False) -> None:
    """Slice-header ALF fields (alf_info_in_ph_flag = 0)."""
    enabled = p is not None and p.luma_enabled
    bs.put(1 if enabled else 0, 1)  # sh_alf_enabled_flag
    if enabled:
        bs.put(1, 3)   # sh_num_alf_aps_ids_luma
        bs.put(p.aps_id & 7, 3)   # sh_alf_aps_id_luma[0]
        if has_chroma:
            bs.put(1 if p.cb_enabled else 0, 1)
            bs.put(1 if p.cr_enabled else 0, 1)
            if p.cb_enabled or p.cr_enabled:
                bs.put(p.aps_id & 7, 3)   # sh_alf_aps_id_chroma
        if cc_alf:
            bs.put(1 if p.cc_cb_enabled else 0, 1)
            if p.cc_cb_enabled:
                bs.put(p.aps_id & 7, 3)   # sh_cc_alf_cb_aps_id
            bs.put(1 if p.cc_cr_enabled else 0, 1)
            if p.cc_cr_enabled:
                bs.put(p.aps_id & 7, 3)   # sh_cc_alf_cr_aps_id


def encode_alf_ctu(cabac, OFF, ctu_idx: int, wl: int,
                   p: AlfFrameParams) -> None:
    """Per-CTU ALF flags (after SAO, before the coding tree)."""
    comp_flags = (p.ctu_flags_y, p.ctu_flags_cb, p.ctu_flags_cr)
    comp_enabled = (p.luma_enabled, p.cb_enabled, p.cr_enabled)
    for comp in range(3 if p.ctu_flags_cb is not None else 1):
        if not comp_enabled[comp]:
            continue
        flags = comp_flags[comp]
        left = flags[ctu_idx - 1] if ctu_idx % wl else 0
        above = flags[ctu_idx - wl] if ctu_idx >= wl else 0
        ctx = int(bool(left)) + int(bool(above))
        cabac.encode_bin(OFF["alf_ctb_flag"] + comp * 3 + ctx,
                         1 if flags[ctu_idx] else 0)
        if comp == 0 and flags[ctu_idx]:
            # one APS in the slice: use_latest=1, no further index bins
            cabac.encode_bin(OFF["alf_temporal_filt"], 1)
        elif comp > 0 and flags[ctu_idx] and p.num_chroma_alts > 1:
            # alf_ctb_alternatives: truncated unary (alf.c:1270-1284)
            alts = p.ctu_alt_cb if comp == 1 else p.ctu_alt_cr
            val = int(alts[ctu_idx]) if alts is not None else 0
            for _ in range(val):
                cabac.encode_bin(
                    OFF["alf_ctb_alternatives"] + comp - 1, 1)
            if val < p.num_chroma_alts - 1:
                cabac.encode_bin(
                    OFF["alf_ctb_alternatives"] + comp - 1, 0)
    for comp, enabled, cflags in ((1, p.cc_cb_enabled, p.cc_flags_cb),
                                  (2, p.cc_cr_enabled, p.cc_flags_cr)):
        if not enabled:
            continue
        left = cflags[ctu_idx - 1] if ctu_idx % wl else 0
        above = cflags[ctu_idx - wl] if ctu_idx >= wl else 0
        ctx = int(bool(left)) + int(bool(above)) + (3 if comp == 2 else 0)
        cabac.encode_bin(OFF["alf_cc_filter_control_flag"] + ctx,
                         1 if cflags[ctu_idx] else 0)
        # filter_count == 1: idc in {0, 1}, no extra EP bins


def _decode_trunc_bin(dec, max_value: int) -> int:
    """Truncated binary, bypass bins (cabac.c:203 convention)."""
    if max_value <= 1:
        return 0
    thresh = max_value.bit_length() - 1
    val = 1 << thresh
    b = max_value - val
    t = dec.decode_bins_ep(thresh) if thresh else 0
    if t < val - b:
        return t
    t = (t << 1) + dec.decode_bin_ep()
    return t - (val - b)


def decode_alf_ctu(dec, OFF, ctu_idx: int, wl: int,
                   p: AlfFrameParams, has_chroma: bool) -> None:
    """Parsing mirror of encode_alf_ctu; fills p.ctu_flags_*."""
    comp_flags = (p.ctu_flags_y, p.ctu_flags_cb, p.ctu_flags_cr)
    comp_enabled = (p.luma_enabled, p.cb_enabled, p.cr_enabled)
    for comp in range(3 if has_chroma else 1):
        if not comp_enabled[comp]:
            continue
        flags = comp_flags[comp]
        left = flags[ctu_idx - 1] if ctu_idx % wl else 0
        above = flags[ctu_idx - wl] if ctu_idx >= wl else 0
        ctx = int(bool(left)) + int(bool(above))
        flags[ctu_idx] = bool(
            dec.decode_bin(OFF["alf_ctb_flag"] + comp * 3 + ctx))
        if comp == 0 and flags[ctu_idx]:
            # alf_ctb_filter_index (alf.c code_alf_ctu_filter_index):
            # sets 0..15 fixed, 16+i the i-th slice APS
            num_aps = p.num_luma_aps
            if num_aps > 0:
                if dec.decode_bin(OFF["alf_temporal_filt"]):
                    idx = 16 + (_decode_trunc_bin(dec, num_aps)
                                if num_aps > 1 else 0)
                else:
                    idx = _decode_trunc_bin(dec, 16)
            else:
                idx = _decode_trunc_bin(dec, 16)
            if p.ctu_filter_set is not None:
                p.ctu_filter_set[ctu_idx] = idx
            else:
                assert idx >= 16, "fixed filter set without ctu_filter_set"
        elif comp > 0 and flags[ctu_idx] and p.num_chroma_alts > 1:
            val = 0
            while val < p.num_chroma_alts - 1 and dec.decode_bin(
                    OFF["alf_ctb_alternatives"] + comp - 1):
                val += 1
            alts = p.ctu_alt_cb if comp == 1 else p.ctu_alt_cr
            if alts is not None:
                alts[ctu_idx] = val
    for comp, enabled, cflags in ((1, p.cc_cb_enabled, p.cc_flags_cb),
                                  (2, p.cc_cr_enabled, p.cc_flags_cr)):
        if not enabled:
            continue
        left = cflags[ctu_idx - 1] if ctu_idx % wl else 0
        above = cflags[ctu_idx - wl] if ctu_idx >= wl else 0
        ctx = int(bool(left)) + int(bool(above)) + (3 if comp == 2 else 0)
        cflags[ctu_idx] = bool(
            dec.decode_bin(OFF["alf_cc_filter_control_flag"] + ctx))

"""Scaling-list APS syntax (scaling_list_data) + picture-header flag.

The reference applies quant matrices without ever signaling them (its
SPS hardcodes scaling_list_enabled_flag = 0, encoder_state-bitstream.c
:691, and its cqm parser is stubbed, scalinglist.c:168). This encoder
signals them: one scaling-list APS (aps_params_type = 2) at stream
start, explicit coding per id (no inter-id prediction), mirrored by
parse_scaling_aps for the decoder oracle.

Id layout (VVC 7.3.2.21 scaling_list_data shape; within each size
class the list order is [intra Y, intra Cb, intra Cr, inter Y,
inter Cb, inter Cr]):
  0..1   2x2 chroma       -> copy default (unused; min TU here is 4x4)
  2..7   4x4              -> base (size_id 0, slot)
  8..13  8x8              -> base (size_id 1, slot)
  14..19 16x16 (+DC)      -> base (size_id 2, slot)
  20..25 32x32 (+DC)      -> luma: (3, 0/1); chroma: the 16x16 class
                             values (what the encoder actually applies)
  26..27 64x64 luma       -> copy default (64x64 TUs not produced)
Coefficients are coded as se(v) DPCM deltas from 8 along the diagonal
scan of the 4x4 or 8x8 base; DC (ids >= 14) as se(dc - 8).
"""
from __future__ import annotations

import numpy as np

from ..ops.scaling_lists import ScalingLists

_EXPLICIT_IDS = range(2, 26)
_GROUP_START = (0, 2, 8)   # ids with no pred_id_delta field


def _diag_order(n: int):
    """Up-right diagonal scan positions (y, x) of an n x n matrix."""
    out = []
    for d in range(2 * n - 1):
        for x in range(n):
            y = d - x
            if 0 <= y < n:
                out.append((y, x))
    return out


def _id_to_slot(sid: int):
    """(size_id, slot, has_dc) for an explicit id."""
    if sid < 8:
        return 0, sid - 2, False
    if sid < 14:
        return 1, sid - 8, False
    if sid < 20:
        return 2, sid - 14, True
    lst = sid - 20
    if lst in (0, 3):        # 32x32 luma
        return 3, 0 if lst == 0 else 1, True
    return 2, lst, True      # 32-class chroma signals the 16x16 values


def write_scaling_aps(bs, sl: ScalingLists) -> None:
    """Scaling-list APS RBSP payload (after the NAL header)."""
    bs.put(2, 3)   # aps_params_type = SCALING_APS
    bs.put(1, 5)   # adaptation_parameter_set_id (distinct from ALF's 0)
    bs.put(1, 1)   # aps_chroma_present_flag
    for sid in range(28):
        if sid in (0, 1, 26, 27):
            bs.put(1, 1)                    # scaling_list_copy_mode_flag
            if sid not in _GROUP_START:
                bs.put_ue(0)                # pred_id_delta -> default
            continue
        bs.put(0, 1)                        # copy_mode = 0
        bs.put(0, 1)   # pred_mode = 0 (explicit; no pred -> no id delta)
        size_id, slot, has_dc = _id_to_slot(sid)
        base = sl.base[(size_id, slot)]
        if has_dc:
            bs.put_se(sl.dc.get((size_id, slot), 16) - 8)
        n = base.shape[0]
        next_coef = 8
        for (y, x) in _diag_order(n):
            v = int(base[y, x])
            bs.put_se(v - next_coef)
            next_coef = v
    bs.put(0, 1)   # aps_extension_flag
    bs.rbsp_trailing_bits()


def parse_scaling_aps(rd) -> ScalingLists:
    """Spec-mirror parse of write_scaling_aps into a ScalingLists."""
    sl = ScalingLists.default()
    aps_type = rd.read(3)
    assert aps_type == 2, "not a scaling-list APS"
    rd.read(5)     # aps id
    rd.read(1)     # chroma present
    for sid in range(28):
        copy = rd.read_bit()
        if copy:
            if sid not in _GROUP_START:
                delta = rd.read_ue()
                assert delta == 0, "inter-id prediction not produced"
            continue
        pred = rd.read_bit()
        assert pred == 0, "pred mode not produced by this encoder"
        size_id, slot, has_dc = _id_to_slot(sid)
        if has_dc:
            sl.dc[(size_id, slot)] = 8 + rd.read_se()
        n = 4 if size_id == 0 else 8
        m = np.zeros((n, n), dtype=np.int32)
        next_coef = 8
        for (y, x) in _diag_order(n):
            next_coef = next_coef + rd.read_se()
            m[y, x] = next_coef & 255
        sl.base[(size_id, slot)] = m
    sl._cache.clear()
    return sl

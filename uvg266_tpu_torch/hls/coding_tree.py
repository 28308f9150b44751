"""Coding-tree syntax: split flags, intra modes, CBFs, TU recursion.

Encoder + parsing decoder for the supported all-intra toolset. Behavioral
parity with the reference writers:
- uvg_write_split_flag (uvg266 src/encode_coding_tree.c:1240-1363)
  and uvg_get_possible_splits (uvg266 src/cu.c:412-513)
- uvg_encode_intra_luma_coding_unit (encode_coding_tree.c:992-1237) and MPM
  derivation uvg_intra_get_dir_luma_predictor (intra.c:88-188)
- encode_chroma_intra_cu (encode_coding_tree.c:902-990)
- encode_transform_coeff / encode_transform_unit (encode_coding_tree.c:
  472-759) with the max-TU (32) implicit transform split
- uvg_encode_coding_tree (encode_coding_tree.c:1365-1730)

The decoder half mirrors the VVC parsing process over the same context
model and is part of the in-repo conformance oracle.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..bitstream.cabac import Cabac, CabacDecoder
from ..bitstream.ctx_tables import OFF
from ..consts import COLOR_U, COLOR_V, COLOR_Y, LCU_WIDTH, TR_MAX_WIDTH
from ..control.cu import (
    CU_IBC,
    CU_INTER,
    BT_HOR_SPLIT,
    BT_VER_SPLIT,
    CU_INTRA,
    NO_SPLIT,
    QT_SPLIT,
    TT_HOR_SPLIT,
    TT_VER_SPLIT,
    CtuNode,
    CuInfo,
    CuMap,
    split_locs,
)
from .residual import decode_coeff_nxn, encode_coeff_nxn

INTRA_MPM_COUNT = 6
PLANAR_IDX, DC_IDX, HOR_IDX, VER_IDX = 0, 1, 18, 50


@dataclass
class SplitState:
    """Split-tree bookkeeping threaded through the recursion
    (the reference's split_tree_t, cu.h)."""
    depth: int = 0
    mtt_depth: int = 0
    implicit_mtt_depth: int = 0
    part_index: int = 0
    chain: tuple = ()        # splits from CTU root down to (excluding) here

    def last_split(self) -> int:
        return self.chain[-1] if self.chain else NO_SPLIT


def get_implicit_split(frame_w: int, frame_h: int, x: int, y: int,
                       w: int, h: int, max_mtt_depth: int) -> int:
    right_ok = frame_w >= x + w
    bottom_ok = frame_h >= y + h
    if right_ok and bottom_ok:
        return NO_SPLIT
    if right_ok and max_mtt_depth:
        return BT_HOR_SPLIT
    if bottom_ok and max_mtt_depth:
        return BT_VER_SPLIT
    return QT_SPLIT


def get_possible_splits(cfg, frame_w: int, frame_h: int, is_irap: bool,
                        x: int, y: int, w: int, h: int,
                        st: SplitState, tree_type: int = 0):
    """Returns (can_split[6], is_implicit). cu.c:412-513.

    tree_type: 0 = BOTH/LUMA, 2 = CHROMA (dual-tree chroma pass).
    """
    slice_idx = (2 if tree_type == 2 else 0) if is_irap else 1
    max_btd = cfg.max_btt_depth[slice_idx] + st.implicit_mtt_depth
    max_bt_size = cfg.max_bt_size[slice_idx]
    min_bt_size = 4
    max_tt_size = cfg.max_tt_size[slice_idx]
    min_tt_size = 4
    min_qt_size = cfg.min_qt_size[slice_idx]

    implicit = get_implicit_split(frame_w, frame_h, x, y, w, h, max_btd)
    can = [True] * 6
    can_btt = st.mtt_depth < max_btd
    last = st.last_split()
    parl = BT_HOR_SPLIT if last == TT_HOR_SPLIT else BT_VER_SPLIT

    if st.depth != 0 and last != QT_SPLIT:
        can[QT_SPLIT] = False
    if w <= min_qt_size:
        can[QT_SPLIT] = False
    if tree_type == 2 and w <= 8:
        can[QT_SPLIT] = False

    if implicit != NO_SPLIT:
        can[NO_SPLIT] = can[TT_HOR_SPLIT] = can[TT_VER_SPLIT] = False
        can[BT_HOR_SPLIT] = implicit == BT_HOR_SPLIT and h <= max_bt_size
        can[BT_VER_SPLIT] = implicit == BT_VER_SPLIT and w <= max_bt_size
        if tree_type == 2 and w <= 8:
            can[BT_VER_SPLIT] = False
        if not can[BT_HOR_SPLIT] and not can[BT_VER_SPLIT] and not can[QT_SPLIT]:
            can[QT_SPLIT] = True
        return can, True

    if last in (TT_HOR_SPLIT, TT_VER_SPLIT) and st.part_index == 1:
        can[BT_HOR_SPLIT] = parl != BT_HOR_SPLIT
        can[BT_VER_SPLIT] = parl != BT_VER_SPLIT

    if can_btt and (w <= min_bt_size and h <= min_bt_size) \
            and (w <= min_tt_size and h <= min_tt_size):
        can_btt = False
    if can_btt and (w > max_bt_size or h > max_bt_size) \
            and (w > max_tt_size or h > max_tt_size):
        can_btt = False

    if not can_btt:
        can[BT_HOR_SPLIT] = can[TT_HOR_SPLIT] = False
        can[BT_VER_SPLIT] = can[TT_VER_SPLIT] = False
        return can, False

    if w > max_bt_size or h > max_bt_size:
        can[BT_HOR_SPLIT] = can[BT_VER_SPLIT] = False
    if h <= min_bt_size:
        can[BT_HOR_SPLIT] = False
    if w > 64 and h <= 64:
        can[BT_HOR_SPLIT] = False
    if tree_type == 2 and w * h <= 64:
        can[BT_HOR_SPLIT] = False
    if w <= min_bt_size:
        can[BT_VER_SPLIT] = False
    if w <= 64 and h > 64:
        can[BT_VER_SPLIT] = False
    if tree_type == 2 and (w * h <= 64 or w <= 8):
        can[BT_VER_SPLIT] = False
    if h <= 2 * min_tt_size or h > max_tt_size or w > max_tt_size:
        can[TT_HOR_SPLIT] = False
    if w > 64 or h > 64:
        can[TT_HOR_SPLIT] = False
    if tree_type == 2 and w * h <= 128:
        can[TT_HOR_SPLIT] = False
    if w <= 2 * min_tt_size or w > max_tt_size or h > max_tt_size:
        can[TT_VER_SPLIT] = False
    if w > 64 or h > 64:
        can[TT_VER_SPLIT] = False
    if tree_type == 2 and (w * h <= 128 or w <= 16):
        can[TT_VER_SPLIT] = False
    return can, False


def _qt_depth_of_chain(chain) -> int:
    d = 0
    for s in chain:
        if s != QT_SPLIT:
            break
        d += 1
    return d


class _SplitCtx:
    """Shared split-flag context derivation for encoder and decoder."""

    def __init__(self, cabac_like, cfg, ctrl, is_irap: bool, cu_map: CuMap,
                 chain_map: dict):
        self.c = cabac_like
        self.cfg = cfg
        self.ctrl = ctrl
        self.is_irap = is_irap
        self.cu_map = cu_map
        # (x4, y4) -> split chain tuple of the coded CU covering that unit
        self.chain_map = chain_map

    def neighbor(self, x: int, y: int):
        return self.cu_map.at(x, y)

    def split_flag_ctx(self, x, y, w, h, can):
        left = self.neighbor(x - 1, y)
        above = self.neighbor(x, y - 1)
        m = 0
        if left and (1 << left["log2_h"]) < h:
            m += 1
        if above and (1 << above["log2_w"]) < w:
            m += 1
        split_num = 0
        if can[QT_SPLIT]:
            split_num += 2
        for s in (BT_HOR_SPLIT, BT_VER_SPLIT, TT_HOR_SPLIT, TT_VER_SPLIT):
            if can[s]:
                split_num += 1
        if split_num > 0:
            split_num -= 1
        m += 3 * (split_num >> 1)
        return m

    def qt_split_ctx(self, x, y, st: SplitState):
        left_qt = top_qt = 0
        left = self.neighbor(x - 1, y)
        above = self.neighbor(x, y - 1)
        if left:
            left_qt = _qt_depth_of_chain(self.chain_map.get(((x - 1) // 4, y // 4), ()))
        if above:
            top_qt = _qt_depth_of_chain(self.chain_map.get((x // 4, (y - 1) // 4), ()))
        return ((1 if (left and left_qt > st.depth) else 0)
                + (1 if (above and top_qt > st.depth) else 0)
                + (0 if st.depth < 2 else 3))

    def mtt_vertical_ctx(self, x, y, w, h, can):
        nv = can[BT_VER_SPLIT] + can[TT_VER_SPLIT]
        nh = can[BT_HOR_SPLIT] + can[TT_HOR_SPLIT]
        if nv > nh:
            return 4
        if nv < nh:
            return 3
        left = self.neighbor(x - 1, y)
        above = self.neighbor(x, y - 1)
        d_a = w // (1 << above["log2_w"]) if above else w
        d_l = h // (1 << left["log2_h"]) if left else h
        if d_a != d_l and above and left:
            return 1 if d_a < d_l else 2
        return 0


def write_split_flag(sc: _SplitCtx, cabac: Cabac, x, y, w, h,
                     st: SplitState, split: int, tree_type: int = 0) -> bool:
    can, is_implicit = get_possible_splits(
        sc.cfg, sc.ctrl.in_width, sc.ctrl.in_height, sc.is_irap,
        x, y, w, h, st, tree_type)
    assert can[split], f"illegal split {split} at {x},{y} {w}x{h}"
    allow_split = any(can[1:])
    if can[NO_SPLIT] and allow_split:
        m = sc.split_flag_ctx(x, y, w, h, can)
        cabac.encode_bin(OFF["split_flag"] + m, 1 if split != NO_SPLIT else 0)
    if (not is_implicit or (can[QT_SPLIT] and (can[BT_HOR_SPLIT] or can[BT_VER_SPLIT]))) \
            and (can[BT_HOR_SPLIT] or can[BT_VER_SPLIT]
                 or can[TT_HOR_SPLIT] or can[TT_VER_SPLIT]) \
            and split != NO_SPLIT:
        qt_split = split == QT_SPLIT
        if (can[BT_VER_SPLIT] or can[BT_HOR_SPLIT] or can[TT_VER_SPLIT]
                or can[TT_HOR_SPLIT]) and can[QT_SPLIT]:
            m = sc.qt_split_ctx(x, y, st)
            cabac.encode_bin(OFF["qt_split_flag"] + m, 1 if qt_split else 0)
        if not qt_split:
            is_vertical = split in (BT_VER_SPLIT, TT_VER_SPLIT)
            if (can[BT_HOR_SPLIT] or can[TT_HOR_SPLIT]) and \
                    (can[BT_VER_SPLIT] or can[TT_VER_SPLIT]):
                m = sc.mtt_vertical_ctx(x, y, w, h, can)
                cabac.encode_bin(OFF["mtt_vertical"] + m, 1 if is_vertical else 0)
            if (can[BT_VER_SPLIT] and can[TT_VER_SPLIT] and is_vertical) or \
                    (can[BT_HOR_SPLIT] and can[TT_HOR_SPLIT] and not is_vertical):
                m = (2 * (1 if is_vertical else 0)) + (1 if st.mtt_depth <= 1 else 0)
                cabac.encode_bin(OFF["mtt_binary"] + m,
                                 1 if split in (BT_VER_SPLIT, BT_HOR_SPLIT) else 0)
    return is_implicit


def read_split_flag(sc: _SplitCtx, dec: CabacDecoder, x, y, w, h,
                    st: SplitState, tree_type: int = 0) -> tuple[int, bool]:
    can, is_implicit = get_possible_splits(
        sc.cfg, sc.ctrl.in_width, sc.ctrl.in_height, sc.is_irap,
        x, y, w, h, st, tree_type)
    allow_split = any(can[1:])
    split_bin = 1
    if can[NO_SPLIT] and allow_split:
        m = sc.split_flag_ctx(x, y, w, h, can)
        split_bin = dec.decode_bin(OFF["split_flag"] + m)
    elif can[NO_SPLIT] and not allow_split:
        return NO_SPLIT, is_implicit
    if not split_bin:
        return NO_SPLIT, is_implicit

    # determine which split
    if not ((not is_implicit or (can[QT_SPLIT] and (can[BT_HOR_SPLIT] or can[BT_VER_SPLIT])))
            and (can[BT_HOR_SPLIT] or can[BT_VER_SPLIT]
                 or can[TT_HOR_SPLIT] or can[TT_VER_SPLIT])):
        # only one family possible
        if can[QT_SPLIT]:
            return QT_SPLIT, is_implicit
        if can[BT_HOR_SPLIT]:
            return BT_HOR_SPLIT, is_implicit
        return BT_VER_SPLIT, is_implicit

    qt_split = can[QT_SPLIT]
    if (can[BT_VER_SPLIT] or can[BT_HOR_SPLIT] or can[TT_VER_SPLIT]
            or can[TT_HOR_SPLIT]) and can[QT_SPLIT]:
        m = sc.qt_split_ctx(x, y, st)
        qt_split = bool(dec.decode_bin(OFF["qt_split_flag"] + m))
    if qt_split:
        return QT_SPLIT, is_implicit

    if (can[BT_HOR_SPLIT] or can[TT_HOR_SPLIT]) and \
            (can[BT_VER_SPLIT] or can[TT_VER_SPLIT]):
        m = sc.mtt_vertical_ctx(x, y, w, h, can)
        is_vertical = bool(dec.decode_bin(OFF["mtt_vertical"] + m))
    else:
        is_vertical = can[BT_VER_SPLIT] or can[TT_VER_SPLIT]
    if is_vertical:
        if can[BT_VER_SPLIT] and can[TT_VER_SPLIT]:
            m = 2 + (1 if st.mtt_depth <= 1 else 0)
            return (BT_VER_SPLIT if dec.decode_bin(OFF["mtt_binary"] + m)
                    else TT_VER_SPLIT), is_implicit
        return (BT_VER_SPLIT if can[BT_VER_SPLIT] else TT_VER_SPLIT), is_implicit
    if can[BT_HOR_SPLIT] and can[TT_HOR_SPLIT]:
        m = 0 + (1 if st.mtt_depth <= 1 else 0)
        return (BT_HOR_SPLIT if dec.decode_bin(OFF["mtt_binary"] + m)
                else TT_HOR_SPLIT), is_implicit
    return (BT_HOR_SPLIT if can[BT_HOR_SPLIT] else TT_HOR_SPLIT), is_implicit


# --- intra mode coding -----------------------------------------------------

def intra_mpm_predictors(cu_map: CuMap, x: int, y: int, w: int, h: int):
    """6-entry MPM list (intra.c:88-188)."""
    left = cu_map.at(x - 1, y + h - 1) if x > 0 else None
    above = cu_map.at(x + w - 1, y - 1) if (y % LCU_WIDTH > 0 and y > 0) else None

    left_dir = 0
    if left and left["type"] == CU_INTRA:
        left_dir = 0 if left["mip_flag"] else left["intra_mode"]
    above_dir = 0
    if above and above["type"] == CU_INTRA and y % LCU_WIDTH != 0:
        above_dir = 0 if above["mip_flag"] else above["intra_mode"]

    offset, mod = 61, 64
    preds = [PLANAR_IDX, DC_IDX, VER_IDX, HOR_IDX, VER_IDX - 4, VER_IDX + 4]
    if left_dir == above_dir:
        if left_dir > DC_IDX:
            preds = [
                PLANAR_IDX,
                left_dir,
                ((left_dir + offset) % mod) + 2,
                ((left_dir - 1) % mod) + 2,
                ((left_dir + offset - 1) % mod) + 2,
                (left_dir % mod) + 2,
            ]
    else:
        if left_dir > DC_IDX and above_dir > DC_IDX:
            preds = [PLANAR_IDX, left_dir, above_dir, 0, 0, 0]
            mx = 1 if preds[1] > preds[2] else 2
            mn = 2 if preds[1] > preds[2] else 1
            d = preds[mx] - preds[mn]
            if d == 1:
                preds[3] = ((preds[mn] + offset) % mod) + 2
                preds[4] = ((preds[mx] - 1) % mod) + 2
                preds[5] = ((preds[mn] + offset - 1) % mod) + 2
            elif d >= 62:
                preds[3] = ((preds[mn] - 1) % mod) + 2
                preds[4] = ((preds[mx] + offset) % mod) + 2
                preds[5] = (preds[mn] % mod) + 2
            elif d == 2:
                preds[3] = ((preds[mn] - 1) % mod) + 2
                preds[4] = ((preds[mn] + offset) % mod) + 2
                preds[5] = ((preds[mx] - 1) % mod) + 2
            else:
                preds[3] = ((preds[mn] + offset) % mod) + 2
                preds[4] = ((preds[mn] - 1) % mod) + 2
                preds[5] = ((preds[mx] + offset) % mod) + 2
        elif left_dir + above_dir >= 2:
            m = above_dir if left_dir < above_dir else left_dir
            preds = [
                PLANAR_IDX,
                m,
                ((m + offset) % mod) + 2,
                ((m - 1) % mod) + 2,
                ((m + offset - 1) % mod) + 2,
                (m % mod) + 2,
            ]
    return preds


def _sorted_non_mpm_rank(preds, mode: int) -> int:
    """Mode index after removing the (sorted) MPM set
    (encode_coding_tree.c:1193-1234)."""
    tmp = mode
    for p in sorted(preds, reverse=True):
        if tmp > p:
            tmp -= 1
    return tmp


def _non_mpm_mode_from_rank(preds, rank: int) -> int:
    mode = rank
    for p in sorted(preds):
        if mode >= p:
            mode += 1
    return mode


def mip_flag_ctx(cu_map: CuMap, x, y, w, h) -> int:
    """uvg_get_mip_flag_context (intra.c:598)."""
    if w > 2 * h or h > 2 * w:
        return 3
    ctx = 0
    left = cu_map.at(x - 1, y) if x > 0 else None
    above = cu_map.at(x, y - 1) if y > 0 else None
    if left and left["mip_flag"]:
        ctx += 1
    if above and above["mip_flag"]:
        ctx += 1
    return ctx


def encode_intra_luma_mode(cabac: Cabac, cfg, cu: CuInfo, cu_map: CuMap) -> None:
    """uvg_encode_intra_luma_coding_unit; MIP flag/transpose/mode,
    MRL reference-line index, ISP mode/split-type, and the regular MPM
    path (encode_coding_tree.c:1046-1210)."""
    if cfg.mip:
        from ..ops.mip import mip_mode_count
        ctx = mip_flag_ctx(cu_map, cu.x, cu.y, cu.w, cu.h)
        cabac.encode_bin(OFF["mip_flag"] + ctx, 1 if cu.mip_flag else 0)
        if cu.mip_flag:
            cabac.encode_bin_ep(1 if cu.mip_transposed else 0)
            cabac.encode_trunc_bin(cu.intra_mode,
                                   mip_mode_count(cu.w, cu.h))
            return

    mrl = cu.multi_ref_idx
    if cfg.mrl and cu.y % LCU_WIDTH != 0:
        cabac.encode_bin(OFF["multi_ref_line"], 1 if mrl != 0 else 0)
        if mrl != 0:
            cabac.encode_bin(OFF["multi_ref_line"] + 1,
                             1 if mrl != 1 else 0)
    else:
        assert mrl == 0

    # ISP (intra_subpartitions_mode_flag + split type); only signaled with
    # reference line 0 (encode_coding_tree.c:1093-1106)
    if cfg.isp:
        from ..ops.isp import can_use_isp
        if can_use_isp(cu.w, cu.h) and mrl == 0:
            cabac.encode_bin(OFF["intra_subpart"],
                             1 if cu.isp_mode else 0)
            if cu.isp_mode:
                cabac.encode_bin(OFF["intra_subpart"] + 1, cu.isp_mode - 1)
        else:
            assert cu.isp_mode == 0

    preds = intra_mpm_predictors(cu_map, cu.x, cu.y, cu.w, cu.h)
    mode = cu.intra_mode
    mpm_idx = preds.index(mode) if mode in preds else -1
    if mrl == 0:
        cabac.encode_bin(OFF["intra_luma_mpm_flag"],
                         1 if mpm_idx >= 0 else 0)
    else:
        assert mpm_idx >= 1, "MRL mode must be a non-planar MPM"
    if mpm_idx >= 0:
        if mrl == 0:
            cabac.encode_bin(OFF["luma_planar"] + (0 if cu.isp_mode else 1),
                             1 if mpm_idx > 0 else 0)
        for i in range(1, 5):
            if mpm_idx > i - 1:
                cabac.encode_bin_ep(1 if mpm_idx > i else 0)
            else:
                break
    else:
        cabac.encode_trunc_bin(_sorted_non_mpm_rank(preds, mode),
                               67 - INTRA_MPM_COUNT)


def decode_intra_luma_mode(dec: CabacDecoder, cfg, x, y, w, h,
                           cu_map: CuMap, cu: CuInfo | None = None) -> int:
    if cfg.mip:
        from ..ops.mip import mip_mode_count
        ctx = mip_flag_ctx(cu_map, x, y, w, h)
        if dec.decode_bin(OFF["mip_flag"] + ctx):
            transposed = bool(dec.decode_bin_ep())
            mode = dec.decode_trunc_bin(mip_mode_count(w, h))
            if cu is not None:
                cu.mip_flag = True
                cu.mip_transposed = transposed
            return mode
    mrl = 0
    if cfg.mrl and y % LCU_WIDTH != 0:
        if dec.decode_bin(OFF["multi_ref_line"]):
            mrl = 2 if dec.decode_bin(OFF["multi_ref_line"] + 1) else 1
        if cu is not None:
            cu.multi_ref_idx = mrl
    isp_mode = 0
    if cfg.isp:
        from ..ops.isp import can_use_isp
        if can_use_isp(w, h) and mrl == 0:
            if dec.decode_bin(OFF["intra_subpart"]):
                isp_mode = 1 + dec.decode_bin(OFF["intra_subpart"] + 1)
        if cu is not None:
            cu.isp_mode = isp_mode
    preds = intra_mpm_predictors(cu_map, x, y, w, h)
    if mrl != 0:
        mpm_idx = 1
        while mpm_idx < 5 and dec.decode_bin_ep():
            mpm_idx += 1
        return preds[mpm_idx]
    if dec.decode_bin(OFF["intra_luma_mpm_flag"]):
        if not dec.decode_bin(OFF["luma_planar"] + (0 if isp_mode else 1)):
            return preds[0]
        mpm_idx = 1
        while mpm_idx < 5 and dec.decode_bin_ep():
            mpm_idx += 1
        return preds[mpm_idx]
    rank = dec.decode_trunc_bin(67 - INTRA_MPM_COUNT)
    return _non_mpm_mode_from_rank(preds, rank)


def lfnst_allowed(cfg, cu) -> bool:
    """uvg_is_lfnst_allowed (encode_coding_tree.c:109) for the single-tree
    non-ISP/MIP path; relies on the violates/last-scan accumulators filled
    while coding (or parsing) the transform coefficients."""
    if not cfg.lfnst or cu.type != CU_INTRA:
        return False
    if cu.w > TR_MAX_WIDTH or cu.h > TR_MAX_WIDTH \
            or min(cu.w, cu.h) < 4:
        return False
    if cu.mip_flag and not (cu.w >= 16 and cu.h >= 16):
        return False    # can_use_lfnst_with_mip (uvg_is_lfnst_allowed:121)
    if cu.isp_mode:
        from ..ops.isp import can_use_isp_with_lfnst
        if not can_use_isp_with_lfnst(cu.w, cu.h, cu.isp_mode):
            return False    # uvg_is_lfnst_allowed:124
    if cu.tr_idx == 1:          # transform skip
        return False
    if cu.violates_lfnst_luma or cu.violates_lfnst_chroma:
        return False
    return bool(cu.lfnst_last_scan_pos)


def accumulate_lfnst_flags(cu) -> None:
    """Derive the LFNST signaling accumulators from decoded coefficient
    blocks (parsing mirror of the writer-side accumulation)."""
    from ..ops.scan import coeff_scan_table
    cu.violates_lfnst_luma = False
    cu.violates_lfnst_chroma = False
    cu.lfnst_last_scan_pos = False
    for (color, tx, ty), blk in cu.coeffs.items():
        h, w = blk.shape
        scan = coeff_scan_table(w.bit_length() - 1, h.bit_length() - 1)
        nz = np.nonzero(blk.reshape(-1)[scan])[0]
        if len(nz) == 0:
            continue
        last = int(nz[-1])
        max_pos = 7 if (w, h) in ((4, 4), (8, 8)) else 15
        viol = (w >= 4 and h >= 4) and last > max_pos
        if color == COLOR_Y:
            cu.violates_lfnst_luma |= viol
        else:
            cu.violates_lfnst_chroma |= viol
        # last-scan-pos accumulates over LUMA AND CHROMA blocks >= 4x4
        # (uvg_derive_lfnst_constraints, transform.c:208-212)
        if w >= 4 and h >= 4:
            cu.lfnst_last_scan_pos |= last >= 1


def encode_lfnst_idx(cabac: Cabac, cfg, cu: CuInfo,
                     sep_tree: bool = False) -> None:
    """sep_tree: separate/local-dual/chroma tree — first bin takes ctx 1
    (encode_coding_tree.c encode_lfnst_idx:195-198)."""
    if not lfnst_allowed(cfg, cu):
        assert cu.lfnst_idx == 0, "lfnst set but not signalable"
        return
    cabac.encode_bin(OFF["lfnst_idx"] + (1 if sep_tree else 0),
                     1 if cu.lfnst_idx else 0)
    if cu.lfnst_idx:
        cabac.encode_bin(OFF["lfnst_idx"] + 2,
                         1 if cu.lfnst_idx == 2 else 0)


def decode_lfnst_idx(dec: CabacDecoder, cfg, cu: CuInfo,
                     sep_tree: bool = False) -> None:
    accumulate_lfnst_flags(cu)
    if not lfnst_allowed(cfg, cu):
        cu.lfnst_idx = 0
        return
    if dec.decode_bin(OFF["lfnst_idx"] + (1 if sep_tree else 0)):
        cu.lfnst_idx = 2 if dec.decode_bin(OFF["lfnst_idx"] + 2) else 1
    else:
        cu.lfnst_idx = 0


def cclm_allowed_chroma_tree(chroma_chain: tuple,
                             luma_chain: tuple) -> bool:
    """CCLM availability in the separate chroma tree
    (uvg_cclm_is_allowed, intra.c): gated on the chroma CU's first two
    split types and the co-located (top-left) luma CU's first split."""
    from ..control.cu import BT_HOR_SPLIT, BT_VER_SPLIT
    d0 = chroma_chain[0] if len(chroma_chain) > 0 else NO_SPLIT
    d1 = chroma_chain[1] if len(chroma_chain) > 1 else NO_SPLIT
    allow = (d0 == QT_SPLIT or d0 == NO_SPLIT
             or (d0 == BT_HOR_SPLIT and d1 in (BT_VER_SPLIT, NO_SPLIT)))
    if not allow:
        return False
    l0 = luma_chain[0] if luma_chain else NO_SPLIT
    return l0 == NO_SPLIT or l0 == QT_SPLIT


CHROMA_BASE_MODES = (0, 50, 18, 1)


def encode_chroma_intra_mode(cabac: Cabac, cfg, cu: CuInfo, luma_dir: int,
                             cclm_ok: bool | None = None) -> None:
    """encode_chroma_intra_cu (encode_coding_tree.c:902-990). cclm_ok
    overrides cfg.cclm for positions where CCLM is tree-disallowed
    (uvg_cclm_is_allowed)."""
    chroma_dir = cu.intra_mode_chroma
    modes = [m if m != luma_dir else 66 for m in CHROMA_BASE_MODES] + [67, 81, 82, 83]
    derived = chroma_dir == luma_dir
    cclm = chroma_dir > 67
    if cfg.cclm if cclm_ok is None else cclm_ok:
        cabac.encode_bin(OFF["cclm_flag"], 1 if cclm else 0)
        if cclm:
            cabac.encode_bin(OFF["cclm_model"], 1 if chroma_dir != 81 else 0)
            if chroma_dir != 81:
                cabac.encode_bin_ep(1 if chroma_dir == 83 else 0)
            return
    cabac.encode_bin(OFF["chroma_pred"], 0 if derived else 1)
    if not derived:
        pred_mode = modes.index(chroma_dir)
        assert pred_mode < 4, "invalid chroma mode"
        cabac.encode_bins_ep(pred_mode, 2)


def decode_chroma_intra_mode(dec: CabacDecoder, cfg, luma_dir: int,
                             cclm_ok: bool | None = None) -> int:
    modes = [m if m != luma_dir else 66 for m in CHROMA_BASE_MODES]
    if cfg.cclm if cclm_ok is None else cclm_ok:
        if dec.decode_bin(OFF["cclm_flag"]):
            if dec.decode_bin(OFF["cclm_model"]):
                return 83 if dec.decode_bin_ep() else 82
            return 81
    if not dec.decode_bin(OFF["chroma_pred"]):
        return luma_dir
    return modes[dec.decode_bins_ep(2)]


# --- transform tree --------------------------------------------------------

def _tu_split(w: int, h: int) -> int:
    if w > TR_MAX_WIDTH and h > TR_MAX_WIDTH:
        return QT_SPLIT
    if w > TR_MAX_WIDTH:
        return BT_VER_SPLIT
    if h > TR_MAX_WIDTH:
        return BT_HOR_SPLIT
    return NO_SPLIT


def write_qp_delta(cabac, cu: CuInfo, qp_state: dict) -> None:
    """cu_qp_delta_abs/sign for the current quantization group
    (encode_coding_tree.c:721-742): tu-ctx unary-max prefix (cutoff 5)
    + EG0 suffix + EP sign."""
    delta = cu.qp - qp_state["pred"]
    abs_d = abs(delta)
    cabac.write_unary_max_symbol(OFF["cu_qp_delta_abs"], min(abs_d, 5),
                                 1, 5)
    if abs_d >= 5:
        cabac.write_ep_ex_golomb(abs_d - 5, 0)
    if delta:
        cabac.encode_bin_ep(0 if delta >= 0 else 1)
    qp_state["must_code"] = False
    qp_state["qp"] = cu.qp


def parse_qp_delta(dec, qp_state: dict) -> None:
    abs_d = dec.decode_unary_max_symbol(OFF["cu_qp_delta_abs"], 1, 5)
    if abs_d >= 5:
        abs_d = 5 + dec.decode_ep_ex_golomb(0)
    delta = abs_d
    if abs_d and dec.decode_bin_ep():
        delta = -abs_d
    qp_state["qp"] = qp_state["pred"] + delta
    qp_state["must_code"] = False


def encode_transform_coeff(cabac: Cabac, cfg, cu: CuInfo, ctrl,
                           tx: int, ty: int, tw: int, th: int,
                           luma_cbf_ctx: list, has_chroma: bool = True,
                           tree_type: int = 0, qp_state=None) -> None:
    """encode_transform_coeff for the non-ISP intra path
    (encode_coding_tree.c:628-759). tree_type 1 = dual-tree luma pass
    (no chroma syntax), 2 = dual-tree chroma pass (no luma syntax)."""
    split = _tu_split(tw, th)
    if split != NO_SPLIT:
        for (sx, sy, sw, sh) in split_locs(tx, ty, tw, th, split):
            if sx >= ctrl.in_width or sy >= ctrl.in_height:
                continue
            encode_transform_coeff(cabac, cfg, cu, ctrl, sx, sy, sw, sh,
                                   luma_cbf_ctx, has_chroma, tree_type,
                                   qp_state)
        return

    rel = ((tx - cu.x) // TR_MAX_WIDTH, (ty - cu.y) // TR_MAX_WIDTH)
    cbf_y = cu.cbf_set(COLOR_Y, *rel) if tree_type != 2 else 0
    cbf_u = cu.cbf_set(COLOR_U, *rel) if tree_type != 1 else 0
    cbf_v = cu.cbf_set(COLOR_V, *rel) if tree_type != 1 else 0

    if ctrl.chroma_format != 0 and has_chroma and tree_type != 1:
        cabac.encode_bin(OFF["qt_cbf_cb"], cbf_u)
        cabac.encode_bin(OFF["qt_cbf_cr"] + (1 if cbf_u else 0), cbf_v)
    # luma cbf: signaled for intra / split TU / when chroma has coeffs,
    # inferred 1 otherwise (encode_coding_tree.c:702-718)
    pu_is_tu = cu.w <= TR_MAX_WIDTH and cu.h <= TR_MAX_WIDTH
    if tree_type == 2:
        pass
    elif cu.type == 1 or not pu_is_tu or cbf_u or cbf_v:
        cabac.encode_bin(OFF["qt_cbf_luma"] + luma_cbf_ctx[0], cbf_y)
        if pu_is_tu:
            luma_cbf_ctx[0] = 2 + cbf_y
    else:
        assert cbf_y == 1, "inter luma cbf inferred 1"

    if not (cbf_y or cbf_u or cbf_v):
        return
    if qp_state is not None and qp_state["must_code"] and tree_type != 2:
        write_qp_delta(cabac, cu, qp_state)
    if cfg.jccr and (((cbf_u or cbf_v) and cu.type == 1)
                     or (cbf_u and cbf_v)):
        cabac.encode_bin(OFF["joint_cb_cr"] + (cbf_u * 2 + cbf_v - 1),
                         1 if cu.joint_cb_cr.get(rel) else 0)

    if cbf_y:
        ts_ok = cfg.trskip_enable \
            and tw <= (1 << cfg.trskip_max_size) \
            and th <= (1 << cfg.trskip_max_size) \
            and cu.isp_mode == 0
        is_ts = cu.tr_idx == 1
        if ts_ok:
            cabac.encode_bin(OFF["transform_skip_luma"], 1 if is_ts else 0)
        if is_ts:
            from .ts_residual import encode_ts_residual
            encode_ts_residual(cabac, cu.coeffs[(COLOR_Y, *rel)])
        else:
            info = encode_coeff_nxn(cabac, cu.coeffs[(COLOR_Y, *rel)], True,
                                    cfg.dep_quant, cfg.signhide_enable)
            cu.violates_lfnst_luma |= info["violates_lfnst"]
            cu.lfnst_last_scan_pos |= info["lfnst_last_scan_pos"]
            cu.mts_last_scan_pos |= info["mts_last_scan_pos"]
    if has_chroma and tree_type != 1:
        ch_ge4 = tw >= 8 and th >= 8     # 4:2:0 chroma block >= 4x4
        # chroma transform_skip_flag: written for every coded chroma
        # block whose dims fit tr-skip-max-size whenever trskip is on —
        # even with chroma transform skip unused, the bin is present
        # (encode_coding_tree.c:494-524)
        twc = min(tw, cu.w) >> 1
        thc = min(th, cu.h) >> 1
        ts_c_ok = cfg.trskip_enable \
            and twc <= (1 << cfg.trskip_max_size) \
            and thc <= (1 << cfg.trskip_max_size)
        if cbf_u:
            if ts_c_ok:
                cabac.encode_bin(OFF["transform_skip_chroma"], 0)
            info = encode_coeff_nxn(cabac, cu.coeffs[(COLOR_U, *rel)], False,
                                    cfg.dep_quant, cfg.signhide_enable)
            cu.violates_lfnst_chroma |= info["violates_lfnst"]
            if ch_ge4:
                cu.lfnst_last_scan_pos |= info["lfnst_last_scan_pos"]
        if cbf_v and not (cu.joint_cb_cr.get(rel) and cbf_u):
            if ts_c_ok:
                cabac.encode_bin(OFF["transform_skip_chroma"], 0)
            info = encode_coeff_nxn(cabac, cu.coeffs[(COLOR_V, *rel)], False,
                                    cfg.dep_quant, cfg.signhide_enable)
            cu.violates_lfnst_chroma |= info["violates_lfnst"]
            if ch_ge4:
                cu.lfnst_last_scan_pos |= info["lfnst_last_scan_pos"]


def decode_transform_coeff(dec: CabacDecoder, cfg, cu: CuInfo, ctrl,
                           tx: int, ty: int, tw: int, th: int,
                           luma_cbf_ctx: list, has_chroma: bool = True,
                           tree_type: int = 0, qp_state=None) -> None:
    split = _tu_split(tw, th)
    if split != NO_SPLIT:
        for (sx, sy, sw, sh) in split_locs(tx, ty, tw, th, split):
            if sx >= ctrl.in_width or sy >= ctrl.in_height:
                continue
            decode_transform_coeff(dec, cfg, cu, ctrl, sx, sy, sw, sh,
                                   luma_cbf_ctx, has_chroma, tree_type,
                                   qp_state)
        return

    rel = ((tx - cu.x) // TR_MAX_WIDTH, (ty - cu.y) // TR_MAX_WIDTH)
    tw_c = min(tw, cu.w) >> 1
    th_c = min(th, cu.h) >> 1
    cbf_u = cbf_v = 0
    if ctrl.chroma_format != 0 and has_chroma and tree_type != 1:
        cbf_u = dec.decode_bin(OFF["qt_cbf_cb"])
        cbf_v = dec.decode_bin(OFF["qt_cbf_cr"] + (1 if cbf_u else 0))
    pu_is_tu = cu.w <= TR_MAX_WIDTH and cu.h <= TR_MAX_WIDTH
    if tree_type == 2:
        cbf_y = 0
    elif cu.type == 1 or not pu_is_tu or cbf_u or cbf_v:
        cbf_y = dec.decode_bin(OFF["qt_cbf_luma"] + luma_cbf_ctx[0])
        if pu_is_tu:
            luma_cbf_ctx[0] = 2 + cbf_y
    else:
        cbf_y = 1
    cu.cbf[(COLOR_Y, *rel)] = cbf_y
    cu.cbf[(COLOR_U, *rel)] = cbf_u
    cu.cbf[(COLOR_V, *rel)] = cbf_v
    if not (cbf_y or cbf_u or cbf_v):
        return
    if qp_state is not None and qp_state["must_code"] and tree_type != 2:
        parse_qp_delta(dec, qp_state)
    # signaled for intra with any chroma cbf, inter only with both
    # (encode_coding_tree.c:745-750)
    if cfg.jccr and (((cbf_u or cbf_v) and cu.type == 1)
                     or (cbf_u and cbf_v)):
        if dec.decode_bin(OFF["joint_cb_cr"] + (cbf_u * 2 + cbf_v - 1)):
            # TuCResMode (VVC 7.4.12.10): (cbf_u,cbf_v) (1,0)->1 (1,1)->2
            # (0,1)->3; the joint residual is coded in the Cb TU for
            # modes 1-2 and in the Cr TU for mode 3
            cu.joint_cb_cr[rel] = {(1, 0): 1, (1, 1): 2, (0, 1): 3}[
                (cbf_u, cbf_v)]
    if cbf_y:
        ts_ok = cfg.trskip_enable \
            and tw <= (1 << cfg.trskip_max_size) \
            and th <= (1 << cfg.trskip_max_size) \
            and cu.isp_mode == 0
        is_ts = False
        if ts_ok:
            is_ts = bool(dec.decode_bin(OFF["transform_skip_luma"]))
        if is_ts:
            from .ts_residual import decode_ts_residual
            cu.tr_idx = 1
            cu.coeffs[(COLOR_Y, *rel)] = decode_ts_residual(dec, tw, th) \
                .astype(np.int16)
        else:
            cu.coeffs[(COLOR_Y, *rel)] = decode_coeff_nxn(
                dec, tw, th, True, cfg.dep_quant, cfg.signhide_enable)
    if has_chroma and tree_type != 1:
        ts_c_ok = cfg.trskip_enable \
            and tw_c <= (1 << cfg.trskip_max_size) \
            and th_c <= (1 << cfg.trskip_max_size)
        if cbf_u:
            if ts_c_ok and dec.decode_bin(OFF["transform_skip_chroma"]):
                raise NotImplementedError(
                    "chroma transform skip (--chroma-transform-skip)")
            cu.coeffs[(COLOR_U, *rel)] = decode_coeff_nxn(
                dec, tw_c, th_c, False, cfg.dep_quant, cfg.signhide_enable)
        # V coefficients are absent only for joint modes 1-2 (the joint
        # residual rides the Cb TU); mode 3 codes it in the Cr TU
        if cbf_v and not (cu.joint_cb_cr.get(rel) and cbf_u):
            if ts_c_ok and dec.decode_bin(OFF["transform_skip_chroma"]):
                raise NotImplementedError(
                    "chroma transform skip (--chroma-transform-skip)")
            cu.coeffs[(COLOR_V, *rel)] = decode_coeff_nxn(
                dec, tw_c, th_c, False, cfg.dep_quant, cfg.signhide_enable)


def encode_transform_coeff_isp(cabac: Cabac, cfg, cu: CuInfo, ctrl,
                               tree_type: int = 0,
                               has_chroma: bool = True) -> None:
    """Transform-coefficient coding of an ISP-split intra CU: 2/4 luma
    sub-TUs, chroma and JCCR only at the last split, last luma cbf
    inferred 1 when the earlier splits all coded 0
    (encode_coding_tree.c:1667-1687, :692-716).

    Luma sub-TU coefficients live under rel key (i, -1); the CU-level
    chroma TU keeps rel (0, 0)."""
    from ..ops.isp import isp_tu_locs
    locs = isp_tu_locs(cu.x, cu.y, cu.w, cu.h, cu.isp_mode)
    n = len(locs)
    luma_cbf_ctx = 2
    can_skip_last = True
    chroma_on = ctrl.chroma_format != 0 and has_chroma and tree_type != 1
    for i, (tx, ty, tw, th) in enumerate(locs):
        last = (i + 1 == n)
        rel = (i, -1)
        cbf_y = cu.cbf_set(COLOR_Y, *rel)
        cbf_u = cbf_v = 0
        if last and chroma_on:
            cbf_u = cu.cbf_set(COLOR_U, 0, 0)
            cbf_v = cu.cbf_set(COLOR_V, 0, 0)
            cabac.encode_bin(OFF["qt_cbf_cb"], cbf_u)
            cabac.encode_bin(OFF["qt_cbf_cr"] + (1 if cbf_u else 0), cbf_v)
        if last and can_skip_last:
            assert cbf_y == 1, "last ISP cbf inferred 1"
        else:
            cabac.encode_bin(OFF["qt_cbf_luma"] + luma_cbf_ctx, cbf_y)
            luma_cbf_ctx = 2 + cbf_y
        can_skip_last &= (cbf_y == 0)
        if not (cbf_y or cbf_u or cbf_v):
            continue
        if last and chroma_on and cfg.jccr and (cbf_u or cbf_v):
            cabac.encode_bin(OFF["joint_cb_cr"] + (cbf_u * 2 + cbf_v - 1),
                             1 if cu.joint_cb_cr.get((0, 0)) else 0)
        if cbf_y:
            info = encode_coeff_nxn(cabac, cu.coeffs[(COLOR_Y, *rel)], True,
                                    cfg.dep_quant, cfg.signhide_enable)
            if tw >= 4 and th >= 4:
                cu.violates_lfnst_luma |= info["violates_lfnst"]
                cu.lfnst_last_scan_pos |= info["lfnst_last_scan_pos"]
            else:
                # sub-4 TUs: LFNST is not signalable with this split shape
                # (uvg_can_use_isp_with_lfnst); nothing accumulates
                pass
        if last and chroma_on:
            ts_c_ok = cfg.trskip_enable \
                and (cu.w >> 1) <= (1 << cfg.trskip_max_size) \
                and (cu.h >> 1) <= (1 << cfg.trskip_max_size)
            if cbf_u:
                if ts_c_ok:
                    cabac.encode_bin(OFF["transform_skip_chroma"], 0)
                info = encode_coeff_nxn(cabac, cu.coeffs[(COLOR_U, 0, 0)],
                                        False, cfg.dep_quant,
                                        cfg.signhide_enable)
                cu.violates_lfnst_chroma |= info["violates_lfnst"]
            if cbf_v and not (cu.joint_cb_cr.get((0, 0)) and cbf_u):
                if ts_c_ok:
                    cabac.encode_bin(OFF["transform_skip_chroma"], 0)
                info = encode_coeff_nxn(cabac, cu.coeffs[(COLOR_V, 0, 0)],
                                        False, cfg.dep_quant,
                                        cfg.signhide_enable)
                cu.violates_lfnst_chroma |= info["violates_lfnst"]


def decode_transform_coeff_isp(dec: CabacDecoder, cfg, cu: CuInfo, ctrl,
                               tree_type: int = 0,
                               has_chroma: bool = True) -> None:
    from ..ops.isp import isp_tu_locs
    locs = isp_tu_locs(cu.x, cu.y, cu.w, cu.h, cu.isp_mode)
    n = len(locs)
    luma_cbf_ctx = 2
    can_skip_last = True
    chroma_on = ctrl.chroma_format != 0 and has_chroma and tree_type != 1
    cw, ch = cu.w >> 1, cu.h >> 1
    for i, (tx, ty, tw, th) in enumerate(locs):
        last = (i + 1 == n)
        rel = (i, -1)
        cbf_u = cbf_v = 0
        if last and chroma_on:
            cbf_u = dec.decode_bin(OFF["qt_cbf_cb"])
            cbf_v = dec.decode_bin(OFF["qt_cbf_cr"] + (1 if cbf_u else 0))
            cu.cbf[(COLOR_U, 0, 0)] = cbf_u
            cu.cbf[(COLOR_V, 0, 0)] = cbf_v
        if last and can_skip_last:
            cbf_y = 1
        else:
            cbf_y = dec.decode_bin(OFF["qt_cbf_luma"] + luma_cbf_ctx)
            luma_cbf_ctx = 2 + cbf_y
        cu.cbf[(COLOR_Y, *rel)] = cbf_y
        can_skip_last &= (cbf_y == 0)
        if not (cbf_y or cbf_u or cbf_v):
            continue
        if last and chroma_on and cfg.jccr and (cbf_u or cbf_v):
            if dec.decode_bin(OFF["joint_cb_cr"] + (cbf_u * 2 + cbf_v - 1)):
                cu.joint_cb_cr[(0, 0)] = {(1, 0): 1, (1, 1): 2,
                                          (0, 1): 3}[(cbf_u, cbf_v)]
        if cbf_y:
            cu.coeffs[(COLOR_Y, *rel)] = decode_coeff_nxn(
                dec, tw, th, True, cfg.dep_quant, cfg.signhide_enable)
        if last and chroma_on:
            if cbf_u:
                if cfg.trskip_enable \
                        and cw <= (1 << cfg.trskip_max_size) \
                        and ch <= (1 << cfg.trskip_max_size) \
                        and dec.decode_bin(OFF["transform_skip_chroma"]):
                    raise NotImplementedError("chroma transform skip")
                cu.coeffs[(COLOR_U, 0, 0)] = decode_coeff_nxn(
                    dec, cw, ch, False, cfg.dep_quant, cfg.signhide_enable)
            if cbf_v and not (cu.joint_cb_cr.get((0, 0)) and cbf_u):
                if cfg.trskip_enable \
                        and cw <= (1 << cfg.trskip_max_size) \
                        and ch <= (1 << cfg.trskip_max_size) \
                        and dec.decode_bin(OFF["transform_skip_chroma"]):
                    raise NotImplementedError("chroma transform skip")
                cu.coeffs[(COLOR_V, 0, 0)] = decode_coeff_nxn(
                    dec, cw, ch, False, cfg.dep_quant, cfg.signhide_enable)


# --- inter CU syntax -------------------------------------------------------

def encode_merge_idx(cabac: Cabac, merge_idx: int, max_merge: int) -> None:
    """Unary merge index: first bin context-coded (encode_coding_tree.c:
    1499-1513), rest bypass."""
    if max_merge <= 1:
        return
    for ui in range(max_merge - 1):
        symbol = 1 if ui != merge_idx else 0
        if ui == 0:
            cabac.encode_bin(OFF["cu_merge_idx_ext"], symbol)
        else:
            cabac.encode_bin_ep(symbol)
        if symbol == 0:
            break


def decode_merge_idx(dec: CabacDecoder, max_merge: int) -> int:
    if max_merge <= 1:
        return 0
    if not dec.decode_bin(OFF["cu_merge_idx_ext"]):
        return 0
    idx = 1
    while idx < max_merge - 1 and dec.decode_bin_ep():
        idx += 1
    return idx


def encode_mvd(cabac: Cabac, mvd_hor: int, mvd_ver: int) -> None:
    """uvg_encode_mvd (encode_coding_tree.c:1865): greater0/greater1 flags,
    EG1 remainder, sign. mvd components in quarter-pel."""
    h0 = mvd_hor != 0
    v0 = mvd_ver != 0
    cabac.encode_bin(OFF["cu_mvd"], 1 if h0 else 0)
    cabac.encode_bin(OFF["cu_mvd"], 1 if v0 else 0)
    ah, av = abs(mvd_hor), abs(mvd_ver)
    if h0:
        cabac.encode_bin(OFF["cu_mvd"] + 1, 1 if ah > 1 else 0)
    if v0:
        cabac.encode_bin(OFF["cu_mvd"] + 1, 1 if av > 1 else 0)
    if h0:
        if ah > 1:
            cabac.write_ep_ex_golomb(ah - 2, 1)
        cabac.encode_bin_ep(0 if mvd_hor > 0 else 1)
    if v0:
        if av > 1:
            cabac.write_ep_ex_golomb(av - 2, 1)
        cabac.encode_bin_ep(0 if mvd_ver > 0 else 1)


def decode_mvd(dec: CabacDecoder) -> tuple[int, int]:
    h0 = dec.decode_bin(OFF["cu_mvd"])
    v0 = dec.decode_bin(OFF["cu_mvd"])
    h1 = dec.decode_bin(OFF["cu_mvd"] + 1) if h0 else 0
    v1 = dec.decode_bin(OFF["cu_mvd"] + 1) if v0 else 0
    mvd_hor = mvd_ver = 0
    if h0:
        a = (dec.decode_ep_ex_golomb(1) + 2) if h1 else 1
        mvd_hor = -a if dec.decode_bin_ep() else a
    if v0:
        a = (dec.decode_ep_ex_golomb(1) + 2) if v1 else 1
        mvd_ver = -a if dec.decode_bin_ep() else a
    return mvd_hor, mvd_ver


# --- MTS index (encode_coding_tree.c:50-105) -------------------------------

def _mts_coeff_flags(coeff: np.ndarray):
    """(mts_last_scan_pos, violates_mts_constraint) from final luma coeffs —
    computed identically by encoder and decoder so the signaling condition
    stays in sync (uvg_is_mts_allowed, encode_coding_tree-generic.c:310-322)."""
    from ..ops.scan import cg_scan_table, coeff_scan_table, log2_sbb_size
    h, w = coeff.shape
    lw, lh = w.bit_length() - 1, h.bit_length() - 1
    scan = coeff_scan_table(lw, lh)
    flat = coeff.reshape(-1)
    nz = np.nonzero(flat[scan])[0]
    if len(nz) == 0:
        return False, False
    last = int(nz[-1])
    sw, sh = log2_sbb_size(lw, lh)
    cg_grid_w = w >> sw
    violates = False
    for i in nz:
        cg = int(scan[int(i)]) // w >> sh, (int(scan[int(i)]) % w) >> sw
        if cg[0] > 3 or cg[1] > 3:
            violates = True
            break
    return last > 0, violates


def mts_signaling_allowed(cfg, cu: CuInfo) -> bool:
    mts_type = cfg.mts
    if not (mts_type == 3 or (cu.type == CU_INTRA and mts_type == 1)
            or (cu.type == CU_INTER and mts_type == 2)):
        return False
    if cu.w > 32 or cu.h > 32 or cu.isp_mode or cu.lfnst_idx:
        return False
    if cu.tr_idx == 1:      # transform skip (uvg_is_mts_allowed:65)
        return False
    if not cu.cbf_set(COLOR_Y):
        return False
    last_ok, violates = _mts_coeff_flags(cu.coeffs[(COLOR_Y, 0, 0)])
    return last_ok and not violates


def encode_mts_idx(cabac: Cabac, cfg, cu: CuInfo) -> None:
    if not mts_signaling_allowed(cfg, cu):
        assert cu.tr_idx in (0, 1), "chosen MTS not signalable"
        return
    symbol = 1 if cu.tr_idx != 0 else 0
    cabac.encode_bin(OFF["mts_idx"], symbol)
    if symbol:
        for i in range(3):
            sym = 1 if cu.tr_idx > i + 2 else 0
            cabac.encode_bin(OFF["mts_idx"] + 1 + i, sym)
            if not sym:
                break


def decode_mts_idx(dec: CabacDecoder, cfg, cu: CuInfo) -> int:
    if not mts_signaling_allowed(cfg, cu):
        return cu.tr_idx    # keep a parsed transform-skip (tr_idx == 1)
    if not dec.decode_bin(OFF["mts_idx"]):
        return 0
    idx = 2
    for i in range(3):
        if dec.decode_bin(OFF["mts_idx"] + 1 + i):
            idx += 1
        else:
            break
    return idx


# --- coding tree -----------------------------------------------------------

class CodingTreeWriter:
    """Per-slice coding-tree syntax writer (uvg_encode_coding_tree)."""

    def __init__(self, cabac: Cabac, cfg, ctrl, is_irap: bool = True,
                 is_intra_slice: bool = True, num_ref: int = 0,
                 is_b_slice: bool = False):
        self.cabac = cabac
        self.cfg = cfg
        self.ctrl = ctrl
        self.is_irap = is_irap
        self.is_intra_slice = is_intra_slice
        self.num_ref = num_ref if isinstance(num_ref, tuple) \
            else (num_ref, num_ref)
        self.is_b_slice = is_b_slice
        self.cu_map = CuMap(ctrl.in_width, ctrl.in_height)
        self.chain_map: dict = {}
        self.sc = _SplitCtx(cabac, cfg, ctrl, is_irap, self.cu_map,
                            self.chain_map)
        self.qp_state = None

    def enable_qp_delta(self, slice_qp: int) -> None:
        """Activate cu_qp_delta signaling (QG = CTU,
        ph_cu_qp_delta_subdiv 0); the CUs' .qp fields must carry the
        final per-CU QPs (control.encoder.assign_cu_qps)."""
        self.qp_state = {"must_code": False, "pred": slice_qp,
                         "qp": slice_qp, "last_qp": slice_qp,
                         "last_cu_qp": slice_qp}

    def ctu_qp_pred(self, x: int, y: int) -> int:
        """QG predictor at a CTU start (uvg_get_cu_ref_qp,
        encoderstate.c:2214-2239 with QG = CTU): the above CTU's
        bottom-left QP at a row start, else the running last_qp. With
        tiles the rule applies in TILE-local coordinates (each tile
        codes against a sub-image view, so x_qg==0 means the tile's
        left column and 'above' stays within the tile)."""
        tx0, ty0 = 0, 0
        if self.ctrl.tiles_enable:
            t = self.ctrl.tile_index_of_ctu(x // 64, y // 64)
            tx0, ty0, _x1, _y1 = self.ctrl.tile_bounds_px(t)
        if x == tx0 and y > ty0:
            return int(self.cu_map.qp[(y - 1) // 4, x // 4])
        return self.qp_state["last_qp"]

    def encode_ctu(self, node: CtuNode, tree_type: int = 0) -> None:
        if tree_type == 2 and not hasattr(self, "cu_map_c"):
            # dual-tree chroma pass keeps its own availability state
            self.cu_map_c = CuMap(self.ctrl.in_width, self.ctrl.in_height)
            self.chain_map_c: dict = {}
            self.sc_c = _SplitCtx(self.cabac, self.cfg, self.ctrl,
                                  self.is_irap, self.cu_map_c,
                                  self.chain_map_c)
        if self.qp_state is not None and tree_type != 2:
            self.qp_state["pred"] = self.ctu_qp_pred(node.x, node.y)
            self.qp_state["qp"] = self.qp_state["pred"]
            self.qp_state["must_code"] = True
        self._encode_node(node, SplitState(), tree_type)
        if self.qp_state is not None and tree_type != 2:
            self.qp_state["last_qp"] = self.qp_state["last_cu_qp"]

    def _encode_node(self, node: CtuNode, st: SplitState,
                     tree_type: int = 0) -> None:
        x, y, w, h = node.x, node.y, node.w, node.h
        if x >= self.ctrl.in_width or y >= self.ctrl.in_height:
            return
        sc = self.sc_c if tree_type == 2 else self.sc
        sc.c = self.cabac
        if w + h > 8:
            is_implicit = write_split_flag(
                sc, self.cabac, x, y, w, h, st, node.split, tree_type)
            if node.split != NO_SPLIT:
                for i, child in enumerate(node.children):
                    child_st = SplitState(
                        depth=st.depth + 1,
                        mtt_depth=st.mtt_depth + (node.split != QT_SPLIT),
                        implicit_mtt_depth=st.implicit_mtt_depth
                        + (1 if (node.split != QT_SPLIT and is_implicit) else 0),
                        part_index=i,
                        chain=st.chain + (node.split,),
                    )
                    self._encode_node(child, child_st, tree_type)
                return
        self._encode_cu(node.cu, st, tree_type)

    def _encode_cu(self, cu: CuInfo, st: SplitState,
                   tree_type: int = 0) -> None:
        cabac = self.cabac
        if tree_type == 2:
            # dual-tree chroma CU: chroma mode (DM from the co-located
            # luma CU center) + chroma transform tree only
            luma = self.cu_map.at(cu.x + cu.w // 2, cu.y + cu.h // 2)
            luma_dir = 0 if (luma is None or luma["mip_flag"]) \
                else luma["intra_mode"]
            cclm_ok = self.cfg.cclm and cclm_allowed_chroma_tree(
                st.chain, self.chain_map.get((cu.x // 4, cu.y // 4), ()))
            encode_chroma_intra_mode(self.cabac, self.cfg, cu, luma_dir,
                                     cclm_ok=cclm_ok)
            luma_cbf_ctx = [0]
            encode_transform_coeff(self.cabac, self.cfg, cu, self.ctrl,
                                   cu.x, cu.y, cu.w, cu.h, luma_cbf_ctx,
                                   tree_type=2)
            if self.cfg.lfnst:
                encode_lfnst_idx(self.cabac, self.cfg, cu, sep_tree=True)
            self.cu_map_c.set_cu(cu)
            for yy in range(cu.y // 4, (cu.y + cu.h) // 4):
                for xx in range(cu.x // 4, (cu.x + cu.w) // 4):
                    self.chain_map_c[(xx, yy)] = st.chain
            return
        # skip flag (uvg_encode_coding_tree:1471-1528); with IBC enabled
        # the skip flag is also coded in I slices (for CUs <= 64x64) and
        # an ibc_flag distinguishes IBC from intra/inter. Flag order
        # mirrors the reference exactly: skip [+ibc_flag if skipped in
        # P/B], then ibc_flag when (I-slice or w==4), then pred_mode in
        # P/B (non-4x4) followed by ibc_flag when coded as non-intra.
        ibc_cfg = bool(getattr(self.cfg, "ibc", 0))
        left = self.cu_map.at(cu.x - 1, cu.y)
        above = self.cu_map.at(cu.x, cu.y - 1)

        def _ibc_flag():
            ctx_ibc = (1 if (left and left["type"] == CU_IBC) else 0) \
                + (1 if (above and above["type"] == CU_IBC) else 0)
            cabac.encode_bin(OFF["ibc_flag"] + ctx_ibc,
                             1 if cu.type == CU_IBC else 0)

        if not self.is_intra_slice or ibc_cfg:
            if (cu.w != 4 or cu.h != 4) and not self.is_intra_slice \
                    or (ibc_cfg and cu.w <= 64 and cu.h <= 64):
                ctx_skip = (1 if (left and left["skipped"]) else 0) \
                    + (1 if (above and above["skipped"]) else 0)
                cabac.encode_bin(OFF["cu_skip_flag"] + ctx_skip,
                                 1 if cu.skipped else 0)
            if cu.skipped:
                if ibc_cfg and not self.is_intra_slice:
                    _ibc_flag()
                encode_merge_idx(cabac, cu.merge_idx, self.cfg.max_merge)
                self._register(cu, st)
                return
            if (self.is_intra_slice or cu.w == 4) and ibc_cfg:
                _ibc_flag()
            if not self.is_intra_slice and (cu.w != 4 or cu.h != 4):
                ctx_pm = 1 if ((left and left["type"] == CU_INTRA)
                               or (above and above["type"] == CU_INTRA)) \
                    else 0
                cabac.encode_bin(OFF["cu_pred_mode"] + ctx_pm,
                                 1 if cu.type == CU_INTRA else 0)
                if ibc_cfg and cu.type != CU_INTRA:
                    _ibc_flag()

        if cu.type == CU_IBC:
            # IBC PU: merge flag + merge idx, or full-pel MVD + mvp idx
            # (uvg_encode_inter_prediction_unit, CU_IBC arms)
            cabac.encode_bin(OFF["cu_merge_flag_ext"], 1 if cu.merged else 0)
            if cu.merged:
                encode_merge_idx(cabac, cu.merge_idx, self.cfg.max_merge)
            else:
                encode_mvd(cabac, cu.mvd[0][0], cu.mvd[0][1])
                cabac.encode_bin(OFF["mvp_idx"], cu.mv_cand_idx
                                 if not isinstance(cu.mv_cand_idx, tuple)
                                 else cu.mv_cand_idx[0])
            has_coeffs = any(cu.cbf.values())
            if not cu.merged:
                cabac.encode_bin(OFF["cu_qt_root_cbf"],
                                 1 if has_coeffs else 0)
            if has_coeffs or cu.merged:
                luma_cbf_ctx = [0]
                encode_transform_coeff(self.cabac, self.cfg, cu, self.ctrl,
                                       cu.x, cu.y, cu.w, cu.h, luma_cbf_ctx,
                                       qp_state=self.qp_state)
            self._register(cu, st)
            return

        if cu.type == CU_INTER:
            cabac.encode_bin(OFF["cu_merge_flag_ext"], 1 if cu.merged else 0)
            if cu.merged:
                encode_merge_idx(cabac, cu.merge_idx, self.cfg.max_merge)
            else:
                if self.is_b_slice:
                    # inter_pred_idc (encode_coding_tree.c:814-826)
                    if cu.w + cu.h > 12:
                        ctx = 7 - (((cu.w.bit_length() - 1)
                                    + (cu.h.bit_length() - 1) + 1) >> 1)
                        cabac.encode_bin(OFF["inter_dir"] + ctx,
                                         1 if cu.mv_dir == 3 else 0)
                    if cu.mv_dir < 3:
                        cabac.encode_bin(OFF["inter_dir"] + 5,
                                         1 if cu.mv_dir == 2 else 0)
                for l in range(2):
                    if not (cu.mv_dir & (1 << l)):
                        continue
                    nref = self.num_ref[l]
                    if nref > 1:
                        ref = cu.mv_ref[l]
                        cabac.encode_bin(OFF["cu_ref_pic"],
                                         1 if ref != 0 else 0)
                        if ref > 0 and nref > 2:
                            cabac.encode_bin(OFF["cu_ref_pic"] + 1,
                                             1 if ref > 1 else 0)
                            if ref > 1 and nref > 3:
                                for idx in range(3, nref):
                                    val = 1 if ref > idx - 1 else 0
                                    cabac.encode_bin_ep(val)
                                    if not val:
                                        break
                    encode_mvd(cabac, cu.mvd[l][0], cu.mvd[l][1])
                    cabac.encode_bin(OFF["mvp_idx"], cu.mv_cand_idx
                                     if not isinstance(cu.mv_cand_idx, tuple)
                                     else cu.mv_cand_idx[l])
            # AMVR (imv) resolution flags (encode_coding_tree.c:1619-1632);
            # quarter-pel (OFF) is always selected, matching the reference
            # writer's fixed choice
            if self.cfg.amvr and not cu.merged \
                    and any(cu.mvd[l] != (0, 0) for l in range(2)
                            if cu.mv_dir & (1 << l)):
                cabac.encode_bin(OFF["imv_flag"], 0)
            has_coeffs = any(cu.cbf.values())
            if not cu.merged:
                cabac.encode_bin(OFF["cu_qt_root_cbf"], 1 if has_coeffs else 0)
            if has_coeffs or cu.merged:
                luma_cbf_ctx = [0]
                encode_transform_coeff(self.cabac, self.cfg, cu, self.ctrl,
                                       cu.x, cu.y, cu.w, cu.h, luma_cbf_ctx,
                                       qp_state=self.qp_state)
            self._register(cu, st)
            return

        assert cu.type == CU_INTRA
        encode_intra_luma_mode(self.cabac, self.cfg, cu, self.cu_map)
        if self.ctrl.chroma_format != 0 and tree_type == 0:
            encode_chroma_intra_mode(self.cabac, self.cfg, cu,
                                     0 if cu.mip_flag else cu.intra_mode)
        if cu.isp_mode:
            encode_transform_coeff_isp(self.cabac, self.cfg, cu, self.ctrl,
                                       tree_type=tree_type)
        else:
            luma_cbf_ctx = [0]
            encode_transform_coeff(self.cabac, self.cfg, cu, self.ctrl,
                                   cu.x, cu.y, cu.w, cu.h, luma_cbf_ctx,
                                   tree_type=tree_type,
                                   qp_state=self.qp_state)
        if self.cfg.lfnst:
            encode_lfnst_idx(self.cabac, self.cfg, cu,
                             sep_tree=tree_type == 1)
        if self.cfg.mts:
            encode_mts_idx(self.cabac, self.cfg, cu)
        self._register(cu, st)

    def _register(self, cu: CuInfo, st: SplitState) -> None:
        if self.qp_state is not None:
            self.qp_state["last_cu_qp"] = cu.qp
        self.cu_map.set_cu(cu)
        for yy in range(cu.y // 4, (cu.y + cu.h) // 4):
            for xx in range(cu.x // 4, (cu.x + cu.w) // 4):
                self.chain_map[(xx, yy)] = st.chain


class CodingTreeReader:
    """Parsing mirror of CodingTreeWriter; produces a CtuNode tree with
    decoded CuInfo leaves (coefficients included, no reconstruction).

    For inter slices it runs the normative candidate derivation (merge,
    AMVP, HMVP) to reconstruct motion vectors."""

    def __init__(self, dec: CabacDecoder, cfg, ctrl, is_irap: bool = True,
                 is_intra_slice: bool = True, num_ref: int = 0,
                 ref_pocs=None, is_b_slice: bool = False, tmvp=None):
        self.dec = dec
        self.cfg = cfg
        self.ctrl = ctrl
        self.is_irap = is_irap
        self.is_intra_slice = is_intra_slice
        self.num_ref = num_ref if isinstance(num_ref, tuple) \
            else (num_ref, num_ref)
        self.is_b_slice = is_b_slice
        self.ref_pocs = ref_pocs or [[], []]
        self.tmvp = tmvp
        self.cu_map = CuMap(ctrl.in_width, ctrl.in_height)
        self.chain_map: dict = {}
        self.sc = _SplitCtx(dec, cfg, ctrl, is_irap, self.cu_map,
                            self.chain_map)
        self.qp_state = None
        if not is_intra_slice:
            from ..control.inter_cand import HmvpState
            self.hmvp = HmvpState(ctrl.height_in_lcu)
        if getattr(cfg, "ibc", 0):
            from ..control.inter_cand import HmvpIbcState
            self.hmvp_ibc = HmvpIbcState()

    def enable_qp_delta(self, slice_qp: int) -> None:
        self.qp_state = {"must_code": False, "pred": slice_qp,
                         "qp": slice_qp, "last_qp": slice_qp,
                         "last_cu_qp": slice_qp}

    def decode_ctu(self, ctu_x: int, ctu_y: int,
                   tree_type: int = 0) -> CtuNode:
        if tree_type == 2 and not hasattr(self, "cu_map_c"):
            self.cu_map_c = CuMap(self.ctrl.in_width, self.ctrl.in_height)
            self.chain_map_c: dict = {}
            self.sc_c = _SplitCtx(self.dec, self.cfg, self.ctrl,
                                  self.is_irap, self.cu_map_c,
                                  self.chain_map_c)
        if self.qp_state is not None and tree_type != 2:
            # tile-local coordinates: each tile codes against a
            # sub-image view, so the 'row start uses the above CTU'
            # rule applies at the tile's left column
            tx0, ty0 = 0, 0
            if self.ctrl.tiles_enable:
                t = self.ctrl.tile_index_of_ctu(ctu_x // 64, ctu_y // 64)
                tx0, ty0, _x1, _y1 = self.ctrl.tile_bounds_px(t)
            if ctu_x == tx0 and ctu_y > ty0:
                pred = int(self.cu_map.qp[(ctu_y - 1) // 4, ctu_x // 4])
            else:
                pred = self.qp_state["last_qp"]
            self.qp_state["pred"] = pred
            self.qp_state["qp"] = pred
            self.qp_state["must_code"] = True
        node = self._decode_node(ctu_x, ctu_y, LCU_WIDTH, LCU_WIDTH,
                                 SplitState(), tree_type)
        if self.qp_state is not None and tree_type != 2:
            self.qp_state["last_qp"] = self.qp_state["last_cu_qp"]
        return node

    def _decode_node(self, x, y, w, h, st: SplitState,
                     tree_type: int = 0, chroma_loc=None,
                     has_chroma: bool = True) -> CtuNode | None:
        if x >= self.ctrl.in_width or y >= self.ctrl.in_height:
            return None
        node = CtuNode(x, y, w, h)
        sc = self.sc_c if tree_type == 2 else self.sc
        sc.c = self.dec
        if w + h > 8:
            split, is_implicit = read_split_flag(
                sc, self.dec, x, y, w, h, st, tree_type)
            node.split = split
            if split != NO_SPLIT:
                from ..control.cu import split_is_separate_chroma
                # local dual tree (SCIPU): a split that would make chroma
                # < 16 samples keeps chroma at this geometry; only the
                # LAST child codes it (encode_coding_tree.c:1443-1452)
                sep = (chroma_loc is not None
                       or split_is_separate_chroma(x, y, w, h, split)) \
                    and tree_type == 0 and self.ctrl.chroma_format != 0
                if sep and not self.is_intra_slice:
                    raise NotImplementedError(
                        "local dual tree in inter slices (mode-type "
                        "constraints) is not supported")
                locs = split_locs(x, y, w, h, split)
                c_loc = chroma_loc if chroma_loc is not None \
                    else ((x, y, w, h) if sep else None)
                for i, (sx, sy, sw, sh) in enumerate(locs):
                    child_st = SplitState(
                        depth=st.depth + 1,
                        mtt_depth=st.mtt_depth + (split != QT_SPLIT),
                        implicit_mtt_depth=st.implicit_mtt_depth
                        + (1 if (split != QT_SPLIT and is_implicit) else 0),
                        part_index=i,
                        chain=st.chain + (split,),
                    )
                    child = self._decode_node(
                        sx, sy, sw, sh, child_st, tree_type,
                        chroma_loc=c_loc if sep else None,
                        has_chroma=(not sep) or (i == len(locs) - 1
                                                 and has_chroma))
                    if child is not None:
                        node.children.append(child)
                return node
        node.cu = self._decode_cu(x, y, w, h, st, tree_type,
                                  chroma_loc=chroma_loc,
                                  has_chroma=has_chroma)
        return node

    def _decode_cu(self, x, y, w, h, st: SplitState,
                   tree_type: int = 0, chroma_loc=None,
                   has_chroma: bool = True) -> CuInfo:
        dec = self.dec
        cu = CuInfo(x, y, w, h, type=CU_INTRA)
        local_dual = chroma_loc is not None and \
            (chroma_loc[2] != w or chroma_loc[3] != h)
        cu.local_dual = local_dual
        if tree_type == 2:
            luma = self.cu_map.at(x + w // 2, y + h // 2)
            luma_dir = 0 if (luma is None or luma["mip_flag"]) \
                else luma["intra_mode"]
            cu.intra_mode = luma_dir
            cclm_ok = self.cfg.cclm and cclm_allowed_chroma_tree(
                st.chain, self.chain_map.get((x // 4, y // 4), ()))
            cu.intra_mode_chroma = decode_chroma_intra_mode(
                dec, self.cfg, luma_dir, cclm_ok=cclm_ok)
            luma_cbf_ctx = [0]
            decode_transform_coeff(dec, self.cfg, cu, self.ctrl,
                                   x, y, w, h, luma_cbf_ctx, tree_type=2)
            if self.cfg.lfnst:
                decode_lfnst_idx(dec, self.cfg, cu, sep_tree=True)
            self.cu_map_c.set_cu(cu)
            for yy in range(y // 4, (y + h) // 4):
                for xx in range(x // 4, (x + w) // 4):
                    self.chain_map_c[(xx, yy)] = st.chain
            return cu
        ibc_cfg = bool(getattr(self.cfg, "ibc", 0))
        if not self.is_intra_slice or ibc_cfg:
            from ..control.inter_cand import (MotionInfo, derive_merge_list,
                                              derive_amvp)
            left = self.cu_map.at(x - 1, y)
            above = self.cu_map.at(x, y - 1)

            def _ibc_flag() -> bool:
                ctx_ibc = (1 if (left and left["type"] == CU_IBC) else 0) \
                    + (1 if (above and above["type"] == CU_IBC) else 0)
                return bool(dec.decode_bin(OFF["ibc_flag"] + ctx_ibc))

            skipped = False
            if ((w != 4 or h != 4) and not self.is_intra_slice) \
                    or (ibc_cfg and w <= 64 and h <= 64):
                ctx_skip = (1 if (left and left["skipped"]) else 0) \
                    + (1 if (above and above["skipped"]) else 0)
                skipped = bool(dec.decode_bin(OFF["cu_skip_flag"]
                                              + ctx_skip))
            if skipped:
                is_ibc = self.is_intra_slice
                if ibc_cfg and not self.is_intra_slice:
                    is_ibc = _ibc_flag()
                cu.skipped = True
                cu.merged = True
                cu.merge_idx = decode_merge_idx(dec, self.cfg.max_merge)
                if is_ibc:
                    from ..control.inter_cand import derive_ibc_merge_list
                    cu.type = CU_IBC
                    bv = derive_ibc_merge_list(
                        self.cu_map, self.hmvp_ibc, x, y, w, h)[cu.merge_idx]
                    cu.mv = (bv, (0, 0))
                    cu.mv_dir = 1
                    self._finish_ibc(cu, st)
                    return cu
                cu.type = CU_INTER
                nmr = min(self.num_ref) if self.is_b_slice \
                    else self.num_ref[0]
                cands = derive_merge_list(
                    self.cu_map, self.hmvp, x, y, w, h,
                    self.ctrl.in_width, self.ctrl.in_height,
                    self.cfg.max_merge, self.is_b_slice, nmr,
                    tmvp=self.tmvp, wpp=self.cfg.wpp)
                c = cands[cu.merge_idx]
                cu.mv, cu.mv_ref, cu.mv_dir = c.mv, c.ref, c.dir
                self._finish_inter(cu, st)
                return cu
            is_ibc = False
            if (self.is_intra_slice or w == 4) and ibc_cfg:
                is_ibc = _ibc_flag()
            is_intra = self.is_intra_slice and not is_ibc
            if not self.is_intra_slice and (w != 4 or h != 4):
                ctx_pm = 1 if ((left and left["type"] == CU_INTRA)
                               or (above and above["type"] == CU_INTRA)) \
                    else 0
                is_intra = bool(dec.decode_bin(OFF["cu_pred_mode"]
                                               + ctx_pm))
                if ibc_cfg and not is_intra and not is_ibc:
                    is_ibc = _ibc_flag()
            if is_ibc:
                from ..control.inter_cand import derive_ibc_merge_list
                cu.type = CU_IBC
                cu.mv_dir = 1
                cu.merged = bool(dec.decode_bin(OFF["cu_merge_flag_ext"]))
                if cu.merged:
                    cu.merge_idx = decode_merge_idx(dec, self.cfg.max_merge)
                    bv = derive_ibc_merge_list(
                        self.cu_map, self.hmvp_ibc, x, y, w, h)[cu.merge_idx]
                    cu.mv = (bv, (0, 0))
                    has_coeffs = True
                else:
                    mvd = decode_mvd(dec)           # full-pel for IBC
                    mvp_idx = dec.decode_bin(OFF["mvp_idx"])
                    mvp = derive_ibc_merge_list(
                        self.cu_map, self.hmvp_ibc, x, y, w, h)[mvp_idx]
                    cu.mv = ((mvp[0] + (mvd[0] << 4),
                              mvp[1] + (mvd[1] << 4)), (0, 0))
                    cu.mvd = (mvd, (0, 0))
                    cu.mv_cand_idx = mvp_idx
                    has_coeffs = bool(dec.decode_bin(OFF["cu_qt_root_cbf"]))
                if has_coeffs:
                    luma_cbf_ctx = [0]
                    decode_transform_coeff(self.dec, self.cfg, cu,
                                           self.ctrl, x, y, w, h,
                                           luma_cbf_ctx,
                                           qp_state=self.qp_state)
                self._finish_ibc(cu, st)
                return cu
            if not is_intra:
                cu.type = CU_INTER
                cu.merged = bool(dec.decode_bin(OFF["cu_merge_flag_ext"]))
                if cu.merged:
                    cu.merge_idx = decode_merge_idx(dec, self.cfg.max_merge)
                    nmr = min(self.num_ref) if self.is_b_slice \
                        else self.num_ref[0]
                    cands = derive_merge_list(
                        self.cu_map, self.hmvp, x, y, w, h,
                        self.ctrl.in_width, self.ctrl.in_height,
                        self.cfg.max_merge, self.is_b_slice, nmr,
                        tmvp=self.tmvp, wpp=self.cfg.wpp)
                    c = cands[cu.merge_idx]
                    cu.mv, cu.mv_ref, cu.mv_dir = c.mv, c.ref, c.dir
                    has_coeffs = True
                else:
                    mv_dir = 1
                    if self.is_b_slice:
                        bi = 0
                        if w + h > 12:
                            ctx = 7 - (((w.bit_length() - 1)
                                        + (h.bit_length() - 1) + 1) >> 1)
                            bi = dec.decode_bin(OFF["inter_dir"] + ctx)
                        if bi:
                            mv_dir = 3
                        else:
                            mv_dir = 2 if dec.decode_bin(OFF["inter_dir"] + 5) else 1

                    mvs = [(0, 0), (0, 0)]
                    mv_refs = [0, 0]
                    mvds = [(0, 0), (0, 0)]
                    mvp_idxs = [0, 0]
                    for l in range(2):
                        if not (mv_dir & (1 << l)):
                            continue
                        ref = 0
                        nref = self.num_ref[l]
                        if nref > 1:
                            if dec.decode_bin(OFF["cu_ref_pic"]):
                                ref = 1
                                if nref > 2 and dec.decode_bin(OFF["cu_ref_pic"] + 1):
                                    ref = 2
                                    for idx in range(3, nref):
                                        if dec.decode_bin_ep():
                                            ref = idx
                                        else:
                                            break
                        mvd = decode_mvd(dec)
                        mvp_idx = dec.decode_bin(OFF["mvp_idx"])
                        mv_refs[l] = ref
                        mvds[l] = mvd
                        mvp_idxs[l] = mvp_idx
                        amvp = derive_amvp(
                            self.cu_map, self.hmvp, x, y, w, h,
                            self.ctrl.in_width, self.ctrl.in_height, l,
                            self.ref_pocs[l][ref], self.ref_pocs,
                            tmvp=self.tmvp, wpp=self.cfg.wpp)
                        mvp = amvp[mvp_idx]
                        mvs[l] = (mvp[0] + (mvd[0] << 2),
                                  mvp[1] + (mvd[1] << 2))
                    cu.mv_dir = mv_dir
                    cu.mv_ref = tuple(mv_refs)
                    cu.mv = (mvs[0], mvs[1])
                    cu.mvd = (mvds[0], mvds[1])
                    cu.mv_cand_idx = tuple(mvp_idxs)
                    if self.cfg.amvr and any(
                            cu.mvd[l] != (0, 0) for l in range(2)
                            if mv_dir & (1 << l)):
                        imv = dec.decode_bin(OFF["imv_flag"])
                        assert imv == 0, "AMVR resolutions beyond 1/4-pel " \
                            "are not emitted by this encoder"
                    has_coeffs = bool(dec.decode_bin(OFF["cu_qt_root_cbf"]))
                if has_coeffs:
                    luma_cbf_ctx = [0]
                    decode_transform_coeff(self.dec, self.cfg, cu, self.ctrl,
                                           x, y, w, h, luma_cbf_ctx,
                                           qp_state=self.qp_state)
                self._finish_inter(cu, st)
                return cu

        cu.intra_mode = decode_intra_luma_mode(
            self.dec, self.cfg, x, y, w, h, self.cu_map, cu)
        if self.ctrl.chroma_format != 0 and tree_type == 0 \
                and not local_dual:
            cu.intra_mode_chroma = decode_chroma_intra_mode(
                self.dec, self.cfg, 0 if cu.mip_flag else cu.intra_mode)
        if cu.isp_mode:
            decode_transform_coeff_isp(
                self.dec, self.cfg, cu, self.ctrl,
                tree_type=1 if local_dual else tree_type)
        else:
            luma_cbf_ctx = [0]
            decode_transform_coeff(self.dec, self.cfg, cu, self.ctrl,
                                   x, y, w, h, luma_cbf_ctx,
                                   tree_type=1 if local_dual else tree_type,
                                   qp_state=self.qp_state)
        if self.cfg.lfnst:
            decode_lfnst_idx(self.dec, self.cfg, cu,
                             sep_tree=local_dual or tree_type == 1)
        if self.cfg.mts:
            cu.tr_idx = decode_mts_idx(self.dec, self.cfg, cu)
        self._assign_qp(cu)
        self.cu_map.set_cu(cu)
        for yy in range(y // 4, (y + h) // 4):
            for xx in range(x // 4, (x + w) // 4):
                self.chain_map[(xx, yy)] = st.chain
        if local_dual and has_chroma and self.ctrl.chroma_format != 0:
            # deferred chroma of the whole area, coded with the LAST luma
            # CU (encode_coding_tree.c:1694-1708): chroma intra mode (DM =
            # co-located luma at the area center) + chroma transform tree
            # at the parent geometry
            cx, cy, cw2, ch2 = chroma_loc
            luma = self.cu_map.at(cx + cw2 // 2, cy + ch2 // 2)
            luma_dir = 0 if (luma is None or luma["mip_flag"]) \
                else luma["intra_mode"]
            ccu = CuInfo(cx, cy, cw2, ch2, type=CU_INTRA,
                         intra_mode=luma_dir)
            ccu.intra_mode_chroma = decode_chroma_intra_mode(
                self.dec, self.cfg, luma_dir)
            ctx2 = [0]
            decode_transform_coeff(self.dec, self.cfg, ccu, self.ctrl,
                                   cx, cy, cw2, ch2, ctx2, tree_type=2)
            if self.cfg.lfnst:
                decode_lfnst_idx(self.dec, self.cfg, ccu, sep_tree=True)
            cu.chroma_cu = ccu
        return cu

    def _assign_qp(self, cu: CuInfo) -> None:
        if self.qp_state is not None:
            cu.qp = self.qp_state["qp"]
            self.qp_state["last_cu_qp"] = cu.qp

    def _finish_inter(self, cu: CuInfo, st: SplitState) -> None:
        from ..control.inter_cand import MotionInfo
        self._assign_qp(cu)
        self.cu_map.set_cu(cu)
        self.hmvp.add(cu.x, cu.y, cu.w, cu.h,
                      MotionInfo(mv=cu.mv, ref=cu.mv_ref, dir=cu.mv_dir),
                      self.cfg.log2_parallel_merge_level)
        for yy in range(cu.y // 4, (cu.y + cu.h) // 4):
            for xx in range(cu.x // 4, (cu.x + cu.w) // 4):
                self.chain_map[(xx, yy)] = st.chain

    def _finish_ibc(self, cu: CuInfo, st: SplitState) -> None:
        self._assign_qp(cu)
        self.cu_map.set_cu(cu)
        self.hmvp_ibc.add(cu.x, cu.y, cu.w, cu.h,
                          (cu.mv[0][0], cu.mv[0][1]))
        for yy in range(cu.y // 4, (cu.y + cu.h) // 4):
            for xx in range(cu.x // 4, (cu.x + cu.w) // 4):
                self.chain_map[(xx, yy)] = st.chain

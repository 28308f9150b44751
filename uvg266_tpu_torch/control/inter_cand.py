"""Normative inter candidate derivation: spatial merge, HMVP, pairwise,
AMVP — shared by the encoder and the decoding oracle (the derivation is
part of the VVC decoding process, so both sides must run it identically).

Behavioral parity with the reference:
- spatial candidates A0/A1/B0/B1/B2: inter.c get_spatial_merge_candidates
  :1368 (availability = already-coded, inter-coded neighbors)
- merge list construction + MER constraint + HMVP + pairwise + zeros:
  uvg_inter_get_merge_cand (inter.c:1989-2192)
- AMVP (2 candidates): get_mv_cand_from_candidates (inter.c:1606-1699)
  with quarter-pel rounding (uvg_round_precision)
- HMVP table update: uvg_hmvp_add_mv (inter.c:1878-1906)
- TMVP: colocated C0/C1 fetch from the L0[0] picture's stored motion
  field (get_temporal_merge_candidates, inter.c:1031-1096), MV rounding
  through the float representation (round_mv_comp, inter.c:1106-1146)
  and POC-distance scaling (apply_mv_scaling_pocs, inter.c:1148-1165),
  added to the merge list (inter.c:2030-2070) and the AMVP list
  (inter.c:1649-1669, gated on poc > 1).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..consts import LCU_WIDTH
from ..ops.inter import round_precision
from .cu import CU_INTER, CuMap

MAX_NUM_HMVP_CANDS = 5
AMVP_MAX_NUM_CANDS = 2


@dataclass
class MotionInfo:
    mv: tuple = ((0, 0), (0, 0))
    ref: tuple = (0, 0)
    dir: int = 0


def _minfo_from_map(n) -> MotionInfo | None:
    if n is None or n["type"] != CU_INTER:
        return None
    # zero undefined lists (inter.c:748-765 inter_clear_cu_unused)
    mv = [list(n["mv"][0]), list(n["mv"][1])]
    ref = list(n["mv_ref"])
    for l in range(2):
        if not (n["mv_dir"] & (1 << l)):
            mv[l] = [0, 0]
            ref[l] = 0
    return MotionInfo(mv=(tuple(mv[0]), tuple(mv[1])),
                      ref=tuple(ref), dir=n["mv_dir"])


@dataclass
class MotionField:
    """8x8-grid motion snapshot of a coded picture — the slice of the
    reference's cu_array kept per DPB picture for TMVP (inter.c:1062
    ref_cu_array; storage granularity matches the (x>>3)<<3 snapping of
    the colocated fetch)."""
    dir: np.ndarray       # (h8, w8) int8; 0 = intra / not coded
    mv: np.ndarray        # (h8, w8, 2 lists, 2 comps) int32, 1/16-pel
    ref_poc: np.ndarray   # (h8, w8, 2 lists) int32: POC referenced


def build_motion_field(cu_map: CuMap, pocs0: list, pocs1: list) -> MotionField:
    """Snapshot a frame's CuMap into the compact TMVP motion field."""
    d = np.where(cu_map.cu_type[::2, ::2] == CU_INTER,
                 cu_map.mv_dir[::2, ::2], 0).astype(np.int8)
    h8, w8 = d.shape
    mv = np.zeros((h8, w8, 2, 2), dtype=np.int32)
    mv[:, :, 0, 0] = cu_map.mv0x[::2, ::2]
    mv[:, :, 0, 1] = cu_map.mv0y[::2, ::2]
    mv[:, :, 1, 0] = cu_map.mv1x[::2, ::2]
    mv[:, :, 1, 1] = cu_map.mv1y[::2, ::2]
    rp = np.zeros((h8, w8, 2), dtype=np.int32)
    p0 = np.asarray(pocs0 if pocs0 else [0], dtype=np.int32)
    p1 = np.asarray(pocs1 if pocs1 else [0], dtype=np.int32)
    rp[:, :, 0] = p0[np.clip(cu_map.ref0[::2, ::2], 0, len(p0) - 1)]
    rp[:, :, 1] = p1[np.clip(cu_map.ref1[::2, ::2], 0, len(p1) - 1)]
    return MotionField(dir=d, mv=mv, ref_poc=rp)


@dataclass
class TmvpCtx:
    """Everything TMVP derivation needs about the current frame and the
    colocated (L0[0]) picture."""
    col_field: MotionField
    col_poc: int              # POC of the colocated picture (L0[0])
    cur_poc: int
    pocs0: list               # current frame's L0 POCs
    pocs1: list               # current frame's L1 POCs
    has_future_ref: bool      # any reference POC > cur_poc

    @classmethod
    def from_reflists(cls, rl, cur_poc: int):
        """Build from a RefLists whose pictures carry .motion, or None."""
        if not rl or not getattr(rl, "l0", None):
            return None
        field = getattr(rl.l0[0], "motion", None)
        if field is None:
            return None
        pocs = list(rl.pocs0) + list(rl.pocs1)
        return cls(col_field=field, col_poc=rl.pocs0[0], cur_poc=cur_poc,
                   pocs0=list(rl.pocs0), pocs1=list(rl.pocs1),
                   has_future_ref=any(p > cur_poc for p in pocs))


def round_mv_comp(v: int) -> int:
    """MV rounding through the 4-bit-exponent/6-bit-mantissa float
    representation (convert_mv_fixed_to_float + convert_mv_float_to_fixed,
    inter.c:1106-1140)."""
    sign = -1 if v < 0 else 0
    scale = ((v ^ sign) | 31).bit_length() - 6
    if scale < 0:
        return v
    n = (v + ((1 << scale) >> 1)) >> scale
    exponent = scale + ((n ^ sign) >> 5)
    mantissa = (n & 31) | (sign << 5)
    return (mantissa ^ 32) << (exponent - 1)


def _get_scaled_mv(mv: int, scale: int) -> int:
    s = scale * mv
    return max(-131072, min(131071, (s + 127 + (1 if s < 0 else 0)) >> 8))


def apply_mv_scaling_pocs(cur_poc: int, cur_ref_poc: int, nb_poc: int,
                          nb_ref_poc: int, mv: tuple) -> tuple:
    """POC-distance MV scaling (apply_mv_scaling_pocs, inter.c:1148)."""
    diff_cur = cur_poc - cur_ref_poc
    diff_nb = nb_poc - nb_ref_poc
    if diff_cur == diff_nb:
        return mv
    diff_cur = max(-128, min(127, diff_cur))
    diff_nb = max(-128, min(127, diff_nb))
    q = int((0x4000 + (abs(diff_nb) >> 1)) / diff_nb)  # trunc toward zero
    scale = max(-4096, min(4095, (diff_cur * q + 32) >> 6))
    return (_get_scaled_mv(mv[0], scale), _get_scaled_mv(mv[1], scale))


def _colocated_cell(tmvp: TmvpCtx, x, y, w, h, pic_w, pic_h):
    """C0 (bottom-right, same CTU row) else C1 (center) colocated cell
    indices into the 8x8 motion field, or None
    (get_temporal_merge_candidates, inter.c:1031-1096)."""
    f = tmvp.col_field
    xbr, ybr = x + w, y + h
    if xbr < pic_w and ybr < pic_h and ybr % LCU_WIDTH != 0:
        ci, cj = ybr >> 3, xbr >> 3
        if f.dir[ci, cj] != 0:
            return ci, cj
    xc, yc = x + w // 2, y + h // 2
    if xc < pic_w and yc < pic_h:
        ci, cj = yc >> 3, xc >> 3
        if f.dir[ci, cj] != 0:
            return ci, cj
    return None


def temporal_candidate(tmvp: TmvpCtx, cell, reflist: int,
                       cur_ref_poc: int) -> tuple:
    """Scaled temporal MV from a colocated cell (add_temporal_candidate,
    inter.c:1547-1602)."""
    f = tmvp.col_field
    ci, cj = cell
    col_list = 1 if tmvp.has_future_ref else reflist
    if not (int(f.dir[ci, cj]) & (1 << col_list)):
        col_list = 1 - col_list
    mv = (round_mv_comp(int(f.mv[ci, cj, col_list, 0])),
          round_mv_comp(int(f.mv[ci, cj, col_list, 1])))
    return apply_mv_scaling_pocs(tmvp.cur_poc, cur_ref_poc, tmvp.col_poc,
                                 int(f.ref_poc[ci, cj, col_list]), mv)


def is_duplicate(c1: MotionInfo, c2: MotionInfo | None) -> bool:
    if c2 is None:
        return False
    if c1.dir != c2.dir:
        return False
    for l in range(2):
        if c1.dir & (1 << l):
            if c1.mv[l] != c2.mv[l] or c1.ref[l] != c2.ref[l]:
                return False
    return True


def spatial_candidates(cu_map: CuMap, x: int, y: int, w: int, h: int,
                       pic_w: int, pic_h: int, wpp: bool = False) -> dict:
    """A0/A1/B0/B1/B2 (None when unavailable). With WPP the cross-CTU
    above-right candidate is never available (inter.c:1421,1512:
    x_local+width<LCU_WIDTH || (!wpp && y_local==0))."""
    out = {"a0": None, "a1": None, "b0": None, "b1": None, "b2": None}
    if x != 0:
        out["a1"] = _minfo_from_map(cu_map.at(x - 1, y + h - 1))
        if y + h < pic_h:
            out["a0"] = _minfo_from_map(cu_map.at(x - 1, y + h))
    if y != 0:
        if x + w < pic_w and ((x % 64) + w < 64 or not wpp):
            out["b0"] = _minfo_from_map(cu_map.at(x + w, y - 1))
        out["b1"] = _minfo_from_map(cu_map.at(x + w - 1, y - 1))
        if x != 0:
            out["b2"] = _minfo_from_map(cu_map.at(x - 1, y - 1))
    return out


def _different_mer(x, y, x2, y2, level):
    return (x >> level) != (x2 >> level) or (y >> level) != (y2 >> level)


class HmvpState:
    """Per-CTU-row HMVP LUTs (videoframe.h:91, reset per frame).

    With tiles, the LUT is additionally keyed by the tile index (the spec
    resets HMVP at the start of each CTU row of each tile); callers set
    cur_tile while walking the tile scan.
    """

    def __init__(self, height_in_lcu: int):
        self.lut: dict[tuple, list[MotionInfo]] = {}
        self.cur_tile = 0

    def _row(self, y: int) -> list[MotionInfo]:
        return self.lut.setdefault((self.cur_tile, y // LCU_WIDTH), [])

    def add(self, x: int, y: int, w: int, h: int, cu_minfo: MotionInfo,
            parallel_log2: int) -> None:
        """uvg_hmvp_add_mv: FIFO push with redundancy removal."""
        x_br, y_br = x + w, y + h
        if not ((x_br >> parallel_log2) > (x >> parallel_log2)
                and (y_br >> parallel_log2) > (y >> parallel_log2)):
            return
        lut = self._row(y)
        for i, c in enumerate(lut):
            if is_duplicate(cu_minfo, c):
                del lut[i]
                break
        lut.insert(0, cu_minfo)
        if len(lut) > MAX_NUM_HMVP_CANDS:
            lut.pop()

    def row(self, y: int) -> list[MotionInfo]:
        return self._row(y)


def derive_merge_list(cu_map: CuMap, hmvp: HmvpState, x, y, w, h,
                      pic_w, pic_h, max_merge: int, is_b_slice: bool,
                      num_ref: int, parallel_log2: int = 2,
                      tmvp: TmvpCtx | None = None,
                      wpp: bool = False) -> list[MotionInfo]:
    """Merge candidate list (inter.c:1989) incl. the temporal candidate
    (inter.c:2030-2070) when a TmvpCtx is supplied."""
    sp = spatial_candidates(cu_map, x, y, w, h, pic_w, pic_h, wpp)
    a0, a1, b0, b1, b2 = sp["a0"], sp["a1"], sp["b0"], sp["b1"], sp["b2"]
    cands: list[MotionInfo] = []

    def try_add(c, dup1, dup2):
        if c is not None and not is_duplicate(c, dup1) and not is_duplicate(c, dup2):
            cands.append(c)
            return True
        return False

    if _different_mer(x, y, x, y - 1, parallel_log2):
        try_add(b1, None, None)
    if _different_mer(x, y, x - 1, y, parallel_log2):
        try_add(a1, b1, None)
    if _different_mer(x, y, x + 1, y - 1, parallel_log2):
        try_add(b0, b1, None)
    if _different_mer(x, y, x - 1, y + 1, parallel_log2):
        try_add(a0, a1, None)
    if len(cands) < 4 and _different_mer(x, y, x - 1, y - 1, parallel_log2):
        try_add(b2, a1, b1)

    # temporal candidate, reference idx always 0 (inter.c:2030-2070)
    if tmvp is not None and len(cands) < max_merge:
        cell = _colocated_cell(tmvp, x, y, w, h, pic_w, pic_h)
        if cell is not None:
            d = 0
            mv = [(0, 0), (0, 0)]
            for l in range(2 if is_b_slice else 1):
                mvl = temporal_candidate(tmvp, cell, l, tmvp.pocs0[0])
                pocs_l = tmvp.pocs0 if l == 0 else tmvp.pocs1
                if pocs_l and pocs_l[0] > tmvp.cur_poc:
                    mvl = (-mvl[0], -mvl[1])
                mv[l] = mvl
                d |= 1 << l
            if d:
                cands.append(MotionInfo(mv=(mv[0], mv[1]), ref=(0, 0), dir=d))

    # HMVP (oldest-first iteration, first two checked against a1/b1)
    if len(cands) < max_merge - 1:
        for i, hc in enumerate(hmvp.row(y)):
            if i > 1 or (not is_duplicate(hc, a1) and not is_duplicate(hc, b1)):
                c = MotionInfo(mv=hc.mv, ref=hc.ref, dir=hc.dir)
                if not is_b_slice:
                    c = MotionInfo(mv=(hc.mv[0], (0, 0)),
                                   ref=(hc.ref[0], 0), dir=hc.dir)
                cands.append(c)
                if len(cands) == max_merge - 1:
                    break

    # pairwise average of the first two
    if 1 < len(cands) < max_merge:
        nlists = 2 if is_b_slice else 1
        mv = [[0, 0], [0, 0]]
        ref = [0, 0]
        d = 0
        for l in range(nlists):
            ri = cands[0].ref[l] if cands[0].dir & (1 << l) else -1
            rj = cands[1].ref[l] if cands[1].dir & (1 << l) else -1
            if ri == -1 and rj == -1:
                continue
            d += 1 << l
            if ri != -1 and rj != -1:
                ax = cands[0].mv[l][0] + cands[1].mv[l][0]
                ay = cands[0].mv[l][1] + cands[1].mv[l][1]
                # round_avg_mv with shift 1
                ax = (ax + 1 - (1 if ax >= 0 else 0)) >> 1
                ay = (ay + 1 - (1 if ay >= 0 else 0)) >> 1
                mv[l] = [ax, ay]
                ref[l] = ri
            elif ri != -1:
                mv[l] = list(cands[0].mv[l])
                ref[l] = ri
            else:
                mv[l] = list(cands[1].mv[l])
                ref[l] = rj
        if d > 0:
            cands.append(MotionInfo(mv=(tuple(mv[0]), tuple(mv[1])),
                                    ref=tuple(ref), dir=d))

    # zero candidates
    zero_idx = 0
    while len(cands) < max_merge:
        r = zero_idx if zero_idx < num_ref - 1 else 0
        if is_b_slice:
            cands.append(MotionInfo(mv=((0, 0), (0, 0)), ref=(r, r), dir=3))
        else:
            cands.append(MotionInfo(mv=((0, 0), (0, 0)), ref=(r, 0), dir=1))
        zero_idx += 1
    return cands[:max_merge]


def derive_amvp(cu_map: CuMap, hmvp: HmvpState, x, y, w, h,
                pic_w, pic_h, reflist: int, cur_ref_poc: int,
                ref_pocs: list,
                tmvp: TmvpCtx | None = None,
                wpp: bool = False) -> list[tuple[int, int]]:
    """AMVP candidate pair (inter.c get_mv_cand_from_candidates:1606)
    incl. the temporal candidate (inter.c:1649-1669, gated on poc > 1).
    ref_pocs[l][idx] -> POC for each list."""
    sp = spatial_candidates(cu_map, x, y, w, h, pic_w, pic_h, wpp)
    cands: list[tuple[int, int]] = []

    def try_mvp(c: MotionInfo | None) -> bool:
        if c is None:
            return False
        for i in range(2):
            cl = reflist if i == 0 else 1 - reflist
            if not (c.dir & (1 << cl)):
                continue
            if ref_pocs[cl][c.ref[cl]] == cur_ref_poc:
                cands.append(c.mv[cl])
                return True
        return False

    if not try_mvp(sp["a0"]):
        try_mvp(sp["a1"])
    n_a = len(cands)
    if not try_mvp(sp["b0"]):
        if not try_mvp(sp["b1"]):
            try_mvp(sp["b2"])

    cands = [round_precision(4, 2, c) for c in cands]
    if len(cands) == 2 and cands[0] == cands[1]:
        cands = cands[:1]

    # temporal MVP (needs at least two coded P/B frames, inter.c:1653)
    if tmvp is not None and tmvp.cur_poc > 1 \
            and len(cands) < AMVP_MAX_NUM_CANDS:
        cell = _colocated_cell(tmvp, x, y, w, h, pic_w, pic_h)
        if cell is not None:
            cands.append(temporal_candidate(tmvp, cell, reflist,
                                            cur_ref_poc))

    if len(cands) < AMVP_MAX_NUM_CANDS:
        for i, hc in enumerate(hmvp.row(y)[::-1][:4]):
            for src in range(2):
                cl = reflist if src == 0 else 1 - reflist
                if not (hc.dir & (1 << cl)):
                    continue
                if ref_pocs[cl][hc.ref[cl]] == cur_ref_poc:
                    cands.append(hc.mv[cl])
                    if len(cands) == AMVP_MAX_NUM_CANDS:
                        break
            if len(cands) == AMVP_MAX_NUM_CANDS:
                break

    while len(cands) < AMVP_MAX_NUM_CANDS:
        cands.append((0, 0))
    return [round_precision(4, 2, c) for c in cands[:AMVP_MAX_NUM_CANDS]]


# --- IBC (intra block copy) candidates --------------------------------------

IBC_MRG_MAX_NUM_CANDS = 6


class HmvpIbcState:
    """Per-CTU-row IBC HMVP LUT (hmvp_lut_ibc, videoframe.h;
    inter.c:1841-1899).

    Entries are block vectors (1/16-pel units, always full-pel multiples).
    Push inserts at the FRONT with mv-only duplicate removal
    (is_duplicate_candidate_ibc, inter.c:1221) and is NOT gated by the
    parallel-merge-level (uvg_hmvp_add_mv: `hmvp_possible || CU_IBC`).
    """

    def __init__(self):
        self.lut: dict[tuple, list[tuple]] = {}
        self.cur_tile = 0

    def _row(self, y: int) -> list[tuple]:
        return self.lut.setdefault((self.cur_tile, y // LCU_WIDTH), [])

    def add(self, x: int, y: int, w: int, h: int, bv: tuple) -> None:
        if w * h <= 16:     # uvg_hmvp_add_mv small-block assert
            return
        lut = self._row(y)
        for i, c in enumerate(lut):
            if c == bv:
                del lut[i]
                break
        lut.insert(0, bv)
        if len(lut) > MAX_NUM_HMVP_CANDS:
            lut.pop()

    def row(self, y: int) -> list[tuple]:
        return self._row(y)


def derive_ibc_merge_list(cu_map: CuMap, hmvp_ibc: HmvpIbcState,
                          x: int, y: int, w: int, h: int) -> list[tuple]:
    """get_ibc_merge_candidates (inter.c:1250-1349): A1, B1 (IBC-typed
    neighbours, mv-deduped), IBC HMVP entries (duplicates allowed after
    the first LUT item), zero fill.  Returns IBC_MRG_MAX_NUM_CANDS block
    vectors in 1/16-pel units, rounded to the quarter-pel grid like the
    reference (uvg_round_precision(INTERNAL_MV_PREC, 2))."""
    from ..ops.inter import round_precision
    from .cu import CU_IBC
    cands: list[tuple] = []
    a1_bv = b1_bv = None
    if x != 0:
        a1 = cu_map.at(x - 1, y + h - 1)
        if a1 is not None and a1["type"] == CU_IBC:
            a1_bv = a1["mv"][0]
            cands.append(a1_bv)
    if y != 0:
        b1 = cu_map.at(x + w - 1, y - 1)
        if b1 is not None and b1["type"] == CU_IBC:
            b1_bv = b1["mv"][0]
            if b1_bv != a1_bv:
                cands.append(b1_bv)
            else:
                b1_bv = None    # reference nulls duplicate b1
    cands = [round_precision(4, 2, c) for c in cands]
    if len(cands) < IBC_MRG_MAX_NUM_CANDS:
        for i, bv in enumerate(hmvp_ibc.row(y)[:MAX_NUM_HMVP_CANDS]):
            duplicate = bv == a1_bv or bv == b1_bv
            # reference allows duplicates after the first hmvp lut item
            if not duplicate or i > 0:
                cands.append(bv)
                if len(cands) == IBC_MRG_MAX_NUM_CANDS:
                    return cands
    while len(cands) < IBC_MRG_MAX_NUM_CANDS:
        cands.append((0, 0))
    return cands

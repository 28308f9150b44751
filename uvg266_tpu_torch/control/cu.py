"""CU data structures: per-frame CU map at 4x4 granularity + partition tree.

The analogue of the reference's cu_info_t / cu_array_t
(uvg266 src/cu.h:134-263, cu.c) re-shaped as structure-of-arrays
over the frame's 4x4 grid, which is the natural TPU layout (gather-friendly)
and also what the syntax writer needs for neighbor context derivation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..consts import LCU_WIDTH

# split types (order matters for signaling; mirrors the reference enum)
NO_SPLIT = 0
QT_SPLIT = 1
BT_HOR_SPLIT = 2
TT_HOR_SPLIT = 3
BT_VER_SPLIT = 4
TT_VER_SPLIT = 5

CU_NOTSET = 0
CU_INTRA = 1
CU_INTER = 2
CU_IBC = 3


def split_locs(x: int, y: int, w: int, h: int, split: int):
    """Child (x, y, w, h) tuples for a split (cu.c uvg_get_split_locs:323)."""
    hw, hh = w >> 1, h >> 1
    qw, qh = w >> 2, h >> 2
    if split == QT_SPLIT:
        return [(x, y, hw, hh), (x + hw, y, hw, hh),
                (x, y + hh, hw, hh), (x + hw, y + hh, hw, hh)]
    if split == BT_HOR_SPLIT:
        return [(x, y, w, hh), (x, y + hh, w, hh)]
    if split == BT_VER_SPLIT:
        return [(x, y, hw, h), (x + hw, y, hw, h)]
    if split == TT_HOR_SPLIT:
        return [(x, y, w, qh), (x, y + qh, w, hh), (x, y + qh + hh, w, qh)]
    if split == TT_VER_SPLIT:
        return [(x, y, qw, h), (x + qw, y, hw, h), (x + qw + hw, y, qw, h)]
    raise ValueError(f"bad split {split}")


def split_is_separate_chroma(x: int, y: int, w: int, h: int, split: int) -> bool:
    """Would this split make chroma stay unsplit (local dual tree)?
    (cu.c:333-366 separate_chroma flags)."""
    hw, hh = w >> 1, h >> 1
    qw, qh = w >> 2, h >> 2
    if w == 4:
        return True
    if split == QT_SPLIT:
        return hh == 4
    if split == BT_HOR_SPLIT:
        return hh * w < 64
    if split == BT_VER_SPLIT:
        return hw == 4 or hw * h < 64
    if split == TT_HOR_SPLIT:
        return qh * w < 64
    if split == TT_VER_SPLIT:
        return qw == 4 or qw * h < 64
    return False


@dataclass
class CuInfo:
    """One coded CU (leaf of the partition tree)."""
    x: int
    y: int
    w: int
    h: int
    type: int = CU_INTRA
    # inter fields (1/16-pel MVs, reference parity: cu.h inter struct)
    mv: tuple = ((0, 0), (0, 0))
    mv_ref: tuple = (0, 0)
    mv_dir: int = 0
    merged: bool = False
    merge_idx: int = 0
    mv_cand_idx: int = 0
    mvd: tuple = (0, 0)             # quarter-pel, list 0
    skipped: bool = False
    intra_mode: int = 0
    intra_mode_chroma: int = 0
    mip_flag: bool = False
    mip_transposed: bool = False
    multi_ref_idx: int = 0
    isp_mode: int = 0
    lfnst_idx: int = 0
    tr_idx: int = 0                 # MTS index, 0 = DCT2_DCT2
    # per-TU joint Cb-Cr map keyed by rel (tx, ty) -> TuCResMode 1..3 (the
    # tu_joint_cbcr_residual_flag is TU-level syntax)
    joint_cb_cr: dict = field(default_factory=dict)
    # local dual tree (SCIPU): this CU carries no chroma of its own
    # (cu.c:333-366 separate_chroma); the LAST CU of the area holds the
    # whole area's chroma in `chroma_cu` (a chroma-only CuInfo at the
    # parent geometry)
    local_dual: bool = False
    chroma_cu: object = None
    qp: int = 0
    # per-color cbf; for CUs larger than the max TU these are per-TU maps
    # keyed by (tx, ty)
    cbf: dict = field(default_factory=dict)        # (color, tx, ty) -> 0/1
    coeffs: dict = field(default_factory=dict)     # (color, tx, ty) -> np.ndarray
    # LFNST/MTS constraint accumulators (encode_coding_tree-generic.c:113)
    violates_lfnst_luma: bool = False
    violates_lfnst_chroma: bool = False
    lfnst_last_scan_pos: bool = False
    mts_last_scan_pos: bool = False
    violates_mts_constraint: bool = False

    def cbf_set(self, color: int, tx: int = 0, ty: int = 0) -> int:
        return self.cbf.get((color, tx, ty), 0)


class CuMap:
    """Frame-level SoA CU attribute map at 4x4 granularity."""

    def __init__(self, width: int, height: int):
        self.w4 = -(-width // 4)
        self.h4 = -(-height // 4)
        shape = (self.h4, self.w4)
        self.cu_type = np.zeros(shape, dtype=np.int8)
        self.intra_mode = np.zeros(shape, dtype=np.int16)
        self.log2_w = np.zeros(shape, dtype=np.int8)
        self.log2_h = np.zeros(shape, dtype=np.int8)
        self.skipped = np.zeros(shape, dtype=np.int8)
        self.mip_flag = np.zeros(shape, dtype=np.int8)
        self.coded = np.zeros(shape, dtype=bool)   # coded-order availability
        # inter motion fields (1/16-pel)
        self.mv_dir = np.zeros(shape, dtype=np.int8)
        self.mv0x = np.zeros(shape, dtype=np.int32)
        self.mv0y = np.zeros(shape, dtype=np.int32)
        self.mv1x = np.zeros(shape, dtype=np.int32)
        self.mv1y = np.zeros(shape, dtype=np.int32)
        self.ref0 = np.zeros(shape, dtype=np.int8)
        self.ref1 = np.zeros(shape, dtype=np.int8)
        # per-unit luma QP (cu_qp_delta streams; cu.h qp field)
        self.qp = np.zeros(shape, dtype=np.int8)
        # tile prediction break: when tile_map is set, at() treats units of
        # a different tile than cur_tile as unavailable (VVC availability
        # derivation, "in the same tile" clause). Callers set cur_tile per
        # CTU while walking the tile scan.
        self.tile_map: np.ndarray | None = None
        self.cur_tile: int = 0

    def set_tile_map(self, ctrl) -> None:
        """Build the per-4x4-unit tile index map from the tile grid."""
        tm = np.zeros((self.h4, self.w4), dtype=np.int16)
        n_tiles = ctrl.cfg.tiles_width_count * ctrl.cfg.tiles_height_count
        for t in range(n_tiles):
            x0, y0, x1, y1 = ctrl.tile_bounds_px(t)
            tm[y0 // 4:-(-y1 // 4), x0 // 4:-(-x1 // 4)] = t
        self.tile_map = tm

    def set_cu(self, cu: CuInfo) -> None:
        ys, xs = cu.y // 4, cu.x // 4
        ye, xe = (cu.y + cu.h) // 4, (cu.x + cu.w) // 4
        self.cu_type[ys:ye, xs:xe] = cu.type
        self.intra_mode[ys:ye, xs:xe] = cu.intra_mode
        self.log2_w[ys:ye, xs:xe] = cu.w.bit_length() - 1
        self.log2_h[ys:ye, xs:xe] = cu.h.bit_length() - 1
        self.mip_flag[ys:ye, xs:xe] = 1 if cu.mip_flag else 0
        self.skipped[ys:ye, xs:xe] = 1 if cu.skipped else 0
        self.qp[ys:ye, xs:xe] = cu.qp
        self.coded[ys:ye, xs:xe] = True
        if cu.type != CU_INTRA:
            self.mv_dir[ys:ye, xs:xe] = cu.mv_dir
            self.mv0x[ys:ye, xs:xe] = cu.mv[0][0]
            self.mv0y[ys:ye, xs:xe] = cu.mv[0][1]
            self.mv1x[ys:ye, xs:xe] = cu.mv[1][0]
            self.mv1y[ys:ye, xs:xe] = cu.mv[1][1]
            self.ref0[ys:ye, xs:xe] = cu.mv_ref[0]
            self.ref1[ys:ye, xs:xe] = cu.mv_ref[1]

    def at(self, x: int, y: int):
        """Neighbor attribute lookup at pixel coords; None if out of frame."""
        if x < 0 or y < 0:
            return None
        yi, xi = y // 4, x // 4
        if yi >= self.h4 or xi >= self.w4 or not self.coded[yi, xi]:
            return None
        if self.tile_map is not None \
                and self.tile_map[yi, xi] != self.cur_tile:
            return None
        return {
            "type": int(self.cu_type[yi, xi]),
            "intra_mode": int(self.intra_mode[yi, xi]),
            "log2_w": int(self.log2_w[yi, xi]),
            "log2_h": int(self.log2_h[yi, xi]),
            "skipped": bool(self.skipped[yi, xi]),
            "mip_flag": bool(self.mip_flag[yi, xi]),
            "mv_dir": int(self.mv_dir[yi, xi]),
            "mv": ((int(self.mv0x[yi, xi]), int(self.mv0y[yi, xi])),
                   (int(self.mv1x[yi, xi]), int(self.mv1y[yi, xi]))),
            "mv_ref": (int(self.ref0[yi, xi]), int(self.ref1[yi, xi])),
            "qp": int(self.qp[yi, xi]),
        }


@dataclass
class CtuNode:
    """Partition tree node; leaf nodes carry a CuInfo."""
    x: int
    y: int
    w: int
    h: int
    split: int = NO_SPLIT
    children: list = field(default_factory=list)
    cu: CuInfo | None = None

    def leaves(self):
        if self.split == NO_SPLIT:
            yield self
        else:
            for c in self.children:
                yield from c.leaves()

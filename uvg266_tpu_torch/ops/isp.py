"""ISP (intra sub-partitions) geometry and eligibility rules.

Behavioral parity with the reference:
- uvg_get_isp_split_dim / _num / _loc (uvg266 src/intra.c:1469-1537)
- uvg_can_use_isp (uvg266 src/transform.c:1751)
- uvg_can_use_isp_with_lfnst (uvg266 src/intra.c:1778)
- implicit transform-type rule (uvg266 src/strategies/generic/
  dct-generic.c:2500-2556 uvg_get_tr_type): with ISP, DST7 applies to a
  dimension in [4, 16] only when MTS is configured (explicit-intra or
  implicit); LFNST forces DCT2.

ISP splits a luma intra CU into 2 or 4 sub-TUs (horizontal row bands or
vertical column bands) that reconstruct sequentially, each predicting from
the previous one's reconstruction.  Prediction runs at pred-block
granularity (vertical splits narrower than 4 share one 4-wide prediction,
intra.c:1490-1494), transforms at transform-block granularity (1- and
2-wide TUs are legal).
"""
from __future__ import annotations

ISP_NONE = 0
ISP_HOR = 1
ISP_VER = 2

TR_MAX_WIDTH = 32   # global.h:190 TR_MAX_LOG2_SIZE == 5
MIN_ISP_SAMPLES = 16


def can_use_isp(w: int, h: int) -> bool:
    """Eligibility: each sub-block needs >= 16 samples and the CU must fit
    the max transform size (transform.c:1751-1766)."""
    log2_w = w.bit_length() - 1
    log2_h = h.bit_length() - 1
    if log2_w + log2_h <= 4:
        return False
    if w > TR_MAX_WIDTH or h > TR_MAX_WIDTH:
        return False
    return True


def isp_split_dim(w: int, h: int, mode: int, is_transform: bool) -> int:
    """Size of the split dimension of one sub-block (intra.c:1469)."""
    assert mode != ISP_NONE
    if mode == ISP_HOR:
        split_dim, non_split = h, w
    else:
        split_dim, non_split = w, h
    factor = (MIN_ISP_SAMPLES >> (non_split.bit_length() - 1)) \
        if non_split < MIN_ISP_SAMPLES else 1
    part = factor if (split_dim >> 2) < factor else (split_dim >> 2)
    # prediction blocks are at least 4 wide for vertical splits; transform
    # blocks are not (JVET-T2001 8.4.5.1 eq. 246 note in intra.c:1489-1494)
    if mode == ISP_VER and not is_transform:
        part = max(4, part)
    return part


def isp_split_num(w: int, h: int, mode: int, is_transform: bool) -> int:
    d = isp_split_dim(w, h, mode, is_transform)
    return h // d if mode == ISP_HOR else w // d


def isp_split_loc(x: int, y: int, w: int, h: int, idx: int, mode: int,
                  is_transform: bool) -> tuple[int, int, int, int]:
    """(x, y, w, h) of sub-block idx (intra.c:1512-1537)."""
    part = isp_split_dim(w, h, mode, is_transform)
    if mode == ISP_VER and w < 16 and h != 4 and not is_transform:
        # two transform blocks share each 4-wide prediction block
        idx //= 2
    off = part * idx
    if mode == ISP_HOR:
        return x, y + off, w, part
    return x + off, y, part, h


def isp_tu_locs(x: int, y: int, w: int, h: int, mode: int):
    """Transform sub-block rectangles in coding order."""
    return [isp_split_loc(x, y, w, h, i, mode, True)
            for i in range(isp_split_num(w, h, mode, True))]


def can_use_isp_with_lfnst(w: int, h: int, mode: int) -> bool:
    """LFNST needs every ISP TU to be >= 4 in both dims (intra.c:1778)."""
    if mode == ISP_NONE:
        return True
    tu_w = w if mode == ISP_HOR else isp_split_dim(w, h, ISP_VER, True)
    tu_h = isp_split_dim(w, h, ISP_HOR, True) if mode == ISP_HOR else h
    return tu_w >= 4 and tu_h >= 4


def isp_tr_types(tu_w: int, tu_h: int, mode: int, cfg_mts: int,
                 lfnst_idx: int) -> tuple[int, int]:
    """(type_hor, type_ver) for an ISP luma TU (dct-generic.c:2522-2544).

    cfg_mts: the config's MTS mode (0 off, 1 intra, 2 inter, 3 both,
    4 implicit — cfg.py mirror of UVG_MTS_*)."""
    from .tr_matrices import DCT2, DST7
    if mode == ISP_NONE:
        return DCT2, DCT2
    if lfnst_idx:
        return DCT2, DCT2
    explicit_intra = cfg_mts in (1, 3)
    implicit = cfg_mts in (2, 4)
    if not (explicit_intra or implicit):
        return DCT2, DCT2
    th = DST7 if 4 <= tu_w <= 16 else DCT2
    tv = DST7 if 4 <= tu_h <= 16 else DCT2
    return th, tv

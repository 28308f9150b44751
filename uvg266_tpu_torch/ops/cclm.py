"""CCLM (cross-component linear model) chroma prediction.

Behavioral parity with the reference:
- parameter derivation (4-point min/max groups, integer division LUT):
  intra.c get_cclm_parameters:311-493
- luma downsampling (6-tap {1,2,1;1,2,1}/8 block filter; single-row
  {1,2,1}/4 above a CTU-row boundary) and reference construction:
  search.c downsample_cclm_rec:459, intra.c predict_cclm:511-595
- modes: 81 = LM (both sides), 82 = LM_L, 83 = LM_T (intra.c:303)

Operates on the frame-global reconstruction planes (the reference works
in LCU-local buffers; the math is identical).
"""
from __future__ import annotations

import numpy as np

DIV_SIG_TABLE = np.array([0, 7, 6, 5, 5, 4, 4, 3, 3, 2, 2, 1, 1, 1, 1, 0],
                         dtype=np.int32)

LM_CHROMA_IDX = 81
LM_CHROMA_L_IDX = 82
LM_CHROMA_T_IDX = 83


def _ds_block(rec_y, x0c, y0c, cw, ch):
    """Downsample the co-located luma block to chroma resolution
    ({1,2,1;1,2,1}/8 with left-edge replication)."""
    H, W = rec_y.shape
    out = np.empty((ch, cw), dtype=np.int32)
    ys = 2 * (y0c + np.arange(ch))
    xs = 2 * (x0c + np.arange(cw))
    xm1 = np.maximum(xs - 1, 0)
    s = (4 + 2 * rec_y[np.ix_(ys, xs)] + rec_y[np.ix_(ys, xs + 1)]
         + rec_y[np.ix_(ys, xm1)]
         + 2 * rec_y[np.ix_(ys + 1, xs)] + rec_y[np.ix_(ys + 1, xs + 1)]
         + rec_y[np.ix_(ys + 1, xm1)])
    return (s >> 3).astype(np.int32)


def _ds_top_ref(rec_y, x0c, y0c, n, wpp: bool):
    """Downsampled luma reference row above the block (n chroma samples).

    Above a CTU-row boundary the 3-tap single-row filter is used
    (predict_cclm:552-567 / the cclm_luma_rec_top_line path)."""
    y0l = 2 * y0c
    xs = 2 * x0c + 2 * np.arange(n)
    xm1 = np.maximum(xs - 1, 0)
    if y0l % 64 == 0:
        row = rec_y[y0l - 1]
        s = 2 + 2 * row[xs] + row[np.minimum(xs + 1, rec_y.shape[1] - 1)] \
            + row[xm1]
        return (s >> 2).astype(np.int32)
    r0 = rec_y[y0l - 2]
    r1 = rec_y[y0l - 1]
    xp1 = np.minimum(xs + 1, rec_y.shape[1] - 1)
    s = (4 + 2 * r0[xs] + r0[xp1] + r0[xm1]
         + 2 * r1[xs] + r1[xp1] + r1[xm1])
    return (s >> 3).astype(np.int32)


def _ds_left_ref(rec_y, x0c, y0c, n):
    """Downsampled luma reference column left of the block."""
    ys = 2 * (y0c + np.arange(n))
    x = 2 * x0c - 2
    xm1 = max(x - 1, 0)
    s = (4 + 2 * rec_y[ys, x] + rec_y[ys, x + 1] + rec_y[ys, xm1]
         + 2 * rec_y[ys + 1, x] + rec_y[ys + 1, x + 1] + rec_y[ys + 1, xm1])
    return (s >> 3).astype(np.int32)


def _avail_above_right(coded_mask, x0l, y0l, wl2, fw, wpp: bool) -> int:
    """Units (4 luma px) of available above-right reference beyond the
    block (predict_cclm:545-553)."""
    max_units = wl2 // 4        # width/2 in chroma = luma_width/4 units
    if y0l % 64 == 0:
        x_scu = x0l % 64
        avail = min(max_units, (64 - x_scu - wl2) // 4,
                    (fw - x0l - wl2) // 4)
        if not wpp:
            avail = min(max_units, (fw - x0l - wl2) // 4)
        return max(0, avail)
    avail = 0
    while avail < max_units:
        x_ext = x0l + wl2 + 4 * avail
        if (x0l % 64) + wl2 + 4 * avail >= 64 or x_ext >= fw:
            break
        if not coded_mask[(y0l - 4) // 4, x_ext // 4]:
            break
        avail += 1
    return avail


def _avail_left_below(coded_mask, x0l, y0l, hl2, fh) -> int:
    max_units = hl2 // 4
    if x0l % 64 == 0:
        y_scu = y0l % 64
        return max(0, min(max_units, (64 - y_scu - hl2) // 4,
                          (fh - y0l - hl2) // 4))
    avail = 0
    while avail < max_units:
        y_ext = y0l + hl2 + 4 * avail
        if (y0l % 64) + hl2 + 4 * avail >= 64 or y_ext >= fh:
            break
        if not coded_mask[y_ext // 4, (x0l - 4) // 4]:
            break
        avail += 1
    return avail


def derive_cclm_params(mode: int, cw: int, ch: int, x0c: int, y0c: int,
                       luma_top, luma_left, chroma_top, chroma_left,
                       avail_ar_units: int, avail_lb_units: int,
                       bitdepth: int):
    """(a, b, shift) from the 4-point min/max fit
    (get_cclm_parameters:311)."""
    unit = 2          # chroma samples per unit
    above_units = cw // unit if y0c else 0
    left_units = ch // unit if x0c else 0
    above_avail = above_units != 0
    left_avail = left_units != 0
    top_n = left_n = 0
    if mode == LM_CHROMA_T_IDX:
        left_avail = False
        ar = min(avail_ar_units, ch // unit)
        top_n = unit * (above_units + ar)
    elif mode == LM_CHROMA_L_IDX:
        above_avail = False
        lb = min(avail_lb_units, cw // unit)
        left_n = unit * (left_units + lb)
    else:
        top_n = cw
        left_n = ch
    above_is4 = 0 if left_avail else 1
    left_is4 = 0 if above_avail else 1
    start = [top_n >> (2 + above_is4), left_n >> (2 + left_is4)]
    step = [max(1, top_n >> (1 + above_is4)), max(1, left_n >> (1 + left_is4))]
    sel_l = [0, 0, 0, 0]
    sel_c = [0, 0, 0, 0]
    cnt = 0
    if above_avail:
        cnt_t = min(top_n, (1 + above_is4) << 1)
        pos = start[0]
        while cnt < cnt_t:
            sel_l[cnt] = int(luma_top[pos])
            sel_c[cnt] = int(chroma_top[pos])
            pos += step[0]
            cnt += 1
    if left_avail:
        cnt_l = min(left_n, (1 + left_is4) << 1)
        pos = 0 + start[1]
        k = 0
        while k < cnt_l:
            sel_l[cnt + k] = int(luma_left[pos])
            sel_c[cnt + k] = int(chroma_left[pos])
            pos += step[1]
            k += 1
        cnt += k
    if cnt == 2:
        sel_l[3], sel_c[3] = sel_l[0], sel_c[0]
        sel_l[2], sel_c[2] = sel_l[1], sel_c[1]
        sel_l[0], sel_c[0] = sel_l[1], sel_c[1]
        sel_l[1], sel_c[1] = sel_l[3], sel_c[3]
    mn = [0, 2]
    mx = [1, 3]
    if sel_l[mn[0]] > sel_l[mn[1]]:
        mn[0], mn[1] = mn[1], mn[0]
    if sel_l[mx[0]] > sel_l[mx[1]]:
        mx[0], mx[1] = mx[1], mx[0]
    if sel_l[mn[0]] > sel_l[mx[1]]:
        mn, mx = mx, mn
    if sel_l[mn[1]] > sel_l[mx[0]]:
        mn[1], mx[0] = mx[0], mn[1]
    min_l = (sel_l[mn[0]] + sel_l[mn[1]] + 1) >> 1
    min_c = (sel_c[mn[0]] + sel_c[mn[1]] + 1) >> 1
    max_l = (sel_l[mx[0]] + sel_l[mx[1]] + 1) >> 1
    max_c = (sel_c[mx[0]] + sel_c[mx[1]] + 1) >> 1

    if left_avail or above_avail:
        diff = max_l - min_l
        if diff > 0:
            diff_c = max_c - min_c
            x = diff.bit_length() - 1
            norm_diff = ((diff << 4) >> x) & 15
            v = int(DIV_SIG_TABLE[norm_diff]) | 8
            x += int(norm_diff != 0)
            y = (abs(diff_c).bit_length()) if diff_c else 0
            add = (1 << y) >> 1
            a = (diff_c * v + add) >> y if y else diff_c * v
            shift = 3 + x - y
            if shift < 1:
                shift = 1
                a = 0 if a == 0 else (-15 if a < 0 else 15)
            b = min_c - ((a * min_l) >> shift)
        else:
            a, b, shift = 0, min_c, 0
    else:
        a, b, shift = 0, 1 << (bitdepth - 1), 0
    return a, b, shift


def predict_cclm(mode: int, rec_y, chroma_refs, coded_mask,
                 x0c: int, y0c: int, cw: int, ch: int,
                 fw: int, fh: int, bitdepth: int,
                 wpp: bool = False) -> np.ndarray:
    """CCLM chroma prediction block (predict_cclm:511). chroma_refs:
    IntraRefs of the target chroma plane (top/left with [0] = corner)."""
    x0l, y0l = 2 * x0c, 2 * y0c
    avail_ar = 0
    avail_lb = 0
    luma_top = luma_left = None
    if y0c:
        avail_ar = _avail_above_right(coded_mask, x0l, y0l, 2 * cw, fw, wpp) \
            if mode == LM_CHROMA_T_IDX else 0
        n_top = cw + 2 * avail_ar if mode == LM_CHROMA_T_IDX else cw
        n_top = min(n_top, (fw - x0l) // 2)
        luma_top = _ds_top_ref(rec_y, x0c, y0c, n_top, wpp)
    if x0c:
        avail_lb = _avail_left_below(coded_mask, x0l, y0l, 2 * ch, fh) \
            if mode == LM_CHROMA_L_IDX else 0
        n_left = ch + 2 * avail_lb if mode == LM_CHROMA_L_IDX else ch
        n_left = min(n_left, (fh - y0l) // 2)
        luma_left = _ds_left_ref(rec_y, x0c, y0c, n_left)

    a, b, shift = derive_cclm_params(
        mode, cw, ch, x0c, y0c,
        luma_top if luma_top is not None else np.zeros(1, np.int32),
        luma_left if luma_left is not None else np.zeros(1, np.int32),
        chroma_refs.top[1:], chroma_refs.left[1:],
        avail_ar, avail_lb, bitdepth)
    ds = _ds_block(rec_y, x0c, y0c, cw, ch)
    pred = ((ds * a) >> shift) + b
    return np.clip(pred, 0, (1 << bitdepth) - 1).astype(np.int32)

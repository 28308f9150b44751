"""Inter prediction: motion compensation with 8-tap luma / 4-tap chroma
interpolation, extended-border fetch.

Behavioral parity with the reference MC path:
- filters: uvg_g_luma_filter[16][8], uvg_g_chroma_filter[32][4]
  (uvg266 src/filter.c:62-116)
- kernels: uvg_sample_quarterpel_luma_generic / uvg_sample_octpel_chroma_
  generic (strategies/generic/ipol-generic.c:134,681): 2-pass hor+ver,
  shift1 = bd-8, shift2 = 6, weighted-pred rounding (14-bd)
- border handling: uvg_get_extended_block (edge replication)

MVs are in 1/16-pel luma units (INTERNAL_MV_PREC, global.h:149); chroma
uses 1/32-pel in chroma samples (mv & 31).

numpy host-exact implementation: the golden model for the batched JAX ME
kernels and the oracle's MC.
"""
from __future__ import annotations

import numpy as np

LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0],
], dtype=np.int32)

CHROMA_FILTER = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
], dtype=np.int32)


def fetch_extended_block(plane: np.ndarray, bx: int, by: int,
                         bw: int, bh: int, pad_l: int, pad_t: int,
                         pad_r: int, pad_b: int) -> np.ndarray:
    """Fetch a (bh+pad_t+pad_b) x (bw+pad_l+pad_r) block at (bx, by),
    edge-replicating outside the frame (uvg_get_extended_block)."""
    h, w = plane.shape
    ys = np.clip(np.arange(by - pad_t, by + bh + pad_b), 0, h - 1)
    xs = np.clip(np.arange(bx - pad_l, bx + bw + pad_r), 0, w - 1)
    return plane[np.ix_(ys, xs)]


def mc_luma(ref: np.ndarray, x: int, y: int, w: int, h: int,
            mv: tuple[int, int], bitdepth: int = 8) -> np.ndarray:
    """Motion-compensated luma block; mv in 1/16-pel units."""
    int_x = x + (mv[0] >> 4)
    int_y = y + (mv[1] >> 4)
    fx = mv[0] & 15
    fy = mv[1] & 15
    max_pix = (1 << bitdepth) - 1
    if fx == 0 and fy == 0:
        return fetch_extended_block(ref, int_x, int_y, w, h, 0, 0, 0, 0).astype(np.int32)
    ext = fetch_extended_block(ref, int_x, int_y, w, h, 3, 3, 4, 4).astype(np.int64)
    hf = LUMA_FILTER[fx]
    vf = LUMA_FILTER[fy]
    shift1 = bitdepth - 8
    # horizontal pass over rows [0, h+7), tap window of 8
    hor = np.zeros((h + 7, w), dtype=np.int64)
    for t in range(8):
        hor += hf[t] * ext[:h + 7, t:t + w]
    hor >>= shift1
    # vertical pass
    out = np.zeros((h, w), dtype=np.int64)
    for t in range(8):
        out += vf[t] * hor[t:t + h]
    out >>= 6
    wp_shift = 14 - bitdepth
    out = (out + (1 << (wp_shift - 1))) >> wp_shift
    return np.clip(out, 0, max_pix).astype(np.int32)


def mc_chroma(ref: np.ndarray, x_c: int, y_c: int, w_c: int, h_c: int,
              mv: tuple[int, int], bitdepth: int = 8) -> np.ndarray:
    """Motion-compensated chroma block; mv in 1/16-pel luma units
    (= 1/32-pel chroma). x_c/y_c/w_c/h_c in chroma samples."""
    int_x = x_c + (mv[0] >> 5)
    int_y = y_c + (mv[1] >> 5)
    fx = mv[0] & 31
    fy = mv[1] & 31
    max_pix = (1 << bitdepth) - 1
    if fx == 0 and fy == 0:
        return fetch_extended_block(ref, int_x, int_y, w_c, h_c, 0, 0, 0, 0).astype(np.int32)
    ext = fetch_extended_block(ref, int_x, int_y, w_c, h_c, 1, 1, 2, 2).astype(np.int64)
    hf = CHROMA_FILTER[fx]
    vf = CHROMA_FILTER[fy]
    shift1 = bitdepth - 8
    hor = np.zeros((h_c + 3, w_c), dtype=np.int64)
    for t in range(4):
        hor += hf[t] * ext[:h_c + 3, t:t + w_c]
    hor >>= shift1
    out = np.zeros((h_c, w_c), dtype=np.int64)
    for t in range(4):
        out += vf[t] * hor[t:t + h_c]
    out >>= 6
    wp_shift = 14 - bitdepth
    out = (out + (1 << (wp_shift - 1))) >> wp_shift
    return np.clip(out, 0, max_pix).astype(np.int32)


def change_precision(src: int, dst: int, mv: tuple[int, int]) -> tuple[int, int]:
    """uvg_change_precision (inter.c:1927): precision conversion with the
    VVC rounding rule."""
    shift = dst - src
    hx, hy = mv
    if shift >= 0:
        return hx << shift, hy << shift
    rs = -shift
    offset = 1 << (rs - 1)
    hx = (hx + offset - 1) >> rs if hx >= 0 else (hx + offset) >> rs
    hy = (hy + offset - 1) >> rs if hy >= 0 else (hy + offset) >> rs
    return hx, hy


def round_precision(src: int, dst: int, mv: tuple[int, int]) -> tuple[int, int]:
    return change_precision(dst, src, change_precision(src, dst, mv))


def _mc_luma_hi(ref: np.ndarray, x: int, y: int, w: int, h: int,
                mv: tuple[int, int], bitdepth: int = 8) -> np.ndarray:
    """14-bit intermediate luma prediction (no rounding/clip), for bipred
    averaging (uvg_sample_quarterpel_luma_hi_generic)."""
    int_x = x + (mv[0] >> 4)
    int_y = y + (mv[1] >> 4)
    fx = mv[0] & 15
    fy = mv[1] & 15
    if fx == 0 and fy == 0:
        px = fetch_extended_block(ref, int_x, int_y, w, h, 0, 0, 0, 0)
        return px.astype(np.int64) << (14 - bitdepth)
    ext = fetch_extended_block(ref, int_x, int_y, w, h, 3, 3, 4, 4).astype(np.int64)
    hf = LUMA_FILTER[fx]
    vf = LUMA_FILTER[fy]
    shift1 = bitdepth - 8
    hor = np.zeros((h + 7, w), dtype=np.int64)
    for t in range(8):
        hor += hf[t] * ext[:h + 7, t:t + w]
    hor >>= shift1
    out = np.zeros((h, w), dtype=np.int64)
    for t in range(8):
        out += vf[t] * hor[t:t + h]
    return out >> 6


def _mc_chroma_hi(ref: np.ndarray, x_c: int, y_c: int, w_c: int, h_c: int,
                  mv: tuple[int, int], bitdepth: int = 8) -> np.ndarray:
    int_x = x_c + (mv[0] >> 5)
    int_y = y_c + (mv[1] >> 5)
    fx = mv[0] & 31
    fy = mv[1] & 31
    if fx == 0 and fy == 0:
        px = fetch_extended_block(ref, int_x, int_y, w_c, h_c, 0, 0, 0, 0)
        return px.astype(np.int64) << (14 - bitdepth)
    ext = fetch_extended_block(ref, int_x, int_y, w_c, h_c, 1, 1, 2, 2).astype(np.int64)
    hf = CHROMA_FILTER[fx]
    vf = CHROMA_FILTER[fy]
    shift1 = bitdepth - 8
    hor = np.zeros((h_c + 3, w_c), dtype=np.int64)
    for t in range(4):
        hor += hf[t] * ext[:h_c + 3, t:t + w_c]
    hor >>= shift1
    out = np.zeros((h_c, w_c), dtype=np.int64)
    for t in range(4):
        out += vf[t] * hor[t:t + h_c]
    return out >> 6


def mc_luma_bi(ref0: np.ndarray, ref1: np.ndarray, x: int, y: int,
               w: int, h: int, mv0, mv1, bitdepth: int = 8) -> np.ndarray:
    """Bi-prediction: hi-precision average (bipred_average_*,
    picture-generic.c:1132-1172)."""
    a = _mc_luma_hi(ref0, x, y, w, h, mv0, bitdepth)
    b = _mc_luma_hi(ref1, x, y, w, h, mv1, bitdepth)
    shift = 15 - bitdepth
    out = (a + b + (1 << (shift - 1))) >> shift
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)


def mc_chroma_bi(ref0: np.ndarray, ref1: np.ndarray, x_c: int, y_c: int,
                 w_c: int, h_c: int, mv0, mv1, bitdepth: int = 8) -> np.ndarray:
    a = _mc_chroma_hi(ref0, x_c, y_c, w_c, h_c, mv0, bitdepth)
    b = _mc_chroma_hi(ref1, x_c, y_c, w_c, h_c, mv1, bitdepth)
    shift = 15 - bitdepth
    out = (a + b + (1 << (shift - 1))) >> shift
    return np.clip(out, 0, (1 << bitdepth) - 1).astype(np.int32)

"""Intra prediction: reference construction, planar/DC/angular modes, PDPC.

Behavioral parity with the reference:
- reference building: intra.c uvg_intra_build_reference_any:756-1063 and
  uvg_count_available_edge_cus (cu.c:516)
- mode dispatch + reference smoothing + wide-angle: intra.c
  intra_predict_regular:1372-1468, uvg_wide_angle_correction,
  intra_filter_reference
- prediction kernels: strategies/generic/intra-generic.c
  (uvg_angular_pred_generic:55, uvg_intra_pred_planar_generic:300,
  intra_pred_dc intra.c:236, uvg_pdpc_planar_dc_generic:410)

This module is the host-exact (numpy) implementation used by the sequential
reconstruction path and as the golden model for the batched JAX search
kernels.
"""
from __future__ import annotations

import numpy as np

LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6}

MODEDISP2SAMPLEDISP = np.array(
    [0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32, 35, 39, 45,
     51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512, 1024], dtype=np.int32)
MODEDISP2INVSAMPLEDISP = np.array(
    [0, 16384, 8192, 5461, 4096, 2731, 2048, 1638, 1365, 1170, 1024, 910, 819,
     712, 630, 565, 512, 468, 420, 364, 321, 287, 256, 224, 191, 161, 128, 96,
     64, 48, 32, 16], dtype=np.int32)
PRE_SCALE = np.array(
    [8, 7, 6, 5, 5, 4, 4, 4, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1,
     1, 0, 0, 0, -1, -1, -2, -3], dtype=np.int32)

CUBIC_FILTER = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
], dtype=np.int32)

HOR_VER_DIST_THRES = [24, 24, 24, 14, 2, 0, 0, 0]


def wide_angle_correction(mode: int, log2_w: int, log2_h: int,
                          account_for_dc_planar: bool = False) -> int:
    pred_mode = mode
    if log2_w != log2_h and 1 < mode <= 66:
        mode_shift = [0, 6, 10, 12, 14, 15]
        delta = abs(log2_w - log2_h)
        if log2_w > log2_h and mode < 2 + mode_shift[delta]:
            pred_mode += 65
        elif log2_h > log2_w and mode > 66 - mode_shift[delta]:
            pred_mode -= 65 + (2 if account_for_dc_planar else 0)
    return pred_mode


class IntraRefs:
    """top/left reference arrays; index 0 is the top-left sample."""
    __slots__ = ("top", "left", "filtered_top", "filtered_left",
                 "filtered_initialized")

    def __init__(self, top: np.ndarray, left: np.ndarray):
        self.top = top
        self.left = left
        self.filtered_top = None
        self.filtered_left = None
        self.filtered_initialized = False

    def filtered(self, log2_w: int, log2_h: int):
        """[1 2 1]/4 reference smoothing (intra.c intra_filter_reference)."""
        if not self.filtered_initialized:
            rw = 2 * (1 << log2_w) + 1
            rh = 2 * (1 << log2_h) + 1
            ft = self.top.copy()
            fl = self.left.copy()
            fl[0] = (self.left[1] + 2 * self.left[0] + self.top[1] + 2) >> 2
            ft[0] = fl[0]
            l_ = self.left.astype(np.int32)
            t_ = self.top.astype(np.int32)
            fl[1:rh - 1] = ((l_[:rh - 2] + 2 * l_[1:rh - 1] + l_[2:rh] + 2) >> 2)
            ft[1:rw - 1] = ((t_[:rw - 2] + 2 * t_[1:rw - 1] + t_[2:rw] + 2) >> 2)
            fl[rh - 1] = self.left[rh - 1]
            ft[rw - 1] = self.top[rw - 1]
            self.filtered_top = ft
            self.filtered_left = fl
            self.filtered_initialized = True
        return self.filtered_top, self.filtered_left


def count_available_edge_units(x: int, y: int, w: int, h: int,
                               coded_mask: np.ndarray, left: bool,
                               lcu_size: int = 64) -> int:
    """Number of available 4-px units along the left/top edge (cu.c:516).

    coded_mask is a frame-level boolean [h/4, w/4] map of already-coded
    4x4 units (updated in coding order).
    """
    local_x = x % lcu_size
    local_y = y % lcu_size
    if (left and x == 0) or (not left and y == 0):
        return 0
    if left and local_x == 0:
        return (lcu_size - local_y) // 4
    if not left and local_y == 0:
        return w // 2
    mh, mw = coded_mask.shape
    if left:
        amount = h & ~3
        while (local_y + amount < lcu_size
               and (y + amount) // 4 < mh
               and coded_mask[(y + amount) // 4, (x - 4) // 4]):
            amount += 4
        return max(amount, h) // 4
    amount = w & ~3
    while (local_x + amount < lcu_size
           and (x + amount) // 4 < mw
           and coded_mask[(y - 4) // 4, (x + amount) // 4]):
        amount += 4
    return max(amount, w) // 4


def build_reference(plane: np.ndarray, coded_mask: np.ndarray,
                    x: int, y: int, w: int, h: int,
                    pic_w: int, pic_h: int, bitdepth: int = 8,
                    is_chroma: bool = False, lcu_size: int = 64,
                    tile_rect=None, wpp: bool = False) -> IntraRefs:
    """Build unfiltered top/left reference lines for a PU at (x, y) in the
    given (chroma-scaled, if chroma) plane coordinates.

    plane: reconstruction plane (full frame), coded_mask: 4x4 (luma units)
    coded map in the same color plane's units scaled to luma via caller.
    Mirrors uvg_intra_build_reference_any for MRL=0, no ISP.

    tile_rect: optional (x0, y0, x1, y1) in *plane-domain* pixels; samples
    outside it are treated as unavailable (VVC tile prediction break). Tile
    boundaries are CTU-aligned, so with tile-raster coding order the
    coded_mask walks never observe a cross-tile unit as coded.
    """
    if tile_rect is None:
        tx0, ty0, tx1, ty1 = 0, 0, pic_w, pic_h
    else:
        tx0, ty0, tx1, ty1 = tile_rect
    log2_w, log2_h = LOG2[w], LOG2[h]
    dc_val = 1 << (bitdepth - 1)
    max_len = 3 * 64 + 3
    top = np.full(max_len, dc_val, dtype=np.int32)
    left = np.full(max_len, dc_val, dtype=np.int32)

    # luma-domain coordinates for availability counting
    sc = 1 if is_chroma else 0
    lx, ly = x << sc, y << sc
    lw, lh = w << sc, h << sc

    # --- left reference ---
    s = max(0, log2_h - log2_w)
    ext = (h << s) + 2
    total_height = min(h * 2 + ext, max_len - 1)
    if x > tx0:
        if x % (lcu_size >> sc) == 0:
            navail = ((lcu_size - (ly % lcu_size)) // 4)
        else:
            navail = count_available_edge_units(lx, ly, lw, lh, coded_mask, True, lcu_size)
        px_avail = navail * (2 if is_chroma else 4)
        px_avail = min(px_avail, h + h)           # cu_height + pu_height
        px_avail = min(px_avail, ty1 - y)
        px_avail = max(px_avail, 1)
        left[1:1 + px_avail] = plane[y:y + px_avail, x - 1]
        left[1 + px_avail:1 + total_height] = plane[y + px_avail - 1, x - 1]
    else:
        nearest = plane[y - 1, x] if y > ty0 else dc_val
        left[1:1 + total_height] = nearest

    # --- top-left ---
    if x > tx0 and y > ty0:
        left[0] = plane[y - 1, x - 1]
        top[0] = left[0]
    else:
        left[0] = left[1]
        top[0] = left[1]

    # --- top reference ---
    s = max(0, log2_w - log2_h)
    ext = (w << s) + 2
    total_width = min(w * 2 + ext, max_len - 1)
    if y > ty0:
        if y % (lcu_size >> sc) == 0:
            navail = lw // 2
        else:
            navail = count_available_edge_units(lx, ly, lw, lh, coded_mask, False, lcu_size)
        px_avail = navail * (2 if is_chroma else 4)
        px_avail = min(px_avail, w + w)
        px_avail = min(px_avail, tx1 - x)
        if wpp and y % (lcu_size >> sc) == 0:
            # entropy sync (WPP): the above-right CTU is normatively
            # unavailable (VVC 6.4.4 availability with
            # sps_entropy_coding_sync_enabled_flag; intra.c:1318) — clamp
            # top refs at the CTU right edge for CTU-top-row blocks.
            px_avail = min(px_avail,
                           (lcu_size >> sc) - (x % (lcu_size >> sc)))
        px_avail = max(px_avail, 1)
        top[1:1 + px_avail] = plane[y - 1, x:x + px_avail]
        top[1 + px_avail:1 + total_width] = plane[y - 1, x + px_avail - 1]
    else:
        nearest = plane[y, x - 1] if x > tx0 else dc_val
        top[1:1 + total_width] = nearest

    return IntraRefs(top, left)


def build_reference_isp(plane: np.ndarray, coded_mask: np.ndarray,
                        cu_x: int, cu_y: int, cu_w: int, cu_h: int,
                        pu_x: int, pu_y: int, pu_w: int, pu_h: int,
                        pic_w: int, pic_h: int, isp_mode: int,
                        bitdepth: int = 8, lcu_size: int = 64,
                        tile_rect=None, wpp: bool = False) -> IntraRefs:
    """Reference construction for an ISP sub-block (luma only).

    Mirrors uvg_intra_build_reference_any's ISP arm
    (uvg266 src/intra.c:850-900 left, :1016-1060 top):
    - first sub-block: availability and extension as if predicting the
      whole CU (lengths cu_dim*2)
    - later sub-blocks: the edge shared with the previous sub-block is
      fully available from the in-progress reconstruction; extension
      length is cu_dim + pu_dim
    """
    from ..ops.isp import ISP_VER
    if tile_rect is None:
        tx0, ty0, tx1, ty1 = 0, 0, pic_w, pic_h
    else:
        tx0, ty0, tx1, ty1 = tile_rect
    first = pu_x == cu_x and pu_y == cu_y
    log2_w, log2_h = LOG2[pu_w], LOG2[pu_h]
    dc_val = 1 << (bitdepth - 1)
    max_len = 3 * 64 + 3
    top = np.full(max_len, dc_val, dtype=np.int32)
    left = np.full(max_len, dc_val, dtype=np.int32)

    def cu_edge_avail(left_edge: bool) -> int:
        """Available pixels along the CU's left/top edge (CU-level rule of
        the regular builder)."""
        if left_edge:
            if cu_x % lcu_size == 0:
                n = (lcu_size - (cu_y % lcu_size)) // 4
            else:
                n = count_available_edge_units(cu_x, cu_y, cu_w, cu_h,
                                               coded_mask, True, lcu_size)
        else:
            if cu_y % lcu_size == 0:
                n = cu_w // 2
            else:
                n = count_available_edge_units(cu_x, cu_y, cu_w, cu_h,
                                               coded_mask, False, lcu_size)
        return n * 4

    # --- left reference ---
    s = max(0, log2_h - log2_w)
    ext = (pu_h << s) + 2
    tmp_h = cu_h * 2 if first else cu_h + pu_h
    total_height = min(tmp_h + ext, max_len - 1)
    if pu_x > tx0:
        if not first and isp_mode == ISP_VER:
            avail = pu_h
        elif not first:
            avail = cu_edge_avail(True) - (pu_y - cu_y)
        else:
            avail = cu_edge_avail(True)
        avail = min(avail, cu_h + pu_h, ty1 - pu_y)
        n = max(avail, 0)
        if n:
            left[1:1 + n] = plane[pu_y:pu_y + n, pu_x - 1]
        nearest = plane[pu_y + avail - 1, pu_x - 1]
        left[1 + n:1 + total_height] = nearest
    else:
        nearest = plane[pu_y - 1, pu_x] if pu_y > ty0 else dc_val
        left[1:1 + total_height] = nearest

    # --- top-left ---
    if pu_x > tx0 and pu_y > ty0:
        left[0] = plane[pu_y - 1, pu_x - 1]
        top[0] = left[0]
    else:
        left[0] = left[1]
        top[0] = left[1]

    # --- top reference ---
    s = max(0, log2_w - log2_h)
    ext = (pu_w << s) + 2
    tmp_w = cu_w * 2 if first else cu_w + pu_w
    total_width = min(tmp_w + ext, max_len - 1)
    if pu_y > ty0:
        if not first and isp_mode != ISP_VER:
            avail = pu_w
        elif not first:
            avail = cu_edge_avail(False) - (pu_x - cu_x)
        else:
            avail = cu_edge_avail(False)
        avail = min(avail, cu_w + pu_w, tx1 - pu_x)
        if wpp and pu_y % lcu_size == 0:
            avail = min(avail, lcu_size - (pu_x % lcu_size))
        n = max(avail, 0)
        if n:
            top[1:1 + n] = plane[pu_y - 1, pu_x:pu_x + n]
        nearest = plane[pu_y - 1, pu_x + avail - 1]
        top[1 + n:1 + total_width] = nearest
    else:
        nearest = plane[pu_y, pu_x - 1] if pu_x > tx0 else dc_val
        top[1:1 + total_width] = nearest

    return IntraRefs(top, left)


def pred_planar(w: int, h: int, ref_top: np.ndarray, ref_left: np.ndarray) -> np.ndarray:
    log2_w, log2_h = LOG2[w], LOG2[h]
    top_right = int(ref_top[w + 1])
    bottom_left = int(ref_left[h + 1])
    xs = np.arange(w)
    ys = np.arange(h)
    t = ref_top[1:1 + w].astype(np.int32)
    l = ref_left[1:1 + h].astype(np.int32)
    hor = ((l << log2_w)[:, None] + (top_right - l)[:, None] * (xs + 1)[None, :])
    ver = ((t << log2_h)[None, :] + (bottom_left - t)[None, :] * (ys + 1)[:, None])
    offset = 1 << (log2_w + log2_h)
    return ((hor << log2_h) + (ver << log2_w) + offset) >> (1 + log2_w + log2_h)


def pred_dc(w: int, h: int, ref_top: np.ndarray, ref_left: np.ndarray) -> np.ndarray:
    s = 0
    if w >= h:
        s += int(ref_top[1:1 + w].sum())
    if w <= h:
        s += int(ref_left[1:1 + h].sum())
    denom = (w << 1) if w == h else max(w, h)
    dc = (s + (denom >> 1)) >> (denom.bit_length() - 1)
    return np.full((h, w), dc, dtype=np.int32)


def pdpc_planar_dc(pred: np.ndarray, w: int, h: int,
                   ref_top: np.ndarray, ref_left: np.ndarray) -> np.ndarray:
    log2_w, log2_h = LOG2[w], LOG2[h]
    scale = (log2_w + log2_h - 2) >> 2
    xs = np.arange(w)
    ys = np.arange(h)
    w_l = 32 >> np.minimum(31, (xs << 1) >> scale)
    w_t = 32 >> np.minimum(31, (ys << 1) >> scale)
    l = ref_left[1:1 + h].astype(np.int32)
    t = ref_top[1:1 + w].astype(np.int32)
    p = pred.astype(np.int32)
    out = p + ((w_l[None, :] * (l[:, None] - p)
                + w_t[:, None] * (t[None, :] - p) + 32) >> 6)
    return out


def pred_angular(w: int, h: int, pred_mode: int,
                 ref_top: np.ndarray, ref_left: np.ndarray,
                 bitdepth: int = 8, is_chroma: bool = False,
                 force_cubic: bool = False) -> np.ndarray:
    """Angular prediction incl. wide-angle modes and gradient PDPC.

    pred_mode is the wide-angle-corrected mode (may be <2 or >66).
    Scalar mirror of uvg_angular_pred_generic.
    """
    log2_w, log2_h = LOG2[w], LOG2[h]
    max_pix = (1 << bitdepth) - 1
    vertical_mode = pred_mode >= 34
    mode_disp = pred_mode - 50 if vertical_mode else -(pred_mode - 18)
    sample_disp = (-1 if mode_disp < 0 else 1) * int(MODEDISP2SAMPLEDISP[abs(mode_disp)])
    side_size = log2_h if vertical_mode else log2_w
    scale = min(2, side_size - int(PRE_SCALE[abs(mode_disp)]))

    if sample_disp < 0:
        # negative-angle: build extended main reference from the side ref
        size_main = h if vertical_mode else w
        size_side = h if not vertical_mode else w
        # wait: main = above for vertical
        if vertical_mode:
            main = np.zeros(h + w + 3 + 1 + 64, dtype=np.int32)
            main[h:h + w + 2] = ref_top[:w + 2]
            side = ref_left
            size_side = h
            base = h
        else:
            main = np.zeros(w + h + 3 + 1 + 64, dtype=np.int32)
            main[w:w + h + 2] = ref_left[:h + 2]
            side = ref_top
            size_side = w
            base = w
        inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
        for i in range(-size_side, 0):
            main[base + i] = side[min((-i * inv + 256) >> 9, size_side)]
        ref_main = main
        ref_main_base = base
        ref_side = side
    else:
        ref_main = (ref_top if vertical_mode else ref_left).astype(np.int32)
        ref_side = ref_left if vertical_mode else ref_top
        ref_main_base = 0

    # after swap, operate in "vertical" orientation
    ww, hh = (w, h) if vertical_mode else (h, w)
    work = np.zeros((hh, ww), dtype=np.int32)

    if sample_disp != 0:
        use_cubic = True
        thres = HOR_VER_DIST_THRES[(log2_w + log2_h) >> 1]
        dist = min(abs(pred_mode - 50), abs(pred_mode - 18))
        if dist > thres and (abs(sample_disp) & 0x1F) != 0:
            use_cubic = False
        if force_cubic:
            # MRL/ISP always use the cubic filter (intra-generic.c:182-186)
            use_cubic = True
        for y in range(hh):
            delta_pos = sample_disp * (y + 1)
            delta_int = delta_pos >> 5
            delta_fract = delta_pos & 31
            if (abs(sample_disp) & 0x1F) != 0:
                if not is_chroma:
                    if use_cubic:
                        f = CUBIC_FILTER[delta_fract]
                    else:
                        f = np.array([16 - (delta_fract >> 1),
                                      32 - (delta_fract >> 1),
                                      16 + (delta_fract >> 1),
                                      delta_fract >> 1], dtype=np.int32)
                    idx = ref_main_base + delta_int + np.arange(ww)
                    p0 = ref_main[idx]
                    p1 = ref_main[idx + 1]
                    p2 = ref_main[idx + 2]
                    p3 = ref_main[idx + 3]
                    v = (f[0] * p0 + f[1] * p1 + f[2] * p2 + f[3] * p3 + 32) >> 6
                    work[y] = np.clip(v, 0, max_pix)
                else:
                    idx = ref_main_base + delta_int + np.arange(ww)
                    r1 = ref_main[idx + 1]
                    r2 = ref_main[idx + 2]
                    work[y] = r1 + ((delta_fract * (r2 - r1) + 16) >> 5)
            else:
                idx = ref_main_base + delta_int + np.arange(ww)
                work[y] = ref_main[idx + 1]

            # gradient PDPC for positive angular modes
            pdpc = (w >= 4 and h >= 4)
            if 1 < pred_mode < 67:
                if mode_disp < 0:
                    pdpc = False
                elif mode_disp > 0:
                    pdpc = pdpc and scale >= 0
            if pdpc:
                inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
                inv_angle_sum = 256
                for xx in range(min(3 << scale, ww)):
                    inv_angle_sum += inv
                    wl = 32 >> ((2 * xx) >> scale)
                    left_px = int(ref_side[y + (inv_angle_sum >> 9) + 1])
                    work[y, xx] = work[y, xx] + ((wl * (left_px - work[y, xx]) + 32) >> 6)
    else:
        # purely horizontal/vertical
        do_pdpc = (w >= 4 and h >= 4)
        row = ref_main[ref_main_base + 1:ref_main_base + 1 + ww]
        work[:] = row[None, :]
        if do_pdpc:
            sc2 = (log2_w + log2_h - 2) >> 2
            top_left = int(ref_main[ref_main_base])
            for y in range(hh):
                left_px = int(ref_side[1 + y])
                for xx in range(min(3 << sc2, ww)):
                    wl = 32 >> ((2 * xx) >> sc2)
                    val = work[y, xx]
                    work[y, xx] = np.clip(val + ((wl * (left_px - top_left) + 32) >> 6), 0, max_pix)

    if not vertical_mode:
        work = work.T
    return work.astype(np.int32)


def predict_intra(mode: int, w: int, h: int, refs: IntraRefs,
                  bitdepth: int = 8, is_chroma: bool = False,
                  smoothing_disabled: bool = False,
                  cu_log2_w: int | None = None, cu_log2_h: int | None = None,
                  isp: bool = False) -> np.ndarray:
    """Full regular intra prediction dispatcher (intra_predict_regular).

    isp: prediction of an ISP sub-block — unfiltered references and the
    cubic interpolation filter (intra.c:691, intra-generic.c:182-186);
    wide-angle mapping must use the CU dims via cu_log2_w/h."""
    log2_w, log2_h = LOG2[w], LOG2[h]
    pred_mode = wide_angle_correction(mode, cu_log2_w or log2_w, cu_log2_h or log2_h)

    top, left_arr = refs.top, refs.left
    if smoothing_disabled or is_chroma or mode == 1 or (w == 4 and h == 4) \
            or isp:
        pass
    elif mode == 0:
        if w * h > 32:
            top, left_arr = refs.filtered(cu_log2_w or log2_w, cu_log2_h or log2_h)
    else:
        thres = HOR_VER_DIST_THRES[(log2_w + log2_h) >> 1]
        dist = min(abs(pred_mode - 50), abs(pred_mode - 18))
        if dist > thres:
            mode_disp = pred_mode - 50 if pred_mode >= 34 else 18 - pred_mode
            sample_disp = (-1 if mode_disp < 0 else 1) * int(MODEDISP2SAMPLEDISP[abs(mode_disp)])
            if (abs(sample_disp) & 0x1F) == 0:
                top, left_arr = refs.filtered(cu_log2_w or log2_w, cu_log2_h or log2_h)

    if mode == 0:
        pred = pred_planar(w, h, top, left_arr)
    elif mode == 1:
        pred = pred_dc(w, h, top, left_arr)
    else:
        pred = pred_angular(w, h, pred_mode, top, left_arr, bitdepth,
                            is_chroma, force_cubic=isp)

    if mode in (0, 1) and w >= 4 and h >= 4:
        pred = pdpc_planar_dc(pred, w, h, top, left_arr)
    return np.clip(pred, 0, (1 << bitdepth) - 1).astype(np.int32)


def build_reference_mrl(plane: np.ndarray, coded_mask: np.ndarray,
                        x: int, y: int, w: int, h: int,
                        pic_w: int, pic_h: int, bitdepth: int,
                        mrl: int, inv_lut=None,
                        tile_rect=None) -> IntraRefs:
    """Reference lines for MRL (line index 1 or 2): samples from row
    y-1-mrl / column x-1-mrl (uvg_intra_build_reference_inner MRL path,
    intra.c:1155-1343). Availability follows the line-0 rules
    (count_available_edge_cus + size/picture clamps); samples past the
    available extent repeat the nearest available one — reading the raw
    plane there would leak not-yet-coded pixels (above-right /
    below-left), which is exactly what the substitution prevents.
    MRL is only used away from the CTU top row, so the offset rows lie
    inside the current CTU row band.

    inv_lut (LMCS): at an LCU left border the reference encoder copies
    the extra MRL lines straight from the frame-level rec buffer
    (intra.c:1570-1585) — AFTER the left CTU's per-LCU inverse mapping
    (encoderstate.c:829) — so those samples are in the UNMAPPED domain
    while everything else predicts in the mapped domain. Passing the
    frame's inverse LUT replicates that quirk bit-exactly.
    """
    dc_val = 1 << (bitdepth - 1)
    max_len = 3 * 64 + 3
    top = np.full(max_len, dc_val, dtype=np.int32)
    left = np.full(max_len, dc_val, dtype=np.int32)
    lcu_size = 64
    # tile prediction break: the reference codes each tile against a
    # sub-image view, so a tile's left edge behaves exactly like the
    # picture's left edge (encoderstate.c:1256-1306)
    if tile_rect is None:
        tx0, _ty0, tx1, _ty1 = 0, 0, pic_w, pic_h
    else:
        tx0, _ty0, tx1, _ty1 = tile_rect

    # --- left reference (intra.c:1236-1292) ---
    if x > tx0:
        if x % lcu_size == 0:
            navail = (lcu_size - (y % lcu_size)) // 4
        else:
            navail = count_available_edge_units(x, y, w, h, coded_mask,
                                                True, lcu_size)
        px_avail = min(navail * 4, h + h, pic_h - y)
        # the reference's copy loop (intra.c:1259-1275) is a do/while
        # from i = mrl while i < px_avail; when y%4==0 and px_avail%4==0
        # it runs 4-at-a-time and OVERSHOOTS to the next multiple of 4
        # past (px_avail - mrl) — the extension's nearest sample then
        # comes from the overshot last row. Bit-exact parity requires
        # mirroring the overshoot.
        if y % 4 == 0 and px_avail % 4 == 0 and px_avail > mrl:
            n_copy = 4 * ((px_avail - mrl + 3) // 4)
        else:
            n_copy = max(px_avail - mrl, 1)
        rows = np.clip(y + np.arange(n_copy), 0, pic_h - 1)
        col = plane[rows, x - 1 - mrl]
        if inv_lut is not None and x % lcu_size == 0:
            col = inv_lut[col]
        left[1 + mrl:1 + mrl + n_copy] = col
        last = mrl + n_copy
        total_height = min(2 * h + mrl + h + 2, max_len - 2)
        left[1 + last:4 + total_height] = left[last]
    # --- top reference (intra.c:1295-1343) ---
    if y > 0:
        if y % lcu_size == 0:
            navail = w // 2
        else:
            navail = count_available_edge_units(x, y, w, h, coded_mask,
                                                False, lcu_size)
        px_avail = min(navail * 4, w + w, pic_w - x, tx1 - x)
        px_avail = max(px_avail, 1)
        cols = np.clip(x + np.arange(px_avail), 0, pic_w - 1)
        top[1 + mrl:1 + mrl + px_avail] = plane[y - 1 - mrl, cols]
        last = mrl + px_avail
        total_width = min(2 * w + mrl + w + 2, max_len - 2)
        top[1 + last:4 + total_width] = top[last]
    # --- top-left corner entries 0..mrl (intra.c:1158-1214) ---
    if x == tx0:
        # picture left border: every left sample (and the corner
        # entries) comes from the first sample of the offset top line
        ry = y - 1 - mrl
        fill = int(plane[ry, x]) if ry >= 0 else dc_val
        left[:] = fill
        top[:1 + mrl] = fill
    else:
        border = inv_lut is not None and x % lcu_size == 0
        for i in range(mrl + 1):
            lv = plane[y + i - 1 - mrl, x - 1 - mrl]
            tv = plane[y - 1 - mrl, x + i - 1 - mrl]
            if border:
                lv = inv_lut[lv]
                tv = inv_lut[tv]
            left[i] = lv
            top[i] = tv
    return IntraRefs(top, left)


def predict_intra_mrl(mode: int, w: int, h: int, refs: IntraRefs,
                      mrl: int, bitdepth: int = 8) -> np.ndarray:
    """Angular/DC prediction from reference line `mrl` (1 or 2)
    (uvg_angular_pred_generic with multi_ref_index, intra-generic.c:55;
    cubic interpolation forced, no smoothing, no PDPC). refs index 0 is
    the line-mrl corner sample; planar is excluded by the MRL mode list.
    """
    assert 2 <= mode <= 66 or mode == 1
    maxv = (1 << bitdepth) - 1
    if mode == 1:           # DC over the offset line (intra-generic.c:376)
        s = 0
        if w >= h:
            s += int(refs.top[1 + mrl:1 + mrl + w].sum())
        if w <= h:
            s += int(refs.left[1 + mrl:1 + mrl + h].sum())
        denom = (w << 1) if w == h else max(w, h)
        dc = (s + (denom >> 1)) >> (denom.bit_length() - 1)
        return np.full((h, w), dc, dtype=np.int32)

    log2_w, log2_h = LOG2[w], LOG2[h]
    vertical = mode >= 34
    mode_disp = (mode - 50) if vertical else -(mode - 18)
    sample_disp = (-1 if mode_disp < 0 else 1)         * int(MODEDISP2SAMPLEDISP[abs(mode_disp)])
    ww, hh = (w, h) if vertical else (h, w)   # work in main-ref space

    in_main = refs.top if vertical else refs.left
    in_side = refs.left if vertical else refs.top
    max_len = in_main.shape[0]
    if sample_disp < 0:
        # negative angles: extend main backwards by projecting the side
        inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
        size_side = hh
        main = np.zeros(size_side + max_len, dtype=np.int64)
        main[size_side:] = in_main
        for i in range(-size_side, 0):
            main[size_side + i] = in_side[
                min(((-i * inv + 256) >> 9), size_side)]
        base = size_side + mrl
    else:
        main = in_main.astype(np.int64)
        base = mrl

    # NOTE: negative delta_int indexes BEFORE the line-offset base (the
    # projected extension); index main[base + idx] explicitly — a sliced
    # view would wrap negative indices to the array end.
    out = np.zeros((hh, ww), dtype=np.int64)
    if sample_disp == 0:
        for yy in range(hh):
            out[yy] = main[base + 1 + np.arange(ww)]
    else:
        for yy in range(hh):
            delta_pos = sample_disp * (1 + mrl) + yy * sample_disp
            delta_int = delta_pos >> 5
            delta_fract = delta_pos & 31
            idx = base + delta_int + np.arange(ww)
            if (abs(sample_disp) & 31) != 0:
                f = CUBIC_FILTER[delta_fract]
                p = np.stack([main[idx + k] for k in range(4)])
                v = (f[0] * p[0] + f[1] * p[1] + f[2] * p[2]
                     + f[3] * p[3] + 32) >> 6
                out[yy] = np.clip(v, 0, maxv)
            else:
                out[yy] = main[idx + 1]
    if not vertical:
        out = out.T
    return out.astype(np.int32)

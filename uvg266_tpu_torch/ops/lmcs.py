"""LMCS (luma mapping with chroma scaling) numeric core.

Three layers, mirroring the split in the reference (src/reshape.c):

1. `seq_stats` — per-bin histogram + windowed log-variance preanalysis
   (reshape.c uvg_calc_seq_stats:121, a per-pixel sliding-window variance
   accumulated per 16-bin luma histogram).  The reference walks pixels
   with incremental row/column sums; here the same clipped-window sums
   come from two integral images, fully vectorized.
2. `allocate_codewords` — encoder-side SDR codeword allocation
   (reshape.c uvg_lmcs_preanalyzer:840 + deriveReshapeParametersSDR:495
   with updateCtrl=1, the mode uvg266 hardcodes at encoderstate.c:2011).
   Returns None when LMCS should be disabled for the sequence.
3. `build_luts` — the *normative* PWL construction shared by encoder and
   decoder (reshape.c uvg_construct_reshaper_lmcs:1257; VVC spec 8.8.2):
   pivots, fwd/inv scale coefficients, fwd/inv sample LUTs and the
   chroma scaling LUT, all integer-exact.

The per-frame LUT application itself is a gather (`fwd_lut[plane]`) —
XLA-friendly and fused into the frame pipeline by the caller.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PIC_CODE_CW_BINS = 16
FP_PREC = 11
CSCALE_FP_PREC = 11


# --- preanalysis ------------------------------------------------------------

@dataclass
class SeqStats:
    bin_hist: np.ndarray        # [16] fraction of pixels per luma bin
    bin_var: np.ndarray         # [16] mean log10(local variance + 1)
    norm_var: np.ndarray        # [16] bin_var / mean_bin_var
    min_bin_var: float
    max_bin_var: float
    mean_bin_var: float
    nonzero_cnt: int
    weight_var: float
    weight_norm: float
    ratio_std_u: float
    ratio_std_v: float


def _window_sums(p: np.ndarray, wl: int):
    """Clipped-window box sums: for each pixel, the sum and count over the
    (2*wl+1)^2 window clipped to the frame (integral-image form of the
    incremental row/col walk in uvg_calc_seq_stats)."""
    h, w = p.shape
    ii = np.zeros((h + 1, w + 1), dtype=np.float64)
    np.cumsum(np.cumsum(p, axis=0), axis=1, out=ii[1:, 1:])
    ys = np.arange(h)
    xs = np.arange(w)
    y1 = np.maximum(ys - wl, 0)
    y2 = np.minimum(ys + wl, h - 1) + 1
    x1 = np.maximum(xs - wl, 0)
    x2 = np.minimum(xs + wl, w - 1) + 1
    s = (ii[y2[:, None], x2[None, :]] - ii[y1[:, None], x2[None, :]]
         - ii[y2[:, None], x1[None, :]] + ii[y1[:, None], x1[None, :]])
    n = (y2 - y1)[:, None] * (x2 - x1)[None, :]
    return s, n.astype(np.float64)


def seq_stats(y: np.ndarray, u: np.ndarray | None, v: np.ndarray | None,
              bitdepth: int = 8) -> SeqStats:
    """Per-bin luma histogram and windowed log-variance, plus the
    chroma/luma std ratios (uvg_calc_seq_stats, reshape.c:121)."""
    h, w = y.shape
    n_bins = PIC_CODE_CW_BINS
    wl = max(1, min(h, w) // 240)
    yf = y.astype(np.float64)
    s1, n = _window_sums(yf, wl)
    s2, _ = _window_sums(yf * yf, wl)
    avg = s1 / n
    var = s2 / n - avg * avg
    # normalize variance to the 10-bit domain before the log
    if bitdepth < 10:
        var = var * float(1 << (20 - 2 * bitdepth))
    elif bitdepth > 10:
        var = var / float(1 << (2 * bitdepth - 20))
    var_log = np.log10(np.maximum(var, 0.0) + 1.0)

    bin_len = (1 << bitdepth) // n_bins
    bins = (y // bin_len).astype(np.int64).ravel()
    cnt = np.bincount(bins, minlength=n_bins).astype(np.float64)
    vsum = np.bincount(bins, weights=var_log.ravel(), minlength=n_bins)
    hist = cnt / float(h * w)
    bin_var = np.where(cnt > 0, vsum / np.maximum(cnt, 1), 0.0)

    nz = hist > 0.001
    nonzero = int(nz.sum())
    mean_bv = float(bin_var[nz].mean()) if nonzero else 0.0
    min_bv = float(bin_var[nz].min()) if nonzero else 5.0
    max_bv = float(bin_var[nz].max()) if nonzero else 0.0
    norm = bin_var / mean_bv if mean_bv > 0 else np.zeros_like(bin_var)
    weight_var = float((hist * bin_var).sum())
    weight_norm = float((hist * norm).sum())

    ratio_u = ratio_v = 0.0
    if u is not None and v is not None:
        var_y = float(yf.var())
        if var_y > 0:
            ratio_u = float(np.sqrt(u.astype(np.float64).var())
                            / np.sqrt(var_y))
            ratio_v = float(np.sqrt(v.astype(np.float64).var())
                            / np.sqrt(var_y))
    return SeqStats(hist, bin_var, norm, min_bv, max_bv, mean_bv, nonzero,
                    weight_var, weight_norm, ratio_u, ratio_v)


# --- encoder-side codeword allocation ---------------------------------------

def _perturb(hist: np.ndarray, norm_var: np.ndarray, base: np.ndarray
             ) -> np.ndarray:
    """Variance-driven per-bin codeword perturbation (cwPerturbation,
    reshape.c:416): flat bins (low normalized variance) get extra
    codewords, busy bins lose them, step sizes proportional to the bin's
    histogram mass."""
    hh = np.minimum(hist, 0.4)
    d1 = np.floor(10.0 * hh + 0.5)
    d2 = np.floor(20.0 * hh + 0.5)
    active = hist > 0.001
    cw = base.astype(np.float64).copy()
    cw += np.where(active & (norm_var < 0.8), d2,
                   np.where(active & (norm_var < 0.9), d1, 0.0))
    cw -= np.where(active & (norm_var > 1.2), d2,
                   np.where(active & (norm_var > 1.1), d1, 0.0))
    return cw.astype(np.int64)


def _reduce(cw: np.ndarray, lo: int, hi: int, tot_cw: int) -> np.ndarray:
    """Scale the allocation back under the budget (cwReduction,
    reshape.c:459): uniform decrement over [lo, hi] plus a remainder
    walk."""
    cw = cw.copy()
    used = int(cw.sum())
    max_allowed = tot_cw - 1
    if used > max_allowed:
        span = hi - lo + 1
        delta = used - max_allowed
        div, mod = delta // span, delta % span
        if div:
            cw[lo:hi + 1] -= div
        for i in range(lo, hi + 1):
            if mod == 0:
                break
            if cw[i] > 0:
                cw[i] -= 1
                mod -= 1
    return cw


def allocate_codewords(stats: SeqStats, bitdepth: int = 8,
                       base_qp: int = 22, pic_size: int = 0
                       ) -> np.ndarray | None:
    """SDR codeword allocation for the AI update mode (updateCtrl=1, the
    uvg266 default — encoderstate.c:2011).  Returns per-bin codewords in
    10-bit units, or None when the preanalysis disables reshaping
    (uvg_lmcs_preanalyzer:840 guards + deriveReshapeParametersSDR:495).

    The branchy VTM tuning tree is distilled to its dominant decisions:
    the skip guards, the isLowCase budget reduction and the bright/dark
    histogram specials; the long tail of content-specific overrides is
    intentionally not reproduced.
    """
    hist, bv = stats.bin_hist, stats.bin_var
    n = PIC_CODE_CW_BINS
    # standard-range bins in 10-bit terms
    bin_len10 = 1024 // n
    lo = (16 << 2) // bin_len10       # 16..235 video range, 10-bit
    hi = (235 << 2) // bin_len10
    # extend to any occupied out-of-range bins (m_exceedSTD)
    occupied = np.nonzero(hist > 0)[0]
    if occupied.size:
        lo = min(lo, int(occupied[0]))
        hi = max(hi, int(occupied[-1]))

    # hard disable guards (preanalyzer:876-946)
    if not np.any(bv > 0):
        return None
    if hist[n - 1] > 0.0003 or hist[0] > 0.03:
        return None
    if (stats.ratio_std_u + stats.ratio_std_v) > 1.5 and hist[1] > 0.5:
        return None

    # skip-case: concentrated extreme-bin content (derive...SDR:594-604)
    order = np.argsort(-bv, kind="stable")
    cdf = np.cumsum(hist[order])
    sv = bv[order]

    def perc_below(thr):
        k = 0
        for b in range(n - 1):
            if sv[b] > thr:
                k = b + 1
        return float(cdf[k])

    p1, p2, p3 = perc_below(3.4), perc_below(2.8), perc_below(2.5)
    if (hist[0] + hist[n - 1]) > 0.0001 and hist[n - 2] < 0.001:
        if p3 > 0.8 and p2 > 0.4 and bv[n - 2] > 4.8:
            return None
        if p3 < 0.1 and p1 < 0.05 and bv[n - 2] < 4.0:
            return None

    # budget selection (updateCtrl=1 branch, derive...SDR:687-753)
    max_cw = 952
    is_low = (pic_size > 5184000 or bv[1] > 4.0
              or (stats.mean_bin_var > 3.1 and stats.weight_norm > 0.0))
    if is_low:
        if hist[n - 2] > 0.05:
            max_cw = 812
        elif p2 < 0.8 and p3 == 1.0:
            max_cw = 896
        elif p2 < 0.1:
            max_cw = 1022
    if hist[n - 2] < 0.001 and hist[1] > 0.05 and bv[1] > 3.0:
        max_cw = 784

    span = hi - lo + 1
    base = np.zeros(n, dtype=np.int64)
    base[lo:hi + 1] = int(round(max_cw / span))
    cw = _perturb(hist, stats.norm_var, base)
    cw[:lo] = 0
    cw[hi + 1:] = 0
    cw = np.maximum(cw, 0)
    cw = _reduce(cw, lo, hi, 1024)
    if int(cw.sum()) <= 0:
        return None
    return cw


def adjust_pivots(cw10: np.ndarray, bitdepth: int) -> np.ndarray:
    """Convert 10-bit codewords to bitdepth units and enforce the
    32-segment pivot constraint (adjust_lmcs_pivot, reshape.c:1178): each
    mapped pivot must start a new (1 << (bd-5))-sample segment."""
    bd_shift = bitdepth - 10
    if bd_shift > 0:
        cw = cw10 * (1 << bd_shift)
    elif bd_shift < 0:
        cw = cw10 // (1 << (-bd_shift))
    else:
        cw = cw10.copy()
    cw = cw.astype(np.int64)
    n = PIC_CODE_CW_BINS
    org_cw = (1 << bitdepth) // n
    log2_seg = bitdepth - 5
    nz = np.nonzero(cw)[0]
    if nz.size == 0:
        return cw
    min_bin, max_bin = int(nz[0]), int(nz[-1])
    piv = np.zeros(n + 1, dtype=np.int64)
    piv[1:] = np.cumsum(cw)
    seg_max = int(piv[max_bin + 1]) >> log2_seg
    i = min_bin
    while i <= max_bin:
        piv[i + 1] = piv[i] + cw[i]
        cur = int(piv[i]) >> log2_seg
        nxt = int(piv[i + 1]) >> log2_seg
        if cur == nxt and int(piv[i]) != (cur << log2_seg):
            if cur == seg_max:
                piv[i] = piv[max_bin + 1]
                for j in range(i, max_bin + 1):
                    piv[j + 1] = piv[i]
                    cw[j] = 0
                cw[i - 1] = piv[i] - piv[i - 1]
                break
            adj = ((cur + 1) << log2_seg) - int(piv[i + 1])
            piv[i + 1] += adj
            cw[i] += adj
            for j in range(i + 1, max_bin + 1):
                floor_cw = org_cw >> 3
                if cw[j] < adj + floor_cw:
                    adj -= int(cw[j]) - floor_cw
                    cw[j] = floor_cw
                else:
                    cw[j] -= adj
                    adj = 0
                if adj == 0:
                    break
        i += 1
    return cw


# --- normative PWL construction (shared with the decoder) -------------------

@dataclass
class LmcsLuts:
    bin_cw: np.ndarray          # [16] codewords, bitdepth units
    input_pivot: np.ndarray     # [17]
    pivot: np.ndarray           # [17] mapped pivots
    fwd_scale: np.ndarray       # [16] FP_PREC fixed point
    inv_scale: np.ndarray       # [16]
    chroma_scale: np.ndarray    # [16] CSCALE_FP_PREC fixed point
    fwd_lut: np.ndarray         # [1<<bd]
    inv_lut: np.ndarray         # [1<<bd]
    min_bin: int
    max_bin: int
    crs_offset: int
    bitdepth: int

    def fwd(self, plane: np.ndarray) -> np.ndarray:
        return self.fwd_lut[plane]

    def inv(self, plane: np.ndarray) -> np.ndarray:
        return self.inv_lut[plane]

    def chroma_adj_from_avg(self, avg_luma: int) -> int:
        """Chroma residual scale for a mapped-domain luma neighbor
        average (calculate_lmcs_chroma_adj, reshape.c:1441)."""
        idx = self.min_bin
        while idx <= self.max_bin and avg_luma >= int(self.pivot[idx + 1]):
            idx += 1
        idx = min(idx, PIC_CODE_CW_BINS - 1)
        return int(self.chroma_scale[idx])


def build_luts(bin_cw: np.ndarray, bitdepth: int, crs_offset: int = 0
               ) -> LmcsLuts:
    """Integer-exact PWL LUT construction from per-bin codewords in
    bitdepth units (uvg_construct_reshaper_lmcs, reshape.c:1257; VVC
    8.8.2 LmcsPivot/ScaleCoeff/InvScaleCoeff/ChromaScaleCoeff)."""
    n = PIC_CODE_CW_BINS
    lut_size = 1 << bitdepth
    org_cw = lut_size // n
    log2_org = org_cw.bit_length() - 1
    cw = bin_cw.astype(np.int64)
    nz = np.nonzero(cw)[0]
    min_bin = int(nz[0]) if nz.size else 0
    max_bin = int(nz[-1]) if nz.size else n - 1

    input_pivot = org_cw * np.arange(n + 1, dtype=np.int64)
    pivot = np.zeros(n + 1, dtype=np.int64)
    pivot[1:] = np.cumsum(cw)
    fwd_scale = (cw * (1 << FP_PREC) + (1 << (log2_org - 1))) >> log2_org
    inv_scale = np.where(cw > 0, (org_cw << FP_PREC) // np.maximum(cw, 1), 0)
    chroma_scale = np.where(
        cw > 0,
        (org_cw << CSCALE_FP_PREC) // np.maximum(cw + crs_offset, 1),
        1 << CSCALE_FP_PREC)

    samples = np.arange(lut_size, dtype=np.int64)
    idx = samples >> log2_org
    fwd = pivot[idx] + ((fwd_scale[idx] * (samples - input_pivot[idx])
                         + (1 << (FP_PREC - 1))) >> FP_PREC)
    fwd_lut = np.clip(fwd, 0, lut_size - 1).astype(np.int32)

    # inverse index: first bin whose upper mapped pivot exceeds the sample
    # (get_pwl_idx_inv, reshape.c:1247)
    idx_inv = np.searchsorted(pivot[min_bin + 1:max_bin + 2], samples,
                              side="right") + min_bin
    idx_inv = np.minimum(idx_inv, n - 1)
    inv = input_pivot[idx_inv] + (
        (inv_scale[idx_inv] * (samples - pivot[idx_inv])
         + (1 << (FP_PREC - 1))) >> FP_PREC)
    inv_lut = np.clip(inv, 0, lut_size - 1).astype(np.int32)

    return LmcsLuts(cw, input_pivot, pivot, fwd_scale, inv_scale,
                    chroma_scale, fwd_lut, inv_lut, min_bin, max_bin,
                    crs_offset, bitdepth)


def derive_frame_luts(y: np.ndarray, u: np.ndarray | None,
                      v: np.ndarray | None, bitdepth: int,
                      base_qp: int) -> LmcsLuts | None:
    """Encoder entry: preanalysis -> allocation -> pivot adjustment ->
    LUTs, or None when LMCS stays off for this model period."""
    stats = seq_stats(y, u, v, bitdepth)
    cw10 = allocate_codewords(stats, bitdepth, base_qp,
                              pic_size=y.size)
    if cw10 is None:
        return None
    cw = adjust_pivots(cw10, bitdepth)
    if int(cw.sum()) <= 0 or int(cw.sum()) >= (1 << bitdepth):
        return None
    return build_luts(cw, bitdepth, crs_offset=0)


# --- chroma residual scaling -------------------------------------------------

def chroma_adj_for_ctu(luts: LmcsLuts, rec_mapped_y: np.ndarray,
                       x: int, y: int, pic_w: int, pic_h: int,
                       lcu: int = 64) -> int:
    """Chroma scale for the CTU at (x, y) from the average of up to 64
    left + 64 above mapped-domain reconstructed luma neighbors
    (uvg_calculate_lmcs_chroma_adj_vpdu_nei, reshape.c:1452). pic_w/pic_h
    are the TRUE picture dims (the recon plane may be LCU-padded;
    out-of-picture neighbor indices repeat the last in-picture sample)."""
    x0 = (x // lcu) * lcu
    y0 = (y // lcu) * lcu
    n_nei = min(64, lcu)
    log_n = n_nei.bit_length() - 1
    total = 0
    parts = 0
    if x0 > 0:
        ys = y0 + np.arange(n_nei)
        ys = np.where(ys >= pic_h, pic_h - 1, ys)
        total += int(rec_mapped_y[ys, x0 - 1].sum())
        parts += 1
    if y0 > 0:
        xs = x0 + np.arange(n_nei)
        xs = np.where(xs >= pic_w, pic_w - 1, xs)
        total += int(rec_mapped_y[y0 - 1, xs].sum())
        parts += 1
    if parts == 1:
        avg = (total + (1 << (log_n - 1))) >> log_n
    elif parts == 2:
        avg = (total + (1 << log_n)) >> (log_n + 1)
    else:
        avg = 1 << (luts.bitdepth - 1)
    return luts.chroma_adj_from_avg(avg)


class LmcsFrameCtx:
    """Per-frame LMCS state shared by encoder and decoder: the LUTs, the
    chroma-adj enable, and the per-LCU chroma scale cache computed lazily
    from the (live, mapped-domain) luma recon plane — the analog of the
    reference's lmcs_avg/lmcs_avg_processed arrays."""

    def __init__(self, luts: LmcsLuts, rec_y_mapped: np.ndarray,
                 pic_w: int, pic_h: int, chroma_adj: bool = True):
        self.luts = luts
        self.rec_y = rec_y_mapped
        self.pic_w = pic_w
        self.pic_h = pic_h
        self.chroma_adj = chroma_adj
        self._cache: dict = {}

    def adj(self, x: int, y: int) -> int:
        """Chroma scale for the LCU containing luma position (x, y)."""
        key = (x // 64, y // 64)
        a = self._cache.get(key)
        if a is None:
            a = chroma_adj_for_ctu(self.luts, self.rec_y, x, y,
                                   self.pic_w, self.pic_h)
            self._cache[key] = a
        return a


def scale_chroma_residual_fwd(res: np.ndarray, adj: int,
                              bitdepth: int) -> np.ndarray:
    """Encoder-side forward chroma residual scaling
    (strategies/generic/quant-generic.c:482-491): divide by the scale in
    CSCALE_FP_PREC fixed point."""
    max_abs = (1 << bitdepth) - 1
    a = np.abs(res.astype(np.int64))
    scaled = ((a << CSCALE_FP_PREC) + (adj >> 1)) // adj
    return np.clip(np.sign(res) * scaled, -max_abs, max_abs)


def scale_chroma_residual_inv(res: np.ndarray, adj: int,
                              bitdepth: int) -> np.ndarray:
    """Decoder-side inverse chroma residual scaling
    (strategies/generic/quant-generic.c:572-581): clip the coded residual
    to the bitdepth range, then multiply by the scale."""
    max_abs = (1 << bitdepth) - 1
    r = np.clip(res.astype(np.int64), -max_abs - 1, max_abs)
    a = np.abs(r)
    val = np.sign(r) * ((a * adj + (1 << (CSCALE_FP_PREC - 1)))
                        >> CSCALE_FP_PREC)
    return np.clip(val, -32768, 32767)

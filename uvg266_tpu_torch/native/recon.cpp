// Native reconstruction engine: intra prediction + DCT2 + quant round-trip.
//
// The sequential closed-loop phase of the encoder (intra prediction needs
// reconstructed neighbors) runs as native host code, mirroring the verified
// Python implementations which remain the golden models:
// - reference build: ops/intra.py build_reference (reference parity:
//   intra.c uvg_intra_build_reference_any:756, cu.c:516)
// - prediction: ops/intra.py predict_intra (strategies/generic/
//   intra-generic.c:55,300,410)
// - transforms: ops/transforms.py (dct-generic.c mts_dct/mts_idct)
// - quant: ops/quant.py (quant-generic.c:51,618)
// Bit-exactness vs the Python path is asserted in tests.

#include <cstdint>
#include <cstring>
#include <vector>

#include "recon_shared.h"

namespace rcn {

constexpr int LCU = 64;

const int32_t MODEDISP2SAMPLEDISP[32] = {
    0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32, 35, 39, 45,
    51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512, 1024};
const int32_t MODEDISP2INVSAMPLEDISP[32] = {
    0, 16384, 8192, 5461, 4096, 2731, 2048, 1638, 1365, 1170, 1024, 910, 819,
    712, 630, 565, 512, 468, 420, 364, 321, 287, 256, 224, 191, 161, 128, 96,
    64, 48, 32, 16};
const int32_t PRE_SCALE[32] = {
    8, 7, 6, 5, 5, 4, 4, 4, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1,
    1, 0, 0, 0, -1, -1, -2, -3};
const int32_t CUBIC_FILTER[32][4] = {
    {0, 64, 0, 0}, {-1, 63, 2, 0}, {-2, 62, 4, 0}, {-2, 60, 7, -1},
    {-2, 58, 10, -2}, {-3, 57, 12, -2}, {-4, 56, 14, -2}, {-4, 55, 15, -2},
    {-4, 54, 16, -2}, {-5, 53, 18, -2}, {-6, 52, 20, -2}, {-6, 49, 24, -3},
    {-6, 46, 28, -4}, {-5, 44, 29, -4}, {-4, 42, 30, -4}, {-4, 39, 33, -4},
    {-4, 36, 36, -4}, {-4, 33, 39, -4}, {-4, 30, 42, -4}, {-4, 29, 44, -5},
    {-4, 28, 46, -6}, {-3, 24, 49, -6}, {-2, 20, 52, -6}, {-2, 18, 53, -5},
    {-2, 16, 54, -4}, {-2, 15, 55, -4}, {-2, 14, 56, -4}, {-2, 12, 57, -3},
    {-2, 10, 58, -2}, {-1, 7, 60, -2}, {0, 4, 62, -2}, {0, 2, 63, -1}};
const int HOR_VER_DIST_THRES[8] = {24, 24, 24, 14, 2, 0, 0, 0};

const int32_t QUANT_SCALES[2][6] = {
    {26214, 23302, 20560, 18396, 16384, 14564},
    {18396, 16384, 14564, 13107, 11651, 10280}};
const int32_t INV_QUANT_SCALES[2][6] = {
    {40, 45, 51, 57, 64, 72}, {57, 64, 72, 80, 90, 102}};

// DCT2 matrices set from Python (tr_matrices), indexed by log2(size)-2,
// sizes 4-64: rd_roundtrip takes 64x64 prediction blocks (the host screen
// and host-ME rd_cost_pred), a full 64-point DCT2 with no zero-out
int16_t g_dct2[5][64 * 64];
// grouped diagonal scan tables indexed by [log2(w)-2][log2(h)-2]
// (rectangular TUs from BT/TT splits scan differently from squares)
int32_t g_scan[4][4][32 * 32];

inline int ilog2(int v) {
    int l = 0;
    while (v > 1) { v >>= 1; l++; }
    return l;
}

void Refs::make_filtered(int w, int h) {
    if (filtered_done) return;
    filtered_done = true;
    int rw = 2 * w + 1, rh = 2 * h + 1;
    memcpy(ftop, top, sizeof(top));
    memcpy(fleft, left, sizeof(left));
    fleft[0] = (left[1] + 2 * left[0] + top[1] + 2) >> 2;
    ftop[0] = fleft[0];
    for (int i = 1; i < rh - 1; ++i)
        fleft[i] = (left[i - 1] + 2 * left[i] + left[i + 1] + 2) >> 2;
    for (int i = 1; i < rw - 1; ++i)
        ftop[i] = (top[i - 1] + 2 * top[i] + top[i + 1] + 2) >> 2;
    fleft[rh - 1] = left[rh - 1];
    ftop[rw - 1] = top[rw - 1];
}

// cu.c uvg_count_available_edge_cus analogue over the 4x4 coded mask
int count_avail_units(int x, int y, int w, int h, const uint8_t* mask,
                      int mask_w, int mask_h, bool left_edge) {
    int local_x = x % LCU, local_y = y % LCU;
    if ((left_edge && x == 0) || (!left_edge && y == 0)) return 0;
    if (left_edge && local_x == 0) return (LCU - local_y) / 4;
    if (!left_edge && local_y == 0) return w / 2;
    if (left_edge) {
        int amount = h & ~3;
        while (local_y + amount < LCU && (y + amount) / 4 < mask_h
               && mask[((y + amount) / 4) * mask_w + (x - 4) / 4])
            amount += 4;
        return (amount > h ? amount : h) / 4;
    }
    int amount = w & ~3;
    while (local_x + amount < LCU && (x + amount) / 4 < mask_w
           && mask[((y - 4) / 4) * mask_w + (x + amount) / 4])
        amount += 4;
    return (amount > w ? amount : w) / 4;
}

// ops/intra.py build_reference
void build_reference(const int32_t* plane, int stride,
                     const uint8_t* mask, int mask_w, int mask_h,
                     int x, int y, int w, int h, int pic_w, int pic_h,
                     int bd, bool is_chroma, Refs* refs, bool wpp) {
    const int dc_val = 1 << (bd - 1);
    for (int i = 0; i < REF_MAX; ++i) refs->top[i] = refs->left[i] = dc_val;
    refs->filtered_done = false;
    int log2_w = ilog2(w), log2_h = ilog2(h);
    int sc = is_chroma ? 1 : 0;
    int lx = x << sc, ly = y << sc, lw = w << sc, lh = h << sc;
    int lcu_local = LCU >> sc;

    // left
    {
        int s = log2_h - log2_w > 0 ? log2_h - log2_w : 0;
        int ext = (h << s) + 2;
        int total_h = h * 2 + ext;
        if (total_h > REF_MAX - 1) total_h = REF_MAX - 1;
        if (lx > 0) {
            int navail;
            if (x % lcu_local == 0)
                navail = (LCU - (ly % LCU)) / 4;
            else
                navail = count_avail_units(lx, ly, lw, lh, mask, mask_w,
                                           mask_h, true);
            int px = navail * (is_chroma ? 2 : 4);
            if (px > h + h) px = h + h;
            if (px > pic_h - y) px = pic_h - y;
            if (px < 1) px = 1;
            for (int i = 0; i < px; ++i)
                refs->left[1 + i] = plane[(y + i) * stride + x - 1];
            int32_t fill = plane[(y + px - 1) * stride + x - 1];
            for (int i = px; i < total_h; ++i) refs->left[1 + i] = fill;
        } else {
            int32_t nearest = (ly > 0) ? plane[(y - 1) * stride + x] : dc_val;
            for (int i = 0; i < total_h; ++i) refs->left[1 + i] = nearest;
        }
    }
    // top-left
    if (lx > 0 && ly > 0) {
        refs->left[0] = plane[(y - 1) * stride + x - 1];
        refs->top[0] = refs->left[0];
    } else {
        refs->left[0] = refs->left[1];
        refs->top[0] = refs->left[1];
    }
    // top
    {
        int s = log2_w - log2_h > 0 ? log2_w - log2_h : 0;
        int ext = (w << s) + 2;
        int total_w = w * 2 + ext;
        if (total_w > REF_MAX - 1) total_w = REF_MAX - 1;
        if (ly > 0) {
            int navail;
            if (y % lcu_local == 0)
                navail = lw / 2;
            else
                navail = count_avail_units(lx, ly, lw, lh, mask, mask_w,
                                           mask_h, false);
            int px = navail * (is_chroma ? 2 : 4);
            if (px > w + w) px = w + w;
            if (px > pic_w - x) px = pic_w - x;
            // entropy sync (WPP): above-right CTU normatively unavailable
            // (VVC 6.4.4; intra.c:1318) for CTU-top-row blocks
            if (wpp && y % lcu_local == 0)
                if (px > lcu_local - (x % lcu_local))
                    px = lcu_local - (x % lcu_local);
            if (px < 1) px = 1;
            for (int i = 0; i < px; ++i)
                refs->top[1 + i] = plane[(y - 1) * stride + x + i];
            int32_t fill = plane[(y - 1) * stride + x + px - 1];
            for (int i = px; i < total_w; ++i) refs->top[1 + i] = fill;
        } else {
            int32_t nearest = (lx > 0) ? plane[y * stride + x - 1] : dc_val;
            for (int i = 0; i < total_w; ++i) refs->top[1 + i] = nearest;
        }
    }
}

int wide_angle(int mode, int log2_w, int log2_h) {
    int pm = mode;
    if (log2_w != log2_h && mode > 1 && mode <= 66) {
        static const int mode_shift[6] = {0, 6, 10, 12, 14, 15};
        int delta = log2_w - log2_h;
        if (delta < 0) delta = -delta;
        if (log2_w > log2_h && mode < 2 + mode_shift[delta]) pm += 65;
        else if (log2_h > log2_w && mode > 66 - mode_shift[delta]) pm -= 65;
    }
    return pm;
}

// ops/intra.py predict_intra (planar/DC/angular + PDPC + smoothing)
void predict_intra(int mode, int w, int h, Refs* refs, int bd, bool is_chroma,
                   int32_t* out /* h*w */) {
    const int log2_w = ilog2(w), log2_h = ilog2(h);
    const int max_pix = (1 << bd) - 1;
    const int pred_mode = wide_angle(mode, log2_w, log2_h);

    const int32_t* top = refs->top;
    const int32_t* left = refs->left;
    // smoothing selection
    if (is_chroma || mode == 1 || (w == 4 && h == 4)) {
    } else if (mode == 0) {
        if (w * h > 32) {
            refs->make_filtered(w, h);
            top = refs->ftop;
            left = refs->fleft;
        }
    } else {
        int thres = HOR_VER_DIST_THRES[(log2_w + log2_h) >> 1];
        int d50 = pred_mode - 50; if (d50 < 0) d50 = -d50;
        int d18 = pred_mode - 18; if (d18 < 0) d18 = -d18;
        int dist = d50 < d18 ? d50 : d18;
        if (dist > thres) {
            int md = pred_mode >= 34 ? pred_mode - 50 : 18 - pred_mode;
            int ad = md < 0 ? -md : md;
            int sd = MODEDISP2SAMPLEDISP[ad];
            if ((sd & 0x1F) == 0) {
                refs->make_filtered(w, h);
                top = refs->ftop;
                left = refs->fleft;
            }
        }
    }

    if (mode == 0) {
        // planar
        int32_t tr = top[w + 1], bl = left[h + 1];
        for (int yy = 0; yy < h; ++yy) {
            for (int xx = 0; xx < w; ++xx) {
                int64_t hor = ((int64_t)left[1 + yy] << log2_w)
                              + (int64_t)(tr - left[1 + yy]) * (xx + 1);
                int64_t ver = ((int64_t)top[1 + xx] << log2_h)
                              + (int64_t)(bl - top[1 + xx]) * (yy + 1);
                int64_t v = ((hor << log2_h) + (ver << log2_w)
                             + ((int64_t)1 << (log2_w + log2_h)))
                            >> (1 + log2_w + log2_h);
                out[yy * w + xx] = (int32_t)v;
            }
        }
    } else if (mode == 1) {
        int64_t s = 0;
        if (w >= h) for (int i = 0; i < w; ++i) s += top[1 + i];
        if (w <= h) for (int i = 0; i < h; ++i) s += left[1 + i];
        int denom = (w == h) ? (w << 1) : (w > h ? w : h);
        int shift = ilog2(denom);
        int32_t dc = (int32_t)((s + (denom >> 1)) >> shift);
        for (int i = 0; i < w * h; ++i) out[i] = dc;
    } else {
        // angular
        bool vertical = pred_mode >= 34;
        int mode_disp = vertical ? pred_mode - 50 : -(pred_mode - 18);
        int ad = mode_disp < 0 ? -mode_disp : mode_disp;
        int sample_disp = (mode_disp < 0 ? -1 : 1) * MODEDISP2SAMPLEDISP[ad];
        int side_log2 = vertical ? log2_h : log2_w;
        int scale = side_log2 - PRE_SCALE[ad];
        if (scale > 2) scale = 2;
        int ww = vertical ? w : h, hh = vertical ? h : w;
        const int32_t* ref_main_src = vertical ? top : left;
        const int32_t* ref_side = vertical ? left : top;

        std::vector<int32_t> main_buf;
        const int32_t* ref_main;
        int base = 0;
        if (sample_disp < 0) {
            base = hh;
            main_buf.assign(base + ww + hh + 8, 0);
            for (int i = 0; i < ww + 2; ++i)
                main_buf[base + i] = ref_main_src[i];
            int inv = MODEDISP2INVSAMPLEDISP[ad];
            for (int i = -hh; i < 0; ++i) {
                int k = (-i * inv + 256) >> 9;
                main_buf[base + i] = ref_side[k < hh ? k : hh];
            }
            ref_main = main_buf.data();
        } else {
            ref_main = ref_main_src;
        }

        std::vector<int32_t> work(hh * ww);
        if (sample_disp != 0) {
            bool use_cubic = true;
            {
                int thres = HOR_VER_DIST_THRES[(log2_w + log2_h) >> 1];
                int d50 = pred_mode - 50; if (d50 < 0) d50 = -d50;
                int d18 = pred_mode - 18; if (d18 < 0) d18 = -d18;
                int dist = d50 < d18 ? d50 : d18;
                int asd = sample_disp < 0 ? -sample_disp : sample_disp;
                if (dist > thres && (asd & 0x1F) != 0) use_cubic = false;
            }
            bool frac = ((sample_disp < 0 ? -sample_disp : sample_disp) & 0x1F) != 0;
            for (int yy = 0; yy < hh; ++yy) {
                int delta_pos = sample_disp * (yy + 1);
                int delta_int = delta_pos >> 5;
                int delta_fract = delta_pos & 31;
                if (frac) {
                    if (!is_chroma) {
                        const int32_t* f;
                        int32_t gauss[4];
                        if (use_cubic) {
                            f = CUBIC_FILTER[delta_fract];
                        } else {
                            gauss[0] = 16 - (delta_fract >> 1);
                            gauss[1] = 32 - (delta_fract >> 1);
                            gauss[2] = 16 + (delta_fract >> 1);
                            gauss[3] = delta_fract >> 1;
                            f = gauss;
                        }
                        for (int xx = 0; xx < ww; ++xx) {
                            int idx = base + delta_int + xx;
                            int32_t v = (f[0] * ref_main[idx]
                                         + f[1] * ref_main[idx + 1]
                                         + f[2] * ref_main[idx + 2]
                                         + f[3] * ref_main[idx + 3] + 32) >> 6;
                            work[yy * ww + xx] =
                                v < 0 ? 0 : (v > max_pix ? max_pix : v);
                        }
                    } else {
                        for (int xx = 0; xx < ww; ++xx) {
                            int idx = base + delta_int + xx;
                            int32_t r1 = ref_main[idx + 1];
                            int32_t r2 = ref_main[idx + 2];
                            work[yy * ww + xx] =
                                r1 + ((delta_fract * (r2 - r1) + 16) >> 5);
                        }
                    }
                } else {
                    for (int xx = 0; xx < ww; ++xx)
                        work[yy * ww + xx] = ref_main[base + delta_int + xx + 1];
                }
                // gradient PDPC
                bool pdpc = (w >= 4 && h >= 4);
                if (pred_mode > 1 && pred_mode < 67) {
                    if (mode_disp < 0) pdpc = false;
                    else if (mode_disp > 0) pdpc = pdpc && scale >= 0;
                }
                if (pdpc) {
                    int inv = MODEDISP2INVSAMPLEDISP[ad];
                    int inv_angle_sum = 256;
                    int lim = 3 << scale;
                    if (lim > ww) lim = ww;
                    for (int xx = 0; xx < lim; ++xx) {
                        inv_angle_sum += inv;
                        int wl = 32 >> ((2 * xx) >> scale);
                        int k = yy + (inv_angle_sum >> 9) + 1;
                        int32_t lp = ref_side[k < REF_MAX ? k : REF_MAX - 1];
                        int32_t* p = &work[yy * ww + xx];
                        *p = *p + ((wl * (lp - *p) + 32) >> 6);
                    }
                }
            }
        } else {
            // pure hor/ver
            for (int yy = 0; yy < hh; ++yy)
                for (int xx = 0; xx < ww; ++xx)
                    work[yy * ww + xx] = ref_main[xx + 1];
            if (w >= 4 && h >= 4) {
                int sc2 = (log2_w + log2_h - 2) >> 2;
                int32_t tl = ref_main[0];
                int lim = 3 << sc2;
                if (lim > ww) lim = ww;
                for (int yy = 0; yy < hh; ++yy) {
                    int32_t lp = ref_side[1 + yy];
                    for (int xx = 0; xx < lim; ++xx) {
                        int wl = 32 >> ((2 * xx) >> sc2);
                        int32_t v = work[yy * ww + xx]
                                    + ((wl * (lp - tl) + 32) >> 6);
                        work[yy * ww + xx] =
                            v < 0 ? 0 : (v > max_pix ? max_pix : v);
                    }
                }
            }
        }
        if (vertical) {
            memcpy(out, work.data(), sizeof(int32_t) * w * h);
        } else {
            for (int yy = 0; yy < h; ++yy)
                for (int xx = 0; xx < w; ++xx)
                    out[yy * w + xx] = work[xx * ww + yy];
        }
        for (int i = 0; i < w * h; ++i) {
            int32_t v = out[i];
            out[i] = v < 0 ? 0 : (v > max_pix ? max_pix : v);
        }
        return;
    }

    // planar/DC PDPC
    if (w >= 4 && h >= 4) {
        int sc = (log2_w + log2_h - 2) >> 2;
        for (int yy = 0; yy < h; ++yy) {
            int wt = 32 >> ((yy * 2) >> sc < 31 ? (yy * 2) >> sc : 31);
            for (int xx = 0; xx < w; ++xx) {
                int wl = 32 >> ((xx * 2) >> sc < 31 ? (xx * 2) >> sc : 31);
                int32_t p = out[yy * w + xx];
                out[yy * w + xx] = p + ((wl * (left[1 + yy] - p)
                                        + wt * (top[1 + xx] - p) + 32) >> 6);
            }
        }
    }
    for (int i = 0; i < w * h; ++i) {
        int32_t v = out[i];
        out[i] = v < 0 ? 0 : (v > max_pix ? max_pix : v);
    }
}

// 2-D DCT2 fwd/inv + quant round-trip (ops/transforms.py, ops/quant.py)
// returns cbf; coeff_out gets quantized levels, rec gets reconstruction
void sign_hide(int32_t* qf, const int32_t* cf, const int64_t* du,
               int w, int h) {
    // quant-generic.c:151-229 over 16-coefficient scan sets
    const int32_t* scan = g_scan[ilog2(w) - 2][ilog2(h) - 2];
    int last_cg = -1;
    for (int subset = (w * h - 1) >> 4; subset >= 0; --subset) {
        int subpos = subset << 4;
        int first_nz = -1, last_nz = -1;
        for (int n = 15; n >= 0; --n)
            if (qf[scan[subpos + n]]) { last_nz = n; break; }
        for (int n = 0; n < 16; ++n)
            if (qf[scan[subpos + n]]) { first_nz = n; break; }
        if (last_nz < 0) {
            if (last_cg == 1) last_cg = 0;
            continue;
        }
        int64_t abssum = 0;
        for (int n = first_nz; n <= last_nz; ++n)
            abssum += qf[scan[subpos + n]];
        if (last_cg == -1) last_cg = 1;
        if (last_nz - first_nz >= 4) {
            int signbit = qf[scan[subpos + first_nz]] > 0 ? 0 : 1;
            if (signbit != (abssum & 1)) {
                int64_t min_cost = 0x7FFFFFFF;
                int min_pos = -1;
                int final_change = 0;
                int start = last_cg == 1 ? last_nz : 15;
                for (int n = start; n >= 0; --n) {
                    int blk = scan[subpos + n];
                    int64_t cur_cost;
                    int cur_change = 0;
                    if (qf[blk] != 0) {
                        if (du[blk] > 0) { cur_cost = -du[blk]; cur_change = 1; }
                        else if (n == first_nz
                                 && (qf[blk] == 1 || qf[blk] == -1)) {
                            cur_cost = 0x7FFFFFFF;
                        } else { cur_cost = du[blk]; cur_change = -1; }
                    } else if (n < first_nz
                               && ((cf[blk] >= 0 ? 0 : 1) != signbit)) {
                        cur_cost = 0x7FFFFFFF;
                    } else {
                        cur_cost = -du[blk];
                        cur_change = 1;
                    }
                    if (cur_cost < min_cost) {
                        min_cost = cur_cost;
                        final_change = cur_change;
                        min_pos = blk;
                    }
                }
                if (qf[min_pos] == 32767 || qf[min_pos] == -32768)
                    final_change = -1;
                if (cf[min_pos] >= 0) qf[min_pos] += final_change;
                else qf[min_pos] -= final_change;
            }
        }
        if (last_cg == 1) last_cg = 0;
    }
}

int transform_quant_recon(const int32_t* src, const int32_t* pred,
                          int w, int h, int qp, int bd, bool is_intra_slice,
                          bool signhide, int32_t* coeff_out, int32_t* rec,
                          double rdoq_lam) {
    const int log2_w = ilog2(w), log2_h = ilog2(h);
    const int16_t* mh = g_dct2[log2_w - 2];
    const int16_t* mv = g_dct2[log2_h - 2];
    const int s1 = log2_w - 1 + bd - 8;
    const int s2 = log2_h - 1 + 7;
    // intermediates fit int32: |resid| <= 2^bd, |tmp| <= 2^15, matrix
    // entries <= 2^7, dims <= 32 -> accumulators stay under 2^27; ikj
    // loop order keeps the inner loop contiguous so -O3 vectorizes it
    std::vector<int32_t> resid(w * h), tmp(w * h);
    for (int i = 0; i < w * h; ++i) resid[i] = src[i] - pred[i];

    // tmp = rshift(X @ Mh^T): tmp[y][k] = sum_x X[y][x] * Mh[k][x]
    for (int y = 0; y < h; ++y)
        for (int k = 0; k < w; ++k) {
            const int16_t* mrow = mh + k * w;
            const int32_t* rrow = resid.data() + y * w;
            int32_t s = 0;
            for (int x = 0; x < w; ++x)
                s += rrow[x] * (int32_t)mrow[x];
            tmp[y * w + k] = (int16_t)((s + (1 << (s1 - 1))) >> s1);
        }
    // coef = rshift(Mv @ tmp): accumulate rows of tmp scaled by Mv[k][y]
    std::vector<int32_t> coef(w * h);
    std::vector<int32_t> acc32(w);
    for (int k = 0; k < h; ++k) {
        for (int x = 0; x < w; ++x) acc32[x] = 0;
        const int16_t* mrow = mv + k * h;
        for (int y = 0; y < h; ++y) {
            const int32_t m = mrow[y];
            const int32_t* trow = tmp.data() + y * w;
            for (int x = 0; x < w; ++x) acc32[x] += m * trow[x];
        }
        for (int x = 0; x < w; ++x)
            coef[k * w + x] = (int16_t)((acc32[x] + (1 << (s2 - 1))) >> s2);
    }

    // quant
    const bool needs_sqrt2 = ((log2_w + log2_h) & 1) != 0;
    const int tshift = 15 - bd - ((log2_w + log2_h) >> 1) - (needs_sqrt2 ? 1 : 0);
    const int q_bits = 14 + qp / 6 + tshift;
    const int64_t add = (int64_t)(is_intra_slice ? 171 : 85) << (q_bits - 9);
    const int64_t scale = QUANT_SCALES[needs_sqrt2 ? 1 : 0][qp % 6];
    bool any = false;
    int64_t ac_sum = 0;
    std::vector<int64_t> delta_u(signhide ? w * h : 0);
    if (rdoq_lam > 0.0)
        rdoq_levels(coef.data(), w, h, qp, bd, rdoq_lam, coeff_out);
    for (int i = 0; i < w * h; ++i) {
        int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
        int32_t level;
        if (rdoq_lam > 0.0) {
            level = coeff_out[i] < 0 ? -coeff_out[i] : coeff_out[i];
        } else {
            level = (int32_t)((a * scale + add) >> q_bits);
            if (level > 32767) level = 32767;
            coeff_out[i] = coef[i] < 0 ? -level : level;
        }
        any |= level != 0;
        ac_sum += level;
        if (signhide)
            delta_u[i] = (a * scale - ((int64_t)level << q_bits))
                         >> (q_bits - 8);
    }
    if (signhide && ac_sum >= 2) {
        sign_hide(coeff_out, coef.data(), delta_u.data(), w, h);
        any = false;
        for (int i = 0; i < w * h; ++i) any |= coeff_out[i] != 0;
    }
    if (!any) {
        memcpy(rec, pred, sizeof(int32_t) * w * h);
        return 0;
    }

    // dequant
    const int tshift_d = 15 - bd - ((log2_w + log2_h) >> 1);
    const int dq_shift = 20 - 14 - (tshift_d - (needs_sqrt2 ? 1 : 0));
    const int64_t iscale = (int64_t)INV_QUANT_SCALES[needs_sqrt2 ? 1 : 0][qp % 6]
                           << (qp / 6);
    std::vector<int32_t> dq(w * h);
    for (int i = 0; i < w * h; ++i) {
        int64_t c = ((int64_t)coeff_out[i] * iscale
                     + ((int64_t)1 << (dq_shift - 1))) >> dq_shift;
        dq[i] = c < -32768 ? -32768 : (c > 32767 ? 32767 : (int32_t)c);
    }

    // inverse: u = clip(rshift(Mv^T @ C, 7)); x = clip(rshift(u @ Mh, 20-bd))
    // same int32/ikj scheme; |dq| <= 2^15, |m| <= 2^7, dims <= 32
    const int si1 = 7, si2 = 20 - bd;
    for (int k = 0; k < h; ++k) {
        for (int x = 0; x < w; ++x) acc32[x] = 0;
        for (int y = 0; y < h; ++y) {
            const int32_t m = mv[y * h + k];
            const int32_t* drow = dq.data() + y * w;
            for (int x = 0; x < w; ++x) acc32[x] += m * drow[x];
        }
        for (int x = 0; x < w; ++x) {
            int32_t v = (acc32[x] + (1 << (si1 - 1))) >> si1;
            tmp[k * w + x] = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
        }
    }
    const int max_pix = (1 << bd) - 1;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) acc32[x] = 0;
        const int32_t* trow = tmp.data() + y * w;
        for (int k = 0; k < w; ++k) {
            const int32_t t = trow[k];
            const int16_t* mrow = mh + k * w;
            for (int x = 0; x < w; ++x) acc32[x] += t * (int32_t)mrow[x];
        }
        for (int x = 0; x < w; ++x) {
            int32_t v = (acc32[x] + (1 << (si2 - 1))) >> si2;
            v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
            int32_t r = pred[y * w + x] + v;
            rec[y * w + x] = r < 0 ? 0 : (r > max_pix ? max_pix : r);
        }
    }
    return 1;
}

// rd-cost roundtrip for one prediction: DCT2 -> quant -> bucket bits ->
// dequant -> IDCT2 -> SSD (the mirror of ops/rd_cost.py
// make_rd_cost_pred_fn; reference --fast-residual-cost,
// quant-generic.c:688). wts: 4 bucket weights. rec: w*h scratch.
void rd_roundtrip(const int32_t* src, const int32_t* pred, int w, int h,
                  int qp, int bd, bool is_intra_slice, const float* wts,
                  int64_t* out_ssd, double* out_bits, int32_t* rec) {
    const int log2_w = ilog2(w), log2_h = ilog2(h);
    const int16_t* mh = g_dct2[log2_w - 2];
    const int16_t* mv = g_dct2[log2_h - 2];
    const int s1 = log2_w - 1 + bd - 8;
    const int s2 = log2_h - 1 + 7;
    int32_t resid[64 * 64], tmp[64 * 64], coef[64 * 64];
    for (int i = 0; i < w * h; ++i) resid[i] = src[i] - pred[i];
    for (int y = 0; y < h; ++y)
        for (int k = 0; k < w; ++k) {
            const int16_t* mrow = mh + k * w;
            const int32_t* rrow = resid + y * w;
            int32_t s = 0;
            for (int x = 0; x < w; ++x) s += rrow[x] * (int32_t)mrow[x];
            tmp[y * w + k] = (int16_t)((s + (1 << (s1 - 1))) >> s1);
        }
    for (int k = 0; k < h; ++k)
        for (int x = 0; x < w; ++x) {
            int32_t s = 0;
            for (int y = 0; y < h; ++y)
                s += (int32_t)mv[k * h + y] * tmp[y * w + x];
            coef[k * w + x] = (int16_t)((s + (1 << (s2 - 1))) >> s2);
        }
    const bool needs_sqrt2 = ((log2_w + log2_h) & 1) != 0;
    const int tshift = 15 - bd - ((log2_w + log2_h) >> 1)
                       - (needs_sqrt2 ? 1 : 0);
    const int q_bits = 14 + qp / 6 + tshift;
    const int64_t add = (int64_t)(is_intra_slice ? 171 : 85)
                        << (q_bits - 9);
    const int64_t scale = QUANT_SCALES[needs_sqrt2 ? 1 : 0][qp % 6];
    const int tshift_d = 15 - bd - ((log2_w + log2_h) >> 1);
    const int dq_shift = 20 - 14 - (tshift_d - (needs_sqrt2 ? 1 : 0));
    const int64_t iscale =
        (int64_t)INV_QUANT_SCALES[needs_sqrt2 ? 1 : 0][qp % 6] << (qp / 6);
    double bits = 0.0;
    int32_t dq[64 * 64];
    for (int i = 0; i < w * h; ++i) {
        int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
        int64_t level = (a * scale + add) >> q_bits;
        if (level > 32767) level = 32767;
        bits += wts[level < 3 ? level : 3];
        int64_t sgn = coef[i] < 0 ? -1 : (coef[i] > 0 ? 1 : 0);
        int64_t d = (sgn * level * iscale + ((int64_t)1 << (dq_shift - 1)))
                    >> dq_shift;
        dq[i] = (int32_t)(d < -32768 ? -32768 : (d > 32767 ? 32767 : d));
    }
    const int si1 = 7, si2 = 20 - bd;
    const int max_pix = (1 << bd) - 1;
    for (int k = 0; k < h; ++k)
        for (int x = 0; x < w; ++x) {
            int32_t s = 0;
            for (int y = 0; y < h; ++y)
                s += (int32_t)mv[y * h + k] * dq[y * w + x];
            int32_t v = (s + (1 << (si1 - 1))) >> si1;
            tmp[k * w + x] = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
        }
    int64_t ssd = 0;
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            int32_t s = 0;
            for (int k = 0; k < w; ++k)
                s += tmp[y * w + k] * (int32_t)mh[k * w + x];
            int32_t v = (s + (1 << (si2 - 1))) >> si2;
            v = v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
            int32_t r = pred[y * w + x] + v;
            r = r < 0 ? 0 : (r > max_pix ? max_pix : r);
            rec[y * w + x] = r;
            int64_t d2 = src[y * w + x] - r;
            ssd += d2 * d2;
        }
    *out_ssd = ssd;
    *out_bits = bits;
}

// Closed-loop recon of one plain intra CU; per-leaf body shared with the
// whole-frame inter finalize (inter.cpp). Implicit transform split: CUs
// larger than the 32x32 max TU are coded as a raster grid of TUs;
// prediction is per TU from the running reconstruction (matches the
// Python TU loop in reconstruct_intra_cu). Per-TU cbf is bit-packed:
// bit t of cbf_out is TU t = ty_i * tn_x + tx_i.
void recon_intra_leaf(int32_t* rec_y, int32_t* rec_u, int32_t* rec_v,
                      const int32_t* src_y, const int32_t* src_u,
                      const int32_t* src_v, uint8_t* coded_mask,
                      int fw, int fh, int qp, int qp_c, int bd,
                      int signhide, int wpp,
                      int x, int y, int w, int h, int mode, int mode_c,
                      int32_t* coeff_y, int32_t* coeff_u, int32_t* coeff_v,
                      int32_t* cbf_out, double rdoq_lam) {
    const int mask_w = (fw + 3) / 4, mask_h = (fh + 3) / 4;
    const int cw_stride = fw >> 1;
    Refs refs;
    int32_t pred[64 * 64];
    int32_t rec[64 * 64];
    int32_t srcbuf[64 * 64];
    const bool has_chroma = rec_u != nullptr;
    const int kMaxTu = 32;
    const int tn_x = w > kMaxTu ? w / kMaxTu : 1;
    const int tn_y = h > kMaxTu ? h / kMaxTu : 1;
    const int tw = w < kMaxTu ? w : kMaxTu;
    const int th = h < kMaxTu ? h : kMaxTu;
    int64_t off_y = 0, off_c = 0;
    cbf_out[0] = cbf_out[1] = cbf_out[2] = 0;
    int t = 0;
    for (int ty_i = 0; ty_i < tn_y; ++ty_i)
    for (int tx_i = 0; tx_i < tn_x; ++tx_i, ++t) {
        const int tx = x + tx_i * kMaxTu, ty = y + ty_i * kMaxTu;

        // --- luma ---
        build_reference(rec_y, fw, coded_mask, mask_w, mask_h,
                        tx, ty, tw, th, fw, fh, bd, false, &refs,
                        wpp != 0);
        predict_intra(mode, tw, th, &refs, bd, false, pred);
        for (int yy = 0; yy < th; ++yy)
            memcpy(&srcbuf[yy * tw], &src_y[(ty + yy) * fw + tx],
                   sizeof(int32_t) * tw);
        int cbf = transform_quant_recon(srcbuf, pred, tw,
                                        th, qp, bd, true, signhide != 0,
                                        coeff_y + off_y, rec, rdoq_lam);
        cbf_out[0] |= cbf << t;
        for (int yy = 0; yy < th; ++yy)
            memcpy(&rec_y[(ty + yy) * fw + tx],
                   cbf ? &rec[yy * tw] : &pred[yy * tw],
                   sizeof(int32_t) * tw);
        off_y += tw * th;
        for (int yy = ty / 4; yy < (ty + th) / 4; ++yy)
            for (int xx = tx / 4; xx < (tx + tw) / 4; ++xx)
                coded_mask[yy * mask_w + xx] = 1;

        // --- chroma ---
        if (!has_chroma) continue;
        int cx = tx >> 1, cy = ty >> 1, cw = tw >> 1, ch = th >> 1;
        int32_t* planes[2] = {rec_u, rec_v};
        const int32_t* srcs[2] = {src_u, src_v};
        int32_t* coeffs[2] = {coeff_u + off_c, coeff_v + off_c};
        for (int c = 0; c < 2; ++c) {
            build_reference(planes[c], cw_stride, coded_mask, mask_w,
                            mask_h, cx, cy, cw, ch, fw >> 1, fh >> 1, bd,
                            true, &refs, wpp != 0);
            predict_intra(mode_c, cw, ch, &refs, bd, true, pred);
            for (int yy = 0; yy < ch; ++yy)
                memcpy(&srcbuf[yy * cw],
                       &srcs[c][(cy + yy) * cw_stride + cx],
                       sizeof(int32_t) * cw);
            int cbf_c = transform_quant_recon(srcbuf, pred,
                                              cw, ch, qp_c, bd, true,
                                              signhide != 0, coeffs[c],
                                              rec, rdoq_lam);
            cbf_out[1 + c] |= cbf_c << t;
            for (int yy = 0; yy < ch; ++yy)
                memcpy(&planes[c][(cy + yy) * cw_stride + cx],
                       cbf_c ? &rec[yy * cw] : &pred[yy * cw],
                       sizeof(int32_t) * cw);
        }
        off_c += cw * ch;
    }
}

}  // namespace rcn

extern "C" {

void rc_set_dct2(int log2_size, const int16_t* m) {
    int n = 1 << log2_size;
    memcpy(rcn::g_dct2[log2_size - 2], m, sizeof(int16_t) * n * n);
}

void rc_set_scan(int log2_w, int log2_h, const int32_t* t) {
    int nn = 1 << (log2_w + log2_h);
    memcpy(rcn::g_scan[log2_w - 2][log2_h - 2], t, sizeof(int32_t) * nn);
}

// Reconstruct a list of intra CUs in coding order.
// leaves: packed int32 [n][6]: x, y, w, h, mode, mode_chroma
// coeff buffers are per-frame flat arrays the caller slices afterward:
//   coeff_y: sum over leaves of w*h, coeff_u/v: sum of (w/2)*(h/2)
// cbf_out: [n][3]
// rdoq_lam > 0 quantises with rdoq (transform_quant_recon). Returns 0, or
// 1 with nothing written where rdoq_levels would leave a TU to numpy.
int rc_recon_frame(int32_t* rec_y, int32_t* rec_u, int32_t* rec_v,
                   const int32_t* src_y, const int32_t* src_u,
                   const int32_t* src_v,
                   uint8_t* coded_mask,
                   int fw, int fh, int qp, int qp_c, int bd, int signhide,
                   int wpp,
                   const int32_t* leaves, int n,
                   int32_t* coeff_y, int32_t* coeff_u, int32_t* coeff_v,
                   int32_t* cbf_out, double rdoq_lam) {
    const bool has_chroma = rec_u != nullptr;
    for (int i = 0; rdoq_lam > 0.0 && i < n; ++i) {
        const int32_t* L = leaves + i * 6;
        const int tw = L[2] < 32 ? L[2] : 32, th = L[3] < 32 ? L[3] : 32;
        if (!rcn::rdoq_covers(tw, th, qp, bd)
            || (has_chroma && !rcn::rdoq_covers(tw >> 1, th >> 1, qp_c, bd)))
            return 1;
    }
    int64_t off_y = 0, off_c = 0;
    for (int i = 0; i < n; ++i) {
        const int32_t* L = leaves + i * 6;
        int x = L[0], y = L[1], w = L[2], h = L[3];
        rcn::recon_intra_leaf(rec_y, rec_u, rec_v, src_y, src_u, src_v,
                              coded_mask, fw, fh, qp, qp_c, bd, signhide,
                              wpp, x, y, w, h, L[4], L[5],
                              coeff_y + off_y, coeff_u + off_c,
                              coeff_v + off_c, cbf_out + i * 3, rdoq_lam);
        off_y += (int64_t)w * h;
        if (has_chroma) off_c += (int64_t)(w >> 1) * (h >> 1);
    }
    return 0;
}

}  // extern "C"

// RDOQ level decision: ops/rdoq.py rdoq_levels in C++, level for level.
//
// The numpy function stays the golden model and the fallback. This one
// keeps its float64 arithmetic in the same order, so that every cost and
// every comparison rounds as numpy's does:
// - dist + lam * rate, with dist = d * d * err_scale, each product rounded
//   on its own (no fused multiply-add: see the pragma below);
// - np.where's tie order: ceil, then floor, then zero;
// - np.cumsum is sequential; np.sum and .sum(axis=1) are numpy's pairwise
//   sums (pairwise_sum below);
// - np.argmin takes the first minimum;
// - the rate of a level above 3 (4.4 + 1.5 * log2(l - 2)) comes from a
//   table numpy computed (rc_set_rdoq_rates): numpy's float64 log2 need
//   not round like the C library's.
// A block whose levels run past the table, or whose shape has no scan
// table here (a side below 4 or above 32), is left to numpy.

// GCC contracts a * b + c into one fused multiply-add by default in C++;
// numpy rounds the product first. This file alone is built without it.
#pragma GCC optimize("fp-contract=off")

#include <cstdint>
#include <cstring>
#include <vector>

#include "recon_shared.h"

namespace rcn {

namespace {

constexpr double kLastCtxBits = 1.3;    // ops/rdoq.py _LAST_CTX_BITS
constexpr double kSigGroupBits = 1.2;   // ops/rdoq.py _SIG_GROUP_BITS
constexpr int kCgSize = 16;             // 4x4 groups for sides 4..32

// ops/scan.py GROUP_IDX, positions 0..31
const int kGroupIdx[32] = {0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                           8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9};
const int64_t kQuantScales[2][6] = {
    {26214, 23302, 20560, 18396, 16384, 14564},
    {18396, 16384, 14564, 13107, 11651, 10280}};

// rate (bits) of |level| l, for l below the table's length
std::vector<double> g_rate;

int log2_exact(int v) {
    if (v <= 0 || (v & (v - 1))) return -1;
    return __builtin_ctz((unsigned)v);
}

// numpy's pairwise_sum (loops_utils.h.src) over n contiguous doubles
double pairwise_sum(const double* a, int n) {
    if (n < 8) {
        double res = 0.0;
        for (int i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        double r[8];
        for (int k = 0; k < 8; ++k) r[k] = a[k];
        int i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int k = 0; k < 8; ++k) r[k] += a[i + k];
        double res = ((r[0] + r[1]) + (r[2] + r[3]))
                     + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    int n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

}  // namespace

// the quantiser's scale and q_bits of a w x h block; false where numpy
// decides (no scan table here, a negative QP, or numpy's quant_params
// raises below 9: a negative shift of the rounding offset)
bool rdoq_params(int w, int h, int qp_scaled, int bd, int64_t* scale,
                 int* q_bits) {
    const int lw = log2_exact(w), lh = log2_exact(h);
    if (lw < 2 || lw > 5 || lh < 2 || lh > 5 || qp_scaled < 0
        || g_rate.empty())
        return false;
    const int sqrt2 = (lw + lh) & 1;
    const int tshift = 15 - bd - ((lw + lh) >> 1) - sqrt2;
    *q_bits = 14 + qp_scaled / 6 + tshift;
    *scale = kQuantScales[sqrt2][qp_scaled % 6];
    return *q_bits >= 9 && *q_bits <= 40;
}

bool rdoq_covers(int w, int h, int qp_scaled, int bd) {
    int64_t scale;
    int q_bits;
    // the ceil candidate of the largest int16 coefficient inside the table
    return rdoq_params(w, h, qp_scaled, bd, &scale, &q_bits)
           && ((32768 * scale) >> q_bits) + 1 < (int64_t)g_rate.size();
}

int rdoq_levels(const int32_t* coef, int w, int h, int qp_scaled, int bd,
                double lam, int32_t* out) {
    int64_t scale;
    int q_bits;
    if (!rdoq_params(w, h, qp_scaled, bd, &scale, &q_bits)) return 1;
    const int n = w * h;
    const int64_t lim = (int64_t)g_rate.size() - 1;
    for (int i = 0; i < n; ++i) {
        const int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
        if (((a * scale) >> q_bits) >= lim) return 1;
    }
    const double* rate = g_rate.data();
    const int tshift = q_bits - 14 - qp_scaled / 6;
    const double err_unit =
        1.0 / ((double)scale * __builtin_ldexp(1.0, tshift));
    const double err_scale = err_unit * err_unit;

    // 1. per-coefficient level: the cheapest of zero, floor and ceil
    int32_t lvl[32 * 32];
    double cost[32 * 32], cost0[32 * 32];
    bool any = false;
    for (int i = 0; i < n; ++i) {
        const int64_t a = coef[i] < 0 ? -(int64_t)coef[i] : coef[i];
        const int64_t ld = a * scale;
        const int64_t lf = ld >> q_bits;
        const double d0 = (double)ld;
        const double d1 = (double)(ld - (lf << q_bits));
        const double d2 = (double)(ld - ((lf + 1) << q_bits));
        const double c0 = d0 * d0 * err_scale + lam * rate[0];
        const double c1 = d1 * d1 * err_scale + lam * rate[lf];
        const double c2 = d2 * d2 * err_scale + lam * rate[lf + 1];
        double c = c0 < c1 ? c0 : c1;
        c = c < c2 ? c : c2;
        int64_t l = c2 == c ? lf + 1 : (c1 == c ? lf : 0);
        lvl[i] = (int32_t)(l < 32767 ? l : 32767);
        cost[i] = c;
        // dist(0) + lam * _R0: rate[0] is _R0, so this is c0
        cost0[i] = c0;
        any |= lvl[i] != 0;
    }
    if (!any) {
        memset(out, 0, sizeof(int32_t) * n);
        return 0;
    }

    // 2. last significant position, in scan order
    const int32_t* scan = g_scan[log2_exact(w) - 2][log2_exact(h) - 2];
    int32_t lvl_s[32 * 32];
    double cost_s[32 * 32], cost0_s[32 * 32], ztail[32 * 32];
    for (int i = 0; i < n; ++i) {
        lvl_s[i] = lvl[scan[i]];
        cost_s[i] = cost[scan[i]];
        cost0_s[i] = cost0[scan[i]];
    }
    // ztail[i]: cost0_s[i+1:] summed from the end, as the reversed cumsum
    ztail[n - 1] = 0.0;
    double acc = 0.0;
    for (int i = n - 1; i > 0; --i) {
        acc = i == n - 1 ? cost0_s[i] : acc + cost0_s[i];
        ztail[i - 1] = acc;
    }
    int best_i = -1;
    double best = 0.0, csum = 0.0;
    for (int i = 0; i < n; ++i) {
        csum = i == 0 ? cost_s[0] : csum + cost_s[i];
        if (lvl_s[i] <= 0) continue;
        const int gx = kGroupIdx[scan[i] % w], gy = kGroupIdx[scan[i] / w];
        const int mx = (gx >> 1) - 1 > 0 ? (gx >> 1) - 1 : 0;
        const int my = (gy >> 1) - 1 > 0 ? (gy >> 1) - 1 : 0;
        const double last_bits =
            kLastCtxBits * ((double)(gx + gy) + 2.0) + (double)mx
            + (double)my;
        const double total = csum + lam * last_bits + ztail[i];
        if (best_i < 0 || total < best) {
            best = total;
            best_i = i;
        }
    }
    if (pairwise_sum(cost0_s, n) <= best) {
        memset(out, 0, sizeof(int32_t) * n);
        return 0;
    }
    for (int i = best_i + 1; i < n; ++i) lvl_s[i] = 0;

    // 3. coefficient-group zeroing, between the DC group and the last
    const int n_cg = n / kCgSize;
    if (n_cg > 1) {
        double cost_cg[64], zero_cg[64];
        double pick[kCgSize];
        for (int g = 0; g < n_cg; ++g) {
            const int o = g * kCgSize;
            for (int k = 0; k < kCgSize; ++k)
                pick[k] = lvl_s[o + k] > 0 ? cost_s[o + k] : cost0_s[o + k];
            cost_cg[g] = pairwise_sum(pick, kCgSize);
            zero_cg[g] = pairwise_sum(cost0_s + o, kCgSize);
        }
        const int last_cg = best_i / kCgSize;
        const double sig_group = lam * kSigGroupBits;
        for (int g = 1; g < last_cg; ++g) {
            const int o = g * kCgSize;
            bool nz = false;
            for (int k = 0; k < kCgSize; ++k) nz |= lvl_s[o + k] != 0;
            if (nz && zero_cg[g] < cost_cg[g] + sig_group)
                for (int k = 0; k < kCgSize; ++k) lvl_s[o + k] = 0;
        }
    }
    for (int i = 0; i < n; ++i) {
        const int p = scan[i];
        out[p] = coef[p] > 0 ? lvl_s[i] : (coef[p] < 0 ? -lvl_s[i] : 0);
    }
    return 0;
}

}  // namespace rcn

extern "C" {

// the rate table: rates[l] = ops/rdoq.py _rate_model(l) for l < n
void rc_set_rdoq_rates(const double* rates, int n) {
    rcn::g_rate.assign(rates, rates + n);
}

// one block, coef and out h x w row-major: 0 with the levels in out, or
// 1 where numpy has to decide (out untouched)
int rc_rdoq_levels(const int32_t* coef, int w, int h, int qp_scaled,
                   int bitdepth, double lam, int16_t* out) {
    int32_t lv[32 * 32];
    if (rcn::rdoq_levels(coef, w, h, qp_scaled, bitdepth, lam, lv)) return 1;
    for (int i = 0; i < w * h; ++i) out[i] = (int16_t)lv[i];
    return 0;
}

// a * b - c, built as the rest of this file: 0 for a = b = 1 + 2^-30,
// c = 1 + 2^-29 unless the product was fused into the subtraction
double rc_rdoq_contract_probe(double a, double b, double c) {
    return a * b - c;
}

}  // extern "C"

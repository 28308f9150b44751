// VVC deblocking filter (in-loop), frame-level two-pass.
//
// Behavioral parity with the reference deblocker
// (uvg266 src/filter.c): strength derivation (:738-818), beta/tc
// tables (:47-60), weak/strong/large-block luma filters (:127-198,406-524),
// strong-filter decision (:529-585), max filter length (:587-644), chroma
// filter (:203-257, 1036-1193), edge grids (filter_deblock_unit:1207).
// The reference interleaves per-LCU with delayed right columns purely for
// threading; filtering ALL vertical edges then ALL horizontal edges is the
// spec-order equivalent and produces identical output.
//
// Inter-mode strength terms (MV/ref comparisons) activate once the inter
// path lands; per-4x4 CU info is provided by the caller.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

const uint16_t TC_TABLE[66] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,   0,   0,
    0,  3,  4,  4,  4,  4,  5,  5,  5,  5,   7,   7,   8,   9,   10,  10,  11,
    13, 14, 15, 17, 19, 21, 24, 25, 29, 33,  36,  41,  45,  51,  57,  64,  71,
    80, 89, 100, 112, 125, 141, 157, 177, 198, 222, 250, 280, 314, 352, 395};
const uint8_t BETA_TABLE[64] = {
    0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,
    6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88};

inline int32_t clip3(int32_t lo, int32_t hi, int32_t v) {
    return v < lo ? lo : (v > hi ? hi : v);
}
inline int32_t iabs(int32_t v) { return v < 0 ? -v : v; }

// per-4x4 CU description (SoA arrays from Python)
struct CuGrid {
    const int32_t* cu_x;     // CU top-left x of the unit's CU
    const int32_t* cu_y;
    const int32_t* log2w;
    const int32_t* log2h;
    const int32_t* is_intra;
    const int32_t* cbf_y;
    const int32_t* cbf_u;
    const int32_t* cbf_v;
    const int32_t* mvx;      // list-0 MV, 1/16-pel
    const int32_t* mvy;
    const int32_t* mvx1;     // list-1 MV
    const int32_t* mvy1;
    const int32_t* refp0;    // POC of list-0 ref, -1 if unused
    const int32_t* refp1;
    int gw, gh;

    int idx(int x, int y) const { return (y / 4) * gw + (x / 4); }
};

struct Ctx {
    int32_t* rec_y;
    int32_t* rec_u;
    int32_t* rec_v;
    int fw, fh;
    int qp, qp_c;
    // per-4x4 luma QP map + luma->chroma QP LUT (cu_qp_delta streams);
    // null -> the scalar frame qp/qp_c (spec 8.8.3: edge QP is the
    // average of the two adjacent CUs' QPs)
    const int32_t* qp4 = nullptr;
    const int32_t* cqp_lut = nullptr;
    int beta_off2, tc_off2;
    int bd;
    CuGrid g;
};

// --- core filters (filter.c:127,159,406,203) -----------------------------

int luma_strong(int32_t* m, int32_t tc) {
    const int32_t m0 = m[0], m1 = m[1], m2 = m[2], m3 = m[3];
    const int32_t m4 = m[4], m5 = m[5], m6 = m[6], m7 = m[7];
    m[1] = clip3(m1 - tc, m1 + tc, (2*m0 + 3*m1 + m2 + m3 + m4 + 4) >> 3);
    m[2] = clip3(m2 - 2*tc, m2 + 2*tc, (m1 + m2 + m3 + m4 + 2) >> 2);
    m[3] = clip3(m3 - 3*tc, m3 + 3*tc, (m1 + 2*m2 + 2*m3 + 2*m4 + m5 + 4) >> 3);
    m[4] = clip3(m4 - 3*tc, m4 + 3*tc, (m2 + 2*m3 + 2*m4 + 2*m5 + m6 + 4) >> 3);
    m[5] = clip3(m5 - 2*tc, m5 + 2*tc, (m3 + m4 + m5 + m6 + 2) >> 2);
    m[6] = clip3(m6 - tc, m6 + tc, (m3 + m4 + m5 + 3*m6 + 2*m7 + 4) >> 3);
    return 3;
}

int luma_weak(int32_t* m, int32_t tc, bool p2, bool q2, int max_pix) {
    const int32_t m1 = m[1], m2 = m[2], m3 = m[3];
    const int32_t m4 = m[4], m5 = m[5], m6 = m[6];
    int32_t delta = (9 * (m4 - m3) - 3 * (m5 - m2) + 8) >> 4;
    if (iabs(delta) >= tc * 10) return 0;
    int32_t tc2 = tc >> 1;
    delta = clip3(-tc, tc, delta);
    m[3] = clip3(0, max_pix, m3 + delta);
    m[4] = clip3(0, max_pix, m4 - delta);
    if (p2) {
        int32_t d1 = clip3(-tc2, tc2, (((m1 + m3 + 1) >> 1) - m2 + delta) >> 1);
        m[2] = clip3(0, max_pix, m2 + d1);
    }
    if (q2) {
        int32_t d2 = clip3(-tc2, tc2, (((m6 + m4 + 1) >> 1) - m5 - delta) >> 1);
        m[5] = clip3(0, max_pix, m5 + d2);
    }
    return (p2 || q2) ? 2 : 1;
}

// line/lineL layout identical to the reference (filter.c:406-524)
int luma_large(int32_t* line, int32_t* lineL, int32_t tc,
               int len_P, int len_Q) {
    static const int coeffs7[7] = {59, 50, 41, 32, 23, 14, 5};
    static const int coeffs5[5] = {58, 45, 32, 19, 6};
    static const int coeffs3[3] = {53, 32, 11};
    const int* cP = nullptr;
    const int* cQ = nullptr;
    int32_t lineP[8] = {line[3], line[2], line[1], line[0],
                        lineL[3], lineL[2], lineL[1], lineL[0]};
    int32_t lineQ[8] = {line[4], line[5], line[6], line[7],
                        lineL[4], lineL[5], lineL[6], lineL[7]};
    int32_t* dstP[7] = {line + 3, line + 2, line + 1,
                        lineL + 3, lineL + 2, lineL + 1, lineL + 0};
    int32_t* dstQ[7] = {line + 4, line + 5, line + 6,
                        lineL + 4, lineL + 5, lineL + 6, lineL + 7};
    int ref_P = 0, ref_Q = 0, ref_mid = 0;
    switch (len_P) {
        case 7: ref_P = (lineP[6] + lineP[7] + 1) >> 1; cP = coeffs7; break;
        case 5: ref_P = (lineP[4] + lineP[5] + 1) >> 1; cP = coeffs5; break;
        case 3: ref_P = (lineP[2] + lineP[3] + 1) >> 1; cP = coeffs3; break;
    }
    switch (len_Q) {
        case 7: ref_Q = (lineQ[6] + lineQ[7] + 1) >> 1; cQ = coeffs7; break;
        case 5: ref_Q = (lineQ[4] + lineQ[5] + 1) >> 1; cQ = coeffs5; break;
        case 3: ref_Q = (lineQ[2] + lineQ[3] + 1) >> 1; cQ = coeffs3; break;
    }
    if (len_P == len_Q) {
        if (len_P == 7)
            ref_mid = (lineP[6] + lineP[5] + lineP[4] + lineP[3] + lineP[2]
                       + lineP[1] + 2 * (lineP[0] + lineQ[0]) + lineQ[1]
                       + lineQ[2] + lineQ[3] + lineQ[4] + lineQ[5] + lineQ[6]
                       + 8) >> 4;
        else
            ref_mid = (lineP[4] + lineP[3]
                       + 2 * (lineP[2] + lineP[1] + lineP[0] + lineQ[0]
                              + lineQ[1] + lineQ[2])
                       + lineQ[3] + lineQ[4] + 8) >> 4;
    } else {
        int lenS = len_P < len_Q ? len_P : len_Q;
        int lenL = len_P < len_Q ? len_Q : len_P;
        const int32_t* refS = len_P < len_Q ? lineP : lineQ;
        const int32_t* refL = len_P < len_Q ? lineQ : lineP;
        if (lenL == 7 && lenS == 5)
            ref_mid = (lineP[5] + lineP[4] + lineP[3] + lineP[2]
                       + 2 * (lineP[1] + lineP[0] + lineQ[0] + lineQ[1])
                       + lineQ[2] + lineQ[3] + lineQ[4] + lineQ[5] + 8) >> 4;
        else if (lenL == 7 && lenS == 3)
            ref_mid = (3 * refS[0] + 2 * refL[0] + 3 * refS[1] + refL[1]
                       + 2 * refS[2] + refL[2] + refL[3] + refL[4] + refL[5]
                       + refL[6] + 8) >> 4;
        else
            ref_mid = (lineP[3] + lineP[2] + lineP[1] + lineP[0] + lineQ[0]
                       + lineQ[1] + lineQ[2] + lineQ[3] + 4) >> 3;
    }
    static const uint8_t tc7[7] = {6, 5, 4, 3, 2, 1, 1};
    static const uint8_t tc3[3] = {6, 4, 2};
    const uint8_t* tcP = (len_P == 3) ? tc3 : tc7;
    const uint8_t* tcQ = (len_Q == 3) ? tc3 : tc7;
    for (int i = 0; i < len_P; ++i) {
        int range = (tc * tcP[i]) >> 1;
        *dstP[i] = clip3(lineP[i] - range, lineP[i] + range,
                         (ref_mid * cP[i] + ref_P * (64 - cP[i]) + 32) >> 6);
    }
    for (int i = 0; i < len_Q; ++i) {
        int range = (tc * tcQ[i]) >> 1;
        *dstQ[i] = clip3(lineQ[i] - range, lineQ[i] + range,
                         (ref_mid * cQ[i] + ref_Q * (64 - cQ[i]) + 32) >> 6);
    }
    return 3;
}

void chroma_filter(int32_t* src, int offset, int32_t tc, bool sw,
                   bool large_boundary, bool hor_ctb_boundary, int max_pix) {
    int32_t m0 = src[-offset * 4], m1 = src[-offset * 3];
    int32_t m2 = src[-offset * 2], m3 = src[-offset];
    int32_t m4 = src[0], m5 = src[offset];
    int32_t m6 = src[offset * 2], m7 = src[offset * 3];
    if (sw) {
        if (hor_ctb_boundary) {
            src[-offset] = clip3(m3 - tc, m3 + tc,
                                 (3 * m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3);
            src[0] = clip3(m4 - tc, m4 + tc,
                           (2 * m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3);
        } else {
            src[-offset * 3] = clip3(m1 - tc, m1 + tc,
                                     (3 * m0 + 2 * m1 + m2 + m3 + m4 + 4) >> 3);
            src[-offset * 2] = clip3(m2 - tc, m2 + tc,
                                     (2 * m0 + m1 + 2 * m2 + m3 + m4 + m5 + 4) >> 3);
            src[-offset] = clip3(m3 - tc, m3 + tc,
                                 (m0 + m1 + m2 + 2 * m3 + m4 + m5 + m6 + 4) >> 3);
            src[0] = clip3(m4 - tc, m4 + tc,
                           (m1 + m2 + m3 + 2 * m4 + m5 + m6 + m7 + 4) >> 3);
        }
        src[offset] = clip3(m5 - tc, m5 + tc,
                            (m2 + m3 + m4 + 2 * m5 + m6 + 2 * m7 + 4) >> 3);
        src[offset * 2] = clip3(m6 - tc, m6 + tc,
                                (m3 + m4 + m5 + 2 * m6 + 3 * m7 + 4) >> 3);
    } else {
        int32_t delta = clip3(-tc, tc, (((m4 - m3) * 4) + m2 - m5 + 4) >> 3);
        src[-offset] = clip3(0, max_pix, m3 + delta);
        src[0] = clip3(0, max_pix, m4 - delta);
    }
}

bool strong_decision(const int32_t* b0, const int32_t* b3,
                     const int32_t* b0L, const int32_t* b3L,
                     int32_t dp0, int32_t dq0, int32_t dp3, int32_t dq3,
                     int32_t tc, int32_t beta,
                     bool p_large, bool q_large, int len_P, int len_Q,
                     bool chroma_ctb_boundary) {
    int32_t sp0 = chroma_ctb_boundary ? iabs(b0[2] - b0[3]) : iabs(b0[0] - b0[3]);
    int32_t sp3 = chroma_ctb_boundary ? iabs(b3[2] - b3[3]) : iabs(b3[0] - b3[3]);
    if (p_large || q_large) {
        int32_t sq0 = iabs(b0[4] - b0[7]);
        int32_t sq3 = iabs(b3[4] - b3[7]);
        int32_t tmp0, tmp3;
        if (p_large) {
            if (len_P == 7) {
                tmp0 = b0L[0]; tmp3 = b3L[0];
                sp0 += iabs(b0L[3] - b0L[2] - b0L[1] + tmp0);
                sp3 += iabs(b3L[3] - b3L[2] - b3L[1] + tmp3);
            } else { tmp0 = b0L[2]; tmp3 = b3L[2]; }
            sp0 = (sp0 + iabs(b0[0] - tmp0) + 1) >> 1;
            sp3 = (sp3 + iabs(b3[0] - tmp3) + 1) >> 1;
        }
        if (q_large) {
            if (len_Q == 7) {
                tmp0 = b0L[7]; tmp3 = b3L[7];
                sq0 += iabs(b0L[4] - b0L[5] - b0L[6] + tmp0);
                sq3 += iabs(b3L[4] - b3L[5] - b3L[6] + tmp3);
            } else { tmp0 = b0L[5]; tmp3 = b3L[5]; }
            sq0 = (sq0 + iabs(tmp0 - b0[7]) + 1) >> 1;
            sq3 = (sq3 + iabs(tmp3 - b3[7]) + 1) >> 1;
        }
        return 2 * (dp0 + dq0) < (beta >> 4) && 2 * (dp3 + dq3) < (beta >> 4)
               && iabs(b0[3] - b0[4]) < ((5 * tc + 1) >> 1)
               && iabs(b3[3] - b3[4]) < ((5 * tc + 1) >> 1)
               && sp0 + sq0 < (beta * 3 >> 5) && sp3 + sq3 < (beta * 3 >> 5);
    }
    return 2 * (dp0 + dq0) < (beta >> 2) && 2 * (dp3 + dq3) < (beta >> 2)
           && iabs(b0[3] - b0[4]) < ((5 * tc + 1) >> 1)
           && iabs(b3[3] - b3[4]) < ((5 * tc + 1) >> 1)
           && sp0 + iabs(b0[4] - b0[7]) < (beta >> 3)
           && sp3 + iabs(b3[4] - b3[7]) < (beta >> 3);
}

// tu sizes on the edge-normal axis; filter.c:587-644 (non-merge path)
void max_filter_length(int tu_P, int tu_Q, bool is_luma,
                       int* len_P, int* len_Q) {
    if (is_luma) {
        if (tu_P <= 4 || tu_Q <= 4) {
            *len_P = 1; *len_Q = 1;
        } else {
            *len_P = tu_P >= 32 ? 7 : 3;
            *len_Q = tu_Q >= 32 ? 7 : 3;
        }
    } else {
        *len_P = (tu_P >= 8 && tu_Q >= 8) ? 3 : 1;
        *len_Q = *len_P;
    }
}

void filter_edge_luma(Ctx& c, int x, int y, bool hor) {
    // edge between P (left/above) and Q at (x, y); 4 lines
    int32_t* base = c.rec_y;
    const int stride = c.fw;
    const int x_stride = hor ? stride : 1;
    const int y_stride = hor ? 1 : stride;
    const int max_pix = (1 << c.bd) - 1;

    int qi = c.g.idx(x, y);
    int pi = hor ? c.g.idx(x, y - 1) : c.g.idx(x - 1, y);
    // boundary strength (filter.c:738-818; P-slice single-list terms,
    // B-slice/bipred terms land with bipred)
    int strength = 0;
    if (c.g.is_intra[qi] || c.g.is_intra[pi]) {
        strength = 2;
    } else if (c.g.cbf_y[qi] || c.g.cbf_y[pi]) {
        strength = 1;
    } else {
        // MV-based strength (filter.c:746-818)
        const int rp0 = c.g.refp0[pi], rp1 = c.g.refp1[pi];
        const int rq0 = c.g.refp0[qi], rq1 = c.g.refp1[qi];
        const int thr = 8;  // half-pel in 1/16 units
        const bool bi_p = rp1 != -1 && rp0 != -1;
        const bool bi_q = rq1 != -1 && rq0 != -1;
        if (bi_p || bi_q || rp1 != -1 || rq1 != -1) {
            // B-style comparison with list swapping
            int mpx0 = rp0 != -1 ? c.g.mvx[pi] : 0;
            int mpy0 = rp0 != -1 ? c.g.mvy[pi] : 0;
            int mpx1 = rp1 != -1 ? c.g.mvx1[pi] : 0;
            int mpy1 = rp1 != -1 ? c.g.mvy1[pi] : 0;
            int mqx0 = rq0 != -1 ? c.g.mvx[qi] : 0;
            int mqy0 = rq0 != -1 ? c.g.mvy[qi] : 0;
            int mqx1 = rq1 != -1 ? c.g.mvx1[qi] : 0;
            int mqy1 = rq1 != -1 ? c.g.mvy1[qi] : 0;
            if ((rp0 == rq0 && rp1 == rq1) || (rp0 == rq1 && rp1 == rq0)) {
                if (rp0 != rp1) {
                    if (rp0 == rq0) {
                        strength = (iabs(mqx0 - mpx0) >= thr
                                    || iabs(mqy0 - mpy0) >= thr
                                    || iabs(mqx1 - mpx1) >= thr
                                    || iabs(mqy1 - mpy1) >= thr) ? 1 : 0;
                    } else {
                        strength = (iabs(mqx1 - mpx0) >= thr
                                    || iabs(mqy1 - mpy0) >= thr
                                    || iabs(mqx0 - mpx1) >= thr
                                    || iabs(mqy0 - mpy1) >= thr) ? 1 : 0;
                    }
                } else {
                    strength = ((iabs(mqx0 - mpx0) >= thr
                                 || iabs(mqy0 - mpy0) >= thr
                                 || iabs(mqx1 - mpx1) >= thr
                                 || iabs(mqy1 - mpy1) >= thr)
                                && (iabs(mqx1 - mpx0) >= thr
                                    || iabs(mqy1 - mpy0) >= thr
                                    || iabs(mqx0 - mpx1) >= thr
                                    || iabs(mqy0 - mpy1) >= thr)) ? 1 : 0;
                }
            } else {
                strength = 1;
            }
        } else if (rp0 != rq0) {
            strength = 1;
        } else if (iabs(c.g.mvx[qi] - c.g.mvx[pi]) >= thr
                   || iabs(c.g.mvy[qi] - c.g.mvy[pi]) >= thr) {
            strength = 1;
        }
    }
    if (strength == 0) return;

    const int eqp = c.qp4 ? ((c.qp4[pi] + c.qp4[qi] + 1) >> 1) : c.qp;
    const int b_index = clip3(0, 63, eqp + (c.beta_off2 << 1));
    const int beta = BETA_TABLE[b_index] * (1 << (c.bd - 8));
    const int side_threshold = (beta + (beta >> 1)) >> 3;
    const int tc_index = clip3(0, 65, eqp + 2 * (strength - 1)
                               + (c.tc_off2 << 1));
    const int tc = c.bd < 10 ? ((TC_TABLE[tc_index] + (1 << (9 - c.bd)))
                                >> (10 - c.bd))
                             : (TC_TABLE[tc_index] << (c.bd - 10));
    if (tc == 0) return;

    int tu_P = hor ? (1 << c.g.log2h[pi]) : (1 << c.g.log2w[pi]);
    int tu_Q = hor ? (1 << c.g.log2h[qi]) : (1 << c.g.log2w[qi]);
    if (tu_P > 32) tu_P = 32;
    if (tu_Q > 32) tu_Q = 32;
    int len_P, len_Q;
    max_filter_length(tu_P, tu_Q, true, &len_P, &len_Q);
    bool p_large = len_P > 3 && !(hor && (y % 64 == 0));
    bool q_large = len_Q > 3;

    int32_t* edge = base + y * stride + x;

    int32_t b[4][8], bL[4][8];
    auto gather = [&](int line, int32_t* dst) {
        int32_t* p = edge + line * y_stride - 4 * x_stride;
        for (int i = 0; i < 8; ++i) dst[i] = p[i * x_stride];
    };
    auto gatherL = [&](int line, int32_t* dst, int off) {
        int32_t* p = edge + line * y_stride + off * x_stride;
        for (int i = 0; i < 4; ++i) dst[i] = p[i * x_stride];
    };
    auto scatter = [&](const int32_t* src_b, int line, int reach) {
        int32_t* p = edge + line * y_stride - reach * x_stride;
        for (int i = 0; i < 2 * reach; ++i) p[i * x_stride] = src_b[4 - reach + i];
    };

    gather(0, b[0]);
    gather(3, b[3]);
    int32_t dp0 = iabs(b[0][1] - 2 * b[0][2] + b[0][3]);
    int32_t dq0 = iabs(b[0][4] - 2 * b[0][5] + b[0][6]);
    int32_t dp3 = iabs(b[3][1] - 2 * b[3][2] + b[3][3]);
    int32_t dq3 = iabs(b[3][4] - 2 * b[3][5] + b[3][6]);
    int32_t dp = dp0 + dp3, dq = dq0 + dq3;
    bool sw = false;

    if (p_large || q_large) {
        int32_t dp0L = dp0, dq0L = dq0, dp3L = dp3, dq3L = dq3;
        if (p_large) {
            gatherL(0, bL[0], -8);
            gatherL(3, bL[3], -8);
            dp0L = (dp0L + iabs(bL[0][2] - 2 * bL[0][3] + b[0][0]) + 1) >> 1;
            dp3L = (dp3L + iabs(bL[3][2] - 2 * bL[3][3] + b[3][0]) + 1) >> 1;
        }
        if (q_large) {
            gatherL(0, bL[0] + 4, 4);
            gatherL(3, bL[3] + 4, 4);
            dq0L = (dq0L + iabs(b[0][7] - 2 * bL[0][4] + bL[0][5]) + 1) >> 1;
            dq3L = (dq3L + iabs(b[3][7] - 2 * bL[3][4] + bL[3][5]) + 1) >> 1;
        }
        if (dp0L + dp3L + dq0L + dq3L < beta) {
            sw = strong_decision(b[0], b[3], bL[0], bL[3], dp0L, dq0L, dp3L,
                                 dq3L, tc, beta, p_large, q_large, len_P,
                                 len_Q, false);
            if (sw) {
                gather(1, b[1]);
                gather(2, b[2]);
                if (p_large) { gatherL(1, bL[1], -8); gatherL(2, bL[2], -8); }
                if (q_large) { gatherL(1, bL[1] + 4, 4); gatherL(2, bL[2] + 4, 4); }
                for (int i = 0; i < 4; ++i) {
                    luma_large(b[i], bL[i], tc, p_large ? len_P : 3,
                               q_large ? len_Q : 3);
                    // scatter line (reach 3 around edge) + large extensions
                    scatter(b[i], i, 3);
                    if (p_large) {
                        // positions p3..p(2+2*diff) <- lineL-stored outputs
                        int diff = (len_P - 3) >> 1;
                        int32_t* p = edge + i * y_stride
                                     - (3 + 2 * diff) * x_stride;
                        for (int k = 0; k < 2 * diff; ++k)
                            p[k * x_stride] = bL[i][4 - 2 * diff + k];
                    }
                    if (q_large) {
                        int diff = (len_Q - 3) >> 1;
                        int32_t* p = edge + i * y_stride + 3 * x_stride;
                        for (int k = 0; k < 2 * diff; ++k)
                            p[k * x_stride] = bL[i][4 + k];
                    }
                }
            }
        }
    }

    if (!sw && dp + dq < beta) {
        if (len_P > 2 && len_Q > 2)
            sw = strong_decision(b[0], b[3], nullptr, nullptr, dp0, dq0, dp3,
                                 dq3, tc, beta, false, false, 7, 7, false);
        gather(1, b[1]);
        gather(2, b[2]);
        for (int i = 0; i < 4; ++i) {
            int reach;
            if (sw) {
                reach = luma_strong(b[i], tc);
            } else {
                bool p2 = false, q2 = false;
                if (len_P > 1 && len_Q > 1) {
                    p2 = dp < side_threshold;
                    q2 = dq < side_threshold;
                }
                reach = luma_weak(b[i], tc, p2, q2, max_pix);
            }
            scatter(b[i], i, reach);
        }
    }
}

void filter_edge_chroma(Ctx& c, int x_c, int y_c, bool hor) {
    const int stride = c.fw >> 1;
    const int offset = hor ? stride : 1;
    const int step = hor ? 1 : stride;
    const int max_pix = (1 << c.bd) - 1;
    // CU lookup in luma coords
    int xl = x_c << 1, yl = y_c << 1;
    int qi = c.g.idx(xl, yl);
    int pi = hor ? c.g.idx(xl, yl - 4) : c.g.idx(xl - 4, yl);

    int strength_u = 0, strength_v = 0;
    if (c.g.is_intra[qi] || c.g.is_intra[pi]) {
        strength_u = strength_v = 2;
    } else {
        strength_u = (c.g.cbf_u[qi] || c.g.cbf_u[pi]) ? 1 : 0;
        strength_v = (c.g.cbf_v[qi] || c.g.cbf_v[pi]) ? 1 : 0;
    }

    // chroma tu sizes (chroma samples; single tree: CU chroma block)
    int tu_P = hor ? (1 << c.g.log2h[pi]) >> 1 : (1 << c.g.log2w[pi]) >> 1;
    int tu_Q = hor ? (1 << c.g.log2h[qi]) >> 1 : (1 << c.g.log2w[qi]) >> 1;
    if (tu_P > 32) tu_P = 32;
    if (tu_Q > 32) tu_Q = 32;
    int len_P, len_Q;
    max_filter_length(tu_P, tu_Q, false, &len_P, &len_Q);
    bool large_boundary = len_P >= 3 && len_Q >= 3;
    bool hor_ctb_boundary = hor && (yl % 64 == 0);

    int32_t* planes[2] = {c.rec_u, c.rec_v};
    int strengths[2] = {strength_u, strength_v};
    for (int comp = 0; comp < 2; ++comp) {
        int s = strengths[comp];
        if (!(s == 2 || (large_boundary && s == 1))) continue;
        const int eqp_c = c.qp4
            ? c.cqp_lut[clip3(0, 63, (c.qp4[pi] + c.qp4[qi] + 1) >> 1)]
            : c.qp_c;
        int tc_index = clip3(0, 65, eqp_c + 2 * (s - 1) + (c.tc_off2 << 1));
        int tc = c.bd < 10 ? ((TC_TABLE[tc_index] + (1 << (9 - c.bd)))
                              >> (10 - c.bd))
                           : (TC_TABLE[tc_index] << (c.bd - 10));
        if (tc == 0) continue;
        int32_t* edge = planes[comp] + y_c * stride + x_c;
        bool use_long = false;
        if (large_boundary) {
            int beta_index = clip3(0, 63, eqp_c + (c.beta_off2 << 1));
            int beta = BETA_TABLE[beta_index] * (1 << (c.bd - 8));
            const int sss = 1;   // 4:2:0
            int32_t b[2][8];
            for (int i = 0; i < 8; ++i) {
                b[0][i] = edge[0 * step + (i - 4) * offset];
                b[1][i] = edge[sss * step + (i - 4) * offset];
            }
            int p_ind = hor_ctb_boundary ? 2 : 1;
            int32_t dp0 = iabs(b[0][p_ind] - 2 * b[0][2] + b[0][3]);
            int32_t dq0 = iabs(b[0][4] - 2 * b[0][5] + b[0][6]);
            int32_t dp3 = iabs(b[1][p_ind] - 2 * b[1][2] + b[1][3]);
            int32_t dq3 = iabs(b[1][4] - 2 * b[1][5] + b[1][6]);
            if (dp0 + dp3 + dq0 + dq3 < beta) {
                use_long = true;
                bool sw = strong_decision(b[0], b[1], nullptr, nullptr, dp0,
                                          dq0, dp3, dq3, tc, beta, false,
                                          false, 7, 7, hor_ctb_boundary);
                for (int i = 0; i < 2; ++i)
                    chroma_filter(edge + step * i, offset, tc, sw,
                                  large_boundary, hor_ctb_boundary, max_pix);
            }
        }
        if (!use_long) {
            for (int i = 0; i < 2; ++i)
                chroma_filter(edge + step * i, offset, tc, false,
                              large_boundary, hor_ctb_boundary, max_pix);
        }
    }
}

}  // namespace

extern "C" {

// cu grid arrays are per 4x4 unit, row-major [gh][gw]
void rc_deblock_frame(int32_t* rec_y, int32_t* rec_u, int32_t* rec_v,
                      int fw, int fh, int qp, int qp_c,
                      int beta_off2, int tc_off2, int bd,
                      const int32_t* cu_x, const int32_t* cu_y,
                      const int32_t* log2w, const int32_t* log2h,
                      const int32_t* is_intra, const int32_t* cbf_y,
                      const int32_t* cbf_u, const int32_t* cbf_v,
                      const int32_t* mvx, const int32_t* mvy,
                      const int32_t* mvx1, const int32_t* mvy1,
                      const int32_t* refp0, const int32_t* refp1,
                      const int32_t* tbx, int n_tbx,
                      const int32_t* tby, int n_tby,
                      int planes /* bit0 luma, bit1 chroma */,
                      const int32_t* qp4, const int32_t* cqp_lut) {
    Ctx c;
    c.rec_y = rec_y; c.rec_u = rec_u; c.rec_v = rec_v;
    c.fw = fw; c.fh = fh; c.qp = qp; c.qp_c = qp_c;
    c.qp4 = qp4; c.cqp_lut = cqp_lut;
    c.beta_off2 = beta_off2; c.tc_off2 = tc_off2; c.bd = bd;
    c.g.cu_x = cu_x; c.g.cu_y = cu_y; c.g.log2w = log2w; c.g.log2h = log2h;
    c.g.is_intra = is_intra; c.g.cbf_y = cbf_y; c.g.cbf_u = cbf_u;
    c.g.cbf_v = cbf_v; c.g.mvx = mvx; c.g.mvy = mvy;
    c.g.mvx1 = mvx1; c.g.mvy1 = mvy1; c.g.refp0 = refp0; c.g.refp1 = refp1;
    c.g.gw = (fw + 3) / 4; c.g.gh = (fh + 3) / 4;

    const bool do_luma = (planes & 1) != 0;
    const bool has_chroma = rec_u != nullptr && (planes & 2) != 0;
    // tile boundaries with loop_filter_across_tiles disabled: edges lying
    // on a listed x (vertical) / y (horizontal) coordinate are not filtered
    auto in_list = [](int v, const int32_t* lst, int n) {
        for (int i = 0; i < n; ++i) if (lst[i] == v) return true;
        return false;
    };

    // pass 1: vertical edges (horizontal filtering), spec order
    if (do_luma)
    for (int x = 4; x < fw; x += 4) {
        if (in_list(x, tbx, n_tbx)) continue;
        for (int y = 0; y < fh; y += 4) {
            if (c.g.cu_x[c.g.idx(x, y)] == x)
                filter_edge_luma(c, x, y, false);
        }
    }
    if (has_chroma) {
        for (int x = 16; x < fw; x += 16) {
            if (in_list(x, tbx, n_tbx)) continue;
            for (int y = 0; y < fh; y += 4) {
                if (c.g.cu_x[c.g.idx(x, y)] == x)
                    filter_edge_chroma(c, x >> 1, y >> 1, false);
            }
        }
    }
    // pass 2: horizontal edges (vertical filtering)
    if (do_luma)
    for (int y = 4; y < fh; y += 4) {
        if (in_list(y, tby, n_tby)) continue;
        for (int x = 0; x < fw; x += 4) {
            if (c.g.cu_y[c.g.idx(x, y)] == y)
                filter_edge_luma(c, x, y, true);
        }
    }
    if (has_chroma) {
        for (int y = 16; y < fh; y += 16) {
            if (in_list(y, tby, n_tby)) continue;
            for (int x = 0; x < fw; x += 4) {
                if (c.g.cu_y[c.g.idx(x, y)] == y)
                    filter_edge_chroma(c, x >> 1, y >> 1, true);
            }
        }
    }
}

}  // extern "C"

// SAO native kernels: per-CTU statistics accumulation and offset apply.
//
// The host-side twins live in control/sao.py (_frame_sao_stats /
// sao_apply_frame); behavior mirrors the reference's SAO search and
// reconstruction (sao.c uvg_calc_sao_* / uvg_sao_reconstruct_frame).
// These are the per-pixel passes; the RD offset decisions stay in
// (vectorized) Python.

#include <cstdint>
#include <cstring>
#include <vector>
#include <thread>

namespace {

// edge offset class sample pairs: {a, b} offsets as (dx, dy)
static const int EO[4][2][2] = {
    {{-1, 0}, {1, 0}},    // class 0: horizontal neighbors
    {{0, -1}, {0, 1}},    // class 1: vertical
    {{-1, -1}, {1, 1}},   // class 2: 135 diagonal
    {{1, -1}, {-1, 1}},   // class 3: 45 diagonal
};
static const int EO_IDX_TO_CAT[5] = {1, 2, 0, 3, 4};

inline int sign3(int v) { return (v > 0) - (v < 0); }

}  // namespace

extern "C" {

// Accumulate per-CTU SAO statistics for one plane.
// edge_cnt/edge_sum layout: [4][n_ctu][5]; band_cnt/band_sum: [n_ctu][32].
void rc_sao_stats(const int32_t* src, const int32_t* rec, int W, int H,
                  int lcu, int wl, int n_ctu, int bitdepth,
                  int64_t* edge_cnt, int64_t* edge_sum,
                  int64_t* band_cnt, int64_t* band_sum) {
    const int bshift = bitdepth - 5;
    for (int y = 0; y < H; ++y) {
        const int cy = y / lcu;
        const int32_t* rrow = rec + (size_t)y * W;
        const int32_t* srow = src + (size_t)y * W;
        for (int x = 0; x < W; ++x) {
            const int ctu = cy * wl + x / lcu;
            const int d = srow[x] - rrow[x];
            const int c = rrow[x];
            const int band = c >> bshift;
            band_cnt[(size_t)ctu * 32 + band] += 1;
            band_sum[(size_t)ctu * 32 + band] += d;
            const bool x_in = x > 0 && x < W - 1;
            const bool y_in = y > 0 && y < H - 1;
            for (int ec = 0; ec < 4; ++ec) {
                int cat = 0;
                const bool ok = (ec == 0) ? x_in
                              : (ec == 1) ? y_in
                              : (x_in && y_in);
                if (ok) {
                    const int a = rec[(size_t)(y + EO[ec][0][1]) * W
                                      + x + EO[ec][0][0]];
                    const int b = rec[(size_t)(y + EO[ec][1][1]) * W
                                      + x + EO[ec][1][0]];
                    cat = EO_IDX_TO_CAT[2 + sign3(c - a) + sign3(c - b)];
                }
                const size_t base = (size_t)ec * n_ctu * 5
                                  + (size_t)ctu * 5 + cat;
                edge_cnt[base] += 1;
                edge_sum[base] += d;
            }
        }
    }
}

// Apply SAO offsets in place for one plane.
// types/eo_class: [n_ctu]; band_pos: [n_ctu]; offsets: [n_ctu][5]
// (category-indexed: offsets[1..4] edge cats or 4 band offsets at
// band_pos..+3 packed into [1..4]).
void rc_sao_apply(int32_t* plane, const int32_t* pre, int W, int H,
                  int lcu, int wl, int bitdepth,
                  const int32_t* types, const int32_t* eo_class,
                  const int32_t* band_pos, const int32_t* offsets,
                  const int32_t* tbx, int n_tbx,
                  const int32_t* tby, int n_tby) {
    const int maxv = (1 << bitdepth) - 1;
    const int bshift = bitdepth - 5;
    // with loop_filter_across_tiles disabled, a sample whose edge-offset
    // neighbor lies across a tile boundary is left unfiltered (same rule
    // as the picture border); tbx/tby list interior boundary coordinates
    // in THIS plane's units
    auto at_b = [](int v, const int32_t* lst, int n) {
        for (int i = 0; i < n; ++i)
            if (lst[i] == v) return true;
        return false;
    };
    for (int y = 0; y < H; ++y) {
        const int cy = y / lcu;
        const int32_t* prow = pre + (size_t)y * W;
        const bool yb = at_b(y, tby, n_tby) || at_b(y + 1, tby, n_tby);
        for (int x = 0; x < W; ++x) {
            const int ctu = cy * wl + x / lcu;
            const int t = types[ctu];
            if (t == 0) continue;
            const int c = prow[x];
            int v = c;
            if (t == 1) {                       // band
                const int band = c >> bshift;
                const int k = band - band_pos[ctu];
                if (k >= 0 && k < 4)
                    v = c + offsets[(size_t)ctu * 5 + 1 + k];
            } else {                            // edge
                const int ec = eo_class[ctu];
                const bool xb = n_tbx &&
                    (at_b(x, tbx, n_tbx) || at_b(x + 1, tbx, n_tbx));
                const bool ok = (ec == 0) ? (x > 0 && x < W - 1 && !xb)
                              : (ec == 1) ? (y > 0 && y < H - 1 && !yb)
                              : (x > 0 && x < W - 1 && y > 0 && y < H - 1
                                 && !xb && !yb);
                if (ok) {
                    const int a = pre[(size_t)(y + EO[ec][0][1]) * W
                                      + x + EO[ec][0][0]];
                    const int b = pre[(size_t)(y + EO[ec][1][1]) * W
                                      + x + EO[ec][1][0]];
                    const int cat =
                        EO_IDX_TO_CAT[2 + sign3(c - a) + sign3(c - b)];
                    if (cat)
                        v = c + offsets[(size_t)ctu * 5 + cat];
                }
            }
            if (v < 0) v = 0;
            if (v > maxv) v = maxv;
            plane[(size_t)y * W + x] = v;
        }
    }
}

// Whole-frame SAO decision (the mirror of control/sao.py
// sao_search_frame; reference uvg_sao_search_lcu, sao.c:491-671):
// per-plane stats (rc_sao_stats) -> per-category best offsets ->
// per-CTU luma + joint-chroma type decision -> left/up merge. Outputs
// (per CTU): luma type/eo/bp/off[5], chroma type/eo/bp_u/bp_v/off[10],
// merge flags — the SaoInfo layout the entropy writers pack.
void rc_sao_search(const int32_t* src_y, const int32_t* rec_y,
                   const int32_t* src_u, const int32_t* rec_u,
                   const int32_t* src_v, const int32_t* rec_v,
                   int W, int H, int lcu, int wl, int hl, int bitdepth,
                   double lam,
                   int32_t* t_l, int32_t* eo_l, int32_t* bp_l,
                   int32_t* off_l, int32_t* t_c, int32_t* eo_c,
                   int32_t* bp_c, int32_t* off_c, int32_t* mrg) {
    const int n_ctu = wl * hl;
    const int omax = (1 << ((bitdepth < 10 ? bitdepth : 10) - 5)) - 1;
    const bool has_chroma = rec_u != nullptr;
    const int n_planes = has_chroma ? 3 : 1;
    const int edge_signs[5] = {0, 1, 1, -1, -1};

    // per plane: stats + per-(ec, ctu) edge offsets/costs + band window
    std::vector<int64_t> e_cnt(3 * 4 * n_ctu * 5), e_sum(3 * 4 * n_ctu * 5);
    std::vector<int64_t> b_cnt(3 * n_ctu * 32), b_sum(3 * n_ctu * 32);
    std::vector<int32_t> eoff(3 * 4 * n_ctu * 5);
    std::vector<double> ecost(3 * 4 * n_ctu);        // cats 1..4 summed
    std::vector<int32_t> boff(3 * n_ctu * 32);
    std::vector<int32_t> bpos(3 * n_ctu);
    std::vector<double> bwcost(3 * n_ctu);

    // best offset for one (count, sum, sign) in the vectorized python
    // semantics: brute force o in [-omax, omax], offset 0 costs 0
    auto best_off = [&](int64_t cnt, double sm, int sign, double extra,
                        int32_t* o_out, double* c_out) {
        int best_o = -omax;
        double best_c = 0.0;
        bool first = true;
        for (int o = -omax; o <= omax; ++o) {
            double c;
            if (o == 0) {
                c = 0.0;
            } else if ((int64_t)sign * o < 0) {
                continue;           // np.inf
            } else {
                c = (double)cnt * o * o - 2.0 * sm * o
                    + lam * ((o < 0 ? -o : o) + 1 + extra);
            }
            if (first || c < best_c) {
                best_o = o;
                best_c = c;
                first = false;
            }
        }
        *o_out = best_o;
        *c_out = best_c;
    };

    auto plane_work = [&](int p) {
        const int32_t* sp = p == 0 ? src_y : (p == 1 ? src_u : src_v);
        const int32_t* rp = p == 0 ? rec_y : (p == 1 ? rec_u : rec_v);
        int sh = p == 0 ? 0 : 1;
        rc_sao_stats(sp, rp, W >> sh, H >> sh, lcu >> sh, wl, n_ctu,
                     bitdepth,
                     &e_cnt[p * 4 * n_ctu * 5], &e_sum[p * 4 * n_ctu * 5],
                     &b_cnt[p * n_ctu * 32], &b_sum[p * n_ctu * 32]);
        for (int ec = 0; ec < 4; ++ec)
            for (int i = 0; i < n_ctu; ++i) {
                double csum = 0.0;
                int64_t* cc = &e_cnt[((p * 4 + ec) * n_ctu + i) * 5];
                int64_t* cs = &e_sum[((p * 4 + ec) * n_ctu + i) * 5];
                int32_t* oo = &eoff[((p * 4 + ec) * n_ctu + i) * 5];
                oo[0] = 0;
                for (int cat = 1; cat < 5; ++cat) {
                    double c;
                    best_off(cc[cat], (double)cs[cat], edge_signs[cat],
                             0.0, &oo[cat], &c);
                    csum += c;
                }
                ecost[(p * 4 + ec) * n_ctu + i] = csum;
            }
        for (int i = 0; i < n_ctu; ++i) {
            double bc[32];
            int32_t* bo = &boff[(p * n_ctu + i) * 32];
            int64_t* cc = &b_cnt[(p * n_ctu + i) * 32];
            int64_t* cs = &b_sum[(p * n_ctu + i) * 32];
            for (int b = 0; b < 32; ++b)
                best_off(cc[b], (double)cs[b], 0, 1.0, &bo[b], &bc[b]);
            int best_b = 0;
            double best_w = 0.0;
            for (int b = 0; b < 29; ++b) {
                double w = bc[b] + bc[b + 1] + bc[b + 2] + bc[b + 3];
                if (b == 0 || w < best_w) {
                    best_w = w;
                    best_b = b;
                }
            }
            bpos[p * n_ctu + i] = best_b;
            bwcost[p * n_ctu + i] = best_w;
        }
    };
    if (n_planes > 1) {
        std::thread t1(plane_work, 1), t2(plane_work, 2);
        plane_work(0);
        t1.join();
        t2.join();
    } else {
        plane_work(0);
    }

    // delta-distortion of given params on this CTU's stats
    auto dist_with = [&](int p, int i, int type, int ec, int bp,
                         const int32_t* offs, int off_base) {
        double d = 0.0;
        if (type == 2) {            // edge
            int64_t* cc = &e_cnt[((p * 4 + ec) * n_ctu + i) * 5];
            int64_t* cs = &e_sum[((p * 4 + ec) * n_ctu + i) * 5];
            for (int cat = 1; cat < 5; ++cat) {
                int o = offs[off_base + cat];
                d += (double)cc[cat] * o * o - 2.0 * o * (double)cs[cat];
            }
        } else if (type == 1) {     // band
            int64_t* cc = &b_cnt[(p * n_ctu + i) * 32];
            int64_t* cs = &b_sum[(p * n_ctu + i) * 32];
            for (int k = 0; k < 4; ++k) {
                int o = offs[off_base + 1 + k];
                int b = bp + k;
                if (b < 32)
                    d += (double)cc[b] * o * o - 2.0 * o * (double)cs[b];
            }
        }
        return d;
    };

    for (int cty = 0; cty < hl; ++cty)
    for (int ctx = 0; ctx < wl; ++ctx) {
        int i = cty * wl + ctx;
        // ---- luma ----
        int bl_t = 0, bl_ec = 0, bl_bp = 0;
        int32_t bl_off[5] = {0, 0, 0, 0, 0};
        double bl_cost = 0.0;
        for (int ec = 0; ec < 4; ++ec) {
            double c = ecost[ec * n_ctu + i] + lam * 5.0;
            if (c < bl_cost) {
                bl_t = 2;
                bl_ec = ec;
                memcpy(bl_off, &eoff[(ec * n_ctu + i) * 5],
                       sizeof(bl_off));
                bl_cost = c;
            }
        }
        {
            double c = bwcost[i] + lam * 8.0;
            if (c < bl_cost) {
                bl_t = 1;
                bl_bp = bpos[i];
                bl_off[0] = 0;
                for (int k = 0; k < 4; ++k)
                    bl_off[1 + k] = boff[i * 32 + bl_bp + k];
                bl_cost = c;
            }
        }
        // ---- chroma joint ----
        int bc_t = 0, bc_ec = 0, bc_bpu = 0, bc_bpv = 0;
        int32_t bc_off[10] = {0};
        double bc_cost = 0.0;
        if (has_chroma) {
            for (int ec = 0; ec < 4; ++ec) {
                double c = ecost[(1 * 4 + ec) * n_ctu + i]
                           + ecost[(2 * 4 + ec) * n_ctu + i] + lam * 5.0;
                if (c < bc_cost) {
                    bc_t = 2;
                    bc_ec = ec;
                    memset(bc_off, 0, sizeof(bc_off));
                    for (int cat = 1; cat < 5; ++cat) {
                        bc_off[cat] =
                            eoff[((4 + ec) * n_ctu + i) * 5 + cat];
                        bc_off[5 + cat] =
                            eoff[((8 + ec) * n_ctu + i) * 5 + cat];
                    }
                    bc_cost = c;
                }
            }
            double c = bwcost[1 * n_ctu + i] + bwcost[2 * n_ctu + i]
                       + lam * 13.0;
            if (c < bc_cost) {
                bc_t = 1;
                bc_bpu = bpos[1 * n_ctu + i];
                bc_bpv = bpos[2 * n_ctu + i];
                memset(bc_off, 0, sizeof(bc_off));
                for (int k = 0; k < 4; ++k) {
                    bc_off[1 + k] = boff[(1 * n_ctu + i) * 32 + bc_bpu + k];
                    bc_off[6 + k] = boff[(2 * n_ctu + i) * 32 + bc_bpv + k];
                }
                bc_cost = c;
            }
        }
        // ---- merge ----
        double cur_cost = bl_cost + (has_chroma ? bc_cost : 0.0)
                          + lam * 2.0;
        int m_left = 0, m_up = 0, m_src = -1;
        auto merged_cost = [&](int j) {
            double d = dist_with(0, i, t_l[j], eo_l[j], bp_l[j * 2],
                                 &off_l[j * 10], 0);
            if (has_chroma) {
                d += dist_with(1, i, t_c[j], eo_c[j], bp_c[j * 2],
                               &off_c[j * 10], 0);
                d += dist_with(2, i, t_c[j], eo_c[j], bp_c[j * 2 + 1],
                               &off_c[j * 10], 5);
            }
            return d + lam * 1.0;
        };
        if (ctx > 0) {
            double c = merged_cost(i - 1);
            if (c < cur_cost) {
                cur_cost = c;
                m_left = 1;
                m_src = i - 1;
            }
        }
        if (cty > 0) {
            double c = merged_cost(i - wl);
            if (c < cur_cost) {
                cur_cost = c;
                m_left = 0;
                m_up = 1;
                m_src = i - wl;
            }
        }
        if (m_src >= 0) {
            t_l[i] = t_l[m_src];
            eo_l[i] = eo_l[m_src];
            bp_l[i * 2] = bp_l[m_src * 2];
            bp_l[i * 2 + 1] = bp_l[m_src * 2 + 1];
            memcpy(&off_l[i * 10], &off_l[m_src * 10],
                   10 * sizeof(int32_t));
            t_c[i] = t_c[m_src];
            eo_c[i] = eo_c[m_src];
            bp_c[i * 2] = bp_c[m_src * 2];
            bp_c[i * 2 + 1] = bp_c[m_src * 2 + 1];
            memcpy(&off_c[i * 10], &off_c[m_src * 10],
                   10 * sizeof(int32_t));
        } else {
            t_l[i] = bl_t;
            eo_l[i] = bl_ec;
            bp_l[i * 2] = bl_bp;
            bp_l[i * 2 + 1] = 0;
            memset(&off_l[i * 10], 0, 10 * sizeof(int32_t));
            memcpy(&off_l[i * 10], bl_off, sizeof(bl_off));
            t_c[i] = bc_t;
            eo_c[i] = bc_ec;
            bp_c[i * 2] = bc_bpu;
            bp_c[i * 2 + 1] = bc_bpv;
            memcpy(&off_c[i * 10], bc_off, sizeof(bc_off));
        }
        mrg[i * 2] = m_left;
        mrg[i * 2 + 1] = m_up;
    }
}

}  // extern "C"

// Whole-frame intra coding-tree entropy writer.
//
// The native phase-2 companion of recon.cpp: walks every CTU of an
// all-intra frame in one call, emitting SAO params, split flags, intra
// modes (MPM), CBFs and residual coefficients through the C++ CABAC
// engine (entropy.cpp) -- removing the per-bin Python/ctypes round-trips
// of the Python CodingTreeWriter, which it mirrors bit-exactly.
//
// Behavioral parity (via the Python writer, which cites the reference):
// - split flags / possible splits: uvg266 cu.c:412-513,
//   encode_coding_tree.c uvg_write_split_flag
// - intra mode + MPM: intra.c:88-188, encode_coding_tree.c:1193-1234
// - transform tree / cbf: encode_coding_tree.c:628-759
// - SAO syntax: encode_coding_tree sao writers
//
// Scope: I-slice, QT-only decisions (the shape produced by the batched
// partition DP), single tile, no MTS/ISP/MIP/MRL/LFNST, leaves <= 32x32.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {
// entropy.cpp C ABI (handle-opaque)
void ec_bin(void* ec, int ctx, int b);
void ec_bin_ep(void* ec, int b);
void ec_bins_ep(void* ec, uint32_t v, int n);
void ec_trunc_bin(void* ec, uint32_t v, uint32_t m);
void ec_unary_max_ep(void* ec, uint32_t v, uint32_t m);
void ec_get_contexts(void* ec, uint16_t* s0, uint16_t* s1);
void ec_set_states(void* ec, const uint16_t* s0, const uint16_t* s1);
void ec_ep_ex_golomb(void* ec, uint32_t symbol, int count);
int ec_ctx_count(void* ec);
int32_t ec_coeff_nxn(void* ec, const int32_t* coeff, int w, int h,
                     int is_luma, int dep_quant, int signhide,
                     const int32_t* scan, const int32_t* scan_cg,
                     int log2_cg_w, int log2_cg_h);
}

namespace {

constexpr int kLcu = 64;

// scan tables per log2 size (square), uploaded from Python
static const int32_t* g_scan[7] = {nullptr};
static const int32_t* g_scan_cg[7] = {nullptr};

// context family offsets, uploaded from Python (order fixed with binding)
struct TreeOffsets {
    int split_flag, qt_split_flag, mtt_vertical, mtt_binary;
    int mpm_flag, luma_planar, chroma_pred;
    int cbf_cb, cbf_cr, cbf_luma;
    int sao_merge, sao_type;
    // inter syntax (P/B slices)
    int cu_skip, cu_pred_mode, merge_flag, merge_idx;
    int inter_dir, ref_pic, mvp_idx, root_cbf, imv_flag, mvd;
} g_off;

struct Leaf {
    int32_t x, y, w, h, mode, mode_c;
};

// extended leaf for P/B frames (python packer layout, 20 int32):
// x,y,w,h,mode,mode_c, type(1=intra 2=inter), skipped, merged, merge_idx,
// mv_dir, mvd0x,mvd0y,mvd1x,mvd1y, mvp0,mvp1, ref0,ref1, reserved
struct LeafEx {
    int32_t x, y, w, h, mode, mode_c;
    int32_t type, skipped, merged, merge_idx, mv_dir;
    int32_t mvd[2][2];
    int32_t mvp[2], ref[2];
    int32_t reserved;
};

struct Ctx {
    void* ec;
    const int32_t* leaves;     // stride int32s per leaf (6 or 20)
    int stride;
    const int32_t* cbf;        // [n,3]
    const int32_t* coeff_y;    // packed in leaf order
    const int32_t* coeff_u;
    const int32_t* coeff_v;
    int fw, fh, has_chroma, signhide, dep_quant;
    int min_qt_size, max_bt_size, max_tt_size, max_btt_depth;
    // slice params (P/B writer)
    int is_intra_slice = 1, is_b = 0, nref0 = 0, nref1 = 0;
    int max_merge = 6, amvr = 0;
    // per-4x4 state
    int gw4, gh4;
    std::vector<uint8_t> coded;
    std::vector<int16_t> mode4;
    std::vector<int8_t> log2w4, log2h4, qtd4;
    std::vector<uint8_t> skip4, intra4;
    // walk cursor
    int cur;
    int64_t off_y, off_c;
    // leaf lookup: 4x4 -> leaf idx
    std::vector<int32_t> leaf_at;
};

inline const int32_t* lf_raw(const Ctx& c, int i) {
    return c.leaves + (int64_t)i * c.stride;
}
inline Leaf lf_basic(const Ctx& c, int i) {
    const int32_t* p = lf_raw(c, i);
    return Leaf{p[0], p[1], p[2], p[3], p[4], p[5]};
}

inline int at4(const Ctx& c, int x, int y) {       // -1 if unavailable
    if (x < 0 || y < 0) return -1;
    int xi = x >> 2, yi = y >> 2;
    if (xi >= c.gw4 || yi >= c.gh4 || !c.coded[yi * c.gw4 + xi]) return -1;
    return yi * c.gw4 + xi;
}

// --- split flags ----------------------------------------------------------

enum { NO_SPLIT = 0, QT_SPLIT = 1, BT_HOR = 2, TT_HOR = 3, BT_VER = 4,
       TT_VER = 5 };

struct SplitState {
    int depth = 0, mtt_depth = 0, implicit_mtt = 0, part_index = 0;
    int last = NO_SPLIT;   // last split in chain (QT-only trees: QT or none)
};

static int implicit_split(const Ctx& c, int x, int y, int w, int h,
                          int max_btd) {
    bool right_ok = c.fw >= x + w, bottom_ok = c.fh >= y + h;
    if (right_ok && bottom_ok) return NO_SPLIT;
    if (right_ok && max_btd) return BT_HOR;
    if (bottom_ok && max_btd) return BT_VER;
    return QT_SPLIT;
}

// cu.c:412-513 (tree_type 0, I-slice index 0)
static bool possible_splits(const Ctx& c, int x, int y, int w, int h,
                            const SplitState& st, bool can[6]) {
    int max_btd = c.max_btt_depth + st.implicit_mtt;
    int max_bt = c.max_bt_size, min_bt = 4;
    int max_tt = c.max_tt_size, min_tt = 4;
    int min_qt = c.min_qt_size;
    int impl = implicit_split(c, x, y, w, h, max_btd);
    for (int i = 0; i < 6; ++i) can[i] = true;
    bool can_btt = st.mtt_depth < max_btd;
    int last = st.last;
    int parl = (last == TT_HOR) ? BT_HOR : BT_VER;

    if (st.depth != 0 && last != QT_SPLIT) can[QT_SPLIT] = false;
    if (w <= min_qt) can[QT_SPLIT] = false;

    if (impl != NO_SPLIT) {
        can[NO_SPLIT] = can[TT_HOR] = can[TT_VER] = false;
        can[BT_HOR] = (impl == BT_HOR) && h <= max_bt;
        can[BT_VER] = (impl == BT_VER) && w <= max_bt;
        if (!can[BT_HOR] && !can[BT_VER] && !can[QT_SPLIT])
            can[QT_SPLIT] = true;
        return true;
    }

    if ((last == TT_HOR || last == TT_VER) && st.part_index == 1) {
        can[BT_HOR] = parl != BT_HOR;
        can[BT_VER] = parl != BT_VER;
    }
    if (can_btt && (w <= min_bt && h <= min_bt) && (w <= min_tt && h <= min_tt))
        can_btt = false;
    if (can_btt && (w > max_bt || h > max_bt) && (w > max_tt || h > max_tt))
        can_btt = false;
    if (!can_btt) {
        can[BT_HOR] = can[TT_HOR] = can[BT_VER] = can[TT_VER] = false;
        return false;
    }
    if (w > max_bt || h > max_bt) can[BT_HOR] = can[BT_VER] = false;
    if (h <= min_bt) can[BT_HOR] = false;
    if (w > 64 && h <= 64) can[BT_HOR] = false;
    if (w <= min_bt) can[BT_VER] = false;
    if (w <= 64 && h > 64) can[BT_VER] = false;
    if (h <= 2 * min_tt || h > max_tt || w > max_tt) can[TT_HOR] = false;
    if (w > 64 || h > 64) can[TT_HOR] = false;
    if (w <= 2 * min_tt || w > max_tt || h > max_tt) can[TT_VER] = false;
    if (w > 64 || h > 64) can[TT_VER] = false;
    return false;
}

static int split_flag_ctx(const Ctx& c, int x, int y, int w, int h,
                          const bool can[6]) {
    int l = at4(c, x - 1, y), a = at4(c, x, y - 1);
    int m = 0;
    if (l >= 0 && (1 << c.log2h4[l]) < h) m += 1;
    if (a >= 0 && (1 << c.log2w4[a]) < w) m += 1;
    int split_num = 0;
    if (can[QT_SPLIT]) split_num += 2;
    if (can[BT_HOR]) split_num += 1;
    if (can[BT_VER]) split_num += 1;
    if (can[TT_HOR]) split_num += 1;
    if (can[TT_VER]) split_num += 1;
    if (split_num > 0) split_num -= 1;
    m += 3 * (split_num >> 1);
    return m;
}

static int qt_split_ctx(const Ctx& c, int x, int y, const SplitState& st) {
    int l = at4(c, x - 1, y), a = at4(c, x, y - 1);
    int left_qt = (l >= 0) ? c.qtd4[l] : 0;
    int top_qt = (a >= 0) ? c.qtd4[a] : 0;
    return ((l >= 0 && left_qt > st.depth) ? 1 : 0)
         + ((a >= 0 && top_qt > st.depth) ? 1 : 0)
         + (st.depth < 2 ? 0 : 3);
}

// QT-only subset of write_split_flag (non-QT branches never taken here)
static bool write_split_flag(Ctx& c, int x, int y, int w, int h,
                             const SplitState& st, int split) {
    bool can[6];
    bool is_implicit = possible_splits(c, x, y, w, h, st, can);
    bool allow_split = can[1] || can[2] || can[3] || can[4] || can[5];
    if (can[NO_SPLIT] && allow_split) {
        int m = split_flag_ctx(c, x, y, w, h, can);
        ec_bin(c.ec, g_off.split_flag + m, split != NO_SPLIT ? 1 : 0);
    }
    bool btt_any = can[BT_HOR] || can[BT_VER] || can[TT_HOR] || can[TT_VER];
    if ((!is_implicit || (can[QT_SPLIT] && (can[BT_HOR] || can[BT_VER])))
        && btt_any && split != NO_SPLIT) {
        if (btt_any && can[QT_SPLIT]) {
            int m = qt_split_ctx(c, x, y, st);
            ec_bin(c.ec, g_off.qt_split_flag + m, split == QT_SPLIT ? 1 : 0);
        }
        // split is always QT in this path; the mtt flags are never written
    }
    return is_implicit;
}

// --- intra mode -----------------------------------------------------------

static void mpm_predictors(const Ctx& c, int x, int y, int w, int h,
                           int preds[6]) {
    const int PLANAR = 0, DC = 1, HOR = 18, VER = 50;
    int l = (x > 0) ? at4(c, x - 1, y + h - 1) : -1;
    int a = (y % kLcu > 0 && y > 0) ? at4(c, x + w - 1, y - 1) : -1;
    int left_dir = (l >= 0) ? c.mode4[l] : 0;
    int above_dir = (a >= 0 && (y % kLcu) != 0) ? c.mode4[a] : 0;
    const int offset = 61, mod = 64;
    int d0[6] = {PLANAR, DC, VER, HOR, VER - 4, VER + 4};
    memcpy(preds, d0, sizeof(d0));
    if (left_dir == above_dir) {
        if (left_dir > DC) {
            preds[0] = PLANAR;
            preds[1] = left_dir;
            preds[2] = ((left_dir + offset) % mod) + 2;
            preds[3] = ((left_dir - 1) % mod) + 2;
            preds[4] = ((left_dir + offset - 1) % mod) + 2;
            preds[5] = (left_dir % mod) + 2;
        }
    } else {
        if (left_dir > DC && above_dir > DC) {
            preds[0] = PLANAR; preds[1] = left_dir; preds[2] = above_dir;
            int mx = preds[1] > preds[2] ? 1 : 2;
            int mn = preds[1] > preds[2] ? 2 : 1;
            int d = preds[mx] - preds[mn];
            if (d == 1) {
                preds[3] = ((preds[mn] + offset) % mod) + 2;
                preds[4] = ((preds[mx] - 1) % mod) + 2;
                preds[5] = ((preds[mn] + offset - 1) % mod) + 2;
            } else if (d >= 62) {
                preds[3] = ((preds[mn] - 1) % mod) + 2;
                preds[4] = ((preds[mx] + offset) % mod) + 2;
                preds[5] = (preds[mn] % mod) + 2;
            } else if (d == 2) {
                preds[3] = ((preds[mn] - 1) % mod) + 2;
                preds[4] = ((preds[mn] + offset) % mod) + 2;
                preds[5] = ((preds[mx] - 1) % mod) + 2;
            } else {
                preds[3] = ((preds[mn] + offset) % mod) + 2;
                preds[4] = ((preds[mn] - 1) % mod) + 2;
                preds[5] = ((preds[mx] + offset) % mod) + 2;
            }
        } else if (left_dir + above_dir >= 2) {
            int m = left_dir < above_dir ? above_dir : left_dir;
            preds[0] = PLANAR;
            preds[1] = m;
            preds[2] = ((m + offset) % mod) + 2;
            preds[3] = ((m - 1) % mod) + 2;
            preds[4] = ((m + offset - 1) % mod) + 2;
            preds[5] = (m % mod) + 2;
        }
    }
}

static void write_intra_luma_mode(Ctx& c, const Leaf& lf) {
    int preds[6];
    mpm_predictors(c, lf.x, lf.y, lf.w, lf.h, preds);
    int mpm_idx = -1;
    for (int i = 0; i < 6; ++i)
        if (preds[i] == lf.mode) { mpm_idx = i; break; }
    ec_bin(c.ec, g_off.mpm_flag, mpm_idx >= 0 ? 1 : 0);
    if (mpm_idx >= 0) {
        ec_bin(c.ec, g_off.luma_planar + 1, mpm_idx > 0 ? 1 : 0);
        for (int i = 1; i < 5; ++i) {
            if (mpm_idx > i - 1) ec_bin_ep(c.ec, mpm_idx > i ? 1 : 0);
            else break;
        }
    } else {
        // rank after removing sorted MPM set
        int sorted[6];
        memcpy(sorted, preds, sizeof(sorted));
        for (int i = 1; i < 6; ++i)
            for (int j = i; j > 0 && sorted[j] < sorted[j - 1]; --j) {
                int t = sorted[j]; sorted[j] = sorted[j - 1];
                sorted[j - 1] = t;
            }
        int tmp = lf.mode;
        for (int i = 5; i >= 0; --i)
            if (tmp > sorted[i]) tmp -= 1;
        ec_trunc_bin(c.ec, (uint32_t)tmp, 67 - 6);
    }
}

static void write_chroma_mode(Ctx& c, const Leaf& lf) {
    const int base[4] = {0, 50, 18, 1};
    int luma = lf.mode, chroma = lf.mode_c;
    bool derived = chroma == luma;
    ec_bin(c.ec, g_off.chroma_pred, derived ? 0 : 1);
    if (!derived) {
        int pred_mode = -1;
        for (int i = 0; i < 4; ++i) {
            int m = (base[i] != luma) ? base[i] : 66;
            if (m == chroma) { pred_mode = i; break; }
        }
        ec_bins_ep(c.ec, (uint32_t)pred_mode, 2);
    }
}

// --- leaf / residual ------------------------------------------------------

static int ilog2(int v) { int r = 0; while (v > 1) { v >>= 1; ++r; } return r; }

static void write_leaf(Ctx& c, const Leaf& lf, int luma_cbf_ctx_unused) {
    (void)luma_cbf_ctx_unused;
    write_intra_luma_mode(c, lf);
    if (c.has_chroma) write_chroma_mode(c, lf);

    // implicit transform split for CUs larger than the 32x32 max TU:
    // per-TU cbf flags arrive bit-packed from recon.cpp (bit t = TU t in
    // raster order), coeff planes hold consecutive TU blocks. The luma
    // cbf context stays 0 for split TUs (encode_transform_coeff keeps
    // luma_cbf_ctx untouched when !pu_is_tu).
    const int kMaxTu = 32;
    const int tn_x = lf.w > kMaxTu ? lf.w / kMaxTu : 1;
    const int tn_y = lf.h > kMaxTu ? lf.h / kMaxTu : 1;
    const int tw = lf.w < kMaxTu ? lf.w : kMaxTu;
    const int th = lf.h < kMaxTu ? lf.h : kMaxTu;
    const int32_t* cbf = c.cbf + 3 * c.cur;
    const int lw = ilog2(tw);
    for (int t = 0; t < tn_x * tn_y; ++t) {
        int cbf_y = (cbf[0] >> t) & 1;
        int cbf_u = c.has_chroma ? (cbf[1] >> t) & 1 : 0;
        int cbf_v = c.has_chroma ? (cbf[2] >> t) & 1 : 0;
        if (c.has_chroma) {
            ec_bin(c.ec, g_off.cbf_cb, cbf_u);
            ec_bin(c.ec, g_off.cbf_cr + (cbf_u ? 1 : 0), cbf_v);
        }
        ec_bin(c.ec, g_off.cbf_luma + 0, cbf_y);

        if (cbf_y) {
            ec_coeff_nxn(c.ec, c.coeff_y + c.off_y, tw, th, 1, c.dep_quant,
                         c.signhide, g_scan[lw],
                         g_scan_cg[lw], 2, 2);
        }
        c.off_y += (int64_t)tw * th;
        if (c.has_chroma) {
            int cw = tw >> 1, ch = th >> 1;
            int lcw = ilog2(cw);
            if (cbf_u)
                ec_coeff_nxn(c.ec, c.coeff_u + c.off_c, cw, ch, 0,
                             c.dep_quant, c.signhide, g_scan[lcw],
                             g_scan_cg[lcw], 2, 2);
            if (cbf_v)
                ec_coeff_nxn(c.ec, c.coeff_v + c.off_c, cw, ch, 0,
                             c.dep_quant, c.signhide, g_scan[lcw],
                             g_scan_cg[lcw], 2, 2);
            c.off_c += (int64_t)cw * ch;
        }
    }

    // register in the 4x4 maps
    int lgw = ilog2(lf.w), lgh = ilog2(lf.h);
    for (int yy = lf.y >> 2; yy < (lf.y + lf.h) >> 2; ++yy)
        for (int xx = lf.x >> 2; xx < (lf.x + lf.w) >> 2; ++xx) {
            int i = yy * c.gw4 + xx;
            c.coded[i] = 1;
            c.mode4[i] = (int16_t)lf.mode;
            c.log2w4[i] = (int8_t)lgw;
            c.log2h4[i] = (int8_t)lgh;
            c.intra4[i] = 1;
        }
}

// --- inter CU syntax (P/B slices) ------------------------------------------
// Mirrors hls/coding_tree.py _encode_cu inter arms / encode_mvd /
// encode_merge_idx (which cite encode_coding_tree.c:1471-1528, :1865,
// :1499-1513).

static void write_merge_idx(Ctx& c, int merge_idx) {
    if (c.max_merge <= 1) return;
    for (int ui = 0; ui < c.max_merge - 1; ++ui) {
        int symbol = (ui != merge_idx) ? 1 : 0;
        if (ui == 0) ec_bin(c.ec, g_off.merge_idx, symbol);
        else ec_bin_ep(c.ec, symbol);
        if (!symbol) break;
    }
}

static void write_mvd(Ctx& c, int mvd_hor, int mvd_ver) {
    int h0 = mvd_hor != 0, v0 = mvd_ver != 0;
    ec_bin(c.ec, g_off.mvd, h0);
    ec_bin(c.ec, g_off.mvd, v0);
    uint32_t ah = (uint32_t)(mvd_hor < 0 ? -mvd_hor : mvd_hor);
    uint32_t av = (uint32_t)(mvd_ver < 0 ? -mvd_ver : mvd_ver);
    if (h0) ec_bin(c.ec, g_off.mvd + 1, ah > 1 ? 1 : 0);
    if (v0) ec_bin(c.ec, g_off.mvd + 1, av > 1 ? 1 : 0);
    if (h0) {
        if (ah > 1) ec_ep_ex_golomb(c.ec, ah - 2, 1);
        ec_bin_ep(c.ec, mvd_hor > 0 ? 0 : 1);
    }
    if (v0) {
        if (av > 1) ec_ep_ex_golomb(c.ec, av - 2, 1);
        ec_bin_ep(c.ec, mvd_ver > 0 ? 0 : 1);
    }
}

// transform coeff for an inter leaf: chroma cbfs, conditionally-signaled
// luma cbf (inferred 1 for a single-TU inter CU with no chroma cbf),
// residual blocks (encode_transform_coeff, coding_tree.py:649-724)
static void write_inter_tu(Ctx& c, const LeafEx& lf) {
    const int kMaxTu = 32;
    const int tn_x = lf.w > kMaxTu ? lf.w / kMaxTu : 1;
    const int tn_y = lf.h > kMaxTu ? lf.h / kMaxTu : 1;
    const int tw = lf.w < kMaxTu ? lf.w : kMaxTu;
    const int th = lf.h < kMaxTu ? lf.h : kMaxTu;
    const int32_t* cbf = c.cbf + 3 * c.cur;
    const int lw = ilog2(tw);
    const bool pu_is_tu = tn_x * tn_y == 1;
    int luma_cbf_ctx = 0;
    for (int t = 0; t < tn_x * tn_y; ++t) {
        int cbf_y = (cbf[0] >> t) & 1;
        int cbf_u = c.has_chroma ? (cbf[1] >> t) & 1 : 0;
        int cbf_v = c.has_chroma ? (cbf[2] >> t) & 1 : 0;
        if (c.has_chroma) {
            ec_bin(c.ec, g_off.cbf_cb, cbf_u);
            ec_bin(c.ec, g_off.cbf_cr + (cbf_u ? 1 : 0), cbf_v);
        }
        if (!pu_is_tu || cbf_u || cbf_v) {
            ec_bin(c.ec, g_off.cbf_luma + luma_cbf_ctx, cbf_y);
            // ctx updates only when pu_is_tu (never here with >1 TU)
        }
        // else: single-TU inter with no chroma cbf -> luma cbf inferred 1
        if (cbf_y)
            ec_coeff_nxn(c.ec, c.coeff_y + c.off_y, tw, th, 1, c.dep_quant,
                         c.signhide, g_scan[lw], g_scan_cg[lw], 2, 2);
        c.off_y += (int64_t)tw * th;
        if (c.has_chroma) {
            int cw = tw >> 1, ch = th >> 1;
            int lcw = ilog2(cw);
            if (cbf_u)
                ec_coeff_nxn(c.ec, c.coeff_u + c.off_c, cw, ch, 0,
                             c.dep_quant, c.signhide, g_scan[lcw],
                             g_scan_cg[lcw], 2, 2);
            if (cbf_v)
                ec_coeff_nxn(c.ec, c.coeff_v + c.off_c, cw, ch, 0,
                             c.dep_quant, c.signhide, g_scan[lcw],
                             g_scan_cg[lcw], 2, 2);
            c.off_c += (int64_t)cw * ch;
        }
    }
}

static void register_leaf_ex(Ctx& c, const LeafEx& lf) {
    int lgw = ilog2(lf.w), lgh = ilog2(lf.h);
    bool is_intra = lf.type == 1;
    for (int yy = lf.y >> 2; yy < (lf.y + lf.h) >> 2; ++yy)
        for (int xx = lf.x >> 2; xx < (lf.x + lf.w) >> 2; ++xx) {
            int i = yy * c.gw4 + xx;
            c.coded[i] = 1;
            c.mode4[i] = is_intra ? (int16_t)lf.mode : 0;
            c.log2w4[i] = (int8_t)lgw;
            c.log2h4[i] = (int8_t)lgh;
            c.skip4[i] = (uint8_t)lf.skipped;
            c.intra4[i] = is_intra ? 1 : 0;
        }
}

// advance the packed-coeff cursors over one leaf without writing
static void skip_leaf_coeffs(Ctx& c, const LeafEx& lf) {
    c.off_y += (int64_t)lf.w * lf.h;
    if (c.has_chroma) c.off_c += (int64_t)(lf.w >> 1) * (lf.h >> 1);
}

// full CU syntax for a P/B-slice leaf (intra or inter)
static void write_leaf_ex(Ctx& c, const LeafEx& lf) {
    int l = at4(c, lf.x - 1, lf.y), a = at4(c, lf.x, lf.y - 1);
    // cu_skip_flag (w,h >= 8 in the lattice so always coded in P/B)
    int ctx_skip = ((l >= 0 && c.skip4[l]) ? 1 : 0)
                 + ((a >= 0 && c.skip4[a]) ? 1 : 0);
    ec_bin(c.ec, g_off.cu_skip + ctx_skip, lf.skipped ? 1 : 0);
    if (lf.skipped) {
        write_merge_idx(c, lf.merge_idx);
        register_leaf_ex(c, lf);
        skip_leaf_coeffs(c, lf);
        return;
    }
    int ctx_pm = ((l >= 0 && c.intra4[l]) || (a >= 0 && c.intra4[a])) ? 1 : 0;
    ec_bin(c.ec, g_off.cu_pred_mode + ctx_pm, lf.type == 1 ? 1 : 0);
    if (lf.type == 1) {
        // intra CU in a P/B slice: identical leaf syntax to the I-slice
        // writer (write_leaf registers the 4x4 maps itself)
        Leaf b{lf.x, lf.y, lf.w, lf.h, lf.mode, lf.mode_c};
        write_leaf(c, b, 0);
        // write_leaf sets mode/intra maps; add the skip map
        for (int yy = lf.y >> 2; yy < (lf.y + lf.h) >> 2; ++yy)
            for (int xx = lf.x >> 2; xx < (lf.x + lf.w) >> 2; ++xx)
                c.skip4[yy * c.gw4 + xx] = 0;
        return;
    }
    // inter PU
    ec_bin(c.ec, g_off.merge_flag, lf.merged ? 1 : 0);
    if (lf.merged) {
        write_merge_idx(c, lf.merge_idx);
    } else {
        if (c.is_b) {
            if (lf.w + lf.h > 12) {
                int ctx = 7 - ((ilog2(lf.w) + ilog2(lf.h) + 1) >> 1);
                ec_bin(c.ec, g_off.inter_dir + ctx, lf.mv_dir == 3 ? 1 : 0);
            }
            if (lf.mv_dir < 3)
                ec_bin(c.ec, g_off.inter_dir + 5, lf.mv_dir == 2 ? 1 : 0);
        }
        for (int li = 0; li < 2; ++li) {
            if (!(lf.mv_dir & (1 << li))) continue;
            int nref = li == 0 ? c.nref0 : c.nref1;
            if (nref > 1) {
                int ref = lf.ref[li];
                ec_bin(c.ec, g_off.ref_pic, ref != 0 ? 1 : 0);
                if (ref > 0 && nref > 2) {
                    ec_bin(c.ec, g_off.ref_pic + 1, ref > 1 ? 1 : 0);
                    if (ref > 1 && nref > 3)
                        for (int idx = 3; idx < nref; ++idx) {
                            int val = ref > idx - 1 ? 1 : 0;
                            ec_bin_ep(c.ec, val);
                            if (!val) break;
                        }
                }
            }
            write_mvd(c, lf.mvd[li][0], lf.mvd[li][1]);
            ec_bin(c.ec, g_off.mvp_idx, lf.mvp[li]);
        }
    }
    // AMVR: quarter-pel always selected (imv_flag 0) when signalable
    if (c.amvr && !lf.merged) {
        bool any_mvd = false;
        for (int li = 0; li < 2; ++li)
            if ((lf.mv_dir & (1 << li))
                && (lf.mvd[li][0] != 0 || lf.mvd[li][1] != 0))
                any_mvd = true;
        if (any_mvd) ec_bin(c.ec, g_off.imv_flag, 0);
    }
    const int32_t* cbf = c.cbf + 3 * c.cur;
    bool has_coeffs = cbf[0] != 0 || cbf[1] != 0 || cbf[2] != 0;
    if (!lf.merged) ec_bin(c.ec, g_off.root_cbf, has_coeffs ? 1 : 0);
    if (has_coeffs || lf.merged) {
        write_inter_tu(c, lf);
    } else {
        skip_leaf_coeffs(c, lf);
    }
    register_leaf_ex(c, lf);
}

static void encode_node(Ctx& c, int x, int y, int s, const SplitState& st) {
    if (x >= c.fw || y >= c.fh) return;
    // leaf here iff the leaf map says a CU of exactly this size starts here
    int li = c.leaf_at[(y >> 2) * c.gw4 + (x >> 2)];
    const int32_t* lp = li >= 0 ? lf_raw(c, li) : nullptr;
    bool is_leaf = li >= 0 && lp[0] == x && lp[1] == y && lp[2] == s;
    int split = is_leaf ? NO_SPLIT : QT_SPLIT;
    bool is_implicit = false;
    if (s + s > 8)
        is_implicit = write_split_flag(c, x, y, s, s, st, split);
    if (split == QT_SPLIT) {
        int hs = s >> 1;
        int k = 0;
        const int dx[4] = {0, 1, 0, 1}, dy[4] = {0, 0, 1, 1};
        for (int i = 0; i < 4; ++i) {
            int sx = x + dx[i] * hs, sy = y + dy[i] * hs;
            if (sx >= c.fw || sy >= c.fh) { ++k; continue; }
            SplitState cst;
            cst.depth = st.depth + 1;
            cst.mtt_depth = st.mtt_depth;            // QT keeps mtt depth
            cst.implicit_mtt = st.implicit_mtt;      // (never BT implicit)
            cst.part_index = k++;
            cst.last = QT_SPLIT;
            encode_node(c, sx, sy, hs, cst);
        }
        return;
    }
    // leaf: qt depth for neighbors' qt_split ctx
    for (int yy = y >> 2; yy < (y + s) >> 2; ++yy)
        for (int xx = x >> 2; xx < (x + s) >> 2; ++xx)
            c.qtd4[yy * c.gw4 + xx] = (int8_t)st.depth;
    if (c.stride >= 20) {
        const LeafEx* le = reinterpret_cast<const LeafEx*>(lf_raw(c, c.cur));
        if (c.is_intra_slice) {
            Leaf b{le->x, le->y, le->w, le->h, le->mode, le->mode_c};
            write_leaf(c, b, 0);
        } else {
            write_leaf_ex(c, *le);
        }
    } else {
        write_leaf(c, lf_basic(c, c.cur), 0);
    }
    c.cur += 1;
}

// --- SAO ------------------------------------------------------------------

static void write_sao_color(Ctx& c, const int32_t* offsets, int type,
                            int eo_class, int band_pos, int color,
                            int abs_omax) {
    int off_base = (color == 2) ? 5 : 0;
    if (color != 2) {
        ec_bin(c.ec, g_off.sao_type, type != 0 ? 1 : 0);
        if (type == 1) ec_bin_ep(c.ec, 0);       // band
        else if (type == 2) ec_bin_ep(c.ec, 1);  // edge
    }
    if (type == 0) return;
    for (int cat = 1; cat < 5; ++cat) {
        int v = offsets[off_base + cat];
        ec_unary_max_ep(c.ec, (uint32_t)(v < 0 ? -v : v), abs_omax);
    }
    if (type == 1) {
        for (int cat = 1; cat < 5; ++cat)
            if (offsets[off_base + cat] != 0)
                ec_bin_ep(c.ec, offsets[off_base + cat] < 0 ? 1 : 0);
        ec_bins_ep(c.ec, (uint32_t)band_pos, 5);
    } else if (color != 2) {
        ec_bins_ep(c.ec, (uint32_t)eo_class, 2);
    }
}

}  // namespace

extern "C" {

void tw_set_offsets(const int32_t* o) {
    int i = 0;
    g_off.split_flag = o[i++];
    g_off.qt_split_flag = o[i++];
    g_off.mtt_vertical = o[i++];
    g_off.mtt_binary = o[i++];
    g_off.mpm_flag = o[i++];
    g_off.luma_planar = o[i++];
    g_off.chroma_pred = o[i++];
    g_off.cbf_cb = o[i++];
    g_off.cbf_cr = o[i++];
    g_off.cbf_luma = o[i++];
    g_off.sao_merge = o[i++];
    g_off.sao_type = o[i++];
    g_off.cu_skip = o[i++];
    g_off.cu_pred_mode = o[i++];
    g_off.merge_flag = o[i++];
    g_off.merge_idx = o[i++];
    g_off.inter_dir = o[i++];
    g_off.ref_pic = o[i++];
    g_off.mvp_idx = o[i++];
    g_off.root_cbf = o[i++];
    g_off.imv_flag = o[i++];
    g_off.mvd = o[i++];
}

void tw_set_scan(int log2, const int32_t* scan, const int32_t* scan_cg) {
    g_scan[log2] = scan;
    g_scan_cg[log2] = scan_cg;
}

// Writes SAO + coding tree for every CTU of an all-intra frame.
// leaves: [n,6] int32 (x,y,w,h,mode,mode_c) in coding (z-scan) order;
// cbf: [n,3]; coeff planes packed in leaf order (recon.cpp layout);
// sao_*: per-CTU arrays (raster), or sao_type_l == nullptr for SAO off.
static void frame_body(
    Ctx& c, void** row_ecs, const int32_t* sao_type_l,
    const int32_t* sao_eo_l, const int32_t* sao_bp_l,
    const int32_t* sao_off_l, const int32_t* sao_type_c,
    const int32_t* sao_eo_c, const int32_t* sao_bp_c,
    const int32_t* sao_off_c, const int32_t* sao_merge, int abs_omax) {
    int wl = (c.fw + kLcu - 1) / kLcu, hl = (c.fh + kLcu - 1) / kLcu;
    int has_chroma = c.has_chroma;
    int nctx = row_ecs ? ec_ctx_count(row_ecs[0]) : 0;
    std::vector<uint16_t> snap0(nctx), snap1(nctx);
    for (int cy = 0; cy < hl; ++cy) {
        if (row_ecs) {
            c.ec = row_ecs[cy];
            // WPP: inherit contexts from the state after the first CTU
            // of the row above (encoderstate.c:966-975)
            if (cy > 0)
                ec_set_states(c.ec, snap0.data(), snap1.data());
        }
        for (int cx = 0; cx < wl; ++cx) {
            int ci = cy * wl + cx;
            if (sao_type_l) {
                int merge_left = sao_merge[2 * ci];
                int merge_up = sao_merge[2 * ci + 1];
                if (cx > 0) ec_bin(c.ec, g_off.sao_merge, merge_left);
                if (cy > 0 && !merge_left)
                    ec_bin(c.ec, g_off.sao_merge, merge_up);
                if (!merge_left && !merge_up) {
                    write_sao_color(c, sao_off_l + 10 * ci, sao_type_l[ci],
                                    sao_eo_l[ci], sao_bp_l[2 * ci], 0,
                                    abs_omax);
                    if (has_chroma) {
                        write_sao_color(c, sao_off_c + 10 * ci,
                                        sao_type_c[ci], sao_eo_c[ci],
                                        sao_bp_c[2 * ci], 1, abs_omax);
                        write_sao_color(c, sao_off_c + 10 * ci,
                                        sao_type_c[ci], sao_eo_c[ci],
                                        sao_bp_c[2 * ci + 1], 2, abs_omax);
                    }
                }
            }
            SplitState st;
            encode_node(c, cx * kLcu, cy * kLcu, kLcu, st);
            if (row_ecs && cx == 0)
                ec_get_contexts(c.ec, snap0.data(), snap1.data());
        }
    }
}

static void setup_frame_ctx(
    Ctx& c, void* ec, const int32_t* leaves, int n_leaves,
    const int32_t* cbf, const int32_t* coeff_y, const int32_t* coeff_u,
    const int32_t* coeff_v, int fw, int fh, int has_chroma, int signhide,
    int dep_quant, int min_qt_size, int max_bt_size, int max_tt_size,
    int max_btt_depth, int stride = 6) {
    c.ec = ec;
    c.leaves = leaves;
    c.stride = stride;
    c.cbf = cbf;
    c.coeff_y = coeff_y;
    c.coeff_u = coeff_u;
    c.coeff_v = coeff_v;
    c.fw = fw; c.fh = fh;
    c.has_chroma = has_chroma;
    c.signhide = signhide;
    c.dep_quant = dep_quant;
    c.min_qt_size = min_qt_size;
    c.max_bt_size = max_bt_size;
    c.max_tt_size = max_tt_size;
    c.max_btt_depth = max_btt_depth;
    c.gw4 = (fw + 3) >> 2;
    c.gh4 = (fh + 3) >> 2;
    c.coded.assign((size_t)c.gw4 * c.gh4, 0);
    c.mode4.assign((size_t)c.gw4 * c.gh4, 0);
    c.log2w4.assign((size_t)c.gw4 * c.gh4, 0);
    c.log2h4.assign((size_t)c.gw4 * c.gh4, 0);
    c.qtd4.assign((size_t)c.gw4 * c.gh4, 0);
    c.skip4.assign((size_t)c.gw4 * c.gh4, 0);
    c.intra4.assign((size_t)c.gw4 * c.gh4, 0);
    c.leaf_at.assign((size_t)c.gw4 * c.gh4, -1);
    c.cur = 0;
    c.off_y = 0;
    c.off_c = 0;
    for (int i = 0; i < n_leaves; ++i) {
        Leaf lf = lf_basic(c, i);
        for (int yy = lf.y >> 2; yy < (lf.y + lf.h) >> 2 && yy < c.gh4; ++yy)
            for (int xx = lf.x >> 2; xx < (lf.x + lf.w) >> 2 && xx < c.gw4;
                 ++xx)
                c.leaf_at[yy * c.gw4 + xx] = i;
    }
}

void tw_write_intra_frame(
    void* ec, const int32_t* leaves, int n_leaves, const int32_t* cbf,
    const int32_t* coeff_y, const int32_t* coeff_u, const int32_t* coeff_v,
    int fw, int fh, int has_chroma, int signhide, int dep_quant,
    int min_qt_size, int max_bt_size, int max_tt_size, int max_btt_depth,
    const int32_t* sao_type_l, const int32_t* sao_eo_l,
    const int32_t* sao_bp_l, const int32_t* sao_off_l,
    const int32_t* sao_type_c, const int32_t* sao_eo_c,
    const int32_t* sao_bp_c, const int32_t* sao_off_c,
    const int32_t* sao_merge, int abs_omax) {
    Ctx c;
    setup_frame_ctx(c, ec, leaves, n_leaves, cbf, coeff_y, coeff_u,
                    coeff_v, fw, fh, has_chroma, signhide, dep_quant,
                    min_qt_size, max_bt_size, max_tt_size, max_btt_depth);
    frame_body(c, nullptr, sao_type_l, sao_eo_l, sao_bp_l, sao_off_l,
               sao_type_c, sao_eo_c, sao_bp_c, sao_off_c, sao_merge,
               abs_omax);
}

// WPP: one CABAC substream per CTU row, contexts inherited from the
// state after the first CTU of the row above. ecs: one engine handle
// per row (already initialized by the caller); termination and byte
// extraction stay on the caller side.
void tw_write_intra_wpp(
    void** ecs, int n_rows, const int32_t* leaves, int n_leaves,
    const int32_t* cbf, const int32_t* coeff_y, const int32_t* coeff_u,
    const int32_t* coeff_v,
    int fw, int fh, int has_chroma, int signhide, int dep_quant,
    int min_qt_size, int max_bt_size, int max_tt_size, int max_btt_depth,
    const int32_t* sao_type_l, const int32_t* sao_eo_l,
    const int32_t* sao_bp_l, const int32_t* sao_off_l,
    const int32_t* sao_type_c, const int32_t* sao_eo_c,
    const int32_t* sao_bp_c, const int32_t* sao_off_c,
    const int32_t* sao_merge, int abs_omax) {
    (void)n_rows;
    Ctx c;
    setup_frame_ctx(c, ecs[0], leaves, n_leaves, cbf, coeff_y, coeff_u,
                    coeff_v, fw, fh, has_chroma, signhide, dep_quant,
                    min_qt_size, max_bt_size, max_tt_size, max_btt_depth);
    frame_body(c, ecs, sao_type_l, sao_eo_l, sao_bp_l, sao_off_l,
               sao_type_c, sao_eo_c, sao_bp_c, sao_off_c, sao_merge,
               abs_omax);
}

// P/B-frame writer: extended 20-int32 leaves (intra + inter CUs with
// skip/merge/mvd/AMVP syntax). ecs: nullptr-terminated only via n_rows;
// pass n_rows=1 and row_mode=0 for a single-substream frame, or one
// engine per CTU row with row_mode=1 for WPP.
void tw_write_frame(
    void** ecs, int n_rows, int row_mode,
    const int32_t* leaves, int n_leaves, const int32_t* cbf,
    const int32_t* coeff_y, const int32_t* coeff_u, const int32_t* coeff_v,
    int fw, int fh, int has_chroma, int signhide, int dep_quant,
    int min_qt_size, int max_bt_size, int max_tt_size, int max_btt_depth,
    int is_intra_slice, int is_b, int nref0, int nref1, int max_merge,
    int amvr,
    const int32_t* sao_type_l, const int32_t* sao_eo_l,
    const int32_t* sao_bp_l, const int32_t* sao_off_l,
    const int32_t* sao_type_c, const int32_t* sao_eo_c,
    const int32_t* sao_bp_c, const int32_t* sao_off_c,
    const int32_t* sao_merge, int abs_omax) {
    (void)n_rows;
    Ctx c;
    setup_frame_ctx(c, ecs[0], leaves, n_leaves, cbf, coeff_y, coeff_u,
                    coeff_v, fw, fh, has_chroma, signhide, dep_quant,
                    min_qt_size, max_bt_size, max_tt_size, max_btt_depth,
                    /*stride=*/20);
    c.is_intra_slice = is_intra_slice;
    c.is_b = is_b;
    c.nref0 = nref0;
    c.nref1 = nref1;
    c.max_merge = max_merge;
    c.amvr = amvr;
    frame_body(c, row_mode ? ecs : nullptr, sao_type_l, sao_eo_l, sao_bp_l,
               sao_off_l, sao_type_c, sao_eo_c, sao_bp_c, sao_off_c,
               sao_merge, abs_omax);
}

}  // extern "C"

// Shared native reconstruction helpers (defined in recon.cpp).
//
// recon.cpp owns the intra prediction + DCT2/quant round-trip used by the
// all-intra whole-frame recon (rc_recon_frame); inter.cpp reuses them for
// the intra CUs inside P/B frames (whole-frame inter finalize).
#pragma once

#include <cstdint>

namespace rcn {

constexpr int REF_MAX = 3 * 64 + 3;

struct Refs {
    int32_t top[REF_MAX];
    int32_t left[REF_MAX];
    int32_t ftop[REF_MAX];
    int32_t fleft[REF_MAX];
    bool filtered_done = false;
    void make_filtered(int w, int h);
};

// ops/intra.py build_reference parity (intra.c uvg_intra_build_reference)
void build_reference(const int32_t* plane, int stride,
                     const uint8_t* mask, int mask_w, int mask_h,
                     int x, int y, int w, int h, int pic_w, int pic_h,
                     int bd, bool is_chroma, Refs* refs, bool wpp);

// ops/intra.py predict_intra parity (strategies/generic/intra-generic.c)
void predict_intra(int mode, int w, int h, Refs* refs, int bd,
                   bool is_chroma, int32_t* out);

// grouped diagonal scan tables indexed by [log2(w)-2][log2(h)-2]
extern int32_t g_scan[4][4][32 * 32];

// ops/rdoq.py rdoq_levels, level for level (rdoq.cpp): h x w levels into
// out and 0, or 1 where numpy has to decide (out untouched)
int rdoq_levels(const int32_t* coef, int w, int h, int qp_scaled, int bd,
                double lam, int32_t* out);

// whether rdoq_levels decides every int16 block of this shape and QP
bool rdoq_covers(int w, int h, int qp_scaled, int bd);

// DCT2 fwd + quant + dequant + inverse round-trip for one TU; returns cbf
// (quant-generic.c uvg_quantize_residual). is_intra_slice selects the
// 171/85 rounding offset. rdoq_lam > 0 takes the levels from rdoq_levels,
// then sign hiding (control/encoder.py transform_quant_recon); the caller
// checks rdoq_covers first. 0 is the scalar quantiser.
int transform_quant_recon(const int32_t* src, const int32_t* pred,
                          int w, int h, int qp, int bd, bool is_intra_slice,
                          bool signhide, int32_t* coeff_out, int32_t* rec,
                          double rdoq_lam);

// rd-cost roundtrip of one prediction (ops/rd_cost.py
// make_rd_cost_pred_fn mirror): DCT2 + quant + bucket bits + dequant +
// IDCT2 + SSD. wts: 4 bucket weights; rec: w*h scratch.
void rd_roundtrip(const int32_t* src, const int32_t* pred, int w, int h,
                  int qp, int bd, bool is_intra_slice, const float* wts,
                  int64_t* out_ssd, double* out_bits, int32_t* rec);

// Closed-loop recon of ONE plain intra CU (implicit 32x32 TU split for
// 64-wide CUs, luma+chroma interleaved per TU) — the per-leaf body of
// rc_recon_frame. cbf_out: 3 ints, bit t = TU t. coeff pointers are the
// leaf's slices (advance w*h / (w/2)*(h/2) per leaf at the call site).
// rdoq_lam as transform_quant_recon's.
void recon_intra_leaf(int32_t* rec_y, int32_t* rec_u, int32_t* rec_v,
                      const int32_t* src_y, const int32_t* src_u,
                      const int32_t* src_v, uint8_t* coded_mask,
                      int fw, int fh, int qp, int qp_c, int bd,
                      int signhide, int wpp,
                      int x, int y, int w, int h, int mode, int mode_c,
                      int32_t* coeff_y, int32_t* coeff_u, int32_t* coeff_v,
                      int32_t* cbf_out, double rdoq_lam);

}  // namespace rcn

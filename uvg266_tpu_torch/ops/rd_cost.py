"""Batched rate-distortion block costing for the partition/mode search.

Port of uvg266_tpu/ops/rd_cost.py. For a batch of blocks: pick the best
intra mode by SATD + sqrt(lambda) * mode bits, then run the real forward
path (DCT2 -> quant -> dequant -> IDCT2, exact integer arithmetic) on the
winner and score rd = SSD + lambda * (bits_est + mode bits), with bits_est
from the trained fast coefficient-cost model (fast_cost_tables).

K4 ``rd_cost`` comes as a plain PyTorch version plus a wrapper that
launches the hand-written CUDA kernel (csrc/rd_cost.cu) for tensors on the
card. It takes the per-mode SATDs of K3 (ops.intra_batch.satd67) as an
input; ``satd67`` followed by ``rd_cost`` is the reference's
make_rd_cost_fn. K6 ``rd_cost_pred`` (csrc/rd_cost_pred.cu, the
reference's make_rd_cost_pred_fn) costs one given prediction per block,
with the quant rounding of an inter (default) or intra slice and extra
bits. K11 ``mts_search`` (csrc/mts_search.cu, the reference's
make_mts_search_fn) costs one given prediction under each of the five MTS
transform pairs and picks the first minimum. All three compute the same
RD tail (_rd_tail_plain); K4 and K6 share its device code
(csrc/rd_tail.cuh), whose arithmetic rd_tail_sep and rd_cost_pred_sep
emulate (tests/test_torch_rd_tail_design.py). K12c ``rough_refine`` (the reference's make_rough_refine_fn, the rough
intra search) is a chain: K2 over the 35 stage-1 modes, K3, the stage-1
selection (csrc/rough_refine.cu), K12b over the 4 refine modes, K3, the
stage-2 selection (the same source), K6 on the winner. rough_select_sep
and rough_pick_sep emulate the two selections' warp layout and shuffle
tree (tests/test_torch_rough_select_design.py).

Both versions compute in int32 where the reference does (x64 off: its
int64 casts are int32), wrapping on overflow as it does. The bits estimate
is taken as per-bucket counts times the weights, ((c0*w0 + c1*w1) + c2*w2)
+ c3*w3 in float32: an order-free form of the reference's float32 sum over
the block, which adds the same terms one by one in XLA's order. rd agrees
with the reference to within that sum's rounding ((n - 1) * 2^-24 of rd
for n samples) and exactly between kernel and plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .quant import INV_QUANT_SCALES, QUANT_SCALES
from .tr_matrices import DCT2, DCT8, DST7
from .transforms import (_PLAIN_CHUNK, _imatmul, _wrap, fwd_shifts,
                         inv_shifts)

LOG2 = {4: 2, 8: 3, 16: 4, 32: 5, 64: 6}

# MTS candidate transform pairs, indexed by tr_idx (cu.h:70-78):
# 0=DCT2/DCT2, (1=skip), 2=DST7/DST7, 3=DCT8/DST7, 4=DST7/DCT8, 5=DCT8/DCT8
MTS_PAIRS = {0: (DCT2, DCT2), 2: (DST7, DST7), 3: (DCT8, DST7),
             4: (DST7, DCT8), 5: (DCT8, DCT8)}
# tr_idx of the MTS candidates, in the order the search tries them
MTS_IDX = tuple(MTS_PAIRS)


def quant_consts(w: int, h: int, bitdepth: int, qp: int,
                 is_intra_slice: bool = True) -> dict:
    """Scalar quantiser constants of make_rd_cost_fn (rd_cost.py:95-134)
    for a w x h block at the scaled QP ``qp``."""
    log2_w, log2_h = LOG2[w], LOG2[h]
    needs_sqrt2 = int((log2_w + log2_h) % 2 == 1)
    tshift = 15 - bitdepth - ((log2_w + log2_h) >> 1) - needs_sqrt2
    tshift_d = 15 - bitdepth - ((log2_w + log2_h) >> 1)
    q_bits = 14 + qp // 6 + tshift
    add_base = 171 if is_intra_slice else 85
    return {"q_bits": q_bits,
            "scale": int(QUANT_SCALES[needs_sqrt2][qp % 6]),
            "add": add_base << (q_bits - 9),
            "iscale": int(INV_QUANT_SCALES[needs_sqrt2][qp % 6]) << (qp // 6),
            "dq_shift": 20 - 14 - (tshift_d - needs_sqrt2)}


def _rd_tail_plain(pred, blk, c: dict, w: int, h: int, bitdepth: int, wts,
                   mat_w, mat_h, mask=None):
    """The RD tail shared by K4, K6 and K11 (csrc/rd_tail.cuh rd_tail;
    K11 runs its own form, csrc/mts_search.cu): pred, blk [b, h, w] int64; mat_w [w, w], mat_h [h, h]
    the horizontal and vertical transform matrices (rows = frequencies);
    mask [h, w] the coefficients kept (default all) -> (bits [b] float32
    as per-bucket counts times wts, ssd [b] float32 of the int32-wrapped
    SSD, level [b, h, w] int64 the quantised levels)."""
    s1, s2 = fwd_shifts(w, h, bitdepth)
    si1, si2 = inv_shifts(bitdepth)
    mw = mat_w.long()
    mh = mat_h.long()
    t = _wrap((_imatmul(blk - pred, mw.T) + (1 << (s1 - 1))) >> s1, 16)
    coef = _wrap((_imatmul(mh, t) + (1 << (s2 - 1))) >> s2, 16)
    if mask is not None:
        coef = coef * mask.long()
    level = _wrap(coef.abs() * c["scale"] + c["add"], 32) >> c["q_bits"]
    level = level.clamp(0, 32767)
    bucket = level.clamp(max=3)
    cnt = [(bucket == k).sum(dim=(-2, -1)).to(torch.float32)
           for k in range(4)]
    bits = ((cnt[0] * wts[0] + cnt[1] * wts[1]) + cnt[2] * wts[2]) \
        + cnt[3] * wts[3]
    dq = _wrap(coef.sign() * level * c["iscale"]
               + (1 << (c["dq_shift"] - 1)), 32) >> c["dq_shift"]
    dq = dq.clamp(-32768, 32767)
    u = ((_imatmul(mh.T, dq) + (1 << (si1 - 1))) >> si1).clamp(-32768, 32767)
    r = ((_imatmul(u, mw) + (1 << (si2 - 1))) >> si2).clamp(-32768, 32767)
    d = blk - (pred + r).clamp(0, (1 << bitdepth) - 1)
    return (bits, _wrap((d * d).sum(dim=(-2, -1)), 32).to(torch.float32),
            level)


def rd_cost_plain(preds, src, satds, qp: int, lam: float, wts, mode_bits,
                  tables: dict, bitdepth: int, tail=None):
    """K4, plain version. preds [B, M, h, w], src [B, h, w], satds [B, M]
    int32 (M = 67 intra modes, or the MIP candidates of a class); wts [4],
    mode_bits [M] float32; tables from
    ops.tables.device_tables -> (best [B] int32, rd [B] float32,
    satd_best [B] int32). ``tail`` (default _rd_tail_plain) computes the
    RD tail: rd_tail_sep gives the kernel's arithmetic."""
    tail = tail or _rd_tail_plain
    B, _M, h, w = preds.shape
    c = quant_consts(w, h, bitdepth, qp)
    dev = preds.device
    lam32 = torch.tensor(np.float32(lam), device=dev)
    mode_cost = satds.to(torch.float32) + torch.sqrt(lam32) * mode_bits[None, :]
    best = torch.argmin(mode_cost, dim=1)          # the first minimum
    satd_best = satds.gather(1, best[:, None])[:, 0]
    bits = torch.empty((B,), dtype=torch.float32, device=dev)
    ssd = torch.empty((B,), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, B, step):
        sl = slice(b0, min(b0 + step, B))
        pred = preds[sl][torch.arange(sl.stop - sl.start, device=dev),
                         best[sl]].long()
        bits[sl], ssd[sl], _lv = tail(
            pred, src[sl].long(), c, w, h, bitdepth, wts, tables["mat_w"],
            tables["mat_h"])
    rd = ssd + lam32 * (bits + mode_bits[best])
    return best.to(torch.int32), rd, satd_best


def rd_cost(preds, src, satds, qp: int, lam: float, wts, mode_bits,
            tables: dict, bitdepth: int):
    """K4: rd_cost_plain on the CPU, the CUDA kernel on the card."""
    kernels.check_batch("rd_cost", preds.shape[0])
    if preds.device.type == "cpu":
        return rd_cost_plain(preds, src, satds, qp, lam, wts, mode_bits,
                             tables, bitdepth)
    dev = kernels.check_cuda("rd_cost", preds, src, satds, wts, mode_bits,
                             tables["mat_w"], tables["mat_h"])
    B, M, h, w = preds.shape
    if (tuple(src.shape) != (B, h, w) or tuple(satds.shape) != (B, M)
            or tuple(mode_bits.shape) != (M,)
            or any(t.dtype != torch.int32 for t in (preds, src, satds))
            or wts.dtype != torch.float32 or mode_bits.dtype != torch.float32):
        raise ValueError("rd_cost: expects int32 preds [B, M, h, w], "
                         "src [B, h, w], satds [B, M] and float32 wts [4], "
                         "mode_bits [M]")
    if preds.data_ptr() % 16 or src.data_ptr() % 16:
        raise ValueError("rd_cost: preds and src must be 16-byte aligned "
                         "(the kernel reads them four samples at a time)")
    c = quant_consts(w, h, bitdepth, qp)
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    rd = torch.empty((B,), dtype=torch.float32, device=dev)
    satd_best = torch.empty((B,), dtype=torch.int32, device=dev)
    kernels.launch("rd_cost", dev, preds.data_ptr(), src.data_ptr(),
                   satds.data_ptr(), B, M, w, h, tables["mat_w"].data_ptr(),
                   tables["mat_h"].data_ptr(), wts.data_ptr(),
                   mode_bits.data_ptr(), bitdepth, c["q_bits"], c["scale"],
                   c["add"], c["iscale"], c["dq_shift"], float(lam),
                   best.data_ptr(), rd.data_ptr(), satd_best.data_ptr())
    return best, rd, satd_best


def rd_cost_pred_plain(pred, src, qp: int, lam: float, wts, extra_bits,
                       tables: dict, bitdepth: int,
                       is_intra_slice: bool = False, tail=None):
    """K6, plain version: the RD cost of one given prediction per block
    (quant rounding 85, or 171 with is_intra_slice). pred, src [B, h, w]
    int32; wts [4], extra_bits [B] float32 -> rd [B] float32 =
    ssd + lam * (bits + extra_bits). ``tail`` as in rd_cost_plain."""
    tail = tail or _rd_tail_plain
    B, h, w = pred.shape
    c = quant_consts(w, h, bitdepth, qp, is_intra_slice)
    dev = pred.device
    lam32 = torch.tensor(np.float32(lam), device=dev)
    bits = torch.empty((B,), dtype=torch.float32, device=dev)
    ssd = torch.empty((B,), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, B, step):
        sl = slice(b0, min(b0 + step, B))
        bits[sl], ssd[sl], _lv = tail(
            pred[sl].long(), src[sl].long(), c, w, h, bitdepth, wts,
            tables["mat_w"], tables["mat_h"])
    return ssd + lam32 * (bits + extra_bits)


def rd_cost_pred(pred, src, qp: int, lam: float, wts, extra_bits,
                 tables: dict, bitdepth: int, is_intra_slice: bool = False):
    """K6: rd_cost_pred_plain on the CPU, the CUDA kernel on the card."""
    kernels.check_batch("rd_cost_pred", pred.shape[0])
    if pred.device.type == "cpu":
        return rd_cost_pred_plain(pred, src, qp, lam, wts, extra_bits,
                                  tables, bitdepth, is_intra_slice)
    dev = kernels.check_cuda("rd_cost_pred", pred, src, wts, extra_bits,
                             tables["mat_w"], tables["mat_h"])
    B, h, w = pred.shape
    if (tuple(src.shape) != (B, h, w) or tuple(extra_bits.shape) != (B,)
            or pred.dtype != torch.int32 or src.dtype != torch.int32
            or wts.dtype != torch.float32
            or extra_bits.dtype != torch.float32):
        raise ValueError("rd_cost_pred: expects int32 pred, src [B, h, w] "
                         "and float32 wts, extra_bits [B]")
    if pred.data_ptr() % 16 or src.data_ptr() % 16:
        raise ValueError("rd_cost_pred: pred and src must be 16-byte aligned "
                         "(the kernel reads them four samples at a time)")
    c = quant_consts(w, h, bitdepth, qp, is_intra_slice)
    rd = torch.empty((B,), dtype=torch.float32, device=dev)
    kernels.launch("rd_cost_pred", dev, pred.data_ptr(), src.data_ptr(),
                   extra_bits.data_ptr(), B, w, h, tables["mat_w"].data_ptr(),
                   tables["mat_h"].data_ptr(), wts.data_ptr(), bitdepth,
                   c["q_bits"], c["scale"], c["add"], c["iscale"],
                   c["dq_shift"], float(lam), rd.data_ptr())
    return rd


def mts_search_plain(pred, src, qp: int, lam: float, wts, mts: dict,
                     bitdepth: int):
    """K11, plain version: the RD cost of one given prediction per block
    under each MTS candidate (tr_idx 0, 2, 3, 4, 5). pred, src [B, h, w]
    int32 with w, h <= 32; wts [4] float32; ``mts`` from
    ops.tables.device_mts_tables -> (tr_idx [B] int32 of the first
    minimum, its cost [B] float32, dc_only [B] bool of the DCT2
    candidate). cost = ssd + lam * (bits + signalling bits), the
    signalling bits 1 for DCT2 and 1 + ci for candidate ci; a candidate
    ci > 0 with no nonzero level beyond DC cannot signal mts_idx and is
    pushed out by adding 1e30."""
    B, h, w = pred.shape
    c = quant_consts(w, h, bitdepth, qp)
    dev = pred.device
    lam32 = torch.tensor(np.float32(lam), device=dev)
    n_c = len(MTS_IDX)
    cost = torch.empty((B, n_c), dtype=torch.float32, device=dev)
    dcs = torch.empty((B, n_c), dtype=torch.bool, device=dev)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, B, step):
        sl = slice(b0, min(b0 + step, B))
        p64, s64 = pred[sl].long(), src[sl].long()
        for ci in range(n_c):
            bits, ssd, level = _rd_tail_plain(
                p64, s64, c, w, h, bitdepth, wts, mts["mts_w"][ci],
                mts["mts_h"][ci], mts["mts_mask"][ci])
            bits = bits + (1.0 if ci == 0 else 1.0 + ci)
            nz = level != 0
            dc_only = (nz.sum(dim=(-2, -1)) - nz[:, 0, 0].long()) == 0
            cc = ssd + lam32 * bits
            if ci > 0:
                cc = torch.where(dc_only, cc + np.float32(1e30), cc)
            cost[sl, ci] = cc
            dcs[sl, ci] = dc_only
    best = torch.argmin(cost, dim=1)               # the first minimum
    tr_idx = torch.tensor(MTS_IDX, dtype=torch.int32, device=dev)[best]
    return tr_idx, cost.gather(1, best[:, None])[:, 0], dcs[:, 0].clone()


def _in32(*ts):
    """Raise unless every sum lies inside int32 (the kernel's sums are
    int32, the emulation's int64)."""
    for t in ts:
        if t.numel() and (t.min() < -(1 << 31) or t.max() >= 1 << 31):
            raise OverflowError("a transform sum leaves int32")
    return ts[0] if len(ts) == 1 else ts


def _bfly_fwd(v, m):
    """The even/odd partial butterfly of a DCT2 along the last axis
    (M[k][n-1-x] = (-1)^k M[k][x]): v [..., n], m [n, n] -> sums [..., n],
    output 2j from (v[x] + v[n-1-x]) and 2j+1 from (v[x] - v[n-1-x]) over
    x < n/2."""
    n = v.shape[-1]
    hn = n // 2
    r = v.flip(-1)[..., :hn]
    out = torch.empty_like(v)
    out[..., 0::2] = _imatmul(v[..., :hn] + r, m[0::2, :hn].T)
    out[..., 1::2] = _imatmul(v[..., :hn] - r, m[1::2, :hn].T)
    return _in32(out)


def _bfly_inv(c, m):
    """The inverse DCT2 along the last axis from the even and the odd half
    sums: out[i] = e + o, out[n-1-i] = e - o, i < n/2."""
    hn = c.shape[-1] // 2
    e = _imatmul(c[..., 0::2], m[0::2, :hn])
    o = _imatmul(c[..., 1::2], m[1::2, :hn])
    return _in32(torch.cat([e + o, (e - o).flip(-1)], -1))


def rd_tail_sep(pred, blk, c: dict, w: int, h: int, bitdepth: int, wts,
                mat_w, mat_h):
    """The RD tail as csrc/rd_tail.cuh computes it for K4 and K6, in plain
    PyTorch: the DCT2 passes on even/odd partial butterflies (_bfly_fwd,
    _bfly_inv: rows, then columns, then back), the bucket counts of
    levels 0, 1, 2 and >= 3 as the kernel counts them, the SSD summed in
    uint32. Same arguments and results as _rd_tail_plain without a mask,
    which it must equal bit for bit; raises where a sum would leave
    int32."""
    s1, s2 = fwd_shifts(w, h, bitdepth)
    si1, si2 = inv_shifts(bitdepth)
    mw, mh = mat_w.long(), mat_h.long()

    def fwd_shift(x, s):
        return _wrap((x + (1 << (s - 1))) >> s, 16)

    def inv_shift(x, s):
        return ((x + (1 << (s - 1))) >> s).clamp(-32768, 32767)

    t = fwd_shift(_bfly_fwd(blk - pred, mw), s1)            # rows
    coef = fwd_shift(_bfly_fwd(t.mT, mh), s2).mT           # columns
    level = (_wrap(coef.abs() * c["scale"] + c["add"], 32)
             >> c["q_bits"]).clamp(0, 32767)
    cnt = [(level == 0).sum(dim=(-2, -1)), (level == 1).sum(dim=(-2, -1)),
           (level == 2).sum(dim=(-2, -1)), (level >= 3).sum(dim=(-2, -1))]
    cnt = [n.to(torch.float32) for n in cnt]
    bits = ((cnt[0] * wts[0] + cnt[1] * wts[1]) + cnt[2] * wts[2]) \
        + cnt[3] * wts[3]
    dq = (_wrap(coef.sign() * level * c["iscale"]
                + (1 << (c["dq_shift"] - 1)), 32) >> c["dq_shift"]) \
        .clamp(-32768, 32767)
    u = inv_shift(_bfly_inv(dq.mT, mh), si1).mT              # columns
    r = inv_shift(_bfly_inv(u, mw), si2)                    # rows
    d = blk - (pred + r).clamp(0, (1 << bitdepth) - 1)
    ssd = ((d * d) & 0xFFFFFFFF).sum(dim=(-2, -1)) & 0xFFFFFFFF
    return bits, _wrap(ssd, 32).to(torch.float32), level


def rd_cost_pred_sep(pred, src, qp: int, lam: float, wts, extra_bits,
                     tables: dict, bitdepth: int,
                     is_intra_slice: bool = False):
    """K6's arithmetic as csrc/rd_cost_pred.cu computes it: rd_cost_pred_plain
    on rd_tail_sep."""
    return rd_cost_pred_plain(pred, src, qp, lam, wts, extra_bits, tables,
                              bitdepth, is_intra_slice, tail=rd_tail_sep)


def _joint_fwd(v, s, k: int):
    """DST7 and DCT8 along the last axis from one product (DCT8[k][x] =
    (-1)^k DST7[k][n-1-x]): with a = v[x] + v[n-1-x], d = v[x] - v[n-1-x]
    (x < n/2), s1 = sum a (S[k][x] + S[k][n-1-x]) and s2 = sum d (S[k][x] -
    S[k][n-1-x]) the DST7 output is (s1 + s2) / 2 and the DCT8 output
    (-1)^k (s1 - s2) / 2; the first k outputs of each. s: the DST7 matrix
    [n, n] (rows = frequencies)."""
    n = v.shape[-1]
    hn = n // 2
    r = v.flip(-1)[..., :hn]
    sr = s.flip(-1)
    s1, s2 = _in32(_imatmul(v[..., :hn] + r, (s[:k, :hn] + sr[:k, :hn]).T),
                   _imatmul(v[..., :hn] - r, (s[:k, :hn] - sr[:k, :hn]).T))
    if ((s1 + s2) & 1).any():
        raise ArithmeticError("s1 and s2 differ in parity")
    sign = 1 - 2 * (torch.arange(k, device=v.device) & 1)
    return (s1 + s2) >> 1, ((s1 - s2) >> 1) * sign


def dct8_of(s):
    """The DCT8 matrix from the DST7 matrix s of the same size:
    DCT8[k][x] = (-1)^k DST7[k][n-1-x]."""
    sign = 1 - 2 * (torch.arange(s.shape[0], device=s.device) & 1)
    return sign[:, None] * s.flip(-1)


def mts_search_sep(pred, src, qp: int, lam: float, wts, mts: dict,
                   bitdepth: int):
    """K11's arithmetic as csrc/mts_search.cu computes it, in plain
    PyTorch: the DCT2 candidate on even/odd partial butterflies; one
    forward row pass for the four DST7/DCT8 candidates and one column
    pass per horizontal type, each giving DST7 and DCT8 from one product
    (_joint_fwd), and at 32 points only the 16 coefficients kept; per
    candidate the quantiser, the dequantiser and the inverse passes over
    the kept coefficients alone. The DCT8 matrices come from the DST7
    ones (dct8_of). Same arguments and results as mts_search_plain, which
    it must equal bit for bit; raises where a sum would leave int32."""
    B, h, w = pred.shape
    c = quant_consts(w, h, bitdepth, qp)
    s1, s2 = fwd_shifts(w, h, bitdepth)
    si1, si2 = inv_shifts(bitdepth)
    kw, kh = (16 if w == 32 else w), (16 if h == 32 else h)
    dev = pred.device
    lam32 = torch.tensor(np.float32(lam), device=dev)
    d2w, d2h = mts["mts_w"][0].long(), mts["mts_h"][0].long()
    sw, sh = mts["mts_w"][1].long(), mts["mts_h"][1].long()
    # vertical and horizontal matrices of candidates 1-4 (tr_idx 2-5)
    vert = (sh, sh, dct8_of(sh), dct8_of(sh))
    hor = (sw, dct8_of(sw), sw, dct8_of(sw))
    n_c = len(MTS_IDX)
    cost = torch.empty((B, n_c), dtype=torch.float32, device=dev)
    dcs = torch.empty((B, n_c), dtype=torch.bool, device=dev)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))

    def fwd_shift(x, s):
        return _wrap((x + (1 << (s - 1))) >> s, 16)

    def inv_shift(x, s):
        return ((x + (1 << (s - 1))) >> s).clamp(-32768, 32767)

    for b0 in range(0, B, step):
        sl = slice(b0, min(b0 + step, B))
        p64, s64 = pred[sl].long(), src[sl].long()
        resid = s64 - p64
        # rows: the DCT2 butterfly, then DST7 and DCT8 jointly
        r2 = fwd_shift(_bfly_fwd(resid, d2w), s1)
        rs, rc = (fwd_shift(t, s1) for t in _joint_fwd(resid, sw, kw))
        # columns (the lines last, then back): [b, k2, k]
        coefs = [fwd_shift(_bfly_fwd(r2.mT, d2h), s2).mT]
        # [horizontal]_[vertical]: DST7 (s) or DCT8 (c)
        s_s, s_c = _joint_fwd(rs.mT, sh, kh)
        c_s, c_c = _joint_fwd(rc.mT, sh, kh)
        coefs += [fwd_shift(t, s2).mT for t in (s_s, c_s, s_c, c_c)]
        for ci, coef in enumerate(coefs):
            level = _wrap(coef.abs() * c["scale"] + c["add"], 32) \
                >> c["q_bits"]
            level = level.clamp(0, 32767)
            n1, n2, n3 = ((level == 1).sum(dim=(-2, -1)),
                          (level == 2).sum(dim=(-2, -1)),
                          (level >= 3).sum(dim=(-2, -1)))
            nz = n1 + n2 + n3
            cnt = [(h * w - nz).to(torch.float32)] + \
                [n.to(torch.float32) for n in (n1, n2, n3)]
            bits = ((cnt[0] * wts[0] + cnt[1] * wts[1]) + cnt[2] * wts[2]) \
                + cnt[3] * wts[3]
            dq = _wrap(coef.sign() * level * c["iscale"]
                       + (1 << (c["dq_shift"] - 1)), 32) >> c["dq_shift"]
            dq = dq.clamp(-32768, 32767)
            if ci == 0:
                u = inv_shift(_bfly_inv(dq.mT, d2h), si1).mT
                r = inv_shift(_bfly_inv(u, d2w), si2)
            else:
                u = inv_shift(_in32(_imatmul(vert[ci - 1][:kh].T, dq)), si1)
                r = inv_shift(_in32(_imatmul(u, hor[ci - 1][:kw])), si2)
            d = s64 - (p64 + r).clamp(0, (1 << bitdepth) - 1)
            ssd = _wrap((d * d).sum(dim=(-2, -1)), 32).to(torch.float32)
            bits = bits + (1.0 if ci == 0 else 1.0 + ci)
            dc_only = (nz - (level[:, 0, 0] != 0).long()) == 0
            cc = ssd + lam32 * bits
            if ci > 0:
                cc = torch.where(dc_only, cc + np.float32(1e30), cc)
            cost[sl, ci] = cc
            dcs[sl, ci] = dc_only
    best = torch.argmin(cost, dim=1)
    tr_idx = torch.tensor(MTS_IDX, dtype=torch.int32, device=dev)[best]
    return tr_idx, cost.gather(1, best[:, None])[:, 0], dcs[:, 0].clone()


def mts_search(pred, src, qp: int, lam: float, wts, mts: dict,
               bitdepth: int):
    """K11: mts_search_plain on the CPU, the CUDA kernel on the card."""
    kernels.check_batch("mts_search", pred.shape[0])
    if pred.device.type == "cpu":
        return mts_search_plain(pred, src, qp, lam, wts, mts, bitdepth)
    dev = kernels.check_cuda("mts_search", pred, src, wts, mts["mts_w"],
                             mts["mts_h"])
    B, h, w = pred.shape
    if (tuple(src.shape) != (B, h, w) or w > 32 or h > 32
            or pred.dtype != torch.int32 or src.dtype != torch.int32
            or wts.dtype != torch.float32 or (mts["w"], mts["h"]) != (w, h)
            or mts["mts_w"].dtype != torch.int8
            or mts["mts_h"].dtype != torch.int8):
        raise ValueError("mts_search: expects int32 pred, src [B, h, w] with "
                         "w, h <= 32, float32 wts and the class's MTS tables")
    if pred.data_ptr() % 16 or src.data_ptr() % 16:
        raise ValueError("mts_search: pred and src must be 16-byte aligned "
                         "(the kernel reads them four samples at a time)")
    c = quant_consts(w, h, bitdepth, qp)
    keep = np.ascontiguousarray(mts["mts_keep"], dtype=np.int32)
    idx = np.ascontiguousarray(MTS_IDX, dtype=np.int32)
    tr = torch.empty((B,), dtype=torch.int32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    dc_only = torch.empty((B,), dtype=torch.bool, device=dev)
    kernels.launch("mts_search", dev, pred.data_ptr(), src.data_ptr(), B, w,
                   h, mts["mts_w"].data_ptr(), mts["mts_h"].data_ptr(),
                   keep.ctypes.data, idx.ctypes.data, wts.data_ptr(),
                   bitdepth, c["q_bits"], c["scale"], c["add"], c["iscale"],
                   c["dq_shift"], float(lam), tr.data_ptr(), cost.data_ptr(),
                   dc_only.data_ptr())
    return tr, cost, dc_only


# --- K12c: the rough intra search ---------------------------------------

def _rough_costs(satds, lam32, mode_bits, modes):
    """float32(satd) + sqrt(lam) * mode_bits[mode], the multiply and the
    add rounded separately (make_rough_refine_fn's c1 and c2)."""
    return satds.to(torch.float32) + torch.sqrt(lam32) * mode_bits[modes.long()]


def rough_select_plain(s1, lam: float, mode_bits, m1):
    """K12c stage 1, plain version: s1 [B, 35] int32 SATDs of the modes m1
    [35] int32 -> refine [B, 4] int32 = clip([a1-1, a1+1, a2-1, a2+1], 2,
    66), a1 and a2 the two best even angular modes (the first minimum over
    c1[2:], then with that cost raised by 1e30)."""
    lam32 = torch.tensor(np.float32(lam), device=s1.device)
    ang = _rough_costs(s1, lam32, mode_bits, m1)[:, 2:]
    i1 = torch.argmin(ang, dim=1)
    masked = ang.clone()
    rows = torch.arange(ang.shape[0], device=ang.device)
    masked[rows, i1] = ang[rows, i1] + np.float32(1e30)
    i2 = torch.argmin(masked, dim=1)
    a1, a2 = 2 + 2 * i1, 2 + 2 * i2
    return torch.stack([a1 - 1, a1 + 1, a2 - 1, a2 + 1], dim=1) \
        .clamp(2, 66).to(torch.int32)


def rough_pick_plain(s1, s2, refine, lam: float, mode_bits, m1, p1, p2):
    """K12c stage 2, plain version: the first minimum k over the 39 costs
    [c1 | c2] of the stage-1 modes m1 (SATDs s1 [B, 35], predictions p1
    [B, 35, h, w]) and the refine modes (s2, refine [B, 4], p2 [B, 4, h,
    w]) -> (best_mode [B] int32, satd_best [B] int32, extra [B] float32 =
    mode_bits[best_mode], pred [B, h, w] int32 the winning prediction)."""
    B = s1.shape[0]
    lam32 = torch.tensor(np.float32(lam), device=s1.device)
    all_c = torch.cat([_rough_costs(s1, lam32, mode_bits, m1[None]),
                       _rough_costs(s2, lam32, mode_bits, refine)], dim=1)
    k = torch.argmin(all_c, dim=1)                 # stage-1 slots win ties
    rows = torch.arange(B, device=s1.device)
    n1 = s1.shape[1]
    modes = torch.cat([m1[None].expand(B, n1), refine], dim=1)
    best_mode = modes[rows, k]
    satd_best = torch.cat([s1, s2], dim=1)[rows, k]
    pred = torch.where((k < n1)[:, None, None],
                       p1[rows, k.clamp(max=n1 - 1)],
                       p2[rows, (k - n1).clamp(min=0)])
    return best_mode, satd_best, mode_bits[best_mode.long()], pred


_LANES = torch.arange(32)
_NONE = 2 ** 31 - 1                   # the index of a lane with no slot


def _lane_min(c):
    """Costs c [B, n] (n <= 64) laid on a warp as the kernels lay them:
    lane l holds slots l and l + 32 and keeps the first of its two minima
    -> (cost, slot) [B, 32]; a lane with no slot holds (+inf, 2^31 - 1)."""
    B, n = c.shape
    cc = torch.full((B, 64), float("inf"), dtype=torch.float32)
    cc[:, :n] = c
    ii = torch.full((B, 64), _NONE, dtype=torch.int64)
    ii[:, :n] = torch.arange(n)
    hi = cc[:, 32:] < cc[:, :32]
    return (torch.where(hi, cc[:, 32:], cc[:, :32]),
            torch.where(hi, ii[:, 32:], ii[:, :32]))


def _warp_argmin(c, i):
    """The kernels' warp_argmin on lane values c, i [B, 32]: at each of the
    five __shfl_xor_sync steps (16, 8, 4, 2, 1) lane l takes lane l ^ o's
    key where it is smaller (the cost, then the index) -> every lane's key
    after the last step."""
    for o in (16, 8, 4, 2, 1):
        oc, oi = c[:, _LANES ^ o], i[:, _LANES ^ o]
        take = (oc < c) | ((oc == c) & (oi < i))
        c, i = torch.where(take, oc, c), torch.where(take, oi, i)
    return c, i


def _warp_first_min(c, what: str):
    """The first minimum of each row of c [B, n] as a block's warp finds
    it (_lane_min, then _warp_argmin); raises if the lanes disagree."""
    _c, i = _warp_argmin(*_lane_min(c))
    if not (i == i[:, :1]).all():
        raise AssertionError(f"{what}: the lanes disagree on the minimum")
    return i[:, 0]


def rough_select_sep(s1, lam: float, mode_bits, m1):
    """K12c stage 1 as csrc/rough_refine.cu computes it (CPU tensors): lane
    l of a block's warp holds the angular costs j = 2 + l and 34 + l, a
    warp argmin gives i1 (every lane must agree), the lane holding i1 adds
    1e30 to that cost, a second warp argmin gives i2, lane 0 writes the
    clipped refine list. Equal to rough_select_plain."""
    lam32 = torch.tensor(np.float32(lam))
    ang = _rough_costs(s1, lam32, mode_bits, m1)[:, 2:]
    i1 = _warp_first_min(ang, "rough_select_sep i1")
    rows = torch.arange(ang.shape[0])
    masked = ang.clone()
    masked[rows, i1] = ang[rows, i1] + np.float32(1e30)
    i2 = _warp_first_min(masked, "rough_select_sep i2")
    a1, a2 = 2 + 2 * i1, 2 + 2 * i2
    return torch.stack([a1 - 1, a1 + 1, a2 - 1, a2 + 1], dim=1) \
        .clamp(2, 66).to(torch.int32)


def rough_pick_sep(s1, s2, refine, lam: float, mode_bits, m1, p1, p2):
    """K12c stage 2 as csrc/rough_refine.cu computes it (CPU tensors): lane
    l holds slots j = l and l + 32 of the 39 costs (the stage-1 slots, then
    the refine slots, whose mode index is clamped to [0, 66]), a warp
    argmin gives k, the lane holding slot k (lane k % 32, its slot k // 32)
    gives best_mode, satd_best and extra, and the winner is copied four
    samples at a time. Equal to rough_pick_plain."""
    B, n1 = s1.shape
    h, w = p1.shape[2:]
    lam32 = torch.tensor(np.float32(lam))
    modes = torch.cat([m1[None].expand(B, n1), refine.clamp(0, 66)], dim=1)
    sat = torch.cat([s1, s2], dim=1)
    k = _warp_first_min(_rough_costs(sat, lam32, mode_bits, modes),
                        "rough_pick_sep k")
    rows = torch.arange(B)
    best_mode = modes[rows, k]                  # lane k % 32's slot k // 32
    q1 = p1.reshape(B, n1, h * w // 4, 4)
    q2 = p2.reshape(B, 4, h * w // 4, 4)
    pred = torch.where((k < n1)[:, None, None], q1[rows, k.clamp(max=n1 - 1)],
                       q2[rows, (k - n1).clamp(min=0)])
    return (best_mode, sat[rows, k], mode_bits[best_mode.long()],
            pred.reshape(B, h, w))


def _rough_stage(stage: int, s1, lam: float, mode_bits, m1, s2=None,
                 refine=None, p1=None, p2=None):
    """Launch stage 1 or 2 of csrc/rough_refine.cu (K12c's selections)."""
    dev = kernels.check_cuda("rough_refine", s1, mode_bits, m1,
                             *(t for t in (s2, refine, p1, p2)
                               if t is not None))
    B, n1 = s1.shape
    if (s1.dtype != torch.int32 or m1.dtype != torch.int32
            or tuple(m1.shape) != (n1,) or mode_bits.dtype != torch.float32
            or tuple(mode_bits.shape) != (67,)):
        raise ValueError("rough_refine: expects int32 s1 [B, n1], m1 [n1] "
                         "and float32 mode_bits [67]")
    if stage == 1:
        refine = torch.empty((B, 4), dtype=torch.int32, device=dev)
        kernels.launch("rough_refine", dev, 1, B, n1, 0, float(lam),
                       s1.data_ptr(), None, refine.data_ptr(),
                       mode_bits.data_ptr(), m1.data_ptr(), None, None, None,
                       None, None, None)
        return refine
    _B, _n1, h, w = p1.shape
    if (tuple(p1.shape[:2]) != (B, n1) or tuple(p2.shape) != (B, 4, h, w)
            or tuple(s2.shape) != (B, 4) or tuple(refine.shape) != (B, 4)
            or any(t.dtype != torch.int32 for t in (s2, refine, p1, p2))):
        raise ValueError("rough_refine: expects int32 s2, refine [B, 4], "
                         "p1 [B, n1, h, w], p2 [B, 4, h, w]")
    if p1.data_ptr() % 16 or p2.data_ptr() % 16:
        raise ValueError("rough_refine: p1 and p2 must be 16-byte aligned "
                         "(the kernel copies the winner four samples at a "
                         "time)")
    best_mode = torch.empty((B,), dtype=torch.int32, device=dev)
    satd_best = torch.empty((B,), dtype=torch.int32, device=dev)
    extra = torch.empty((B,), dtype=torch.float32, device=dev)
    pred = torch.empty((B, h, w), dtype=torch.int32, device=dev)
    kernels.launch("rough_refine", dev, 2, B, n1, h * w, float(lam),
                   s1.data_ptr(), s2.data_ptr(), refine.data_ptr(),
                   mode_bits.data_ptr(), m1.data_ptr(), p1.data_ptr(),
                   p2.data_ptr(), best_mode.data_ptr(), satd_best.data_ptr(),
                   extra.data_ptr(), pred.data_ptr())
    return best_mode, satd_best, extra, pred


def rough_select(s1, lam: float, mode_bits, m1):
    """K12c stage 1: rough_select_plain on the CPU, the kernel on the
    card."""
    kernels.check_batch("rough_select", s1.shape[0])
    if s1.device.type == "cpu":
        return rough_select_plain(s1, lam, mode_bits, m1)
    return _rough_stage(1, s1, lam, mode_bits, m1)


def rough_pick(s1, s2, refine, lam: float, mode_bits, m1, p1, p2):
    """K12c stage 2: rough_pick_plain on the CPU, the kernel on the card."""
    kernels.check_batch("rough_pick", s1.shape[0])
    if s1.device.type == "cpu":
        return rough_pick_plain(s1, s2, refine, lam, mode_bits, m1, p1, p2)
    return _rough_stage(2, s1, lam, mode_bits, m1, s2, refine, p1, p2)


def _rough_chain(refs, src, qp: int, lam: float, wts, mode_bits,
                 tables: dict, bitdepth: int, is_intra_slice: bool, m1,
                 plain: bool, sep: bool = False):
    from .intra_batch import (predict67, predict67_plain, predict_modes,
                              predict_modes_plain, satd67, satd67_plain)
    if plain:
        pred67, predm, satd = predict67_plain, predict_modes_plain, \
            satd67_plain
        select, pick, rdp = rough_select_plain, rough_pick_plain, \
            rd_cost_pred_plain
        if sep:
            select, pick = rough_select_sep, rough_pick_sep
    else:
        pred67, predm, satd = predict67, predict_modes, satd67
        select, pick, rdp = rough_select, rough_pick, rd_cost_pred
    p1 = pred67(refs, tables, m1)                   # K2, M = 35
    s1 = satd(p1, src)                              # K3
    refine = select(s1, lam, mode_bits, m1)         # stage 1
    p2 = predm(refs, refine, tables)                # K12b
    s2 = satd(p2, src)                              # K3, M = 4
    best_mode, satd_best, extra, pred = pick(s1, s2, refine, lam, mode_bits,
                                             m1, p1, p2)   # stage 2
    rd = rdp(pred, src, qp, lam, wts, extra, tables, bitdepth,
             is_intra_slice)                        # K6
    return best_mode, rd, satd_best


def rough_refine_plain(refs, src, qp: int, lam: float, wts, mode_bits,
                       tables: dict, bitdepth: int, m1,
                       is_intra_slice: bool = True):
    """K12c, plain version: refs [B, 4*REF_LEN], src [B, h, w] int32, wts
    [4], mode_bits [67] float32, tables from ops.tables.device_tables, m1
    the stage-1 modes (ops.tables.rough_modes) -> (best_mode [B] int32,
    rd [B] float32, satd_best [B] int32): the chain of plain versions."""
    return _rough_chain(refs, src, qp, lam, wts, mode_bits, tables,
                        bitdepth, is_intra_slice, m1, True)


def rough_refine_sep(refs, src, qp: int, lam: float, wts, mode_bits,
                     tables: dict, bitdepth: int, m1,
                     is_intra_slice: bool = True):
    """rough_refine_plain with the two selections' emulations
    (rough_select_sep, rough_pick_sep) in place of their plain versions."""
    return _rough_chain(refs, src, qp, lam, wts, mode_bits, tables,
                        bitdepth, is_intra_slice, m1, True, sep=True)


def rough_refine(refs, src, qp: int, lam: float, wts, mode_bits,
                 tables: dict, bitdepth: int, m1,
                 is_intra_slice: bool = True):
    """K12c: the chain through each stage's wrapper (K2, K3, stage 1, K12b,
    K3, stage 2, K6): the plain versions on the CPU, the kernels on the
    card."""
    return _rough_chain(refs, src, qp, lam, wts, mode_bits, tables,
                        bitdepth, is_intra_slice, m1, False)

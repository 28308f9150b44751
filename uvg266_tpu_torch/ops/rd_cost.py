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
with inter rounding and extra bits. K11 ``mts_search``
(csrc/mts_search.cu, the reference's make_mts_search_fn) costs one given
prediction under each of the five MTS transform pairs and picks the
first minimum. All three share the RD tail.

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
from .transforms import fwd_shifts, inv_shifts

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


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 product a [..., m, k] @ b [..., k, n] as a broadcast
    multiply and sum (no integer GEMM on the card)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


# int64 elements of the largest intermediate per chunk of blocks
_PLAIN_CHUNK = 1 << 24


def _rd_tail_plain(pred, blk, c: dict, w: int, h: int, bitdepth: int, wts,
                   mat_w, mat_h, mask=None):
    """The RD tail shared by K4, K6 and K11 (csrc/common.cuh
    rd_tail_block): pred, blk [b, h, w] int64; mat_w [w, w], mat_h [h, h]
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
                  tables: dict, bitdepth: int):
    """K4, plain version. preds [B, M, h, w], src [B, h, w], satds [B, M]
    int32 (M = 67 intra modes, or the MIP candidates of a class); wts [4],
    mode_bits [M] float32; tables from
    ops.tables.device_tables -> (best [B] int32, rd [B] float32,
    satd_best [B] int32)."""
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
        bits[sl], ssd[sl], _lv = _rd_tail_plain(
            pred, src[sl].long(), c, w, h, bitdepth, wts, tables["mat_w"],
            tables["mat_h"])
    rd = ssd + lam32 * (bits + mode_bits[best])
    return best.to(torch.int32), rd, satd_best


def rd_cost(preds, src, satds, qp: int, lam: float, wts, mode_bits,
            tables: dict, bitdepth: int):
    """K4: rd_cost_plain on the CPU, the CUDA kernel on the card."""
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
                       tables: dict, bitdepth: int):
    """K6, plain version: the RD cost of one given prediction per block
    (the inter path, quant rounding 85). pred, src [B, h, w] int32; wts
    [4], extra_bits [B] float32 -> rd [B] float32 =
    ssd + lam * (bits + extra_bits)."""
    B, h, w = pred.shape
    c = quant_consts(w, h, bitdepth, qp, is_intra_slice=False)
    dev = pred.device
    lam32 = torch.tensor(np.float32(lam), device=dev)
    bits = torch.empty((B,), dtype=torch.float32, device=dev)
    ssd = torch.empty((B,), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, B, step):
        sl = slice(b0, min(b0 + step, B))
        bits[sl], ssd[sl], _lv = _rd_tail_plain(
            pred[sl].long(), src[sl].long(), c, w, h, bitdepth, wts,
            tables["mat_w"], tables["mat_h"])
    return ssd + lam32 * (bits + extra_bits)


def rd_cost_pred(pred, src, qp: int, lam: float, wts, extra_bits,
                 tables: dict, bitdepth: int):
    """K6: rd_cost_pred_plain on the CPU, the CUDA kernel on the card."""
    if pred.device.type == "cpu":
        return rd_cost_pred_plain(pred, src, qp, lam, wts, extra_bits,
                                  tables, bitdepth)
    dev = kernels.check_cuda("rd_cost_pred", pred, src, wts, extra_bits,
                             tables["mat_w"], tables["mat_h"])
    B, h, w = pred.shape
    if (tuple(src.shape) != (B, h, w) or tuple(extra_bits.shape) != (B,)
            or pred.dtype != torch.int32 or src.dtype != torch.int32
            or wts.dtype != torch.float32
            or extra_bits.dtype != torch.float32):
        raise ValueError("rd_cost_pred: expects int32 pred, src [B, h, w] "
                         "and float32 wts, extra_bits [B]")
    c = quant_consts(w, h, bitdepth, qp, is_intra_slice=False)
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


def mts_search(pred, src, qp: int, lam: float, wts, mts: dict,
               bitdepth: int):
    """K11: mts_search_plain on the CPU, the CUDA kernel on the card."""
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

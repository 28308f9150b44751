"""Scalar quantization / dequantization, bit-exact with the reference
(quant-generic.c: uvg_quant_generic:51, uvg_dequant_generic:618;
scale tables scalinglist.c:91-97).

Default path only (no custom scaling lists); sign-data hiding is applied as
a separate pass (see signhide further down, quant-generic.c:134-258).

K14 ``quant_batch`` / ``dequant_batch`` are the batched device twins (the
reference's make_quant_fn / make_dequant_fn), each a plain PyTorch version
plus a wrapper that launches the hand-written CUDA kernel (csrc/quant.cu)
for tensors on the card. They compute in int32 as the reference does (x64
off: its int64 casts are int32) and wrap where it wraps, so they differ
from the numpy ``quant`` / ``dequant`` above, which saturate: at 8x4, 10
bits, qp_scaled 63 the level 29127 dequantises to -32768 (numpy: 32767),
and at 4x4, 10 bits, qp_scaled 0 the coefficient 200000 quantises to 7231
(numpy: 32767). ``quant_batch_sep`` / ``dequant_batch_sep`` emulate the
kernel's arithmetic (int16 or int32 read in place, eight elements a thread,
the sign as selects) in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .transforms import _check_blocks, _int32_blocks, _wrap

QUANT_SCALES = np.array([
    [26214, 23302, 20560, 18396, 16384, 14564],
    [18396, 16384, 14564, 13107, 11651, 10280],
], dtype=np.int64)
INV_QUANT_SCALES = np.array([
    [40, 45, 51, 57, 64, 72],
    [57, 64, 72, 80, 90, 102],
], dtype=np.int64)

QUANT_SHIFT = 14
MAX_TR_DYNAMIC_RANGE = 15
MIN_QP_PRIME_TS = 2
LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6}


def quant_params(qp_scaled: int, log2_w: int, log2_h: int, bitdepth: int = 8,
                 transform_skip: bool = False, is_intra_slice: bool = True):
    """Returns (quant_scale, q_bits, add) for the default quant path."""
    if transform_skip:
        qp_scaled = max(qp_scaled, 4 + 6 * MIN_QP_PRIME_TS)
    needs_sqrt2 = (not transform_skip) and ((log2_w + log2_h) % 2 == 1)
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - ((log2_w + log2_h) >> 1) - needs_sqrt2
    q_bits = QUANT_SHIFT + qp_scaled // 6 + (0 if transform_skip else transform_shift)
    add = (171 if is_intra_slice else 85) << (q_bits - 9)
    scale = int(QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6])
    return scale, q_bits, add


def quant(coef: np.ndarray, qp_scaled: int, bitdepth: int = 8,
          transform_skip: bool = False, is_intra_slice: bool = True,
          signhide: bool = False, qmat: np.ndarray | None = None) -> np.ndarray:
    """Quantize an h x w coefficient block (numpy, bit-exact), with
    optional sign-data hiding (quant-generic.c:123-229).

    qmat: optional per-coefficient scaling-list matrix m (flat = 16);
    the per-coefficient quant scale becomes (scale << 4) / m
    (quant-generic.c:74-94)."""
    h, w = coef.shape
    scale, q_bits, add = quant_params(qp_scaled, LOG2[w], LOG2[h], bitdepth,
                                      transform_skip, is_intra_slice)
    if qmat is None:
        qc = scale
    else:
        qc = (scale << 4) // qmat.astype(np.int64)
    a = np.abs(coef.astype(np.int64))
    level = (a * qc + add) >> q_bits
    q = np.clip(np.sign(coef) * level, -32768, 32767).astype(np.int16)
    if signhide and int(level.sum()) >= 2:
        delta_u = ((a * qc - (level << q_bits)) >> (q_bits - 8)).astype(np.int64)
        _sign_hide(q, coef, delta_u, w, h)
    return q


def _sign_hide(q: np.ndarray, coef: np.ndarray, delta_u: np.ndarray,
               w: int, h: int) -> None:
    """In-place sign-data hiding over 16-coefficient scan sets
    (quant-generic.c:151-229)."""
    from .scan import coeff_scan_table
    lw, lh = LOG2[w], LOG2[h]
    scan = coeff_scan_table(lw, lh)
    qf = q.reshape(-1)
    cf = coef.reshape(-1)
    du = delta_u.reshape(-1)
    last_cg = -1
    for subset in range((w * h - 1) >> 4, -1, -1):
        subpos = subset << 4
        sub_scan = scan[subpos:subpos + 16]
        vals = qf[sub_scan]
        nz = np.nonzero(vals)[0]
        if len(nz) == 0:
            if last_cg == 1:
                last_cg = 0
            continue
        first_nz, last_nz = int(nz[0]), int(nz[-1])
        abssum = int(vals[first_nz:last_nz + 1].sum())
        if last_cg == -1:
            last_cg = 1
        if last_nz - first_nz >= 4:
            signbit = 0 if qf[sub_scan[first_nz]] > 0 else 1
            if signbit != (abssum & 1):
                min_cost, min_pos, final_change = 0x7FFFFFFF, -1, 0
                start = last_nz if last_cg == 1 else 15
                for n in range(start, -1, -1):
                    blk = int(sub_scan[n])
                    if qf[blk] != 0:
                        if du[blk] > 0:
                            cur_cost, cur_change = -int(du[blk]), 1
                        elif n == first_nz and abs(int(qf[blk])) == 1:
                            cur_cost, cur_change = 0x7FFFFFFF, 0
                        else:
                            cur_cost, cur_change = int(du[blk]), -1
                    elif n < first_nz and ((0 if cf[blk] >= 0 else 1) != signbit):
                        cur_cost, cur_change = 0x7FFFFFFF, 0
                    else:
                        cur_cost, cur_change = -int(du[blk]), 1
                    if cur_cost < min_cost:
                        min_cost, final_change, min_pos = cur_cost, cur_change, blk
                if qf[min_pos] == 32767 or qf[min_pos] == -32768:
                    final_change = -1
                if cf[min_pos] >= 0:
                    qf[min_pos] += final_change
                else:
                    qf[min_pos] -= final_change
        if last_cg == 1:
            last_cg = 0


def dequant(q: np.ndarray, qp_scaled: int, bitdepth: int = 8,
            transform_skip: bool = False,
            qmat: np.ndarray | None = None) -> np.ndarray:
    """Dequantize an h x w level block (numpy, bit-exact).

    qmat: optional scaling-list matrix; the per-coefficient dequant
    scale becomes inv_scale * m with shift += 4 and the per-6-QP
    doubling folded into the shift (uvg_dequant_generic,
    quant-generic.c:639-660)."""
    h, w = q.shape
    log2_w, log2_h = LOG2[w], LOG2[h]
    if transform_skip:
        qp_scaled = max(qp_scaled, 4 + 6 * MIN_QP_PRIME_TS)
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - ((log2_w + log2_h) >> 1)
    needs_sqrt2 = (not transform_skip) and ((log2_w + log2_h) % 2 == 1)
    shift = 20 - QUANT_SHIFT - (0 if transform_skip else transform_shift - needs_sqrt2)
    if qmat is not None:
        shift += 4
        per = qp_scaled // 6
        dq = int(INV_QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6])             * qmat.astype(np.int64)
        if shift > per:
            add = 1 << (shift - per - 1)
            c = (q.astype(np.int64) * dq + add) >> (shift - per)
        else:
            c = np.clip(q.astype(np.int64) * dq, -32768, 32767)                 << (per - shift)
        return np.clip(c, -32768, 32767).astype(np.int16)
    scale = int(INV_QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6]) << (qp_scaled // 6)
    add = 1 << (shift - 1)
    c = (q.astype(np.int64) * scale + add) >> shift
    return np.clip(c, -32768, 32767).astype(np.int16)


# --- K14: the batched quantiser and dequantiser ----------------------------

def _check_shift(name: str, qp_scaled: int, shift: int) -> None:
    # the reference shifts int32 values by amounts it computes from the
    # traced qp_scaled; XLA's result for an amount outside [0, 31] is not
    # C's or Python's, and no encoder QP gives one
    if not 0 <= shift <= 31:
        raise ValueError(f"{name}: qp_scaled {qp_scaled} gives the shift "
                         f"{shift}, outside [0, 31]")


def quant_batch_consts(width: int, height: int, bitdepth: int,
                       is_intra_slice: bool, qp_scaled: int
                       ) -> tuple[int, int, int]:
    """(scale, add, q_bits) of make_quant_fn at qp_scaled, in its int32
    arithmetic."""
    log2_w, log2_h = LOG2[width], LOG2[height]
    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth \
        - ((log2_w + log2_h) >> 1) - needs_sqrt2
    q_bits = QUANT_SHIFT + qp_scaled // 6 + transform_shift
    _check_shift("quant_batch", qp_scaled, q_bits)
    _check_shift("quant_batch", qp_scaled, q_bits - 9)
    add = _wrap((171 if is_intra_slice else 85) << (q_bits - 9), 32)
    return int(QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6]), add, q_bits


def dequant_batch_consts(width: int, height: int, bitdepth: int,
                         qp_scaled: int) -> tuple[int, int, int]:
    """(scale, add, shift) of make_dequant_fn at qp_scaled, in its int32
    arithmetic."""
    log2_w, log2_h = LOG2[width], LOG2[height]
    needs_sqrt2 = (log2_w + log2_h) % 2 == 1
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth \
        - ((log2_w + log2_h) >> 1)
    shift = 20 - QUANT_SHIFT - (transform_shift - needs_sqrt2)
    add = 1 << (shift - 1)
    _check_shift("dequant_batch", qp_scaled, qp_scaled // 6)
    scale = _wrap(int(INV_QUANT_SCALES[int(needs_sqrt2), qp_scaled % 6])
                  << (qp_scaled // 6), 32)
    return scale, add, shift


def quant_batch_plain(coef: torch.Tensor, qp_scaled: int, bitdepth: int = 8,
                      is_intra_slice: bool = True) -> torch.Tensor:
    """K14 quantiser, plain version (the reference's make_quant_fn):
    coefficients [..., h, w] of an integer type -> levels int32,
      level = (|coef| * scale + add) >> q_bits
      q     = clip(sign(coef) * level, -32768, 32767)
    in int32 (wrapping; |INT32_MIN| stays INT32_MIN, as in XLA)."""
    coef = _int32_blocks("quant_batch", coef)
    scale, add, q_bits = quant_batch_consts(
        coef.shape[-1], coef.shape[-2], bitdepth, is_intra_slice, qp_scaled)
    c = coef.long()
    level = _wrap(c.abs() * scale + add, 32) >> q_bits
    return _wrap(c.sign() * level, 32).clamp(-32768, 32767).to(torch.int32)


def dequant_batch_plain(q: torch.Tensor, qp_scaled: int,
                        bitdepth: int = 8) -> torch.Tensor:
    """K14 dequantiser, plain version (the reference's make_dequant_fn):
    levels [..., h, w] of an integer type -> coefficients int32,
    clip((q * scale + add) >> shift, -32768, 32767) in int32 (wrapping)."""
    q = _int32_blocks("dequant_batch", q)
    scale, add, shift = dequant_batch_consts(q.shape[-1], q.shape[-2],
                                             bitdepth, qp_scaled)
    c = _wrap(q.long() * scale + add, 32) >> shift
    return c.clamp(-32768, 32767).to(torch.int32)


def _levels_input(name: str, x: torch.Tensor) -> torch.Tensor:
    """x as K14 reads it: an int16 or int32 tensor as it is, another
    integer type as int32 (the reference's astype)."""
    _check_blocks(name, x)
    return x if x.dtype in (torch.int16, torch.int32) else x.to(torch.int32)


def _launch_levels(name: str, x: torch.Tensor, *consts: int) -> torch.Tensor:
    x = x.contiguous()
    dev = kernels.check_cuda(name, x)
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    kernels.launch(name, dev, x.data_ptr(), x.numel(), x.element_size(),
                   *consts, out.data_ptr())
    return out


def quant_batch(coef: torch.Tensor, qp_scaled: int, bitdepth: int = 8,
                is_intra_slice: bool = True) -> torch.Tensor:
    """K14 quantiser: quant_batch_plain on the CPU, the CUDA kernel on the
    card (which reads int16 and int32 coefficients in place)."""
    kernels.check_batch("quant_batch", coef.numel())
    if coef.device.type == "cpu":
        return quant_batch_plain(coef, qp_scaled, bitdepth, is_intra_slice)
    coef = _levels_input("quant_batch", coef)
    return _launch_levels("quant_levels", coef, *quant_batch_consts(
        coef.shape[-1], coef.shape[-2], bitdepth, is_intra_slice, qp_scaled))


def dequant_batch(q: torch.Tensor, qp_scaled: int,
                  bitdepth: int = 8) -> torch.Tensor:
    """K14 dequantiser: dequant_batch_plain on the CPU, the CUDA kernel on
    the card (which reads int16 and int32 levels in place)."""
    kernels.check_batch("dequant_batch", q.numel())
    if q.device.type == "cpu":
        return dequant_batch_plain(q, qp_scaled, bitdepth)
    q = _levels_input("dequant_batch", q)
    return _launch_levels("dequant_levels", q, *dequant_batch_consts(
        q.shape[-1], q.shape[-2], bitdepth, qp_scaled))


# --- K14's arithmetic as csrc/quant.cu computes it ---------------------------

_U32 = 0xFFFFFFFF


def _levels_sep(name: str, x: torch.Tensor, quant: bool, scale: int,
                add: int, shift: int) -> torch.Tensor:
    """The kernel's elementwise pass over x as it reads it (int16 or int32
    in place, any contiguous view): eight elements a thread from the
    output's first 16-byte boundary (a fresh output: element 0), the last n
    mod 8 elements one a thread, each in uint32 with the sign and |c| as
    selects: s = c >> 31 (all ones or none), |c| = (c ^ s) - s, level =
    (|c| scale + add) >> shift, q = (level ^ s) - s, 0 where c is 0."""
    x = _levels_input(name, x).contiguous()
    flat = x.reshape(-1).long()
    n = flat.numel()
    nvec = n // 8

    def op(c):
        if not quant:
            return (_wrap(c * scale + add, 32) >> shift).clamp(-32768, 32767)
        s = (c >> 31) & _U32
        a = ((c & _U32) ^ s) - s & _U32
        level = _wrap(a * scale + add, 32) >> shift
        q = _wrap(((level & _U32) ^ s) - s, 32)
        return torch.where(c == 0, 0, q).clamp(-32768, 32767)

    out = torch.cat([op(flat[:8 * nvec].reshape(nvec, 8)).reshape(-1),
                     op(flat[8 * nvec:])])
    return out.to(torch.int32).reshape(x.shape)


def quant_batch_sep(coef: torch.Tensor, qp_scaled: int, bitdepth: int = 8,
                    is_intra_slice: bool = True) -> torch.Tensor:
    """K14 quantiser as csrc/quant.cu computes it (_levels_sep), for int16
    and int32 inputs and views at an offset. Same arguments and result as
    quant_batch_plain, which it must equal bit for bit."""
    _check_blocks("quant_batch", coef)
    return _levels_sep("quant_batch", coef, True, *quant_batch_consts(
        coef.shape[-1], coef.shape[-2], bitdepth, is_intra_slice, qp_scaled))


def dequant_batch_sep(q: torch.Tensor, qp_scaled: int,
                      bitdepth: int = 8) -> torch.Tensor:
    """K14 dequantiser as csrc/quant.cu computes it (_levels_sep). Same
    arguments and result as dequant_batch_plain."""
    _check_blocks("dequant_batch", q)
    return _levels_sep("dequant_batch", q, False, *dequant_batch_consts(
        q.shape[-1], q.shape[-2], bitdepth, qp_scaled))

"""Transform-skip residual coding (TSRC): encoder + parsing mirror.

Behavioral parity with the reference:
- uvg_encode_ts_residual (encode_coding_tree.c:218-399): forward-scan
  coefficient groups, three passes (sig/sign/gt1/par ctx pass, gt2..gt8
  cutoff pass, bypass remainder pass) with the shared maxCtxBins budget
- context derivations: context.c uvg_context_get_sig_coeff_group_ts:662,
  uvg_context_get_sig_ctx_idx_abs_ts:729, uvg_sign_ctx_id_abs_ts:747,
  uvg_derive_mod_coeff:784, uvg_lrg1_ctx_id_abs_ts:810

The level prediction (derive_mod_coeff) references already-coded left and
above neighbors of the ORIGINAL level map, so the decoder reconstructs
levels in the same forward scan order.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.ctx_tables import OFF
from ..ops.scan import coeff_scan_table, log2_sbb_size

LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6}


def _sig_ctx(levels, px, py):
    n = 0
    if px > 0 and levels[py, px - 1]:
        n += 1
    if py > 0 and levels[py - 1, px]:
        n += 1
    return n


def _sign_ctx(levels, px, py):
    r = int(np.sign(levels[py, px - 1])) if px > 0 else 0
    b = int(np.sign(levels[py - 1, px])) if py > 0 else 0
    if (r == 0 and b == 0) or r * b < 0:
        return 0
    return 1 if (r >= 0 and b >= 0) else 2


def _gt1_ctx(levels, px, py):
    return _sig_ctx(levels, px, py)   # same neighbor count derivation


def _mod_coeff(levels, px, py, abs_coeff):
    """uvg_derive_mod_coeff (level prediction remap)."""
    if abs_coeff == 0:
        return 0
    right = abs(int(levels[py, px - 1])) if px > 0 else 0
    below = abs(int(levels[py - 1, px])) if py > 0 else 0
    pred1 = max(right, below)
    if abs_coeff == pred1:
        return 1
    return abs_coeff + 1 if abs_coeff < pred1 else abs_coeff


def encode_ts_residual(cabac, coeff: np.ndarray) -> None:
    """Encode one transform-skip TU's levels (luma)."""
    h, w = coeff.shape
    lw, lh = LOG2[w], LOG2[h]
    cgw, cgh = log2_sbb_size(lw, lh)
    log2_cg = cgw + cgh
    cg_size = 1 << log2_cg
    scan = coeff_scan_table(lw, lh)
    flat = coeff.reshape(-1).astype(np.int64)
    n = w * h
    n_cg = n >> log2_cg
    cg_width = min(32, w) >> cgw

    sig_group = np.zeros(n_cg, dtype=bool)
    from ..ops.scan import cg_scan_table
    scan_cg = cg_scan_table(lw, lh)
    for i in range(n):
        if flat[scan[i]]:
            sig_group[scan_cg[i >> log2_cg]] = True
    scan_cg_last = (n - 1) >> log2_cg
    max_ctx_bins = (n * 7) >> 2
    no_sig_before_last = True

    for i in range(scan_cg_last + 1):
        if not ((w == 4 and h == 4)
                or (i == scan_cg_last and no_sig_before_last)):
            cg_blk = int(scan_cg[i])
            cgy, cgx = divmod(cg_blk, cg_width)
            left = sig_group[cg_blk - 1] if cgx > 0 else 0
            above = sig_group[cg_blk - cg_width] if cgy > 0 else 0
            ctx = int(left) + int(above)
            bit = bool(sig_group[cg_blk])
            cabac.encode_bin(OFF["ts_sig_coeff_group"] + ctx, int(bit))
            if not bit:
                continue
            no_sig_before_last = False
        first = i << log2_cg
        last = first + cg_size - 1
        infer_pos = last
        num_nonzero = 0
        last_pass1 = -1
        last_pass2 = -1
        pos = first
        while pos <= last and max_ctx_bins >= 4:
            blk = int(scan[pos])
            py, px = divmod(blk, w)
            c = int(flat[blk])
            sig = c != 0
            if num_nonzero or pos != infer_pos:
                cabac.encode_bin(
                    OFF["ts_sig"] + _sig_ctx(coeff, px, py), int(sig))
                max_ctx_bins -= 1
            if sig:
                cabac.encode_bin(
                    OFF["ts_res_sign"] + _sign_ctx(coeff, px, py),
                    1 if c < 0 else 0)
                max_ctx_bins -= 1
                num_nonzero += 1
                mod = _mod_coeff(coeff, px, py, abs(c))
                rem = mod - 1
                gt1 = rem != 0
                cabac.encode_bin(
                    OFF["ts_gt1"] + _gt1_ctx(coeff, px, py), int(gt1))
                max_ctx_bins -= 1
                if gt1:
                    rem -= 1
                    cabac.encode_bin(OFF["ts_par"], rem & 1)
                    max_ctx_bins -= 1
            last_pass1 = pos
            pos += 1

        # pass 2: gt2..gt8 cutoff flags
        pos = first
        while pos <= last and max_ctx_bins >= 4:
            blk = int(scan[pos])
            py, px = divmod(blk, w)
            mod = _mod_coeff(coeff, px, py, abs(int(flat[blk])))
            cutoff = 2
            for _j in range(4):
                if mod >= cutoff:
                    cabac.encode_bin(OFF["ts_gt2"] + (cutoff >> 1),
                                     1 if mod >= cutoff + 2 else 0)
                    max_ctx_bins -= 1
                cutoff += 2
            last_pass2 = pos
            pos += 1

        # pass 3: bypass remainders (and bypass signs past pass 1)
        for pos in range(first, last + 1):
            blk = int(scan[pos])
            py, px = divmod(blk, w)
            cutoff = 10 if pos <= last_pass2 else \
                (2 if pos <= last_pass1 else 0)
            if cutoff:
                mod = _mod_coeff(coeff, px, py, abs(int(flat[blk])))
            else:
                mod = abs(int(flat[blk]))
            if mod >= cutoff:
                rem = (mod - cutoff) >> 1 if pos <= last_pass1 else mod
                cabac.write_coeff_remain(rem, 1, 5)
                if mod and pos > last_pass1:
                    cabac.encode_bin_ep(1 if flat[blk] < 0 else 0)


def decode_ts_residual(dec, w: int, h: int) -> np.ndarray:
    """Parsing mirror of encode_ts_residual.

    Decodes in the mod-value domain: pass 1 gives the value lower bound
    (1 or 2+parity), pass 2 gt-flags extend it by 2 per flag, pass 3
    remainders complete it; the mod -> abs remap (inverse of
    uvg_derive_mod_coeff) runs in scan order during pass 3, when the
    neighbors' final levels are already known."""
    lw, lh = LOG2[w], LOG2[h]
    cgw, cgh = log2_sbb_size(lw, lh)
    log2_cg = cgw + cgh
    cg_size = 1 << log2_cg
    scan = coeff_scan_table(lw, lh)
    from ..ops.scan import cg_scan_table
    scan_cg = cg_scan_table(lw, lh)
    n = w * h
    n_cg = n >> log2_cg
    cg_width = min(32, w) >> cgw
    levels = np.zeros((h, w), dtype=np.int64)   # final values
    sigm = np.zeros((h, w), dtype=np.int64)     # +-1 significance/sign map
    sig_group = np.zeros(n_cg, dtype=bool)
    scan_cg_last = (n - 1) >> log2_cg
    max_ctx_bins = (n * 7) >> 2
    no_sig_before_last = True

    def sig_ctx(px, py):
        n_ = 0
        if px > 0 and sigm[py, px - 1]:
            n_ += 1
        if py > 0 and sigm[py - 1, px]:
            n_ += 1
        return n_

    def sign_ctx(px, py):
        r = int(sigm[py, px - 1]) if px > 0 else 0
        b = int(sigm[py - 1, px]) if py > 0 else 0
        if (r == 0 and b == 0) or r * b < 0:
            return 0
        return 1 if (r >= 0 and b >= 0) else 2

    for i in range(scan_cg_last + 1):
        if not ((w == 4 and h == 4)
                or (i == scan_cg_last and no_sig_before_last)):
            cg_blk = int(scan_cg[i])
            cgy, cgx = divmod(cg_blk, cg_width)
            left = sig_group[cg_blk - 1] if cgx > 0 else 0
            above = sig_group[cg_blk - cg_width] if cgy > 0 else 0
            ctx = int(left) + int(above)
            bit = bool(dec.decode_bin(OFF["ts_sig_coeff_group"] + ctx))
            sig_group[cg_blk] = bit
            if not bit:
                continue
            no_sig_before_last = False
        first = i << log2_cg
        last = first + cg_size - 1
        infer_pos = last
        num_nonzero = 0
        last_pass1 = -1
        last_pass2 = -1
        wv = {}          # pos -> working mod value
        sgn = {}         # pos -> sign (0/1)
        pos = first
        while pos <= last and max_ctx_bins >= 4:
            blk = int(scan[pos])
            py, px = divmod(blk, w)
            if num_nonzero or pos != infer_pos:
                sig = bool(dec.decode_bin(OFF["ts_sig"] + sig_ctx(px, py)))
                max_ctx_bins -= 1
            else:
                sig = True
            if sig:
                sign = dec.decode_bin(OFF["ts_res_sign"] + sign_ctx(px, py))
                max_ctx_bins -= 1
                num_nonzero += 1
                gt1 = dec.decode_bin(OFF["ts_gt1"] + sig_ctx(px, py))
                max_ctx_bins -= 1
                v = 1
                if gt1:
                    par = dec.decode_bin(OFF["ts_par"])
                    max_ctx_bins -= 1
                    v = 2 + par
                wv[pos] = v
                sgn[pos] = sign
                sigm[py, px] = -1 if sign else 1
            last_pass1 = pos
            pos += 1

        pos = first
        while pos <= last and max_ctx_bins >= 4:
            v = wv.get(pos, 0)
            cutoff = 2
            for _j in range(4):
                if v >= cutoff:
                    gt = dec.decode_bin(OFF["ts_gt2"] + (cutoff >> 1))
                    max_ctx_bins -= 1
                    if gt:
                        v += 2
                cutoff += 2
            if pos in wv:
                wv[pos] = v
            last_pass2 = pos
            pos += 1

        for pos in range(first, last + 1):
            blk = int(scan[pos])
            py, px = divmod(blk, w)
            if pos <= last_pass1:
                v = wv.get(pos, 0)
                cutoff = 10 if pos <= last_pass2 else 2
                if v >= cutoff:
                    rem = dec.decode_coeff_remain(1, 5)
                    v += 2 * rem
                if v:
                    levels[py, px] = _unmod(levels, px, py, v)                         * (-1 if sgn[pos] else 1)
            else:
                # ctx budget exhausted: plain level + bypass sign
                v = dec.decode_coeff_remain(1, 5)
                if v:
                    sign = dec.decode_bin_ep()
                    levels[py, px] = -v if sign else v
                    sigm[py, px] = -1 if sign else 1
    return levels


def _unmod(levels, px, py, mod):
    """Inverse of _mod_coeff given already-final neighbor levels."""
    right = abs(int(levels[py, px - 1])) if px > 0 else 0
    below = abs(int(levels[py - 1, px])) if py > 0 else 0
    pred1 = max(right, below)
    if pred1 == 0:
        return mod
    if mod == 1:
        return pred1
    return mod - 1 if mod <= pred1 else mod

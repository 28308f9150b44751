"""The benchmark's plain reference of the port's intra frame search.

Plain PyTorch, frozen: the reference lines and source blocks of a class
lattice (the port's K1), the 67-mode prediction (K2), the per-mode SATD
(K3), the mode decision and the RD cost of the winner (K4), the 16x16
pseudo-reconstruction that the P-frame intra screen reads its reference
lines from (K5), and the partition DP over the size classes. The
functions whose names end in ``_plain`` are copies of the port's plain
versions (``uvg266_tpu_torch/ops/intra_batch.py``, ``ops/rd_cost.py``,
``ops/pseudo_recon.py``; the transform helpers of ``ops/transforms.py``)
as they stood when the benchmark was written; ``search_frame`` and
``dp`` restate ``control/encoder.py`` ``_frames_search`` and
``control/partition.py`` ``_dp`` for the square QT lattice. Nothing here
imports the port or JAX, and every table is built here from
``tables.py``.

``cost_dtype`` selects the precision of the float costs (the mode cost
SATD + sqrt(lambda) * mode bits and the RD cost SSD + lambda * bits):
float32 as the program states, or bfloat16 for the control that a
correct run must be told apart from.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .tables import (CUBIC_FILTER, FAST_COEFF_WTS, HOR_VER_DIST_THRES, INF,
                     INV_QUANT_SCALES, LCU, MODE_BITS, MODEDISP2INVSAMPLEDISP,
                     MODEDISP2SAMPLEDISP, PRE_SCALE, QUANT_SCALES,
                     SPLIT_BITS_EST, dct2_matrix, qp_to_lambda,
                     wide_angle_correction)

REF_LEN = 3 * 64 + 3
SEC_TOP, SEC_LEFT, SEC_FTOP, SEC_FLEFT = 0, 1, 2, 3
LOG2 = {4: 2, 8: 3, 16: 4, 32: 5, 64: 6}
NUM_MODES = 67
# elements of the largest intermediate a plain function builds per chunk
_PLAIN_CHUNK = 1 << 24
TILE = 16


def fwd_shifts(width: int, height: int, bitdepth: int) -> tuple[int, int]:
    return LOG2[width] - 1 + bitdepth - 8, LOG2[height] - 1 + 7


def inv_shifts(bitdepth: int) -> tuple[int, int]:
    return 7, 20 - bitdepth


def _wrap(x, bits: int):
    """Two's-complement wrap of an int64 tensor to ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 product a [..., m, k] @ b [..., k, n]."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)



def _sec(section: int, idx):
    return section * REF_LEN + int(idx)


@lru_cache(maxsize=None)
def build_mode_tables(w: int, h: int, bitdepth: int = 8,
                      is_chroma: bool = False):
    """Static tables for all 67 modes of a w x h PU (PU == CU)."""
    log2_w, log2_h = LOG2[w], LOG2[h]
    K = np.zeros((NUM_MODES, h, w, 4), dtype=np.int32)    # gather indices
    W = np.zeros((NUM_MODES, h, w, 4), dtype=np.int32)    # <<6-domain weights
    needs_clip = np.zeros((NUM_MODES,), dtype=bool)
    # gradient PDPC (positive angular): out += (wl*(side - out) + 32) >> 6
    pdpc_on = np.zeros((NUM_MODES,), dtype=bool)
    pdpc_wl = np.zeros((NUM_MODES, h, w), dtype=np.int32)
    pdpc_sidx = np.zeros((NUM_MODES, h, w), dtype=np.int32)
    # pure hor/ver PDPC: out = clip(out + (wl*(side - topleft) + 32) >> 6)
    hv_on = np.zeros((NUM_MODES,), dtype=bool)
    hv_topleft = np.zeros((NUM_MODES,), dtype=np.int32)
    hv_sidx = np.zeros((NUM_MODES, h, w), dtype=np.int32)
    hv_wl = np.zeros((NUM_MODES, h, w), dtype=np.int32)

    for mode in range(2, 67):
        pred_mode = wide_angle_correction(mode, log2_w, log2_h)
        vertical = pred_mode >= 34
        mode_disp = pred_mode - 50 if vertical else -(pred_mode - 18)
        sample_disp = (-1 if mode_disp < 0 else 1) * int(
            MODEDISP2SAMPLEDISP[abs(mode_disp)])
        frac_mode = (abs(sample_disp) & 0x1F) != 0
        side_size_log2 = log2_h if vertical else log2_w
        scale = min(2, side_size_log2 - int(PRE_SCALE[abs(mode_disp)]))

        # reference smoothing + cubic/gauss selection (intra_predict_regular)
        smooth = False
        use_cubic = True
        if not is_chroma and not (w == 4 and h == 4):
            thres = HOR_VER_DIST_THRES[(log2_w + log2_h) >> 1]
            dist = min(abs(pred_mode - 50), abs(pred_mode - 18))
            if dist > thres:
                if frac_mode:
                    use_cubic = False
                else:
                    smooth = True
        main_sec = (SEC_FTOP if smooth else SEC_TOP) if vertical else \
                   (SEC_FLEFT if smooth else SEC_LEFT)
        side_sec = (SEC_FLEFT if smooth else SEC_LEFT) if vertical else \
                   (SEC_FTOP if smooth else SEC_TOP)

        # work orientation: ww columns, hh rows; horizontal modes transpose
        ww, hh = (w, h) if vertical else (h, w)

        def out_pos(work_y, work_x):
            return (work_y, work_x) if vertical else (work_x, work_y)

        # extended main reference map: ext_idx[p] -> r index
        if sample_disp < 0:
            base = hh
            ext_len = base + ww + 8
            ext_idx = np.zeros(ext_len, dtype=np.int64)
            for i in range(min(ww + 2, ext_len - base)):
                ext_idx[base + i] = _sec(main_sec, i)
            inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
            for i in range(-hh, 0):
                ext_idx[base + i] = _sec(side_sec, min((-i * inv + 256) >> 9, hh))
        else:
            base = 0
            ext_len = ((sample_disp * hh) >> 5) + ww + 8
            ext_idx = np.array([_sec(main_sec, min(i, REF_LEN - 1))
                                for i in range(ext_len)], dtype=np.int64)

        for yy in range(hh):
            delta_pos = sample_disp * (yy + 1)
            delta_int = delta_pos >> 5
            delta_fract = delta_pos & 31
            if frac_mode:
                if not is_chroma:
                    if use_cubic:
                        wrow = np.asarray(CUBIC_FILTER[delta_fract])
                    else:
                        wrow = np.array([16 - (delta_fract >> 1),
                                         32 - (delta_fract >> 1),
                                         16 + (delta_fract >> 1),
                                         delta_fract >> 1], dtype=np.int32)
                    toff = 0
                else:
                    d = delta_fract
                    wrow = np.array([2 * (32 - d), 2 * d, 0, 0], dtype=np.int32)
                    toff = 1
            else:
                wrow = np.array([64, 0, 0, 0], dtype=np.int32)
                toff = 1
            for xx in range(ww):
                p0 = base + delta_int + xx + toff
                oy, ox = out_pos(yy, xx)
                K[mode, oy, ox] = [ext_idx[min(max(p0 + t, 0), ext_len - 1)]
                                   for t in range(4)]
                W[mode, oy, ox] = wrow
        needs_clip[mode] = frac_mode and not is_chroma

        # --- PDPC ---
        pdpc_ok = (w >= 4 and h >= 4)
        if 1 < pred_mode < 67:
            if mode_disp < 0:
                pdpc_ok = False
            elif mode_disp > 0:
                pdpc_ok = pdpc_ok and scale >= 0
        if sample_disp != 0:
            if pdpc_ok and sample_disp > 0:
                pdpc_on[mode] = True
                inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
                lim = min(3 << scale, ww)
                for yy in range(hh):
                    inv_angle_sum = 256
                    for xx in range(lim):
                        inv_angle_sum += inv
                        oy, ox = out_pos(yy, xx)
                        pdpc_wl[mode, oy, ox] = 32 >> ((2 * xx) >> scale)
                        pdpc_sidx[mode, oy, ox] = _sec(
                            side_sec, min(yy + (inv_angle_sum >> 9) + 1,
                                          REF_LEN - 1))
        else:
            if pdpc_ok:
                hv_on[mode] = True
                sc2 = (log2_w + log2_h - 2) >> 2
                hv_topleft[mode] = _sec(main_sec, 0)
                for yy in range(hh):
                    for xx in range(min(3 << sc2, ww)):
                        oy, ox = out_pos(yy, xx)
                        hv_wl[mode, oy, ox] = 32 >> ((2 * xx) >> sc2)
                        hv_sidx[mode, oy, ox] = _sec(side_sec, 1 + yy)

    # planar/DC PDPC weights (pdpc_planar_dc)
    scale_pd = (log2_w + log2_h - 2) >> 2
    xs = np.arange(w)
    ys = np.arange(h)
    pd_wl = (32 >> np.minimum(31, (xs * 2) >> scale_pd)).astype(np.int32)
    pd_wt = (32 >> np.minimum(31, (ys * 2) >> scale_pd)).astype(np.int32)

    return {
        "K": K, "W": W, "needs_clip": needs_clip,
        "pdpc_on": pdpc_on, "pdpc_wl": pdpc_wl, "pdpc_sidx": pdpc_sidx,
        "hv_on": hv_on, "hv_topleft": hv_topleft, "hv_sidx": hv_sidx,
        "hv_wl": hv_wl, "pd_wl": pd_wl, "pd_wt": pd_wt,
        "w": w, "h": h, "bitdepth": bitdepth, "is_chroma": is_chroma,
        "log2_w": log2_w, "log2_h": log2_h,
    }


def _chunks(n: int, per_item: int):
    step = max(1, _PLAIN_CHUNK // max(per_item, 1))
    for b0 in range(0, n, step):
        yield slice(b0, min(b0 + step, n))


def _grid_xy(grid, device):
    """Raster-ordered block origins (xs, ys) [B] of a static grid."""
    x0, y0, sx, sy, gx, gy = grid
    xs = x0 + sx * torch.arange(gx, device=device)
    ys = y0 + sy * torch.arange(gy, device=device)
    return xs.repeat(gy), ys.repeat_interleave(gx)


def _smooth_pack(top, left, w: int, h: int):
    """[1 2 1]/4 smoothing + 4-section packing (the reference's
    _smooth_pack, intra_batch.py:600)."""
    rw = 2 * w + 1
    rh = 2 * h + 1
    ft = top.clone()
    fl = left.clone()
    fl[:, 1:rh - 1] = (left[:, :rh - 2] + 2 * left[:, 1:rh - 1]
                       + left[:, 2:rh] + 2) >> 2
    ft[:, 1:rw - 1] = (top[:, :rw - 2] + 2 * top[:, 1:rw - 1]
                       + top[:, 2:rw] + 2) >> 2
    f0 = (left[:, 1] + 2 * left[:, 0] + top[:, 1] + 2) >> 2
    fl[:, 0] = f0
    ft[:, 0] = f0
    return torch.cat([top, left, ft, fl], dim=1)


def refs_blocks_grid_plain(src: torch.Tensor, w: int, h: int, grid,
                           refsrc: torch.Tensor | None = None):
    """K1, plain version. src [H, W] (or [F, H, W]) int32 -> (refs
    [F*B, 4*REF_LEN], blocks [F*B, h, w]) int32 for the blocks of the
    static grid (x0, y0, sx, sy, gx, gy), frames outermost. The edge-padded
    plane of the reference is read through clamped coordinates:
    P[r, c] = refsrc[clamp(r - 1), clamp(c - 1)]. ``refsrc`` (default: src
    itself) is a plane of src's shape the top/left references are read from
    while the blocks still come from src (the QP-matched pseudo-recon of
    inter slices)."""
    s = src if src.dim() == 3 else src[None]
    rs = s if refsrc is None else refsrc.reshape(s.shape)
    F, H, W = s.shape
    xs, ys = _grid_xy(grid, s.device)
    B = xs.numel()
    Lt = min(3 * w + 3, REF_LEN)
    Ll = min(3 * h + 3, REF_LEN)
    i = torch.arange(REF_LEN, device=s.device)[None, :]

    def padded(r, c):
        return rs[:, (r - 1).clamp(0, H - 1), (c - 1).clamp(0, W - 1)]

    top = padded(ys[:, None].expand(B, REF_LEN),
                 xs[:, None] + i.clamp(max=Lt - 1))
    left = padded(ys[:, None] + i.clamp(max=Ll - 1),
                  xs[:, None].expand(B, REF_LEN))
    refs = _smooth_pack(top.reshape(F * B, REF_LEN),
                        left.reshape(F * B, REF_LEN), w, h)
    ry = (ys[:, None, None] + torch.arange(h, device=s.device)[None, :, None])
    cx = (xs[:, None, None] + torch.arange(w, device=s.device)[None, None, :])
    blocks = s[:, ry.clamp(0, H - 1), cx.clamp(0, W - 1)]
    return refs, blocks.reshape(F * B, h, w)


def predict67_plain(refs: torch.Tensor, tables: dict) -> torch.Tensor:
    """K2, plain version: refs [B, 4*REF_LEN] int32 -> [B, 67, h, w] int32
    predictions, with make_predict_fn's gather arithmetic; ``tables`` from
    class_tables."""
    M = tables["K"].shape[0]
    w, h = tables["w"], tables["h"]
    log2_w, log2_h = tables["log2_w"], tables["log2_h"]
    max_pix = (1 << tables["bitdepth"]) - 1
    K = tables["K"].long()
    Wt = tables["W"].int()
    needs_clip = tables["needs_clip"][None, :, None, None]
    pdpc_on = tables["pdpc_on"][None, :, None, None]
    pdpc_wl = tables["pdpc_wl"].int()[None]
    pdpc_sidx = tables["pdpc_sidx"].long()
    hv_on = tables["hv_on"][None, :, None, None]
    hv_topleft = tables["hv_topleft"].long()
    hv_sidx = tables["hv_sidx"].long()
    hv_wl = tables["hv_wl"].int()[None]
    pd_wl = tables["pd_wl"][None, None, :]
    pd_wt = tables["pd_wt"][None, :, None]
    apply_pd_pdpc = w >= 4 and h >= 4
    planar_filtered = (not tables["is_chroma"]) and (w * h > 32)
    psec_t = SEC_FTOP if planar_filtered else SEC_TOP
    psec_l = SEC_FLEFT if planar_filtered else SEC_LEFT
    dev = refs.device
    xs1 = torch.arange(1, w + 1, dtype=torch.int32, device=dev)[None, None, :]
    ys1 = torch.arange(1, h + 1, dtype=torch.int32, device=dev)[None, :, None]
    out = torch.empty((refs.shape[0], M, h, w), dtype=torch.int32,
                      device=dev)

    for sl in _chunks(refs.shape[0], M * h * w * 4):
        r = refs[sl]
        ang = (r[:, K] * Wt).sum(-1, dtype=torch.int32)
        ang = (ang + 32) >> 6
        ang = torch.where(needs_clip, ang.clamp(0, max_pix), ang)
        side = r[:, pdpc_sidx]
        ang = torch.where(pdpc_on, ang + ((pdpc_wl * (side - ang) + 32) >> 6),
                          ang)
        side_hv = r[:, hv_sidx]
        topleft = r[:, hv_topleft][:, :, None, None]
        corr_hv = (hv_wl * (side_hv - topleft) + 32) >> 6
        ang = torch.where(hv_on, (ang + corr_hv).clamp(0, max_pix), ang)

        def sec(k, off, n):
            return r[:, k * REF_LEN + off:k * REF_LEN + off + n]

        t_w = sec(psec_t, 1, w)
        l_h = sec(psec_l, 1, h)
        top_right = r[:, psec_t * REF_LEN + w + 1][:, None, None]
        bottom_left = r[:, psec_l * REF_LEN + h + 1][:, None, None]
        hor = (l_h[:, :, None] << log2_w) + (top_right - l_h[:, :, None]) * xs1
        ver = (t_w[:, None, :] << log2_h) + (bottom_left - t_w[:, None, :]) * ys1
        planar = ((hor << log2_h) + (ver << log2_w)
                  + (1 << (log2_w + log2_h))) >> (1 + log2_w + log2_h)

        s = torch.zeros((r.shape[0],), dtype=torch.int32, device=dev)
        if w >= h:
            s = s + sec(SEC_TOP, 1, w).sum(-1, dtype=torch.int32)
        if w <= h:
            s = s + sec(SEC_LEFT, 1, h).sum(-1, dtype=torch.int32)
        denom = (w << 1) if w == h else max(w, h)
        dc = (s + (denom >> 1)) >> (denom.bit_length() - 1)
        dcp = dc[:, None, None].expand(planar.shape)

        if apply_pd_pdpc:
            def pd_pdpc(p, tsec, lsec):
                tt = sec(tsec, 1, w)[:, None, :]
                ll = sec(lsec, 1, h)[:, :, None]
                return p + ((pd_wl * (ll - p) + pd_wt * (tt - p) + 32) >> 6)
            planar = pd_pdpc(planar, psec_t, psec_l)
            dcp = pd_pdpc(dcp, SEC_TOP, SEC_LEFT)
        ang[:, 0] = planar.clamp(0, max_pix)
        ang[:, 1] = dcp.clamp(0, max_pix)
        out[sl] = ang
    return out


def _fwht(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Walsh-Hadamard transform (Sylvester order, x @ H with the matrix of
    make_satd67_fn) along ``dim`` as butterflies of adds."""
    x = x.movedim(dim, -1)
    lead, n = x.shape[:-1], x.shape[-1]
    half = 1
    while half < n:
        y = x.reshape(*lead, n // (2 * half), 2, half)
        a, b = y[..., 0, :], y[..., 1, :]
        x = torch.stack((a + b, a - b), dim=-2).reshape(*lead, n)
        half *= 2
    return x.movedim(-1, dim)


def satd67_plain(preds: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """K3, plain version: (preds [B, M, h, w], src [B, h, w]) int32 ->
    [B, M] int32 SATD, as make_satd67_fn computes it."""
    B, M, h, w = preds.shape
    n = 8 if (w >= 8 and h >= 8) else 4
    add, shift = (2, 2) if n == 8 else (1, 1)
    out = torch.empty((B, M), dtype=torch.int32, device=preds.device)
    for sl in _chunks(B, M * h * w * 4):
        d = src[sl][:, None] - preds[sl]
        d = d.reshape(d.shape[0], M, h // n, n, w // n, n).transpose(3, 4)
        t = _fwht(_fwht(d, -1), -2).abs()
        s = t.sum(dim=(-2, -1), dtype=torch.int32)
        dc = t[..., 0, 0]
        s = (s - dc + (dc >> 2) + add) >> shift
        out[sl] = s.sum(dim=(-2, -1), dtype=torch.int32)
    return out


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
                   mat_w, mat_h, mask=None, cost_dtype=torch.float32):
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
    cnt = [(bucket == k).sum(dim=(-2, -1)).to(cost_dtype)
           for k in range(4)]
    wts = wts.to(cost_dtype)
    bits = ((cnt[0] * wts[0] + cnt[1] * wts[1]) + cnt[2] * wts[2]) \
        + cnt[3] * wts[3]
    dq = _wrap(coef.sign() * level * c["iscale"]
               + (1 << (c["dq_shift"] - 1)), 32) >> c["dq_shift"]
    dq = dq.clamp(-32768, 32767)
    u = ((_imatmul(mh.T, dq) + (1 << (si1 - 1))) >> si1).clamp(-32768, 32767)
    r = ((_imatmul(u, mw) + (1 << (si2 - 1))) >> si2).clamp(-32768, 32767)
    d = blk - (pred + r).clamp(0, (1 << bitdepth) - 1)
    return (bits, _wrap((d * d).sum(dim=(-2, -1)), 32).to(torch.float32)
            .to(cost_dtype), level)


def rd_cost_plain(preds, src, satds, qp: int, lam: float, wts, mode_bits,
                  tables: dict, bitdepth: int, cost_dtype=torch.float32):
    """K4, plain version. preds [B, 67, h, w], src [B, h, w], satds [B, 67]
    int32; wts [4], mode_bits [67] float32 -> (best [B] int64, rd [B],
    mode_cost [B, 67]), the costs in ``cost_dtype``. The mode cost
    SATD + sqrt(lambda) * mode bits picks the first minimum; the RD tail
    runs on that winner."""
    B, _M, h, w = preds.shape
    c = quant_consts(w, h, bitdepth, qp)
    dev = preds.device
    lam32 = torch.tensor(np.float32(lam), device=dev)
    lamc = lam32.to(cost_dtype)
    mbc = mode_bits.to(cost_dtype)
    mode_cost = satds.to(torch.float32).to(cost_dtype) \
        + torch.sqrt(lam32).to(cost_dtype) * mbc[None, :]
    best = torch.argmin(mode_cost, dim=1)          # the first minimum
    bits = torch.empty((B,), dtype=cost_dtype, device=dev)
    ssd = torch.empty((B,), dtype=cost_dtype, device=dev)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, B, step):
        sl = slice(b0, min(b0 + step, B))
        pred = preds[sl][torch.arange(sl.stop - sl.start, device=dev),
                         best[sl]].long()
        bits[sl], ssd[sl], _lv = _rd_tail_plain(
            pred, src[sl].long(), c, w, h, bitdepth, wts, tables["mat_w"],
            tables["mat_h"], cost_dtype=cost_dtype)
    rd = ssd + lamc * (bits + mbc[best])
    return best, rd, mode_cost


def pseudo_recon_plain(src: torch.Tensor, qp_scaled: int,
                       bitdepth: int = 8) -> torch.Tensor:
    """K5, plain version: src [H, W] int32 (H, W multiples of 16) ->
    [H, W] int32, with make_pseudo_recon_fn's int32 arithmetic."""
    H, W = src.shape
    t = TILE
    c = quant_consts(t, t, bitdepth, qp_scaled)      # intra rounding 171
    s1, s2 = fwd_shifts(t, t, bitdepth)
    i1, i2 = inv_shifts(bitdepth)
    m = torch.from_numpy(dct2_matrix(t).astype(np.int64)).to(src.device)
    tiles = src.long().reshape(H // t, t, W // t, t).transpose(1, 2) \
        .reshape(-1, t, t)
    out = torch.empty(tiles.shape, dtype=torch.int32, device=src.device)
    step = max(1, _PLAIN_CHUNK // t ** 3)     # [tiles, 16, 16, 16] products
    for b0 in range(0, tiles.shape[0], step):
        blk = tiles[b0:b0 + step]
        s = blk.sum(dim=(1, 2), keepdim=True)
        dc = s >> 8                        # sum / 256, rounded half to even
        rem = s & 255
        dc = dc + ((rem > 128) | ((rem == 128) & (dc % 2 == 1))).long()
        tmp = (_imatmul(blk - dc, m.T) + (1 << (s1 - 1))) >> s1
        coef = (_imatmul(m, tmp) + (1 << (s2 - 1))) >> s2
        level = (_wrap(coef.abs() * c["scale"] + c["add"], 32)
                 >> c["q_bits"]).clamp(max=32767)
        dq = (_wrap(coef.sign() * level * c["iscale"]
                    + (1 << (c["dq_shift"] - 1)), 32)
              >> c["dq_shift"]).clamp(-32768, 32767)
        u = ((_imatmul(m.T, dq) + (1 << (i1 - 1))) >> i1).clamp(-32768, 32767)
        rr = ((_imatmul(u, m) + (1 << (i2 - 1))) >> i2).clamp(-32768, 32767)
        out[b0:b0 + step] = (rr + dc).clamp(0, (1 << bitdepth) - 1)
    return out.reshape(H // t, W // t, t, t).transpose(1, 2).reshape(H, W)


# --- the frame search, the lattice and the DP -------------------------------

def class_tables(w: int, h: int, bitdepth: int, device) -> dict:
    """The 67-mode tables of one w x h luma class and its DCT-II matrices,
    as tensors on ``device``."""
    t = dict(build_mode_tables(w, h, bitdepth, False))
    t["mat_w"] = dct2_matrix(w)
    t["mat_h"] = dct2_matrix(h)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            if isinstance(v, np.ndarray) else v for k, v in t.items()}


def lattice(width: int, height: int) -> list:
    """The square classes the search costs, largest first: (s, gx, gy),
    the blocks of side s that lie wholly inside the picture on the raster
    grid, gx across and gy down (control/partition.py: always 64..8)."""
    out = []
    for s in (LCU, LCU >> 1, LCU >> 2, LCU >> 3):
        out.append((s, width // s, height // s))
    return out


def pad_to(plane: np.ndarray, w: int, h: int) -> np.ndarray:
    """Edge-replicate a plane to h x w (int32)."""
    ph, pw = plane.shape
    out = np.empty((h, w), dtype=np.int32)
    out[:ph, :pw] = plane
    if pw < w:
        out[:ph, pw:] = plane[:, -1:]
    if ph < h:
        out[ph:, :] = out[ph - 1:ph, :]
    return out


def search_frame(src_y: np.ndarray, qp: int, bitdepth: int = 8,
                 screen: bool = False, cost_dtype=torch.float32,
                 device="cpu") -> dict:
    """The intra search of one picture: for every class of the lattice the
    reference lines (from the source, or with ``screen`` from its 16x16
    pseudo-reconstruction at the frame's QP, as the P-frame screen reads
    them), the 67 predictions, their SATDs, the mode decision and the RD
    cost of the winner. src_y [H, W] (the picture's luma, 8-bit samples)
    -> {s: {"best": [B] int32, "rd": [B] float64, "mode_cost": [B, 67]
    float32, "gx", "gy"}}, blocks in raster order."""
    H, W = src_y.shape
    H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8
    qps = qp + 6 * (bitdepth - 8)
    lam = float(np.float32(qp_to_lambda(qp)))
    dev = torch.device(device)
    wts = torch.from_numpy(
        FAST_COEFF_WTS[min(qp, len(FAST_COEFF_WTS) - 1)].astype(np.float32)
    ).to(dev)
    mode_bits = torch.from_numpy(MODE_BITS).to(dev)
    if screen:
        H16, W16 = -(-H8 // 16) * 16, -(-W8 // 16) * 16
        plane = torch.from_numpy(pad_to(src_y, W16, H16)).to(dev)
        refsrc = pseudo_recon_plain(plane, qps, bitdepth)
    else:
        plane = torch.from_numpy(pad_to(src_y, W8, H8)).to(dev)
        refsrc = None
    out = {}
    for s, gx, gy in lattice(W8, H8):
        if gx == 0 or gy == 0:
            continue
        tabs = class_tables(s, s, bitdepth, dev)
        refs, blocks = refs_blocks_grid_plain(plane, s, s,
                                              (0, 0, s, s, gx, gy), refsrc)
        best, rd, mcost = [], [], []
        step = max(1, _PLAIN_CHUNK // (NUM_MODES * s * s))
        for b0 in range(0, refs.shape[0], step):
            sl = slice(b0, min(b0 + step, refs.shape[0]))
            preds = predict67_plain(refs[sl], tabs)
            b_, r_, m_ = rd_cost_plain(
                preds, blocks[sl], satd67_plain(preds, blocks[sl]), qps, lam,
                wts, mode_bits, tabs, bitdepth, cost_dtype)
            best.append(b_)
            rd.append(r_.float())
            mcost.append(m_.float())
        out[s] = {"best": torch.cat(best).int().cpu().numpy(),
                  "rd": torch.cat(rd).cpu().numpy().astype(np.float64),
                  "mode_cost": torch.cat(mcost).cpu().numpy(),
                  "gx": gx, "gy": gy}
    return out


def dp(search: dict, width: int, height: int, qp: int):
    """The QT partition DP of control/partition.py over the classes' RD
    costs: leaf or four children plus lambda * SPLIT_BITS_EST at each
    size, a class's cost INF where no block of it lies inside the
    picture, children outside the picture costing 0. -> (choice {s:
    [gh, gw] 0 leaf / 1 split}, total {s: [gh, gw]})."""
    W8, H8 = -(-width // 8) * 8, -(-height // 8) * 8
    lam = qp_to_lambda(qp)
    sizes = [LCU >> d for d in range(4)]
    cost = {}
    for s in sizes:
        gh, gw = -(-H8 // s), -(-W8 // s)
        c = np.full((gh, gw), INF)
        e = search.get(s)
        if e is not None:
            c[:e["gy"], :e["gx"]] = e["rd"].reshape(e["gy"], e["gx"])
        cost[s] = c
    total = {sizes[-1]: cost[sizes[-1]]}
    choice = {}
    for s in sizes[-2::-1]:
        sq = cost[s]
        gh, gw = sq.shape
        ch = total[s >> 1][:gh * 2, :gw * 2]
        ch = np.pad(ch, ((0, gh * 2 - ch.shape[0]), (0, gw * 2 - ch.shape[1])),
                    constant_values=0)
        sum4 = (ch[0::2, 0::2] + ch[0::2, 1::2]
                + ch[1::2, 0::2] + ch[1::2, 1::2])
        stacked = np.stack([sq, sum4 + lam * SPLIT_BITS_EST])
        choice[s] = stacked.argmin(axis=0)
        total[s] = stacked.min(axis=0)
    return choice, total

"""The static tables of the intra search, and their move to the device.

The reference has no learned weights: its parameters are these tables,
built on the host with numpy exactly as the JAX package builds them:

- per size class: the 67-mode prediction tables of build_mode_tables
  (K, W, pdpc_*, hv_*, pd_*), the per-mode descriptors K2 computes its
  angular samples from (mode_descriptors, with a plain PyTorch emulation
  of that path for the tests, predict67_desc) and the DCT2 matrices of
  the two sides;
- per QP: the fast coefficient-cost weights FAST_COEFF_WTS and the
  quantiser scales QUANT_SCALES / INV_QUANT_SCALES;
- per MIP size id: the weight matrices of ops.mip_tables;
- per size class up to 32x32: the five MTS transform pairs (MTS_PAIRS) as
  horizontal and vertical matrices, with their zero-out masks;
- the per-mode signalling bits MODE_BITS of the mode preselection, and
  the 35 stage-1 modes ROUGH_MODES of the rough search;
- per search range: the mvd bits of every quarter-pel MV component the
  per-class inter search can give (mvd_bits_table); per lambda: its
  full-pel and quarter-pel rate penalties (me_penalties).

``tables_to_torch`` turns a dict of such numpy tables into tensors on a
device, each stored in the narrowest integer type that holds its values
(as the kernels read them); ``device_tables``, ``frame_tables``,
``mip_matrix``, ``device_mts_tables``, ``rough_modes``,
``device_mvd_bits`` and ``me_penalties`` cache the result per class, QP,
size id, search range, lambda and device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device_cache
from .fast_cost_tables import FAST_COEFF_WTS
from .intra import (CUBIC_FILTER, HOR_VER_DIST_THRES, MODEDISP2INVSAMPLEDISP,
                    MODEDISP2SAMPLEDISP, PRE_SCALE, wide_angle_correction)
from .intra_batch import LOG2, NUM_MODES, REF_LEN, build_mode_tables
from .me import make_mv_penalty, mv_bits_est
from .mip_tables import MIP_4X4, MIP_8X8, MIP_16X16
from .quant import INV_QUANT_SCALES, QUANT_SCALES
from .rd_cost import MTS_IDX, MTS_PAIRS
from .tr_matrices import DCT2, get_matrix

# rough per-mode signalling bits for the mode preselection (MPM-hit modes
# are cheaper in reality); control/encoder.py _MODE_BITS of the reference
MODE_BITS = np.full(67, 5.0, dtype=np.float32)
MODE_BITS[0] = 1.5
MODE_BITS[1] = 3.0
# stage 1 of the rough search: planar, DC and the even angular modes
# (ops/rd_cost.py make_rough_refine_fn's m1)
ROUGH_MODES = np.array([0, 1] + list(range(2, 67, 2)), dtype=np.int32)

# the type each table is stored in on the device: every K index is below
# 4*REF_LEN = 780, every weight and DCT2 entry within +-128
NARROW = {"K": np.int16, "W": np.int8, "pdpc_wl": np.int8,
          "pdpc_sidx": np.int16, "hv_wl": np.int8, "hv_sidx": np.int16,
          "hv_topleft": np.int16, "mat_w": np.int8, "mat_h": np.int8,
          "mts_w": np.int8, "mts_h": np.int8, "mts_mask": np.int8}

__all__ = ["FAST_COEFF_WTS", "INV_QUANT_SCALES", "MODE_BITS", "MTS_IDX",
           "QUANT_SCALES", "ROUGH_MODES", "class_tables",
           "compact_descriptors", "device_mts_tables",
           "mode_descriptors", "mode_reach", "mode_reads",
           "predict67_desc", "predict_modes_desc",
           "device_mvd_bits", "device_tables", "frame_tables",
           "frac_penalty", "me_penalties", "mip_matrix", "mip_mode_bits",
           "mts_class_tables", "mvd_bits_table", "rough_modes",
           "tables_to_torch"]


# the fields of a K2 mode descriptor (csrc/predict67.cu reads the same)
(D_VERT, D_MAIN, D_SIDE, D_SD, D_INV, D_FILT, D_CLIP, D_PDPC, D_PSCALE,
 D_PLIM, D_BASE, D_EXTN, D_MAINN, D_MODE) = range(14)
DESC_N = 16
FILT_INT, FILT_CUBIC, FILT_GAUSS = 0, 1, 2
PDPC_NONE, PDPC_GRAD, PDPC_HV = 0, 1, 2


def mode_descriptors(w: int, h: int) -> tuple[np.ndarray, int]:
    """The angular modes of a w x h luma block as K2 computes them: one
    int32 [DESC_N] descriptor per mode (rows 0 and 1, planar and DC, hold
    only their mode), and the longest extended main reference a mode reads.

    For mode m >= 2, in the work orientation (rows along the main
    reference: the block itself for vertical modes, its transpose for
    horizontal ones; ww columns, hh rows), the extended main reference is
    ext[p] for p in [0, D_EXTN):
      sample_disp < 0: base = hh; ext[base + j] = r[main + j] for j < ww + 2
        (r[0] beyond), ext[base - i] = r[side + min((i*inv + 256) >> 9, hh)]
        for i in 1..hh;
      else: base = 0, ext[p] = r[main + min(p, REF_LEN - 1)]
    (build_mode_tables' ext_idx; a tap reads no j >= ww + 2). Row yy takes
    deltaInt, deltaFract from
    (yy + 1) * sample_disp: an integer slope copies ext[base + deltaInt +
    xx + 1]; a fractional one filters ext[base + deltaInt + xx + t], t < 4,
    with the cubic row CUBIC_FILTER[deltaFract] or the gauss row
    (16 - f/2, 32 - f/2, 16 + f/2, f/2), then clips. Gradient PDPC (xx <
    D_PLIM): v += (wl*(r[side + min(yy + ((256 + (xx+1)*inv) >> 9) + 1,
    REF_LEN - 1)] - v) + 32) >> 6; hor/ver PDPC: v = clip(v + (wl*(r[side +
    1 + yy] - r[main]) + 32) >> 6) with the correction for xx < D_PLIM;
    wl = 32 >> ((2*xx) >> D_PSCALE). Raises if a tap would leave the
    reference's extended reference, where its table clamps the index."""
    log2_w, log2_h = LOG2[w], LOG2[h]
    desc = np.zeros((NUM_MODES, DESC_N), dtype=np.int32)
    desc[:, D_MODE] = np.arange(NUM_MODES)
    ext_max = 1
    for mode in range(2, NUM_MODES):
        pred_mode = wide_angle_correction(mode, log2_w, log2_h)
        vertical = pred_mode >= 34
        mode_disp = pred_mode - 50 if vertical else -(pred_mode - 18)
        sd = (-1 if mode_disp < 0 else 1) * int(
            MODEDISP2SAMPLEDISP[abs(mode_disp)])
        frac = (abs(sd) & 0x1F) != 0
        smooth, cubic = False, True
        if not (w == 4 and h == 4):
            dist = min(abs(pred_mode - 50), abs(pred_mode - 18))
            if dist > HOR_VER_DIST_THRES[(log2_w + log2_h) >> 1]:
                if frac:
                    cubic = False
                else:
                    smooth = True
        top, left = (2, 3) if smooth else (0, 1)
        main, side = (top, left) if vertical else (left, top)
        ww, hh = (w, h) if vertical else (h, w)
        base = hh if sd < 0 else 0
        ext_len = base + ww + 8 if sd < 0 else ((sd * hh) >> 5) + ww + 8
        taps = 4 if frac else 1
        toff = 0 if frac else 1
        lo = min(base + ((sd * (yy + 1)) >> 5) + toff for yy in range(hh))
        hi = max(base + ((sd * (yy + 1)) >> 5) + toff for yy in range(hh)) \
            + ww - 1 + taps - 1
        if lo < 0 or hi >= ext_len or (sd < 0 and hi - base >= ww + 2):
            raise ValueError(f"mode {mode} at {w}x{h}: a tap leaves ext")
        inv = int(MODEDISP2INVSAMPLEDISP[abs(mode_disp)])
        scale = min(2, (log2_h if vertical else log2_w)
                    - int(PRE_SCALE[abs(mode_disp)]))
        pdpc, pscale, plim = PDPC_NONE, 0, 0
        ok = True
        if 1 < pred_mode < 67:
            if mode_disp < 0:
                ok = False
            elif mode_disp > 0:
                ok = scale >= 0
        if sd > 0 and ok:
            pdpc, pscale, plim = PDPC_GRAD, scale, min(3 << scale, ww)
        elif sd == 0 and ok:
            sc2 = (log2_w + log2_h - 2) >> 2
            pdpc, pscale, plim = PDPC_HV, sc2, min(3 << sc2, ww)
        d = desc[mode]
        d[D_VERT], d[D_MAIN], d[D_SIDE] = vertical, main * REF_LEN, \
            side * REF_LEN
        d[D_SD], d[D_INV] = sd, inv
        d[D_FILT] = FILT_INT if not frac else (FILT_CUBIC if cubic
                                               else FILT_GAUSS)
        d[D_CLIP] = frac
        d[D_PDPC], d[D_PSCALE], d[D_PLIM] = pdpc, pscale, plim
        d[D_BASE], d[D_EXTN], d[D_MAINN] = base, hi + 1, ww + 2
        ext_max = max(ext_max, hi + 1)
    return desc, ext_max


def predict67_desc(refs: torch.Tensor, w: int, h: int, bitdepth: int,
                   modes=None) -> torch.Tensor:
    """K2's descriptor path in plain PyTorch, for the tests: refs [B,
    4*REF_LEN] int32 -> [B, M, h, w] int32, computed as csrc/predict67.cu
    computes it (mode_descriptors for the angular modes; planar and DC with
    their PDPC), for all 67 modes or the subset ``modes`` (slots 0 and 1
    planar and DC). Equal to ops.intra_batch.predict67_plain."""
    desc, _ext_max = mode_descriptors(w, h)
    ml = list(range(NUM_MODES)) if modes is None else [int(m) for m in modes]
    log2_w, log2_h = LOG2[w], LOG2[h]
    mx = (1 << bitdepth) - 1
    L = REF_LEN
    r = refs.long()
    B = r.shape[0]
    dev = refs.device
    out = torch.empty((B, len(ml), h, w), dtype=torch.int32, device=dev)
    xs = torch.arange(w, device=dev)
    ys = torch.arange(h, device=dev)
    sc = (log2_w + log2_h - 2) >> 2
    pd_wl = 32 >> ((2 * xs) >> sc).clamp(max=31)
    pd_wt = 32 >> ((2 * ys) >> sc).clamp(max=31)
    cub = torch.from_numpy(np.asarray(CUBIC_FILTER, dtype=np.int64)).to(dev)
    for slot, mode in enumerate(ml):
        d = [int(v) for v in desc[mode]]
        if mode < 2:
            if mode == 0:
                ts, ls = (2, 3) if w * h > 32 else (0, 1)
                tw = r[:, ts * L + 1 + xs][:, None, :]
                lh = r[:, ls * L + 1 + ys][:, :, None]
                tr = r[:, ts * L + w + 1][:, None, None]
                bl = r[:, ls * L + h + 1][:, None, None]
                hor = lh * (1 << log2_w) + (tr - lh) * (xs + 1)[None, None]
                ver = tw * (1 << log2_h) + (bl - tw) * (ys + 1)[None, :, None]
                v = (hor * (1 << log2_h) + ver * (1 << log2_w)
                     + (1 << (log2_w + log2_h))) >> (1 + log2_w + log2_h)
            else:
                ts, ls = 0, 1
                s = torch.zeros((B,), dtype=torch.long, device=dev)
                if w >= h:
                    s = s + r[:, 1:1 + w].sum(-1)
                if w <= h:
                    s = s + r[:, L + 1:L + 1 + h].sum(-1)
                den = (w << 1) if w == h else max(w, h)
                dc = (s + (den >> 1)) >> (den.bit_length() - 1)
                v = dc[:, None, None].expand(B, h, w)
            tt = r[:, ts * L + 1 + xs][:, None, :]
            ll = r[:, ls * L + 1 + ys][:, :, None]
            v = v + ((pd_wl[None, None] * (ll - v)
                      + pd_wt[None, :, None] * (tt - v) + 32) >> 6)
            out[:, slot] = v.clamp(0, mx).to(torch.int32)
            continue
        out[:, slot] = _angular_desc(r[:, d[D_MAIN]:d[D_MAIN] + L],
                                     r[:, d[D_SIDE]:d[D_SIDE] + L], d, w, h,
                                     mx, cub)
    return out


def _angular_desc(main, side, d, w, h, mx, cub):
    """One angular mode of every block from its descriptor ``d`` (a list of
    ints), as csrc/angular.cuh computes it: main, side [B, n] the leading
    samples of the mode's main and side reference sections (r[D_MAIN + i],
    r[D_SIDE + i]); a read past n raises. -> [B, h, w] int32."""
    L = REF_LEN
    vert = bool(d[D_VERT])
    ww, hh = (w, h) if vert else (h, w)
    base, sd, inv = d[D_BASE], d[D_SD], d[D_INV]
    dev = main.device
    # the extended main reference of every block
    p = torch.arange(d[D_EXTN], device=dev)
    if sd < 0:
        j = p - base
        # j < D_MAINN wherever a tap reads (mode_descriptors' extent)
        jj = torch.where(p >= base, j, torch.zeros_like(j))
        side_i = torch.clamp(((base - p) * inv + 256) >> 9, max=hh)
        side_i = torch.where(p >= base, torch.zeros_like(p), side_i)
        ext = torch.where((p >= base)[None], main[:, jj], side[:, side_i])
    else:
        ext = main[:, p.clamp(max=L - 1)]                 # [B, EXTN]
    yy = torch.arange(hh, device=dev)[:, None]        # work rows
    xx = torch.arange(ww, device=dev)[None, :]        # work columns
    dpos = sd * (yy + 1)
    d_int, d_fr = dpos >> 5, dpos & 31
    if d[D_FILT] == FILT_INT:
        v = ext[:, base + d_int + xx + 1]
    else:
        if d[D_FILT] == FILT_CUBIC:
            wt = cub[d_fr[:, 0]]                       # [hh, 4]
        else:
            f = d_fr[:, 0] >> 1
            wt = torch.stack([16 - f, 32 - f, 16 + f, f], dim=1)
        p0 = base + d_int + xx
        v = sum(ext[:, p0 + t] * wt[None, :, t:t + 1] for t in range(4))
        v = (v + 32) >> 6
        if d[D_CLIP]:
            v = v.clamp(0, mx)
    if d[D_PDPC] != PDPC_NONE:
        wl = torch.where(xx < d[D_PLIM], 32 >> ((2 * xx) >> d[D_PSCALE]),
                         torch.zeros_like(xx))
        if d[D_PDPC] == PDPC_GRAD:
            # only the columns xx < D_PLIM read the side reference
            sidx = torch.clamp(yy + ((256 + (xx[:, :d[D_PLIM]] + 1) * inv)
                                     >> 9) + 1, max=L - 1)
            s = torch.zeros_like(v)
            s[:, :, :d[D_PLIM]] = side[:, sidx]
            v = v + ((wl * (s - v) + 32) >> 6)
        else:
            s = side[:, 1 + yy]
            tl = main[:, 0][:, None, None]
            v = (v + ((wl * (s - tl) + 32) >> 6)).clamp(0, mx)
    return (v if vert else v.transpose(1, 2)).to(torch.int32)


def mode_reads(w: int, h: int) -> np.ndarray:
    """bool [67, 4*REF_LEN]: the reference samples each angular mode of a
    w x h block reads as K2 and K12b compute it (mode_descriptors): its
    extended main reference, p < D_EXTN, and its PDPC side samples (hor/ver
    PDPC: r[side + 1 + yy] and the top-left r[main]). Rows 0 and 1 (planar,
    DC) are empty."""
    desc, _ext_max = mode_descriptors(w, h)
    L = REF_LEN
    reads = np.zeros((NUM_MODES, 4 * L), dtype=bool)
    for mode in range(2, NUM_MODES):
        d = [int(v) for v in desc[mode]]
        hh = h if d[D_VERT] else w
        base, sd, inv = d[D_BASE], d[D_SD], d[D_INV]
        main, side = d[D_MAIN], d[D_SIDE]
        p = np.arange(d[D_EXTN])
        if sd < 0:
            idx = np.where(p >= base, main + p - base,
                           side + np.minimum(((base - p) * inv + 256) >> 9,
                                             hh))
        else:
            idx = main + np.minimum(p, L - 1)
        row = reads[mode]
        row[idx] = True
        yy = np.arange(hh)[:, None]
        xx = np.arange(d[D_PLIM])[None, :]
        if d[D_PDPC] == PDPC_GRAD:
            row[side + np.minimum(yy + ((256 + (xx + 1) * inv) >> 9) + 1,
                                  L - 1)] = True
        elif d[D_PDPC] == PDPC_HV:
            row[side + 1 + yy] = True
            row[main] = True
    return reads


def mode_reach(w: int, h: int) -> tuple:
    """(n_top, n_left, n_ftop, n_fleft): the leading samples of each
    reference section that the angular modes 2..66 of a w x h block read
    (mode_reads), the part of a block's 4*REF_LEN references K12b loads."""
    used = mode_reads(w, h).any(axis=0).reshape(4, REF_LEN)
    return tuple(int(np.nonzero(u)[0][-1]) + 1 if u.any() else 0
                 for u in used)


def compact_descriptors(w: int, h: int) -> np.ndarray:
    """mode_descriptors(w, h)[0] as K12b reads it: the main and side
    sections (D_MAIN, D_SIDE: k * REF_LEN) turned into their offsets in
    its compact copy of a block's references, the leading mode_reach(w, h)
    samples of each section one after the other (the top section, and so
    r[0], still at 0)."""
    desc = mode_descriptors(w, h)[0].copy()
    off = np.concatenate([[0], np.cumsum(mode_reach(w, h))[:3]])
    for f in (D_MAIN, D_SIDE):
        desc[:, f] = off[desc[:, f] // REF_LEN]
    return desc


def predict_modes_desc(refs: torch.Tensor, modes: torch.Tensor, w: int,
                       h: int, bitdepth: int) -> torch.Tensor:
    """K12b's route in plain PyTorch, for the tests: refs [B, 4*REF_LEN],
    modes [B, R] int32 -> [B, R, h, w] int32, computed as
    csrc/predict_modes.cu computes it: each mode clamped to [2, 66], the
    block's references cut to the leading samples of each section that the
    angular modes reach (mode_reach; a read past them raises), each slot's
    prediction from its mode's descriptor in that copy
    (compact_descriptors), duplicates computed per slot. Equal to
    ops.intra_batch.predict_modes_plain."""
    desc = compact_descriptors(w, h)
    reach = mode_reach(w, h)
    L = REF_LEN
    r = refs.long()
    rc = torch.cat([r[:, s * L:s * L + n] for s, n in enumerate(reach)], 1)
    # the sections' ends in the copy, after each one's offset
    end = dict(zip(np.cumsum([0, *reach[:3]]).tolist(), np.cumsum(reach)))
    dev = refs.device
    cub = torch.from_numpy(np.asarray(CUBIC_FILTER, dtype=np.int64)).to(dev)
    ml = modes.long().clamp(2, NUM_MODES - 1)
    B, R = ml.shape
    out = torch.empty((B, R, h, w), dtype=torch.int32, device=dev)
    for mode in torch.unique(ml).tolist():
        d = [int(v) for v in desc[mode]]
        pred = _angular_desc(rc[:, d[D_MAIN]:end[d[D_MAIN]]],
                             rc[:, d[D_SIDE]:end[d[D_SIDE]]], d, w, h,
                             (1 << bitdepth) - 1, cub)
        bi, ji = (ml == mode).nonzero(as_tuple=True)
        out[bi, ji] = pred[bi]
    return out


def class_tables(w: int, h: int, bitdepth: int) -> dict:
    """numpy tables of one luma size class: build_mode_tables, the K2 mode
    descriptors (``desc``, ``ext_max``: mode_descriptors), the reference
    samples K12b loads (``reach``: mode_reach) and the DCT2
    matrices of its width (mat_w) and height (mat_h)."""
    t = dict(build_mode_tables(w, h, bitdepth, False))
    t["desc"], t["ext_max"] = mode_descriptors(w, h)
    t["reach"] = mode_reach(w, h)
    t["mat_w"] = get_matrix(DCT2, w)
    t["mat_h"] = get_matrix(DCT2, h)
    return t


def tables_to_torch(tables: dict, device) -> dict:
    """numpy arrays -> contiguous tensors on ``device`` (narrowed per
    NARROW, raising if a value does not fit); other entries unchanged."""
    out = {}
    for k, v in tables.items():
        if isinstance(v, np.ndarray):
            dt = NARROW.get(k)
            if dt is not None:
                info = np.iinfo(dt)
                if v.size and (v.min() < info.min or v.max() > info.max):
                    raise ValueError(f"table {k} does not fit {dt.__name__}")
                v = v.astype(dt)
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        else:
            out[k] = v
    return out


@device_cache
def device_tables(w: int, h: int, bitdepth: int, device: str) -> dict:
    """class_tables(w, h, bitdepth) on ``device``, built once per process."""
    return tables_to_torch(class_tables(w, h, bitdepth), torch.device(device))


@device_cache
def frame_tables(qp: int, device: str) -> dict:
    """Per-QP cost weights ``wts`` [4] and ``mode_bits`` [67], float32 on
    ``device`` (the reference feeds both to its search as float32)."""
    wts = FAST_COEFF_WTS[min(qp, len(FAST_COEFF_WTS) - 1)].astype(np.float32)
    return tables_to_torch({"wts": wts, "mode_bits": MODE_BITS},
                           torch.device(device))


def mts_class_tables(w: int, h: int) -> dict:
    """numpy tables of the MTS search of one size class (w, h <= 32), one
    entry per candidate of MTS_IDX: the horizontal matrices ``mts_w``
    [5, w, w] and the vertical ones ``mts_h`` [5, h, h] (rows =
    frequencies), the coefficient masks ``mts_mask`` [5, h, w] and, as
    plain ints, the kept rectangle ``mts_keep`` ((keep_w, keep_h), ...):
    a 32-point DST7 or DCT8 keeps its first 16 coefficients."""
    mw, mh, masks, keep = [], [], [], []
    for idx in MTS_IDX:
        th, tv = MTS_PAIRS[idx]
        keep_w = 16 if (th != DCT2 and w == 32) else w
        keep_h = 16 if (tv != DCT2 and h == 32) else h
        mask = np.zeros((h, w), dtype=np.int32)
        mask[:keep_h, :keep_w] = 1
        mw.append(get_matrix(th, w))
        mh.append(get_matrix(tv, h))
        masks.append(mask)
        keep.append((keep_w, keep_h))
    return {"mts_w": np.stack(mw), "mts_h": np.stack(mh),
            "mts_mask": np.stack(masks), "mts_keep": tuple(keep),
            "w": w, "h": h}


@device_cache
def device_mts_tables(w: int, h: int, device: str) -> dict:
    """mts_class_tables(w, h) on ``device``, built once per process."""
    return tables_to_torch(mts_class_tables(w, h), torch.device(device))


@device_cache
def mip_matrix(size_id: int, device: str) -> torch.Tensor:
    """The MIP weight matrix of a size id, uint8 [n_modes, red_pred^2,
    2*red_bdry] on ``device``."""
    m = (MIP_4X4, MIP_8X8, MIP_16X16)[size_id]
    return torch.from_numpy(np.ascontiguousarray(m, dtype=np.uint8)) \
        .to(torch.device(device))


@device_cache
def mip_mode_bits(n_cand: int, device: str) -> torch.Tensor:
    """The flat 6.0 signalling bits of the n_cand MIP candidates, float32
    on ``device`` (the reference's mip_bits of dispatch_blocks)."""
    return torch.from_numpy(np.full(n_cand, 6.0, dtype=np.float32)) \
        .to(torch.device(device))


@device_cache
def rough_modes(device: str) -> torch.Tensor:
    """ROUGH_MODES, int32 [35] on ``device``."""
    return torch.from_numpy(ROUGH_MODES.copy()).to(torch.device(device))


def mvd_bits_table(r: int) -> np.ndarray:
    """[2 * (4r + 3) + 1] float32: mv_bits_est(v) for every quarter-pel MV
    component v = mv16 >> 2 = 4 * full-pel + quarter-pel offset the
    per-class inter search can give, v in [-(4r + 3), 4r + 3], at index
    v + 4r + 3. The values are small integers, exact in float32."""
    lim = 4 * r + 3
    return np.array([mv_bits_est(v) for v in range(-lim, lim + 1)],
                    dtype=np.float32)


@device_cache
def device_mvd_bits(r: int, device: str) -> torch.Tensor:
    """mvd_bits_table(r) on ``device``."""
    return torch.from_numpy(mvd_bits_table(r)).to(torch.device(device))


def frac_penalty(lam_sqrt: float) -> np.ndarray:
    """[49] float32 rate penalty of the quarter-pel offsets k -> (k % 7 - 3,
    k // 7 - 3): lam_sqrt * (2 per nonzero component), in float64 and
    stored as float32 (the reference's fpen, control/encoder.py
    search_inter_blocks)."""
    fpen = np.empty(49, dtype=np.float32)
    for k in range(49):
        dxq, dyq = k % 7 - 3, k // 7 - 3
        fpen[k] = lam_sqrt * ((0.0 if dxq == 0 else 2.0)
                              + (0.0 if dyq == 0 else 2.0))
    return fpen


@device_cache
def me_penalties(lam: float, r: int, device: str):
    """(pen [(2r+1)^2], fpen [49]) float32 on ``device``: the full-pel
    penalty make_mv_penalty(r, sqrt(lam)), flattened dy major, and the
    quarter-pel frac_penalty(sqrt(lam)), lam the inter lambda (float64)."""
    lam_sqrt = np.sqrt(lam)
    dev = torch.device(device)
    return (torch.from_numpy(make_mv_penalty(r, lam_sqrt).reshape(-1))
            .to(dev), torch.from_numpy(frac_penalty(lam_sqrt)).to(dev))

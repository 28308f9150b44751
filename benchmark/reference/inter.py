"""The benchmark's plain reference of a low-delay P frame's inter stages:
the host full-pel motion search's RD cost of each block's chosen vector,
and K8's leaf quarter-pel refinement.

- ``me_rd``: the cost ``native/inter.cpp`` ``fi_me_frame`` reports for a
  block at its chosen full-pel vector, in the units of
  ``ops/rd_cost.py`` ``make_rd_cost_pred_fn`` (K6): the prediction
  fetched edge-clamped from the reference plane, the DCT-II round trip
  with quantisation rounding 85, SSD + lambda * (bucket bits + the
  vector's bits + 4), float32; a vector taken from a neighbour prices 6
  bits instead (``lam >= 100`` only).
- ``leaf_seg``: K8 (``ops/me_frame.py`` ``leaf_qpel_plain``): for every
  inter leaf at its full-pel vector, the 8x8 Hadamard SATD of each 8x8
  tile at the 49 quarter-pel offsets (the 8-tap luma filters, edge-clamped
  windows), summed over the leaf's tiles in float32; and
  ``two_stage`` (``control/encoder.py`` ``_two_stage_qpel``), the
  half-pel square then the quarter-pel neighbours of its winner.

Copies of the port's plain arithmetic as it stood when the benchmark was
written; nothing here imports the port or JAX. ``cost_dtype`` sets the
precision of the float costs: float32 as the program states, bfloat16 for
the control.
"""
from __future__ import annotations

import numpy as np
import torch

from .search import _PLAIN_CHUNK, _fwht, _rd_tail_plain, quant_consts
from .tables import dct2_matrix

# ops/inter.py LUMA_FILTER: the 16 phases of the 8-tap luma filter
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0],
], dtype=np.int64)
TILE = 8
PAD = 5
UNPRICED = 1e37         # fi_me_frame's cost of a reference it did not score


def mv_bits_est(v) -> np.ndarray:
    """Bits of a motion-vector component ``v`` in quarter-pel
    (native/inter.cpp mv_bits_est, ops/me.py): 1 for 0, 3 for 1, else
    2 + the exp-Golomb length of |v| - 2 plus its prefix."""
    a = np.abs(np.asarray(v, dtype=np.int64))
    out = np.empty(a.shape, dtype=np.float64)
    for i, x in np.ndenumerate(a):
        if x == 0:
            out[i] = 1.0
        elif x == 1:
            out[i] = 3.0
        else:
            k, length, count = int(x) - 2, 1, 1
            while k >= (1 << count):
                k -= 1 << count
                count += 1
                length += 2
            out[i] = 2.0 + length + count + 1
    return out


def fetch(plane: torch.Tensor, xs, ys, w: int, h: int, pad: int = 0):
    """Blocks [n, h + 2 pad, w + 2 pad] of ``plane`` [H, W] whose top-left
    samples lie at (xs, ys) [n], edge-replicated outside the plane."""
    H, W = plane.shape
    dev = plane.device
    xs = torch.as_tensor(np.asarray(xs), dtype=torch.long, device=dev)
    ys = torch.as_tensor(np.asarray(ys), dtype=torch.long, device=dev)
    cx = (xs[:, None] - pad + torch.arange(w + 2 * pad, device=dev)
          ).clamp(0, W - 1)
    cy = (ys[:, None] - pad + torch.arange(h + 2 * pad, device=dev)
          ).clamp(0, H - 1)
    return plane[cy[:, :, None], cx[:, None, :]]


def me_rd(src: torch.Tensor, refs: list, class_descs, mvs: np.ndarray,
          costs: np.ndarray, qp_scaled: int, bitdepth: int, lam: float,
          wts: torch.Tensor, cost_dtype=torch.float32) -> np.ndarray:
    """The reference's RD cost of every priced (reference, block) pair of
    a fi_me_frame result at the vector the program chose: src [H, W] and
    refs [R] x [H, W] int64 planes on one device; class_descs [(w, h, x0,
    y0, sx, sy, gx, gy)], mvs [R, total, 2] full-pel, costs [R, total].
    -> [R, total, 2] float64: the cost with the vector's own bits and with
    a neighbour's 6 bits (NaN where the program priced nothing)."""
    dev = src.device
    out = np.full(costs.shape + (2,), np.nan)
    lam32 = torch.tensor(np.float32(lam), device=dev).to(cost_dtype)
    off = 0
    for (w, h, x0, y0, sx, sy, gx, gy) in class_descs:
        n = gx * gy
        k = np.arange(n)
        bx = x0 + (k % gx) * sx
        by = y0 + (k // gx) * sy
        c = quant_consts(w, h, bitdepth, qp_scaled, is_intra_slice=False)
        mat_w = torch.from_numpy(dct2_matrix(w)).to(dev)
        mat_h = torch.from_numpy(dct2_matrix(h)).to(dev)
        blk_all = fetch(src, bx, by, w, h)
        step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
        for u, ref in enumerate(refs):
            sel = np.nonzero(costs[u, off:off + n] < UNPRICED)[0]
            for b0 in range(0, len(sel), step):
                s = sel[b0:b0 + step]
                mv = mvs[u, off + s]
                pred = fetch(ref, bx[s] + mv[:, 0], by[s] + mv[:, 1], w, h)
                bits, ssd, _lv = _rd_tail_plain(
                    pred, blk_all[torch.from_numpy(s).to(dev)], c, w, h,
                    bitdepth, wts, mat_w, mat_h, cost_dtype=cost_dtype)
                own = torch.from_numpy(
                    mv_bits_est(4 * mv[:, 0]) + mv_bits_est(4 * mv[:, 1])
                    + 4.0).to(dev).to(torch.float32).to(cost_dtype)
                for j, extra in enumerate((own, torch.full_like(own, 6.0))):
                    rd = ssd + lam32 * (bits + extra)
                    out[u, off + s, j] = rd.float().cpu().numpy()
        off += n
    return out


def _interp(win: torch.Tensor, k: int, bitdepth: int) -> torch.Tensor:
    """The prediction of 8x8 tiles at quarter-pel offset k (0..48, 7x7,
    row-major from (-3, -3)) from windows [T, 18, 18] int64 that hold the
    tile with PAD samples around it -> [T, 8, 8] int64."""
    offq_x, offq_y = k % 7 - 3, k // 7 - 3
    ix, iy = (offq_x * 4) >> 4, (offq_y * 4) >> 4
    fx, fy = (offq_x * 4) & 15, (offq_y * 4) & 15
    n = TILE
    if fx == 0 and fy == 0:
        return win[:, PAD + iy:PAD + iy + n, PAD + ix:PAD + ix + n]
    hf, vf = LUMA_FILTER[fx], LUMA_FILTER[fy]
    hor = None
    for t in range(8):
        term = int(hf[t]) * win[:, PAD + iy - 3:PAD + iy + n + 4,
                                PAD + ix - 3 + t:PAD + ix - 3 + t + n]
        hor = term if hor is None else hor + term
    if bitdepth > 8:
        hor = hor >> (bitdepth - 8)
    out = None
    for t in range(8):
        term = int(vf[t]) * hor[:, t:t + n]
        out = term if out is None else out + term
    out = out >> 6
    wp_shift = 14 - bitdepth
    out = (out + (1 << (wp_shift - 1))) >> wp_shift
    return out.clamp(0, (1 << bitdepth) - 1)


def tile_satd(win: torch.Tensor, blk: torch.Tensor, bitdepth: int):
    """[T, 49] int64: each 8x8 tile's Hadamard SATD at every offset."""
    out = torch.empty((win.shape[0], 49), dtype=torch.int64,
                      device=win.device)
    for k in range(49):
        t = _fwht(_fwht(blk - _interp(win, k, bitdepth), -1), -2).abs()
        s = t.sum(dim=(-2, -1))
        dc = t[:, 0, 0]
        out[:, k] = (s - dc + (dc >> 2) + 2) >> 2
    return out


def leaf_seg(src: torch.Tensor, refs: list, cands: list, bitdepth: int,
             cost_dtype=torch.float32) -> np.ndarray:
    """K8's sums: cands [(x, y, w, h, u, (mvx, mvy) 1/16-pel)], src and
    refs [H, W] int64 planes -> [n, 49] float64, each leaf's tile SATDs
    summed in tile order in ``cost_dtype``."""
    n = len(cands)
    if n == 0:
        return np.zeros((0, 49))
    dev = src.device
    wins, blks, ids, rank = [], [], [], []
    for i, (x, y, w, h, u, mv) in enumerate(cands):
        ty, tx = np.meshgrid(np.arange(h // TILE), np.arange(w // TILE),
                             indexing="ij")
        ty, tx = ty.reshape(-1), tx.reshape(-1)
        wins.append(fetch(refs[u], x + (mv[0] >> 4) + TILE * tx,
                          y + (mv[1] >> 4) + TILE * ty, TILE, TILE, PAD))
        blks.append(fetch(src, x + TILE * tx, y + TILE * ty, TILE, TILE))
        ids.append(np.full(len(tx), i))
        rank.append(np.arange(len(tx)))
    satd = tile_satd(torch.cat(wins).long(), torch.cat(blks).long(),
                     bitdepth).to(torch.float32).to(cost_dtype)
    ids = torch.from_numpy(np.concatenate(ids)).to(dev)
    rank = torch.from_numpy(np.concatenate(rank)).to(dev)
    seg = torch.zeros((n, 49), dtype=cost_dtype, device=dev)
    for j in range(int(rank.max()) + 1):
        sel = rank == j
        seg[ids[sel]] = seg[ids[sel]] + satd[sel]
    return seg.float().cpu().numpy().astype(np.float64)


def pen49(lam_sqrt: float) -> np.ndarray:
    """The quarter-pel offsets' vector penalty: sqrt(lambda) x 2 bits for
    each non-zero component (control/encoder.py _refine_inter_leaves)."""
    out = np.empty(49, dtype=np.float32)
    for k in range(49):
        dxq, dyq = k % 7 - 3, k // 7 - 3
        out[k] = lam_sqrt * ((0.0 if dxq == 0 else 2.0)
                             + (0.0 if dyq == 0 else 2.0))
    return out


def two_stage(seg_row, pen) -> int:
    """The offset K8's caller keeps: the half-pel square's first minimum
    of seg + pen (float32), then the first lower one among its quarter-pel
    neighbours."""
    best_k, best_c = -1, None
    for dyq in (-2, 0, 2):
        for dxq in (-2, 0, 2):
            k = (dyq + 3) * 7 + (dxq + 3)
            c = np.float32(seg_row[k]) + np.float32(pen[k])
            if best_c is None or c < best_c:
                best_k, best_c = k, c
    bdx, bdy = best_k % 7 - 3, best_k // 7 - 3
    for dyq in (bdy - 1, bdy, bdy + 1):
        if dyq < -3 or dyq > 3:
            continue
        for dxq in (bdx - 1, bdx, bdx + 1):
            if dxq < -3 or dxq > 3:
                continue
            k = (dyq + 3) * 7 + (dxq + 3)
            c = np.float32(seg_row[k]) + np.float32(pen[k])
            if c < best_c:
                best_k, best_c = k, c
    return best_k

"""Whole-frame dense inter search and leaf-level quarter-pel refinement.

Port of uvg266_tpu/ops/me_frame.py. The host helpers (TILE,
mv_bits_table) are copies of the reference's; its two device functions
come as plain PyTorch versions plus wrappers that launch hand-written CUDA
kernels for tensors on the card:

- K7 ``frame_inter`` (csrc/frame_inter.cu; reference: make_frame_inter_fn
  up to its RD cost): for one reference, 8x8-tile SSD maps over every
  full-pel offset in [-r, r]^2, then per size class the block maps (tile
  sums in float32, in the reference's raster order), + the rate penalty,
  the first argmin, and the prediction and source blocks at the winning
  offset. ``frame_inter_search`` follows it with K6
  (ops.rd_cost.rd_cost_pred) per class and packs the reference's flat
  result vector.
- K8 ``leaf_qpel`` (csrc/leaf_qpel.cu; reference: make_leaf_qpel_fn): the
  49 quarter-pel offsets of every decided leaf, 8-tap interpolation, 8x8
  Hadamard SATD per tile, float32 segment sums per leaf, penalty, argmin.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .inter import LUMA_FILTER
from .me import mv_bits_est
from .intra_batch import _fwht, _grid_xy
from .transforms import _PLAIN_CHUNK

TILE = 8


def mv_bits_table(r: int, extra: float = 4.0) -> np.ndarray:
    """[(2r+1)^2] f32: signaled-bits estimate for each full-pel offset
    (quarter-pel mvd magnitude = 4*offset) + per-CU inter overhead."""
    n = 2 * r + 1
    out = np.empty(n * n, dtype=np.float32)
    for k in range(n * n):
        dy, dx = k // n - r, k % n - r
        out[k] = mv_bits_est(4 * dx) + mv_bits_est(4 * dy) + extra
    return out


# --- K7 ------------------------------------------------------------------

def _tile_ssd_plain(src: torch.Tensor, ref_pad: torch.Tensor, r: int):
    """[T, (2r+1)^2] int32 SSD of every 8x8 tile of src [H, W] against
    ref_pad [H+2r, W+2r] at every full-pel offset, offset-major loop."""
    H, W = src.shape
    n = 2 * r + 1
    TY, TX = H // TILE, W // TILE
    s = src.long()
    out = torch.empty((TY * TX, n * n), dtype=torch.int32, device=src.device)
    for a in range(n):
        for b in range(n):
            d = s - ref_pad[a:a + H, b:b + W].long()
            out[:, a * n + b] = (d * d).reshape(TY, TILE, TX, TILE) \
                .sum(dim=(1, 3)).reshape(-1)
    return out


def frame_inter_plain(src: torch.Tensor, ref_pad: torch.Tensor, pen,
                      bits_tab, classes, r: int = 16):
    """K7, plain version. src [H, W] int32 (H, W multiples of 8), ref_pad
    [H+2r, W+2r] int32 (the edge-padded reference), pen and bits_tab
    [(2r+1)^2] float32, classes ((w, h, grid), ...) with every grid entry a
    multiple of 8 -> per class (idx [B] int32 offset index, pred [B, h, w]
    int32 at that offset, blk [B, h, w] int32 source, extra [B] float32 =
    bits_tab[idx])."""
    H, W = src.shape
    TX = W // TILE
    n = 2 * r + 1
    dev = src.device
    ssd = _tile_ssd_plain(src, ref_pad, r).to(torch.float32)
    out = []
    for (w, h, grid) in classes:
        xs, ys = _grid_xy(grid, dev)
        B = xs.numel()
        t0 = (ys // TILE) * TX + xs // TILE
        idx = torch.empty((B,), dtype=torch.int64, device=dev)
        step = max(1, _PLAIN_CHUNK // (n * n))
        for b0 in range(0, B, step):
            tb = t0[b0:b0 + step]
            acc = None
            for i in range(h // TILE):          # class_block_maps' order
                for j in range(w // TILE):
                    v = ssd[tb + i * TX + j]
                    acc = v if acc is None else acc + v
            idx[b0:b0 + step] = torch.argmin(acc + pen[None], dim=1)
        dy = idx // n - r
        dx = idx % n - r
        ii = torch.arange(h, device=dev)[None, :, None]
        jj = torch.arange(w, device=dev)[None, None, :]
        rows = ys[:, None, None] + ii
        cols = xs[:, None, None] + jj
        pred = ref_pad[rows + (dy + r)[:, None, None],
                       cols + (dx + r)[:, None, None]]
        out.append((idx.to(torch.int32), pred, src[rows, cols],
                    bits_tab[idx]))
    return out


def frame_inter(src: torch.Tensor, ref_pad: torch.Tensor, pen, bits_tab,
                classes, r: int = 16):
    """K7: frame_inter_plain on the CPU, the CUDA kernel on the card."""
    H, W = src.shape
    if H % TILE or W % TILE or tuple(ref_pad.shape) != (H + 2 * r, W + 2 * r):
        raise ValueError("frame_inter: src [H, W] with H, W multiples of 8 "
                         "and ref_pad [H + 2r, W + 2r]")
    for (w, h, grid) in classes:
        if any(v % TILE for v in (w, h, *grid[:4])):
            raise ValueError("frame_inter: class sizes and grids must be "
                             "multiples of 8")
    if src.device.type == "cpu":
        return frame_inter_plain(src, ref_pad, pen, bits_tab, classes, r)
    dev = kernels.check_cuda("frame_inter", src, ref_pad, pen, bits_tab)
    n = 2 * r + 1
    if (src.dtype != torch.int32 or ref_pad.dtype != torch.int32
            or pen.dtype != torch.float32 or bits_tab.dtype != torch.float32
            or pen.numel() != n * n or bits_tab.numel() != n * n):
        raise ValueError("frame_inter: int32 planes and float32 pen, "
                         "bits_tab [(2r+1)^2]")
    recs = []
    nb = npx = 0
    for (w, h, grid) in classes:
        x0, y0, sx, sy, gx, gy = (int(v) for v in grid)
        recs.append((w, h, x0, y0, sx, sy, gx, gy, nb, npx))
        nb += gx * gy
        npx += gx * gy * w * h
    desc = np.ascontiguousarray(np.array(recs, dtype=np.int32).reshape(-1))
    ssd = torch.empty(((H // TILE) * (W // TILE), n * n), dtype=torch.int32,
                      device=dev)
    idx = torch.empty((nb,), dtype=torch.int32, device=dev)
    extra = torch.empty((nb,), dtype=torch.float32, device=dev)
    pred = torch.empty((npx,), dtype=torch.int32, device=dev)
    blk = torch.empty((npx,), dtype=torch.int32, device=dev)
    kernels.launch("frame_inter", dev, src.data_ptr(), ref_pad.data_ptr(), H,
                   W, r, pen.data_ptr(), bits_tab.data_ptr(),
                   desc.ctypes.data, len(recs), ssd.data_ptr(),
                   idx.data_ptr(), pred.data_ptr(), blk.data_ptr(),
                   extra.data_ptr())
    out = []
    for (w, h, _x0, _y0, _sx, _sy, gx, gy, b0, p0) in recs:
        B = gx * gy
        out.append((idx[b0:b0 + B],
                    pred[p0:p0 + B * w * h].view(B, h, w),
                    blk[p0:p0 + B * w * h].view(B, h, w),
                    extra[b0:b0 + B]))
    return out


def frame_inter_search(src: torch.Tensor, refs_pad: torch.Tensor, pen,
                       bits_tab, classes, qp: int, lam: float, wts,
                       bitdepth: int = 8, r: int = 16) -> torch.Tensor:
    """make_frame_inter_fn's result on ``src``'s device: for each reference
    of refs_pad [R, H+2r, W+2r], K7 then, per class, K6 on the winning
    prediction -> one flat float32 tensor, for each ref, for each class,
    (best offset index [B], rd cost [B])."""
    from .rd_cost import rd_cost_pred
    from .tables import device_tables
    vecs = []
    for ri in range(refs_pad.shape[0]):
        found = frame_inter(src, refs_pad[ri], pen, bits_tab, classes, r)
        for (w, h, _g), (idx, pred, blk, extra) in zip(classes, found):
            tabs = device_tables(w, h, bitdepth, str(src.device))
            cost = rd_cost_pred(pred, blk, qp, lam, wts, extra, tabs,
                                bitdepth)
            vecs.append(idx.to(torch.float32))
            vecs.append(cost)
    return torch.cat(vecs)


# --- K8 ------------------------------------------------------------------

PAD = 5


def _interp(win: torch.Tensor, k: int, bitdepth: int) -> torch.Tensor:
    """make_leaf_qpel_fn's interp_one for offset k on windows [T, 18, 18]
    int64 -> [T, 8, 8] int64."""
    offq_x, offq_y = k % 7 - 3, k // 7 - 3
    ix, iy = (offq_x * 4) >> 4, (offq_y * 4) >> 4
    fx, fy = (offq_x * 4) & 15, (offq_y * 4) & 15
    h = w = TILE
    if fx == 0 and fy == 0:
        return win[:, PAD + iy:PAD + iy + h, PAD + ix:PAD + ix + w]
    hf, vf = LUMA_FILTER[fx], LUMA_FILTER[fy]
    hor = None
    for t in range(8):
        term = int(hf[t]) * win[:, PAD + iy - 3:PAD + iy + h + 4,
                                PAD + ix - 3 + t:PAD + ix - 3 + t + w]
        hor = term if hor is None else hor + term
    if bitdepth > 8:
        hor = hor >> (bitdepth - 8)
    out = None
    for t in range(8):
        term = int(vf[t]) * hor[:, t:t + h]
        out = term if out is None else out + term
    out = out >> 6
    wp_shift = 14 - bitdepth
    out = (out + (1 << (wp_shift - 1))) >> wp_shift
    return out.clamp(0, (1 << bitdepth) - 1)


def leaf_qpel_plain(windows: torch.Tensor, blocks: torch.Tensor,
                    leaf_ids: torch.Tensor, n_leaves: int, pen,
                    bitdepth: int = 8):
    """K8, plain version. windows [nt, 18, 18], blocks [nt, 8, 8] int32,
    leaf_ids [nt] int32 sorted (ids >= n_leaves are padding), pen [49]
    float32 -> (best [n_leaves] int32, cost [n_leaves] float32, seg
    [n_leaves, 49] float32)."""
    dev = windows.device
    nt = windows.shape[0]
    win = windows.long()
    blk = blocks.long()
    satd = torch.empty((nt, 49), dtype=torch.int64, device=dev)
    for k in range(49):
        d = blk - _interp(win, k, bitdepth)
        t = _fwht(_fwht(d, -1), -2).abs()          # H d H, H the 8x8 Hadamard
        s = t.sum(dim=(-2, -1))
        dc = t[:, 0, 0]
        satd[:, k] = (s - dc + (dc >> 2) + 2) >> 2
    satd = satd.to(torch.float32)
    # segment sums in tile order: the j-th tile of every leaf at step j
    ids = leaf_ids.long()
    keep = ids < n_leaves
    first = torch.searchsorted(ids, ids, right=False)
    rank = torch.arange(nt, device=dev) - first
    seg = torch.zeros((n_leaves, 49), dtype=torch.float32, device=dev)
    for j in range(int(rank.max().item()) + 1 if nt else 0):
        sel = keep & (rank == j)
        seg[ids[sel]] = seg[ids[sel]] + satd[sel]
    costs = seg + pen[None]
    best = torch.argmin(costs, dim=1)
    return best.to(torch.int32), costs.gather(1, best[:, None])[:, 0], seg


def leaf_qpel(windows: torch.Tensor, blocks: torch.Tensor,
              leaf_ids: torch.Tensor, n_leaves: int, pen,
              bitdepth: int = 8):
    """K8: leaf_qpel_plain on the CPU, the CUDA kernel on the card."""
    nt = windows.shape[0]
    if (tuple(windows.shape[1:]) != (18, 18)
            or tuple(blocks.shape) != (nt, TILE, TILE)
            or tuple(leaf_ids.shape) != (nt,) or pen.numel() != 49):
        raise ValueError("leaf_qpel: windows [nt, 18, 18], blocks [nt, 8, 8],"
                         " leaf_ids [nt], pen [49]")
    if windows.device.type == "cpu":
        return leaf_qpel_plain(windows, blocks, leaf_ids, n_leaves, pen,
                               bitdepth)
    dev = kernels.check_cuda("leaf_qpel", windows, blocks, leaf_ids, pen)
    if (windows.dtype != torch.int32 or blocks.dtype != torch.int32
            or leaf_ids.dtype != torch.int32 or pen.dtype != torch.float32):
        raise ValueError("leaf_qpel: int32 windows, blocks, leaf_ids and "
                         "float32 pen")
    satd = torch.empty((nt, 49), dtype=torch.int32, device=dev)
    best = torch.empty((n_leaves,), dtype=torch.int32, device=dev)
    cost = torch.empty((n_leaves,), dtype=torch.float32, device=dev)
    seg = torch.empty((n_leaves, 49), dtype=torch.float32, device=dev)
    kernels.launch("leaf_qpel", dev, windows.data_ptr(), blocks.data_ptr(),
                   leaf_ids.data_ptr(), nt, n_leaves, pen.data_ptr(),
                   bitdepth, satd.data_ptr(), best.data_ptr(),
                   cost.data_ptr(), seg.data_ptr())
    return best, cost, seg

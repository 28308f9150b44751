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

``tile_ssd_sep``, ``frame_inter_sep`` and ``leaf_qpel_sep`` redo the two
kernels' arithmetic in their own order (tests/test_torch_me_frame_design.py
holds them to the plain versions); no encode path calls them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .inter import LUMA_FILTER
from .me import mv_bits_est, satd_butterfly
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
    return _class_pass_plain(src, ref_pad, _tile_ssd_plain(src, ref_pad, r),
                             pen, bits_tab, classes, r)


def _class_pass_plain(src, ref_pad, ssd, pen, bits_tab, classes, r: int):
    """K7's class pass, plain, on the tile SSD maps ssd [T, (2r+1)^2]."""
    TX = src.shape[1] // TILE
    n = 2 * r + 1
    dev = src.device
    ssd = ssd.to(torch.float32)
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


_U32 = (1 << 32) - 1


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values taken modulo 2^32 as int32 (a uint32 result's bits)."""
    v = v & _U32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _k7_geometry(r: int):
    """(PX, PY, NS) of csrc/frame_inter.cu's tile pass: a 4 x 3 patch with
    all 33 offsets of a row a thread at r = 16, else one tile and strips
    of 8."""
    return (4, 3, 2 * r + 1) if r == 16 else (1, 1, 8)


def tile_ssd_sep(src: torch.Tensor, ref_pad: torch.Tensor, r: int):
    """K7's tile pass as csrc/frame_inter.cu computes it, in plain PyTorch:
    per patch of PX x PY tiles one window of ref_pad (zero past the plane
    and past its width, for the strips that run over it), r^2 as column
    sums then row sums of 8 squared window samples, b^2 per tile, corr per
    (tile, dy, strip of NS dx), the SSD b^2 + r^2 - 2 corr; every sum in
    uint32 (int64 taken modulo 2^32). Equal to _tile_ssd_plain."""
    PX, PY, NS = _k7_geometry(r)
    H, W = src.shape
    TY, TX = H // TILE, W // TILE
    n = 2 * r + 1
    strips = -(-n // NS)
    ww, wh = TILE * PX + 2 * r, TILE * PY + 2 * r
    wcols = ww + (NS if n % NS else 0)
    bw, bh = ww - TILE + 1, wh - TILE + 1
    ref, s = ref_pad.long(), src.long()
    Hp, Wp = ref.shape
    out = torch.empty((TY * TX, n * n), dtype=torch.int32, device=src.device)
    for ty0 in range(0, TY, PY):
        for tx0 in range(0, TX, PX):
            win = torch.zeros((wh, wcols), dtype=torch.int64,
                              device=src.device)
            y1 = min(Hp, TILE * ty0 + wh)
            x1 = min(Wp, TILE * tx0 + ww)
            win[:y1 - TILE * ty0, :x1 - TILE * tx0] = \
                ref[TILE * ty0:y1, TILE * tx0:x1]
            sq = win[:, :ww] * win[:, :ww]
            cs = sum(sq[i:i + bh] for i in range(TILE)) & _U32
            box = sum(cs[:, j:j + bw] for j in range(TILE)) & _U32
            for py in range(min(PY, TY - ty0)):
                for px in range(min(PX, TX - tx0)):
                    ty, tx = ty0 + py, tx0 + px
                    st = s[TILE * ty:TILE * ty + TILE,
                           TILE * tx:TILE * tx + TILE]
                    b2 = int((st * st).sum()) & _U32
                    # rows TILE py + a + i, columns TILE px + b + j for
                    # every a and every b of the strips
                    part = win[TILE * py:TILE * py + n + TILE - 1,
                               TILE * px:TILE * px + strips * NS + TILE - 1]
                    corr = (part.unfold(0, TILE, 1).unfold(1, TILE, 1)
                            * st).sum(dim=(-2, -1))[:, :n] & _U32
                    bx = box[TILE * py:TILE * py + n, TILE * px:TILE * px + n]
                    out[ty * TX + tx] = _as_int32(b2 + bx - 2 * corr) \
                        .reshape(-1)
    return out


def frame_inter_sep(src: torch.Tensor, ref_pad: torch.Tensor, pen,
                    bits_tab, classes, r: int = 16):
    """K7 with the tile maps of tile_ssd_sep and the plain class pass (the
    float32 tile sums in raster order, + pen, the first minimum, which the
    kernel's lanes keep in ascending order and reduce as (cost, index)
    pairs, and the gathers). Equal to frame_inter_plain."""
    return _class_pass_plain(src, ref_pad, tile_ssd_sep(src, ref_pad, r),
                             pen, bits_tab, classes, r)


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
    kernels.check_batch("frame_inter", sum(int(g[4]) * int(g[5])
                                           for (_w, _h, g) in classes))
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


def _tile_satd_plain(windows: torch.Tensor, blocks: torch.Tensor,
                     bitdepth: int) -> torch.Tensor:
    """K8's tile pass, plain: windows [nt, 18, 18], blocks [nt, 8, 8] ->
    [nt, 49] int64, each tile's 8x8 Hadamard SATD at every offset."""
    win = windows.long()
    blk = blocks.long()
    satd = torch.empty((windows.shape[0], 49), dtype=torch.int64,
                       device=windows.device)
    for k in range(49):
        d = blk - _interp(win, k, bitdepth)
        t = _fwht(_fwht(d, -1), -2).abs()          # H d H, H the 8x8 Hadamard
        s = t.sum(dim=(-2, -1))
        dc = t[:, 0, 0]
        satd[:, k] = (s - dc + (dc >> 2) + 2) >> 2
    return satd


def _leaf_seg(satd: torch.Tensor, leaf_ids: torch.Tensor, n_leaves: int,
              pen):
    """K8's segment pass, plain: the float32 sums of each leaf's tile SATDs
    [nt, 49] in tile order, + pen, the first minimum -> (best, cost,
    seg)."""
    dev = satd.device
    nt = satd.shape[0]
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


def leaf_qpel_plain(windows: torch.Tensor, blocks: torch.Tensor,
                    leaf_ids: torch.Tensor, n_leaves: int, pen,
                    bitdepth: int = 8):
    """K8, plain version. windows [nt, 18, 18], blocks [nt, 8, 8] int32,
    leaf_ids [nt] int32 sorted (ids >= n_leaves are padding), pen [49]
    float32 -> (best [n_leaves] int32, cost [n_leaves] float32, seg
    [n_leaves, 49] float32)."""
    return _leaf_seg(_tile_satd_plain(windows, blocks, bitdepth), leaf_ids,
                     n_leaves, pen)


def leaf_qpel_sep(windows: torch.Tensor, blocks: torch.Tensor,
                  leaf_ids: torch.Tensor, n_leaves: int, pen,
                  bitdepth: int = 8):
    """K8 as csrc/leaf_qpel.cu computes it, in plain PyTorch: per tile the
    three horizontal passes at fx = 4, 8, 12 over window rows 1..16 and
    tile columns -1..7, >> (bitdepth - 8), kept as int16 (a pass that left
    int16 raises); per x offset the 16 values of each column (the pass at
    column c + ix, or the window << (14 - bitdepth) at fx = 0), the
    vertical 8 taps slid over them for the 7 y offsets (the identity at
    fy = 0, the window itself at k = 24); the butterfly Hadamard SATD
    (ops.me.satd_butterfly); per leaf the float32 sums of its tiles in
    tile order from its first tile (binary search), + pen, the first
    minimum. Equal to leaf_qpel_plain."""
    win = windows.long()
    nt = win.shape[0]
    hx = []
    for fx in (4, 8, 12):
        f = LUMA_FILTER[fx]
        acc = sum(int(f[t]) * win[:, 1:17, 1 + t:10 + t] for t in range(8))
        acc = acc >> (bitdepth - 8)
        h16 = acc.to(torch.int16)
        if not torch.equal(h16.long(), acc):
            raise OverflowError("leaf_qpel_sep: a horizontal pass left int16")
        hx.append(h16.long())                       # [nt, 16, 9]
    wp = 14 - bitdepth
    mx = (1 << bitdepth) - 1
    satd = torch.empty((nt, 49), dtype=torch.int64, device=win.device)
    blk = blocks.long()
    for xo in range(7):
        ox = 4 * (xo - 3)
        ix, fx = ox >> 4, ox & 15
        col = (win[:, 1:17, PAD:PAD + TILE] << wp) if fx == 0 \
            else hx[(fx >> 2) - 1][:, :, ix + 1:ix + 1 + TILE]  # [nt, 16, 8]
        for yo in range(7):
            oy = 4 * (yo - 3)
            iy, fy = oy >> 4, oy & 15
            if fx == 0 and fy == 0:
                pred = win[:, PAD:PAD + TILE, PAD:PAD + TILE]
            else:
                if fy == 0:
                    out = col[:, 4:4 + TILE]
                else:
                    f = LUMA_FILTER[fy]
                    out = sum(int(f[t]) * col[:, 1 + iy + t:1 + iy + t + TILE]
                              for t in range(8)) >> 6
                pred = ((out + (1 << (wp - 1))) >> wp).clamp(0, mx)
            satd[:, yo * 7 + xo] = satd_butterfly(blk - pred)
    # the segment pass: a leaf's tiles from its first, in tile order
    ids = leaf_ids.long()
    first = torch.searchsorted(ids, torch.arange(n_leaves, device=ids.device))
    seg = torch.zeros((n_leaves, 49), dtype=torch.float32, device=win.device)
    sf = satd.to(torch.float32)
    q = first.clone()
    while True:
        on = (q < nt) & (ids[q.clamp(max=max(nt - 1, 0))] ==
                         torch.arange(n_leaves, device=ids.device)) \
            if nt else torch.zeros(n_leaves, dtype=torch.bool)
        if not bool(on.any()):
            break
        seg[on] = seg[on] + sf[q[on]]
        q = q + on.long()
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
    kernels.check_batch("leaf_qpel", min(nt, n_leaves))
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

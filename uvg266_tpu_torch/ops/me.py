"""Batched motion estimation of the per-class inter search.

Port of uvg266_tpu/ops/me.py. The host half is a copy: the mvd bit
estimate and the full-pel rate-penalty table. The two device functions of
search_inter_blocks each come as a plain PyTorch version plus a wrapper
that launches the hand-written CUDA kernel (csrc/) for tensors on the card:

- K9a ``fullpel_search`` (reference: make_fullpel_search_fn): the dense
  full-pel search over a (2r+1)^2 window, SSD = b2 - 2*corr + r2 plus a
  rate penalty, first minimum. The reference sums each term in float32 in
  XLA's order; here each is the exact integer, rounded to float32 once and
  combined in the reference's order, so the result equals the reference
  wherever every term is below 2^24 (8 bits up to 16x16) and is the
  correctly rounded cost elsewhere.
- K9b ``frac_search`` (reference: make_frac_search_fn): the 49 quarter-pel
  offsets around the full-pel MV, 8-tap interpolation, satd_bw and a rate
  penalty, first minimum; integer work, equal to the reference exactly.
  With ``winner_only`` it returns only the winning offset's prediction,
  the one search_inter_blocks reads.

``frac_search_sep`` and ``box_r2`` compute what the two kernels compute,
in their arithmetic, for the tests.

Both read their windows from the reference plane through clamped
coordinates (``windows``), the reference's fetch_extended_block. A wrapper
given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises. Nothing falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .inter import LUMA_FILTER


def mv_bits_est(v: int) -> float:
    """Approximate signaled bits for one quarter-pel mvd component
    (abs_mvd coding: greater0 + greater1 + EG1 + sign)."""
    a = abs(v)
    if a == 0:
        return 1.0
    if a == 1:
        return 3.0
    # EG1 length for a-2
    k = a - 2
    length = 1
    count = 1
    while k >= (1 << count):
        k -= 1 << count
        count += 1
        length += 2
    return 2.0 + length + count + 1


def make_mv_penalty(r: int, lam_sqrt: float) -> np.ndarray:
    """[2r+1, 2r+1] rate penalty for full-pel offsets (quarter-pel mvd
    magnitude = 4*offset), biasing toward small vectors."""
    n = 2 * r + 1
    out = np.zeros((n, n), dtype=np.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out[dy + r, dx + r] = lam_sqrt * (mv_bits_est(4 * dx)
                                              + mv_bits_est(4 * dy))
    return out


FRAC_PAD = 5          # the quarter-pel window margin of make_frac_search_fn


def windows(plane: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, w: int,
            h: int, pad: int) -> torch.Tensor:
    """[B, h+2*pad, w+2*pad] int64 windows of ``plane`` [H, W] around the
    w x h blocks at (xs, ys) [B], edge-replicated outside the plane: a
    clamp of coordinates, as ops.inter.fetch_extended_block(plane, x, y, w,
    h, pad, pad, pad, pad) fetches one."""
    H, W = plane.shape
    i = torch.arange(-pad, h + pad, device=plane.device)
    j = torch.arange(-pad, w + pad, device=plane.device)
    rows = (ys.long()[:, None] + i[None]).clamp(0, H - 1)
    cols = (xs.long()[:, None] + j[None]).clamp(0, W - 1)
    return plane.long()[rows[:, :, None], cols[:, None, :]]


def _check_search(name, ref, blocks, vecs, bitdepth: int, max_bd: int):
    for t, nd in ((ref, 2), (blocks, 3)):
        if t.dtype != torch.int32 or t.dim() != nd:
            raise ValueError(f"{name}: expects int32 ref [H, W] and blocks "
                             "[B, h, w]")
    B = blocks.shape[0]
    for v in vecs:
        if v.dtype != torch.int32 or tuple(v.shape) != (B,):
            raise ValueError(f"{name}: expects int32 vectors [B]")
    if not 8 <= bitdepth <= max_bd:
        raise ValueError(f"{name}: samples of 8..{max_bd} bits only")


def fullpel_search_plain(ref: torch.Tensor, blocks: torch.Tensor,
                         xs: torch.Tensor, ys: torch.Tensor, r: int,
                         pen: torch.Tensor):
    """K9a, plain version: ref [H, W] int32, blocks [B, h, w] int32 at
    origins xs, ys [B], pen [(2r+1)^2] float32 (dy major) -> (mvx, mvy [B]
    int32 full-pel, cost [B] float32). corr, r2 and b2 are exact int64
    sums, each rounded to float32 once; cost = ((b2 - 2*corr) + r2) + pen
    in float32; the first minimum in raster order."""
    B, h, w = blocks.shape
    n = 2 * r + 1
    win = windows(ref, xs, ys, w, h, r)
    blk = blocks.long()
    corr = torch.zeros((B, n, n), dtype=torch.int64, device=ref.device)
    for i in range(h):
        for j in range(w):
            corr += blk[:, i, j, None, None] * win[:, i:i + n, j:j + n]
    sq = torch.nn.functional.pad(win * win, (1, 0, 1, 0))
    ii = sq.cumsum(1).cumsum(2)                    # integral image
    r2 = (ii[:, h:h + n, w:w + n] - ii[:, :n, w:w + n]
          - ii[:, h:h + n, :n] + ii[:, :n, :n])
    b2 = (blk * blk).sum(dim=(1, 2)).to(torch.float32)
    ssd = (b2[:, None, None] - 2.0 * corr.to(torch.float32)) \
        + r2.to(torch.float32)
    cost = (ssd + pen.reshape(1, n, n)).reshape(B, n * n)
    idx = torch.argmin(cost, dim=1)                # the first minimum
    best = cost.gather(1, idx[:, None])[:, 0]
    return ((idx % n - r).to(torch.int32), (idx // n - r).to(torch.int32),
            best)


def fullpel_search(ref: torch.Tensor, blocks: torch.Tensor, xs: torch.Tensor,
                   ys: torch.Tensor, r: int, pen: torch.Tensor,
                   bitdepth: int):
    """K9a: fullpel_search_plain on the CPU, the CUDA kernel on the card.
    The kernel's exact sums are uint32: h * w * (2^bitdepth - 1)^2 must be
    below 2^32 (a 64x64 block at 10 bits is)."""
    kernels.check_batch("fullpel_search", blocks.shape[0])
    if ref.device.type == "cpu":
        return fullpel_search_plain(ref, blocks, xs, ys, r, pen)
    dev = kernels.check_cuda("fullpel_search", ref, blocks, xs, ys, pen)
    _check_search("fullpel_search", ref, blocks, (xs, ys), bitdepth, 10)
    B, h, w = blocks.shape
    n = 2 * r + 1
    if pen.dtype != torch.float32 or pen.numel() != n * n:
        raise ValueError("fullpel_search: expects a float32 penalty of "
                         f"{n * n} offsets")
    H, W = ref.shape
    mvx = torch.empty((B,), dtype=torch.int32, device=dev)
    mvy = torch.empty((B,), dtype=torch.int32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    kernels.launch("fullpel_search", dev, ref.data_ptr(), H, W,
                   blocks.data_ptr(), xs.data_ptr(), ys.data_ptr(), B, w, h, r,
                   pen.data_ptr(), mvx.data_ptr(), mvy.data_ptr(),
                   cost.data_ptr())
    return mvx, mvy, cost


def _interp_one(win: torch.Tensor, offq_x: int, offq_y: int, w: int, h: int,
                bitdepth: int) -> torch.Tensor:
    """make_frac_search_fn's interp_one over int64 windows [B, h+10, w+10]
    (block at (5, 5))."""
    P = FRAC_PAD
    ix, iy = (offq_x * 4) >> 4, (offq_y * 4) >> 4
    fx, fy = (offq_x * 4) & 15, (offq_y * 4) & 15
    if fx == 0 and fy == 0:
        return win[:, P + iy:P + iy + h, P + ix:P + ix + w]
    hf, vf = LUMA_FILTER[fx], LUMA_FILTER[fy]
    hor = sum(int(hf[t]) * win[:, P + iy - 3:P + iy + h + 4,
                               P + ix - 3 + t:P + ix - 3 + t + w]
              for t in range(8))
    if bitdepth > 8:
        hor = hor >> (bitdepth - 8)
    out = sum(int(vf[t]) * hor[:, t:t + h] for t in range(8)) >> 6
    wp = 14 - bitdepth
    return ((out + (1 << (wp - 1))) >> wp).clamp(0, (1 << bitdepth) - 1)


def frac_search_plain(ref: torch.Tensor, blocks: torch.Tensor,
                      xs: torch.Tensor, ys: torch.Tensor, mvx: torch.Tensor,
                      mvy: torch.Tensor, fpen: torch.Tensor, bitdepth: int):
    """K9b, plain version: ref [H, W] int32, blocks [B, h, w] int32 at
    origins xs, ys with full-pel MVs mvx, mvy [B], fpen [49] float32 ->
    (best [B] int32, preds [B, 49, h, w] int32, costs [B, 49] float32),
    costs = float32(satd_bw) + fpen, best the first minimum."""
    from .intra_batch import satd67_plain
    B, h, w = blocks.shape
    win = windows(ref, xs.long() + mvx.long(), ys.long() + mvy.long(), w, h,
                  FRAC_PAD)
    # offset k is (dx, dy) = (k % 7 - 3, k // 7 - 3) quarter pels
    preds = torch.stack([_interp_one(win, k % 7 - 3, k // 7 - 3, w, h,
                                     bitdepth) for k in range(49)], dim=1) \
        .to(torch.int32)
    costs = satd67_plain(preds, blocks).to(torch.float32) + fpen[None]
    best = torch.argmin(costs, dim=1)              # the first minimum
    return best.to(torch.int32), preds, costs


def frac_search(ref: torch.Tensor, blocks: torch.Tensor, xs: torch.Tensor,
                ys: torch.Tensor, mvx: torch.Tensor, mvy: torch.Tensor,
                fpen: torch.Tensor, bitdepth: int, winner_only: bool = False):
    """K9b: frac_search_plain on the CPU, the CUDA kernel on the card.
    winner_only: the second output is the winning offset's prediction
    [B, h, w] (frac_search_plain's preds gathered at best) in place of all
    49 [B, 49, h, w]."""
    kernels.check_batch("frac_search", blocks.shape[0])
    if ref.device.type == "cpu":
        best, preds, costs = frac_search_plain(ref, blocks, xs, ys, mvx, mvy,
                                               fpen, bitdepth)
        if winner_only:
            preds = preds[torch.arange(best.shape[0]), best.long()]
        return best, preds, costs
    dev = kernels.check_cuda("frac_search", ref, blocks, xs, ys, mvx, mvy,
                             fpen)
    _check_search("frac_search", ref, blocks, (xs, ys, mvx, mvy), bitdepth,
                  12)
    if fpen.dtype != torch.float32 or fpen.numel() != 49:
        raise ValueError("frac_search: expects a float32 penalty of 49 "
                         "offsets")
    B, h, w = blocks.shape
    H, W = ref.shape
    best = torch.empty((B,), dtype=torch.int32, device=dev)
    preds = torch.empty((B, h, w) if winner_only else (B, 49, h, w),
                        dtype=torch.int32, device=dev)
    costs = torch.empty((B, 49), dtype=torch.float32, device=dev)
    kernels.launch("frac_search", dev, ref.data_ptr(), H, W, blocks.data_ptr(),
                   xs.data_ptr(), ys.data_ptr(), mvx.data_ptr(),
                   mvy.data_ptr(), B, w, h, bitdepth, fpen.data_ptr(),
                   best.data_ptr(), preds.data_ptr(), costs.data_ptr(),
                   int(winner_only))
    return best, preds, costs


# --- the kernels' arithmetic in plain PyTorch, for the tests --------------

# the window margin K9b reads: the 8 taps reach 3 samples before a sample,
# and the offsets' integer part (4q) >> 4 (q in -3..3 quarter pels) is -1
# or 0, their 1/16 phase (4q) & 15 one of 0, 4, 8, 12
_MARGIN = 4


def frac_search_sep(ref: torch.Tensor, blocks: torch.Tensor,
                    xs: torch.Tensor, ys: torch.Tensor, mvx: torch.Tensor,
                    mvy: torch.Tensor, fpen: torch.Tensor, bitdepth: int,
                    winner_only: bool = False):
    """K9b as csrc/frac_search.cu computes it, in plain PyTorch: the
    (h+8) x (w+8) window; the three horizontal passes at fx = 4, 8, 12
    over its rows and the w + 1 columns the offsets share, >> (bitdepth -
    8), kept as int16; at fx = 0 the window << (14 - bitdepth) (the
    reference's 64 * s >> (bitdepth - 8)); the vertical 8 taps per
    column, skipped at fy = 0; the window itself at k = 24; the SATD as
    a vertical then a horizontal butterfly Hadamard per sub-block. Equal
    to frac_search_plain (and, winner_only, to its gather)."""
    B, h, w = blocks.shape
    M = _MARGIN
    win = windows(ref, xs.long() + mvx.long(), ys.long() + mvy.long(), w, h,
                  M)                                  # [B, h+8, w+8]
    hx = []
    for fx in (4, 8, 12):
        f = LUMA_FILTER[fx]
        acc = sum(int(f[t]) * win[:, :, t:t + w + 1] for t in range(8))
        acc = acc >> (bitdepth - 8)
        h16 = acc.to(torch.int16)
        if not torch.equal(h16.long(), acc):
            raise OverflowError("frac_search_sep: a horizontal pass left "
                                "int16")
        hx.append(h16.long())                          # [B, h+8, w+1]
    wp = 14 - bitdepth
    mx = (1 << bitdepth) - 1
    preds = []
    for k in range(49):
        ox, oy = 4 * (k % 7 - 3), 4 * (k // 7 - 3)
        ix, iy, fx, fy = ox >> 4, oy >> 4, ox & 15, oy & 15
        if fx == 0 and fy == 0:
            preds.append(win[:, M:M + h, M:M + w])
            continue
        col = (win[:, :, M:M + w] << wp) if fx == 0             else hx[(fx >> 2) - 1][:, :, ix + 1:ix + 1 + w]
        if fy == 0:
            out = col[:, M:M + h]
        else:
            f = LUMA_FILTER[fy]
            out = sum(int(f[t]) * col[:, iy + 1 + t:iy + 1 + t + h]
                      for t in range(8)) >> 6
        preds.append(((out + (1 << (wp - 1))) >> wp).clamp(0, mx))
    preds = torch.stack(preds, dim=1)                  # [B, 49, h, w]
    costs = satd_butterfly(blocks.long()[:, None] - preds).to(torch.float32) \
        + fpen[None]
    best = torch.argmin(costs, dim=1)
    preds = preds.to(torch.int32)
    if winner_only:
        preds = preds[torch.arange(B), best]
    return best.to(torch.int32), preds, costs


def satd_butterfly(d: torch.Tensor) -> torch.Tensor:
    """satd_bw of differences d [..., h, w] (int64) as K9b takes it: per
    n x n sub-block the butterfly Hadamard down the columns, then along the
    rows (Sylvester order), sum|t| - |t00| + (|t00| >> 2), the sub-block's
    rounding, the integer sum over the sub-blocks."""
    *lead, h, w = d.shape
    n = 8 if (w >= 8 and h >= 8) else 4
    add, shift = (2, 2) if n == 8 else (1, 1)
    t = d.reshape(*lead, h // n, n, w // n, n).movedim(-3, -2).clone()
    for axis in (-2, -1):          # down the columns, then along the rows
        m = 1
        while m < n:
            t = t.unflatten(axis, (n // (2 * m), 2, m))
            a, b = t.select(axis - 1, 0), t.select(axis - 1, 1)
            t = torch.stack((a + b, a - b), dim=axis - 1).flatten(
                axis - 2, axis)
            m *= 2
    a = t.abs()
    s = a.sum(dim=(-2, -1))
    dc = a[..., 0, 0]
    s = (s - dc + (dc >> 2) + add) >> shift
    return s.sum(dim=(-2, -1))


def box_r2(win: torch.Tensor, w: int, h: int) -> torch.Tensor:
    """K9a's r2 as csrc/fullpel_search.cu computes it: windows [B, h+2r,
    w+2r] -> [B, 2r+1, 2r+1], the sum of win^2 over each h x w box, by
    column sums sliding down the rows, then row sums of those sliding
    along the columns, each step in uint32 (here int64 reduced modulo
    2^32: exact where the true sums stay below 2^32)."""
    mask = (1 << 32) - 1
    B, wh, ww = win.shape
    n = wh - h + 1
    sq = win.long() * win.long()
    cols = [sq[:, :h].sum(1) & mask]                   # [B, ww] per dy
    for dy in range(1, n):
        cols.append((cols[-1] + sq[:, dy + h - 1] - sq[:, dy - 1]) & mask)
    cs = torch.stack(cols, dim=1)                      # [B, n, ww]
    rows = [cs[:, :, :w].sum(2) & mask]
    for dx in range(1, ww - w + 1):
        rows.append((rows[-1] + cs[:, :, dx + w - 1] - cs[:, :, dx - 1])
                    & mask)
    return torch.stack(rows, dim=2)                    # [B, n, n]

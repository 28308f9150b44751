"""MIP (matrix-based intra prediction).

Port of uvg266_tpu/ops/mip.py. Behavioral parity with the reference:
- boundary Haar downsampling, reduced prediction with offset folding,
  two-stage linear upsampling:
  strategies/generic/intra-generic.c uvg_mip_boundary_downsampling_1D:441,
  uvg_mip_reduced_pred:472, uvg_mip_pred_upsampling_1D:527,
  mip_predict_generic:579
- weight matrices: mip_tables.py (spec constants)

`mip_predict_np` is the host-exact golden kernel (used by the sequential
reconstruction), a verbatim copy of the reference's. K10 ``mip_preds``
(the reference's make_mip_preds_fn) evaluates every (mode, transpose)
candidate of a size class for the device search: ``mip_preds_plain`` in
PyTorch, and the hand-written CUDA kernel (csrc/mip_preds.cu) for a source
plane on the card. Nothing falls back from one to the other.

MIP_SHIFT_MATRIX = 6, MIP_OFFSET_MATRIX = 32 (global constants).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .intra_batch import positions_on
from .mip_tables import MIP_4X4, MIP_8X8, MIP_16X16

MIP_SHIFT = 6
MIP_OFFSET = 32


def mip_size_id(w: int, h: int) -> int:
    if w == 4 and h == 4:
        return 0
    if w == 4 or h == 4 or (w == 8 and h == 8):
        return 1
    return 2


def mip_mode_count(w: int, h: int) -> int:
    return (16, 8, 6)[mip_size_id(w, h)]


def _downsample(ref: np.ndarray, dst_len: int) -> np.ndarray:
    src_len = ref.shape[-1]
    if dst_len < src_len:
        f = src_len // dst_len
        lg = f.bit_length() - 1
        s = ref.reshape(ref.shape[:-1] + (dst_len, f)).sum(-1)
        return (s + (1 << (lg - 1))) >> lg
    return ref[..., :dst_len]


def _upsample_1d(pred, boundary_row, factor):
    """Linear upsampling along the last axis: before/behind interpolation
    (uvg_mip_pred_upsampling_1D semantics). boundary_row: value before
    sample 0 per row."""
    lg = factor.bit_length() - 1
    rnd = 1 << (lg - 1)
    n = pred.shape[-1]
    before = np.concatenate([boundary_row[..., None], pred[..., :-1]],
                            axis=-1)
    pos = np.arange(1, factor + 1)
    # out[..., i*factor + (pos-1)] = ((f - pos)*before_i + pos*pred_i + rnd) >> lg
    out = ((factor - pos)[None, :] * before[..., :, None]
           + pos[None, :] * pred[..., :, None] + rnd) >> lg
    return out.reshape(pred.shape[:-1] + (n * factor,))


def mip_predict_np(ref_top: np.ndarray, ref_left: np.ndarray, w: int, h: int,
                   mode: int, transpose: bool, bitdepth: int = 8) -> np.ndarray:
    """Exact MIP prediction for one block. ref_top/ref_left: the w / h
    neighboring samples (refs.top[1:1+w], refs.left[1:1+h])."""
    size_id = mip_size_id(w, h)
    red_bdry = 2 if size_id == 0 else 4
    red_pred = 4 if size_id < 2 else 8
    ups_h = w // red_pred
    ups_v = h // red_pred

    top = _downsample(ref_top.astype(np.int64), red_bdry)
    left = _downsample(ref_left.astype(np.int64), red_bdry)
    bdry = np.concatenate([left, top]) if transpose \
        else np.concatenate([top, left])
    in_off = int(bdry[0])
    inp = bdry - in_off
    if size_id < 2:
        inp[0] = (1 << (bitdepth - 1)) - in_off
    else:
        inp[0] = 0
    M = (MIP_4X4, MIP_8X8, MIP_16X16)[size_id][mode].astype(np.int64)
    offset = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * int(inp.sum())
    red = ((M @ inp + offset) >> MIP_SHIFT) + in_off
    red = np.clip(red, 0, (1 << bitdepth) - 1).reshape(red_pred, red_pred)
    if transpose:
        red = red.T
    out = red.astype(np.int64)
    if ups_h > 1:
        # horizontal upsampling rows use the LEFT boundary as 'before'
        bl = ref_left.astype(np.int64)[ups_v - 1::ups_v][:red_pred]
        out = _upsample_1d(out, bl, ups_h)
    if ups_v > 1:
        bt = ref_top.astype(np.int64)[:w]
        out = _upsample_1d(out.T, bt, ups_v).T
    return out.astype(np.int32)


# --- K10: every (mode, transpose) candidate of a size class -----------------

def mip_geometry(w: int, h: int):
    """(size_id, n_modes, red_bdry, red_pred, ups_h, ups_v) of a w x h
    block."""
    size_id = mip_size_id(w, h)
    red_pred = 4 if size_id < 2 else 8
    return (size_id, mip_mode_count(w, h), 2 if size_id == 0 else 4,
            red_pred, w // red_pred, h // red_pred)


def _ds(ref: torch.Tensor, dst_len: int) -> torch.Tensor:
    src_len = ref.shape[-1]
    if dst_len < src_len:
        f = src_len // dst_len
        lg = f.bit_length() - 1
        s = ref.reshape(ref.shape[:-1] + (dst_len, f)).sum(-1)
        return (s + (1 << (lg - 1))) >> lg
    return ref[..., :dst_len]


def _ups(pred: torch.Tensor, boundary: torch.Tensor, factor: int):
    if factor == 1:
        return pred
    lg = factor.bit_length() - 1
    rnd = 1 << (lg - 1)
    n = pred.shape[-1]
    before = torch.cat([boundary[..., None], pred[..., :-1]], -1)
    pos = torch.arange(1, factor + 1, device=pred.device)
    out = ((factor - pos) * before[..., :, None]
           + pos * pred[..., :, None] + rnd) >> lg
    return out.reshape(pred.shape[:-1] + (n * factor,))


def _mip_reduced(src: torch.Tensor, xs, ys, w: int, h: int, bitdepth: int,
                 mat: torch.Tensor):
    """The reduced predictions of every (mode, transpose) candidate ->
    (red [B, 2*n_modes, red_pred, red_pred] int64, transposed back where
    the candidate is transposed; top [B, w] and left [B, h], the block's
    reference samples)."""
    size_id, n_modes, red_bdry, red_pred, _uh, _uv = mip_geometry(w, h)
    H, W = src.shape
    xs, ys = positions_on(xs, ys, w, h, H, W, src.device)
    xs, ys = xs.long(), ys.long()
    maxv = (1 << bitdepth) - 1
    s = src.long()
    M = mat.long()
    top = s[(ys - 1).clamp(0, H - 1)[:, None],
            (xs[:, None] + torch.arange(w, device=src.device)).clamp(0, W - 1)]
    left = s[(ys[:, None] + torch.arange(h, device=src.device))
             .clamp(0, H - 1), (xs - 1).clamp(0, W - 1)[:, None]]
    tt = _ds(top, red_bdry)
    ll = _ds(left, red_bdry)
    reds = []
    for transpose in (False, True):
        bdry = torch.cat([ll, tt], -1) if transpose else torch.cat([tt, ll], -1)
        in_off = bdry[:, :1]
        inp = bdry - in_off
        if size_id < 2:
            inp[:, 0] = (1 << (bitdepth - 1)) - in_off[:, 0]
        else:
            inp[:, 0] = 0
        offset = (1 << (MIP_SHIFT - 1)) - MIP_OFFSET * inp.sum(-1)
        red = ((M[None] * inp[:, None, None, :]).sum(-1)
               + offset[:, None, None]) >> MIP_SHIFT
        red = (red + in_off[:, :, None]).clamp(0, maxv)
        red = red.reshape(-1, n_modes, red_pred, red_pred)
        reds.append(red.transpose(2, 3) if transpose else red)
    return torch.cat(reds, dim=1), top, left


def mip_preds_plain(src: torch.Tensor, xs, ys, w: int, h: int,
                    bitdepth: int, mat: torch.Tensor) -> torch.Tensor:
    """K10, plain version: src [H, W] int32, block origins xs, ys [B] (host
    arrays), ``mat`` the size id's weight matrix [n_modes, red_pred^2,
    2*red_bdry] (ops.tables.mip_matrix) -> preds [B, 2*n_modes, h, w]
    int32: transpose False modes 0..n-1, then transpose True. Reference
    samples with the open-loop availability of the batched search: the row
    above and the column left of the block in the source plane, clamped to
    the plane (the reference's edge padding)."""
    _sid, _n, _rb, red_pred, ups_h, ups_v = mip_geometry(w, h)
    out, top, left = _mip_reduced(src, xs, ys, w, h, bitdepth, mat)
    n_cand = out.shape[1]
    if ups_h > 1:
        bl = left[:, ups_v - 1::ups_v][:, :red_pred]
        out = _ups(out, bl[:, None, :].expand(-1, n_cand, -1), ups_h)
    if ups_v > 1:
        out = _ups(out.transpose(2, 3),
                   top[:, None, :].expand(-1, n_cand, -1),
                   ups_v).transpose(2, 3)
    return out.to(torch.int32).contiguous()


def mip_preds_seg(src: torch.Tensor, xs, ys, w: int, h: int,
                  bitdepth: int, mat: torch.Tensor) -> torch.Tensor:
    """K10's output as csrc/mip_preds.cu forms it, in plain PyTorch: the
    horizontally upsampled reduced rows (red_pred rows of w samples per
    candidate, the left reference sample before column 0), then each
    output sample as one vertical step between two of those rows (the top
    reference row before row 0), with shifts and masks where the
    reference divides. Same arguments and result as mip_preds_plain, which
    it must equal."""
    _sid, _n, _rb, red_pred, ups_h, ups_v = mip_geometry(w, h)
    red, top, left = _mip_reduced(src, xs, ys, w, h, bitdepth, mat)
    B, n_cand = red.shape[:2]
    lgh, lgv = ups_h.bit_length() - 1, ups_v.bit_length() - 1
    X = torch.arange(w, device=src.device)
    rx, ph = X >> lgh, (X & (ups_h - 1)) + 1
    if ups_h > 1:
        cur = red[..., rx]                             # [B, C, red_pred, w]
        bl = left[:, ups_v - 1 + ups_v * torch.arange(red_pred,
                                                      device=src.device)]
        before = torch.where(rx == 0, bl[:, None, :, None],
                             red[..., (rx - 1).clamp(min=0)])
        rows = ((ups_h - ph) * before + ph * cur + (1 << (lgh - 1))) >> lgh
    else:
        rows = red
    if ups_v == 1:
        return rows.to(torch.int32).contiguous()
    Y = torch.arange(h, device=src.device)
    ry, pv = Y >> lgv, (Y & (ups_v - 1)) + 1
    cur = rows[:, :, ry]                               # [B, C, h, w]
    before = torch.where((ry == 0)[:, None], top[:, None, None, :],
                         rows[:, :, (ry - 1).clamp(min=0)])
    out = ((ups_v - pv[:, None]) * before + pv[:, None] * cur
           + (1 << (lgv - 1))) >> lgv
    return out.to(torch.int32).contiguous()


def mip_preds(src: torch.Tensor, xs, ys, w: int, h: int, bitdepth: int,
              mat: torch.Tensor) -> torch.Tensor:
    """K10: mip_preds_plain on the CPU, the CUDA kernel on the card."""
    kernels.check_batch("mip_preds", len(xs))
    if src.device.type == "cpu":
        return mip_preds_plain(src, xs, ys, w, h, bitdepth, mat)
    dev = kernels.check_cuda("mip_preds", src, mat)
    _sid, n_modes, red_bdry, red_pred, _uh, _uv = mip_geometry(w, h)
    if src.dtype != torch.int32 or src.dim() != 2 or mat.dtype != torch.uint8 \
            or tuple(mat.shape) != (n_modes, red_pred * red_pred,
                                    2 * red_bdry):
        raise ValueError("mip_preds: expects an int32 plane [H, W] and the "
                         "uint8 weight matrix of the block's size id")
    H, W = src.shape
    xd, yd = positions_on(xs, ys, w, h, H, W, dev)
    B = xd.numel()
    preds = torch.empty((B, 2 * n_modes, h, w), dtype=torch.int32, device=dev)
    kernels.launch("mip_preds", dev, src.data_ptr(), H, W, xd.data_ptr(),
                   yd.data_ptr(), B, w, h, bitdepth, mat.data_ptr(),
                   preds.data_ptr())
    return preds

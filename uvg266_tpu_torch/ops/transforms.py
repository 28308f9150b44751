"""Forward/inverse 2-D transforms (DCT-II / DST-VII / DCT-VIII), bit-exact.

Pipeline parity with the reference generic implementation
(dct-generic.c: mts_dct_generic:2560, mts_idct_generic:2622, butterfly
macros :720-770).  In matrix form, for an h x w residual block X:

  forward:  C  = rshift_round(Mv @ rshift_round(X @ Mh^T, s1), s2)
            s1 = log2(w) - 1 + bitdepth - 8,   s2 = log2(h) - 1 + 7
  inverse:  X' = clip16(rshift_round(clip16(rshift_round(Mv^T @ C, 7)) @ Mh,
                        20 - bitdepth))

Zero-out rules: a non-DCT2 32-point dimension keeps 16 coefficients; any
64-point dimension keeps 32 (mts_dct_generic:2582-2583).

K13 ``fwd_batch`` / ``inv_batch`` are the batched device twins (the
reference's make_fwd_fn / make_inv_fn), each a plain PyTorch version plus a
wrapper that launches the hand-written CUDA kernel (csrc/transform.cu) for
tensors on the card. Both compute in int32 where the reference does (x64
off: its products accumulate in int32), wrapping on overflow as it does,
and cast to int16 as it does, so they differ from the numpy versions above
on inputs far outside a residual's range. ``fwd_batch_sep`` /
``inv_batch_sep`` emulate the kernel's arithmetic (partial butterflies, the
kept outputs only, int16 intermediates, sums wrapped to int32) in plain
PyTorch, so the CPU tests hold its design to the plain versions.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .tr_matrices import (DCT2, DCT8, DST7, dct2_matrix, device_matrix,
                          device_matrix32, get_matrix)

LOG2 = {1: 0, 2: 1, 4: 2, 8: 3, 16: 4, 32: 5, 64: 6}


def fwd_shifts(width: int, height: int, bitdepth: int) -> tuple[int, int]:
    return LOG2[width] - 1 + bitdepth - 8, LOG2[height] - 1 + 7


def inv_shifts(bitdepth: int) -> tuple[int, int]:
    return 7, 20 - bitdepth


def zero_out(width: int, type_hor: int, type_ver: int, height: int) -> tuple[int, int]:
    """Number of retained coefficients per dimension."""
    keep_w = 16 if (type_hor != DCT2 and width == 32) else min(width, 32)
    keep_h = 16 if (type_ver != DCT2 and height == 32) else min(height, 32)
    return keep_w, keep_h


def _rshift_round(x, shift):
    # arithmetic shift with rounding, matching C ((v + (1<<(s-1))) >> s);
    # shift can reach 0 / negative for 1- and 2-point ISP transforms
    if shift <= 0:
        return x << (-shift)
    return (x + (1 << (shift - 1))) >> shift


def fwd_transform_2d(x: np.ndarray, type_hor: int = DCT2, type_ver: int = DCT2,
                     bitdepth: int = 8, lfnst: bool = False) -> np.ndarray:
    """Bit-exact numpy forward transform of one h x w block."""
    h, w = x.shape
    s1, s2 = fwd_shifts(w, h, bitdepth)
    mh = get_matrix(type_hor, w).astype(np.int64)
    mv = get_matrix(type_ver, h).astype(np.int64)
    tmp = _rshift_round(x.astype(np.int64) @ mh.T, s1).astype(np.int16).astype(np.int64)
    c = _rshift_round(mv @ tmp, s2).astype(np.int16)
    keep_w, keep_h = zero_out(w, type_hor, type_ver, h)
    if lfnst:
        if (w == 4 and h > 4) or (w > 4 and h == 4):
            keep_w, keep_h = 4, 4
        elif w >= 8 and h >= 8:
            keep_w, keep_h = 8, 8
    if keep_w < w:
        c[:, keep_w:] = 0
    if keep_h < h:
        c[keep_h:, :] = 0
    return c


def inv_transform_2d(c: np.ndarray, type_hor: int = DCT2, type_ver: int = DCT2,
                     bitdepth: int = 8) -> np.ndarray:
    """Bit-exact numpy inverse transform of one h x w coefficient block."""
    h, w = c.shape
    s1, s2 = inv_shifts(bitdepth)
    mh = get_matrix(type_hor, w).astype(np.int64)
    mv = get_matrix(type_ver, h).astype(np.int64)
    u = np.clip(_rshift_round(mv.T @ c.astype(np.int64), s1), -32768, 32767)
    x = np.clip(_rshift_round(u @ mh, s2), -32768, 32767).astype(np.int16)
    return x


# --- K13: the batched transforms -------------------------------------------

def _wrap(x, bits: int):
    """Two's-complement wrap of an int64 tensor (or a Python int) to
    ``bits`` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int64 product a [..., m, k] @ b [..., k, n] as a broadcast
    multiply and sum (no integer GEMM on the card)."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


# int64 elements of the largest intermediate per chunk of blocks
_PLAIN_CHUNK = 1 << 24


def _check_shifts(*shifts: int) -> None:
    # the reference builds its rounding offsets 1 << (s - 1) when it is
    # made, and Python refuses a negative shift there
    if min(shifts) < 1:
        raise ValueError("negative shift count")


def _fwd_params(width: int, height: int, type_hor: int, type_ver: int,
                bitdepth: int) -> tuple[int, int, int, int]:
    """(s1, s2, keep_w, keep_h) of make_fwd_fn, raising where it raises:
    a negative shift (width 2 at 8 bits) or a matrix that does not exist
    (DST7 / DCT8 at 64)."""
    s1, s2 = fwd_shifts(width, height, bitdepth)
    get_matrix(type_hor, width)
    get_matrix(type_ver, height)
    keep_w, keep_h = zero_out(width, type_hor, type_ver, height)
    _check_shifts(s1, s2)
    return s1, s2, keep_w, keep_h


def _inv_params(width: int, height: int, type_hor: int, type_ver: int,
                bitdepth: int) -> tuple[int, int]:
    """(s1, s2) of make_inv_fn, raising where it raises."""
    s1, s2 = inv_shifts(bitdepth)
    get_matrix(type_hor, width)
    get_matrix(type_ver, height)
    _check_shifts(s1, s2)
    return s1, s2


def _check_blocks(name: str, x: torch.Tensor) -> None:
    """Raise unless x is an integer tensor [..., h, w]."""
    if x.dim() < 2 or x.dtype.is_floating_point or x.dtype.is_complex \
            or x.dtype == torch.bool:
        raise ValueError(f"{name}: expects an integer tensor [..., h, w]")


def _int32_blocks(name: str, x: torch.Tensor) -> torch.Tensor:
    """x [..., h, w] of an integer type as int32, as the reference's
    astype(int32)."""
    _check_blocks(name, x)
    return x.to(torch.int32)


def fwd_batch_plain(x: torch.Tensor, type_hor: int = DCT2,
                    type_ver: int = DCT2, bitdepth: int = 8) -> torch.Tensor:
    """K13 forward, plain version (the reference's make_fwd_fn): residuals
    x [..., h, w] of an integer type -> coefficients [..., h, w] int16:
      t = int16((x @ Mh^T + (1 << (s1-1))) >> s1)
      c = int16((Mv @ t + (1 << (s2-1))) >> s2), zero outside the kept
          rectangle (zero_out)
    with the products and the rounding add in int32 (wrapping)."""
    x = _int32_blocks("fwd_batch", x)
    h, w = x.shape[-2:]
    s1, s2, keep_w, keep_h = _fwd_params(w, h, type_hor, type_ver, bitdepth)
    mh = device_matrix(type_hor, w, str(x.device)).long()
    mv = device_matrix(type_ver, h, str(x.device)).long()
    xb = x.reshape(-1, h, w)
    out = torch.empty(xb.shape, dtype=torch.int16, device=x.device)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, xb.shape[0], step):
        blk = xb[b0:b0 + step].long()
        t = _wrap(_wrap(_imatmul(blk, mh.T) + (1 << (s1 - 1)), 32) >> s1, 16)
        c = _wrap(_wrap(_imatmul(mv, t) + (1 << (s2 - 1)), 32) >> s2, 16)
        c[:, keep_h:, :] = 0
        c[:, :, keep_w:] = 0
        out[b0:b0 + step] = c
    return out.reshape(x.shape)


def inv_batch_plain(c: torch.Tensor, type_hor: int = DCT2,
                    type_ver: int = DCT2, bitdepth: int = 8) -> torch.Tensor:
    """K13 inverse, plain version (the reference's make_inv_fn):
    coefficients c [..., h, w] of an integer type -> residuals [..., h, w]
    int16:
      u = clip16((Mv^T @ c + (1 << (s1-1))) >> s1)
      x = clip16((u @ Mh + (1 << (s2-1))) >> s2)
    with the products and the rounding add in int32 (wrapping)."""
    c = _int32_blocks("inv_batch", c)
    h, w = c.shape[-2:]
    s1, s2 = _inv_params(w, h, type_hor, type_ver, bitdepth)
    mh = device_matrix(type_hor, w, str(c.device)).long()
    mv = device_matrix(type_ver, h, str(c.device)).long()
    cb = c.reshape(-1, h, w)
    out = torch.empty(cb.shape, dtype=torch.int16, device=c.device)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, cb.shape[0], step):
        blk = cb[b0:b0 + step].long()
        u = (_wrap(_imatmul(mv.T, blk) + (1 << (s1 - 1)), 32) >> s1) \
            .clamp(-32768, 32767)
        r = (_wrap(_imatmul(u, mh) + (1 << (s2 - 1)), 32) >> s2) \
            .clamp(-32768, 32767)
        out[b0:b0 + step] = r
    return out.reshape(c.shape)


def _launch_transform(name: str, x: torch.Tensor, type_hor: int,
                      type_ver: int, *params: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    x = x.contiguous()
    dev = kernels.check_cuda(name, x)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the blocks must be 16-byte aligned (the "
                         "kernel reads them four samples at a time)")
    out = torch.empty(x.shape, dtype=torch.int16, device=dev)
    # the forward reads M's rows, the inverse M^T's (M's columns)
    t = name == "inv_transform"
    kernels.launch(name, dev, x.data_ptr(), x.numel() // (h * w), w, h,
                   type_hor, type_ver,
                   device_matrix32(type_hor, w, str(dev), t).data_ptr(),
                   device_matrix32(type_ver, h, str(dev), t).data_ptr(),
                   *params, out.data_ptr())
    return out


def fwd_batch(x: torch.Tensor, type_hor: int = DCT2, type_ver: int = DCT2,
              bitdepth: int = 8) -> torch.Tensor:
    """K13 forward: fwd_batch_plain on the CPU, the CUDA kernel on the
    card."""
    kernels.check_batch("fwd_batch", x.numel())
    if x.device.type == "cpu":
        return fwd_batch_plain(x, type_hor, type_ver, bitdepth)
    x = _int32_blocks("fwd_batch", x)
    h, w = x.shape[-2:]
    params = _fwd_params(w, h, type_hor, type_ver, bitdepth)
    return _launch_transform("fwd_transform", x, type_hor, type_ver, *params)


def inv_batch(c: torch.Tensor, type_hor: int = DCT2, type_ver: int = DCT2,
              bitdepth: int = 8) -> torch.Tensor:
    """K13 inverse: inv_batch_plain on the CPU, the CUDA kernel on the
    card."""
    kernels.check_batch("inv_batch", c.numel())
    if c.device.type == "cpu":
        return inv_batch_plain(c, type_hor, type_ver, bitdepth)
    c = _int32_blocks("inv_batch", c)
    h, w = c.shape[-2:]
    params = _inv_params(w, h, type_hor, type_ver, bitdepth)
    return _launch_transform("inv_transform", c, type_hor, type_ver, *params)


# --- K13's arithmetic as csrc/transform.cu computes it ----------------------

def _bfly_fwd_keep(v: torch.Tensor, n: int, keep: int) -> torch.Tensor:
    """The first ``keep`` outputs of the n-point forward DCT2 along the last
    axis of v (int64 holding int32), as the kernel's partial butterfly to
    its full depth: e = v[x] + v[n-1-x] and d = v[x] - v[n-1-x] (x < n/2),
    the odd outputs from d and the n-point matrix, the even ones the
    n/2-point transform of e; every sum wrapped to int32 (the kernel's
    uint32)."""
    if n == 1:
        return _wrap(v * 64, 32)
    hn = n // 2
    r = v.flip(-1)[..., :hn]
    e, d = _wrap(v[..., :hn] + r, 32), _wrap(v[..., :hn] - r, 32)
    m = torch.from_numpy(dct2_matrix(n)).long().to(v.device)
    out = torch.empty(v.shape[:-1] + (keep,), dtype=torch.int64,
                      device=v.device)
    out[..., 1::2] = _wrap(_imatmul(d, m[1:keep:2, :hn].T), 32)
    out[..., 0::2] = _bfly_fwd_keep(e, hn, (keep + 1) // 2)
    return out


def _bfly_inv_full(c: torch.Tensor, n: int) -> torch.Tensor:
    """The n-point inverse DCT2 along the last axis, as the kernel's
    butterfly: out[x] = E(x) + O(x), out[n-1-x] = E(x) - O(x), O from the
    odd coefficients and the n-point matrix, E the n/2-point inverse of the
    even ones; every sum wrapped to int32."""
    if n == 1:
        return _wrap(c * 64, 32)
    hn = n // 2
    m = torch.from_numpy(dct2_matrix(n)).long().to(c.device)
    e = _bfly_inv_full(c[..., 0::2], hn)
    o = _wrap(_imatmul(c[..., 1::2], m[1::2, :hn]), 32)
    return torch.cat([_wrap(e + o, 32), _wrap(e - o, 32).flip(-1)], -1)


def _pass_sep(v: torch.Tensor, tr_type: int, n: int, keep: int, fwd: bool,
              butterfly: bool) -> torch.Tensor:
    """One 1-D pass along the last axis (the rounding add and shift not
    included): the butterfly of a DCT2 dimension, or the matrix product of
    a DST7 / DCT8 dimension and of the generic instance; the forward's
    first ``keep`` outputs, the inverse's every output."""
    if butterfly and tr_type == DCT2:
        return _bfly_fwd_keep(v, n, keep) if fwd else _bfly_inv_full(v, n)
    m = torch.from_numpy(get_matrix(tr_type, n)).long().to(v.device)
    return _wrap(_imatmul(v, m[:keep].T if fwd else m), 32)


def fwd_batch_sep(x: torch.Tensor, type_hor: int = DCT2,
                  type_ver: int = DCT2, bitdepth: int = 8) -> torch.Tensor:
    """K13 forward as csrc/transform.cu computes it, in plain PyTorch: the
    row pass (partial butterflies to full depth for DCT2, matrix passes for
    DST7 / DCT8; plain products at a dimension of 1 or 2, the generic
    instance) computes only the keep_w kept outputs, t is int16, the column
    pass only the kept columns' keep_h outputs, zeros elsewhere; the sums
    wrap to int32. Same arguments and result as fwd_batch_plain, which it
    must equal bit for bit."""
    x = _int32_blocks("fwd_batch", x)
    h, w = x.shape[-2:]
    s1, s2, keep_w, keep_h = _fwd_params(w, h, type_hor, type_ver, bitdepth)
    bf = w >= 4 and h >= 4
    xb = x.reshape(-1, h, w)
    out = torch.zeros(xb.shape, dtype=torch.int16, device=x.device)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, xb.shape[0], step):
        blk = xb[b0:b0 + step].long()
        t = _pass_sep(blk, type_hor, w, keep_w, True, bf)        # [b, h, kw]
        t = _wrap(_wrap(t + (1 << (s1 - 1)), 32) >> s1, 16)
        c = _pass_sep(t.mT, type_ver, h, keep_h, True, bf)       # [b, kw, kh]
        c = _wrap(_wrap(c + (1 << (s2 - 1)), 32) >> s2, 16)
        out[b0:b0 + step, :keep_h, :keep_w] = c.mT.to(torch.int16)
    return out.reshape(x.shape)


def inv_batch_sep(c: torch.Tensor, type_hor: int = DCT2,
                  type_ver: int = DCT2, bitdepth: int = 8) -> torch.Tensor:
    """K13 inverse as csrc/transform.cu computes it, in plain PyTorch: the
    column pass, then u as int16 (clipped), then the row pass, each a
    butterfly (DCT2) or a matrix pass (DST7 / DCT8; plain products at a
    dimension of 1 or 2) over every coefficient (the kernel's shortcut for
    coefficients that are zero outside a 64-point dimension's first 32
    leaves out only terms that are zero, and its __dp2a_lo pairs add the
    same products); the sums wrap to int32.
    Same arguments and result as inv_batch_plain, which it must equal bit
    for bit."""
    c = _int32_blocks("inv_batch", c)
    h, w = c.shape[-2:]
    s1, s2 = _inv_params(w, h, type_hor, type_ver, bitdepth)
    bf = w >= 4 and h >= 4
    cb = c.reshape(-1, h, w)
    out = torch.empty(cb.shape, dtype=torch.int16, device=c.device)
    step = max(1, _PLAIN_CHUNK // (h * w * max(w, h)))
    for b0 in range(0, cb.shape[0], step):
        blk = cb[b0:b0 + step].long()
        u = _pass_sep(blk.mT, type_ver, h, h, False, bf).mT       # columns
        u = (_wrap(u + (1 << (s1 - 1)), 32) >> s1).clamp(-32768, 32767)
        r = _pass_sep(u, type_hor, w, w, False, bf)                # rows
        r = (_wrap(r + (1 << (s2 - 1)), 32) >> s2).clamp(-32768, 32767)
        out[b0:b0 + step] = r
    return out.reshape(c.shape)

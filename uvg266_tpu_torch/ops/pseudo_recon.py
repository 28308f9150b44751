"""Pseudo-reconstruction of a source plane at a given QP.

Port of uvg266_tpu/ops/pseudo_recon.py. The two-phase design searches
phase 1 open-loop: intra predictions are built from *source* neighbours,
which at high QP are far cleaner than the real reconstruction the decoder
will have. The counter is a one-pass DC-pred + DCT2 + quant + dequant +
inverse round trip of the whole plane on a fixed 16x16 tile grid: a plane
with the right noise level for the QP, used only as the neighbour source
of the inter-slice intra screen (distortion targets stay the source).

- ``pseudo_recon_plane``: the host version (numpy, int64), a verbatim copy
  of the reference's; the fused inter search calls it on the host, as the
  reference does.
- K5 ``pseudo_recon``: the device twin (reference: make_pseudo_recon_fn,
  int32 arithmetic), as a plain PyTorch version plus a wrapper that
  launches the hand-written CUDA kernel (csrc/pseudo_recon.cu) for tensors
  on the card. All three agree bit for bit.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .quant import INV_QUANT_SCALES, MAX_TR_DYNAMIC_RANGE, QUANT_SHIFT, \
    quant_params
from .rd_cost import _in32, quant_consts
from .tr_matrices import DCT2, get_matrix
from .transforms import (_PLAIN_CHUNK, _imatmul, _wrap, fwd_shifts,
                         inv_shifts)

_LOG2 = {16: 4}
TILE = 16


def _rshift_round(x: np.ndarray, shift: int) -> np.ndarray:
    return (x + (1 << (shift - 1))) >> shift


def pseudo_recon_plane(src: np.ndarray, qp_scaled: int,
                       bitdepth: int = 8, tile: int = 16) -> np.ndarray:
    """Quantization-roundtrip approximation of the recon of `src` at
    `qp_scaled` (luma scale). Returns int32, same shape as src."""
    h, w = src.shape
    ph, pw = -(-h // tile) * tile, -(-w // tile) * tile
    plane = np.empty((ph, pw), dtype=np.int64)
    plane[:h, :w] = src
    if pw > w:
        plane[:h, w:] = src[:, -1:]
    if ph > h:
        plane[h:, :] = plane[h - 1:h, :]
    # tiles (B, t, t)
    t = tile
    blocks = plane.reshape(ph // t, t, pw // t, t).transpose(0, 2, 1, 3) \
        .reshape(-1, t, t)
    # DC prediction per tile (mean), residual roundtrip
    dc = blocks.mean(axis=(1, 2), keepdims=True).round().astype(np.int64)
    res = blocks - dc
    s1, s2 = fwd_shifts(t, t, bitdepth)
    m = get_matrix(DCT2, t).astype(np.int64)
    tmp = _rshift_round(res @ m.T, s1)
    coef = _rshift_round(np.einsum("ij,bjk->bik", m, tmp), s2)
    scale, q_bits, add = quant_params(qp_scaled, _LOG2[t], _LOG2[t],
                                      bitdepth, is_intra_slice=True)
    level = (np.abs(coef) * scale + add) >> q_bits
    q = np.sign(coef) * np.minimum(level, 32767)
    # dequant
    transform_shift = MAX_TR_DYNAMIC_RANGE - bitdepth - _LOG2[t]
    shift = 20 - QUANT_SHIFT - transform_shift
    dscale = int(INV_QUANT_SCALES[0, qp_scaled % 6]) << (qp_scaled // 6)
    dadd = 1 << (shift - 1)
    dq = np.clip((q * dscale + dadd) >> shift, -32768, 32767)
    i1, i2 = inv_shifts(bitdepth)
    u = np.clip(_rshift_round(np.einsum("ij,bjk->bik", m.T, dq), i1),
                -32768, 32767)
    rec_res = np.clip(_rshift_round(u @ m, i2), -32768, 32767)
    rec = np.clip(rec_res + dc, 0, (1 << bitdepth) - 1)
    out = rec.reshape(ph // t, pw // t, t, t).transpose(0, 2, 1, 3) \
        .reshape(ph, pw)
    return out[:h, :w].astype(np.int32)


@lru_cache(maxsize=None)
def _dct16(device: str) -> torch.Tensor:
    """The 16x16 DCT2 as int8 on ``device`` (entries within +-90)."""
    return torch.from_numpy(get_matrix(DCT2, TILE).astype(np.int8)) \
        .to(torch.device(device))


def pseudo_recon_plain(src: torch.Tensor, qp_scaled: int,
                       bitdepth: int = 8) -> torch.Tensor:
    """K5, plain version: src [H, W] int32 (H, W multiples of 16) ->
    [H, W] int32, with make_pseudo_recon_fn's int32 arithmetic."""
    H, W = src.shape
    t = TILE
    c = quant_consts(t, t, bitdepth, qp_scaled)      # intra rounding 171
    s1, s2 = fwd_shifts(t, t, bitdepth)
    i1, i2 = inv_shifts(bitdepth)
    m = _dct16(str(src.device)).long()
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


def _line16_fwd(v, m):
    """The 16-point forward DCT2 along the last axis as csrc/butterfly.cuh
    fwd_line16 forms it: o[k] = sum_x v[x] * m[k][x] from the odd half
    (64 products), the even half split into rows 4m+2 (16) and then rows
    4, 12 and 0, 8 (4 each); raises where a sum leaves int32."""
    def halves(a):                     # a[x] +- a[n-1-x], x < n/2
        h = a.shape[-1] // 2
        b = a[..., h:].flip(-1)
        return a[..., :h] + b, a[..., :h] - b

    E, O = halves(v)
    EE, EO = halves(E)
    EEE, EEO = halves(EE)
    o = torch.empty_like(v)
    o[..., 1::2] = _imatmul(O, m[1::2, :8].T)
    o[..., 2::4] = _imatmul(EO, m[2::4, :4].T)
    o[..., 4::8] = _imatmul(EEO, m[4::8, :2].T)
    o[..., 0::8] = _imatmul(EEE, m[0::8, :2].T)
    _in32(E, EE)
    return _in32(o)


def _line16_inv(c, m):
    """The 16-point inverse DCT2 along the last axis as csrc/butterfly.cuh
    inv_line16 forms it: o[x] = sum_k c[k] * m[k][x] from the odd rows'
    sums O (x < 8), the rows 4m+2's EO (x < 4) and the rows 4, 12 and 0,
    8's sums (x < 2), recombined; raises where a sum leaves int32."""
    O = _imatmul(c[..., 1::2], m[1::2, :8])
    EO = _imatmul(c[..., 2::4], m[2::4, :4])
    EEO = _imatmul(c[..., 4::8], m[4::8, :2])
    EEE = _imatmul(c[..., 0::8], m[0::8, :2])
    EE = torch.cat([EEE + EEO, (EEE - EEO).flip(-1)], -1)
    E = torch.cat([EE + EO, (EE - EO).flip(-1)], -1)
    _in32(O, E)
    return _in32(torch.cat([E + O, (E - O).flip(-1)], -1))


def pseudo_recon_sep(src: torch.Tensor, qp_scaled: int,
                     bitdepth: int = 8) -> torch.Tensor:
    """K5's arithmetic as csrc/pseudo_recon.cu computes it, in plain
    PyTorch, for the tests: the tile's DC from the quotient and remainder
    of its integer sum, the four 16-point DCT2 passes as full partial
    butterflies (_line16_fwd / _line16_inv: rows, columns, then columns,
    rows back), no int16 wrap between the forward passes, the quantiser
    with rounding 171 and the dequantiser in int32 that wraps.
    Same arguments and result as pseudo_recon_plain, which it must equal
    bit for bit; raises where a pass sum would leave int32."""
    H, W = src.shape
    t = TILE
    c = quant_consts(t, t, bitdepth, qp_scaled)      # intra rounding 171
    s1, s2 = fwd_shifts(t, t, bitdepth)
    i1, i2 = inv_shifts(bitdepth)
    m = _dct16(str(src.device)).long()

    def rsh(x, s):
        return (x + (1 << (s - 1))) >> s

    tiles = src.long().reshape(H // t, t, W // t, t).transpose(1, 2) \
        .reshape(-1, t, t)
    out = torch.empty(tiles.shape, dtype=torch.int32, device=src.device)
    step = max(1, _PLAIN_CHUNK // t ** 3)
    for b0 in range(0, tiles.shape[0], step):
        blk = tiles[b0:b0 + step]
        s = blk.sum(dim=(1, 2), keepdim=True)
        dc = s >> 8                        # sum / 256, rounded half to even
        rem = s & 255
        dc = dc + ((rem > 128) | ((rem == 128) & (dc % 2 == 1))).long()
        tmp = rsh(_line16_fwd(blk - dc, m), s1)                 # rows
        coef = rsh(_line16_fwd(tmp.mT, m), s2).mT               # columns
        level = (_wrap(coef.abs() * c["scale"] + c["add"], 32)
                 >> c["q_bits"]).clamp(max=32767)
        dq = (_wrap(coef.sign() * level * c["iscale"]
                    + (1 << (c["dq_shift"] - 1)), 32)
              >> c["dq_shift"]).clamp(-32768, 32767)
        u = rsh(_line16_inv(dq.mT, m), i1).clamp(-32768, 32767).mT
        rr = rsh(_line16_inv(u, m), i2).clamp(-32768, 32767)     # rows
        out[b0:b0 + step] = (rr + dc).clamp(0, (1 << bitdepth) - 1)
    return out.reshape(H // t, W // t, t, t).transpose(1, 2).reshape(H, W)


def pseudo_recon(src: torch.Tensor, qp_scaled: int,
                 bitdepth: int = 8) -> torch.Tensor:
    """K5: pseudo_recon_plain on the CPU, the CUDA kernel on the card."""
    H, W = src.shape
    if H % TILE or W % TILE:
        raise ValueError("pseudo_recon: the plane must be a multiple of 16 "
                         "in both dimensions")
    kernels.check_batch("pseudo_recon", H * W)
    if src.device.type == "cpu":
        return pseudo_recon_plain(src, qp_scaled, bitdepth)
    dev = kernels.check_cuda("pseudo_recon", src)
    if src.dtype != torch.int32:
        raise ValueError("pseudo_recon: expects an int32 plane")
    if src.data_ptr() % 16:
        raise ValueError("pseudo_recon: the plane must be 16-byte aligned "
                         "(the kernel reads it four samples at a time)")
    c = quant_consts(TILE, TILE, bitdepth, qp_scaled)
    out = torch.empty_like(src)
    kernels.launch("pseudo_recon", dev, src.data_ptr(), H, W,
                   _dct16(str(dev)).data_ptr(), bitdepth, c["q_bits"],
                   c["scale"], c["add"], c["iscale"], c["dq_shift"],
                   out.data_ptr())
    return out

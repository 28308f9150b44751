"""The static tables of the intra search, and their move to the device.

The reference has no learned weights: its parameters are these tables,
built on the host with numpy exactly as the JAX package builds them:

- per size class: the 67-mode prediction tables of build_mode_tables
  (K, W, pdpc_*, hv_*, pd_*) and the DCT2 matrices of the two sides;
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

from functools import lru_cache

import numpy as np
import torch

from .fast_cost_tables import FAST_COEFF_WTS
from .intra_batch import build_mode_tables
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
           "QUANT_SCALES", "ROUGH_MODES", "class_tables", "device_mts_tables",
           "device_mvd_bits", "device_tables", "frame_tables",
           "frac_penalty", "me_penalties", "mip_matrix", "mip_mode_bits",
           "mts_class_tables", "mvd_bits_table", "rough_modes",
           "tables_to_torch"]


def class_tables(w: int, h: int, bitdepth: int) -> dict:
    """numpy tables of one luma size class: build_mode_tables plus the DCT2
    matrices of its width (mat_w) and height (mat_h)."""
    t = dict(build_mode_tables(w, h, bitdepth, False))
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


@lru_cache(maxsize=None)
def device_tables(w: int, h: int, bitdepth: int, device: str) -> dict:
    """class_tables(w, h, bitdepth) on ``device``, built once per process."""
    return tables_to_torch(class_tables(w, h, bitdepth), torch.device(device))


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
def device_mts_tables(w: int, h: int, device: str) -> dict:
    """mts_class_tables(w, h) on ``device``, built once per process."""
    return tables_to_torch(mts_class_tables(w, h), torch.device(device))


@lru_cache(maxsize=None)
def mip_matrix(size_id: int, device: str) -> torch.Tensor:
    """The MIP weight matrix of a size id, uint8 [n_modes, red_pred^2,
    2*red_bdry] on ``device``."""
    m = (MIP_4X4, MIP_8X8, MIP_16X16)[size_id]
    return torch.from_numpy(np.ascontiguousarray(m, dtype=np.uint8)) \
        .to(torch.device(device))


@lru_cache(maxsize=None)
def mip_mode_bits(n_cand: int, device: str) -> torch.Tensor:
    """The flat 6.0 signalling bits of the n_cand MIP candidates, float32
    on ``device`` (the reference's mip_bits of dispatch_blocks)."""
    return torch.full((n_cand,), 6.0, dtype=torch.float32,
                      device=torch.device(device))


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
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


@lru_cache(maxsize=None)
def me_penalties(lam: float, r: int, device: str):
    """(pen [(2r+1)^2], fpen [49]) float32 on ``device``: the full-pel
    penalty make_mv_penalty(r, sqrt(lam)), flattened dy major, and the
    quarter-pel frac_penalty(sqrt(lam)), lam the inter lambda (float64)."""
    lam_sqrt = np.sqrt(lam)
    dev = torch.device(device)
    return (torch.from_numpy(make_mv_penalty(r, lam_sqrt).reshape(-1))
            .to(dev), torch.from_numpy(frac_penalty(lam_sqrt)).to(dev))

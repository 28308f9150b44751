"""The static tables of the intra search, and their move to the device.

The reference has no learned weights: its parameters are these tables,
built on the host with numpy exactly as the JAX package builds them:

- per size class: the 67-mode prediction tables of build_mode_tables
  (K, W, pdpc_*, hv_*, pd_*) and the DCT2 matrices of the two sides;
- per QP: the fast coefficient-cost weights FAST_COEFF_WTS and the
  quantiser scales QUANT_SCALES / INV_QUANT_SCALES;
- the per-mode signalling bits MODE_BITS of the mode preselection.

``tables_to_torch`` turns a dict of such numpy tables into tensors on a
device, each stored in the narrowest integer type that holds its values
(as the kernels read them); ``device_tables`` and ``frame_tables`` cache
the result per class, QP and device.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .fast_cost_tables import FAST_COEFF_WTS
from .intra_batch import build_mode_tables
from .quant import INV_QUANT_SCALES, QUANT_SCALES
from .tr_matrices import DCT2, get_matrix

# rough per-mode signalling bits for the mode preselection (MPM-hit modes
# are cheaper in reality); control/encoder.py _MODE_BITS of the reference
MODE_BITS = np.full(67, 5.0, dtype=np.float32)
MODE_BITS[0] = 1.5
MODE_BITS[1] = 3.0

# the type each table is stored in on the device: every K index is below
# 4*REF_LEN = 780, every weight and DCT2 entry within +-128
NARROW = {"K": np.int16, "W": np.int8, "pdpc_wl": np.int8,
          "pdpc_sidx": np.int16, "hv_wl": np.int8, "hv_sidx": np.int16,
          "hv_topleft": np.int16, "mat_w": np.int8, "mat_h": np.int8}

__all__ = ["FAST_COEFF_WTS", "INV_QUANT_SCALES", "MODE_BITS", "QUANT_SCALES",
           "class_tables", "device_tables", "frame_tables", "tables_to_torch"]


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

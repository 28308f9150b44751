"""K2's descriptor path on the CPU: csrc/predict67.cu computes the angular
modes from one descriptor per mode (ops/tables.py mode_descriptors), not
from the per-sample tables of build_mode_tables that predict67_plain reads.
ops/tables.py predict67_desc emulates the kernel's arithmetic in plain
PyTorch; it must equal predict67_plain exactly at every shape the partition
lattice produces (control/partition.py _shapes: the 4x4-64x64 squares, the
BT children (s, s/2), (s/2, s) and the TT outer children (s, s/4), (s/4,
s)), at 8 and 10 bits, for all 67 modes and for the rough search's 35-mode
subset, on random and edge references (all zero, all at the maximum, a
checkerboard of the two).
"""
import numpy as np
import pytest
import torch

from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import tables as tb


def _lattice():
    shapes = {(s, s) for s in (4, 8, 16, 32, 64)}
    for s in (8, 16, 32, 64):
        shapes |= {(s, s >> 1), (s >> 1, s)}
    for s in (16, 32, 64):
        shapes |= {(s, s >> 2), (s >> 2, s)}
    return sorted(shapes)


def _refs(bd, seed):
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    n = 4 * ib.REF_LEN
    rows = [rng.integers(0, mx + 1, n), rng.integers(0, mx + 1, n),
            np.zeros(n), np.full(n, mx), (np.arange(n) % 2) * mx,
            ((np.arange(n) // 3) % 2) * mx]
    return torch.from_numpy(np.stack(rows).astype(np.int32))


@pytest.mark.parametrize("bd", (8, 10))
@pytest.mark.parametrize("w,h", _lattice())
def test_descriptor_path_equals_plain(w, h, bd):
    refs = _refs(bd, 100 * w + h + bd)
    tabs = tb.device_tables(w, h, bd, "cpu")
    np.testing.assert_array_equal(
        tb.predict67_desc(refs, w, h, bd).numpy(),
        ib.predict67_plain(refs, tabs).numpy())
    m35 = torch.from_numpy(tb.ROUGH_MODES.copy())
    np.testing.assert_array_equal(
        tb.predict67_desc(refs, w, h, bd, m35).numpy(),
        ib.predict67_plain(refs, tabs, m35).numpy())


@pytest.mark.parametrize("w,h", _lattice())
def test_descriptors_stay_inside_the_extended_reference(w, h):
    """Every tap lies inside the extended reference the kernel builds, which
    fits its shared-memory row of 2 * max(w, h) + 4 samples; the descriptor
    carries the work geometry of build_mode_tables."""
    desc, ext_max = tb.mode_descriptors(w, h)
    assert desc.shape == (ib.NUM_MODES, tb.DESC_N) and desc.dtype == np.int32
    assert 1 <= ext_max <= 2 * max(w, h) + 4
    assert (desc[:, tb.D_MODE] == np.arange(ib.NUM_MODES)).all()
    ang = desc[2:]
    assert (ang[:, tb.D_EXTN] <= ext_max).all()
    # integer slopes copy, fractional ones filter and clip
    frac = (np.abs(ang[:, tb.D_SD]) & 31) != 0
    assert ((ang[:, tb.D_FILT] != tb.FILT_INT) == frac).all()
    assert (ang[:, tb.D_CLIP] == frac).all()
    # negative slopes project the side reference in front of the main one
    neg = ang[:, tb.D_SD] < 0
    ww = np.where(ang[:, tb.D_VERT] == 1, w, h)
    hh = np.where(ang[:, tb.D_VERT] == 1, h, w)
    assert (ang[neg, tb.D_BASE] == hh[neg]).all()
    assert (ang[~neg, tb.D_BASE] == 0).all()
    assert (ang[:, tb.D_MAINN] == ww + 2).all()
    # no PDPC on negative slopes; hor/ver PDPC only on the pure directions
    assert (ang[neg, tb.D_PDPC] == tb.PDPC_NONE).all()
    assert ((ang[:, tb.D_PDPC] == tb.PDPC_HV) == (ang[:, tb.D_SD] == 0)).all()
    assert (ang[:, tb.D_PLIM] <= ww).all()

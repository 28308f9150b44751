"""Scaling lists: default/custom quant matrices + cqm file parser.

Behavioral parity with the reference (scalinglist.c):
- default 4x4 (flat 16) and 8x8 intra/inter base matrices
  (scalinglist.c:60-89 g_quant_default_4x4 / g_quant_{intra,inter}_default_8x8)
- per-TU matrices derived by nearest-neighbour upsampling of the base
  with a DC override for 16x16+ (uvg_scalinglist_set:400-416,
  uvg_scalinglist_process_enc:344-372)
- quant coefficient  = (quant_scale << 4) / m   (quant-generic.c:74-94)
- dequant coefficient = inv_quant_scale * m, shift += 4
  (uvg_dequant_generic, quant-generic.c:639-660)
- cqm file format: HM/uvg266 matrix names (INTRA8X8_LUMA, ...,
  INTRA16X16_LUMA_DC) followed by the coefficient list. The reference's
  parser is stubbed out (uvg_scalinglist_parse:168 "ToDo: fix"); this
  one actually works, accepting the documented format.

Unlike the reference - which applies the matrices but always writes
sps scaling_list_enabled_flag = 0 (encoder_state-bitstream.c:691),
producing streams a conformant decoder would drift on - this encoder
signals the matrices in a scaling-list APS (hls.scaling_list_syntax)
that the decoder oracle parses and applies.
"""
from __future__ import annotations

import numpy as np

# list ids within a size class; chroma lists index intra/inter x U/V
INTRA_Y, INTRA_U, INTRA_V, INTER_Y, INTER_U, INTER_V = range(6)

# scalinglist.c:60 g_quant_default_4x4
DEFAULT_4X4 = np.full((4, 4), 16, dtype=np.int32)

# scalinglist.c:67 g_quant_intra_default_8x8
DEFAULT_8X8_INTRA = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], dtype=np.int32).reshape(8, 8)

# scalinglist.c:79 g_quant_inter_default_8x8
DEFAULT_8X8_INTER = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], dtype=np.int32).reshape(8, 8)

# cqm file section names, sizes 4x4 / 8x8 / 16x16 / 32x32
# (scalinglist.c:172-217 matrix_type / matrix_type_dc)
_NAMES = [
    ["INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
     "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV"],
    ["INTRA8X8_LUMA", "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV",
     "INTER8X8_LUMA", "INTER8X8_CHROMAU", "INTER8X8_CHROMAV"],
    ["INTRA16X16_LUMA", "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV",
     "INTER16X16_LUMA", "INTER16X16_CHROMAU", "INTER16X16_CHROMAV"],
    ["INTRA32X32_LUMA", "INTER32X32_LUMA"],
]
_DC_NAMES = {
    (2, 0): "INTRA16X16_LUMA_DC", (2, 1): "INTRA16X16_CHROMAU_DC",
    (2, 2): "INTRA16X16_CHROMAV_DC", (2, 3): "INTER16X16_LUMA_DC",
    (2, 4): "INTER16X16_CHROMAU_DC", (2, 5): "INTER16X16_CHROMAV_DC",
    (3, 0): "INTRA32X32_LUMA_DC", (3, 1): "INTER32X32_LUMA_DC",
}


class ScalingLists:
    """Base matrices per (size_id, list_id) with DC overrides.

    size_id: 0 = 4x4 (4x4 base), 1 = 8x8, 2 = 16x16, 3 = 32x32
    (8x8 base + DC for 2, 3). list_id: INTRA_Y..INTER_V; 32x32 stores
    luma only (slot 0 intra / 1 inter), chroma falls back to 16x16.
    """

    def __init__(self):
        self.base: dict[tuple[int, int], np.ndarray] = {}
        self.dc: dict[tuple[int, int], int] = {}
        self._cache: dict[tuple, np.ndarray] = {}

    @classmethod
    def default(cls) -> "ScalingLists":
        sl = cls()
        for lst in range(6):
            sl.base[(0, lst)] = DEFAULT_4X4.copy()
            for sid in (1, 2, 3):
                d = DEFAULT_8X8_INTRA if lst < 3 else DEFAULT_8X8_INTER
                sl.base[(sid, lst)] = d.copy()
            sl.dc[(2, lst)] = 16
        sl.dc[(3, INTRA_Y)] = 16
        sl.dc[(3, INTER_Y)] = 16
        return sl

    @classmethod
    def from_file(cls, path: str) -> "ScalingLists":
        """Parse an HM/uvg266-format cqm file (values 1..255)."""
        sl = cls.default()
        with open(path) as f:
            text = f.read()
        # strip comments, tokenize sections by name
        lines = [ln.split("#")[0] for ln in text.splitlines()]
        toks = " ".join(lines).replace(",", " ").split()
        i = 0
        sections: dict[str, list[int]] = {}
        cur = None
        while i < len(toks):
            t = toks[i]
            if any(c.isalpha() for c in t):
                cur = t
                sections[cur] = []
            elif cur is not None:
                v = int(t)
                if not 1 <= v <= 255:
                    raise ValueError(
                        f"scaling list value {v} out of range [1,255]")
                sections[cur].append(v)
            i += 1
        for sid, names in enumerate(_NAMES):
            n = 4 if sid == 0 else 8
            for slot, name in enumerate(names):
                vals = sections.get(name)
                if vals is None:
                    continue
                if len(vals) < n * n:
                    raise ValueError(f"{name}: expected {n * n} values")
                sl.base[(sid, slot)] = np.array(
                    vals[:n * n], dtype=np.int32).reshape(n, n)
        for key, name in _DC_NAMES.items():
            vals = sections.get(name)
            if vals:
                sl.dc[key] = int(vals[0])
        return sl

    def _slot(self, size_id: int, list_id: int) -> tuple[int, int]:
        if size_id >= 3:
            # only luma at 32x32; chroma reuses the 16x16 class
            if list_id in (INTRA_Y, INTER_Y):
                return (3, 0 if list_id == INTRA_Y else 1)
            return (2, list_id)
        return (size_id, list_id)

    def matrix(self, w: int, h: int, list_id: int) -> np.ndarray:
        """Per-TU (h, w) quant matrix by nearest-neighbour upsampling of
        the base class of max(w, h), DC override for 16+."""
        key = (w, h, list_id)
        m = self._cache.get(key)
        if m is not None:
            return m
        size = max(w, h)
        size_id = {4: 0, 8: 1, 16: 2, 32: 3, 64: 3}[size]
        sid, slot = self._slot(size_id, list_id)
        base = self.base[(sid, slot)]
        n = base.shape[0]
        ys = (np.arange(h) * n) // h
        xs = (np.arange(w) * n) // w
        m = base[np.ix_(ys, xs)].astype(np.int32).copy()
        if size >= 16:
            dkey = (3, 0 if list_id == INTRA_Y else 1) \
                if size_id >= 3 and list_id in (INTRA_Y, INTER_Y) \
                else (2, list_id)
            m[0, 0] = self.dc.get(dkey, 16)
        self._cache[key] = m
        return m


def quant_matrix(sl: ScalingLists | None, w: int, h: int, comp: int,
                 cu_is_intra: bool) -> np.ndarray | None:
    """Matrix for a TU, or None when scaling lists are off."""
    if sl is None:
        return None
    return sl.matrix(w, h, (0 if cu_is_intra else 3) + comp)

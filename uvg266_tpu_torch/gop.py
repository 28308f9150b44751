"""GOP structure configuration.

Mirrors the reference's low-delay GOP generator
(uvg266 src/cfg.c uvg_config_process_lp_gop:1641-1729) and the
hardcoded random-access B-pyramid tables (src/gop.h: ra8:94, ra16:201 —
transcribed as needed by the inter path).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class GopEntry:
    poc_offset: int
    layer: int
    qp_offset: int
    qp_factor: float
    qp_model_offset: float = 0.0
    qp_model_scale: float = 0.0
    is_ref: bool = True
    ref_neg: tuple = ()
    ref_pos: tuple = ()


def process_lp_gop(gop_len: int, d: int, t: int, ref_frames: int) -> list[GopEntry]:
    """Generate a low-delay-P GOP 'lp-g<g>d<d>t<t>' structure."""
    g_count = gop_len
    depth_modulos = [0] * 8
    for dd in range(d):
        depth_modulos[d - 1 - dd] = 1 << dd
    depth_modulos[0] = g_count

    entries: list[GopEntry] = []
    for g in range(1, g_count + 1):
        gop_layer = 1
        while gop_layer < d and (g % depth_modulos[gop_layer - 1]):
            gop_layer += 1
        entries.append(GopEntry(
            poc_offset=g, layer=gop_layer, qp_offset=gop_layer,
            qp_factor=0.4624, is_ref=False, ref_neg=(), ref_pos=()))

    for idx, e in enumerate(entries):
        g = e.poc_offset
        ref_neg = [0] * ref_frames
        if t > 1:
            if g % t == 0:
                ref_neg[0] = t
            else:
                r = g - 1
                while r > 0 and entries[r].layer >= e.layer:
                    r -= 1
                if entries[r].layer < e.layer:
                    ref_neg[0] = g - entries[r].poc_offset
                    entries[r].is_ref = True
                else:
                    ref_neg[0] = g % g_count
        else:
            ref_neg[0] = 1
            if g >= 2:
                entries[g - 2].is_ref = True
        keyframe = g
        for i in range(1, ref_frames):
            while keyframe == ref_neg[i - 1]:
                keyframe += g_count
            ref_neg[i] = keyframe
        e.ref_neg = tuple(ref_neg)

    for e in entries:
        if not e.is_ref:
            e.qp_factor = 0.68 * 1.31
    entries[g_count - 1].is_ref = True
    entries[g_count - 1].qp_factor = 0.578
    return entries


# random-access B-pyramid GOP8 (transcription of uvg_gop_ra8, gop.h:94):
# entries in coding order; ref_neg/ref_pos are POC deltas
RA8 = [
    GopEntry(poc_offset=8, layer=1, qp_offset=0, qp_factor=1.0, is_ref=True,
             qp_model_offset=0.0, qp_model_scale=0.0,
             ref_neg=(8, 12, 16), ref_pos=()),
    GopEntry(poc_offset=4, layer=2, qp_offset=3, qp_factor=1.0, is_ref=True,
             qp_model_offset=-6.25, qp_model_scale=0.25,
             ref_neg=(4, 8), ref_pos=(4,)),
    GopEntry(poc_offset=2, layer=3, qp_offset=4, qp_factor=1.0, is_ref=True,
             qp_model_offset=-6.25, qp_model_scale=0.25,
             ref_neg=(2, 6), ref_pos=(2, 6)),
    GopEntry(poc_offset=1, layer=4, qp_offset=8, qp_factor=1.0, is_ref=False,
             qp_model_offset=-7.0, qp_model_scale=0.245,
             ref_neg=(1,), ref_pos=(1, 3, 7)),
    GopEntry(poc_offset=3, layer=4, qp_offset=8, qp_factor=1.0, is_ref=False,
             qp_model_offset=-7.0, qp_model_scale=0.245,
             ref_neg=(1, 3), ref_pos=(1, 5)),
    GopEntry(poc_offset=6, layer=3, qp_offset=4, qp_factor=1.0, is_ref=True,
             qp_model_offset=-6.25, qp_model_scale=0.25,
             ref_neg=(2, 6), ref_pos=(2,)),
    GopEntry(poc_offset=5, layer=4, qp_offset=8, qp_factor=1.0, is_ref=False,
             qp_model_offset=-7.0, qp_model_scale=0.245,
             ref_neg=(1, 5), ref_pos=(1, 3)),
    GopEntry(poc_offset=7, layer=4, qp_offset=8, qp_factor=1.0, is_ref=False,
             qp_model_offset=-7.0, qp_model_scale=0.245,
             ref_neg=(1, 3, 7), ref_pos=(1,)),
]


# random-access B-pyramid GOP16 (uvg_gop_ra16, gop.h:201); qp_model per
# layer: L1 (0,0), L2 (-4.8848,.2061), L3 (-5.7476,.2286),
# L4 (-5.90,.2333), L5 (-7.1444,.3)
_RA16_MODEL = {1: (0.0, 0.0), 2: (-4.8848, 0.2061), 3: (-5.7476, 0.2286),
               4: (-5.90, 0.2333), 5: (-7.1444, 0.3)}


def _ra16(poc, layer, qp_off, is_ref, ref_neg, ref_pos):
    off, scale = _RA16_MODEL[layer]
    return GopEntry(poc, layer, qp_off, 1.0, qp_model_offset=off,
                    qp_model_scale=scale, is_ref=is_ref,
                    ref_neg=ref_neg, ref_pos=ref_pos)


RA16 = [
    _ra16(16, 1, 1, True, (16, 24, 32), ()),
    _ra16(8, 2, 1, True, (8, 16), (8,)),
    _ra16(4, 3, 4, True, (4, 12), (4, 12)),
    _ra16(2, 4, 5, True, (2, 10), (2, 6, 14)),
    _ra16(1, 5, 6, False, (1,), (1, 3, 7, 15)),
    _ra16(3, 5, 6, False, (1, 3), (1, 5, 13)),
    _ra16(6, 4, 5, True, (2, 6), (2, 10)),
    _ra16(5, 5, 6, False, (1, 5), (1, 3, 11)),
    _ra16(7, 5, 6, False, (1, 3, 7), (1, 9)),
    _ra16(12, 3, 4, True, (4, 12), (4,)),
    _ra16(10, 4, 5, True, (2, 10), (2, 6)),
    _ra16(9, 5, 6, False, (1, 9), (1, 3, 7)),
    _ra16(11, 5, 6, False, (1, 3, 11), (1, 5)),
    _ra16(14, 4, 5, True, (2, 6, 14), (2,)),
    _ra16(13, 5, 6, False, (1, 5, 13), (1, 3)),
    _ra16(15, 5, 6, False, (1, 3, 7, 15), (1,)),
]


# hand-tuned low-delay GOP4 (uvg_gop_lowdelay4, gop.h:38) — used instead
# of the generated lp gop when gop_len==4 and ref_frames==4
# (encoder.c:222-224)
LOWDELAY4 = [
    GopEntry(poc_offset=1, layer=1, qp_offset=5, qp_factor=1.0,
             qp_model_offset=-6.5, qp_model_scale=0.2590, is_ref=True,
             ref_neg=(1, 5, 9, 13), ref_pos=()),
    GopEntry(poc_offset=2, layer=1, qp_offset=4, qp_factor=1.0,
             qp_model_offset=-6.5, qp_model_scale=0.2590, is_ref=True,
             ref_neg=(1, 2, 6, 10), ref_pos=()),
    GopEntry(poc_offset=3, layer=1, qp_offset=5, qp_factor=1.0,
             qp_model_offset=-6.5, qp_model_scale=0.2590, is_ref=True,
             ref_neg=(1, 3, 7, 11), ref_pos=()),
    GopEntry(poc_offset=4, layer=1, qp_offset=1, qp_factor=1.0,
             qp_model_offset=0.0, qp_model_scale=0.0, is_ref=True,
             ref_neg=(1, 4, 8, 12), ref_pos=()),
]


def get_gop_config(cfg) -> list[GopEntry]:
    if cfg.gop_len == 0:
        return []
    if cfg.gop_lowdelay:
        if cfg.gop_len == 4 and cfg.ref_frames == 4:
            return LOWDELAY4
        return process_lp_gop(cfg.gop_len, cfg.gop_lp_d, cfg.gop_lp_t, cfg.ref_frames)
    if cfg.gop_len == 8:
        return RA8
    if cfg.gop_len == 16:
        return RA16
    raise NotImplementedError(f"unsupported RA GOP length {cfg.gop_len}")


def effective_intra_qp_offset(cfg) -> int:
    """I-slice QP offset in GOP configs (encoder.c:230-240): auto =
    max(1 - ceil_log2(gop_len), -3); forced 0 for all-intra."""
    if cfg.intra_period == 1 or cfg.gop_len <= 1:
        return 0
    if cfg.intra_qp_offset_auto:
        return max(-math.ceil(math.log2(cfg.gop_len)) + 1, -3)
    return cfg.intra_qp_offset


def frame_qp(cfg, entry: GopEntry | None) -> int:
    """Fixed-QP per-frame QP (rate_control.c
    uvg_set_picture_lambda_and_qp:1050-1066): non-I frames add the GOP
    qp_offset plus the clipped linear qp model; I frames add the intra
    QP offset."""
    if entry is None:  # I slice
        return min(max(cfg.qp + effective_intra_qp_offset(cfg), 0), 51)
    qp = float(cfg.qp + entry.qp_offset)
    qp += min(max(qp * entry.qp_model_scale + entry.qp_model_offset, 0.0),
              3.0)
    return min(max(int(qp + 0.5), 0), 51)

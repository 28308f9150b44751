"""SAO (sample adaptive offset): per-CTU search, application, syntax.

Behavioral parity with the reference:
- application: uvg_sao_reconstruct + sao_reconstruct_color
  (uvg266 src/sao.c:302, strategies/generic/sao_shared_generics.h)
  including picture-border trimming for edge offsets and the band offset
  LUT (uvg_calc_sao_offset_array, sao.c:180)
- edge category: sao_calc_eo_cat (eo_idx -> category [1,2,0,3,4])
- syntax: encode_sao / encode_sao_color / merge flags
  (encoderstate.c:523-606); EO offset signs are inferred (cat1/2 >= 0,
  cat3/4 <= 0), BO signs + 5-bit band position signaled
- search: per-class (count, sum) statistics -> RD offset choice
  (sao.c:491-671 structure; the offset decision is an encoder choice)

SAO runs after deblocking on the whole frame; the input for every sample
is the pre-SAO frame (spec semantics).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..consts import LCU_WIDTH

SAO_NONE, SAO_BAND, SAO_EDGE = 0, 1, 2
EDGE_OFFSETS = [((-1, 0), (1, 0)), ((0, -1), (0, 1)),
                ((-1, -1), (1, 1)), ((1, -1), (-1, 1))]
EO_IDX_TO_CAT = np.array([1, 2, 0, 3, 4], dtype=np.int32)
def abs_offset_max(bitdepth: int = 8) -> int:
    return (1 << (min(bitdepth, 10) - 5)) - 1


ABS_OFFSET_MAX = 7     # 8-bit value kept for the syntax default


@dataclass
class SaoInfo:
    type: int = SAO_NONE
    eo_class: int = 0
    band_position: list = field(default_factory=lambda: [0, 0])
    offsets: list = field(default_factory=lambda: [0] * 10)
    merge_left: bool = False
    merge_up: bool = False


def _eo_cat_map(plane: np.ndarray, eo_class: int) -> np.ndarray:
    """Edge category per sample (0 at the 1-px border for this class)."""
    (ax, ay), (bx, by) = EDGE_OFFSETS[eo_class]
    h, w = plane.shape
    cat = np.zeros((h, w), dtype=np.int32)
    y0, y1 = max(0, -ay, -by), h - max(0, ay, by)
    x0, x1 = max(0, -ax, -bx), w - max(0, ax, bx)
    c = plane[y0:y1, x0:x1].astype(np.int32)
    a = plane[y0 + ay:y1 + ay, x0 + ax:x1 + ax].astype(np.int32)
    b = plane[y0 + by:y1 + by, x0 + bx:x1 + bx].astype(np.int32)
    eo_idx = 2 + np.sign(c - a) + np.sign(c - b)
    cat[y0:y1, x0:x1] = EO_IDX_TO_CAT[eo_idx]
    return cat


def _best_offset(count: int, ssum: int, lam: float, sign: int,
                 omax: int = 7) -> tuple[int, float]:
    """Offset minimizing n*o^2 - 2*o*s + lambda*rate; sign: +1, -1, or 0
    (free, band)."""
    best_o, best_c = 0, 0.0
    if count == 0:
        return 0, 0.0
    start = int(round(ssum / count))
    if sign > 0:
        start = max(0, start)
    elif sign < 0:
        start = min(0, start)
    start = max(-omax, min(omax, start))
    o = start
    while o != 0:
        cost = count * o * o - 2 * o * ssum + lam * (abs(o) + 1 + (1 if sign == 0 else 0))
        if cost < best_c:
            best_o, best_c = o, cost
        o += 1 if o < 0 else -1
    return best_o, best_c


def _best_offsets_vec(cnt, sm, lam: float, signs, omax: int,
                      extra_bit: float):
    """Vectorized _best_offset over the trailing axis.

    cnt, sm: [..., K] counts / diff-sums; signs: per-K sign constraint
    (+1 positive-only, -1 negative-only, 0 free). Returns (off, cost)
    arrays [..., K]; offset 0 has cost 0 (the no-offset baseline, matching
    the scalar loop's semantics)."""
    o = np.arange(-omax, omax + 1, dtype=np.int64)          # [O]
    cost = (cnt[..., None] * (o * o)[None]
            - 2.0 * sm[..., None] * o[None]
            + lam * (np.abs(o) + 1 + extra_bit)[None]).astype(np.float64)
    cost[..., omax] = 0.0                                    # offset 0
    signs = np.asarray(signs)
    bad = (signs[..., None] * o[None]) < 0
    cost = np.where(bad, np.inf, cost)
    k = np.argmin(cost, axis=-1)
    return o[k], np.take_along_axis(cost, k[..., None], -1)[..., 0]


def _frame_sao_stats(src, rec, wl, hl, lcu, bitdepth):
    """Whole-frame per-CTU SAO statistics via single-pass bincounts:
    edge (cnt,sum)[4, n_ctu, 5] and band (cnt,sum)[n_ctu, 32]."""
    H, W = rec.shape
    n_ctu = wl * hl
    try:
        from ..native import sao_stats_native
        e_cnt, e_sum, b_cnt, b_sum = sao_stats_native(
            src, rec, lcu, wl, n_ctu, bitdepth)
        return (e_cnt, e_sum.astype(np.float64), b_cnt,
                b_sum.astype(np.float64))
    except Exception:
        pass
    cy = np.arange(H) // lcu
    cx = np.arange(W) // lcu
    ctu_idx = (cy[:, None] * wl + cx[None, :]).astype(np.int64)
    diff = (src.astype(np.int64) - rec.astype(np.int64)).ravel()
    e_cnt = np.empty((4, n_ctu, 5), np.int64)
    e_sum = np.empty((4, n_ctu, 5), np.float64)
    for ec in range(4):
        key = (ctu_idx * 5 + _eo_cat_map(rec, ec)).ravel()
        e_cnt[ec] = np.bincount(key, minlength=n_ctu * 5).reshape(n_ctu, 5)
        e_sum[ec] = np.bincount(key, weights=diff,
                                minlength=n_ctu * 5).reshape(n_ctu, 5)
    key = (ctu_idx * 32 + (rec >> (bitdepth - 5))).ravel()
    b_cnt = np.bincount(key, minlength=n_ctu * 32).reshape(n_ctu, 32)
    b_sum = np.bincount(key, weights=diff,
                        minlength=n_ctu * 32).reshape(n_ctu, 32)
    return e_cnt, e_sum, b_cnt, b_sum


def sao_search_frame(src_planes, rec_planes, ctrl, lam: float,
                     bitdepth: int = 8):
    """Per-CTU SAO decision for all planes.

    Returns (sao_luma list, sao_chroma list) in CTU raster order."""
    if not getattr(ctrl, "tiles_enable", False):
        # whole-frame C++ decision (sao.cpp rc_sao_search), bit-exact
        # with the python loop below (tests/test_sao_native.py)
        try:
            from ..native import sao_search_native
            return sao_search_native(src_planes, rec_planes, ctrl, lam,
                                     bitdepth)
        except ImportError:
            pass
    wl, hl = ctrl.width_in_lcu, ctrl.height_in_lcu
    n_ctu = wl * hl
    sao_luma = []
    sao_chroma = []
    has_chroma = rec_planes.u is not None
    omax = abs_offset_max(bitdepth)

    # whole-frame stats + vectorized per-category best offsets per plane
    planes = [("y", src_planes.y, rec_planes.y, 0)]
    if has_chroma:
        planes += [("u", src_planes.u, rec_planes.u, 1),
                   ("v", src_planes.v, rec_planes.v, 1)]
    stats = {}
    edge_best = {}
    band_best = {}
    edge_signs = np.array([0, 1, 1, -1, -1])
    for name, sp, rp, sh in planes:
        e_cnt, e_sum, b_cnt, b_sum = _frame_sao_stats(
            sp, rp, wl, hl, LCU_WIDTH >> sh, bitdepth)
        stats[name] = (e_cnt, e_sum, b_cnt, b_sum)
        # edge: offsets/costs for cats 1..4 of every (ec, ctu)
        off, cost = _best_offsets_vec(e_cnt, e_sum, lam,
                                      edge_signs[None, None, :], omax, 0.0)
        off[..., 0] = 0
        cost[..., 0] = 0.0
        edge_best[name] = (off, cost[..., 1:].sum(-1))   # [4,n,5], [4,n]
        # band: per-band best offsets, then best 4-band window
        boff, bcost = _best_offsets_vec(b_cnt, b_sum, lam,
                                        np.zeros(32, np.int64)[None], omax,
                                        1.0)
        win = np.stack([bcost[:, k:k + 29] for k in range(4)], -1).sum(-1)
        bp = np.argmin(win, axis=1)                       # [n]
        band_best[name] = (bp, boff, np.take_along_axis(win, bp[:, None],
                                                        1)[:, 0])

    def plane_stats(name, idx):
        e_cnt, e_sum, b_cnt, b_sum = stats[name]
        out = {("edge", ec): (e_cnt[ec, idx], e_sum[ec, idx])
               for ec in range(4)}
        out["band"] = (b_cnt[idx], b_sum[idx])
        return out

    def eval_edge(name, idx, ec):
        off, cost = edge_best[name]
        return list(off[ec, idx]), float(cost[ec, idx])

    def eval_band(name, idx):
        bp, boff, wcost = band_best[name]
        b = int(bp[idx])
        return b, [int(boff[idx, b + k]) for k in range(4)],             float(wcost[idx])

    def dist_with(stats, sao, plane_key, off_base):
        """Delta-distortion of applying given sao params to this region."""
        d = 0.0
        if sao.type == SAO_EDGE:
            cnt, sm = stats[("edge", sao.eo_class)]
            for cat in range(1, 5):
                o = sao.offsets[off_base + cat]
                d += cnt[cat] * o * o - 2 * o * sm[cat]
        elif sao.type == SAO_BAND:
            cnt, sm = stats["band"]
            bp = sao.band_position[0 if off_base == 0 else 1]
            for k in range(4):
                o = sao.offsets[off_base + 1 + k]
                b = bp + k
                if b < 32:
                    d += cnt[b] * o * o - 2 * o * sm[b]
        return d

    for cty in range(hl):
        for ctx in range(wl):
            idx = cty * wl + ctx
            st_y = plane_stats("y", idx)
            if has_chroma:
                st_u = plane_stats("u", idx)
                st_v = plane_stats("v", idx)

            # ---- luma decision ----
            best = SaoInfo()
            best_cost = 0.0
            for ec in range(4):
                offs, cost = eval_edge("y", idx, ec)
                cost += lam * (3 + 2)
                if cost < best_cost:
                    best = SaoInfo(type=SAO_EDGE, eo_class=ec,
                                   offsets=offs + [0] * 5)
                    best_cost = cost
            bp, offs, cost = eval_band("y", idx)
            cost += lam * (3 + 5)
            if cost < best_cost:
                best = SaoInfo(type=SAO_BAND, band_position=[bp, 0],
                               offsets=[0] + offs + [0] * 5)
                best_cost = cost

            # ---- chroma joint decision (shared type + eo class) ----
            cbest = SaoInfo()
            if has_chroma:
                cbest_cost = 0.0
                for ec in range(4):
                    offs_u, cost_u = eval_edge("u", idx, ec)
                    offs_v, cost_v = eval_edge("v", idx, ec)
                    cost = cost_u + cost_v + lam * (3 + 2)
                    if cost < cbest_cost:
                        off = [0] * 10
                        off[1:5] = offs_u[1:5]
                        off[6:10] = offs_v[1:5]
                        cbest = SaoInfo(type=SAO_EDGE, eo_class=ec,
                                        offsets=off)
                        cbest_cost = cost
                bp_u, offs_u, cost_u = eval_band("u", idx)
                bp_v, offs_v, cost_v = eval_band("v", idx)
                cost = cost_u + cost_v + lam * (3 + 10)
                if cost < cbest_cost:
                    off = [0] * 10
                    off[1:5] = offs_u
                    off[6:10] = offs_v
                    cbest = SaoInfo(type=SAO_BAND,
                                    band_position=[bp_u, bp_v], offsets=off)
                    cbest_cost = cost

            # ---- merge decisions (copy full left/up params) ----
            def merged_cost(src_l, src_c):
                d = dist_with(st_y, src_l, "y", 0)
                if has_chroma:
                    d += dist_with(st_u, src_c, "u", 0)
                    d += dist_with(st_v, src_c, "v", 5)
                return d + lam * 1.0

            cur_cost = best_cost + (cbest_cost if has_chroma else 0.0) \
                + lam * 2.0
            choice = (best, cbest, False, False)
            # SAO merge candidates must lie in the same tile (availability
            # clause of the neighbor derivation)
            same_tile_l = same_tile_u = True
            if getattr(ctrl, "tiles_enable", False):
                tid = ctrl.tile_index_of_ctu(ctx, cty)
                same_tile_l = ctx > 0 and \
                    ctrl.tile_index_of_ctu(ctx - 1, cty) == tid
                same_tile_u = cty > 0 and \
                    ctrl.tile_index_of_ctu(ctx, cty - 1) == tid
            if ctx > 0 and same_tile_l:
                ml = sao_luma[cty * wl + ctx - 1]
                mc = sao_chroma[cty * wl + ctx - 1] if has_chroma else None
                c = merged_cost(ml, mc)
                if c < cur_cost:
                    cur_cost = c
                    choice = (ml, mc, True, False)
            if cty > 0 and same_tile_u:
                ul = sao_luma[(cty - 1) * wl + ctx]
                uc = sao_chroma[(cty - 1) * wl + ctx] if has_chroma else None
                c = merged_cost(ul, uc)
                if c < cur_cost:
                    cur_cost = c
                    choice = (ul, uc, False, True)

            sel_l, sel_c, m_left, m_up = choice
            out_l = SaoInfo(type=sel_l.type, eo_class=sel_l.eo_class,
                            band_position=list(sel_l.band_position),
                            offsets=list(sel_l.offsets),
                            merge_left=m_left, merge_up=m_up)
            sao_luma.append(out_l)
            if has_chroma:
                sao_chroma.append(SaoInfo(
                    type=sel_c.type, eo_class=sel_c.eo_class,
                    band_position=list(sel_c.band_position),
                    offsets=list(sel_c.offsets),
                    merge_left=m_left, merge_up=m_up))
            else:
                sao_chroma.append(SaoInfo())
    return sao_luma, sao_chroma


def sao_apply_frame(rec_planes, sao_luma, sao_chroma, ctrl,
                    bitdepth: int = 8, tile_boundaries=None) -> None:
    """Apply SAO in place (input = copy of pre-SAO planes).

    tile_boundaries: optional (xs, ys) interior tile boundary coordinates
    in LUMA pixels — with pps_loop_filter_across_tiles disabled, edge
    offsets never read across them (treated like the picture border).
    """
    wl = ctrl.width_in_lcu
    has_chroma = rec_planes.u is not None
    tbx = tuple((tile_boundaries or ((), ()))[0])
    tby = tuple((tile_boundaries or ((), ()))[1])
    tb_l = (tbx, tby) if (tbx or tby) else None
    tb_c = (tuple(b >> 1 for b in tbx),
            tuple(b >> 1 for b in tby)) if tb_l else None
    try:
        from ..native import sao_apply_native
        n = len(sao_luma)

        def arrays(infos, off_base, bp_idx):
            t = np.array([s_.type for s_ in infos], dtype=np.int32)
            ec = np.array([s_.eo_class for s_ in infos], dtype=np.int32)
            bp = np.array([s_.band_position[bp_idx] for s_ in infos],
                          dtype=np.int32)
            off = np.array([s_.offsets[off_base:off_base + 5]
                            for s_ in infos], dtype=np.int32)
            return t, ec, bp, off

        sao_apply_native(rec_planes.y, LCU_WIDTH, wl, bitdepth,
                         *arrays(sao_luma, 0, 0), tile_boundaries=tb_l)
        if has_chroma:
            sao_apply_native(rec_planes.u, LCU_WIDTH >> 1, wl, bitdepth,
                             *arrays(sao_chroma, 0, 0), tile_boundaries=tb_c)
            sao_apply_native(rec_planes.v, LCU_WIDTH >> 1, wl, bitdepth,
                             *arrays(sao_chroma, 5, 1), tile_boundaries=tb_c)
        return
    except ImportError:
        pass
    pre = {"y": rec_planes.y.copy()}
    if has_chroma:
        pre["u"] = rec_planes.u.copy()
        pre["v"] = rec_planes.v.copy()
    max_pix = (1 << bitdepth) - 1

    def apply_one(name, out, sao, off_base, bp_idx, x0, y0, x1, y1):
        if sao.type == SAO_NONE:
            return
        tb_here = tb_l if name == "y" else tb_c
        p = pre[name]
        if sao.type == SAO_BAND:
            bp = sao.band_position[bp_idx]
            region = p[y0:y1, x0:x1].astype(np.int32)
            band = region >> (bitdepth - 5)
            k = band - bp
            off = np.zeros_like(region)
            for i in range(4):
                off[k == i] = sao.offsets[off_base + 1 + i]
            out[y0:y1, x0:x1] = np.clip(region + off, 0, max_pix)
        else:
            (ax, ay), (bx, by) = EDGE_OFFSETS[sao.eo_class]
            h, w = p.shape
            yy0, yy1 = max(y0, -min(ay, by, 0)), min(y1, h - max(ay, by, 0))
            xx0, xx1 = max(x0, -min(ax, bx, 0)), min(x1, w - max(ax, bx, 0))
            if yy0 >= yy1 or xx0 >= xx1:
                return
            c = p[yy0:yy1, xx0:xx1].astype(np.int32)
            a = p[yy0 + ay:yy1 + ay, xx0 + ax:xx1 + ax].astype(np.int32)
            b = p[yy0 + by:yy1 + by, xx0 + bx:xx1 + bx].astype(np.int32)
            cat = EO_IDX_TO_CAT[2 + np.sign(c - a) + np.sign(c - b)]
            off = np.zeros_like(c)
            for i in range(1, 5):
                off[cat == i] = sao.offsets[off_base + i]
            if tb_here is not None:
                hx, hy = tb_here
                uses_x = sao.eo_class != 1
                uses_y = sao.eo_class != 0
                if uses_x:
                    for bx_ in hx:
                        for col in (bx_ - 1, bx_):
                            if xx0 <= col < xx1:
                                off[:, col - xx0] = 0
                if uses_y:
                    for by_ in hy:
                        for row in (by_ - 1, by_):
                            if yy0 <= row < yy1:
                                off[row - yy0, :] = 0
            out[yy0:yy1, xx0:xx1] = np.clip(c + off, 0, max_pix)

    for i, sao in enumerate(sao_luma):
        cty, ctx = divmod(i, wl)
        x0, y0 = ctx * LCU_WIDTH, cty * LCU_WIDTH
        x1 = min(x0 + LCU_WIDTH, ctrl.in_width)
        y1 = min(y0 + LCU_WIDTH, ctrl.in_height)
        apply_one("y", rec_planes.y, sao, 0, 0, x0, y0, x1, y1)
        if has_chroma:
            sc = sao_chroma[i]
            apply_one("u", rec_planes.u, sc, 0, 0,
                      x0 >> 1, y0 >> 1, x1 >> 1, y1 >> 1)
            apply_one("v", rec_planes.v, sc, 5, 1,
                      x0 >> 1, y0 >> 1, x1 >> 1, y1 >> 1)


# --- syntax (encoderstate.c:523-606) ---------------------------------------

def _encode_sao_color(cabac, OFF, sao: SaoInfo, color: int,
                      bitdepth: int = 8) -> None:
    omax = abs_offset_max(bitdepth)
    off_base = 5 if color == 2 else 0
    if color != 2:
        cabac.encode_bin(OFF["sao_type_idx"], 1 if sao.type != SAO_NONE else 0)
        if sao.type == SAO_BAND:
            cabac.encode_bin_ep(0)
        elif sao.type == SAO_EDGE:
            cabac.encode_bin_ep(1)
    if sao.type == SAO_NONE:
        return
    for cat in range(1, 5):
        cabac.write_unary_max_symbol_ep(abs(sao.offsets[off_base + cat]),
                                        omax)
    if sao.type == SAO_BAND:
        for cat in range(1, 5):
            if sao.offsets[off_base + cat] != 0:
                cabac.encode_bin_ep(1 if sao.offsets[off_base + cat] < 0 else 0)
        cabac.encode_bins_ep(sao.band_position[1 if color == 2 else 0], 5)
    elif color != 2:
        cabac.encode_bins_ep(sao.eo_class, 2)


def encode_sao_ctu(cabac, OFF, x_lcu, y_lcu, sao_l: SaoInfo,
                   sao_c: SaoInfo | None, bitdepth: int = 8) -> None:
    if x_lcu > 0:
        cabac.encode_bin(OFF["sao_merge_flag"], 1 if sao_l.merge_left else 0)
    if y_lcu > 0 and not sao_l.merge_left:
        cabac.encode_bin(OFF["sao_merge_flag"], 1 if sao_l.merge_up else 0)
    if not sao_l.merge_left and not sao_l.merge_up:
        _encode_sao_color(cabac, OFF, sao_l, 0, bitdepth)
        if sao_c is not None:
            _encode_sao_color(cabac, OFF, sao_c, 1, bitdepth)
            _encode_sao_color(cabac, OFF, sao_c, 2, bitdepth)


def _decode_sao_color(dec, OFF, sao: SaoInfo, color: int,
                      bitdepth: int = 8) -> None:
    omax = abs_offset_max(bitdepth)
    off_base = 5 if color == 2 else 0
    if color != 2:
        if dec.decode_bin(OFF["sao_type_idx"]):
            sao.type = SAO_EDGE if dec.decode_bin_ep() else SAO_BAND
        else:
            sao.type = SAO_NONE
    if sao.type == SAO_NONE:
        return
    mags = [dec.decode_unary_max_symbol_ep(omax)
            for _ in range(4)]
    if sao.type == SAO_BAND:
        for k in range(4):
            if mags[k] and dec.decode_bin_ep():
                mags[k] = -mags[k]
        for k in range(4):
            sao.offsets[off_base + 1 + k] = mags[k]
        sao.band_position[1 if color == 2 else 0] = dec.decode_bins_ep(5)
    else:
        # EO signs inferred: cat1/2 positive, cat3/4 negative
        sao.offsets[off_base + 1] = mags[0]
        sao.offsets[off_base + 2] = mags[1]
        sao.offsets[off_base + 3] = -mags[2]
        sao.offsets[off_base + 4] = -mags[3]
        if color != 2:
            sao.eo_class = dec.decode_bins_ep(2)


def decode_sao_ctu(dec, OFF, x_lcu, y_lcu, wl, sao_luma, sao_chroma,
                   has_chroma, bitdepth: int = 8,
                   x_rel: int | None = None,
                   y_rel: int | None = None) -> None:
    """Parse one CTU's SAO params into the raster-indexed lists.

    (x_rel, y_rel): tile-relative CTU coordinates governing the merge
    syntax conditions (a tile-boundary CTU has no left/up candidate);
    default to the absolute coordinates when no tiles are in use. The
    lists may be pre-sized (tile decode order) or grown (raster order).
    """
    x_rel = x_lcu if x_rel is None else x_rel
    y_rel = y_lcu if y_rel is None else y_rel
    sao_l = SaoInfo()
    sao_c = SaoInfo()
    merge_left = merge_up = False
    if x_rel > 0:
        merge_left = bool(dec.decode_bin(OFF["sao_merge_flag"]))
    if y_rel > 0 and not merge_left:
        merge_up = bool(dec.decode_bin(OFF["sao_merge_flag"]))
    idx = y_lcu * wl + x_lcu

    def _store(lst, obj):
        if len(lst) > idx:
            lst[idx] = obj
        else:
            lst.append(obj)

    if merge_left:
        src_l = sao_luma[idx - 1]
        src_c = sao_chroma[idx - 1]
    elif merge_up:
        src_l = sao_luma[idx - wl]
        src_c = sao_chroma[idx - wl]
    else:
        _decode_sao_color(dec, OFF, sao_l, 0, bitdepth)
        if has_chroma:
            _decode_sao_color(dec, OFF, sao_c, 1, bitdepth)
            _decode_sao_color(dec, OFF, sao_c, 2, bitdepth)
        _store(sao_luma, sao_l)
        _store(sao_chroma, sao_c)
        return
    _store(sao_luma, SaoInfo(type=src_l.type, eo_class=src_l.eo_class,
                             band_position=list(src_l.band_position),
                             offsets=list(src_l.offsets)))
    _store(sao_chroma, SaoInfo(type=src_c.type, eo_class=src_c.eo_class,
                               band_position=list(src_c.band_position),
                               offsets=list(src_c.offsets)))

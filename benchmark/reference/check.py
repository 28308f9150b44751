"""The numbers that decide ``correct``: the program's search decisions
held to the reference's, and the same numbers for the control.

A decision tree is nested tuples, ``("leaf", x, y, s, mode)`` or
``("split", x, y, s, children)``: the harness turns the program's CTU
trees into it, and ``tree_from_dp`` builds it from a search and its DP.

- ``mode_gap``: the widest relative gap by which the mode chosen for a
  block costs more, by the reference's float32 mode cost (SATD +
  sqrt(lambda) * mode bits), than the reference's cheapest mode there.
- ``ctu_rd_gap``: the widest relative difference of a CTU's RD cost under
  the chosen partition (each leaf at the reference's RD cost of its block,
  lambda * SPLIT_BITS_EST a split) from the reference DP's optimum.
- ``rd_gap``: the widest relative difference of a block's RD cost from the
  reference's, where a search gives every block's (the P-frame screen).

A leaf the reference has no block for (not a square of 8..64 wholly
inside the picture) reads as an infinite gap.
"""
from __future__ import annotations

import numpy as np

from .search import dp
from .tables import LCU, SPLIT_BITS_EST, qp_to_lambda


def tree_from_dp(search: dict, width: int, height: int, qp: int) -> list:
    """The CTU trees (raster order) that the DP over ``search`` chooses,
    each leaf with its class's best mode (control/partition.py _build)."""
    choice, _total = dp(search, width, height, qp)
    W8, H8 = -(-width // 8) * 8, -(-height // 8) * 8

    def build(x, y, s):
        crosses = x + s > W8 or y + s > H8
        ch = 1 if crosses else (int(choice[s][y // s, x // s])
                                if s in choice else 0)
        if ch == 1 and s > 8:
            h = s >> 1
            kids = [build(cx, cy, h)
                    for (cx, cy) in ((x, y), (x + h, y), (x, y + h),
                                     (x + h, y + h))
                    if cx < W8 and cy < H8]
            return ("split", x, y, s, kids)
        e = search[s]
        return ("leaf", x, y, s, int(e["best"][(y // s) * e["gx"] + x // s]))

    return [build(cx * LCU, cy * LCU, LCU)
            for cy in range(-(-H8 // LCU)) for cx in range(-(-W8 // LCU))]


def _block(search: dict, x: int, y: int, s: int):
    e = search.get(s)
    if e is None or x % s or y % s:
        return None
    bx, by = x // s, y // s
    if bx >= e["gx"] or by >= e["gy"]:
        return None
    return e, by * e["gx"] + bx


def tree_numbers(trees: list, search: dict, width: int, height: int,
                 qp: int) -> dict:
    """mode_gap and ctu_rd_gap of one picture's CTU trees against the
    reference ``search`` (float32) of the same picture."""
    _choice, total = dp(search, width, height, qp)
    lam = qp_to_lambda(qp)
    mode_gap = 0.0
    n_leaves = 0

    def cost(node):
        nonlocal mode_gap, n_leaves
        if node[0] == "split":
            return sum(cost(c) for c in node[4]) + lam * SPLIT_BITS_EST
        _kind, x, y, s, mode = node
        n_leaves += 1
        found = _block(search, x, y, s)
        if found is None or not 0 <= mode < 67:
            mode_gap = float("inf")
            return float("inf")
        e, k = found
        mc = e["mode_cost"][k].astype(np.float64)
        best = mc.min()
        mode_gap = max(mode_gap, (mc[mode] - best) / best)
        return float(e["rd"][k])

    rd_gap = 0.0
    W8 = -(-width // 8) * 8
    wl = -(-W8 // LCU)
    if len(trees) != total[LCU].size:
        return {"mode_gap": float("inf"), "ctu_rd_gap": float("inf"),
                "blocks": 0}
    for i, t in enumerate(trees):
        opt = float(total[LCU][i // wl, i % wl])
        rd_gap = max(rd_gap, abs(cost(t) - opt) / opt)
    return {"mode_gap": mode_gap, "ctu_rd_gap": rd_gap, "blocks": n_leaves}


def screen_numbers(best: dict, rd: dict, search: dict) -> dict:
    """mode_gap and rd_gap of a search that gives every block's decision:
    best / rd {s: [B]} against the reference ``search`` (float32)."""
    mode_gap = 0.0
    rd_gap = 0.0
    n = 0
    for s, e in search.items():
        b = np.asarray(best.get(s, ()), dtype=np.int64)
        r = np.asarray(rd.get(s, ()), dtype=np.float64)
        if b.shape != e["best"].shape or r.shape != e["rd"].shape \
                or (b < 0).any() or (b >= 67).any():
            return {"mode_gap": float("inf"), "rd_gap": float("inf"),
                    "blocks": n}
        mc = e["mode_cost"].astype(np.float64)
        low = mc.min(axis=1)
        chosen = mc[np.arange(len(b)), b]
        mode_gap = max(mode_gap, float(((chosen - low) / low).max()))
        rd_gap = max(rd_gap, float((np.abs(r - e["rd"]) / e["rd"]).max()))
        n += len(b)
    return {"mode_gap": mode_gap, "rd_gap": rd_gap, "blocks": n}


def split_flat(flat, search: dict) -> tuple[dict, dict]:
    """A search's flat result [best_0 | rd_0 | best_1 | rd_1 | ...] over
    the classes of ``search`` (largest first, blocks in raster order) ->
    (best, rd) by class; a short vector leaves the rest empty."""
    flat = np.asarray(flat)
    best, rd = {}, {}
    off = 0
    for s in sorted(search, reverse=True):
        n = search[s]["gx"] * search[s]["gy"]
        best[s] = flat[off:off + n].astype(np.int64)
        rd[s] = flat[off + n:off + 2 * n].astype(np.float64)
        off += 2 * n
    return best, rd

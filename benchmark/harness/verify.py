"""The comparison that decides ``correct``.

The frames it looks at are drawn from the seed before the window opens,
one in each of ``check_frames`` equal strata of the frames a run of
``check_rate`` frames a second starts in the window (the traffic mix sets
a rate that a slow host still reaches), so that the sample spans the
window from its first frames to its last. Once the window has closed and
the program's state is freed, the reference (``benchmark/reference``)
searches each drawn frame's source again in float32, on the same device,
and the program's decisions for that frame are held to it by the traffic
mix's numbers and limits (``check`` in its file). Where the mix names
them, the inter stages of each drawn P frame (the host motion search and
K8) and the sampled rdoq calls are recomputed from what the program gave
them and held to what it gave back. A drawn frame that the window
started and the program never finished, or whose decisions the loop did
not see, fails the run; one that the window never reached is not due.
"""
from __future__ import annotations

import numpy as np

import reference.check as rc
import reference.inter as ri
import reference.rdoq as rr
import reference.search as rs
from reference.tables import FAST_COEFF_WTS, lowdelay4_qp, qp_to_lambda


def is_intra(traffic: dict, g: int) -> bool:
    period = int(traffic.get("intra_period", 0))
    return traffic.get("qp_rule", "fixed") != "fixed" and period > 0 \
        and g % period == 0


def draw(traffic: dict, seed: int, first: int = 0,
         seconds: float = 0.0) -> set:
    """The frame numbers the check looks at: one in each of k equal
    strata of the first max(k, check_rate x seconds) frames from
    ``first``; an I frame drawn gives way to the next frame."""
    rng = np.random.default_rng(int(seed))
    k = int(traffic["check_frames"])
    span = max(k, int(float(traffic["check_rate"]) * float(seconds)))
    out = set()
    for j in range(k):
        lo, hi = j * span // k, (j + 1) * span // k
        g = first + int(rng.integers(lo, hi))
        while is_intra(traffic, g) or g in out:
            g += 1
        out.add(g)
    return out


def frame_qp(traffic: dict, g: int) -> int:
    """The QP of frame g by the traffic mix's rule: ``fixed``, or the
    low-delay GOP 4 with four references (``lowdelay4``; frame 0 and every
    ``intra_period``-th frame are I frames, never drawn)."""
    qp = int(traffic["qp"])
    if traffic.get("qp_rule", "fixed") == "fixed":
        return qp
    return lowdelay4_qp(qp, g % int(traffic["intra_period"]))


def _relgap(got, ref) -> np.ndarray:
    return np.abs(np.asarray(got, np.float64) - ref) \
        / np.maximum(np.abs(ref), 1.0)


def me_numbers(rec: dict, src_y: np.ndarray, qp: int, bitdepth: int,
               device, cost_dtype=None) -> dict:
    """``me_rd_gap``: the widest relative gap between the cost the host
    motion search reports for a block at its chosen vector and the
    reference's RD cost of that vector (with the vector's own bits or a
    neighbour's 6, whichever lies nearer). With ``cost_dtype`` the
    reference in that precision takes the program's costs' place."""
    import torch
    dev = torch.device(device)
    H, W = rec["refs"][0].shape
    src = torch.from_numpy(rs.pad_to(src_y, W, H)).long().to(dev)
    refs = [torch.from_numpy(r).long().to(dev) for r in rec["refs"]]
    wts = torch.from_numpy(FAST_COEFF_WTS[min(qp, len(FAST_COEFF_WTS) - 1)]
                           .astype(np.float32)).to(dev)
    qps = qp + 6 * (bitdepth - 8)
    lam = qp_to_lambda(qp)
    args = (src, refs, rec["descs"], rec["mvs"])
    ref = ri.me_rd(*args, rec["costs"], qps, bitdepth, lam, wts)
    priced = ~np.isnan(ref[..., 0])
    if cost_dtype is None:
        got = rec["costs"][priced]
    else:
        got = ri.me_rd(*args, rec["costs"], qps, bitdepth, lam, wts,
                       cost_dtype)[..., 0][priced]
    ref = ref[priced]
    if not len(got):
        return {"me_rd_gap": 0.0}
    gap = np.minimum(_relgap(got, ref[:, 0]), _relgap(got, ref[:, 1]))
    return {"me_rd_gap": float(gap.max())}


def qpel_numbers(rec: dict, src_y: np.ndarray, qp: int, bitdepth: int,
                 device, cost_dtype=None) -> dict:
    """``qpel_gap``: the widest relative gap of K8's 49 sums of a leaf from
    the reference's; ``qpel_mv_miss``: the leaves whose kept vector is not
    the full-pel vector moved by the reference's two-stage choice."""
    import torch
    cands = rec["cands"]
    if not cands:
        return {"qpel_gap": 0.0, "qpel_mv_miss": 0}
    dev = torch.device(device)
    H, W = rec["refs"][0].shape
    src = torch.from_numpy(rs.pad_to(src_y, W, H)).long().to(dev)
    refs = [torch.from_numpy(r).long().to(dev) for r in rec["refs"]]
    ref = ri.leaf_seg(src, refs, cands, bitdepth)
    if cost_dtype is None:
        seg, mv_out = rec["seg"], rec["mv_out"]
    else:
        seg = ri.leaf_seg(src, refs, cands, bitdepth, cost_dtype)
        mv_out = None
    if seg is None or seg.shape != ref.shape:
        return {"qpel_gap": float("inf"), "qpel_mv_miss": len(cands)}
    pen = ri.pen49(float(np.sqrt(qp_to_lambda(qp))))
    miss = 0
    for i, (_x, _y, _w, _h, _u, mv) in enumerate(cands):
        if mv_out is not None and mv_out[i] is None:
            continue                # a bi pair: its own decision follows
        k = ri.two_stage(ref[i], pen)
        want = (mv[0] + (k % 7 - 3) * 4, mv[1] + (k // 7 - 3) * 4)
        kg = ri.two_stage(seg[i], pen) if mv_out is None else None
        got = mv_out[i] if mv_out is not None else \
            (mv[0] + (kg % 7 - 3) * 4, mv[1] + (kg // 7 - 3) * 4)
        miss += int(tuple(got) != want)
    return {"qpel_gap": float(_relgap(seg, ref).max()), "qpel_mv_miss": miss}


def rdoq_numbers(calls: list, control: bool = False) -> dict:
    """``rdoq_miss``: the sampled rdoq calls whose levels differ from the
    reference's; with ``control`` the reference in float32 takes the
    program's place."""
    miss = 0
    for coef, qps, bd, lam, intra, out in calls:
        ref = rr.rdoq_levels(coef, qps, bd, lam, intra)
        got = rr.rdoq_levels(coef, qps, bd, lam, intra, np.float32) \
            if control else out
        miss += int(not np.array_equal(np.asarray(got), ref))
    return {"rdoq_miss": miss}


def numbers(decisions: dict, want: set, started, done: dict, pool: list,
            source: dict, config: dict, traffic: dict, device,
            cost_dtype=None, stages: dict | None = None) -> dict:
    """The largest reading of each number over the drawn frames, with the
    frames checked. ``decisions`` {frame: (kind, data)} are the program's;
    with ``cost_dtype`` the reference searched in that precision takes
    their place (the control), and for the inter stages and rdoq the
    reference in the precision below the program's."""
    import torch
    W, H = int(config["width"]), int(config["height"])
    bitdepth = int(config["bitdepth"])
    limits = traffic["check"]
    stages = stages or {"me": {}, "qpel": {}, "rdoq": []}
    worst = {k: 0.0 for k in limits}
    checked = 0
    missing = []
    for g in sorted(want):
        if g not in started:
            continue                 # not due: the window never reached it
        if g not in done or (cost_dtype is None and g not in decisions):
            missing.append(g)
            continue
        qp = frame_qp(traffic, g)
        src_y = pool[source[g]][0]
        if torch.is_tensor(src_y):
            src_y = src_y.cpu().numpy()
        kind = traffic["decisions"]
        screen = kind == "screen"
        ref = rs.search_frame(src_y, qp, bitdepth, screen=screen,
                              device=device)
        if cost_dtype is not None:
            ctl = rs.search_frame(src_y, qp, bitdepth, screen=screen,
                                  cost_dtype=cost_dtype, device=device)
            data = rc.tree_from_dp(ctl, W, H, qp) if kind == "tree" else ctl
        else:
            got_kind, data = decisions[g]
            if got_kind != kind:
                missing.append(g)
                continue
        if kind == "tree":
            got = rc.tree_numbers(data, ref, W, H, qp)
        elif cost_dtype is not None:
            got = rc.screen_numbers({s: e["best"] for s, e in data.items()},
                                    {s: e["rd"] for s, e in data.items()},
                                    ref)
        else:
            got = rc.screen_numbers(*rc.split_flat(data, ref), ref)
        del ref
        for key, stage, fn in (("me_rd_gap", "me", me_numbers),
                               ("qpel_gap", "qpel", qpel_numbers)):
            if key not in limits:
                continue
            rec = stages[stage].get(g)
            if rec is None:
                got = None
                break
            got.update(fn(rec, src_y, qp, bitdepth, device, cost_dtype))
        if got is None:
            missing.append(g)
            continue
        for k in worst:
            if k in got:
                worst[k] = max(worst[k], float(got[k]))
        checked += 1
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    calls = 0
    if "rdoq_miss" in limits:
        calls = len(stages["rdoq"])
        worst.update(rdoq_numbers(stages["rdoq"], cost_dtype is not None))
    return {"numbers": worst, "checked": checked, "missing": missing,
            "rdoq_calls": calls}


def verdict(result: dict, traffic: dict) -> tuple[bool, dict]:
    """(correct, the checks line: each number beside its limit)."""
    limits = traffic["check"]
    checks = {k: {"value": result["numbers"][k], "limit": float(v)}
              for k, v in limits.items()}
    drawn = result["checked"] + len(result["missing"])
    # every drawn frame checked: the value has to reach its limit
    checks["frames_checked"] = {"value": result["checked"], "limit": drawn}
    ok = (result["checked"] > 0 and result["checked"] == drawn
          and all(result["numbers"][k] <= float(v)
                  for k, v in limits.items()))
    if "rdoq_miss" in limits:
        # at least one sampled call: the value has to reach its limit
        checks["rdoq_calls_checked"] = {"value": result["rdoq_calls"],
                                        "limit": 1}
        ok = ok and result["rdoq_calls"] >= 1
    return ok, checks

"""The CUDA kernels K1-K14 against their plain PyTorch versions on the
card.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA card: they
carry the ``cuda`` marker and skip elsewhere. On the card:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Both sides run the same integer and float32 operations in the same order,
so every output, the rd costs included, must be equal.
"""
import numpy as np
import pytest
import torch

from uvg266_tpu_torch import kernels
from uvg266_tpu_torch.ops import intra_batch as ib
from uvg266_tpu_torch.ops import rd_cost as rd
from uvg266_tpu_torch.ops import tables as tb

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("w,h,bd", [(4, 4, 8), (8, 8, 8), (16, 8, 8),
                                    (8, 16, 10), (32, 32, 8), (64, 64, 10),
                                    (64, 32, 8), (16, 64, 8)])
def test_kernels_equal_plain(card, w, h, bd):
    rng = np.random.default_rng(w * 100 + h + bd)
    mx = (1 << bd) - 1
    src = torch.from_numpy(
        rng.integers(0, mx + 1, (3 * h + 5, 4 * w + 3)).astype(np.int32))
    src = src.to(card)
    grid = (w // 2, 1, w, h, 3, 2)               # offset grid, edges clamped
    tabs = tb.device_tables(w, h, bd, "cuda")
    before = dict(kernels.LAUNCHES)
    refs, blocks = ib.refs_blocks_grid(src, w, h, grid)
    pr, pb = ib.refs_blocks_grid_plain(src, w, h, grid)
    assert torch.equal(refs, pr) and torch.equal(blocks, pb)
    preds = ib.predict67(refs, tabs)
    assert torch.equal(preds, ib.predict67_plain(refs, tabs))
    preds[0] = 0
    blocks[0] = mx
    satds = ib.satd67(preds, blocks)
    assert torch.equal(satds, ib.satd67_plain(preds, blocks))
    for qp in (22, 37):
        ft = tb.frame_tables(qp, "cuda")
        args = (preds, blocks, satds, qp + 6 * (bd - 8), 57.9, ft["wts"],
                ft["mode_bits"], tabs, bd)
        for a, b in zip(rd.rd_cost(*args), rd.rd_cost_plain(*args)):
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        "refs_blocks_grid": 1, "predict67": 1, "satd67": 1, "rd_cost": 2}


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", [(32, 8), (8, 32), (64, 16), (16, 64),
                                 (4, 16), (16, 4), (64, 64), (8, 8)])
def test_redesigned_k2_k4_equal_plain(card, w, h, bd):
    """K2 (per-mode descriptors) and K4 (partial butterflies, several blocks
    per thread block) at the BT/TT shapes and two squares: B = 1, 7 and 37
    (not a multiple of K4's blocks per thread block), all 67 modes and the
    35 of the rough search, K4 over 67, 35, 16 and 12 candidates, random and
    edge references (zero, maximum, checkerboard), and the largest
    residual (zero predictions, source at the maximum)."""
    rng = np.random.default_rng(w * 1000 + h * 10 + bd)
    mx = (1 << bd) - 1
    tabs = tb.device_tables(w, h, bd, "cuda")
    m35 = tb.rough_modes("cuda")
    n = 0
    before = dict(kernels.LAUNCHES)
    for B in (1, 7, 37):
        refs = rng.integers(0, mx + 1, (B, 780)).astype(np.int32)
        if B > 3:
            refs[1], refs[2] = 0, mx
            refs[3] = (np.arange(780) % 2) * mx
        refs = _t(refs, card)
        blocks = _t(rng.integers(0, mx + 1, (B, h, w)).astype(np.int32), card)
        for ml in (None, m35):
            assert torch.equal(ib.predict67(refs, tabs, ml),
                               ib.predict67_plain(refs, tabs, ml))
            n += 1
        preds = ib.predict67_plain(refs, tabs)
        pairs = [(preds, blocks), (torch.zeros_like(preds),
                                   torch.full_like(blocks, mx))]
        for pp, bb in pairs:
            for M in (67, 35, 16, 12):
                p_ = pp[:, :M].contiguous()
                satds = ib.satd67_plain(p_, bb)
                for qp in (22, 37):
                    ft = tb.frame_tables(qp, "cuda")
                    mb = (ft["mode_bits"][:M].contiguous() if M >= 35
                          else tb.mip_mode_bits(M, "cuda"))
                    args = (p_, bb, satds, qp + 6 * (bd - 8), 57.9,
                            ft["wts"], mb, tabs, bd)
                    for a, b in zip(rd.rd_cost(*args),
                                    rd.rd_cost_plain(*args)):
                        assert a.dtype == b.dtype and torch.equal(a, b)
                    n += 1
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        "predict67": 6, "rd_cost": n - 6}


@pytest.mark.parametrize("bd", [8, 10])
def test_inter_kernels_equal_plain(card, bd):
    """K1 with a separate reference plane, K5 pseudo_recon, K6
    rd_cost_pred, K7 frame_inter and K8 leaf_qpel (K6 and K7 at 8 bits,
    the only depth their path runs) against their plain versions."""
    from uvg266_tpu_torch.ops import me_frame as mf
    from uvg266_tpu_torch.ops import pseudo_recon as pr
    rng = np.random.default_rng(bd)
    mx = (1 << bd) - 1
    H, W, r = 96, 128, 16
    src = rng.integers(0, mx + 1, (H, W)).astype(np.int32)
    src[:16, :16] = mx * (np.arange(16)[None, :] % 2)
    before = dict(kernels.LAUNCHES)
    s = _t(src, card)
    for qps in (22, 37, 51 + 6 * (bd - 8)):
        assert torch.equal(pr.pseudo_recon(s, qps, bd),
                           pr.pseudo_recon_plain(s, qps, bd))
    pseudo = pr.pseudo_recon(s, 27, bd)
    grid = (8, 0, 32, 32, 3, 3)
    got = ib.refs_blocks_grid(s, 16, 32, grid, pseudo)
    want = ib.refs_blocks_grid_plain(s, 16, 32, grid, pseudo)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pen49 = _t(rng.uniform(0, 40, 49).astype(np.float32), card)
    nt, nl = 40, 12
    ids = np.sort(rng.integers(0, nl + 1, nt)).astype(np.int32)   # + padding
    args = (_t(rng.integers(0, mx + 1, (nt, 18, 18)).astype(np.int32), card),
            _t(rng.integers(0, mx + 1, (nt, 8, 8)).astype(np.int32), card),
            _t(ids, card), nl, pen49, bd)
    assert all(torch.equal(a, b) for a, b in zip(mf.leaf_qpel(*args),
                                                  mf.leaf_qpel_plain(*args)))
    # leaves of 1, 4, 16 and 64 tiles (8x8 .. 64x64) plus padding tiles;
    # the 64-tile leaf at the largest residual (block = max - window)
    sizes = (1, 4, 16, 64, 2)
    ids = np.repeat(np.arange(len(sizes) + 1), sizes + (3,)).astype(np.int32)
    wins = rng.integers(0, mx + 1, (ids.size, 18, 18)).astype(np.int32)
    blks = rng.integers(0, mx + 1, (ids.size, 8, 8)).astype(np.int32)
    big = ids == 3
    blks[big] = mx - wins[big, 5:13, 5:13]
    args = (_t(wins, card), _t(blks, card), _t(ids, card), len(sizes), pen49,
            bd)
    assert all(torch.equal(a, b) for a, b in zip(mf.leaf_qpel(*args),
                                                  mf.leaf_qpel_plain(*args)))
    n_expect = {"pseudo_recon": 4, "refs_blocks_grid": 1, "leaf_qpel": 2}
    if bd == 8:
        ref = np.clip(np.roll(src, (3, -5), axis=(0, 1))
                      + rng.integers(-3, 4, (H, W)), 0, mx).astype(np.int32)
        ref_pad = _t(np.pad(ref, r, mode="edge"), card)
        n = 2 * r + 1
        pen = _t(np.linspace(0, 60, n * n).astype(np.float32), card)
        bits = _t(rng.uniform(4, 30, n * n).astype(np.float32), card)
        classes = ((8, 8, (0, 0, 8, 8, 16, 12)), (32, 32, (0, 0, 32, 32, 4, 3)),
                   (64, 64, (0, 0, 64, 64, 2, 1)), (16, 32, (8, 0, 32, 32, 3, 3)))
        got = mf.frame_inter(s, ref_pad, pen, bits, classes, r)
        want = mf.frame_inter_plain(s, ref_pad, pen, bits, classes, r)
        for g, w_ in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(g, w_))
        ft = tb.frame_tables(27, "cuda")
        for (w, h, _g), (_idx, pred, blk, extra) in zip(classes, got):
            tabs = tb.device_tables(w, h, 8, "cuda")
            a = (pred, blk, 27, 68.5, ft["wts"], extra, tabs, 8)
            assert torch.equal(rd.rd_cost_pred(*a), rd.rd_cost_pred_plain(*a))
        n_expect.update(frame_inter=1, rd_cost_pred=len(classes))
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == n_expect


@pytest.mark.parametrize("w,h,bd", [(4, 4, 8), (8, 8, 10), (16, 16, 8),
                                    (32, 32, 10), (8, 32, 8), (64, 64, 8),
                                    (16, 4, 10), (32, 16, 8)])
def test_tool_kernels_equal_plain(card, w, h, bd):
    """K10 mip_preds and K12a refs_blocks at positions on the plane's
    edges and off any grid, K3/K4 at the class's MIP candidate count, and
    K11 mts_search (w, h <= 32) on the winning MIP prediction and on the
    largest residual."""
    from uvg266_tpu_torch.ops import mip
    rng = np.random.default_rng(w * 100 + h + bd)
    mx = (1 << bd) - 1
    H, W = 3 * h + 6, 4 * w + 8
    src = rng.integers(0, mx + 1, (H, W)).astype(np.int32)
    xs = np.array([0, W - w, 0, W - w, 3, w + 1, 2 * w + 5], dtype=np.int32)
    ys = np.array([0, 0, H - h, H - h, 1, h + 2, 2 * h + 3], dtype=np.int32)
    s_cpu = torch.from_numpy(src)
    s = s_cpu.to(card)
    before = dict(kernels.LAUNCHES)
    refs, blocks = ib.refs_blocks(s, xs, ys, w, h)
    pr, pb = ib.refs_blocks_plain(s, xs, ys, w, h)
    assert torch.equal(refs, pr) and torch.equal(blocks, pb)
    mat = tb.mip_matrix(mip.mip_size_id(w, h), "cuda")
    preds = mip.mip_preds(s, xs, ys, w, h, bd, mat)
    assert preds.shape == (7, 2 * mip.mip_mode_count(w, h), h, w)
    assert torch.equal(preds, mip.mip_preds_plain(s, xs, ys, w, h, bd, mat))
    satds = ib.satd67(preds, blocks)
    assert torch.equal(satds, ib.satd67_plain(preds, blocks))
    tabs = tb.device_tables(w, h, bd, "cuda")
    bits = tb.mip_mode_bits(preds.shape[1], "cuda")
    n_expect = {"refs_blocks": 1, "mip_preds": 1, "satd67": 1, "rd_cost": 2}
    for qp in (22, 37):
        ft = tb.frame_tables(qp, "cuda")
        args = (preds, blocks, satds, qp + 6 * (bd - 8), 57.9, ft["wts"],
                bits, tabs, bd)
        got = rd.rd_cost(*args)
        for a, b in zip(got, rd.rd_cost_plain(*args)):
            assert torch.equal(a, b)
    if w <= 32 and h <= 32:
        mts = tb.device_mts_tables(w, h, "cuda")
        best_pred = preds[torch.arange(7, device=card), got[0].long()]
        smooth = (blocks + torch.arange(w, device=card)[None, None, :] * 3
                  - 20).clamp(0, mx).to(torch.int32)
        cases = [(best_pred, blocks), (smooth, blocks),
                 (torch.zeros_like(blocks), torch.full_like(blocks, mx))]
        for pp, bb in cases:
            for qp in (22, 37):
                ft = tb.frame_tables(qp, "cuda")
                a = (pp.contiguous(), bb, qp + 6 * (bd - 8), 57.9, ft["wts"],
                     mts, bd)
                for x_, y_ in zip(rd.mts_search(*a), rd.mts_search_plain(*a)):
                    assert x_.dtype == y_.dtype and torch.equal(x_, y_)
        n_expect["mts_search"] = 6
    with pytest.raises(ValueError, match="outside"):
        ib.refs_blocks(s, np.array([W - w + 1]), np.array([0]), w, h)
    with pytest.raises(ValueError, match="outside"):
        mip.mip_preds(s, np.array([0]), np.array([-1]), w, h, bd, mat)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == n_expect


@pytest.mark.parametrize("w,h,bd", [(8, 8, 8), (16, 16, 10), (16, 8, 8),
                                    (4, 16, 10), (32, 32, 8), (64, 64, 10)])
def test_me_kernels_equal_plain(card, w, h, bd):
    """K9a fullpel_search (textured, flat, all-max and edge blocks; the
    all-max 64x64 10-bit block sums to 4096 * 1023^2 < 2^32) and K9b
    frac_search at its MVs: every output equal."""
    from uvg266_tpu_torch.ops import me
    rng = np.random.default_rng(w * 10 + h + bd)
    mx = (1 << bd) - 1
    H, W, r = 2 * h + 40, 3 * w + 40, 16
    ref = rng.integers(0, mx + 1, (H, W)).astype(np.int32)
    src = np.roll(ref, (3, 5), (0, 1)).copy()
    src[:h, W - w:] = mx
    ref[:h + r, W - w - r:] = mx
    src[H - h:, W - w:] = mx // 2
    xs = np.array([0, W - w, 0, W - w, 17, w + 3], dtype=np.int32)
    ys = np.array([0, 0, H - h, H - h, 9, h + 5], dtype=np.int32)
    blocks = np.stack([src[y:y + h, x:x + w] for x, y in zip(xs, ys)])
    pen, fpen = tb.me_penalties(57.9, r, "cuda")
    rd_, bd_, xd, yd = (_t(a, card) for a in (ref, blocks, xs, ys))
    before = dict(kernels.LAUNCHES)
    got = me.fullpel_search(rd_, bd_, xd, yd, r, pen, bd)
    for a, b in zip(got, me.fullpel_search_plain(rd_, bd_, xd, yd, r, pen)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mvx, mvy, _c = got
    fs = me.frac_search(rd_, bd_, xd, yd, mvx, mvy, fpen, bd)
    for a, b in zip(fs, me.frac_search_plain(rd_, bd_, xd, yd, mvx, mvy, fpen,
                                             bd)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        "fullpel_search": 1, "frac_search": 1}


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("h", [4, 8, 16, 32, 64])
def test_redesigned_k9_equal_plain(card, w, h):
    """K9a (box-sum r2, register-tiled corr, several blocks or split rows
    per thread block) and both forms of K9b (all 49 predictions; the
    winner's only, against the plain gather) at every (w, h) in {4..64}^2:
    B = 1 and 9 (not a multiple of the blocks per thread block) at random
    positions, and the plane's grid of blocks (side by side, as a class
    lies: K9a reads one union window), 8 and 10 bits (K9b also 12), random
    planes, all-max planes (K9a's exact sums at their largest: 4096 *
    1023^2 < 2^32) and blocks at the plane's edges."""
    from uvg266_tpu_torch.ops import me
    rng = np.random.default_rng(w * 100 + h)
    r = 16
    H, W = 2 * h + 40, 3 * w + 40
    pen, fpen = tb.me_penalties(57.9, r, "cuda")
    n = {"fullpel_search": 0, "frac_search": 0}
    before = dict(kernels.LAUNCHES)
    for bd in (8, 10, 12):
        mx = (1 << bd) - 1
        for tag in ("rand", "max"):
            ref = rng.integers(0, mx + 1, (H, W)).astype(np.int32)
            src = np.roll(ref, (3, 5), (0, 1)) + rng.integers(-2, 3, (H, W))
            if tag == "max":
                ref[:], src[:] = mx, mx
            src = np.clip(src, 0, mx).astype(np.int32)
            grid = [(x, y) for y in range(0, H - h + 1, h)
                    for x in range(0, W - w + 1, w)]
            for B in (1, 9, len(grid)):
                xs = rng.integers(0, W - w + 1, B).astype(np.int32)
                ys = rng.integers(0, H - h + 1, B).astype(np.int32)
                xs[0], ys[0] = W - w, H - h
                if B == len(grid):             # side by side, as a class
                    xs = np.array([p[0] for p in grid], dtype=np.int32)
                    ys = np.array([p[1] for p in grid], dtype=np.int32)
                blocks = np.stack([src[y:y + h, x:x + w]
                                   for x, y in zip(xs, ys)])
                rd_, bd_, xd, yd = (_t(a, card)
                                    for a in (ref, blocks, xs, ys))
                if bd <= 10:
                    got = me.fullpel_search(rd_, bd_, xd, yd, r, pen, bd)
                    for a, b in zip(got, me.fullpel_search_plain(
                            rd_, bd_, xd, yd, r, pen)):
                        assert a.dtype == b.dtype and torch.equal(a, b)
                    n["fullpel_search"] += 1
                    mvx, mvy = got[0], got[1]
                else:
                    mvx = _t(rng.integers(-r, r + 1, B).astype(np.int32), card)
                    mvy = _t(rng.integers(-r, r + 1, B).astype(np.int32), card)
                a_ = (rd_, bd_, xd, yd, mvx, mvy, fpen, bd)
                want = me.frac_search_plain(*a_)
                for a, b in zip(me.frac_search(*a_), want):
                    assert a.dtype == b.dtype and torch.equal(a, b)
                wbest, wpred, wcost = me.frac_search(*a_, winner_only=True)
                assert torch.equal(wbest, want[0])
                assert torch.equal(wcost, want[2])
                assert torch.equal(
                    wpred, want[1][torch.arange(B, device=card),
                                   want[0].long()])
                n["frac_search"] += 2
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == n


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("h", [4, 8, 16, 32, 64])
def test_redesigned_k10_k11_equal_plain(card, w, h):
    """K10 mip_preds (templates over (w, h); a thread block per block and
    candidate group, or several blocks per thread block; each output one
    vertical step from the upsampled rows) at every (w, h) in {4..64}^2 and
    K11 mts_search (joint DST7/DCT8 forward passes, the kept coefficients
    only) at every (w, h) in {4..32}^2, 8 and 10 bits. K10 on random,
    all-max and checkerboard planes, at one block in the plane's corner,
    nine at the corners and off any grid (not a multiple of the blocks per
    thread block) and the plane's grid; K11 on random, smooth and all-max
    residuals, B = 1, 9 and 37, QP 22 and 37. Every output equal, one
    launch per comparison."""
    from uvg266_tpu_torch.ops import mip
    rng = np.random.default_rng(w * 100 + h + 7)
    H, W = 3 * h + 6, 4 * w + 8
    mat = tb.mip_matrix(mip.mip_size_id(w, h), "cuda")
    gx, gy = np.meshgrid(np.arange(0, W - w + 1, w), np.arange(0, H - h + 1, h))
    positions = [([W - w], [H - h]),
                 ([0, W - w, 0, W - w, 3, w + 1, 1, 2 * w + 5, 5],
                  [0, 0, H - h, H - h, 1, h + 2, 3, 2 * h + 3, 0]),
                 (gx.ravel(), gy.ravel())]
    n = {"mip_preds": 0, "mts_search": 0}
    before = dict(kernels.LAUNCHES)
    for bd in (8, 10):
        mx = (1 << bd) - 1
        planes = (rng.integers(0, mx + 1, (H, W)), np.full((H, W), mx),
                  (np.indices((H, W)).sum(0) % 2) * mx)
        for plane in planes:
            s = _t(plane.astype(np.int32), card)
            for xs, ys in positions:
                xs = np.asarray(xs, dtype=np.int32)
                ys = np.asarray(ys, dtype=np.int32)
                got = mip.mip_preds(s, xs, ys, w, h, bd, mat)
                want = mip.mip_preds_plain(s, xs, ys, w, h, bd, mat)
                assert got.dtype == want.dtype and torch.equal(got, want)
                n["mip_preds"] += 1
        if max(w, h) > 32:
            continue
        mts = tb.device_mts_tables(w, h, "cuda")
        for B in (1, 9, 37):
            src = rng.integers(0, mx + 1, (B, h, w))
            cases = [(rng.integers(0, mx + 1, (B, h, w)), src),
                     (np.clip(src + rng.integers(-6, 7, (B, h, w)), 0, mx),
                      src),
                     (np.zeros((B, h, w)), np.full((B, h, w), mx))]
            for pred, blk in cases:
                pred = _t(pred.astype(np.int32), card)
                blk = _t(blk.astype(np.int32), card)
                for qp in (22, 37):
                    ft = tb.frame_tables(qp, "cuda")
                    a = (pred, blk, qp + 6 * (bd - 8), 57.9, ft["wts"], mts,
                         bd)
                    for x_, y_ in zip(rd.mts_search(*a),
                                      rd.mts_search_plain(*a)):
                        assert x_.dtype == y_.dtype and torch.equal(x_, y_)
                    n["mts_search"] += 1
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        k: v for k, v in n.items() if v}


@pytest.mark.parametrize("w,h,bd", [(4, 4, 8), (8, 8, 10), (16, 16, 8),
                                    (32, 16, 10), (64, 64, 8)])
def test_rough_kernels_equal_plain(card, w, h, bd):
    """K2 at the 35-mode subset, K12b predict_modes (mode lists with 2, 66
    and duplicates) and the K12c chain with its two selection stages."""
    rng = np.random.default_rng(w * 7 + h + bd)
    mx = (1 << bd) - 1
    B = 9
    refs = _t(rng.integers(0, mx + 1, (B, 780)).astype(np.int32), card)
    blocks = _t(rng.integers(0, mx + 1, (B, h, w)).astype(np.int32), card)
    modes = rng.integers(2, 67, (B, 4)).astype(np.int32)
    modes[0] = (2, 66, 2, 66)
    modes = _t(modes, card)
    tabs = tb.device_tables(w, h, bd, "cuda")
    m1 = tb.rough_modes("cuda")
    before = dict(kernels.LAUNCHES)
    assert torch.equal(ib.predict67(refs, tabs, m1),
                       ib.predict67_plain(refs, tabs, m1))
    assert torch.equal(ib.predict_modes(refs, modes, tabs),
                       ib.predict_modes_plain(refs, modes, tabs))
    for qp in (22, 37):
        ft = tb.frame_tables(qp, "cuda")
        args = (refs, blocks, qp + 6 * (bd - 8), 57.9, ft["wts"],
                ft["mode_bits"], tabs, bd, m1)
        for a, b in zip(rd.rough_refine(*args), rd.rough_refine_plain(*args)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        "predict67": 3, "predict_modes": 3, "satd67": 4, "rough_refine": 4,
        "rd_cost_pred": 2}


@pytest.mark.parametrize("w,h,th,tv,bd", [
    (4, 4, 0, 0, 8), (8, 8, 0, 0, 10), (16, 16, 2, 2, 8), (32, 32, 1, 1, 10),
    (64, 64, 0, 0, 8), (64, 64, 0, 0, 10), (32, 8, 2, 1, 8),
    (8, 32, 1, 2, 10), (8, 4, 0, 0, 10), (64, 16, 0, 0, 8)])
def test_transform_quant_kernels_equal_plain(card, w, h, th, tv, bd):
    """K13 fwd_transform / inv_transform (DCT2 and the MTS types, with the
    zero-out of 32- and 64-point dimensions) and K14 quant_levels /
    dequant_levels at every qp_scaled the encoder gives, on residuals,
    int16-range inputs and the int32 wrap edges: equal, dtypes included."""
    from uvg266_tpu_torch.ops import quant as q
    from uvg266_tpu_torch.ops import transforms as tr
    rng = np.random.default_rng(w * 5 + h * 3 + th + tv + bd)
    mx = (1 << bd) - 1
    x = np.concatenate([rng.integers(-mx, mx + 1, (40, h, w)),
                        rng.integers(-32767, 32768, (8, h, w)),
                        np.full((1, h, w), mx), np.full((1, h, w), -mx)])
    x = _t(x.astype(np.int32), card)
    before = dict(kernels.LAUNCHES)
    c = tr.fwd_batch(x, th, tv, bd)
    assert c.dtype == torch.int16
    assert torch.equal(c, tr.fwd_batch_plain(x, th, tv, bd))
    cc = torch.cat([c.to(torch.int32), x])
    assert torch.equal(tr.inv_batch(cc, th, tv, bd),
                       tr.inv_batch_plain(cc, th, tv, bd))
    edges = torch.tensor([0, 1, -1, 26215, 29127, 32767, -32768, 200000,
                          -200000, 2 ** 31 - 1, -2 ** 31], dtype=torch.int32,
                         device=card)
    levels = cc.clone()
    levels[0].view(-1)[:edges.numel()] = edges
    n_qp = 52 if bd == 8 else 64
    for qp in range(n_qp):
        for intra in (True, False):
            a = q.quant_batch(levels, qp, bd, intra)
            assert a.dtype == torch.int32
            assert torch.equal(a, q.quant_batch_plain(levels, qp, bd, intra))
        assert torch.equal(q.dequant_batch(levels, qp, bd),
                           q.dequant_batch_plain(levels, qp, bd))
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        "fwd_transform": 1, "inv_transform": 1, "quant_levels": 2 * n_qp,
        "dequant_levels": n_qp}


def _k8_leaves(rng, bd, tag, nt_extra=0):
    """Leaves of 1, 2, 4, 16 and 64 tiles, then three padding tiles (and
    nt_extra random one-tile leaves before them), as
    tests/test_torch_me_frame_design.py builds them: random windows with
    the 64-tile leaf at the largest residual, all-max windows, or windows
    whose rows drive each horizontal phase to its extreme sums."""
    from uvg266_tpu_torch.ops.inter import LUMA_FILTER
    mx = (1 << bd) - 1
    sizes = (1, 2, 4, 16, 64) + (1,) * nt_extra
    ids = np.repeat(np.arange(len(sizes) + 1), sizes + (3,)).astype(np.int32)
    nt = ids.size
    if tag == "max":
        wins, blks = np.full((nt, 18, 18), mx), np.zeros((nt, 8, 8))
    elif tag == "taps":
        pats = [np.where(s * np.asarray(LUMA_FILTER[fx]) > 0, mx, 0)
                for fx in (4, 8, 12) for s in (1, -1)]
        wins = np.stack([np.stack([np.resize(pats[(t + i) % 6], 18)
                                   for i in range(18)]) for t in range(nt)])
        blks = rng.integers(0, mx + 1, (nt, 8, 8))
    else:
        wins = rng.integers(0, mx + 1, (nt, 18, 18))
        blks = rng.integers(0, mx + 1, (nt, 8, 8))
        blks[ids == 4] = mx - wins[ids == 4, 5:13, 5:13]
    return (wins.astype(np.int32), blks.astype(np.int32), ids,
            (rng.random(49) * 40).astype(np.float32), len(sizes))


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("tag", ["rand", "max", "taps"])
def test_redesigned_k8_equal_plain(card, bd, tag):
    """K8 leaf_qpel (four tiles a warp, shared int16 horizontal passes, the
    vertical slide and the shuffle Hadamard of qpel.cuh; a warp per leaf)
    at leaves of 1, 2, 4, 16 and 64 tiles mixed with padding ids, alone
    and with 6000 one-tile leaves (many thread blocks, a partial last
    warp); its tile pass alone (the C entry with no leaf) against the plain
    per-tile SATDs; windows at a 4-byte offset (no 16-byte loads)."""
    from uvg266_tpu_torch.ops import me_frame as mf
    rng = np.random.default_rng(bd * 7 + len(tag))
    n = 0
    before = dict(kernels.LAUNCHES)
    for extra in (0, 6000):
        wins, blks, ids, pen, nl = _k8_leaves(rng, bd, tag, extra)
        w_, b_, i_, p_ = (_t(a, card) for a in (wins, blks, ids, pen))
        for a, b in zip(mf.leaf_qpel(w_, b_, i_, nl, p_, bd),
                        mf.leaf_qpel_plain(w_, b_, i_, nl, p_, bd)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        satd = torch.empty((ids.size, 49), dtype=torch.int32, device=card)
        kernels.launch("leaf_qpel", card, w_.data_ptr(), b_.data_ptr(),
                       i_.data_ptr(), ids.size, 0, p_.data_ptr(), bd,
                       satd.data_ptr(), None, None, None)
        assert torch.equal(satd, mf._tile_satd_plain(w_, b_, bd)
                           .to(torch.int32))
        n += 2
    flat = torch.empty(wins.size + 1, dtype=torch.int32, device=card)
    w_odd = flat[1:].view(wins.shape)
    w_odd.copy_(_t(wins, card))
    assert w_odd.data_ptr() % 16 != 0
    for a, b in zip(mf.leaf_qpel(w_odd, b_, i_, nl, p_, bd),
                    mf.leaf_qpel_plain(w_odd, b_, i_, nl, p_, bd)):
        assert torch.equal(a, b)
    n += 1
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {"leaf_qpel": n}


@pytest.mark.parametrize("r", [16, 5, 0, 24])
def test_redesigned_k7_equal_plain(card, r):
    """K7 frame_inter (4 x 3 tile patches at r = 16, one tile and strips
    of 8 at any other r; box-sum r^2; one class launch, a warp per block)
    on a 136x104 frame (partial patches on both axes), random, flat and
    edge 8-bit planes and random 10- and 12-bit ones, ten classes
    (square, rectangular, offset grids, 64x64, an empty one; more than a
    launch's eight), the tile map alone (the C entry with no class)
    against the plain tile SSD maps."""
    from uvg266_tpu_torch.ops import me_frame as mf
    rng = np.random.default_rng(r + 3)
    H, W = 104, 136
    n = 2 * r + 1
    classes = ((8, 8, (0, 0, 8, 8, 17, 13)), (16, 16, (0, 0, 16, 16, 8, 6)),
               (32, 32, (0, 0, 32, 32, 4, 3)), (64, 64, (0, 0, 64, 64, 2, 1)),
               (16, 32, (8, 0, 32, 32, 3, 3)), (32, 16, (0, 8, 32, 32, 4, 3)),
               (8, 16, (0, 0, 16, 16, 8, 6)), (64, 32, (8, 16, 64, 32, 1, 2)),
               (32, 32, (0, 0, 32, 32, 0, 3)), (24, 8, (0, 0, 24, 8, 5, 13)))
    pen = _t(np.linspace(0, 60, n * n).astype(np.float32), card)
    bits = _t(rng.uniform(4, 30, n * n).astype(np.float32), card)
    before = dict(kernels.LAUNCHES)
    cnt = 0
    for bd, tag in ((8, "rand"), (8, "flat"), (8, "edge"), (10, "rand"),
                    (12, "rand")):
        mx = (1 << bd) - 1
        if tag == "flat":
            src = np.full((H, W), mx // 3)
            ref = src.copy()
        elif tag == "edge":
            src = ((np.arange(H)[:, None] // 8 + np.arange(W)[None] // 8)
                   % 2) * mx
            ref = np.roll(src, (3, 5), (0, 1))
        else:
            src = rng.integers(0, mx + 1, (H, W))
            ref = np.clip(np.roll(src, (3, -5), (0, 1))
                          + rng.integers(-3, 4, (H, W)), 0, mx)
        s = _t(src.astype(np.int32), card)
        rp = _t(np.pad(ref, r, mode="edge").astype(np.int32), card)
        got = mf.frame_inter(s, rp, pen, bits, classes, r)
        want = mf.frame_inter_plain(s, rp, pen, bits, classes, r)
        for g, w_ in zip(got, want):
            for a, b in zip(g, w_):
                assert a.dtype == b.dtype and torch.equal(a, b), (bd, tag)
        ssd = torch.empty(((H // 8) * (W // 8), n * n), dtype=torch.int32,
                          device=card)
        kernels.launch("frame_inter", card, s.data_ptr(), rp.data_ptr(), H,
                       W, r, pen.data_ptr(), bits.data_ptr(), None, 0,
                       ssd.data_ptr(), None, None, None, None)
        assert torch.equal(ssd, mf._tile_ssd_plain(s, rp, r)), (bd, tag)
        cnt += 2
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {"frame_inter": cnt}


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (8, 32), (64, 64)])
def test_k9b_after_header_move(card, w, h):
    """K9b frac_search, whose interpolation and Hadamard now come from
    qpel.cuh (shared with K8), on planes whose rows drive each horizontal
    phase to its extreme sums, at 8 and 12 bits: both forms equal their
    plain versions."""
    from uvg266_tpu_torch.ops import me
    from uvg266_tpu_torch.ops.inter import LUMA_FILTER
    rng = np.random.default_rng(w * 3 + h)
    H, W = 2 * h + 40, 3 * w + 40
    _pen, fpen = tb.me_penalties(57.9, 16, "cuda")
    before = dict(kernels.LAUNCHES)
    for bd in (8, 12):
        mx = (1 << bd) - 1
        pats = [np.where(s * np.asarray(LUMA_FILTER[fx]) > 0, mx, 0)
                for fx in (4, 8, 12) for s in (1, -1)]
        ref = np.stack([np.resize(pats[i % 6], W) for i in range(H)])
        B = 9
        xs = rng.integers(0, W - w + 1, B).astype(np.int32)
        ys = rng.integers(0, H - h + 1, B).astype(np.int32)
        blocks = rng.integers(0, mx + 1, (B, h, w)).astype(np.int32)
        mvx = rng.integers(-16, 17, B).astype(np.int32)
        mvy = rng.integers(-16, 17, B).astype(np.int32)
        a_ = tuple(_t(v, card) for v in (ref.astype(np.int32), blocks, xs, ys,
                                         mvx, mvy)) + (fpen, bd)
        want = me.frac_search_plain(*a_)
        for a, b in zip(me.frac_search(*a_), want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        wb, wp, wc = me.frac_search(*a_, winner_only=True)
        assert torch.equal(wb, want[0]) and torch.equal(wc, want[2])
        assert torch.equal(wp, want[1][torch.arange(B, device=card),
                                       want[0].long()])
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {"frac_search": 4}


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("h", [4, 8, 16, 32, 64])
def test_redesigned_k6_k1_equal_plain(card, w, h):
    """K6 rd_cost_pred (K4's RD tail from rd_tail.cuh, w*h/4 threads a
    block) and the K1/K12a reference-line kernel (templates over (w, h), U
    blocks a thread block, lines in shared memory, int4 rows) at every
    (w, h) in {4..64}^2. K6 at 8 and 10 bits, QP 22 and 37, quant rounding
    85 and 171, on random, all-max and (10 bits) 12-bit-range residuals
    that wrap the SSD, B = 1, 37 and 70 (not multiples of the blocks per
    thread block). K1 on planes narrower than its 3w+3 top line, with the
    row length a multiple of 4 and not: the plane's grid with edge blocks
    leaving it, a grid off the 4-sample grid, one block, F = 2 frames with
    a separate reference plane; K12a at the corners and off the 4-sample
    grid. Every output equal, one launch per comparison; the K6 wrapper
    refuses a prediction that is not 16-byte aligned."""
    rng = np.random.default_rng(w * 100 + h + 11)
    n = {"rd_cost_pred": 0, "refs_blocks_grid": 0, "refs_blocks": 0}
    before = dict(kernels.LAUNCHES)
    for bd in (8, 10):
        mx = (1 << bd) - 1
        tabs = tb.device_tables(w, h, bd, "cuda")
        for B in (1, 37, 70):
            src = rng.integers(0, mx + 1, (B, h, w))
            cases = [(rng.integers(0, mx + 1, (B, h, w)), src),
                     (np.zeros((B, h, w)), np.full((B, h, w), mx))]
            if bd == 10:
                cases.append((np.zeros((B, h, w)), np.full((B, h, w), 4095)))
            extra = _t(rng.random(B).astype(np.float32) * 9, card)
            for pred, blk in cases:
                pred = _t(pred.astype(np.int32), card)
                blk = _t(blk.astype(np.int32), card)
                for qp in (22, 37):
                    ft = tb.frame_tables(qp, "cuda")
                    for intra in (False, True):
                        a = (pred, blk, qp + 6 * (bd - 8), 57.9, ft["wts"],
                             extra, tabs, bd, intra)
                        got = rd.rd_cost_pred(*a)
                        want = rd.rd_cost_pred_plain(*a)
                        assert got.dtype == want.dtype and torch.equal(got,
                                                                       want)
                        n["rd_cost_pred"] += 1
        # the reference-line kernel: planes narrower than the top line
        for W in (2 * w + 8, 2 * w + 7, 9 * w + 4):
            H = 2 * h + 3
            planes = _t(rng.integers(0, mx + 1, (2, H, W)).astype(np.int32),
                        card)
            other = _t(rng.integers(0, mx + 1, (2, H, W)).astype(np.int32),
                       card)
            grids = [(0, 0, w, h, -(-W // w), -(-H // h)),
                     (w // 2 + 1, 1, 2 * w, h, max(1, (W - w) // (2 * w)), 2),
                     (W - w, H - h, w, h, 1, 1)]
            for g in grids:
                for s, rs in ((planes[0], None), (planes, other)):
                    got = ib.refs_blocks_grid(s, w, h, g, rs)
                    want = ib.refs_blocks_grid_plain(s, w, h, g, rs)
                    for x_, y_ in zip(got, want):
                        assert x_.dtype == y_.dtype and torch.equal(x_, y_)
                    n["refs_blocks_grid"] += 1
            xs = np.array([0, W - w, 0, W - w, 1, 3, w + 2, W - w - 1, 5],
                          dtype=np.int32)
            ys = np.array([0, 0, H - h, H - h, 2, h + 1, 1, H - h - 1, 0],
                          dtype=np.int32)
            for sel in (slice(None), slice(5, 6)):
                got = ib.refs_blocks(planes[1], xs[sel], ys[sel], w, h)
                want = ib.refs_blocks_plain(planes[1], xs[sel], ys[sel], w, h)
                for x_, y_ in zip(got, want):
                    assert x_.dtype == y_.dtype and torch.equal(x_, y_)
                n["refs_blocks"] += 1
    flat = torch.zeros(4 * h * w + 1, dtype=torch.int32, device=card)
    blk = torch.zeros((4, h, w), dtype=torch.int32, device=card)
    ft = tb.frame_tables(22, "cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        rd.rd_cost_pred(flat[1:].view(4, h, w), blk, 22, 57.9, ft["wts"],
                        torch.zeros(4, device=card), tabs, 10)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == n


def _k12b_k5_cases():
    sizes = (4, 8, 16, 32, 64)
    return ([("k12b", w, h) for w in sizes for h in sizes]
            + [("k5", H, W) for (H, W) in ((16, 16), (32, 48), (80, 144),
                                           (480, 832), (1088, 1920))])


@pytest.mark.parametrize("kind,a,b", _k12b_k5_cases())
def test_redesigned_k12b_k5_equal_plain(card, kind, a, b):
    """K12b predict_modes (K2's descriptor route from angular.cuh, about
    4096 output ints a thread block, only the reference samples the modes
    reach) at every (w, h) in {4..64}^2, 8 and 10 bits, on the
    references of tests/test_torch_predict_desc.py, with refine-like lists,
    random lists with duplicates and lists with modes outside [2, 66];
    B = 6, 37 and 6240 (not multiples of the blocks a thread block holds).
    K5 pseudo_recon (four tiles a thread block, partial butterflies,
    shuffle DC sum) on 16x16 .. 1920x1088 planes (45 tiles at 144x80: a
    partial last thread block), 8 and 10 bits, qp_scaled 0, 22, 37 and the
    largest, random, all-max and checkerboard planes; it refuses a plane
    that is not 16-byte aligned. Every output equal, one launch each."""
    from test_torch_predict_desc import _refs
    n = {"predict_modes": 0, "pseudo_recon": 0}
    before = dict(kernels.LAUNCHES)
    rng = np.random.default_rng(a * 1000 + b)
    if kind == "k12b":
        w, h = a, b
        for bd in (8, 10):
            tabs = tb.device_tables(w, h, bd, "cuda")
            mx = (1 << bd) - 1
            for B in (6, 37, 6240):
                refs = (_refs(bd, w + h + bd).to(card) if B == 6 else _t(
                    rng.integers(0, mx + 1, (B, 780)).astype(np.int32),
                    card))
                a0 = rng.integers(1, 34, (B, 2)) * 2
                lists = [np.clip(np.stack([a0[:, 0] - 1, a0[:, 0] + 1,
                                           a0[:, 1] - 1, a0[:, 1] + 1], 1),
                                 2, 66),
                         rng.integers(2, 67, (B, 4)),
                         rng.integers(-3, 81, (B, 4))]
                lists[1][0] = (34, 34, 2, 66)
                lists[2][0] = (-1, 0, 1, 67)
                lists[2][-1] = (80, 80, 3, 3)
                for ml in lists:
                    m = _t(ml.astype(np.int32), card)
                    got = ib.predict_modes(refs, m, tabs)
                    want = ib.predict_modes_plain(refs, m, tabs)
                    assert got.dtype == want.dtype and torch.equal(got, want)
                    n["predict_modes"] += 1
    else:
        from uvg266_tpu_torch.ops import pseudo_recon as pr
        H, W = a, b
        for bd in (8, 10):
            mx = (1 << bd) - 1
            planes = [rng.integers(0, mx + 1, (H, W)), np.full((H, W), mx),
                      ((np.arange(H)[:, None] + np.arange(W)[None]) % 2) * mx]
            for p_ in planes:
                src = _t(p_.astype(np.int32), card)
                for qps in (0, 22, 37, 51 + 6 * (bd - 8)):
                    got = pr.pseudo_recon(src, qps, bd)
                    want = pr.pseudo_recon_plain(src, qps, bd)
                    assert got.dtype == want.dtype and torch.equal(got, want)
                    n["pseudo_recon"] += 1
        flat = torch.zeros(H * W + 1, dtype=torch.int32, device=card)
        with pytest.raises(ValueError, match="16-byte aligned"):
            pr.pseudo_recon(flat[1:].view(H, W), 27, 8)
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        k: v for k, v in n.items() if v}


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 16), (32, 16),
                                 (64, 64)])
def test_redesigned_k12c_stages_equal_plain(card, w, h):
    """K12c's two selection stages alone (a warp per block, the first
    minimum of the key (cost, index) by shuffles; stage 2 copies the winner
    as int4, h*w / 512 warps sharing a block above 512 samples) against
    rough_select_plain and rough_pick_plain on chip_smoke.py's crafted
    ties (rough_stage_cases: all SATDs equal, the minimum at each slot, i1
    and i2 tied, refine slots tied with stage-1 slots and with each other,
    refine lists at 2 and 66, random SATDs), with the real and flat mode
    bits, at B = 1, 37 and 6240; stage 2 on numbered predictions at the
    (w, h) of test_rough_kernels_equal_plain. Every output equal, one
    launch a stage; stage 2 refuses predictions that are not 16-byte
    aligned."""
    from chip_smoke import rough_stage_cases
    m1 = tb.rough_modes("cuda")
    bits = (tb.frame_tables(22, "cuda")["mode_bits"],
            torch.ones(67, device=card))
    n = 0
    before = dict(kernels.LAUNCHES)
    for B in (1, 37, 6240):
        p1 = torch.arange(B * 35 * h * w, dtype=torch.int32,
                          device=card).view(B, 35, h, w)
        p2 = -1 - torch.arange(B * 4 * h * w, dtype=torch.int32,
                               device=card).view(B, 4, h, w)
        for _tag, s1, s2, refine in rough_stage_cases(B, seed=B + w * h):
            s1, s2 = _t(s1, card), _t(s2, card)
            for mb in bits:
                got = rd.rough_select(s1, 57.9, mb, m1)
                want = rd.rough_select_plain(s1, 57.9, mb, m1)
                assert got.dtype == want.dtype and torch.equal(got, want)
                pk = (s1, s2, got if refine is None else _t(refine, card),
                      57.9, mb, m1, p1, p2)
                for a, b in zip(rd.rough_pick(*pk), rd.rough_pick_plain(*pk)):
                    assert a.dtype == b.dtype and torch.equal(a, b)
                n += 2
        del p1, p2
    flat = torch.zeros(35 * h * w + 1, dtype=torch.int32, device=card)
    s1 = torch.zeros((1, 35), dtype=torch.int32, device=card)
    s2 = torch.zeros((1, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rd.rough_pick(s1, s2, s2 + 2, 57.9, bits[0], m1,
                      flat[1:].view(1, 35, h, w),
                      torch.zeros((1, 4, h, w), dtype=torch.int32,
                                  device=card))
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {"rough_refine": n}


def _k13_k14_shapes():
    sizes = (4, 8, 16, 32, 64)
    return ([(w, h) for w in sizes for h in sizes]
            + [(1, 8), (8, 1), (2, 4), (64, 2), (2, 64), (1, 1), (2, 2)])


@pytest.mark.parametrize("w,h", _k13_k14_shapes())
def test_redesigned_k13_k14_equal_plain(card, w, h):
    """K13 (templates over (w, h) and the dimensions' kinds: DCT2 partial
    butterflies with constant coefficients, DST7 / DCT8 matrix passes, int16
    intermediates, the forward's kept outputs only, the inverse's shortcut
    where the coefficients are zero outside a 64-point dimension's kept
    half, and its full form where they are not; the generic instance at a
    dimension of 1 or 2) at every (w, h) in {4..64}^2 and at the generic
    shapes, 8 and 10 bits (10 only where a dimension is 1 or 2, as the
    reference allows), DCT2 and (up to 32 points) the MTS pairs, on
    residuals, int16-range inputs and the int32 extremes, with one block more
    than a thread block holds; K14 (eight elements a thread, int16 or int32
    read in place) on the coefficients as int16 and as int32, on views at
    an odd element offset, on element counts that are not multiples of 8,
    at every qp_scaled the encoder gives and both roundings. Every output
    equal, dtypes included, one launch a wrapper call; K13 refuses blocks
    that are not 16-byte aligned (wrapper and C entry)."""
    from uvg266_tpu_torch.ops import quant as q
    from uvg266_tpu_torch.ops import transforms as tr
    from uvg266_tpu_torch.ops.tr_matrices import (DCT2, DCT8, DST7,
                                                  device_matrix32)
    rng = np.random.default_rng(w * 131 + h)
    i32 = np.iinfo(np.int32)
    U = max(1, 2048 // (w * h))
    pairs = [(DCT2, DCT2)]
    if 4 <= min(w, h) and max(w, h) <= 32:
        pairs += [(DST7, DST7), (DCT8, DST7), (DST7, DCT8), (DCT8, DCT8),
                  (DCT2, DST7), (DCT8, DCT2)]
    bds = (10,) if min(w, h) < 4 else (8, 10)
    n = {"fwd_transform": 0, "inv_transform": 0, "quant_levels": 0,
         "dequant_levels": 0}

    def at_offset(t, o):               # 2 to 8 bytes off the alignment
        flat = torch.empty(t.numel() + o, dtype=t.dtype, device=card)
        view = flat[o:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16
        return view

    before = dict(kernels.LAUNCHES)
    for bd in bds:
        mx = (1 << bd) - 1
        x = np.concatenate([
            rng.integers(-mx, mx + 1, (U + 1, h, w)),
            rng.integers(-32768, 32768, (2, h, w)),
            rng.integers(i32.min, i32.max, (1, h, w), dtype=np.int64,
                         endpoint=True),
            np.full((1, h, w), i32.max), np.full((1, h, w), i32.min),
            np.where(rng.random((1, h, w)) < 0.5, i32.max, i32.min)])
        x = _t(x.astype(np.int32), card)
        for th, tv in pairs:
            c = tr.fwd_batch(x, th, tv, bd)
            assert c.dtype == torch.int16
            assert torch.equal(c, tr.fwd_batch_plain(x, th, tv, bd))
            # the forward's output (zero outside what a 64-point dimension
            # keeps: the inverse's shortcut), one such block with a nonzero
            # there, the inputs themselves
            odd = c[:1].to(torch.int32)
            odd[0, -1, -1] = 7
            cc = torch.cat([c.to(torch.int32), odd, x])
            got = tr.inv_batch(cc, th, tv, bd)
            assert got.dtype == torch.int16
            assert torch.equal(got, tr.inv_batch_plain(cc, th, tv, bd))
            n["fwd_transform"] += 1
            n["inv_transform"] += 1
        # K14: the coefficients as int16 (read in place) and int32, views
        # at an odd element offset, an element count not a multiple of 8
        c16 = tr.fwd_batch(x, DCT2, DCT2, bd)
        n["fwd_transform"] += 1
        lv = torch.cat([c16.to(torch.int32), x])
        inputs = ([c16, lv] + [at_offset(c16, o) for o in (1, 2, 4)]
                  + [at_offset(lv, o) for o in (1, 2)])
        if bd == 10:      # 14 elements (8 bits has no such block shape)
            odd = lv.reshape(-1)[:14].view(7, 2, 1)
            inputs += [odd, odd.to(torch.int16)]
        for qp in range(52 if bd == 8 else 64):
            for v in inputs:
                for intra in (True, False):
                    a = q.quant_batch(v, qp, bd, intra)
                    assert a.dtype == torch.int32
                    assert torch.equal(a, q.quant_batch_plain(v, qp, bd,
                                                              intra))
                    n["quant_levels"] += 1
                a = q.dequant_batch(v, qp, bd)
                assert a.dtype == torch.int32
                assert torch.equal(a, q.dequant_batch_plain(v, qp, bd))
                n["dequant_levels"] += 1
    # K13 refuses blocks that are not 16-byte aligned
    flat = torch.zeros(2 * h * w + 4, dtype=torch.int32, device=card)
    mis = flat[1:1 + 2 * h * w].view(2, h, w)
    for fn in (tr.fwd_batch, tr.inv_batch):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(mis, DCT2, DCT2, 10)
    out = torch.empty((2, h, w), dtype=torch.int16, device=card)
    s1, s2 = tr.fwd_shifts(w, h, 10)
    kw, kh = tr.zero_out(w, DCT2, DCT2, h)
    m = [device_matrix32(DCT2, k, "cuda").data_ptr() for k in (w, h)]
    with pytest.raises(RuntimeError, match="fwd_transform"):
        kernels.launch("fwd_transform", card, mis.data_ptr(), 2, w, h, DCT2,
                       DCT2, *m, s1, s2, kw, kh, out.data_ptr())
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == n


def _mesh_planes(n, h, w, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        y = np.clip((xx * 2 + yy + i * 17) % 255
                    + rng.integers(-20, 21, (h, w)), 0, 255).astype(np.int32)
        out.append((y, (y[::2, ::2] // 2 + 40).astype(np.int32),
                    (y[::2, ::2] // 3 + 60).astype(np.int32)))
    return out


def test_group_dispatch_batched_on_card(card):
    """The gop mesh's batched call on the card, slots at two QPs: each
    slot's row equals its own call on the card and on the CPU; K1, K2 and
    K3 launch once per class for all slots, K4 and K5 once per QP group."""
    import threading

    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import (Encoder,
                                                  _get_pframe_intra_combo_fn)
    from uvg266_tpu_torch.control.partition import (PartitionSearch,
                                                    qp_to_lambda)
    from uvg266_tpu_torch.parallel import build_gop_mesh
    from uvg266_tpu_torch.parallel.mesh import _MeshGroupDispatch
    W, H = 160, 96
    cfg = Config(width=W, height=H, qp=27, gop_len=4, gop_lowdelay=True,
                 intra_period=64, rdoq_enable=False, wpp=False)
    enc = Encoder(cfg, device=card)
    entries = enc.slice_enc._fused_entries(
        PartitionSearch(enc.ctrl, cfg, qp=27, is_intra=False))
    classes = tuple((w, h, g) for (_k, w, h, _p, g) in entries)
    key = ("pframe_intra", classes, H, W, 8)
    qps = [27, 32, 27, 32]
    planes = [p[0] for p in _mesh_planes(4, H, W, 3)]
    args = [(p, enc.ctrl.luma_qp_scaled(q),
             float(np.float32(qp_to_lambda(q, False))), q)
            for p, q in zip(planes, qps)]
    disp = _MeshGroupDispatch(build_gop_mesh(4, device=card), 4)
    res = [None] * 4

    def work(s):
        res[s] = disp.run(s, key, args[s], lambda: pytest.fail("fell back"))
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    threads = [threading.Thread(target=work, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    n = len(classes)
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before
            if kernels.LAUNCHES[k] != before[k]} == {
        "refs_blocks_grid": n, "predict67": n, "satd67": n,
        "rd_cost": 2 * n, "pseudo_recon": 2}
    assert disp.n_batched == 1 and disp.n_fallback == 0
    for s in range(4):
        for dev in (card, torch.device("cpu")):
            ft = tb.frame_tables(qps[s], str(dev))
            one = _get_pframe_intra_combo_fn(classes, H, W, 8)(
                torch.from_numpy(planes[s]).to(dev), args[s][1], args[s][2],
                ft["wts"], ft["mode_bits"]).cpu().numpy()
            assert np.array_equal(res[s], one), (s, dev)


@pytest.mark.parametrize("tools", [{}, {"intra_rough": True},
                                   {"mip": True}],
                         ids=["plain", "rough", "mip"])
def test_mesh_encoder_on_card(card, tools):
    """MeshEncoder on a (2, 4) mesh on the card: AUs and recons equal the
    plain Encoder's on the card and the CPU mesh's."""
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes
    from uvg266_tpu_torch.parallel import MeshEncoder, build_mesh
    kw = dict(width=256, height=128, qp=32, gop_len=0, intra_period=1,
              tiles_width_count=2, tiles_height_count=2, wpp=False, **tools)
    frames = [FramePlanes(*f) for f in _mesh_planes(3, 128, 256, 4)]
    got = MeshEncoder(Config(**kw), build_mesh(8, device=card)).encode(frames)
    cpu = MeshEncoder(Config(**kw), build_mesh(8, device="cpu")).encode(frames)
    enc = Encoder(Config(**kw), device=card)
    ref = [o[:2] for f in frames for o in enc.feed(f)]
    ref += [o[:2] for o in enc.flush()]
    for (au_m, rec_m), (au_c, _rc), (au_p, rec_p) in zip(got, cpu, ref):
        assert au_m == au_p == au_c
        assert np.array_equal(rec_m.y, rec_p.y)


def test_gop_mesh_on_card(card):
    """MeshGopEncoder (LD, G = 2, L = 3) on the card: every step batched,
    each run's AUs equal a plain Encoder's on the card."""
    from uvg266_tpu_torch.cfg import Config
    from uvg266_tpu_torch.control.encoder import Encoder, FramePlanes
    from uvg266_tpu_torch.parallel import MeshGopEncoder, build_gop_mesh
    kw = dict(width=128, height=80, qp=30, gop_len=4, gop_lowdelay=True,
              intra_period=64, ref_frames=1, rdoq_enable=False, wpp=False)
    frames = [FramePlanes(*f) for f in _mesh_planes(6, 80, 128, 5)]
    m = MeshGopEncoder(Config(**kw), build_gop_mesh(2, device=card))
    res = m.encode(frames)
    assert m.disp.n_batched == 3 and m.disp.n_fallback == 0
    for g in range(2):
        enc = Encoder(Config(**kw), device=card)
        ref = [o[0] for f in frames[3 * g:3 * g + 3] for o in enc.feed(f)]
        ref += [o[0] for o in enc.flush()]
        assert [o[0] for o in res[g]] == ref

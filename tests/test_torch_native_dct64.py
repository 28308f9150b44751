"""The port's host C++ at 64x64: the rd round trip of the host intra screen
(native/inter.cpp fi_host_screen) and of the host ME (fi_me_frame's
rd_cost_pred) on 64x64 blocks, held exactly against K6's plain version
(ops/rd_cost.py rd_cost_pred_plain and its RD tail).

Both C++ paths call rcn::rd_roundtrip (native/recon.cpp), which takes the
DCT2 matrix of the block's width from g_dct2. The table holds sizes 4 to 64;
the 64-point matrix is what make_rd_cost_pred_fn(64, 64) of the reference
multiplies by (a full DCT2, no zero-out).

The C++ assembles a cost in double from the integer SSD and a double sum of
the float32 bucket weights (exact: a few thousand float32 weights of one
binade sum without rounding in 53 bits), then rounds once to float32. The
test takes the SSD and the quantised levels from K6's plain RD tail and
assembles the cost the same way, so the two agree bit for bit; K6's own
float32 rd agrees with it to the rounding of its float32 sums.
"""
import numpy as np
import torch

from uvg266_tpu_torch.native import host_screen_native, me_frame_native
from uvg266_tpu_torch.ops.fast_cost_tables import FAST_COEFF_WTS
from uvg266_tpu_torch.ops.intra import build_reference, predict_intra
from uvg266_tpu_torch.ops.me import mv_bits_est
from uvg266_tpu_torch.ops.pseudo_recon import pseudo_recon_plane
from uvg266_tpu_torch.ops.rd_cost import (_rd_tail_plain, quant_consts,
                                          rd_cost_pred_plain)
from uvg266_tpu_torch.ops.tables import MODE_BITS, device_tables


def _plane(rng, n, bd, t=0):
    """A smooth textured n x n plane with noise, at ``bd`` bits."""
    yy, xx = np.mgrid[0:n, 0:n]
    mx = (1 << bd) - 1
    y = ((0.45 + 0.2 * np.sin((xx + 3 * t) / 11.0) * np.cos(yy / 7.0)) * mx
         + rng.integers(-mx // 40, mx // 40 + 1, (n, n)))
    return np.clip(y, 0, mx).astype(np.int32)


def _k6_terms(pred, blk, qp, bd, wts, is_intra_slice):
    """(ssd int, bits as the exact float64 sum of the bucket weights, K6's
    float32 rd at lam 1 with no extra bits) of one 64x64 block."""
    tabs = device_tables(64, 64, bd, "cpu")
    c = quant_consts(64, 64, bd, qp, is_intra_slice)
    p = torch.from_numpy(pred)[None].long()
    s = torch.from_numpy(blk)[None].long()
    _bits, ssd, level = _rd_tail_plain(p, s, c, 64, 64, bd,
                                       torch.from_numpy(wts), tabs["mat_w"],
                                       tabs["mat_h"])
    cnt = np.bincount(level.clamp(max=3).reshape(-1).numpy(), minlength=4)
    bits = float(sum(int(cnt[k]) * float(wts[k]) for k in range(4)))
    return int(ssd.item()), bits


def _case(bd, qp):
    wts = np.ascontiguousarray(FAST_COEFF_WTS[min(qp, len(FAST_COEFF_WTS) - 1)],
                               dtype=np.float32)
    return wts, qp + 6 * (bd - 8)


def test_host_screen_64x64_equals_k6_plain():
    """fi_host_screen at 64x64 (is_intra_slice): every block's cost is the
    RD tail of K6's plain version on the screen's winning prediction."""
    rng = np.random.default_rng(64)
    for bd, qp, n in ((8, 27, 128), (10, 32, 64)):
        wts, qps = _case(bd, qp)
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        src = _plane(rng, n, bd)
        g = n // 64
        out = host_screen_native(src, qps, bd, lam, wts, MODE_BITS,
                                 [(64, 64, 0, 0, 64, 64, g, g)])
        pseudo = pseudo_recon_plane(src, qps, bd)
        mask = np.ones((n // 4, n // 4), dtype=np.uint8)
        for k in range(g * g):
            x, y = 64 * (k % g), 64 * (k // g)
            mode = int(out[k])
            refs = build_reference(pseudo, mask, x, y, 64, 64, n, n, bd)
            pred = np.ascontiguousarray(
                predict_intra(mode, 64, 64, refs, bd), dtype=np.int32)
            blk = np.ascontiguousarray(src[y:y + 64, x:x + 64])
            ssd, bits = _k6_terms(pred, blk, qps, bd, wts, True)
            want = np.float32(ssd + lam * (bits + float(MODE_BITS[mode])))
            assert np.float32(out[g * g + k]) == want, (bd, k, mode)
            # K6's float32 rd on the same prediction, to its rounding
            rd = rd_cost_pred_plain(
                torch.from_numpy(pred)[None], torch.from_numpy(blk)[None],
                qps, lam, torch.from_numpy(wts),
                torch.tensor([MODE_BITS[mode]], dtype=torch.float32),
                device_tables(64, 64, bd, "cpu"), bd, is_intra_slice=True)
            np.testing.assert_allclose(rd.item(), want, rtol=4096 * 2.0 ** -24)


class _Plane:
    def __init__(self, y):
        self.y = y


def test_me_frame_64x64_equals_k6_plain():
    """fi_me_frame at 64x64 (one block per class grid, so no merge trials):
    the cost of each block's MV is rd_cost_pred of the edge-clamped
    reference block there, with the MV's bits as extra bits."""
    rng = np.random.default_rng(65)
    for bd, qp in ((8, 27), (10, 32)):
        wts, qps = _case(bd, qp)
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        n = 64
        src = _plane(rng, n, bd, t=1)
        ref = _plane(rng, n, bd, t=0)
        mvs, costs = me_frame_native(src, [(0, _Plane(ref))], None, qps, bd,
                                     lam, 8, wts,
                                     [(64, 64, 0, 0, 64, 64, 1, 1)])
        mvx, mvy = int(mvs[0, 0, 0]), int(mvs[0, 0, 1])
        ry = np.clip(np.arange(64) + mvy, 0, n - 1)
        rx = np.clip(np.arange(64) + mvx, 0, n - 1)
        pred = np.ascontiguousarray(ref[ry[:, None], rx[None, :]])
        ssd, bits = _k6_terms(pred, src, qps, bd, wts, False)
        extra = mv_bits_est(4 * mvx) + mv_bits_est(4 * mvy) + 4.0
        lam32 = float(np.float32(lam))
        want = np.float32(float(np.float32(ssd)) + lam32 * (bits + extra))
        assert costs[0, 0] == want, (bd, mvx, mvy)

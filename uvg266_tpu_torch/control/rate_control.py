"""Rate control: R-lambda and OBA models, frame- and LCU-level.

R-lambda (the reference's classic path, rate_control.c:
uvg_set_picture_lambda_and_qp:1027, update_parameters):
  lambda = alpha * bpp^beta, qp = 4.2005*ln(lambda) + 13.7122
with multiplicative alpha / additive beta adaptation and a smoothing
window for buffer feedback.

OBA (optimal bit allocation, rate_control.c:492-870): per-layer C/K
distortion model D = C*bpp^K, lambda = -C*K*bpp^(K-1), updated from the
realized (bpp, distortion, lambda) of each picture
(update_pic_ck:846) with the reference's clip chains against previous
lambdas.

Per-LCU allocation (uvg_set_lcu_lambda_and_qp rate_control.c:1097 +
lcu_allocate_bits:1077): the picture target is split by CTU weights
(previous frame's realized per-CTU bit shares), each CTU's lambda comes
from the same R-lambda model, and the QP is signaled via cu_qp_delta
(QG = CTU).
"""
from __future__ import annotations

import math

import numpy as np

from ..gop import get_gop_config

SMOOTHING_WINDOW = 40
MIN_LAMBDA = 0.1
MAX_LAMBDA = 10000.0


def lambda_to_qp(lam: float) -> int:
    return max(0, min(51, int(round(4.2005 * math.log(lam) + 13.7122))))


class RateControl:
    def __init__(self, cfg, ctrl):
        self.cfg = cfg
        self.ctrl = ctrl
        self.enabled = cfg.target_bitrate > 0
        if not self.enabled:
            return
        self.pels = ctrl.in_width * ctrl.in_height
        fps = cfg.framerate_num / max(1, cfg.framerate_denom)
        self.bits_per_pic = cfg.target_bitrate / fps
        # R-lambda model state per layer (0 = intra)
        self.alpha = {i: 3.2003 for i in range(8)}
        self.beta = {i: -1.367 for i in range(8)}
        self.bits_budget = 0.0       # rolling over/under-spend
        self.frames_coded = 0
        gop = get_gop_config(cfg)
        if gop:
            self.weights = {e.poc_offset: 1.0 / (1 + 0.5 * (e.layer - 1))
                            for e in gop}
            self.avg_weight = sum(self.weights.values()) / len(self.weights)
        else:
            self.weights = {}
            self.avg_weight = 1.0
        self.last_qp = cfg.qp
        # OBA state (rc_algorithm == "oba")
        self.oba = getattr(cfg, "rc_algorithm", "lambda") == "oba"
        self.pic_c = [0.0] * 8
        self.pic_k = [0.0] * 8
        self.prev_lambda_layer = [0.0] * 8
        self.prev_frame_lambda = 0.0
        # per-LCU state (rate_control.c lcu_stats weights)
        self.prev_ctu_bits = None

    def pick_qp(self, fs, gop_pos: int | None) -> tuple[int, float]:
        """Per-picture lambda/QP (uvg_set_picture_lambda_and_qp)."""
        if not self.enabled:
            return fs.qp, 0.0
        # smoothed per-picture target with buffer feedback
        target = self.bits_per_pic - self.bits_budget / 8.0
        if fs.slicetype == 2:    # intra pictures get a larger share
            target *= 3.0 if self.cfg.gop_len else 1.0
            layer = 0
        else:
            w = self.weights.get(gop_pos, 1.0) if gop_pos is not None else 1.0
            target *= w / max(self.avg_weight, 1e-9)
            layer = 1
        target = max(target, self.bits_per_pic * 0.1)
        bpp = target / self.pels
        if self.oba and self.pic_c[layer] != 0.0:
            # D = C*bpp^K  ->  lambda = -C*K*bpp^(K-1)
            a = -self.pic_c[layer] * self.pic_k[layer]
            b = self.pic_k[layer] - 1.0
            lam = a * bpp ** b
            if fs.slicetype == 2:
                lam *= 0.5      # rate_control.c:532 intra reduction
            # clip chains against previous lambdas (rate_control.c:540-553)
            pl = self.prev_lambda_layer[layer]
            if pl > 0.0:
                pl = max(0.1, min(10000.0, pl))
                lam = max(pl * 0.5, min(pl * 2.0, lam))
            pf = self.prev_frame_lambda
            if pf > 0.0:
                pf = max(0.1, min(2000.0, pf))
                lam = max(pf * 2.0 ** (-10.0 / 3.0),
                          min(pf * 2.0 ** (10.0 / 3.0), lam))
        else:
            lam = self.alpha[layer] * bpp ** self.beta[layer]
        lam = max(MIN_LAMBDA, min(MAX_LAMBDA, lam))
        qp = lambda_to_qp(lam)
        qp = max(self.last_qp - 10, min(self.last_qp + 10, qp))
        self.last_qp = qp
        self._pending = (layer, lam, target)
        return qp, lam

    def pick_ctu_qps(self, fs, n_ctu: int):
        """Per-LCU QPs for the picture (uvg_set_lcu_lambda_and_qp,
        rate_control.c:1097): allocate the picture target bits by the
        previous frame's per-CTU bit shares (lcu_allocate_bits:1077),
        map each CTU's bpp through the layer R-lambda model, clip to
        frame QP +-3 (keeps cu_qp_delta cheap). None until feedback
        exists (first frames use the uniform frame QP)."""
        if not self.enabled:
            return None
        layer, _lam, target = self._pending
        prev = self.prev_ctu_bits
        if prev is None or len(prev) != n_ctu or float(prev.sum()) <= 0:
            return None
        w = prev.astype(np.float64) / float(prev.sum())
        bits_i = np.maximum(target * w, 1.0)
        bpp = bits_i / max(1.0, self.pels / n_ctu)
        lam_i = np.clip(self.alpha[layer] * bpp ** self.beta[layer],
                        MIN_LAMBDA, MAX_LAMBDA)
        qp_i = np.round(4.2005 * np.log(lam_i) + 13.7122).astype(np.int32)
        qp_i = np.clip(qp_i, fs.qp - 3, fs.qp + 3)
        return np.clip(qp_i, 0, 51).astype(np.int32)

    def update(self, fs, actual_bits: int,
               distortion: float | None = None) -> None:
        """Model adaptation after a picture (uvg_update_after_picture).

        distortion: mean luma SSD per pixel (the OBA C/K update input;
        any consistent measure works, update_pic_ck:846)."""
        if not self.enabled:
            return
        ctu_bits = getattr(fs, "ctu_bits", None)
        if ctu_bits is not None:
            self.prev_ctu_bits = np.asarray(ctu_bits, dtype=np.float64)
        layer, lam_used, target = self._pending
        if self.oba and distortion is not None and distortion > 0:
            bpp = max(actual_bits / self.pels, 1e-7)
            new_k = -bpp * lam_used / distortion
            new_k = max(-3.0, min(-0.001, new_k))
            new_c = distortion / bpp ** new_k
            new_c = max(0.1, min(100.0, new_c))
            if fs.slicetype == 2 or self.frames_coded <= 4:
                for i in range(8):
                    self.pic_c[i] = new_c
                    self.pic_k[i] = new_k
            else:
                self.pic_c[layer] = new_c
                self.pic_k[layer] = new_k
            self.prev_lambda_layer[layer] = lam_used
            self.prev_frame_lambda = lam_used
        self.bits_budget += actual_bits - self.bits_per_pic
        bpp = max(actual_bits / self.pels, 1e-7)
        lam_model = self.alpha[layer] * bpp ** self.beta[layer]
        lam_model = max(MIN_LAMBDA, min(MAX_LAMBDA, lam_model))
        ln_diff = max(-2.0, min(2.0,
                                math.log(lam_used) - math.log(lam_model)))
        self.alpha[layer] *= math.exp(0.25 * ln_diff)
        self.alpha[layer] = max(0.05, min(500.0, self.alpha[layer]))
        self.beta[layer] += 0.10 * ln_diff * max(-5.0, math.log(bpp))
        self.beta[layer] = max(-3.0, min(-0.1, self.beta[layer]))
        self.frames_coded += 1

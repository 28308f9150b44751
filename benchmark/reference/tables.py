"""The fixed tables of the all-intra and P-frame intra search, frozen.

Copied from the PyTorch/CUDA port (``uvg266_tpu_torch/ops/intra.py``,
``ops/tr_matrices.py``, ``ops/quant.py``, ``ops/tables.py``,
``ops/fast_cost_tables.py``, ``control/partition.py`` and ``gop.py``) as
they stood when the benchmark was written, so that the benchmark's
reference does not move when the program does. Each is a table of the
standard or of the encoder's cost model: the angular prediction
constants, the DCT-II matrices, the quantiser scales, the per-QP
coefficient-cost weights, the per-mode signalling bits, the split-flag
bits of the partition DP and the low-delay GOP-4 QP offsets.
"""
from __future__ import annotations

import functools

import numpy as np

# ops/intra.py
MODEDISP2SAMPLEDISP = np.array(
    [0, 1, 2, 3, 4, 6, 8, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32, 35, 39, 45,
     51, 57, 64, 73, 86, 102, 128, 171, 256, 341, 512, 1024], dtype=np.int32)
MODEDISP2INVSAMPLEDISP = np.array(
    [0, 16384, 8192, 5461, 4096, 2731, 2048, 1638, 1365, 1170, 1024, 910, 819,
     712, 630, 565, 512, 468, 420, 364, 321, 287, 256, 224, 191, 161, 128, 96,
     64, 48, 32, 16], dtype=np.int32)
PRE_SCALE = np.array(
    [8, 7, 6, 5, 5, 4, 4, 4, 3, 3, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1,
     1, 0, 0, 0, -1, -1, -2, -3], dtype=np.int32)
CUBIC_FILTER = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
], dtype=np.int32)
HOR_VER_DIST_THRES = [24, 24, 24, 14, 2, 0, 0, 0]

# ops/tr_matrices.py: odd-frequency basis amplitudes of the DCT-II
DCT2_ODD = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
    64: [91, 90, 90, 90, 88, 87, 86, 84, 83, 81, 79, 77, 73, 71, 69, 65, 62,
         59, 56, 52, 48, 44, 41, 37, 33, 28, 24, 20, 15, 11, 7, 2],
}

# ops/quant.py
QUANT_SCALES = np.array([
    [26214, 23302, 20560, 18396, 16384, 14564],
    [18396, 16384, 14564, 13107, 11651, 10280],
], dtype=np.int64)
INV_QUANT_SCALES = np.array([
    [40, 45, 51, 57, 64, 72],
    [57, 64, 72, 80, 90, 102],
], dtype=np.int64)

# ops/tables.py: per-mode signalling bits of the mode preselection
MODE_BITS = np.full(67, 5.0, dtype=np.float32)
MODE_BITS[0] = 1.5
MODE_BITS[1] = 3.0

# control/partition.py: split-flag bits of the QT DP; the CTU size
SPLIT_BITS_EST = 1.5
LCU = 64
INF = np.float64(1e30)

# gop.py LOWDELAY4 (uvg266 gop.h uvg_gop_lowdelay4): per position of the
# GOP, (qp_offset, qp_model_offset, qp_model_scale)
LOWDELAY4_QP = ((5, -6.5, 0.2590), (4, -6.5, 0.2590), (5, -6.5, 0.2590),
                (1, 0.0, 0.0))

# ops/fast_cost_tables.py: per-QP weights of the coefficient-cost model
# (bits ~ sum of wts[min(|level|, 3)])
FAST_COEFF_WTS = np.array([
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.164240, 4.161530, 3.509033, 6.928047],
    [0.162844, 4.055940, 3.564467, 6.861493],
    [0.128729, 4.311973, 3.942837, 6.935403],
    [0.110956, 4.433190, 3.945753, 6.877697],
    [0.095026, 4.483547, 4.194173, 6.781540],
    [0.075046, 4.633703, 4.084193, 6.698600],
    [0.052426, 4.967223, 4.027210, 6.549197],
    [0.040219, 5.141820, 3.982650, 6.461557],
    [0.035090, 5.192493, 3.830950, 6.418477],
    [0.029845, 5.211647, 3.815457, 6.345440],
    [0.023522, 5.322213, 3.816537, 6.360677],
    [0.021305, 5.225923, 3.842700, 6.325787],
    [0.015878, 5.183090, 3.956003, 6.329680],
    [0.010430, 5.099230, 4.176803, 6.305400],
    [0.008433, 5.030257, 4.237587, 6.270133],
    [0.006500, 4.969247, 4.339397, 6.217827],
    [0.004929, 4.923500, 4.442413, 6.183523],
    [0.003715, 4.915583, 4.429090, 6.125320],
    [0.003089, 4.883907, 4.562790, 6.156447],
    [0.002466, 4.881063, 4.629883, 6.142643],
    [0.002169, 4.882493, 4.646313, 6.127663],
    [0.002546, 4.793337, 4.837413, 6.199270],
    [0.001314, 4.808853, 4.828337, 6.243437],
    [0.001154, 4.862603, 4.846883, 6.205523],
    [0.000984, 4.866403, 4.859330, 6.240893],
    [0.000813, 4.856633, 4.924527, 6.293413],
    [0.001112, 4.789260, 5.009880, 6.433540],
    [0.000552, 4.760747, 5.090447, 6.599380],
    [0.000391, 4.961447, 5.111033, 6.756370],
    [0.000332, 4.980953, 5.138127, 6.867420],
    [0.000201, 5.181957, 4.740160, 6.460997],
    [0.000240, 5.185390, 4.874840, 6.819093],
    [0.000130, 5.270350, 4.734213, 6.826240],
    [0.000104, 5.371937, 4.595087, 6.659253],
    [0.000083, 5.362000, 4.617470, 6.837770],
    [0.000069, 5.285997, 4.754993, 7.159043],
    [0.000049, 5.488470, 4.396107, 6.727357],
    [0.000058, 4.958940, 4.580460, 6.477740],
    [0.000028, 5.521253, 4.440493, 7.205017],
    [0.000000, 0.000000, 0.000000, 0.000000],
    [0.000019, 5.811260, 4.399110, 7.336310],
], dtype=np.float32)


def wide_angle_correction(mode: int, log2_w: int, log2_h: int,
                          account_for_dc_planar: bool = False) -> int:
    pred_mode = mode
    if log2_w != log2_h and 1 < mode <= 66:
        mode_shift = [0, 6, 10, 12, 14, 15]
        delta = abs(log2_w - log2_h)
        if log2_w > log2_h and mode < 2 + mode_shift[delta]:
            pred_mode += 65
        elif log2_h > log2_w and mode > 66 - mode_shift[delta]:
            pred_mode -= 65 + (2 if account_for_dc_planar else 0)
    return pred_mode


def _dct2_value(a: int, n: int) -> int:
    """Value of S*cos(a*pi/(2n)) on the integer amplitude grid, a in [0, n]."""
    if a == 0:
        return 64
    if a & 1:
        return DCT2_ODD[n][(a - 1) >> 1]
    return _dct2_value(a >> 1, n >> 1)


@functools.lru_cache(maxsize=None)
def dct2_matrix(n: int) -> np.ndarray:
    """Forward DCT-II matrix, rows = frequencies: M[k][j] ~ S*cos((2j+1)k*pi/2n)."""
    if n == 1:
        # 1-point transform (ISP 1xN sub-TUs): pure 64x scaling
        return np.array([[64]], dtype=np.int32)
    m = np.zeros((n, n), dtype=np.int32)
    for k in range(n):
        for j in range(n):
            x = ((2 * j + 1) * k) % (4 * n)
            if x > 2 * n:
                x = 4 * n - x
            sign = 1
            if x > n:
                sign = -1
                x = 2 * n - x
            m[k, j] = sign * _dct2_value(x, n)
    return m


def qp_to_lambda(qp: int) -> float:
    """Frame lambda, 0.57 * 2^((qp - 12) / 3) (control/partition.py)."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def lowdelay4_qp(base_qp: int, poc: int) -> int:
    """QP of the P frame at ``poc`` (>= 1) of the low-delay GOP 4 with four
    references (gop.py frame_qp over LOWDELAY4)."""
    off, m_off, m_scale = LOWDELAY4_QP[(poc - 1) % 4]
    qp = float(base_qp + off)
    qp += min(max(qp * m_scale + m_off, 0.0), 3.0)
    return min(max(int(qp + 0.5), 0), 51)

"""VVC CABAC context model initialization values.

These are the VVC standard's context init constants (per slice type B/P/I plus
a window-size row), shared by VTM and the reference encoder
(uvg266 src/context.c:39-453).  Row layout of every table:
row 0 = B slice, row 1 = P slice, row 2 = I slice, row 3 = log2 window sizes.

The context *set* layout (family names and counts) mirrors the reference's
cabac ctx struct (uvg266 src/cabac.h:67-130) so that syntax-writing
code can be checked against it family by family.
"""
from __future__ import annotations

import math

import numpy as np

CNU = 35  # "context not used" default init
DWS = 8   # default window size

# --- init tables (VVC spec constants) --------------------------------------

INIT_SPLIT_FLAG = [
    [18, 27, 15, 18, 28, 45, 26, 7, 23],
    [11, 35, 53, 12, 6, 30, 13, 15, 31],
    [19, 28, 38, 27, 29, 38, 20, 30, 31],
    [12, 13, 8, 8, 13, 12, 5, 9, 9],
]
INIT_QT_SPLIT_FLAG = [
    [26, 36, 38, 18, 34, 21],
    [20, 14, 23, 18, 19, 6],
    [27, 6, 15, 25, 19, 37],
    [0, 8, 8, 12, 12, 8],
]
INIT_VERTICAL_SPLIT_FLAG = [
    [43, 42, 37, 42, 44],
    [43, 35, 37, 34, 52],
    [43, 42, 29, 27, 44],
    [9, 8, 9, 8, 5],
]
INIT_BINARY_SPLIT_FLAG = [
    [28, 29, 28, 29],
    [43, 37, 21, 22],
    [36, 45, 36, 45],
    [12, 13, 12, 13],
]
INIT_NON_INTER_FLAG = [
    [25, 20],
    [25, 12],
    [CNU, CNU],
    [1, 0],
]
INIT_SKIP_FLAG = [
    [57, 60, 46],
    [57, 59, 45],
    [0, 26, 28],
    [5, 4, 8],
]
INIT_MERGE_FLAG_EXT = [[6], [21], [26], [4]]
INIT_MERGE_IDX_EXT = [[18], [20], [34], [4]]
INIT_PART_SIZE = [[CNU] * 4, [CNU] * 4, [CNU] * 4, [DWS] * 4]
INIT_PRED_MODE = [
    [40, 35],
    [40, 35],
    [CNU, CNU],
    [5, 1],
]
MULTI_REF_LINE_MODE = [
    [25, 59],
    [25, 58],
    [25, 60],
    [5, 8],
]
MIP_FLAG = [
    [56, 57, 50, 26],
    [41, 57, 58, 26],
    [33, 49, 50, 25],
    [9, 10, 9, 6],
]
INIT_INTRA_LUMA_MPM_FLAG = [44, 36, 45, 6]
INIT_INTRA_LUMA_PLANAR_MODE = [
    [13, 6],
    [12, 20],
    [13, 28],
    [1, 5],
]
INIT_CHROMA_PRED_MODE = [25, 25, 34, 5]
INIT_CU_QP_DELTA_ABS = [[CNU, CNU], [CNU, CNU], [CNU, CNU], [DWS, DWS]]
INIT_INTER_DIR = [
    [14, 13, 5, 4, 3, 40],
    [7, 6, 5, 12, 4, 40],
    [CNU] * 6,
    [0, 0, 1, 4, 4, 0],
]
INIT_REF_PIC = [
    [5, 35],
    [20, 35],
    [CNU, CNU],
    [0, 4],
]
INIT_MVD = [
    [51, 36],
    [44, 43],
    [14, 45],
    [9, 5],
]
INIT_QT_ROOT_CBF = [[12], [5], [6], [4]]
INIT_QT_CBF = [
    [15, 6, 5, 14, 25, 37, 9, 36, 45],
    [23, 5, 20, 7, 25, 28, 25, 29, 45],
    [15, 12, 5, 7, 12, 21, 33, 28, 36],
    [5, 1, 8, 9, 5, 0, 2, 1, 0],
]
BDPCM_MODE_INIT = [
    [19, 21, 0, 28],
    [40, 36, 0, 13],
    [19, 35, 1, 27],
    [1, 4, 1, 0],
]
INIT_SIG_COEFF_GROUP = [
    [25, 45, 25, 14],
    [25, 30, 25, 45],
    [18, 31, 25, 15],
    [8, 5, 5, 8],
]
# INIT_SIG_FLAG[set][slice][i]; sets 0,2,4 are luma (12 ctx), 1,3,5 chroma (8)
INIT_SIG_FLAG = [
    [
        [17, 41, 49, 36, 1, 49, 50, 37, 48, 51, 58, 45],
        [17, 41, 42, 29, 25, 49, 43, 37, 33, 58, 51, 30],
        [25, 19, 28, 14, 25, 20, 29, 30, 19, 37, 30, 38],
        [12, 9, 9, 10, 9, 9, 9, 10, 8, 8, 8, 10],
    ],
    [
        [9, 49, 50, 36, 48, 59, 59, 38],
        [17, 34, 35, 21, 41, 59, 60, 38],
        [25, 27, 28, 37, 34, 53, 53, 46],
        [12, 12, 9, 13, 4, 5, 8, 9],
    ],
    [
        [26, 45, 53, 46, 49, 54, 61, 39, 35, 39, 39, 39],
        [19, 38, 38, 46, 34, 54, 54, 39, 6, 39, 39, 39],
        [11, 38, 46, 54, 27, 39, 39, 39, 44, 39, 39, 39],
        [9, 13, 8, 8, 8, 8, 8, 5, 8, 0, 0, 0],
    ],
    [
        [34, 45, 38, 31, 58, 39, 39, 39],
        [35, 45, 53, 54, 44, 39, 39, 39],
        [19, 46, 38, 39, 52, 39, 39, 39],
        [8, 12, 12, 8, 4, 0, 0, 0],
    ],
    [
        [19, 54, 39, 39, 50, 39, 39, 39, 0, 39, 39, 39],
        [19, 39, 54, 39, 19, 39, 39, 39, 56, 39, 39, 39],
        [18, 39, 39, 39, 27, 39, 39, 39, 0, 39, 39, 39],
        [8, 8, 8, 8, 8, 0, 4, 4, 0, 0, 0, 0],
    ],
    [
        [34, 38, 54, 39, 41, 39, 39, 39],
        [34, 38, 62, 39, 26, 39, 39, 39],
        [11, 39, 39, 39, 19, 39, 39, 39],
        [8, 8, 8, 8, 4, 0, 0, 0],
    ],
]
# INIT_PARITY_FLAG[luma/chroma][slice][i]
INIT_PARITY_FLAG = [
    [
        [33, 40, 25, 41, 26, 42, 25, 33, 26, 34, 27, 25, 41, 42, 42, 35, 33, 27, 35, 42, 43],
        [18, 17, 33, 18, 26, 42, 25, 33, 26, 42, 27, 25, 34, 42, 42, 35, 26, 27, 42, 20, 20],
        [33, 25, 18, 26, 34, 27, 25, 26, 19, 42, 35, 33, 19, 27, 35, 35, 34, 42, 20, 43, 20],
        [8, 9, 12, 13, 13, 13, 10, 13, 13, 13, 13, 13, 13, 13, 13, 13, 10, 13, 13, 13, 13],
    ],
    [
        [33, 25, 26, 34, 19, 27, 33, 42, 43, 35, 43],
        [25, 25, 26, 11, 19, 27, 33, 42, 35, 35, 43],
        [33, 25, 26, 42, 19, 27, 26, 50, 35, 20, 43],
        [8, 12, 12, 12, 13, 13, 13, 13, 13, 13, 13],
    ],
]
# INIT_GTX_FLAG rows (context.c:255): 0=gt2 luma, 1=gt2 chroma, 2=gt1 luma, 3=gt1 chroma
INIT_GTX_FLAG = [
    [
        [25, 0, 0, 17, 25, 26, 0, 9, 25, 33, 19, 0, 25, 33, 26, 20, 25, 33, 27, 35, 22],
        [17, 0, 1, 17, 25, 18, 0, 9, 25, 33, 34, 9, 25, 18, 26, 20, 25, 18, 19, 27, 29],
        [25, 1, 40, 25, 33, 11, 17, 25, 25, 18, 4, 17, 33, 26, 19, 13, 33, 19, 20, 28, 22],
        [1, 5, 9, 9, 9, 6, 5, 9, 10, 10, 9, 9, 9, 9, 9, 9, 6, 8, 9, 9, 10],
    ],
    [
        [25, 1, 25, 33, 26, 12, 25, 33, 27, 28, 37],
        [17, 9, 25, 10, 18, 4, 17, 33, 19, 20, 29],
        [40, 9, 25, 18, 26, 35, 25, 26, 35, 28, 37],
        [1, 5, 8, 8, 9, 6, 6, 9, 8, 8, 9],
    ],
    [
        [0, 0, 33, 34, 35, 21, 25, 34, 35, 28, 29, 40, 42, 43, 29, 30, 49, 36, 37, 45, 38],
        [0, 17, 26, 19, 35, 21, 25, 34, 20, 28, 29, 33, 27, 28, 29, 22, 34, 28, 44, 37, 38],
        [25, 25, 11, 27, 20, 21, 33, 12, 28, 21, 22, 34, 28, 29, 29, 30, 36, 29, 45, 30, 23],
        [9, 5, 10, 13, 13, 10, 9, 10, 13, 13, 13, 9, 10, 10, 10, 13, 8, 9, 10, 10, 13],
    ],
    [
        [0, 40, 34, 43, 36, 37, 57, 52, 45, 38, 46],
        [0, 25, 19, 20, 13, 14, 57, 44, 30, 30, 23],
        [40, 33, 27, 28, 21, 37, 36, 37, 45, 38, 46],
        [8, 8, 9, 12, 12, 10, 5, 9, 9, 9, 13],
    ],
]
INIT_LAST_X = [
    [6, 6, 12, 14, 6, 4, 14, 7, 6, 4, 29, 7, 6, 6, 12, 28, 7, 13, 13, 35, 19, 5, 4],
    [6, 13, 12, 6, 6, 12, 14, 14, 13, 12, 29, 7, 6, 13, 36, 28, 14, 13, 5, 26, 12, 4, 18],
    [13, 5, 4, 21, 14, 4, 6, 14, 21, 11, 14, 7, 14, 5, 11, 21, 30, 22, 13, 42, 12, 4, 3],
    [8, 5, 4, 5, 4, 4, 5, 4, 1, 0, 4, 1, 0, 0, 0, 0, 1, 0, 0, 0, 5, 4, 4],
]
INIT_LAST_Y = [
    [5, 5, 20, 13, 13, 19, 21, 6, 12, 12, 14, 14, 5, 4, 12, 13, 7, 13, 12, 41, 11, 5, 27],
    [5, 5, 12, 6, 6, 4, 6, 14, 5, 12, 14, 7, 13, 5, 13, 21, 14, 20, 12, 34, 11, 4, 18],
    [13, 5, 4, 6, 13, 11, 14, 6, 5, 3, 14, 22, 6, 4, 3, 6, 22, 29, 20, 34, 12, 4, 3],
    [8, 5, 8, 5, 5, 4, 5, 5, 4, 0, 5, 4, 1, 0, 0, 1, 4, 0, 0, 0, 6, 5, 5],
]
INIT_MVP_IDX = [[34], [34], [42], [12]]
INIT_SAO_MERGE_FLAG = [2, 60, 60, 0]
INIT_SAO_TYPE_IDX = [2, 5, 13, 4]
INIT_LFNST_IDX = [
    [52, 37, 27],
    [37, 45, 27],
    [28, 52, 42],
    [9, 9, 10],
]
INIT_MTS_IDX = [
    [45, 25, 27, 0],
    [45, 40, 27, 0],
    [29, 0, 28, 0],
    [8, 0, 9, 0],
]
INIT_JOINT_CB_CR_FLAG = [
    [42, 43, 52],
    [27, 36, 45],
    [12, 21, 35],
    [1, 1, 0],
]
INIT_CTB_ALF_FLAG = [
    [33, 52, 46, 25, 61, 54, 25, 61, 54],
    [13, 23, 46, 4, 61, 54, 19, 46, 54],
    [62, 39, 39, 54, 39, 39, 31, 39, 39],
    [0, 0, 0, 4, 0, 0, 1, 0, 0],
]
INIT_CTB_ALF_ALTERNATIVE = [
    [11, 26],
    [20, 12],
    [11, 11],
    [0, 0],
]
INIT_USE_TEMPORAL_ALF_FILT = [46, 46, 46, 0]
INIT_CC_ALF_FILTER_CONTROL_FLAG = [
    [25, 35, 38, 25, 28, 38],
    [18, 21, 38, 18, 21, 38],
    [18, 30, 31, 18, 30, 31],
    [4, 1, 4, 4, 1, 4],
]
INIT_CU_TRANSQUANT_BYPASS = [[CNU], [CNU], [CNU], [DWS]]
INIT_TRANSFORM_SKIP = [
    [25, 17],
    [25, 9],
    [25, 9],
    [1, 1],
]
INIT_TRANSFORM_SKIP_SIG_COEFF_GROUP = [
    [18, 35, 45],
    [18, 12, 29],
    [18, 20, 38],
    [5, 8, 8],
]
INIT_TRANSFORM_SKIP_SIG = [
    [25, 50, 37],
    [40, 35, 44],
    [25, 28, 38],
    [13, 13, 8],
]
INIT_TRANSFORM_SKIP_PARITY = [[11], [3], [11], [6]]
INIT_TRANSFORM_SKIP_GT2 = [
    [CNU, 3, 4, 4, 5],
    [CNU, 2, 10, 3, 3],
    [CNU, 10, 3, 3, 3],
    [DWS, 1, 1, 1, 1],
]
INIT_TRANSFORM_SKIP_GT1 = [
    [19, 11, 4, 6],
    [18, 11, 4, 28],
    [11, 5, 5, 14],
    [4, 2, 1, 6],
]
INIT_TRANSFORM_SKIP_RES_SIGN = [
    [35, 25, 46, 28, 33, 38],
    [5, 10, 53, 43, 25, 46],
    [12, 17, 46, 28, 25, 46],
    [1, 4, 4, 5, 8, 8],
]
INIT_INTRA_SUBPART_MODE = [
    [33, 43],
    [33, 36],
    [33, 43],
    [9, 2],
]
INIT_IMV_FLAG = [
    [59, 26, 50, 60, 38],
    [59, 48, 58, 60, 60],
    [CNU, 34, CNU, CNU, CNU],
    [0, 5, 0, 0, 4],
]
INIT_CCLM_FLAG = [26, 34, 59, 4]
INIT_CCLM_MODEL = [27, 27, 27, 9]
INIT_IBC_FLAG = [
    [0, 43, 45],
    [0, 57, 44],
    [17, 42, 36],
    [1, 5, 8],
]

# --- context family registry -------------------------------------------
# (name, count, init_table) — init_table is indexed [slice][i] with row 3 the
# window sizes; scalar tables are wrapped to 1-element families.


def _scalar(t):
    return [[t[0]], [t[1]], [t[2]], [t[3]]]


# Order defines the flat context id space.
FAMILIES: list[tuple[str, int, list]] = [
    ("alf_ctb_flag", 9, INIT_CTB_ALF_FLAG),
    ("alf_temporal_filt", 1, _scalar(INIT_USE_TEMPORAL_ALF_FILT)),
    ("alf_ctb_alternatives", 2, INIT_CTB_ALF_ALTERNATIVE),
    ("alf_cc_filter_control_flag", 6, INIT_CC_ALF_FILTER_CONTROL_FLAG),
    ("sao_merge_flag", 1, _scalar(INIT_SAO_MERGE_FLAG)),
    ("sao_type_idx", 1, _scalar(INIT_SAO_TYPE_IDX)),
    ("lfnst_idx", 3, INIT_LFNST_IDX),
    ("mts_idx", 4, INIT_MTS_IDX),
    ("split_flag", 9, INIT_SPLIT_FLAG),
    ("qt_split_flag", 6, INIT_QT_SPLIT_FLAG),
    ("mtt_vertical", 5, INIT_VERTICAL_SPLIT_FLAG),
    ("mtt_binary", 4, INIT_BINARY_SPLIT_FLAG),
    ("non_inter_flag", 2, INIT_NON_INTER_FLAG),
    ("intra_luma_mpm_flag", 1, _scalar(INIT_INTRA_LUMA_MPM_FLAG)),
    ("intra_subpart", 2, INIT_INTRA_SUBPART_MODE),
    ("chroma_pred", 1, _scalar(INIT_CHROMA_PRED_MODE)),
    ("inter_dir", 6, INIT_INTER_DIR),
    ("imv_flag", 5, INIT_IMV_FLAG),
    ("qt_cbf_luma", 4, [row[0:4] for row in INIT_QT_CBF]),
    ("qt_cbf_cb", 2, [row[4:6] for row in INIT_QT_CBF]),
    ("qt_cbf_cr", 3, [row[6:9] for row in INIT_QT_CBF]),
    ("cu_qp_delta_abs", 2, INIT_CU_QP_DELTA_ABS),
    ("part_size", 4, INIT_PART_SIZE),
    ("sig_luma_0", 12, INIT_SIG_FLAG[0]),
    ("sig_luma_1", 12, INIT_SIG_FLAG[2]),
    ("sig_luma_2", 12, INIT_SIG_FLAG[4]),
    ("sig_chroma_0", 8, INIT_SIG_FLAG[1]),
    ("sig_chroma_1", 8, INIT_SIG_FLAG[3]),
    ("sig_chroma_2", 8, INIT_SIG_FLAG[5]),
    ("parity_luma", 21, INIT_PARITY_FLAG[0]),
    ("parity_chroma", 11, INIT_PARITY_FLAG[1]),
    # Bank order per context.c:631: cu_gtx_flag_model[ii] is initialized
    # from INIT_GTX_FLAG[ii*2(+1)], and the coder uses model[1] for gt1 and
    # model[0] for gt2 — so rows [2]/[3] are the gt1 inits, [0]/[1] gt2.
    ("gt1_luma", 21, INIT_GTX_FLAG[2]),
    ("gt1_chroma", 11, INIT_GTX_FLAG[3]),
    ("gt2_luma", 21, INIT_GTX_FLAG[0]),
    ("gt2_chroma", 11, INIT_GTX_FLAG[1]),
    ("last_y_luma", 20, [row[0:20] for row in INIT_LAST_Y]),
    ("last_y_chroma", 3, [row[20:23] for row in INIT_LAST_Y]),
    ("last_x_luma", 20, [row[0:20] for row in INIT_LAST_X]),
    ("last_x_chroma", 3, [row[20:23] for row in INIT_LAST_X]),
    ("cu_pred_mode", 2, INIT_PRED_MODE),
    ("cu_skip_flag", 3, INIT_SKIP_FLAG),
    ("cu_merge_idx_ext", 1, INIT_MERGE_IDX_EXT),
    ("cu_merge_flag_ext", 1, INIT_MERGE_FLAG_EXT),
    ("cu_transquant_bypass", 1, INIT_CU_TRANSQUANT_BYPASS),
    ("cu_mvd", 2, INIT_MVD),
    ("cu_ref_pic", 2, INIT_REF_PIC),
    ("mvp_idx", 1, INIT_MVP_IDX),
    ("cu_qt_root_cbf", 1, INIT_QT_ROOT_CBF),
    ("sig_coeff_group", 4, INIT_SIG_COEFF_GROUP),
    ("luma_planar", 2, INIT_INTRA_LUMA_PLANAR_MODE),
    ("multi_ref_line", 2, MULTI_REF_LINE_MODE),
    ("mip_flag", 4, MIP_FLAG),
    ("bdpcm_mode", 4, BDPCM_MODE_INIT),
    ("joint_cb_cr", 3, INIT_JOINT_CB_CR_FLAG),
    ("transform_skip_luma", 1, [[r[0]] for r in INIT_TRANSFORM_SKIP]),
    ("transform_skip_chroma", 1, [[r[1]] for r in INIT_TRANSFORM_SKIP]),
    ("ts_sig_coeff_group", 3, INIT_TRANSFORM_SKIP_SIG_COEFF_GROUP),
    ("ts_sig", 3, INIT_TRANSFORM_SKIP_SIG),
    ("ts_res_sign", 6, INIT_TRANSFORM_SKIP_RES_SIGN),
    ("ts_gt1", 4, INIT_TRANSFORM_SKIP_GT1),
    ("ts_par", 1, INIT_TRANSFORM_SKIP_PARITY),
    ("ts_gt2", 5, INIT_TRANSFORM_SKIP_GT2),
    ("cclm_flag", 1, _scalar(INIT_CCLM_FLAG)),
    ("cclm_model", 1, _scalar(INIT_CCLM_MODEL)),
    ("ibc_flag", 3, INIT_IBC_FLAG),
]

OFF: dict[str, int] = {}
_n = 0
for _name, _cnt, _tab in FAMILIES:
    OFF[_name] = _n
    _n += _cnt
NUM_CTX = _n


def build_init_arrays() -> tuple[np.ndarray, np.ndarray]:
    """Return (init_value[3][NUM_CTX], window[NUM_CTX]) int arrays."""
    init = np.full((3, NUM_CTX), CNU, dtype=np.int32)
    win = np.full(NUM_CTX, DWS, dtype=np.int32)
    for name, cnt, tab in FAMILIES:
        o = OFF[name]
        for s in range(3):
            init[s, o:o + cnt] = tab[s][:cnt]
        win[o:o + cnt] = tab[3][:cnt]
    return init, win


INIT_VALUES, WINDOW_SIZES = build_init_arrays()


def make_entropy_bits() -> np.ndarray:
    """Fractional-bit estimation table, indexed [(state8 << 1) ^ bin].

    Closed form of the reference's uvg_f_entropy_bits (rdo.c:143):
    round(-log2(p) * 2^15) / 2^15 with p = ((bin ? s : 255-s) + 0.5) / 256.
    Verified element-exact against the reference table in tests.
    """
    tab = np.zeros(512, dtype=np.float64)
    for s in range(256):
        for b in (0, 1):
            p = ((s if b else 255 - s) + 0.5) / 256.0
            tab[(s << 1) | b] = round(-math.log2(p) * 32768.0) / 32768.0
    return tab


ENTROPY_BITS = make_entropy_bits()
ENTROPY_BITS_F32 = ENTROPY_BITS.astype(np.float32)

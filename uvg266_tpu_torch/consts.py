"""Global constants of the VVC coding model (reference: src/global.h)."""

LCU_WIDTH = 64                 # CTU size (global.h:185)
LCU_WIDTH_C = 32
MIN_SIZE = 2                   # log2 of min CU size 4x4 (global.h:165)
MAX_DEPTH = 4
TR_MAX_LOG2_SIZE = 5           # max transform 32x32 (global.h:190)
TR_MAX_WIDTH = 1 << TR_MAX_LOG2_SIZE
TR_MIN_LOG2_SIZE = 2
TR_MIN_WIDTH = 1 << TR_MIN_LOG2_SIZE


class NalType:
    TRAIL = 0
    STSA = 1
    RADL = 2
    RASL = 3
    IDR_W_RADL = 7
    IDR_N_LP = 8
    CRA_NUT = 9
    GDR_NUT = 10
    VPS_NUT = 14
    SPS_NUT = 15
    PPS_NUT = 16
    PREFIX_APS_NUT = 17
    SUFFIX_APS_NUT = 18
    PH_NUT = 19
    AUD_NUT = 20
    EOS_NUT = 21
    EOB_NUT = 22
    PREFIX_SEI_NUT = 23
    SUFFIX_SEI_NUT = 24


class SliceType:
    B = 0
    P = 1
    I = 2


class ChromaFormat:
    CSP_400 = 0
    CSP_420 = 1
    CSP_422 = 2
    CSP_444 = 3


COLOR_Y = 0
COLOR_U = 1
COLOR_V = 2

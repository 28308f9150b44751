"""Immutable per-encode control parameters and per-frame state.

The analogue of the reference's encoder_control_t (encoder.{c,h}) geometry
derivation (uvg_encoder_control_input_init, encoder.c:726-770) and the
per-frame fields of encoder_state_t needed for header writing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from ..cfg import Config
from ..consts import LCU_WIDTH, ChromaFormat, NalType, SliceType

CONF_WINDOW_PAD = 8  # VVC pic size granularity (global.h:182)


class EncoderControl:
    def __init__(self, cfg: Config, bitdepth: int | None = None,
                 apply_tool_guards: bool = True):
        # apply_tool_guards=False: decoding a FOREIGN stream — the
        # bitstream is authoritative about active tools; never shed any.
        self.cfg = cfg
        self.bitdepth = bitdepth if bitdepth is not None \
            else cfg.input_bitdepth
        self.chroma_format = cfg.input_format

        # geometry (encoder.c:726-770): pad to 8, crop via conformance window
        self.real_width = cfg.width
        self.real_height = cfg.height
        self.in_width = -(-cfg.width // CONF_WINDOW_PAD) * CONF_WINDOW_PAD
        self.in_height = -(-cfg.height // CONF_WINDOW_PAD) * CONF_WINDOW_PAD
        self.width_in_lcu = -(-self.in_width // LCU_WIDTH)
        self.height_in_lcu = -(-self.in_height // LCU_WIDTH)

        # cu_qp_delta signaling (encoderstate.c:1882-1886): on for RC /
        # VAQ streams. The VAQ path runs through the python finalize +
        # writer; combos whose writers lack the delta syntax (ISP, dual
        # tree) or whose QG prediction needs per-tile state (tiles) shed
        # VAQ like the other tool guards.
        if apply_tool_guards and cfg.vaq \
                and (cfg.isp or cfg.dual_tree
                     or cfg.tiles_width_count * cfg.tiles_height_count > 1):
            cfg.vaq = 0
        self.qp_delta_enabled = bool(cfg.vaq) or cfg.target_bitrate > 0

        # poc lsb bits (encoder.c:242)
        gop_len = cfg.gop_len
        self.poc_lsb_bits = max(4, math.ceil(math.log2(gop_len * 2 + 1)) if gop_len else 0)

        if apply_tool_guards and cfg.dep_quant:
            # dep-quant REPLACES scalar RDOQ (the trellis is the level
            # decision, as in the reference where rdoq is implied); the
            # flag is cleared so rate paths key off dep_quant alone
            cfg.rdoq_enable = False
        self.scaling_lists = None
        if cfg.scaling_list:
            from ..ops.scaling_lists import ScalingLists
            self.scaling_lists = ScalingLists.from_file(cfg.cqmfile) \
                if cfg.scaling_list == 1 else ScalingLists.default()
            if apply_tool_guards:
                # per-coefficient quant matrices run on the scalar
                # finalize path only; tools with their own level-decision
                # or scale assumptions are pending (the reference couples
                # them via err_scale tables, scalinglist.c:376)
                cfg.rdoq_enable = False
                cfg.dep_quant = False
                cfg.lfnst = False
                cfg.trskip_enable = False
                cfg.mts = 0
                cfg.jccr = 0

        self.tiles_enable = (cfg.tiles_width_count > 1 or cfg.tiles_height_count > 1)
        if self.tiles_enable and cfg.wpp:
            # tiles+WPP combined substreams are not supported yet; tiles win
            cfg.wpp = False

        # uniform tile grid in CTUs (encoder.c tile geometry)
        self.tile_col_bd = self._uniform_bounds(self.width_in_lcu,
                                                cfg.tiles_width_count)
        self.tile_row_bd = self._uniform_bounds(self.height_in_lcu,
                                                cfg.tiles_height_count)

        # chroma QP mapping table (encoder.c:141-183): qp_map[qp_in] for the
        # full in-range [-qpBdOffsetC .. 63]; identity extension outside the
        # signalled pivots, as defined by VVC 7.4.3.3 derivation.
        self.qp_map = self._derive_chroma_qp_map()

    @staticmethod
    def _uniform_bounds(n_ctu: int, count: int) -> list[int]:
        bd = [0]
        for i in range(1, count + 1):
            bd.append((i * n_ctu) // count)
        return bd

    def tile_index_of_ctu(self, cx: int, cy: int) -> int:
        tc = sum(1 for b in self.tile_col_bd[1:-1] if cx >= b)
        tr = sum(1 for b in self.tile_row_bd[1:-1] if cy >= b)
        return tr * self.cfg.tiles_width_count + tc

    def tile_bounds_px(self, tile_idx: int):
        """(x0, y0, x1, y1) pixel bounds of a tile (clipped to the frame)."""
        tc = tile_idx % self.cfg.tiles_width_count
        tr = tile_idx // self.cfg.tiles_width_count
        x0 = self.tile_col_bd[tc] * 64
        x1 = min(self.tile_col_bd[tc + 1] * 64, self.in_width)
        y0 = self.tile_row_bd[tr] * 64
        y1 = min(self.tile_row_bd[tr + 1] * 64, self.in_height)
        return x0, y0, x1, y1

    def tile_ctus(self, tile_idx: int):
        """CTU (cx, cy) list of one tile in raster-within-tile order."""
        tc = tile_idx % self.cfg.tiles_width_count
        tr = tile_idx // self.cfg.tiles_width_count
        return [(cx, cy)
                for cy in range(self.tile_row_bd[tr], self.tile_row_bd[tr + 1])
                for cx in range(self.tile_col_bd[tc],
                                self.tile_col_bd[tc + 1])]

    def ctu_scan_order(self):
        """CTU (cx, cy) coding order: raster within tile, tiles in raster
        (the VVC tile scan)."""
        order = []
        for tr in range(self.cfg.tiles_height_count):
            for tc in range(self.cfg.tiles_width_count):
                for cy in range(self.tile_row_bd[tr], self.tile_row_bd[tr + 1]):
                    for cx in range(self.tile_col_bd[tc],
                                    self.tile_col_bd[tc + 1]):
                        order.append((cx, cy))
        return order

    def _derive_chroma_qp_map(self) -> list[int]:
        cfg = self.cfg
        qp_bd_offset = 6 * (self.bitdepth - 8)
        num_points = cfg.qp_table_length_minus1 + 1
        qp_in = [cfg.qp_table_start_minus26 + 26]
        qp_out = [qp_in[0]]
        for j in range(num_points):
            qp_in.append(qp_in[-1] + cfg.delta_qp_in_val_minus1[j] + 1)
            qp_out.append(qp_out[-1] + cfg.delta_qp_out_val[j])
        # build table over [-qp_bd_offset, 63]
        size = 64 + qp_bd_offset
        table = [0] * size

        def set_qp(i, v):
            table[i + qp_bd_offset] = max(-qp_bd_offset, min(63, v))

        set_qp(qp_in[0], qp_out[0])
        for k in range(qp_in[0] - 1, -qp_bd_offset - 1, -1):
            set_qp(k, table[k + 1 + qp_bd_offset] - 1)
        for j in range(num_points):
            sh = (cfg.delta_qp_in_val_minus1[j] + 1) >> 1
            for k in range(qp_in[j] + 1, qp_in[j + 1] + 1):
                m = k - qp_in[j]
                set_qp(k, qp_out[j] + (cfg.delta_qp_out_val[j] * m + sh)
                       // (cfg.delta_qp_in_val_minus1[j] + 1))
        for k in range(qp_in[-1] + 1, 64):
            set_qp(k, table[k - 1 + qp_bd_offset] + 1)
        return table

    def get_chroma_qp(self, qp: int) -> int:
        qp_bd_offset = 6 * (self.bitdepth - 8)
        return self.qp_map[qp + qp_bd_offset]

    @property
    def qp_bd_offset(self) -> int:
        return 6 * (self.bitdepth - 8)

    def luma_qp_scaled(self, qp: int) -> int:
        """qp + QpBdOffset (uvg_get_scaled_qp, transform.c:150)."""
        return qp + self.qp_bd_offset

    def chroma_qp_scaled(self, qp: int) -> int:
        return self.get_chroma_qp(qp) + self.qp_bd_offset


@dataclass
class FrameState:
    num: int = 0                        # frame number in coding order
    poc: int = 0
    pictype: int = NalType.IDR_W_RADL
    slicetype: int = SliceType.I
    qp: int = 22
    lambda_: float = 0.0
    gop_offset: int = 0
    first_nal: bool = True
    max_qp_delta_depth: int = -1
    jccr_sign: int = 0
    ref_pocs_neg: tuple = ()            # POCs of list-0 refs (delta > 0)
    ref_pocs_pos: tuple = ()
    alf: object = None                  # AlfFrameParams of this picture
    lmcs: object = None                 # LmcsFrameCtx when reshaping is on

    @property
    def is_idr(self) -> bool:
        return self.pictype in (NalType.IDR_W_RADL, NalType.IDR_N_LP)

    @property
    def is_irap(self) -> bool:
        return self.pictype in (NalType.IDR_W_RADL, NalType.IDR_N_LP,
                                NalType.CRA_NUT, NalType.GDR_NUT)

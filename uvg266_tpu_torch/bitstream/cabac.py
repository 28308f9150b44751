"""VVC CABAC arithmetic coder (encoder + verification decoder).

Engine parity with the reference (uvg266 src/cabac.c): two-state
adaptive probability (10-bit + 14-bit) contexts, 9-bit range arithmetic
coding with carry propagation into buffered bytes, bypass (EP) bins,
terminate bins, truncated binary and Golomb-Rice binarizations.

The decoder mirrors the VVC spec decoding process (9.3.4.3.2) and is used
as the in-repo conformance oracle (no VTM binary is available here): every
encode path is round-tripped through it in tests.

Contexts live in flat Python int lists indexed by context id (see
ctx_tables.OFF for the family offsets) so that snapshots are cheap list
copies — the analogue of uvg266's per-WPP-row context inheritance.
"""
from __future__ import annotations

from .bitwriter import Bitstream, BitstreamReader
from .ctx_tables import (
    ENTROPY_BITS,
    INIT_VALUES,
    NUM_CTX,
    OFF,
    WINDOW_SIZES,
)

MASK0 = 0x7FE0  # 10-bit state mask (bits 5..14)
MASK1 = 0x7FFE  # 14-bit state mask (bits 1..14)

RENORM_TABLE = (
    6, 5, 4, 4, 3, 3, 3, 3, 2, 2, 2, 2, 2, 2, 2, 2,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
)

# truncated-binary threshold: floor(log2(n)) for n in 0..256
TB_MAX = [0] * 257
for _i in range(2, 257):
    TB_MAX[_i] = TB_MAX[_i >> 1] + 1
TB_MAX[1] = 0


def init_contexts(qp: int, slice_type: int) -> tuple[list[int], list[int], list[int], list[int]]:
    """Build (state0, state1, rate0, rate1) lists for all contexts.

    slice_type: 0=B, 1=P, 2=I (row index into the init tables).
    Mirrors uvg_ctx_init (uvg266 src/context.c:471).
    """
    s0 = [0] * NUM_CTX
    s1 = [0] * NUM_CTX
    r0 = [0] * NUM_CTX
    r1 = [0] * NUM_CTX
    init_row = INIT_VALUES[slice_type]
    for i in range(NUM_CTX):
        iv = int(init_row[i])
        slope = (iv >> 3) - 4
        offset = ((iv & 7) * 18) + 1
        inistate = ((slope * (qp - 16)) >> 1) + offset
        inistate = 1 if inistate < 1 else (127 if inistate > 127 else inistate)
        p1 = inistate << 8
        s0[i] = p1 & MASK0
        s1[i] = p1 & MASK1
        w = int(WINDOW_SIZES[i])
        rate0 = 2 + ((w >> 2) & 3)
        r0[i] = rate0
        r1[i] = 3 + rate0 + (w & 3)
    return s0, s1, r0, r1


class Cabac:
    """CABAC encoder writing into a Bitstream."""

    __slots__ = ("low", "range", "buffered_byte", "num_buffered_bytes",
                 "bits_left", "stream", "s0", "s1", "r0", "r1")

    def __init__(self, stream: Bitstream | None = None) -> None:
        self.stream = stream if stream is not None else Bitstream()
        self.s0: list[int] = [0] * NUM_CTX
        self.s1: list[int] = [0] * NUM_CTX
        self.r0: list[int] = [0] * NUM_CTX
        self.r1: list[int] = [0] * NUM_CTX
        self.start()

    # --- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self.low = 0
        self.range = 510
        self.bits_left = 23
        self.num_buffered_bytes = 0
        self.buffered_byte = 0xFF

    def init_contexts(self, qp: int, slice_type: int) -> None:
        self.s0, self.s1, self.r0, self.r1 = init_contexts(qp, slice_type)

    def ctx_snapshot(self) -> tuple[list[int], list[int], list[int], list[int]]:
        return (self.s0[:], self.s1[:], self.r0[:], self.r1[:])

    def save_ctx(self):
        return (self.s0[:], self.s1[:])

    def load_ctx(self, snap) -> None:
        self.s0 = list(snap[0])
        self.s1 = list(snap[1])

    def ctx_restore(self, snap) -> None:
        self.s0 = snap[0][:]
        self.s1 = snap[1][:]
        self.r0 = snap[2][:]
        self.r1 = snap[3][:]

    # --- state helpers ----------------------------------------------------
    def state8(self, ctx: int) -> int:
        return (self.s0[ctx] + self.s1[ctx]) >> 8

    def fbits(self, ctx: int, binval: int) -> float:
        """Fractional bits this bin would cost (no state change)."""
        return ENTROPY_BITS[(self.state8(ctx) << 1) ^ binval]

    def update_ctx(self, ctx: int, binval: int) -> None:
        s0 = self.s0
        s1 = self.s1
        rate0 = self.r0[ctx]
        rate1 = self.r1[ctx]
        s0[ctx] -= (s0[ctx] >> rate0) & MASK0
        s1[ctx] -= (s1[ctx] >> rate1) & MASK1
        if binval:
            s0[ctx] += (0x7FFF >> rate0) & MASK0
            s1[ctx] += (0x7FFF >> rate1) & MASK1

    # --- engine ---------------------------------------------------------
    def _write_out(self) -> None:
        lead_byte = self.low >> (24 - self.bits_left)
        self.bits_left += 8
        self.low &= 0xFFFFFFFF >> self.bits_left
        if lead_byte == 0xFF:
            self.num_buffered_bytes += 1
        elif self.num_buffered_bytes > 0:
            carry = lead_byte >> 8
            self.stream.put_byte(self.buffered_byte + carry)
            self.buffered_byte = lead_byte & 0xFF
            fill = (0xFF + carry) & 0xFF
            for _ in range(self.num_buffered_bytes - 1):
                self.stream.put_byte(fill)
            self.num_buffered_bytes = 1
        else:
            self.num_buffered_bytes = 1
            self.buffered_byte = lead_byte

    def encode_bin(self, ctx: int, binval: int) -> None:
        state8 = (self.s0[ctx] + self.s1[ctx]) >> 8
        q = state8 ^ 0xFF if state8 & 0x80 else state8
        lps = (((q >> 2) * (self.range >> 5)) >> 1) + 4
        self.range -= lps
        if (1 if binval else 0) != (state8 >> 7):
            num_bits = RENORM_TABLE[lps >> 3]
            self.low = (self.low + self.range) << num_bits
            self.range = lps << num_bits
            self.bits_left -= num_bits
            if self.bits_left < 12:
                self._write_out()
        elif self.range < 256:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
            if self.bits_left < 12:
                self._write_out()
        self.update_ctx(ctx, binval)

    def encode_bin_ep(self, binval: int) -> None:
        self.low <<= 1
        if binval:
            self.low += self.range
        self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def encode_bins_ep(self, binvals: int, num_bins: int) -> None:
        if self.range == 256:
            # aligned mode
            rem = num_bins
            while rem > 0:
                n = min(rem, 8)
                mask = (1 << n) - 1
                new_bins = (binvals >> (rem - n)) & mask
                self.low = (self.low << n) + (new_bins << 8)
                rem -= n
                self.bits_left -= n
                if self.bits_left < 12:
                    self._write_out()
            return
        while num_bins > 8:
            num_bins -= 8
            pattern = binvals >> num_bins
            self.low = (self.low << 8) + self.range * pattern
            binvals -= pattern << num_bins
            self.bits_left -= 8
            if self.bits_left < 12:
                self._write_out()
        self.low = (self.low << num_bins) + self.range * binvals
        self.bits_left -= num_bins
        if self.bits_left < 12:
            self._write_out()

    def encode_bin_trm(self, binval: int) -> None:
        self.range -= 2
        if binval:
            self.low += self.range
            self.low <<= 7
            self.range = 2 << 7
            self.bits_left -= 7
        elif self.range >= 256:
            return
        else:
            self.low <<= 1
            self.range <<= 1
            self.bits_left -= 1
        if self.bits_left < 12:
            self._write_out()

    def finish(self) -> None:
        assert self.bits_left <= 32
        if self.low >> (32 - self.bits_left):
            self.stream.put_byte(self.buffered_byte + 1)
            for _ in range(self.num_buffered_bytes - 1):
                self.stream.put_byte(0)
            self.low -= 1 << (32 - self.bits_left)
        else:
            if self.num_buffered_bytes > 0:
                self.stream.put_byte(self.buffered_byte)
            for _ in range(self.num_buffered_bytes - 1):
                self.stream.put_byte(0xFF)
        bits = 24 - self.bits_left
        self.stream.put(self.low >> 8, bits)
        self.num_buffered_bytes = 0

    def put(self, value: int, bits: int) -> None:
        self.stream.put(value, bits)

    def align_zero(self) -> None:
        self.stream.align_zero()

    # --- binarizations ----------------------------------------------------
    def encode_trunc_bin(self, value: int, max_value: int) -> None:
        if max_value > 256:
            thresh = 8
            thresh_val = 1 << 8
            while thresh_val <= max_value:
                thresh += 1
                thresh_val <<= 1
            thresh -= 1
        else:
            thresh = TB_MAX[max_value]
        val = 1 << thresh
        b = max_value - val
        if value < val - b:
            self.encode_bins_ep(value, thresh)
        else:
            self.encode_bins_ep(value + val - b, thresh + 1)

    def write_coeff_remain(self, remainder: int, rice_param: int, cutoff: int) -> int:
        """Golomb-Rice remainder with exp-golomb escape; returns bin count."""
        threshold = cutoff << rice_param
        if remainder < threshold:
            length = (remainder >> rice_param) + 1
            self.encode_bins_ep((1 << length) - 2, length)
            self.encode_bins_ep(remainder & ((1 << rice_param) - 1), rice_param)
            return length + rice_param
        max_prefix_length = 32 - cutoff - 15
        prefix_length = 0
        code_value = (remainder >> rice_param) - cutoff
        if code_value >= (1 << max_prefix_length) - 1:
            prefix_length = max_prefix_length
            suffix_length = 15
        else:
            while code_value > (2 << prefix_length) - 2:
                prefix_length += 1
            suffix_length = prefix_length + rice_param + 1
        total_prefix_length = prefix_length + cutoff
        bit_mask = (1 << rice_param) - 1
        prefix = (1 << total_prefix_length) - 1
        suffix = ((code_value - ((1 << prefix_length) - 1)) << rice_param) | (remainder & bit_mask)
        self.encode_bins_ep(prefix, total_prefix_length)
        self.encode_bins_ep(suffix, suffix_length)
        return total_prefix_length + suffix_length

    def write_unary_max_symbol(self, ctx_base: int, symbol: int, offset: int, max_symbol: int) -> None:
        if not max_symbol:
            return
        code_last = max_symbol > symbol
        self.encode_bin(ctx_base, 1 if symbol else 0)
        if not symbol:
            return
        while symbol > 1:
            symbol -= 1
            self.encode_bin(ctx_base + offset, 1)
        if code_last:
            self.encode_bin(ctx_base + offset, 0)

    def write_unary_max_symbol_ep(self, symbol: int, max_symbol: int) -> None:
        code_last = max_symbol > symbol
        self.encode_bin_ep(1 if symbol else 0)
        if not symbol:
            return
        while symbol > 1:
            symbol -= 1
            self.encode_bin_ep(1)
        if code_last:
            self.encode_bin_ep(0)

    def write_ep_ex_golomb(self, symbol: int, count: int) -> int:
        bins = 0
        num_bins = 0
        while symbol >= (1 << count):
            bins = 2 * bins + 1
            num_bins += 1
            symbol -= 1 << count
            count += 1
        bins = 2 * bins
        num_bins += 1
        bins = (bins << count) | symbol
        num_bins += count
        self.encode_bins_ep(bins, num_bins)
        return num_bins


class CabacDecoder:
    """Spec-mirror CABAC decoder (VVC 9.3.4.3.2) over the same context model.

    Used as the conformance oracle for encoder round-trip tests.
    """

    __slots__ = ("rd", "range", "offset", "s0", "s1", "r0", "r1")

    def __init__(self, reader: BitstreamReader) -> None:
        self.rd = reader
        self.range = 510
        self.offset = reader.read(9)
        self.s0: list[int] = [0] * NUM_CTX
        self.s1: list[int] = [0] * NUM_CTX
        self.r0: list[int] = [0] * NUM_CTX
        self.r1: list[int] = [0] * NUM_CTX

    def init_contexts(self, qp: int, slice_type: int) -> None:
        self.s0, self.s1, self.r0, self.r1 = init_contexts(qp, slice_type)

    def save_ctx(self):
        return (self.s0[:], self.s1[:])

    def load_ctx(self, snap) -> None:
        self.s0 = list(snap[0])
        self.s1 = list(snap[1])

    def update_ctx(self, ctx: int, binval: int) -> None:
        rate0 = self.r0[ctx]
        rate1 = self.r1[ctx]
        self.s0[ctx] -= (self.s0[ctx] >> rate0) & MASK0
        self.s1[ctx] -= (self.s1[ctx] >> rate1) & MASK1
        if binval:
            self.s0[ctx] += (0x7FFF >> rate0) & MASK0
            self.s1[ctx] += (0x7FFF >> rate1) & MASK1

    def decode_bin(self, ctx: int) -> int:
        state8 = (self.s0[ctx] + self.s1[ctx]) >> 8
        q = state8 ^ 0xFF if state8 & 0x80 else state8
        lps = (((q >> 2) * (self.range >> 5)) >> 1) + 4
        mps = state8 >> 7
        self.range -= lps
        if self.offset >= self.range:
            binval = 1 - mps
            self.offset -= self.range
            self.range = lps
        else:
            binval = mps
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.rd.read_bit()
        self.update_ctx(ctx, binval)
        return binval

    def decode_bin_ep(self) -> int:
        self.offset = (self.offset << 1) | self.rd.read_bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bins_ep(self, num_bins: int) -> int:
        v = 0
        for _ in range(num_bins):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_bin_trm(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.rd.read_bit()
        return 0

    def decode_trunc_bin(self, max_value: int) -> int:
        if max_value > 256:
            thresh = 8
            thresh_val = 1 << 8
            while thresh_val <= max_value:
                thresh += 1
                thresh_val <<= 1
            thresh -= 1
        else:
            thresh = TB_MAX[max_value]
        val = 1 << thresh
        b = max_value - val
        t = self.decode_bins_ep(thresh)
        if t < val - b:
            return t
        return ((t << 1) | self.decode_bin_ep()) - (val - b)

    def decode_coeff_remain(self, rice_param: int, cutoff: int) -> int:
        max_prefix_length = 32 - cutoff - 15
        k = 0
        while k < cutoff + max_prefix_length and self.decode_bin_ep() == 1:
            k += 1
        if k < cutoff:
            return (k << rice_param) | self.decode_bins_ep(rice_param)
        prefix_length = k - cutoff
        if k == cutoff + max_prefix_length:
            suffix = self.decode_bins_ep(15)
        else:
            # the terminating 0 bin was the MSB of the suffix field
            suffix = self.decode_bins_ep(prefix_length + rice_param)
        code_value = (suffix >> rice_param) + ((1 << prefix_length) - 1)
        return ((code_value + cutoff) << rice_param) | (suffix & ((1 << rice_param) - 1))

    def decode_unary_max_symbol(self, ctx_base: int, offset: int, max_symbol: int) -> int:
        if not max_symbol:
            return 0
        if not self.decode_bin(ctx_base):
            return 0
        symbol = 1
        while symbol < max_symbol and self.decode_bin(ctx_base + offset):
            symbol += 1
        return symbol

    def decode_unary_max_symbol_ep(self, max_symbol: int) -> int:
        if not self.decode_bin_ep():
            return 0
        symbol = 1
        while symbol < max_symbol and self.decode_bin_ep():
            symbol += 1
        return symbol

    def decode_ep_ex_golomb(self, count: int) -> int:
        symbol = 0
        while self.decode_bin_ep():
            symbol += 1 << count
            count += 1
        if count:
            symbol += self.decode_bins_ep(count)
        return symbol


__all__ = ["Cabac", "CabacDecoder", "init_contexts", "OFF", "NUM_CTX"]

"""Byte-stream writer with NAL emulation prevention and Exp-Golomb codes.

Behavioral parity with the reference chunked bitstream
(uvg266 src/bitstream.c: uvg_bitstream_put, uvg_bitstream_put_byte,
uvg_bitstream_put_ue/se, uvg_bitstream_add_rbsp_trailing_bits) — we use a flat
bytearray instead of a chunk list since Python owns the buffer anyway.

Emulation prevention: any time two consecutive zero bytes have been emitted
and the next byte is < 4, an 0x03 escape byte is inserted first
(bitstream.c: uvg_bitstream_put_byte).  Raw start codes are written with
`write_byte_raw`, which bypasses the escape logic.
"""
from __future__ import annotations


class Bitstream:
    __slots__ = ("buf", "cur_bit", "data", "zerocount")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.cur_bit = 0      # bits pending in `data` (0..7)
        self.data = 0         # pending partial byte (MSB-first)
        self.zerocount = 0    # consecutive zero bytes for emulation prevention

    # --- byte level ---------------------------------------------------
    def write_byte_raw(self, byte: int) -> None:
        """Append a byte with NO emulation prevention (start codes, NAL hdr)."""
        assert self.cur_bit == 0
        self.buf.append(byte & 0xFF)

    def put_byte(self, byte: int) -> None:
        """Append a payload byte, inserting 0x03 escapes as needed."""
        assert self.cur_bit == 0
        byte &= 0xFF
        if self.zerocount == 2 and byte < 4:
            self.buf.append(0x03)
            self.zerocount = 0
        self.zerocount = self.zerocount + 1 if byte == 0 else 0
        self.buf.append(byte)

    # --- bit level ----------------------------------------------------
    def put(self, value: int, bits: int) -> None:
        """Write `bits` bits of `value` MSB-first."""
        data = self.data
        cur = self.cur_bit
        for i in range(bits - 1, -1, -1):
            data = ((data << 1) | ((value >> i) & 1)) & 0xFF
            cur += 1
            if cur == 8:
                cur = 0
                # inline put_byte
                if self.zerocount == 2 and data < 4:
                    self.buf.append(0x03)
                    self.zerocount = 0
                self.zerocount = self.zerocount + 1 if data == 0 else 0
                self.buf.append(data)
                data = 0
        self.data = data
        self.cur_bit = cur

    def put_ue(self, value: int) -> None:
        """Unsigned Exp-Golomb."""
        v = value + 1
        nbits = v.bit_length() * 2 - 1
        self.put(v, nbits)

    def put_se(self, value: int) -> None:
        """Signed Exp-Golomb: positive -> odd code nums, negative -> even."""
        code = (-value) << 1 if value <= 0 else (value << 1) - 1
        self.put_ue(code)

    # --- alignment ----------------------------------------------------
    def rbsp_trailing_bits(self) -> None:
        self.put(1, 1)
        self.align_zero()

    def align(self) -> None:
        if self.cur_bit & 7:
            self.rbsp_trailing_bits()

    def align_zero(self) -> None:
        if self.cur_bit & 7:
            self.put(0, (8 - self.cur_bit) & 7)

    # --- utility --------------------------------------------------------
    def tell(self) -> int:
        """Bit position."""
        return len(self.buf) * 8 + self.cur_bit

    def bytes(self) -> bytes:
        assert self.cur_bit == 0
        return bytes(self.buf)

    def move_from(self, src: "Bitstream") -> None:
        """Append src's bytes (dst must be byte aligned); src keeps partial bits."""
        assert self.cur_bit == 0
        self.buf += src.buf
        self.data = src.data
        self.cur_bit = src.cur_bit
        self.zerocount = src.zerocount
        src.buf = bytearray()
        src.data = 0
        src.cur_bit = 0
        src.zerocount = 0


class BitstreamReader:
    """Bit reader over an RBSP (escapes already removed) — used by the
    verification decoder and the CABAC decoder."""
    __slots__ = ("buf", "pos")

    def __init__(self, data: bytes) -> None:
        self.buf = data
        self.pos = 0  # bit position

    def read_bit(self) -> int:
        byte_idx = self.pos >> 3
        if byte_idx >= len(self.buf):
            return 0  # reading past the end yields zeros (decoder flush slack)
        bit = (self.buf[byte_idx] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def read(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.read_bit()
        return v

    def read_ue(self) -> int:
        zeros = 0
        while self.read_bit() == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("invalid ue(v)")
        return (1 << zeros) - 1 + self.read(zeros)

    def read_se(self) -> int:
        code = self.read_ue()
        return (code + 1) >> 1 if code & 1 else -(code >> 1)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def more_data(self) -> bool:
        return self.pos < len(self.buf) * 8


def strip_emulation_prevention(data: bytes) -> bytes:
    """Remove 0x03 escape bytes from a NAL payload (00 00 03 xx -> 00 00 xx)."""
    out = bytearray()
    zeros = 0
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if zeros >= 2 and b == 0x03 and i + 1 < n and data[i + 1] <= 0x03:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)

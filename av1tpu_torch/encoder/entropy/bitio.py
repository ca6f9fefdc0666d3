# Copied from av1tpu/encoder/entropy/bitio.py.
"""MSB-first bit I/O for AV1 uncompressed headers (OBU syntax layer).

Implements the descriptor set from the AV1 spec's conventions section:
f(n), uvlc(), le(n), leb128(), su(n) — used by the sequence/frame header
writers and the conformance decoder's header parser.
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self._bytes = bytearray()
        self._bitbuf = 0
        self._nbits = 0

    def f(self, value: int, n: int) -> None:
        """n-bit unsigned, MSB first."""
        if n == 0:
            return
        assert 0 <= value < (1 << n), (value, n)
        for i in range(n - 1, -1, -1):
            self._bitbuf = (self._bitbuf << 1) | ((value >> i) & 1)
            self._nbits += 1
            if self._nbits == 8:
                self._bytes.append(self._bitbuf)
                self._bitbuf = 0
                self._nbits = 0

    def su(self, value: int, n: int) -> None:
        """Signed: value bits then sign handled as (1+n)-bit twos-complement."""
        self.f(value & ((1 << n) - 1), n)

    def uvlc(self, value: int) -> None:
        v = value + 1
        n = v.bit_length()
        self.f(0, n - 1)      # leading zeros
        self.f(v, n)          # value incl. leading one

    def ns(self, value: int, n: int) -> None:
        """Non-symmetric unsigned in [0, n)."""
        w = n.bit_length()
        m = (1 << w) - n
        if value < m:
            self.f(value, w - 1)
        else:
            extra = value - m
            self.f(m + (extra >> 1), w - 1)
            self.f(extra & 1, 1)

    def byte_align(self) -> None:
        while self._nbits:
            self.f(0, 1)

    def trailing_bits(self) -> None:
        """AV1 trailing_bits: a one then zeros to byte boundary."""
        self.f(1, 1)
        self.byte_align()

    def bytes(self) -> bytes:
        assert self._nbits == 0, "call byte_align()/trailing_bits() first"
        return bytes(self._bytes)

    @property
    def bit_count(self) -> int:
        return len(self._bytes) * 8 + self._nbits


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self._data[self._pos >> 3] if (self._pos >> 3) < len(
                self._data) else 0
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        if v >= (1 << (n - 1)):
            v -= 1 << n
        return v

    def uvlc(self) -> int:
        leading = 0
        while self.f(1) == 0:
            leading += 1
            if leading > 32:
                raise ValueError("uvlc too long")
        if leading == 0:
            return 0
        return (1 << leading) - 1 + self.f(leading)

    def ns(self, n: int) -> int:
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        return (v << 1) - m + self.f(1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    @property
    def bit_pos(self) -> int:
        return self._pos


def write_leb128(value: int) -> bytes:
    """leb128() descriptor (OBU sizes)."""
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def read_leb128(data: bytes, pos: int = 0) -> tuple[int, int]:
    """Returns (value, new_pos)."""
    value = 0
    for i in range(8):
        byte = data[pos + i]
        value |= (byte & 0x7F) << (7 * i)
        if not (byte & 0x80):
            return value, pos + i + 1
    raise ValueError("leb128 too long")

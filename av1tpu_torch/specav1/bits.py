# Copied from av1tpu/specav1/bits.py.
"""Bit-exact readers/writers for AV1 uncompressed syntax (spec §4/§5.3).

Covers every descriptor the sequence/frame headers use: f(n), uvlc,
le(n), leb128, su(n), ns(n).  The arithmetic-coded tile payload uses
msac.py instead.
"""

from __future__ import annotations


class BitReader:
    """MSB-first bit reader over bytes (spec f(n) semantics)."""

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uvlc(self) -> int:
        lead = 0
        while self.f(1) == 0:
            lead += 1
            if lead > 32:
                raise ValueError("uvlc overflow")
        if lead == 32:
            return (1 << 32) - 1
        return (1 << lead) - 1 + self.f(lead)

    def su(self, n: int) -> int:
        """Signed: n-1 magnitude bits + sign interpretation (spec su(n))."""
        v = self.f(n)
        sign_mask = 1 << (n - 1)
        if v & sign_mask:
            v = v - 2 * sign_mask
        return v

    def ns(self, n: int) -> int:
        """Non-symmetric unsigned with max n (spec ns(n))."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.f(w - 1)
        if v < m:
            return v
        extra = self.f(1)
        return (v << 1) - m + extra

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

class BitWriter:
    """MSB-first bit writer (encoder-side duals of BitReader)."""

    def __init__(self):
        self.bits: list[int] = []

    def f(self, v: int, n: int) -> "BitWriter":
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)
        return self

    def uvlc(self, v: int) -> "BitWriter":
        lead = (v + 1).bit_length() - 1
        self.f(0, lead)
        self.f(1, 1)
        self.f(v + 1 - (1 << lead), lead)
        return self

    def su(self, v: int, n: int) -> "BitWriter":
        self.f(v & ((1 << n) - 1), n)
        return self

    def ns(self, v: int, n: int) -> "BitWriter":
        w = n.bit_length()
        m = (1 << w) - n
        if v < m:
            self.f(v, w - 1)
        else:
            x = v + m
            self.f(x >> 1, w - 1)
            self.f(x & 1, 1)
        return self

    def byte_align(self) -> "BitWriter":
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def trailing_bits(self) -> "BitWriter":
        """spec trailing_bits(): a 1 then 0s to byte alignment."""
        self.f(1, 1)
        return self.byte_align()

    def tobytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | self.bits[i + j]
            out.append(b)
        return bytes(out)

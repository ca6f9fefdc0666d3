# Copied from av1tpu/specav1/msac.py.
"""AV1 multi-symbol arithmetic decoder (spec §8.2, daala-EC lineage).

Operates on inverse-CDF (ICDF) arrays: for an N-symbol alphabet the
array holds N entries — icdf[k] = 32768 - cum_prob(sym <= k), strictly
decreasing to icdf[N-1] = 0 — plus one trailing adaptation counter.
EC_PROB_SHIFT = 6, EC_MIN_PROB = 4 exactly as the spec's decode_symbol.

Pure-python reference implementation: clarity over speed (the TPU
encoder's hot path uses the C++ coder; this decoder exists for
conformance and debugging).
"""

from __future__ import annotations

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
_WINDOW = 32  # bits in the decode window


class SymbolDecoder:
    def __init__(self, data: bytes):
        self.data = data
        self.bptr = 0
        self.dif = (1 << (_WINDOW - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self._refill()

    def _refill(self) -> None:
        s = _WINDOW - 9 - (self.cnt + 15)
        while s >= 0 and self.bptr < len(self.data):
            self.dif ^= self.data[self.bptr] << s
            self.cnt += 8
            self.bptr += 1
            s -= 8
        if self.bptr >= len(self.data):
            self.cnt = 0x4000  # "lots of bits": past the end reads zeros

    def _normalize(self, dif: int, rng: int) -> None:
        d = 16 - rng.bit_length()
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & ((1 << _WINDOW) - 1)
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()

    def decode_symbol(self, icdf, nsyms: int) -> int:
        """Decode one symbol from an N-symbol ICDF (no adaptation)."""
        r = self.rng
        c = self.dif >> (_WINDOW - 16)
        v = r
        ret = -1
        while True:
            u = v
            ret += 1
            v = ((r >> 8) * (int(icdf[ret]) >> EC_PROB_SHIFT)
                 >> (7 - EC_PROB_SHIFT))
            v += EC_MIN_PROB * (nsyms - ret - 1)
            if c >= v:
                break
        rng = u - v
        dif = self.dif - (v << (_WINDOW - 16))
        self._normalize(dif, rng)
        return ret

    def decode_bool(self, f: int) -> int:
        """Decode a boolean with P(bit==0) = f / 32768 (no adaptation)."""
        r = self.rng
        v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) \
            + EC_MIN_PROB
        vw = v << (_WINDOW - 16)
        if self.dif >= vw:
            ret = 0
            dif = self.dif - vw
            rng = r - v
        else:
            ret = 1
            dif = self.dif
            rng = v
        self._normalize(dif, rng)
        return ret

    def read_literal(self, n: int) -> int:
        x = 0
        for _ in range(n):
            x = (x << 1) | self.decode_bool(16384)
        return x

    def read_adapt(self, cdf, nsyms: int | None = None) -> int:
        """Decode with adaptation: cdf is a mutable array of N+1 u16
        (N-symbol ICDF + counter)."""
        if nsyms is None:
            nsyms = len(cdf) - 1
        val = self.decode_symbol(cdf, nsyms)
        update_cdf(cdf, val, nsyms)
        return val

def update_cdf(cdf, val: int, nsyms: int) -> None:
    """spec §8.4 CDF update, ICDF orientation."""
    count = int(cdf[nsyms])
    # min(FloorLog2(nsyms), 2): 2 syms -> 1, 4 -> 2, >=4 caps at 2
    rate = 3 + (count > 15) + (count > 31) + min(_floor_log2(nsyms), 2)
    for i in range(nsyms - 1):
        if i < val:
            cdf[i] = cdf[i] + ((32768 - cdf[i]) >> rate)
        else:
            cdf[i] = cdf[i] - (cdf[i] >> rate)
    cdf[nsyms] = count + (count < 32)


def _floor_log2(x: int) -> int:
    return x.bit_length() - 1

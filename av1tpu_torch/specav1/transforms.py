"""Transform primitives shared by the keyframe and P-frame encoders.

Port of ``av1tpu/specav1/jax_intra.py`` lines 230-490: the float32
forward matrices used for quantization, and the spec-exact integer
inverse DCT/ADST.  The inverse transforms run in int32 with the spec's
clamp after every butterfly, exactly as the reference; every
intermediate fits int32 (|w| <= 4096, |x| <= 2^17 at 10 bits).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from av1tpu_torch.specav1 import recon


def _fwd_mat(n: int) -> np.ndarray:
    """Scaled float32 DCT-II matrix.  Copied from jax_intra._fwd_mat."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = np.cos((2 * j + 1) * k * math.pi / (2 * n)) * math.sqrt(2.0 / n)
    m[0] *= 1.0 / math.sqrt(2)
    gw = math.sqrt(n) / math.sqrt(2)
    rs = recon._ROW_SHIFT[(n.bit_length() - 1, n.bit_length() - 1)]
    scale = (1 << (rs + 4)) / (gw * gw)
    return (m * math.sqrt(scale)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fwd_mat_kind(kind: str, n: int) -> np.ndarray:
    """Forward 1-D matrix for quantization: the scaled numeric inverse
    of the spec integer inverse transform.  Copied from
    jax_intra._fwd_mat_kind."""
    if kind == "dct":
        return _fwd_mat(n)
    scale_in = 1 << 12
    A = np.zeros((n, n), np.float64)
    for j in range(n):
        e = [np.int64(0)] * n
        e[j] = np.int64(scale_in)
        out = recon.iadst1d(e, lambda x: x)
        A[:, j] = np.asarray(out, np.float64) / scale_in
    rs = recon._ROW_SHIFT[(n.bit_length() - 1, n.bit_length() - 1)]
    s = math.sqrt(float(1 << (rs + 4)))
    return (s * np.linalg.inv(A)).astype(np.float32)


_mats: dict = {}


def fwd_mat(kind: str, n: int, device) -> torch.Tensor:
    """The forward matrix as a float32 tensor on ``device`` (cached)."""
    key = (kind, n, str(device))
    m = _mats.get(key)
    if m is None:
        m = torch.from_numpy(np.ascontiguousarray(
            _fwd_mat_kind(kind, n))).to(device)
        _mats[key] = m
    return m


# ---------------------------------------------------------------------------
# spec-exact integer inverse transforms (port of recon.idct1d/iadst1d)
# ---------------------------------------------------------------------------

def _round2(x, n: int):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _jbtf(w0: int, x0, w1: int, x1):
    return _round2(w0 * x0 + w1 * x1, recon.COS_BIT)


def _bitrev(i: int, n: int) -> int:
    return int(format(i, f"0{n}b")[::-1], 2) if n else 0


def _c(a: int) -> int:
    return int(recon.cos128(a))


def _jidct(T, clamp):
    n = len(T)
    if n == 2:
        c32 = _c(32)
        return [clamp(_jbtf(c32, T[0], c32, T[1])),
                clamp(_jbtf(c32, T[0], -c32, T[1]))]
    half = n // 2
    even = _jidct([T[2 * i] for i in range(half)], clamp)
    odd = _jidct_odd([T[2 * i + 1] for i in range(half)], n, clamp)
    out = [None] * n
    for i in range(half):
        out[i] = clamp(even[i] + odd[half - 1 - i])
        out[n - 1 - i] = clamp(even[i] - odd[half - 1 - i])
    return out


def _jidct_odd(O, full, clamp):
    m = len(O)
    bits = m.bit_length() - 1
    unit = 64 // full
    s = [None] * m
    for k in range(m // 2):
        coeff = 2 * _bitrev(k, bits) + 1
        a = unit * coeff
        lo = O[(coeff - 1) // 2]
        hi = O[(full - coeff - 1) // 2]
        s[k] = clamp(_jbtf(_c(64 - a), lo, -_c(a), hi))
        s[m - 1 - k] = clamp(_jbtf(_c(a), lo, _c(64 - a), hi))
    if m == 2:
        return s
    for lvl in range(1, bits):
        g = 1 << lvl
        t = [None] * m
        for lo0 in range(0, m, g):
            gi = lo0 // g
            for i in range(g // 2):
                a_i, b_i = lo0 + i, lo0 + g - 1 - i
                if gi % 2 == 0:
                    t[a_i] = clamp(s[a_i] + s[b_i])
                    t[b_i] = clamp(s[a_i] - s[b_i])
                else:
                    t[a_i] = clamp(-s[a_i] + s[b_i])
                    t[b_i] = clamp(s[a_i] + s[b_i])
        s = t
        band_lo = g // 2
        base_angle = (64 * g) // m
        t = list(s)
        for j in range(m // 2):
            if not (band_lo <= (j % (2 * g)) < band_lo + g):
                continue
            k = m - 1 - j
            quad = j // (2 * g)
            nq = m // (2 * g)
            mult = 2 * _bitrev(quad, max(nq.bit_length() - 1, 0)) + 1
            a = base_angle * mult
            ca, cb = _c(a), _c(64 - a)
            if (j // g) % 2 == 0:
                t[j] = clamp(_jbtf(-ca, s[j], cb, s[k]))
                t[k] = clamp(_jbtf(cb, s[j], ca, s[k]))
            else:
                t[j] = clamp(_jbtf(-cb, s[j], -ca, s[k]))
                t[k] = clamp(_jbtf(-ca, s[j], cb, s[k]))
        s = t
    return s


def _jiadst(T, clamp):
    """Spec-exact inverse ADST; T: list of n lanes, n in {4, 8, 16}."""
    n = len(T)
    if n == 4:
        s1, s2, s3, s4 = (int(x) for x in recon.SINPI[1:5])
        x0, x1, x2, x3 = T
        a0 = s1 * x0 + s4 * x2 + s2 * x3
        a1 = s2 * x0 - s1 * x2 - s4 * x3
        a2 = s3 * (x0 - x2 + x3)
        a3 = s3 * x1
        return [_round2(o, 12) for o in (a0 + a3, a1 + a3, a2,
                                         a0 + a1 - a3)]
    angles = recon._IADST8_ANGLES if n == 8 else recon._IADST16_ANGLES
    s = []
    for k in range(n // 2):
        s.append(T[n - 1 - 2 * k])
        s.append(T[2 * k])
    t = [None] * n
    for k in range(n // 2):
        a = int(angles[k])
        ca, cb = _c(a), _c(64 - a)
        t[2 * k] = clamp(_jbtf(ca, s[2 * k], cb, s[2 * k + 1]))
        t[2 * k + 1] = clamp(_jbtf(cb, s[2 * k], -ca, s[2 * k + 1]))
    s = t
    t = [None] * n
    for i in range(n // 2):
        t[i] = clamp(s[i] + s[i + n // 2])
        t[i + n // 2] = clamp(s[i] - s[i + n // 2])
    s = t
    t = list(s)
    c8, c16, c24, c32 = _c(8), _c(16), _c(24), _c(32)
    c40, c48, c56 = _c(40), _c(48), _c(56)
    if n == 8:
        t[4] = clamp(_jbtf(c16, s[4], c48, s[5]))
        t[5] = clamp(_jbtf(c48, s[4], -c16, s[5]))
        t[6] = clamp(_jbtf(-c48, s[6], c16, s[7]))
        t[7] = clamp(_jbtf(c16, s[6], c48, s[7]))
        s = t
        t = [None] * n
        for base in (0, 4):
            for i in range(2):
                t[base + i] = clamp(s[base + i] + s[base + 2 + i])
                t[base + 2 + i] = clamp(s[base + i] - s[base + 2 + i])
        s = t
        t = list(s)
        for base in (2, 6):
            t[base] = clamp(_jbtf(c32, s[base], c32, s[base + 1]))
            t[base + 1] = clamp(_jbtf(c32, s[base], -c32, s[base + 1]))
        s = t
        return [s[0], -s[4], s[6], -s[2], s[3], -s[7], s[5], -s[1]]
    # n == 16
    t[8] = clamp(_jbtf(c8, s[8], c56, s[9]))
    t[9] = clamp(_jbtf(c56, s[8], -c8, s[9]))
    t[10] = clamp(_jbtf(c40, s[10], c24, s[11]))
    t[11] = clamp(_jbtf(c24, s[10], -c40, s[11]))
    t[12] = clamp(_jbtf(-c56, s[12], c8, s[13]))
    t[13] = clamp(_jbtf(c8, s[12], c56, s[13]))
    t[14] = clamp(_jbtf(-c24, s[14], c40, s[15]))
    t[15] = clamp(_jbtf(c40, s[14], c24, s[15]))
    s = t
    t = [None] * n
    for base in (0, 8):
        for i in range(4):
            t[base + i] = clamp(s[base + i] + s[base + 4 + i])
            t[base + 4 + i] = clamp(s[base + i] - s[base + 4 + i])
    s = t
    t = list(s)
    for base in (4, 12):
        t[base] = clamp(_jbtf(c16, s[base], c48, s[base + 1]))
        t[base + 1] = clamp(_jbtf(c48, s[base], -c16, s[base + 1]))
        t[base + 2] = clamp(_jbtf(-c48, s[base + 2], c16, s[base + 3]))
        t[base + 3] = clamp(_jbtf(c16, s[base + 2], c48, s[base + 3]))
    s = t
    t = [None] * n
    for base in (0, 4, 8, 12):
        for i in range(2):
            t[base + i] = clamp(s[base + i] + s[base + 2 + i])
            t[base + 2 + i] = clamp(s[base + i] - s[base + 2 + i])
    s = t
    t = list(s)
    for base in (2, 6, 10, 14):
        t[base] = clamp(_jbtf(c32, s[base], c32, s[base + 1]))
        t[base + 1] = clamp(_jbtf(c32, s[base], -c32, s[base + 1]))
    s = t
    return [s[0], -s[8], s[12], -s[4], s[6], -s[14], s[10], -s[2],
            s[3], -s[11], s[15], -s[7], s[5], -s[13], s[9], -s[1]]


def _japply_1d(kind: str, T, clamp):
    if kind == "dct":
        return _jidct(T, clamp)
    if kind != "adst":
        raise ValueError(f"unknown 1-D transform kind {kind!r}")
    return _jiadst(T, clamp)


def _clamp_fn(bit_depth: int):
    cb = bit_depth + 8
    lo, hi = -(1 << (cb - 1)), (1 << (cb - 1)) - 1
    return lambda x: x.clamp(lo, hi)


def _pass_rows(buf, kind, clamp):
    """1-D transform along the last axis of (B, n, n)."""
    n = buf.shape[-1]
    return torch.stack(_japply_1d(kind, [buf[:, :, i] for i in range(n)],
                                  clamp), dim=2)


def _pass_cols(buf, kind, clamp):
    """1-D transform along the middle axis of (B, n, n)."""
    n = buf.shape[-1]
    return torch.stack(_japply_1d(kind, [buf[:, i, :] for i in range(n)],
                                  clamp), dim=1)


def _finish(rows_out, pred, bit_depth, clamp, col_fn):
    n = rows_out.shape[-1]
    rs = recon._ROW_SHIFT[(n.bit_length() - 1, n.bit_length() - 1)]
    buf = clamp(_round2(rows_out, rs))
    res = _round2(col_fn(buf), 4)
    return (pred + res).clamp(0, (1 << bit_depth) - 1)


def inv_tx2d_add(dq: torch.Tensor, pred: torch.Tensor, bit_depth: int,
                 row_kind: str = "dct", col_kind: str = "dct"):
    """dq (B, n, n) int32 dequantized coefficients, pred (B, n, n)
    int32 -> spec-exact reconstruction (B, n, n) int32."""
    clamp = _clamp_fn(bit_depth)
    rows = _pass_rows(clamp(dq.to(torch.int32)), row_kind, clamp)
    return _finish(rows, pred.to(torch.int32), bit_depth, clamp,
                   lambda b: _pass_cols(b, col_kind, clamp))


def inv_tx2d_add_mixed(dq: torch.Tensor, pred: torch.Tensor,
                       bit_depth: int, row_adst: torch.Tensor,
                       col_adst: torch.Tensor):
    """inv_tx2d_add with per-block kinds: row_adst/col_adst (B,) bool
    select ADST over DCT for that block's row/column pass.  Both kinds
    run on the whole batch and each block keeps its own, so every block
    gets exactly the single-kind result."""
    clamp = _clamp_fn(bit_depth)
    buf = clamp(dq.to(torch.int32))
    rows = torch.where(row_adst[:, None, None],
                       _pass_rows(buf, "adst", clamp),
                       _pass_rows(buf, "dct", clamp))

    def cols(b):
        return torch.where(col_adst[:, None, None],
                           _pass_cols(b, "adst", clamp),
                           _pass_cols(b, "dct", clamp))

    return _finish(rows, pred.to(torch.int32), bit_depth, clamp, cols)


# ---------------------------------------------------------------------------
# quantization (the closures of jax_inter/jax_intra._encode_frame)
# ---------------------------------------------------------------------------

class Quantizer:
    """Deadzone quantizer and dequantizer for one (qindex, bit depth).

    quant: floor(|c| / q + 1 - qround) in float32, as the reference;
    dequant: the spec's 24-bit masked integer product."""

    def __init__(self, qindex: int, bit_depth: int, qround: float, device):
        self.dcq = int(recon.DC_Q[bit_depth][qindex])
        self.acq = int(recon.AC_Q[bit_depth][qindex])
        self.deadzone = torch.tensor(1.0 - qround, dtype=torch.float32,
                                     device=device)
        self.device = device
        self._dqf = {}
        self._dqi = {}

    def _dq_float(self, n: int, shift: int):
        m = self._dqf.get((n, shift))
        if m is None:
            m = torch.full((n, n), float(self.acq), dtype=torch.float32,
                           device=self.device)
            m[0, 0] = float(self.dcq)
            m = m / (1 << shift)
            self._dqf[(n, shift)] = m
        return m

    def _dq_int(self, n: int):
        m = self._dqi.get(n)
        if m is None:
            m = torch.full((n, n), self.acq, dtype=torch.int32,
                           device=self.device)
            m[0, 0] = self.dcq
            self._dqi[n] = m
        return m

    def quant(self, coef: torch.Tensor, n: int, shift: int):
        mag = coef.abs() / self._dq_float(n, shift) + self.deadzone
        lv = mag.floor().clamp(0, 32767).to(torch.int32)
        return torch.where(coef < 0, -lv, lv)

    def dequant(self, lv: torch.Tensor, n: int, shift: int):
        mag = (lv.abs() * self._dq_int(n)) & 0xFFFFFF
        return lv.sign() * (mag >> shift)

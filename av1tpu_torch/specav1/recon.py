# Copied from av1tpu/specav1/recon.py.
"""Spec-exact AV1 reconstruction: dequant, inverse transforms, intra
prediction (spec §7.11-7.13).

Numpy host implementation used by the conformance decoder; the TPU
encoder's recon loop must match it bit-for-bit.

The inverse DCT is implemented from the recursive factorization the
spec's stage lists follow; the construction was cross-checked
stage-by-stage against the explicit 4/8/16/32-point transforms:
  * input bit-reversal; even half recurses;
  * odd half: initial rotations pairing coefficient c with N-c at
    angle (128/N)*c, then for each level L: mirrored-pair adds with
    per-group alternating signs, then mirror-pair rotation fixups on
    the inner band with angles (128/M)*2^(L-1)*odd and a sign variant
    chosen by the low slot's group parity;
  * final cross adds with the even half.
Structure errors explode in the float-basis tests; bit-exact rounding
is proven by decoding libaom streams (tests/test_specav1_decode.py).
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

# --- tx types ---
(DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
 FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
 V_ADST, H_ADST, V_FLIPADST, H_FLIPADST) = range(16)

# per tx type: (row 1D, col 1D) where row transforms act along width
TX_1D = {
    DCT_DCT: ("dct", "dct"), ADST_DCT: ("dct", "adst"),
    DCT_ADST: ("adst", "dct"), ADST_ADST: ("adst", "adst"),
    FLIPADST_DCT: ("dct", "flipadst"), DCT_FLIPADST: ("flipadst", "dct"),
    FLIPADST_FLIPADST: ("flipadst", "flipadst"),
    ADST_FLIPADST: ("flipadst", "adst"), FLIPADST_ADST: ("adst", "flipadst"),
    IDTX: ("idtx", "idtx"), V_DCT: ("idtx", "dct"), H_DCT: ("dct", "idtx"),
    V_ADST: ("idtx", "adst"), H_ADST: ("adst", "idtx"),
    V_FLIPADST: ("idtx", "flipadst"), H_FLIPADST: ("flipadst", "idtx"),
}

COS_BIT = 12
_COS = np.round(np.cos(np.arange(65) * math.pi / 128) *
                (1 << COS_BIT)).astype(np.int64)
assert _COS[32] == 2896 and _COS[0] == 4096

SINPI = (0, 1321, 2482, 3344, 3803)
SQRT2 = 5793
INV_SQRT2 = 2896

_NPZ = Path(__file__).resolve().parent.parent / "encoder" / "entropy" / \
    "av1_default_cdfs.npz"
with np.load(_NPZ) as _z:
    DC_Q = {8: _z["dc_qlookup_8"].astype(np.int32),
            10: _z["dc_qlookup_10"].astype(np.int32)}
    AC_Q = {8: _z["ac_qlookup_8"].astype(np.int32),
            10: _z["ac_qlookup_10"].astype(np.int32),
            12: _z["ac_qlookup_12"].astype(np.int32)}
    SM_WEIGHTS = {4: _z["sm_weights"][0:4].astype(np.int32),
                  8: _z["sm_weights"][4:12].astype(np.int32),
                  16: _z["sm_weights"][12:28].astype(np.int32),
                  32: _z["sm_weights"][28:60].astype(np.int32),
                  64: _z["sm_weights"][60:124].astype(np.int32)}
    DR_DERIVATIVE = _z["dr_intra_derivative"].astype(np.int32)


def cos128(angle: int) -> int:
    angle &= 255
    if angle <= 64:
        return int(_COS[angle])
    if angle <= 128:
        return -int(_COS[128 - angle])
    if angle <= 192:
        return -int(_COS[angle - 128])
    return int(_COS[256 - angle])


def round2(x, n: int):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _btf(w0, x0, w1, x1):
    return round2(w0 * x0 + w1 * x1, COS_BIT)


def _bitrev(i: int, n: int) -> int:
    return int(format(i, f"0{n}b")[::-1], 2) if n else 0


# ---------------------------------------------------------------------------
# 1D inverse transforms over (size, batch) int64 arrays
# ---------------------------------------------------------------------------

def idct1d(T: list, clamp) -> list:
    """Generic inverse DCT; T = list of (batch,) arrays, natural
    coefficient order.  Returns sample-order outputs."""
    n = len(T)
    if n == 2:
        c32 = cos128(32)
        return [clamp(_btf(c32, T[0], c32, T[1])),
                clamp(_btf(c32, T[0], -c32, T[1]))]
    half = n // 2
    even = idct1d([T[2 * i] for i in range(half)], clamp)
    odd = _idct_odd([T[2 * i + 1] for i in range(half)], n, clamp)
    out = [None] * n
    for i in range(half):
        out[i] = clamp(even[i] + odd[half - 1 - i])
        out[n - 1 - i] = clamp(even[i] - odd[half - 1 - i])
    return out


def _idct_odd(O: list, full: int, clamp) -> list:
    """Odd ladder: O[k] = coefficient 2k+1 of a full-point DCT.
    Returns M = full/2 values in ladder slot order."""
    m = len(O)
    bits = m.bit_length() - 1
    unit = 64 // full
    # stage 1+2: bit-reversed placement & initial mirror rotations
    s = [None] * m
    for k in range(m // 2):
        coeff = 2 * _bitrev(k, bits) + 1      # odd coeff at slot k
        a = unit * coeff
        lo = O[(coeff - 1) // 2]
        hi = O[(full - coeff - 1) // 2]
        s[k] = clamp(_btf(cos128(64 - a), lo, -cos128(a), hi))
        s[m - 1 - k] = clamp(_btf(cos128(a), lo, cos128(64 - a), hi))
    if m == 2:
        return s
    # levels 1..bits-1: mirrored adds (per-group alternating signs),
    # then mirror-pair rotation fixups on the inner band
    for level in range(1, bits):
        g = 1 << level     # group size
        t = [None] * m
        for lo0 in range(0, m, g):
            gi = lo0 // g
            for i in range(g // 2):
                a_idx, b_idx = lo0 + i, lo0 + g - 1 - i
                if gi % 2 == 0:
                    t[a_idx] = clamp(s[a_idx] + s[b_idx])
                    t[b_idx] = clamp(s[a_idx] - s[b_idx])
                else:
                    t[a_idx] = clamp(-s[a_idx] + s[b_idx])
                    t[b_idx] = clamp(s[a_idx] + s[b_idx])
        s = t
        # rotate mirror pairs (j, m-1-j) where
        # j mod 2^(level+1) in [2^(level-1), 2^(level-1) + 2^level)
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
            ca, cb = cos128(a), cos128(64 - a)
            if (j // g) % 2 == 0:
                t[j] = clamp(_btf(-ca, s[j], cb, s[k]))
                t[k] = clamp(_btf(cb, s[j], ca, s[k]))
            else:
                t[j] = clamp(_btf(-cb, s[j], -ca, s[k]))
                t[k] = clamp(_btf(-ca, s[j], cb, s[k]))
        s = t
    return s


def iadst4(T: list, clamp) -> list:
    s1, s2, s3, s4 = SINPI[1], SINPI[2], SINPI[3], SINPI[4]
    x0, x1, x2, x3 = (t.astype(np.int64) for t in T)
    a0 = s1 * x0 + s4 * x2 + s2 * x3
    a1 = s2 * x0 - s1 * x2 - s4 * x3
    a2 = s3 * (x0 - x2 + x3)
    a3 = s3 * x1
    o0 = a0 + a3
    o1 = a1 + a3
    o2 = a2
    o3 = a0 + a1 - a3
    return [round2(o, 12) for o in (o0, o1, o2, o3)]


_IADST8_ANGLES = (4, 20, 36, 52)
_IADST16_ANGLES = (2, 10, 18, 26, 34, 42, 50, 58)


def iadst1d(T: list, clamp) -> list:
    n = len(T)
    if n == 4:
        return iadst4(T, clamp)
    angles = _IADST8_ANGLES if n == 8 else _IADST16_ANGLES
    # stage 1: reorder inputs: (n-1, 0, n-3, 2, n-5, 4, ...)
    s = []
    for k in range(n // 2):
        s.append(T[n - 1 - 2 * k])
        s.append(T[2 * k])
    # stage 2: paired rotations
    t = [None] * n
    for k in range(n // 2):
        a = angles[k]
        ca, cb = cos128(a), cos128(64 - a)
        t[2 * k] = clamp(_btf(ca, s[2 * k], cb, s[2 * k + 1]))
        t[2 * k + 1] = clamp(_btf(cb, s[2 * k], -ca, s[2 * k + 1]))
    s = t
    # stage 3: butterfly halves (i, i + n/2)
    t = [None] * n
    for i in range(n // 2):
        t[i] = clamp(s[i] + s[i + n // 2])
        t[i + n // 2] = clamp(s[i] - s[i + n // 2])
    s = t
    # stage 4: rotations within the second half
    t = list(s)
    h = n // 2
    if n == 8:
        rot = ((4, 5, 16), (6, 7, 48))
        t[4] = clamp(_btf(cos128(16), s[4], cos128(48), s[5]))
        t[5] = clamp(_btf(cos128(48), s[4], -cos128(16), s[5]))
        t[6] = clamp(_btf(-cos128(48), s[6], cos128(16), s[7]))
        t[7] = clamp(_btf(cos128(16), s[6], cos128(48), s[7]))
        s = t
        # stage 5: butterfly quarters
        t = [None] * n
        for base in (0, 4):
            for i in range(2):
                t[base + i] = clamp(s[base + i] + s[base + 2 + i])
                t[base + 2 + i] = clamp(s[base + i] - s[base + 2 + i])
        s = t
        # stage 6: cospi32 rotations on pairs (2,3) and (6,7)
        t = list(s)
        for base in (2, 6):
            t[base] = clamp(_btf(cos128(32), s[base], cos128(32),
                                 s[base + 1]))
            t[base + 1] = clamp(_btf(cos128(32), s[base], -cos128(32),
                                     s[base + 1]))
        s = t
        # stage 7: output permutation with alternating negation
        return [s[0], -s[4], s[6], -s[2], s[3], -s[7], s[5], -s[1]]
    # n == 16
    t[8] = clamp(_btf(cos128(8), s[8], cos128(56), s[9]))
    t[9] = clamp(_btf(cos128(56), s[8], -cos128(8), s[9]))
    t[10] = clamp(_btf(cos128(40), s[10], cos128(24), s[11]))
    t[11] = clamp(_btf(cos128(24), s[10], -cos128(40), s[11]))
    t[12] = clamp(_btf(-cos128(56), s[12], cos128(8), s[13]))
    t[13] = clamp(_btf(cos128(8), s[12], cos128(56), s[13]))
    t[14] = clamp(_btf(-cos128(24), s[14], cos128(40), s[15]))
    t[15] = clamp(_btf(cos128(40), s[14], cos128(24), s[15]))
    s = t
    # stage 5: butterflies (i, i+4) within each half
    t = [None] * n
    for base in (0, 8):
        for i in range(4):
            t[base + i] = clamp(s[base + i] + s[base + 4 + i])
            t[base + 4 + i] = clamp(s[base + i] - s[base + 4 + i])
    s = t
    # stage 6: rotations on slots 4..7 and 12..15 with (16, 48)
    t = list(s)
    for base in (4, 12):
        t[base] = clamp(_btf(cos128(16), s[base], cos128(48), s[base + 1]))
        t[base + 1] = clamp(_btf(cos128(48), s[base], -cos128(16),
                                 s[base + 1]))
        t[base + 2] = clamp(_btf(-cos128(48), s[base + 2], cos128(16),
                                 s[base + 3]))
        t[base + 3] = clamp(_btf(cos128(16), s[base + 2], cos128(48),
                                 s[base + 3]))
    s = t
    # stage 7: butterflies (i, i+2) within each quarter
    t = [None] * n
    for base in (0, 4, 8, 12):
        for i in range(2):
            t[base + i] = clamp(s[base + i] + s[base + 2 + i])
            t[base + 2 + i] = clamp(s[base + i] - s[base + 2 + i])
    s = t
    # stage 8: cospi32 rotations on pairs (2,3),(6,7),(10,11),(14,15)
    t = list(s)
    for base in (2, 6, 10, 14):
        t[base] = clamp(_btf(cos128(32), s[base], cos128(32), s[base + 1]))
        t[base + 1] = clamp(_btf(cos128(32), s[base], -cos128(32),
                                 s[base + 1]))
    s = t
    # stage 9: output permutation
    return [s[0], -s[8], s[12], -s[4], s[6], -s[14], s[10], -s[2],
            s[3], -s[11], s[15], -s[7], s[5], -s[13], s[9], -s[1]]


def iidentity(T: list, clamp) -> list:
    n = len(T)
    if n == 4:
        return [clamp(round2(t * SQRT2, 12)) for t in T]
    if n == 8:
        return [clamp(t * 2) for t in T]
    if n == 16:
        return [clamp(round2(t * 2 * SQRT2, 12)) for t in T]
    return [clamp(t * 4) for t in T]  # 32


def _apply_1d(kind: str, T: list, clamp) -> tuple[list, bool]:
    """Returns (outputs, flip) — flip means reverse output order."""
    if kind == "dct":
        return idct1d(T, clamp), False
    if kind == "adst":
        return iadst1d(T, clamp), False
    if kind == "flipadst":
        return iadst1d(T, clamp), True
    return iidentity(T, clamp), False


# row shift per (log2w, log2h); column shift is always 4
_ROW_SHIFT = {
    (2, 2): 0, (3, 3): 1, (4, 4): 2, (5, 5): 2, (6, 6): 2,
    (2, 3): 0, (3, 2): 0, (3, 4): 1, (4, 3): 1, (4, 5): 1, (5, 4): 1,
    (5, 6): 1, (6, 5): 1, (2, 4): 1, (4, 2): 1, (3, 5): 2, (5, 3): 2,
    (4, 6): 2, (6, 4): 2,
}


def inv_txfm_add(dq: np.ndarray, tx_type: int, pred: np.ndarray,
                 bit_depth: int) -> np.ndarray:
    """dq: (h, w) dequantized int coefficients; pred: (h, w) pixels.
    Returns reconstructed pixels."""
    h, w = dq.shape
    log2w, log2h = w.bit_length() - 1, h.bit_length() - 1
    row_kind, col_kind = TX_1D[tx_type]
    clamp_bits = bit_depth + 8
    lo, hi = -(1 << (clamp_bits - 1)), (1 << (clamp_bits - 1)) - 1

    def clamp(x):
        return np.clip(x, lo, hi)

    buf = dq.astype(np.int64)
    # 64-wide/tall: only 32 coefficients are coded; downscale sizes for
    # the 1D transforms that only exist up to 32 for adst/idtx handled
    # by callers (adst caps at 16 per spec)
    if (log2w + log2h) & 1:
        buf = round2(buf * INV_SQRT2, 12)
    buf = clamp(buf)
    # row transforms: each row is a length-w transform; batch over rows
    cols = [buf[:, i] for i in range(w)]
    row_out, rflip = _apply_1d(row_kind, cols, clamp)
    if rflip:
        row_out = row_out[::-1]
    buf = np.stack(row_out, axis=1)  # (h, w) sample-order columns
    rs = _ROW_SHIFT[(log2w, log2h)]
    buf = clamp(round2(buf, rs))
    # column transforms
    rows = [buf[i, :] for i in range(h)]
    col_out, cflip = _apply_1d(col_kind, rows, clamp)
    if cflip:
        col_out = col_out[::-1]
    buf = np.stack(col_out, axis=0)  # (h, w)
    res = round2(buf, 4)
    out = pred.astype(np.int64) + res
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(pred.dtype)


def dequant_coeffs(levels: np.ndarray, qindex: int, dc_delta: int,
                   ac_delta: int, bit_depth: int,
                   tx_w: int, tx_h: int) -> np.ndarray:
    """Spec dequant: dq = sign * (((|q| * dqv) & 0xFFFFFF) >> shift)."""
    dcq = int(DC_Q[bit_depth][np.clip(qindex + dc_delta, 0, 255)])
    acq = int(AC_Q[bit_depth][np.clip(qindex + ac_delta, 0, 255)])
    dqv = np.full(levels.shape, acq, np.int64)
    dqv.flat[0] = dcq
    # tx scale is AREA-based (libaom av1_get_tx_scale: pels>256 adds 1,
    # pels>1024 adds 1) — NOT max-dim (round-3 fix: 32x8 takes shift 0,
    # 64x16 shift 1; the max-dim rule over-shifted every 4:1 shape)
    pels = tx_w * tx_h
    shift = int(pels > 256) + int(pels > 1024)
    sign = np.sign(levels)
    mag = (np.abs(levels.astype(np.int64)) * dqv) & 0xFFFFFF
    return (sign * (mag >> shift)).astype(np.int64)


# ---------------------------------------------------------------------------
# intra prediction (spec §7.11.2)
# ---------------------------------------------------------------------------

(DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED,
 D203_PRED, D67_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED,
 PAETH_PRED) = range(13)
UV_CFL_PRED = 13

MODE_ANGLE = {V_PRED: 90, H_PRED: 180, D45_PRED: 45, D135_PRED: 135,
              D113_PRED: 113, D157_PRED: 157, D203_PRED: 203, D67_PRED: 67}


def predict_intra(frame: np.ndarray, x: int, y: int, w: int, h: int,
                  mode: int, angle_delta: int, bit_depth: int,
                  have_left: bool, have_above: bool,
                  n_top_right: int, n_bottom_left: int,
                  max_x: int | None = None,
                  max_y: int | None = None,
                  edge_filter: bool = False,
                  filt_type: int = 0) -> np.ndarray:
    """Predict a w×h block at (x, y) from reconstructed `frame` pixels.

    n_top_right / n_bottom_left: number of valid pixels beyond the
    block edge (0 if unavailable).  Edge upsampling/filtering is the
    enable_intra_edge_filter path, implemented in `filter_edges`
    callers; this base version covers the seq-disabled case.
    """
    base = 1 << (bit_depth - 1)
    fh, fw = frame.shape
    if max_x is not None:
        fw = min(fw, max_x + 1)
    if max_y is not None:
        fh = min(fh, max_y + 1)
    size = w + h
    above = np.empty(size, np.int32)
    left = np.empty(size, np.int32)
    if have_above:
        n_avail = max(1, min(w + n_top_right, fw - x, size))
        src = frame[y - 1, x:x + n_avail].astype(np.int32)
        above[:n_avail] = src
        above[n_avail:] = src[-1]
        if n_top_right <= 0:
            above[w:] = above[w - 1]
        else:
            lim = min(w + n_top_right, size)
            above[lim:] = above[lim - 1]
    elif have_left:
        above[:] = frame[y, x - 1]
    else:
        above[:] = base - 1
    if have_left:
        n_avail = max(1, min(h + n_bottom_left, fh - y, size))
        src = frame[y:y + n_avail, x - 1].astype(np.int32)
        left[:n_avail] = src
        left[n_avail:] = src[-1]
        if n_bottom_left <= 0:
            left[h:] = left[h - 1]
        else:
            lim = min(h + n_bottom_left, size)
            left[lim:] = left[lim - 1]
    elif have_above:
        left[:] = frame[y - 1, x]
    else:
        left[:] = base + 1
    if have_above and have_left:
        corner = int(frame[y - 1, x - 1])
    elif have_above:
        corner = int(frame[y - 1, x])
    elif have_left:
        corner = int(frame[y, x - 1])
    else:
        corner = base

    if mode == DC_PRED:
        if have_above and have_left:
            v = (above[:w].sum() + left[:h].sum() + ((w + h) >> 1)) \
                // (w + h)
        elif have_above:
            v = (above[:w].sum() + (w >> 1)) >> (w.bit_length() - 1)
        elif have_left:
            v = (left[:h].sum() + (h >> 1)) >> (h.bit_length() - 1)
        else:
            v = base
        return np.full((h, w), v, np.int32)
    if mode == V_PRED and angle_delta == 0:
        return np.tile(above[:w], (h, 1))
    if mode == H_PRED and angle_delta == 0:
        return np.tile(left[:h][:, None], (1, w))
    if mode == PAETH_PRED:
        a = np.tile(above[:w], (h, 1))
        l_ = np.tile(left[:h][:, None], (1, w))
        pbase = a + l_ - corner
        pa = np.abs(pbase - a)
        pl = np.abs(pbase - l_)
        pc = np.abs(pbase - corner)
        out = np.where((pa <= pl) & (pa <= pc), a,
                       np.where(pl <= pc, l_, corner))
        return out.astype(np.int32)
    if mode in (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED):
        wv = SM_WEIGHTS[h]
        wh = SM_WEIGHTS[w]
        a = above[:w].astype(np.int64)
        l_ = left[:h].astype(np.int64)
        br = int(left[h - 1])
        rt = int(above[w - 1])
        i = np.arange(h)[:, None]
        j = np.arange(w)[None, :]
        if mode == SMOOTH_PRED:
            s = (wv[i] * a[j] + (256 - wv[i]) * br +
                 wh[j] * l_[i] + (256 - wh[j]) * rt)
            return round2(s, 9).astype(np.int32)
        if mode == SMOOTH_V_PRED:
            s = wv[i] * a[j] + (256 - wv[i]) * br
            return round2(s, 8).astype(np.int32)
        s = wh[j] * l_[i] + (256 - wh[j]) * rt
        return round2(s, 8).astype(np.int32)
    # directional
    p_angle = MODE_ANGLE[mode] + angle_delta * 3
    if edge_filter:
        return _predict_directional_edge(above, left, corner, w, h,
                                         p_angle, filt_type, have_above,
                                         have_left, x, y, fw, fh,
                                         bit_depth)
    return _predict_directional(above, left, corner, w, h, p_angle)


_EDGE_KERNELS = ((0, 4, 8, 4, 0), (0, 5, 6, 5, 0), (2, 4, 4, 4, 2))


def _edge_filter_strength(w, h, filt_type, delta):
    d = abs(delta)
    blk_wh = w + h
    s = 0
    if filt_type == 0:
        if blk_wh <= 8:
            if d >= 56:
                s = 1
        elif blk_wh <= 12:
            if d >= 40:
                s = 1
        elif blk_wh <= 16:
            if d >= 40:
                s = 1
        elif blk_wh <= 24:
            if d >= 8:
                s = 1
            if d >= 16:
                s = 2
            if d >= 32:
                s = 3
        elif blk_wh <= 32:
            s = 1
            if d >= 4:
                s = 2
            if d >= 32:
                s = 3
        else:
            s = 3
    else:
        if blk_wh <= 8:
            if d >= 40:
                s = 1
            if d >= 64:
                s = 2
        elif blk_wh <= 16:
            if d >= 20:
                s = 1
            if d >= 48:
                s = 2
        elif blk_wh <= 24:
            if d >= 4:
                s = 3
        else:
            s = 3
    return s


def _use_edge_upsample(w, h, filt_type, delta):
    d = abs(delta)
    blk_wh = w + h
    if d <= 0 or d >= 40:
        return 0
    return int(blk_wh <= 8) if filt_type == 1 else int(blk_wh <= 16)


def _apply_edge_filter(buf, sz, strength):
    """buf[0] is the corner; filters buf[1..sz-1] in place (spec
    intra_edge_filter)."""
    if strength == 0:
        return
    kern = _EDGE_KERNELS[strength - 1]
    orig = buf[:sz].copy()
    for i in range(1, sz):
        s = 0
        for j in range(5):
            k = min(max(i - 2 + j, 0), sz - 1)
            s += kern[j] * int(orig[k])
        buf[i] = (s + 8) >> 4


def _upsample_edge(buf, num_px, bit_depth):
    """buf[1] is index 0 (buf[0] = corner).  Returns a new array where
    index i maps to position (i - 2) / 2 relative to the old edge
    (spec intra_edge_upsample: positions -2..2*numPx-1 in half units).
    out[k] corresponds to old coordinate (k - 2) in half-sample units:
    out[2 + 2*i] = old[i], out[2 + 2*i - 1] = interpolated."""
    dup = np.empty(num_px + 3, np.int64)
    dup[0] = buf[0]
    dup[1] = buf[0]
    dup[2:2 + num_px] = buf[1:1 + num_px]
    dup[num_px + 2] = buf[num_px]
    out = np.empty(2 * num_px + 2, np.int64)
    out[0] = dup[0]  # position -2 (old corner)
    lim = (1 << bit_depth) - 1
    for i in range(num_px):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        s = min(max((s + 8) >> 4, 0), lim)
        out[2 * i + 1] = s          # position 2*i - 1
        out[2 * i + 2] = dup[i + 2]  # position 2*i
    return out


def _predict_directional_edge(above, left, corner, w, h, p_angle,
                              filt_type, have_above, have_left, x, y,
                              fw, fh, bit_depth):
    """Directional prediction with the enable_intra_edge_filter path
    (corner smoothing, edge filtering, edge upsampling)."""
    ar = np.concatenate(([corner], above)).astype(np.int64)
    lc = np.concatenate(([corner], left)).astype(np.int64)
    if 90 < p_angle < 180 and (w + h) >= 24 and have_left and have_above:
        s = (int(lc[1]) * 5 + int(ar[0]) * 6 + int(ar[1]) * 5 + 8) >> 4
        ar[0] = lc[0] = s
    if have_above and p_angle != 90:
        strength = _edge_filter_strength(w, h, filt_type, p_angle - 90)
        num_px = min(w, fw - x) + (h if p_angle < 90 else 0) + 1
        _apply_edge_filter(ar, num_px, strength)
    if have_left and p_angle != 180:
        strength = _edge_filter_strength(w, h, filt_type, p_angle - 180)
        num_px = min(h, fh - y) + (w if p_angle > 180 else 0) + 1
        _apply_edge_filter(lc, num_px, strength)
    up_above = _use_edge_upsample(w, h, filt_type, p_angle - 90) \
        if have_above else 0
    up_left = _use_edge_upsample(w, h, filt_type, p_angle - 180) \
        if have_left else 0
    if up_above:
        num_px = w + (h if p_angle < 90 else 0)
        au = _upsample_edge(ar, num_px, bit_depth)
    else:
        au = None
    if up_left:
        num_px = h + (w if p_angle > 180 else 0)
        lu = _upsample_edge(lc, num_px, bit_depth)
    else:
        lu = None

    def a_at(base):
        # base in (possibly upsampled) units; array origin at corner=-1
        if up_above:
            return int(au[min(max(base + 2, 0), len(au) - 1)])
        return int(ar[min(max(base + 1, 0), len(ar) - 1)])

    def l_at(base):
        if up_left:
            return int(lu[min(max(base + 2, 0), len(lu) - 1)])
        return int(lc[min(max(base + 1, 0), len(lc) - 1)])

    out = np.zeros((h, w), np.int32)
    if p_angle < 90:
        dx = int(DR_DERIVATIVE[p_angle])
        max_base = (w + h - 1) << up_above
        for i in range(h):
            for j in range(w):
                idx = (i + 1) * dx
                base = (idx >> (6 - up_above)) + (j << up_above)
                shift = ((idx << up_above) >> 1) & 0x1F
                if base >= max_base:
                    out[i, j] = a_at(max_base)
                else:
                    out[i, j] = round2(
                        a_at(base) * (32 - shift) +
                        a_at(base + 1) * shift, 5)
        return out
    if p_angle > 180:
        dy = int(DR_DERIVATIVE[270 - p_angle])
        max_base = (w + h - 1) << up_left
        for i in range(h):
            for j in range(w):
                idx = (j + 1) * dy
                base = (idx >> (6 - up_left)) + (i << up_left)
                shift = ((idx << up_left) >> 1) & 0x1F
                if base >= max_base:
                    out[i, j] = l_at(max_base)
                else:
                    out[i, j] = round2(
                        l_at(base) * (32 - shift) +
                        l_at(base + 1) * shift, 5)
        return out
    dx = int(DR_DERIVATIVE[180 - p_angle])
    dy = int(DR_DERIVATIVE[p_angle - 90])
    for i in range(h):
        for j in range(w):
            idx = (j << 6) - (i + 1) * dx
            base = idx >> (6 - up_above)
            if base >= -(1 << up_above):
                shift = ((idx << up_above) >> 1) & 0x1F
                out[i, j] = round2(a_at(base) * (32 - shift) +
                                   a_at(base + 1) * shift, 5)
            else:
                idx2 = (i << 6) - (j + 1) * dy
                base2 = idx2 >> (6 - up_left)
                shift = ((idx2 << up_left) >> 1) & 0x1F
                out[i, j] = round2(l_at(base2) * (32 - shift) +
                                   l_at(base2 + 1) * shift, 5)
    return out


def _predict_directional(above, left, corner, w, h, p_angle):
    out = np.zeros((h, w), np.int32)
    # AboveRow[-1] = corner convention: build arrays with offset 1
    ar = np.concatenate(([corner], above)).astype(np.int32)
    lc = np.concatenate(([corner], left)).astype(np.int32)
    if p_angle < 90:
        dx = int(DR_DERIVATIVE[p_angle])
        for i in range(h):
            for j in range(w):
                idx = (i + 1) * dx
                base_i = (idx >> 6) + j
                shift = (idx >> 1) & 0x1F
                mx = w + h - 1
                if base_i > mx:
                    out[i, j] = ar[1 + mx]
                else:
                    b = min(base_i, mx)
                    b1 = min(base_i + 1, mx)
                    out[i, j] = round2(ar[1 + b] * (32 - shift) +
                                       ar[1 + b1] * shift, 5)
        return out
    if p_angle > 180:
        dy = int(DR_DERIVATIVE[270 - p_angle])
        for i in range(h):
            for j in range(w):
                idx = (j + 1) * dy
                base_i = (idx >> 6) + i
                shift = (idx >> 1) & 0x1F
                mx = w + h - 1
                b = min(base_i, mx)
                b1 = min(base_i + 1, mx)
                out[i, j] = round2(lc[1 + b] * (32 - shift) +
                                   lc[1 + b1] * shift, 5)
        return out
    # zone 2: 90 < angle < 180 (and exactly 90/180 handled by V/H)
    dx = int(DR_DERIVATIVE[180 - p_angle])
    dy = int(DR_DERIVATIVE[p_angle - 90])
    for i in range(h):
        for j in range(w):
            idx = (j << 6) - (i + 1) * dx
            base_i = idx >> 6
            if base_i >= -1:
                shift = (idx >> 1) & 0x1F
                out[i, j] = round2(ar[1 + base_i] * (32 - shift) +
                                   ar[1 + base_i + 1] * shift, 5)
            else:
                idx2 = (i << 6) - (j + 1) * dy
                base2 = idx2 >> 6
                shift = (idx2 >> 1) & 0x1F
                out[i, j] = round2(lc[1 + base2] * (32 - shift) +
                                   lc[1 + base2 + 1] * shift, 5)
    return out

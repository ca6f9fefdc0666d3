# Copied from av1tpu/specav1/cdef.py.
"""Spec AV1 CDEF (constrained directional enhancement filter, spec
7.15), vectorized in numpy.

This is the normative host reference: the port's spec decoder applies
it to decode CDEF-enabled streams, and the encoders' tensor version
(specav1.torch_cdef) takes its tables from here.  The external
conformance oracle is libaom decoding CDEF-enabled streams to the same
planes.

Scope: 4:2:0, cdef_bits = 0 (one strength pair per frame — our encoder
emits no per-64x64 cdef_idx bits), any damping, 8/10-bit.

Process recap (what the numbers below implement):
  * the frame splits into 8x8 luma units; a unit is filtered unless
    all four covering 4x4 MIs are coded skip;
  * per unit, an 8-way directional search over partial-sum variances
    picks the filter direction and yields a variance that modulates the
    luma primary strength;
  * each pixel mixes 4 primary taps (along the direction) and 8
    secondary taps (along the two 45-degree-off directions) through a
    damped constraint function, then clamps to the min/max of the taps
    actually available;
  * chroma (4:2:0) filters 4x4 units with the co-located luma unit's
    direction, damping reduced by 1, and no variance modulation.

Reference behavior replaced: the in-loop CDEF of the exec'd ffmpeg's
av1_vaapi encoder (internal/ffmpeg/transcode.go:119-123).
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 30000

# Cdef_Directions[dir][k]: (dy, dx) of the k-th primary tap distance
DIRECTIONS = np.array([
    [[-1, 1], [-2, 2]],
    [[0, 1], [-1, 2]],
    [[0, 1], [0, 2]],
    [[0, 1], [1, 2]],
    [[1, 1], [2, 2]],
    [[1, 0], [2, 1]],
    [[1, 0], [2, 0]],
    [[1, 0], [2, -1]],
], np.int32)

PRI_TAPS = np.array([[4, 2], [3, 3]], np.int32)   # [pri_strength & 1]
SEC_TAPS = np.array([2, 1], np.int32)

DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105],
                     np.int64)


def find_dir(blocks: np.ndarray, coeff_shift: int):
    """Direction search (spec 7.15.2) for B 8x8 blocks at once.

    blocks: (B, 8, 8) int arrays of post-deblock pixels.
    Returns (dir (B,), var (B,)).
    """
    B = blocks.shape[0]
    x = (blocks.astype(np.int64) >> coeff_shift) - 128
    i = np.arange(8)[:, None] + np.zeros((1, 8), np.int64)
    j = np.arange(8)[None, :] + np.zeros((8, 1), np.int64)
    i = i.astype(np.int64)
    j = j.astype(np.int64)
    bins = [
        i + j,              # d0: 15 bins
        i + j // 2,         # d1: 11 bins
        i,                  # d2: 8 bins
        3 + i - j // 2,     # d3: 11 bins
        7 + i - j,          # d4: 15 bins
        3 - i // 2 + j,     # d5: 11 bins
        j,                  # d6: 8 bins
        i // 2 + j,         # d7: 11 bins
    ]
    cost = np.zeros((8, B), np.int64)
    partials = []
    for d in range(8):
        nb = int(bins[d].max()) + 1
        onehot = (bins[d].reshape(64)[None, :] ==
                  np.arange(nb)[:, None]).astype(np.int64)  # (nb, 64)
        p = x.reshape(B, 64) @ onehot.T                      # (B, nb)
        partials.append(p)
    for d in (2, 6):
        cost[d] = 105 * (partials[d] ** 2).sum(axis=1)
    for d in (0, 4):
        p = partials[d]
        for k in range(7):
            cost[d] += (p[:, k] ** 2 + p[:, 14 - k] ** 2) * DIV_TABLE[k + 1]
        cost[d] += p[:, 7] ** 2 * DIV_TABLE[8]
    for d in (1, 3, 5, 7):
        p = partials[d]
        cost[d] += 105 * (p[:, 3:8] ** 2).sum(axis=1)
        for k in range(3):
            cost[d] += (p[:, k] ** 2 + p[:, 10 - k] ** 2) * \
                DIV_TABLE[2 * k + 2]
    best = np.argmax(cost, axis=0)
    best_cost = cost[best, np.arange(B)]
    var = (best_cost - cost[(best + 4) & 7, np.arange(B)]) >> 10
    return best.astype(np.int32), var.astype(np.int64)


def _floor_log2(v: int) -> int:
    return max(0, int(v).bit_length() - 1)


def constrain(diff: np.ndarray, strength: int, damping: int) -> np.ndarray:
    """Damped difference constraint (spec 7.15.3 constrain())."""
    if strength == 0:
        return np.zeros_like(diff)
    shift = max(0, damping - _floor_log2(strength))
    ad = np.abs(diff)
    v = np.minimum(ad, np.maximum(0, strength - (ad >> shift)))
    return np.where(diff < 0, -v, v).astype(diff.dtype)


def _filter_plane(plane: np.ndarray, dirs: np.ndarray, variances,
                  skip8: np.ndarray, pri_str: int, sec_str: int,
                  damping: int, coeff_shift: int, nh: int, nw: int,
                  blk: int, is_luma: bool) -> np.ndarray:
    """Filter one plane.  dirs/skip8: per-unit grids (uh, uw) where the
    unit is blk x blk pixels.  nh/nw: available plane area (MI-aligned
    coded dims); taps outside are treated as unavailable."""
    uh, uw = dirs.shape
    out = plane.astype(np.int64).copy()
    if (pri_str == 0 and sec_str == 0) or not (nh and nw):
        return out
    # padded source with unavailable ring
    pad = 2
    src = np.full((nh + 2 * pad, nw + 2 * pad), CDEF_VERY_LARGE, np.int64)
    src[pad:pad + nh, pad:pad + nw] = plane[:nh, :nw]

    # per-unit adjusted primary strength (luma variance modulation)
    if is_luma:
        vs = np.asarray(variances, np.int64).reshape(uh, uw)
        msb = np.zeros_like(vs)
        vv = vs >> 6
        nz = vv > 0
        msb[nz] = np.minimum(
            np.floor(np.log2(vv[nz].astype(np.float64))).astype(np.int64),
            12)
        pri_per_unit = np.where(
            vs != 0, (pri_str * (4 + msb) + 8) >> 4, 0)
    else:
        pri_per_unit = np.full((uh, uw), pri_str, np.int64)

    x = src[pad:pad + nh, pad:pad + nw]
    sum_ = np.zeros((nh, nw), np.int64)
    mx = x.copy()
    mn = x.copy()
    # broadcast per-unit values to pixels
    dmap = np.repeat(np.repeat(dirs, blk, 0), blk, 1)[:nh, :nw]
    pmap = np.repeat(np.repeat(pri_per_unit, blk, 0), blk, 1)[:nh, :nw]
    smap = np.repeat(np.repeat(skip8.astype(bool), blk, 0),
                     blk, 1)[:nh, :nw]

    def tap(dy_per_dir, dx_per_dir):
        """Gather the tap plane whose offset depends on the pixel's
        direction."""
        t = np.empty((nh, nw), np.int64)
        for d in range(8):
            m = dmap == d
            if not m.any():
                continue
            dy = int(dy_per_dir[d])
            dx = int(dx_per_dir[d])
            sh = src[pad + dy:pad + dy + nh, pad + dx:pad + dx + nw]
            t[m] = sh[m]
        return t

    def constrain_map(p, strength_map, damping_):
        """constrain() with a per-pixel strength map."""
        valid = p != CDEF_VERY_LARGE
        diff = np.where(valid, p - x, 0)
        ad = np.abs(diff)
        s = np.asarray(strength_map, np.int64)
        # per-pixel shift = max(0, damping - FloorLog2(strength))
        fl = np.zeros_like(s)
        nzs = s > 0
        fl[nzs] = np.floor(
            np.log2(s[nzs].astype(np.float64))).astype(np.int64)
        shift = np.maximum(0, damping_ - fl)
        v = np.minimum(ad, np.maximum(0, s - (ad >> shift)))
        v = np.where(nzs, v, 0)
        c = np.where(diff < 0, -v, v)
        return c, valid

    for k in range(2):
        off = DIRECTIONS[:, k]           # (8, 2) per-dir (dy, dx)
        # tap pair selection uses the 8-bit-domain strength parity
        ptap = np.where(((pmap >> coeff_shift) & 1) != 0,
                        PRI_TAPS[1, k], PRI_TAPS[0, k])
        for sign in (1, -1):
            p = tap(sign * off[:, 0], sign * off[:, 1])
            c, valid = constrain_map(p, pmap, damping)
            sum_ += ptap * c
            mx = np.where(valid, np.maximum(p, mx), mx)
            mn = np.minimum(p, mn)
        for doff in (2, 6):
            soff = DIRECTIONS[(np.arange(8) + doff) & 7][:, k]  # (8,2)
            for sign in (1, -1):
                p = tap(sign * soff[:, 0], sign * soff[:, 1])
                valid = p != CDEF_VERY_LARGE
                diff = np.where(valid, p - x, 0)
                sum_ += int(SEC_TAPS[k]) * constrain(diff, sec_str,
                                                     damping)
                mx = np.where(valid, np.maximum(p, mx), mx)
                mn = np.minimum(p, mn)

    y = x + ((8 + sum_ - (sum_ < 0)) >> 4)
    y = np.clip(y, mn, mx)
    filt = np.where(smap, x, y)
    out[:nh, :nw] = filt
    return out


def cdef_frame(planes, skips4, *, y_pri: int, y_sec: int, uv_pri: int,
               uv_sec: int, damping: int, bit_depth: int = 8,
               th: int = 0, tw: int = 0):
    """Apply CDEF to (y, u, v) post-deblock planes.

    skips4: (mi_rows, mi_cols) coded skip flags on the 4x4 MI grid.
    th/tw: true (coded) luma dims; availability and the unit grid stop
    at the MI-aligned bound (8px granularity), matching the decoder's
    plane allocation.  Returns new (y, u, v) as int64 arrays.
    """
    yp, up, vp = planes
    H, W = yp.shape
    th = th or H
    tw = tw or W
    fh8 = ((th + 7) >> 3) << 3
    fw8 = ((tw + 7) >> 3) << 3
    cs = bit_depth - 8
    uh, uw = fh8 // 8, fw8 // 8

    # unit skip: all four covering MIs coded skip
    s4 = np.asarray(skips4, bool)
    s4 = s4[:2 * uh, :2 * uw]
    skip8 = (s4[0::2, 0::2] & s4[1::2, 0::2] &
             s4[0::2, 1::2] & s4[1::2, 1::2])

    if (y_pri | y_sec | uv_pri | uv_sec) == 0:
        return (yp.astype(np.int64), up.astype(np.int64),
                vp.astype(np.int64))

    # direction search on luma 8x8 units.  A plane class whose primary
    # strength is 0 filters with dir = 0 (the search result feeds only
    # primary taps; secondary offsets then hang off direction 0) —
    # verified against libaom in the strength sweep.
    blocks = yp[:fh8, :fw8].astype(np.int64).reshape(
        uh, 8, uw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    dirs, variances = find_dir(blocks, cs)
    dirs = dirs.reshape(uh, uw)
    zdirs = np.zeros_like(dirs)

    yo = _filter_plane(yp, dirs if y_pri else zdirs, variances, skip8,
                       y_pri << cs, y_sec << cs, damping + cs, cs,
                       fh8, fw8, 8, True)
    # chroma: 4x4 units, same (identity-remapped for 4:2:0) directions,
    # damping - 1, no variance modulation
    uvdirs = dirs if uv_pri else zdirs
    uo = _filter_plane(up, uvdirs, None, skip8, uv_pri << cs,
                       uv_sec << cs, damping - 1 + cs, cs,
                       fh8 // 2, fw8 // 2, 4, False)
    vo = _filter_plane(vp, uvdirs, None, skip8, uv_pri << cs,
                       uv_sec << cs, damping - 1 + cs, cs,
                       fh8 // 2, fw8 // 2, 4, False)
    return yo, uo, vo

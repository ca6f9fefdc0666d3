# Copied from av1tpu/specav1/lr.py.
"""Spec AV1 loop restoration (spec 7.17): Wiener + self-guided (SGR),
plus the per-RU tile syntax (spec 5.11.57/5.11.58).

This is the normative host reference, verified behaviorally against
system libaom (tests/test_spec_lr.py): our decoder replays
libaom-encoded LR streams bit-exactly, and our encoder's LR streams
decode bit-exactly in libaom.

Reference behavior replaced: the in-loop loop-restoration of the
exec'd ffmpeg's av1_vaapi encoder (internal/ffmpeg/transcode.go:119-123;
BASELINE config #4 names loop restoration explicitly).

Key structural facts (7.17.1):
  * filtering runs in STRIPES of 64 luma rows offset by -8 (first
    stripe is rows 0..55, then 56..119, ...); vertical taps that cross
    a stripe boundary read the POST-DEBLOCK PRE-CDEF pixels, clamped
    to +-2 rows beyond the stripe — never post-CDEF pixels of the
    neighboring stripe (this is what libaom's "save boundary lines"
    machinery implements);
  * restoration units (RUs) tile the plane at LoopRestorationSize with
    the unit-row grid ALSO offset by -8 (RESTORATION_UNIT_OFFSET), the
    last unit in each direction absorbing the remainder;
  * horizontal taps clamp at frame edges only (RU column boundaries
    filter across, using post-CDEF pixels).
"""

from __future__ import annotations

import numpy as np

RESTORE_NONE = 0
RESTORE_WIENER = 1
RESTORE_SGRPROJ = 2
RESTORE_SWITCHABLE = 3

FILTER_BITS = 7
WIENER_COEFF = 3          # free coeffs per half (tap 0..2)
# per-tap (min, max, subexp k); spec Wiener_Taps_*
WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)
WIENER_TAPS_MID = (3, -7, 15)

SGRPROJ_PARAMS_BITS = 4
SGRPROJ_PRJ_SUBEXP_K = 4
SGRPROJ_PRJ_BITS = 7
SGRPROJ_RST_BITS = 4
SGRPROJ_MTABLE_BITS = 20
SGRPROJ_SGR_BITS = 8
SGRPROJ_RECIP_BITS = 12
SGRPROJ_PRJ_MIN0, SGRPROJ_PRJ_MAX0 = -96, 31
SGRPROJ_PRJ_MIN1, SGRPROJ_PRJ_MAX1 = -32, 95

# Sgr_Params[set] = (r0, e0, r1, e1) — spec section 7.17.3 table.
SGR_PARAMS = (
    (2, 12, 1, 4), (2, 15, 1, 6), (2, 18, 1, 9), (2, 21, 1, 12),
    (2, 24, 1, 14), (2, 29, 1, 18), (2, 36, 1, 24), (2, 45, 1, 32),
    (2, 56, 1, 40), (2, 68, 1, 48), (2, 80, 1, 53), (2, 95, 1, 56),
    (2, 35, 1, 12), (2, 75, 1, 26), (2, 90, 1, 34), (2, 104, 1, 38),
)

RESTORATION_UNIT_OFFSET = 8


def count_units_in_frame(unit_size: int, frame_size: int) -> int:
    return max((frame_size + (unit_size >> 1)) // unit_size, 1)


def round2(x, n):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------
# Tile syntax (5.11.57 read_lr / 5.11.58 read_lr_unit).
#
# Subexp primitives mirror the spec's *_bool variants: literal
# (equiprobable) bits from the symbol decoder, golomb-free.

def _read_quniform(rd, n: int) -> int:
    """Quasi-uniform code for n symbols (spec ns(n) via bools)."""
    if n <= 1:
        return 0
    l = n.bit_length()          # floor(log2(n)) + 1 for n >= 1
    m = (1 << l) - n
    v = rd.read_literal(l - 1)
    if v < m:
        return v
    return (v << 1) - m + rd.read_literal(1)


def _read_subexp_fin(rd, n: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if n <= mk + 3 * a:
            return _read_quniform(rd, n - mk) + mk
        if rd.read_literal(1):
            i += 1
            mk += a
        else:
            return rd.read_literal(b2) + mk


def _inv_recenter_nonneg(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if (v & 1) == 0:
        return (v >> 1) + r
    return r - ((v + 1) >> 1)


def _inv_recenter_finite(n: int, r: int, v: int) -> int:
    if (r << 1) <= n:
        return _inv_recenter_nonneg(r, v)
    return n - 1 - _inv_recenter_nonneg(n - 1 - r, v)


def read_signed_subexp_with_ref(rd, low: int, high: int, k: int,
                                r: int) -> int:
    """decode_signed_subexp_with_ref_bool: value in [low, high)."""
    n = high - low
    x = _read_subexp_fin(rd, n, k)
    r = r - low
    return _inv_recenter_finite(n, r, x) + low


class LrState:
    """Per-frame LR syntax state: RU grids + subexp refs per plane."""

    def __init__(self, hdr, seq):
        self.types = list(hdr.lr.frame_restoration_type)
        self.sizes = list(hdr.lr.loop_restoration_size)
        self.seq = seq
        self.hdr = hdr
        self.unit_rows = [0] * 3
        self.unit_cols = [0] * 3
        self.wiener = {}     # (plane, ur, uc) -> (vfilt3, hfilt3) lists
        self.sgr = {}        # (plane, ur, uc) -> (set_idx, xqd0, xqd1)
        self.rtype = {}      # (plane, ur, uc) -> RESTORE_*
        self.reset_refs()
        for p in range(3):
            if self.types[p] == RESTORE_NONE:
                continue
            sub_x = 0 if p == 0 else seq.subsampling_x
            sub_y = 0 if p == 0 else seq.subsampling_y
            size = self.sizes[p]
            self.unit_rows[p] = count_units_in_frame(
                size, round2(hdr.frame_height, sub_y))
            self.unit_cols[p] = count_units_in_frame(
                size, round2(hdr.frame_width, sub_x))

    def reset_refs(self) -> None:
        """Subexp prediction refs reset at each TILE start (tiles are
        independently decodable; libaom av1_reset_loop_restoration)."""
        self.ref_wiener = [[list(WIENER_TAPS_MID), list(WIENER_TAPS_MID)]
                           for _ in range(3)]
        self.ref_sgr = [[0, 0] for _ in range(3)]

    # --- per-SB read hook (call before decode_partition) --------------
    def read_lr(self, td, r: int, c: int, bsize_w4: int,
                bsize_h4: int) -> None:
        if getattr(self.hdr, "allow_intrabc", 0):
            return
        for p in range(3):
            if self.types[p] == RESTORE_NONE:
                continue
            sub_x = 0 if p == 0 else self.seq.subsampling_x
            sub_y = 0 if p == 0 else self.seq.subsampling_y
            size = self.sizes[p]
            # spec 5.11.57: unitRowStart = ( MiRow * ( MI_SIZE >> subY )
            #   + unitSize - 1 ) / unitSize, MI_SIZE = 4 px (superres
            # off: numerator = denominator = 1 for the column form)
            urs = (r * (4 >> sub_y) + size - 1) // size
            ure = min(self.unit_rows[p],
                      ((r + bsize_h4) * (4 >> sub_y) + size - 1) // size)
            ucs = (c * (4 >> sub_x) + size - 1) // size
            uce = min(self.unit_cols[p],
                      ((c + bsize_w4) * (4 >> sub_x) + size - 1) // size)
            for ur in range(urs, ure):
                for uc in range(ucs, uce):
                    self._read_lr_unit(td, p, ur, uc)

    def _read_lr_unit(self, td, p: int, ur: int, uc: int) -> None:
        ftype = self.types[p]
        rd = td.r
        fc = td.fc
        if ftype == RESTORE_WIENER:
            use = rd.read_adapt(fc.restore_wiener)
            rtype = RESTORE_WIENER if use else RESTORE_NONE
        elif ftype == RESTORE_SGRPROJ:
            use = rd.read_adapt(fc.restore_sgrproj)
            rtype = RESTORE_SGRPROJ if use else RESTORE_NONE
        else:
            # restore_switchable's default CDF is not behaviorally
            # pinned yet (see tools/extract_cdfs.py NOTE) — decoding
            # with a wrong init would silently desync the tile
            raise NotImplementedError(
                "RESTORE_SWITCHABLE frames: switchable CDF unpinned")
        self.rtype[(p, ur, uc)] = rtype
        if rtype == RESTORE_WIENER:
            filts = []
            for pass_ in range(2):
                coeffs = [0, 0, 0]
                first = 1 if p else 0
                for j in range(first, 3):
                    mn, mx = WIENER_TAPS_MIN[j], WIENER_TAPS_MAX[j]
                    k = WIENER_TAPS_K[j]
                    v = read_signed_subexp_with_ref(
                        rd, mn, mx + 1, k, self.ref_wiener[p][pass_][j])
                    coeffs[j] = v
                    self.ref_wiener[p][pass_][j] = v
                filts.append(coeffs)
            self.wiener[(p, ur, uc)] = (filts[0], filts[1])
        elif rtype == RESTORE_SGRPROJ:
            set_idx = rd.read_literal(SGRPROJ_PARAMS_BITS)
            r0, _e0, r1, _e1 = SGR_PARAMS[set_idx]
            xqd = [0, 0]
            for i, rad in enumerate((r0, r1)):
                mn = SGRPROJ_PRJ_MIN0 if i == 0 else SGRPROJ_PRJ_MIN1
                mx = SGRPROJ_PRJ_MAX0 if i == 0 else SGRPROJ_PRJ_MAX1
                if rad:
                    v = read_signed_subexp_with_ref(
                        rd, mn, mx + 1, SGRPROJ_PRJ_SUBEXP_K,
                        self.ref_sgr[p][i])
                elif i == 1:
                    v = max(mn, min(mx, (1 << SGRPROJ_PRJ_BITS) - xqd[0]))
                else:
                    v = 0
                xqd[i] = v
                self.ref_sgr[p][i] = v
            self.sgr[(p, ur, uc)] = (set_idx, xqd[0], xqd[1])


# ---------------------------------------------------------------------
# Filters (7.17).  All operate on one full plane at a time.

def _wiener_7tap(c3) -> np.ndarray:
    c0, c1, c2 = c3
    return np.array([c0, c1, c2, 128 - 2 * (c0 + c1 + c2), c2, c1, c0],
                    np.int64)


def _stripe_ranges(h: int, sub_y: int):
    """[(start, end_inclusive)] stripe rows for a plane of height h."""
    sh = 64 >> sub_y
    off = RESTORATION_UNIT_OFFSET >> sub_y
    out = []
    y = 0
    first_end = sh - off - 1
    while y <= min(first_end, h - 1) and not out:
        out.append((0, min(first_end, h - 1)))
    y = first_end + 1
    while y < h:
        out.append((y, min(y + sh - 1, h - 1)))
        y += sh
    return out


def _padded_source(cdef_plane: np.ndarray, pre_plane: np.ndarray,
                   s0: int, s1: int, w: int):
    """(s1-s0+1+6, w+6) source window for one stripe: rows s0-3..s1+3,
    cols -3..w+2 — post-CDEF inside the stripe, pre-CDEF clamped to
    +-2 beyond it, 3-px edge replication at frame borders."""
    h = cdef_plane.shape[0]
    rows = []
    for yy in range(s0 - 3, s1 + 4):
        y = min(h - 1, max(0, yy))
        if y < s0:
            y2 = max(s0 - 2, y)
            rows.append(pre_plane[min(h - 1, max(0, y2))])
        elif y > s1:
            y2 = min(s1 + 2, y)
            rows.append(pre_plane[min(h - 1, max(0, y2))])
        else:
            rows.append(cdef_plane[y])
    src = np.stack(rows).astype(np.int64)
    left = np.repeat(src[:, :1], 3, axis=1)
    right = np.repeat(src[:, -1:], 3, axis=1)
    return np.concatenate([left, src[:, :w], right], axis=1)


def wiener_stripe(src: np.ndarray, vfilt, hfilt, x0: int, x1: int,
                  bit_depth: int) -> np.ndarray:
    """Filter columns [x0, x1) of one stripe.  src: _padded_source
    output ((rows+6, w+6) with 3-px pads).  Returns (rows, x1-x0)."""
    r0b = 5 if bit_depth == 12 else 3
    r1b = 9 if bit_depth == 12 else 11
    hf = _wiener_7tap(hfilt)
    vf = _wiener_7tap(vfilt)
    nrows = src.shape[0] - 6
    ncols = x1 - x0
    offset = 1 << (bit_depth + FILTER_BITS - r0b - 1)
    limit = (1 << (bit_depth + 1 + FILTER_BITS - r0b)) - 1
    # horizontal pass over rows s0-3..s1+3 (vertical taps need them)
    inter = np.zeros((nrows + 6, ncols), np.int64)
    base = 1 << (bit_depth + FILTER_BITS - 1)
    for t in range(7):
        inter += hf[t] * src[:, 3 + x0 + t - 3: 3 + x0 + t - 3 + ncols]
    inter = round2(inter + base, r0b)
    inter = np.clip(inter, 0, limit)
    # vertical pass
    out = np.zeros((nrows, ncols), np.int64)
    for t in range(7):
        out += vf[t] * inter[t:t + nrows]
    v = round2(out - (base << (FILTER_BITS - r0b)), r1b)
    return np.clip(v, 0, (1 << bit_depth) - 1)


def _box_sums(src: np.ndarray, r: int):
    """(sum, sum of squares) over (2r+1)^2 windows, same-size output.
    src is pre-padded by >= r on all sides; returns for the inner
    region."""
    c = np.cumsum(np.cumsum(src, axis=0, dtype=np.int64), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = src.shape
    n = 2 * r + 1
    oh, ow = h - 2 * r, w - 2 * r
    s = (c[n:n + oh, n:n + ow] - c[0:oh, n:n + ow]
         - c[n:n + oh, 0:ow] + c[0:oh, 0:ow])
    return s


def sgr_filter(cdef_plane: np.ndarray, pre_plane: np.ndarray,
               s0: int, s1: int, x0: int, x1: int, set_idx: int,
               xqd0: int, xqd1: int, bit_depth: int) -> np.ndarray:
    """Self-guided restoration (7.17.3) for stripe rows [s0, s1],
    columns [x0, x1)."""
    w = cdef_plane.shape[1]
    src = _padded_source(cdef_plane, pre_plane, s0, s1, w)
    nrows = s1 - s0 + 1
    ncols = x1 - x0
    # working window: rows -3..+3 of stripe, cols x0-3..x1+2
    win = src[:, x0:x1 + 6]
    r0, e0, r1, e1 = SGR_PARAMS[set_idx]
    outputs = []
    for (rad, eps) in ((r0, e0), (r1, e1)):
        if rad == 0:
            outputs.append(None)
            continue
        outputs.append(_sgr_pass(win, nrows, ncols, rad, eps, bit_depth))
    u = win[3:3 + nrows, 3:3 + ncols].astype(np.int64)
    v = u << SGRPROJ_RST_BITS    # unfiltered at RST precision
    w0, w1 = xqd0, xqd1
    w2 = (1 << SGRPROJ_PRJ_BITS) - w0 - w1
    acc = np.zeros((nrows, ncols), np.int64)
    for wi, f in zip((w0, w2, w1), (outputs[0], v, outputs[1])):
        acc += wi * (v if f is None else f)
    out = round2(acc, SGRPROJ_PRJ_BITS + SGRPROJ_RST_BITS)
    return np.clip(out, 0, (1 << bit_depth) - 1)


def _sgr_pass(win: np.ndarray, nrows: int, ncols: int, rad: int,
              eps: int, bit_depth: int) -> np.ndarray:
    """One SGR pass: win is the (nrows+6, ncols+6) padded window with
    the filtered region at [3:3+nrows, 3:3+ncols].  Returns
    (nrows, ncols) filtered values at SGRPROJ_RST_BITS extra
    precision."""
    # a/b are needed at every pixel of the filtered region plus a
    # 1-px ring
    shift = 2 * (bit_depth - 8)
    n = (2 * rad + 1) ** 2
    # stats over windows centered at each ring pixel: need win pixels
    # rad beyond the ring -> slice accordingly (3 - 1 - rad offset)
    o = 3 - 1 - rad
    sub = win[o:o + nrows + 2 + 2 * rad, o:o + ncols + 2 + 2 * rad]
    s = _box_sums(sub, rad)
    sub2 = sub * sub
    s2 = _box_sums(sub2, rad)
    # a = s2*n - s^2 (variance*n^2), rounded at high bit depth
    a = round2(s2, shift) * n - round2(s, shift // 2) ** 2
    a = np.maximum(a, 0)
    p = a * eps
    z = round2(a * eps, SGRPROJ_MTABLE_BITS)
    del p
    a255 = np.where(z >= 255, 256,
                    np.where(z == 0, 1, ((z << SGRPROJ_SGR_BITS)
                                         + (z >> 1)) // (z + 1)))
    one_over_n = ((1 << SGRPROJ_RECIP_BITS) + (n >> 1)) // n
    b = ((1 << SGRPROJ_SGR_BITS) - a255) * s * one_over_n
    b = round2(b, SGRPROJ_RECIP_BITS)
    # cross-neighborhood weighted sums of a/b (3x3 with weights
    # depending on parity for r=2)
    A = a255
    B = b
    out = np.zeros((nrows, ncols), np.int64)
    u = win[3:3 + nrows, 3:3 + ncols].astype(np.int64)
    if rad == 2:
        # r=2: a/b averaged over 5 taps on even rows pattern; spec uses
        # every-other-row weighting: rows y%2==0 use (5,6,5) row above/
        # below pattern
        for yy in range(nrows):
            ay = yy + 1  # index into A grid (ring offset 1)
            if yy % 2 == 0:
                w_a = (A[ay - 1, 0:ncols] * 5 + A[ay - 1, 1:ncols + 1] * 6
                       + A[ay - 1, 2:ncols + 2] * 5
                       + A[ay + 1, 0:ncols] * 5 + A[ay + 1, 1:ncols + 1] * 6
                       + A[ay + 1, 2:ncols + 2] * 5)
                w_b = (B[ay - 1, 0:ncols] * 5 + B[ay - 1, 1:ncols + 1] * 6
                       + B[ay - 1, 2:ncols + 2] * 5
                       + B[ay + 1, 0:ncols] * 5 + B[ay + 1, 1:ncols + 1] * 6
                       + B[ay + 1, 2:ncols + 2] * 5)
                sh = 5
            else:
                w_a = (A[ay, 0:ncols] * 5 + A[ay, 1:ncols + 1] * 6
                       + A[ay, 2:ncols + 2] * 5)
                w_b = (B[ay, 0:ncols] * 5 + B[ay, 1:ncols + 1] * 6
                       + B[ay, 2:ncols + 2] * 5)
                sh = 4
            vrow = w_a * u[yy] + w_b
            out[yy] = round2(vrow,
                             SGRPROJ_SGR_BITS + sh - SGRPROJ_RST_BITS)
    else:
        # r=1: full 3x3 with weights (3,4,3 / 4,4,4? spec: center 4
        # pattern) — weights: corners 3, edges 4, center 4... total 30?
        wts = np.array([[3, 4, 3], [4, 4, 4], [3, 4, 3]], np.int64)
        for yy in range(nrows):
            ay = yy + 1
            w_a = np.zeros(ncols, np.int64)
            w_b = np.zeros(ncols, np.int64)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    wt = wts[dy + 1, dx + 1]
                    w_a += wt * A[ay + dy, 1 + dx:1 + dx + ncols]
                    w_b += wt * B[ay + dy, 1 + dx:1 + dx + ncols]
            vrow = w_a * u[yy] + w_b
            out[yy] = round2(vrow,
                             SGRPROJ_SGR_BITS + 5 - SGRPROJ_RST_BITS)
    return out


def apply_lr_frame(state: LrState, cdef_planes, pre_planes,
                   bit_depth: int, th: int, tw: int):
    """Apply loop restoration to post-CDEF planes (pre_planes: the
    post-deblock pre-CDEF planes used at stripe boundaries).  Returns
    new (y, u, v)."""
    seq = state.seq
    outs = []
    for p in range(3):
        cdefp = np.asarray(cdef_planes[p], np.int64)
        prep = np.asarray(pre_planes[p], np.int64)
        if state.types[p] == RESTORE_NONE:
            outs.append(cdefp)
            continue
        sub_x = 0 if p == 0 else seq.subsampling_x
        sub_y = 0 if p == 0 else seq.subsampling_y
        w = round2(tw, sub_x)
        h = round2(th, sub_y)
        # LR edge clamping is against the VISIBLE frame dims (spec
        # 7.17.1 get_source_sample clamps to RestorationWidth/Height),
        # not the SB-padded recon planes the decoder carries — slice
        # first so bottom/right taps replicate the true frame edge
        # (round-3 fix: 160-tall frames read 192-tall padding rows)
        cdefp = cdefp[:h, :w]
        prep = prep[:h, :w]
        size = state.sizes[p]
        ucols = state.unit_cols[p]
        urows = state.unit_rows[p]
        off = RESTORATION_UNIT_OFFSET >> sub_y
        # reference slots keep the SB-padded area: restore into a
        # full-size copy, filtering only the visible region
        full = np.asarray(cdef_planes[p], np.int64).copy()
        out = cdefp.copy()
        for (s0, s1) in _stripe_ranges(h, sub_y):
            src = None
            ur = min(urows - 1, (s0 + off) // size)
            for uc in range(ucols):
                x0 = uc * size
                x1 = min(w, (uc + 1) * size) if uc < ucols - 1 else w
                rtype = state.rtype.get((p, ur, uc), RESTORE_NONE)
                if rtype == RESTORE_NONE:
                    continue
                if rtype == RESTORE_WIENER:
                    if src is None:
                        src = _padded_source(cdefp, prep, s0, s1, w)
                    vf, hf = state.wiener[(p, ur, uc)]
                    out[s0:s1 + 1, x0:x1] = wiener_stripe(
                        src, vf, hf, x0, x1, bit_depth)
                else:
                    si, x0q, x1q = state.sgr[(p, ur, uc)]
                    if (x0q, x1q) != (0, 0):
                        # identity projection (xqd 0,0) is exact by
                        # construction; the box-filter internals are
                        # not yet verified against libaom
                        raise NotImplementedError(
                            "non-identity SGR filter unverified")
                    out[s0:s1 + 1, x0:x1] = sgr_filter(
                        cdefp, prep, s0, s1, x0, x1, si, x0q, x1q,
                        bit_depth)
        full[:h, :w] = out
        outs.append(full)
    return outs[0], outs[1], outs[2]

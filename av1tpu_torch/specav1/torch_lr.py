"""Spec loop restoration on tensors: the Wiener apply and the encoders'
per-restoration-unit search (port of ``av1tpu/specav1/jax_lr.py``).

The apply is the spec's integer arithmetic (the numpy
``specav1/lr.py``), bit-exact, with the stripe-boundary rule as a row
gather: each of the seven vertical taps reads, per output row, one row
of the horizontally filtered post-CDEF plane or of the pre-CDEF one
(rows within +-2 beyond a 64-row stripe read the pre-CDEF plane, and
everything clamps at the frame's edges as the spec does).  The
reference restates that gather as shifts and masked selects, and
broadcasts per-unit values by static repeats, for its hardware; here
they are index gathers.

The search, per 256-px restoration unit (RU) of the luma plane, weighs
the eight static presets (one batched apply) and one solved tap pair:
separable Wiener normal equations (horizontal taps against the post-CDEF
plane, then vertical taps against the exact horizontally filtered
intermediate), solved in closed form and quantized to the spec's tap
ranges.  The best candidate by SSE against the source turns its RU on
when it beats a fixed charge for the unit's syntax.

Exactness.  Every SSE and every normal-equation term is an integer (the
vertical residual a multiple of 1/16), summed exactly in int64 per RU
and converted to float32 once; the 3x3 solve then runs as separate
elementwise float32 operations in the reference's order, so CPU and GPU
choose the same taps.  The reference sums in float32 and can differ
where those sums pass 2**24.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.specav1 import lr as NL

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
FILTER_BITS = 7

# (tap0, tap1, tap2) presets, tied for both directions (the
# reference's jax_lr.PRESETS): mild to strong smoothing, band and
# sharpen shapes, all within the spec tap ranges
PRESETS = (
    (0, 1, 8),      # very mild
    (0, 2, 14),     # mild
    (1, 4, 20),     # medium
    (2, 7, 27),     # strong
    (3, -7, 15),    # band (the spec mid taps)
    (-1, 2, 20),    # detail-preserving medium
    (0, -4, 12),    # mild sharpen-band
    (-2, -5, 25),   # sharpen
)

# tap value ranges per position (spec wiener_info subexp bounds)
TAPS_MIN = (-5, -23, -17)
TAPS_MAX = (10, 8, 46)


def _rounds(bit_depth: int):
    r0b = 5 if bit_depth == 12 else 3
    r1b = 9 if bit_depth == 12 else 11
    return r0b, r1b, 1 << (bit_depth + FILTER_BITS - 1)


def _taps7(c3):
    """(..., 3) taps -> (7, ...) with the derived centre tap."""
    c0, c1, c2 = c3[..., 0], c3[..., 1], c3[..., 2]
    return torch.stack([c0, c1, c2, 128 - 2 * (c0 + c1 + c2), c2, c1, c0])


def _hfilter(raw, taps7, bit_depth: int):
    """Horizontal Wiener pass with 3-px edge replication and the spec's
    rounding and clamp.  raw: (..., nh, nw) int32; taps7: (7, ...)
    broadcasting against it (per preset or per pixel)."""
    r0b, _, base = _rounds(bit_depth)
    limit = (1 << (bit_depth + 1 + FILTER_BITS - r0b)) - 1
    nw = raw.shape[-1]
    cols = torch.arange(-3, nw + 3, device=raw.device).clamp(0, nw - 1)
    p = raw[..., cols]
    acc = taps7[0] * p[..., 0:nw]
    for t in range(1, 7):
        acc = acc + taps7[t] * p[..., t:t + nw]
    return ((acc + base + (1 << (r0b - 1))) >> r0b).clamp(0, limit)


def _stripe_row_plan(nh: int, sub_y: int):
    """(7, nh) source row per (tap, output row) and whether it reads the
    pre-CDEF plane, following the spec's get_source_sample: the
    frame-edge clamp first, then the stripe's +-2 rule."""
    sh = 64 >> sub_y
    off = NL.RESTORATION_UNIT_OFFSET >> sub_y
    rows = np.arange(nh)
    s = (rows + off) // sh
    s0 = np.maximum(s * sh - off, 0)
    s1 = np.minimum(s * sh - off + sh - 1, nh - 1)
    idx = np.zeros((7, nh), np.int64)
    pre = np.zeros((7, nh), bool)
    for t in range(7):
        yy = np.clip(rows + t - 3, 0, nh - 1)
        below = yy < s0
        above = yy > s1
        r = yy.copy()
        r[below] = np.maximum(s0[below] - 2, yy[below])
        r[above] = np.minimum(s1[above] + 2, yy[above])
        idx[t] = np.clip(r, 0, nh - 1)
        pre[t] = below | above
    return idx, pre


def _row_select(nh: int, sub_y: int, device):
    """(7, nh) rows of cat([post-CDEF, pre-CDEF], rows) per tap."""
    idx, pre = _stripe_row_plan(nh, sub_y)
    return torch.as_tensor(idx + nh * pre, device=device)


def wiener_apply(rec, pre, taps, nh: int, nw: int, sub_y: int,
                 bit_depth: int):
    """Spec Wiener filter of a whole plane with stripe semantics.

    rec: post-CDEF plane; pre: post-deblock pre-CDEF plane; taps: K
    (c0, c1, c2) triples, filtered in one batched pass.  Returns
    (K, nh, nw) int32."""
    dev = rec.device
    t = torch.as_tensor(np.asarray(taps, np.int32), device=dev)
    t7 = _taps7(t)[:, :, None, None]                         # (7, K, 1, 1)
    raw = torch.stack([rec[:nh, :nw], pre[:nh, :nw]]).to(I32)
    h = _hfilter(raw[:, None], t7[:, None], bit_depth)      # (2, K, nh, nw)
    h = torch.cat([h[0], h[1]], dim=1)                      # (K, 2nh, nw)
    return _vfilter(h, t7, _row_select(nh, sub_y, dev), bit_depth)


def _vfilter(h, t7, rowsel, bit_depth: int):
    """The vertical pass: h (..., 2nh, nw) the post- and pre-CDEF rows,
    t7 (7, ...) taps, rowsel (7, nh)."""
    r0b, r1b, base = _rounds(bit_depth)
    acc = t7[0] * h[..., rowsel[0], :]
    for t in range(1, 7):
        acc = acc + t7[t] * h[..., rowsel[t], :]
    v = (acc - (base << (FILTER_BITS - r0b)) + (1 << (r1b - 1))) >> r1b
    return v.clamp(0, (1 << bit_depth) - 1)


def _ru_index(nh: int, nw: int, size: int, urows: int, ucols: int,
              device):
    """The RU grid of an nh x nw plane: (unit row per pixel row, unit
    column per pixel column, size, urows, ucols), with the spec's
    RESTORATION_UNIT_OFFSET row shift and last-unit extension."""
    off = NL.RESTORATION_UNIT_OFFSET
    ur = np.minimum((np.arange(nh) + off) // size, urows - 1)
    uc = np.minimum(np.arange(nw) // size, ucols - 1)
    return (torch.as_tensor(ur, device=device),
            torch.as_tensor(uc, device=device), size, urows, ucols)


def _ru_reduce(delta, ru):
    """Exact per-RU sums of (..., nh, nw) integers: (..., urows *
    ucols) int64, row-major RU order (row bands, then column bands; the
    last band of each axis takes the remainder)."""
    _, _, size, urows, ucols = ru
    off = NL.RESTORATION_UNIT_OFFSET
    lead = delta.shape[:-2]
    nh, nw = delta.shape[-2:]
    rb, cb = -(-(nh + off) // size), -(-nw // size)
    d = torch.zeros(lead + (rb * size, cb * size), dtype=I64,
                    device=delta.device)
    d[..., off:off + nh, :nw] = delta
    d = d.view(lead + (rb, size, cb, size)).sum((-3, -1))
    if rb > urows:
        d = torch.cat([d[..., :urows - 1, :],
                       d[..., urows - 1:, :].sum(-2, keepdim=True)], -2)
    if cb > ucols:
        d = torch.cat([d[..., :ucols - 1],
                       d[..., ucols - 1:].sum(-1, keepdim=True)], -1)
    return d.reshape(lead + (urows * ucols,))


def _basis3(x, axis: int):
    """The three symmetric-tap basis planes along ``axis`` (-1 columns,
    -2 rows): b_j(p) = x[p - (3 - j)] + x[p + (3 - j)] - 2 x[p],
    edge-replicated, int64."""
    n = x.shape[axis]
    x = x.to(I64)
    out = []
    for j in range(3):
        d = 3 - j
        lo = torch.arange(-d, n - d, device=x.device).clamp(0, n - 1)
        hi = torch.arange(d, n + d, device=x.device).clamp(0, n - 1)
        out.append(x.index_select(axis, lo) + x.index_select(axis, hi)
                   - 2 * x)
    return out


def _stats3(bs, e, ru, denom: int = 1):
    """Per-RU normal equations A (nru, 3, 3), r (nru, 3) as float32:
    each entry's integer sum taken exactly, converted once; r is the
    sum of e * b_j over ``denom`` (a power of two)."""
    ent = {}
    for j in range(3):
        for k in range(j, 3):
            ent[j, k] = _ru_reduce(bs[j] * bs[k], ru).to(F32)
    A = torch.stack([torch.stack([ent[min(j, k), max(j, k)]
                                  for k in range(3)], -1)
                     for j in range(3)], -2)
    r = torch.stack([_ru_reduce(e * bs[j], ru).to(F32) for j in range(3)],
                    -1)
    if denom != 1:
        r = r * (1.0 / denom)
    return A, r


def _solve_quant(A, r, scale: float):
    """c = -scale * A^-1 r per RU (3x3 adjugate, trace regularization
    and normalization), quantized to the spec's tap ranges (nru, 3)
    int32.  Separate float32 operations in the reference's order;
    divisions by tensors (a division by a host scalar may run as a
    multiplication by its reciprocal)."""
    dev = A.device

    def c(v):
        return torch.tensor(v, dtype=F32, device=dev)

    tr = (A[:, 0, 0] + A[:, 1, 1] + A[:, 2, 2]) / c(3.0) + c(1e-6)
    An = A / tr[:, None, None]
    An = An + c(1e-4) * torch.eye(3, dtype=F32, device=dev)
    rn = r / tr[:, None]
    a, b, cc = An[:, 0, 0], An[:, 0, 1], An[:, 0, 2]
    d, e, f = An[:, 1, 0], An[:, 1, 1], An[:, 1, 2]
    g, h, i = An[:, 2, 0], An[:, 2, 1], An[:, 2, 2]
    det = a * (e * i - f * h) - b * (d * i - f * g) + cc * (d * h - e * g)
    det = torch.where(det.abs() < c(1e-12), c(1e-12), det)
    adj = ((e * i - f * h, cc * h - b * i, b * f - cc * e),
           (f * g - d * i, a * i - cc * g, cc * d - a * f),
           (d * h - e * g, b * g - a * h, a * e - b * d))
    q = []
    for j in range(3):
        row = adj[j]
        s = row[0] * rn[:, 0] + row[1] * rn[:, 1] + row[2] * rn[:, 2]
        cf = c(-scale) * s / det
        # clamped before the conversion (the same taps as clamping
        # after it, without an out-of-range float-to-int conversion)
        cf = cf.clamp(TAPS_MIN[j], TAPS_MAX[j])
        q.append(torch.round(cf).to(I32))
    return torch.stack(q, -1)


def _ru_map(ru):
    """(nh, nw) RU id of every pixel."""
    ur, uc, _, _, ucols = ru
    return ur[:, None] * ucols + uc[None, :]


def _tap_maps(c3, ru):
    """(7, nh, nw) per-pixel taps from per-RU (nru, 3) taps."""
    return _taps7(c3)[:, _ru_map(ru)]


def _apply_rumap(rec, pre, tms_h, tms_v, nh: int, nw: int, sub_y: int,
                 bit_depth: int):
    """Spec Wiener apply with per-RU tap pairs.  Every output pixel
    filters its whole 7x7 window with its own unit's taps, so each
    vertical tap's source rows (post- or pre-CDEF by the stripe rule)
    are filtered horizontally with the output pixel's taps inside the
    vertical loop."""
    r0b, r1b, base = _rounds(bit_depth)
    raw = torch.cat([rec[:nh, :nw], pre[:nh, :nw]]).to(I32)
    rowsel = _row_select(nh, sub_y, rec.device)
    acc = None
    for t in range(7):
        h = _hfilter(raw[rowsel[t]], tms_h, bit_depth)
        acc = tms_v[t] * h if acc is None else acc + tms_v[t] * h
    v = (acc - (base << (FILTER_BITS - r0b)) + (1 << (r1b - 1))) >> r1b
    return v.clamp(0, (1 << bit_depth) - 1)


def lr_search_apply(rec_y, pre_y, src_y, bit_depth: int = 8, th: int = 0,
                    tw: int = 0, size: int = 256):
    """Per-RU Wiener search on luma by SSE against the source, then the
    apply (the reference's ``lr_search_apply`` with ``solve=True``).

    Returns (filtered y (H, W) int32, choice (nru,) int32: -1 = RU off,
    0..P-1 = preset, P = solved; taps6 (nru, 6) int32: the solved (v0,
    v1, v2, h0, h1, h2) per RU for the tile syntax).  LR runs on the
    true frame dims (th, tw)."""
    H, W = rec_y.shape
    nh, nw = th or H, tw or W
    dev = rec_y.device
    urows = NL.count_units_in_frame(size, nh)
    ucols = NL.count_units_in_frame(size, nw)
    ru = _ru_index(nh, nw, size, urows, ucols, dev)
    r0b, r1b, base = _rounds(bit_depth)
    x = rec_y[:nh, :nw].to(I32)
    s = src_y[:nh, :nw].to(I32)
    e0 = (x - s) ** 2
    outs = wiener_apply(rec_y, pre_y, PRESETS, nh, nw, 0, bit_depth)
    sses = _ru_reduce((outs - s) ** 2 - e0, ru)               # (P, nru)

    # the solved candidate: horizontal taps against the post-CDEF
    # plane, then vertical taps against the exact intermediate, whose
    # output with identity vertical taps is (128 h - C) / 2**r1b
    A_h, r_h = _stats3(_basis3(x, -1), (x - s).to(I64), ru)
    c_h = _solve_quant(A_h, r_h, 128.0)
    tms_h = _tap_maps(c_h, ru)
    hrec = _hfilter(x, tms_h, bit_depth)
    sc = 1 << (r1b - 7)
    e_v = hrec.to(I64) - ((base << (FILTER_BITS - r0b)) >> 7) - sc * s
    A_v, r_v = _stats3(_basis3(hrec, -2), e_v, ru, sc)
    c_v = _solve_quant(A_v, r_v, float(1 << r1b))
    f_s = _apply_rumap(rec_y, pre_y, tms_h, _tap_maps(c_v, ru), nh, nw, 0,
                       bit_depth)
    outs = torch.cat([outs, f_s[None]])
    sse = torch.cat([sses, _ru_reduce((f_s - s) ** 2 - e0, ru)[None]])
    sse = sse.to(F32)                                          # (P+1, nru)
    best = sse.argmin(0)
    best_sse = sse.gather(0, best[None])[0]
    # ~56 bits of syntax per RU at ~6 SSE a bit (x 4**(bd - 8))
    on = best_sse < -384.0 * (1 << (2 * (bit_depth - 8)))
    choice = torch.where(on, best, -1).to(I32)
    pick = choice[_ru_map(ru)]
    filt = torch.where(pick >= 0,
                       outs.gather(0, pick.clamp(min=0).long()[None])[0], x)
    out = rec_y.to(I32).clone()
    out[:nh, :nw] = filt
    return out, choice, torch.cat([c_v, c_h], -1)

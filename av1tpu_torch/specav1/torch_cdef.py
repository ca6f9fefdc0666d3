"""Spec CDEF on tensors: the encoders' in-loop filter and its
frame-level strength search (port of ``av1tpu/specav1/jax_cdef.py``).

The integer arithmetic is the reference's (spec 7.15, the numpy
``specav1/cdef.py``), so the filtered planes are bit-exact; the layout
is not.  The reference builds the direction search from eight one-hot
partial-sum matmuls and each tap plane from a one-hot select over eight
shifted views, both workarounds for its hardware.  Here:

  * ``find_dir`` takes the partial sums with one ``index_add_`` over the
    bins of all eight directions;
  * every tap value is one gather from the edge-padded plane at the
    pixel's position plus its direction's offset, for all twelve taps
    (four primary, eight secondary) at once;
  * the filter body takes a leading candidate axis, so the frame-level
    search evaluates every (pri, sec) pair of a plane class in one pass
    (the reference's ``jax.vmap``), U and V together.

The search runs on the reference's unit subsample: every fourth 8x8
unit in each dimension, 1 unit in 16 (its docstring says 1-in-4; the
code keeps 1 in 16, and so does this one), with the taps read from the
full frame.  Each candidate's SSE delta is summed exactly in int64 and
converted to float32 once; the reference sums int32 rows into a float32
total, which agrees wherever that total stays below 2**24.  The first
minimum wins, and the (0, 0) candidate comes first.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.specav1 import cdef as NC

I32 = torch.int32
LARGE = NC.CDEF_VERY_LARGE

# (pri, sec) candidates per plane class, (0, 0) first: the reference's
# lists (jax_cdef.Y_CANDIDATES, UV_CANDIDATES); sec 4 codes as 3
Y_CANDIDATES = ((0, 0), (1, 0), (1, 1), (2, 1), (2, 2),
                (4, 2), (6, 2), (8, 2), (12, 4))
UV_CANDIDATES = ((0, 0), (1, 0), (1, 1), (2, 1), (2, 2), (4, 2),
                 (8, 2))


def _dir_tables():
    """Bin of each pixel of an 8x8 block per direction, as flat slots of
    an (8, 15) partial-sum array (spec 7.15.2), and the per-slot cost
    weights (unused slots weigh 0)."""
    i = np.arange(8)[:, None] + np.zeros((1, 8), np.int64)
    j = np.arange(8)[None, :] + np.zeros((8, 1), np.int64)
    bins = [i + j, i + j // 2, i + 0 * j, 3 + i - j // 2, 7 + i - j,
            3 - i // 2 + j, j + 0 * i, i // 2 + j]
    slots = np.concatenate([d * 15 + bins[d].reshape(64) for d in range(8)])
    div = NC.DIV_TABLE
    wts = np.zeros((8, 15), np.int64)
    for d in (2, 6):
        wts[d, :8] = 105
    for d in (0, 4):
        wts[d] = np.concatenate([div[1:8], div[8:9], div[1:8][::-1]])
    for d in (1, 3, 5, 7):
        wts[d, :11] = [div[2], div[4], div[6], 105, 105, 105, 105, 105,
                       div[6], div[4], div[2]]
    return slots, wts.astype(np.int32)


_SLOTS, _WTS = _dir_tables()


def _tap_offsets() -> np.ndarray:
    """(12, 8, 2) per-direction (dy, dx) of the taps: primary k = 0, 1
    (+ and -), then secondary k = 0, 1 (dir + 2, its negation, dir + 6,
    its negation)."""
    dirs = NC.DIRECTIONS
    pri, sec = [], []
    for k in range(2):
        o = dirs[:, k]
        pri += [o, -o]
        s2 = dirs[(np.arange(8) + 2) & 7, k]
        s6 = dirs[(np.arange(8) + 6) & 7, k]
        sec += [s2, -s2, s6, -s6]
    return np.stack(pri + sec)


_OFFS = _tap_offsets()


def find_dir(blocks, coeff_shift: int):
    """blocks: (B, 8, 8) int.  Returns (dir (B,), var (B,)) int32; the
    first maximum wins, as in the reference."""
    B = blocks.shape[0]
    dev = blocks.device
    x = (blocks.to(I32) >> coeff_shift) - 128
    p = torch.zeros((B, 120), dtype=I32, device=dev)
    p.index_add_(1, torch.as_tensor(_SLOTS, device=dev),
                 x.reshape(B, 64).repeat(1, 8))
    p = p.view(B, 8, 15)
    cost = (p * p * torch.as_tensor(_WTS, device=dev)).sum(2, dtype=I32)
    best = cost.argmax(1)
    c_best = cost.gather(1, best[:, None])[:, 0]
    c_opp = cost.gather(1, ((best + 4) & 7)[:, None])[:, 0]
    return best.to(I32), (c_best - c_opp) >> 10


def _floor_log2(v):
    """max(0, FloorLog2(v)) of int32 0 <= v < 2**24 (exact in float32;
    frexp's exponent e has v = m * 2**e with 0.5 <= m < 1)."""
    return (torch.frexp(v.to(torch.float32)).exponent - 1).clamp(min=0)


def _adjusted_pri(pri, var_u, is_luma: bool):
    """(C, U) per-unit primary strengths for (C,) strengths already
    << coeff_shift: luma is modulated by the unit's variance."""
    if not is_luma:
        return pri[:, None].expand(-1, var_u.shape[0])
    adj = _floor_log2(var_u >> 6).clamp(max=12)
    return torch.where(var_u[None] != 0,
                       (pri[:, None] * (4 + adj[None]) + 8) >> 4, 0)


def _constrain(ad, neg, s, shift):
    """constrain() of |diff| ``ad`` (0 where the tap is unavailable)
    with strength ``s`` and damping shift ``shift`` (broadcast)."""
    v = torch.minimum(ad, (s - (ad >> shift)).clamp(min=0))
    v = torch.where(s > 0, v, 0)
    return torch.where(neg, -v, v)


def _filter(x, taps, pri_u, sec, uid, damping: int, cs: int):
    """The CDEF filter of the pixels x (N,) from their tap values (12, N)
    for C candidates: pri_u (C, U) per-unit adjusted primary strength,
    sec (C,) secondary strength, uid (N,) each pixel's unit.  Returns
    (C, N), before the skip and on/off masks."""
    valid = taps != LARGE
    diff = taps - x
    ad = torch.where(valid, diff, 0).abs()
    neg = diff < 0
    mx = torch.maximum(torch.where(valid, taps, x).amax(0), x)
    mn = torch.minimum(taps.amin(0), x)
    pmap = pri_u[:, uid]                                     # (C, N)
    pshift = (damping - _floor_log2(pri_u)).clamp(min=0)[:, uid]
    cp = _constrain(ad[None, :4], neg[:4], pmap[:, None],
                    pshift[:, None])                         # (C, 4, N)
    odd = ((pmap >> cs) & 1) != 0
    pt = NC.PRI_TAPS
    sum_ = (torch.where(odd, int(pt[1, 0]), int(pt[0, 0])) *
            (cp[:, 0] + cp[:, 1]) +
            torch.where(odd, int(pt[1, 1]), int(pt[0, 1])) *
            (cp[:, 2] + cp[:, 3]))
    sshift = (damping - _floor_log2(sec)).clamp(min=0)
    cs_ = _constrain(ad[None, 4:], neg[4:], sec[:, None, None],
                     sshift[:, None, None])                  # (C, 8, N)
    st = NC.SEC_TAPS
    sum_ = sum_ + int(st[0]) * cs_[:, 0:4].sum(1, dtype=I32) + \
        int(st[1]) * cs_[:, 4:8].sum(1, dtype=I32)
    y = x + ((8 + sum_ - (sum_ < 0).to(I32)) >> 4)
    return torch.minimum(torch.maximum(y, mn), mx)


class _Pixels:
    """A set of pixels of one plane class (rows x cols of an nh x nw
    plane, for each of its planes) with everything the filter reads:
    values, tap values at the pixel's direction, unit ids."""

    def __init__(self, planes, rows, cols, nh: int, nw: int, blk: int,
                 uw: int, dir_u):
        dev = planes[0].device
        pw = nw + 4
        pad = torch.full((len(planes), nh + 4, pw), LARGE, dtype=I32,
                         device=dev)
        for i, pl in enumerate(planes):
            pad[i, 2:2 + nh, 2:2 + nw] = pl[:nh, :nw]
        base = ((rows[:, None] + 2) * pw + cols[None, :] + 2).reshape(-1)
        uid = ((rows[:, None] // blk) * uw + cols[None, :] // blk)
        uid = uid.reshape(-1)
        offs = torch.as_tensor(_OFFS, device=dev)
        lin = offs[..., 0] * pw + offs[..., 1]               # (12, 8)
        idx = base[None] + lin[:, dir_u.reshape(-1)[uid].long()]
        flat = pad.reshape(len(planes), -1)
        n = base.shape[0]
        self.x = flat[:, base].reshape(-1)                   # (P * N,)
        self.taps = flat[:, idx].permute(1, 0, 2).reshape(12, -1)
        self.uid = uid.repeat(len(planes))
        self.n = n


def _unit_grid(rec_y, th: int, tw: int, cs: int, skip8):
    """Direction, variance and skip of the luma 8x8 units of the
    MI-aligned frame (fh8 x fw8)."""
    fh8 = ((th + 7) >> 3) << 3
    fw8 = ((tw + 7) >> 3) << 3
    uh, uw = fh8 // 8, fw8 // 8
    blocks = rec_y[:fh8, :fw8].to(I32).reshape(uh, 8, uw, 8) \
        .permute(0, 2, 1, 3).reshape(-1, 8, 8)
    dirs, var = find_dir(blocks, cs)
    skip = torch.as_tensor(skip8, device=rec_y.device)[:uh, :uw] != 0
    return fh8, fw8, uh, uw, dirs, var, skip.reshape(-1)


def _merge(orig, filt, nh: int, nw: int):
    out = orig.to(I32).clone()
    out[:nh, :nw] = filt.view(nh, nw)
    return out


def _sub_axis(n: int, blk: int, dev):
    """Pixel indices of every fourth unit along an axis of n pixels."""
    r = torch.arange(n, device=dev)
    return r[(r // blk) % 4 == 0]


def cdef_search_apply(rec_y, rec_u, rec_v, src_y, src_u, src_v, skip8,
                      damping: int, bit_depth: int = 8, th: int = 0,
                      tw: int = 0):
    """Search the frame strengths by SSE against the source and apply
    them (the reference's ``cdef_search_apply``).

    rec_*: post-deblock planes; src_*: source planes; skip8: (uh, uw)
    per-8x8-unit skip grid; damping: 8-bit-domain damping.  Returns
    (y, u, v, strengths (4,) int32 [y_pri, y_sec, uv_pri, uv_sec]), all
    on the planes' device."""
    H, W = rec_y.shape
    th = th or H
    tw = tw or W
    cs = bit_depth - 8
    dev = rec_y.device
    fh8, fw8, uh, uw, dirs, var, skip = _unit_grid(rec_y, th, tw, cs,
                                                   skip8)

    def plane_class(planes, srcs, candidates, blk, dam, is_luma):
        assert all(pri > 0 or sec == 0 for pri, sec in candidates)
        nh, nw = fh8 // (8 // blk), fw8 // (8 // blk)
        cand = torch.as_tensor(candidates, dtype=I32, device=dev)
        pri_c, sec_c = cand[:, 0] << cs, cand[:, 1] << cs
        on_c = (cand[:, 0] > 0) | (cand[:, 1] > 0)
        srcs = [s.to(I32) for s in srcs]

        # search on the unit subsample
        rows, cols = _sub_axis(nh, blk, dev), _sub_axis(nw, blk, dev)
        px = _Pixels(planes, rows, cols, nh, nw, blk, uw, dirs)
        s = torch.cat([sp[rows][:, cols].reshape(-1) for sp in srcs])
        pri_u = torch.where(on_c[:, None],
                            _adjusted_pri(pri_c, var, is_luma), 0)
        f = _filter(px.x, px.taps, pri_u, sec_c, px.uid, dam, cs)
        f = torch.where(skip[px.uid][None] | ~on_c[:, None], px.x, f)
        delta = (f - s) ** 2 - (px.x - s) ** 2
        sse = delta.sum(1, dtype=torch.int64).to(torch.float32)
        best = torch.argmin(sse)
        pri_b, sec_b = cand[best, 0:1], cand[best, 1:2]

        # one full-frame apply with the winning strengths
        rows = torch.arange(nh, device=dev)
        cols = torch.arange(nw, device=dev)
        px = _Pixels(planes, rows, cols, nh, nw, blk, uw, dirs)
        on = (pri_b > 0) | (sec_b > 0)
        pri_u = torch.where(on[:, None],
                            _adjusted_pri(pri_b << cs, var, is_luma), 0)
        f = _filter(px.x, px.taps, pri_u, sec_b << cs, px.uid, dam, cs)[0]
        f = torch.where(skip[px.uid] | ~on, px.x, f)
        outs = [_merge(pl, f[i * px.n:(i + 1) * px.n], nh, nw)
                for i, pl in enumerate(planes)]
        return outs, torch.cat([pri_b, sec_b])

    (fy,), ystr = plane_class((rec_y,), (src_y,), Y_CANDIDATES, 8,
                              damping + cs, True)
    (fu, fv), uvstr = plane_class((rec_u, rec_v), (src_u, src_v),
                                  UV_CANDIDATES, 4, damping - 1 + cs, False)
    return fy, fu, fv, torch.cat([ystr, uvstr]).to(I32)


def cdef_apply(rec_y, rec_u, rec_v, skip8, y_pri: int, y_sec: int,
               uv_pri: int, uv_sec: int, damping: int, bit_depth: int = 8,
               th: int = 0, tw: int = 0):
    """Apply CDEF with given strengths (the reference's ``cdef_apply``,
    the decode-side dual of the search): a plane class whose primary
    strength is 0 filters along direction 0."""
    H, W = rec_y.shape
    th = th or H
    tw = tw or W
    cs = bit_depth - 8
    dev = rec_y.device
    fh8, fw8, uh, uw, dirs, var, skip = _unit_grid(rec_y, th, tw, cs,
                                                   skip8)

    def one_plane(pl, pri, sec, blk, dam, is_luma):
        nh, nw = fh8 // (8 // blk), fw8 // (8 // blk)
        pri, sec = int(pri) << cs, int(sec) << cs
        px = _Pixels((pl,), torch.arange(nh, device=dev),
                     torch.arange(nw, device=dev), nh, nw, blk, uw,
                     dirs if pri > 0 else torch.zeros_like(dirs))
        pri_t = torch.tensor([pri], dtype=I32, device=dev)
        pri_u = _adjusted_pri(pri_t, var, is_luma) if pri > 0 else \
            torch.zeros((1, uh * uw), dtype=I32, device=dev)
        f = _filter(px.x, px.taps, pri_u,
                    torch.tensor([sec], dtype=I32, device=dev), px.uid,
                    dam, cs)[0]
        if not (pri or sec):
            f = px.x
        f = torch.where(skip[px.uid], px.x, f)
        return _merge(pl, f, nh, nw)

    return (one_plane(rec_y, y_pri, y_sec, 8, damping + cs, True),
            one_plane(rec_u, uv_pri, uv_sec, 4, damping - 1 + cs, False),
            one_plane(rec_v, uv_pri, uv_sec, 4, damping - 1 + cs, False))

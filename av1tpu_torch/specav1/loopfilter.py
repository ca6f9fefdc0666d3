"""Spec AV1 in-loop deblocking filter (spec 7.14): port of
``av1tpu/specav1/loopfilter.py``.

Two callers, one statement of the tap formulas (``_filter_taps``, which
takes the array namespace): the encoders filter their reconstruction on
torch tensors (``deblock_frame``; the filtered frame is the display
output and the inter reference, while in-frame intra prediction uses the
unfiltered planes), and the conformance decoder filters numpy planes
from its decoded per-4x4 grids (``deblock_frame_general``, copied from
the reference as it is).

Scope of ``deblock_frame``: the streams the encoder emits.  One filter
level per plane, no segments, no delta_lf, one transform per coded
block, so every transform edge is a block edge and filters
unconditionally.  The base grid is 32x32 luma / 16x16 chroma (filter
length 14 luma / 6 chroma at every interior edge); PARTITION_SPLIT
blocks and the rows of a 16-px bottom strip (th % 32 == 16) add masked
edges at half the step, with the same filter lengths.

The reference writes each pass as slices of a (rows, blocks, step) view
because scatters lower badly on its hardware; here a pass gathers the
14-wide windows around its edge columns, filters them and writes them
back by index (``_vpass``), which covers the reference's uniform pass
and its ``_vpass_masked`` in one call per direction; ``_filter_plane`` covers its
``_filter_plane`` and ``_filter_plane_structured``.  Horizontal edges
run the same pass on an explicit transposed copy.
"""

from __future__ import annotations

import numpy as np
import torch


def thresholds(level: int, sharpness: int = 0):
    """(limit, blimit, thresh) per spec 7.14.4 (8-bit domain)."""
    shift = (1 if sharpness > 0 else 0) + (1 if sharpness > 4 else 0)
    limit = level >> shift
    if sharpness > 0:
        limit = min(limit, 9 - sharpness)
    limit = max(limit, 1)
    blimit = 2 * (level + 2) + limit
    thresh = level >> 4
    return limit, blimit, thresh


def _rpot(x, n):
    return (x + (1 << (n - 1))) >> n


def _filter_taps(P, Q, limit, blimit, thresh, size: int, bd: int, xp):
    """Filter one batch of edge pixel-lines.

    P: (..., 7) samples p6..p0 (P[..., 6] = p0 nearest the edge);
    Q: (..., 7) samples q0..q6.  Returns (newP, newQ) with the same
    layout.  size: 4, 6, 8, or 14.  xp: ``torch`` (int32 tensors, the
    encoders) or ``numpy`` (the decoder); identical integer formulas.
    """
    s = 1 << (bd - 8)
    limit = limit * s
    blimit = blimit * s
    thresh = thresh * s
    p = [P[..., 6 - i] for i in range(7)]   # p[0]=p0 .. p[6]=p6
    q = [Q[..., i] for i in range(7)]

    def ab(a, b):
        return xp.abs(a - b)

    # filter_mask (spec: joint sample-activity test)
    mask = (ab(p[1], p[0]) <= limit) & (ab(q[1], q[0]) <= limit) & \
        (ab(p[0], q[0]) * 2 + ab(p[1], q[1]) // 2 <= blimit)
    if size >= 8:
        mask = mask & (ab(p[3], p[2]) <= limit) & \
            (ab(p[2], p[1]) <= limit) & (ab(q[2], q[1]) <= limit) & \
            (ab(q[3], q[2]) <= limit)
    elif size == 6:
        mask = mask & (ab(p[2], p[1]) <= limit) & (ab(q[2], q[1]) <= limit)

    one = s  # flatness threshold 1 << (bd - 8)
    if size >= 6:
        flat = (ab(p[1], p[0]) <= one) & (ab(q[1], q[0]) <= one) & \
            (ab(p[2], p[0]) <= one) & (ab(q[2], q[0]) <= one)
        if size >= 8:
            flat = flat & (ab(p[3], p[0]) <= one) & (ab(q[3], q[0]) <= one)
    if size == 14:
        flat2 = (ab(p[6], p[0]) <= one) & (ab(q[6], q[0]) <= one) & \
            (ab(p[5], p[0]) <= one) & (ab(q[5], q[0]) <= one) & \
            (ab(p[4], p[0]) <= one) & (ab(q[4], q[0]) <= one)

    # narrow filter (filter4): signed arithmetic around mid
    hev = (ab(p[1], p[0]) > thresh) | (ab(q[1], q[0]) > thresh)
    lo = -(128 * s)
    hi = 128 * s - 1

    def c(x):
        return xp.clip(x, lo, hi)

    ps1, ps0 = p[1] - 128 * s, p[0] - 128 * s
    qs0, qs1 = q[0] - 128 * s, q[1] - 128 * s
    f = xp.where(hev, c(ps1 - qs1), 0)
    f = xp.where(mask, c(f + 3 * (qs0 - ps0)), 0)
    f1 = c(f + 4) >> 3
    f2 = c(f + 3) >> 3
    n_q0 = c(qs0 - f1) + 128 * s
    n_p0 = c(ps0 + f2) + 128 * s
    f3 = (f1 + 1) >> 1
    n_q1 = xp.where(hev, qs1, c(qs1 - f3)) + 128 * s
    n_p1 = xp.where(hev, ps1, c(ps1 + f3)) + 128 * s

    outp = [n_p0, n_p1] + [p[i] for i in range(2, 7)]
    outq = [n_q0, n_q1] + [q[i] for i in range(2, 7)]

    if size == 6:
        w = flat & mask
        op1 = _rpot(p[2] * 3 + p[1] * 2 + p[0] * 2 + q[0], 3)
        op0 = _rpot(p[2] + p[1] * 2 + p[0] * 2 + q[0] * 2 + q[1], 3)
        oq0 = _rpot(p[1] + p[0] * 2 + q[0] * 2 + q[1] * 2 + q[2], 3)
        oq1 = _rpot(p[0] + q[0] * 2 + q[1] * 2 + q[2] * 3, 3)
        outp[0] = xp.where(w, op0, outp[0])
        outp[1] = xp.where(w, op1, outp[1])
        outq[0] = xp.where(w, oq0, outq[0])
        outq[1] = xp.where(w, oq1, outq[1])
    elif size >= 8:
        w = flat & mask
        op2 = _rpot(p[3] * 3 + p[2] * 2 + p[1] + p[0] + q[0], 3)
        op1 = _rpot(p[3] * 2 + p[2] + p[1] * 2 + p[0] + q[0] + q[1], 3)
        op0 = _rpot(p[3] + p[2] + p[1] + p[0] * 2 + q[0] + q[1] + q[2], 3)
        oq0 = _rpot(p[2] + p[1] + p[0] + q[0] * 2 + q[1] + q[2] + q[3], 3)
        oq1 = _rpot(p[1] + p[0] + q[0] + q[1] * 2 + q[2] + q[3] * 2, 3)
        oq2 = _rpot(p[0] + q[0] + q[1] + q[2] * 2 + q[3] * 3, 3)
        outp[0] = xp.where(w, op0, outp[0])
        outp[1] = xp.where(w, op1, outp[1])
        outp[2] = xp.where(w, op2, outp[2])
        outq[0] = xp.where(w, oq0, outq[0])
        outq[1] = xp.where(w, oq1, outq[1])
        outq[2] = xp.where(w, oq2, outq[2])
    if size == 14:
        w2 = flat2 & flat & mask
        # 13-tap smoothing: output d steps from the edge mixes a
        # 14-wide window with edge replication of p6/q6 (spec filter14)
        o = {}
        o["p5"] = _rpot(p[6] * 7 + p[5] * 2 + p[4] * 2 + p[3] + p[2] +
                        p[1] + p[0] + q[0], 4)
        o["p4"] = _rpot(p[6] * 5 + p[5] * 2 + p[4] * 2 + p[3] * 2 +
                        p[2] + p[1] + p[0] + q[0] + q[1], 4)
        o["p3"] = _rpot(p[6] * 4 + p[5] + p[4] * 2 + p[3] * 2 +
                        p[2] * 2 + p[1] + p[0] + q[0] + q[1] + q[2], 4)
        o["p2"] = _rpot(p[6] * 3 + p[5] + p[4] + p[3] * 2 + p[2] * 2 +
                        p[1] * 2 + p[0] + q[0] + q[1] + q[2] + q[3], 4)
        o["p1"] = _rpot(p[6] * 2 + p[5] + p[4] + p[3] + p[2] * 2 +
                        p[1] * 2 + p[0] * 2 + q[0] + q[1] + q[2] +
                        q[3] + q[4], 4)
        o["p0"] = _rpot(p[6] + p[5] + p[4] + p[3] + p[2] + p[1] * 2 +
                        p[0] * 2 + q[0] * 2 + q[1] + q[2] + q[3] +
                        q[4] + q[5], 4)
        o["q0"] = _rpot(p[5] + p[4] + p[3] + p[2] + p[1] + p[0] * 2 +
                        q[0] * 2 + q[1] * 2 + q[2] + q[3] + q[4] +
                        q[5] + q[6], 4)
        o["q1"] = _rpot(p[4] + p[3] + p[2] + p[1] + p[0] + q[0] * 2 +
                        q[1] * 2 + q[2] * 2 + q[3] + q[4] + q[5] +
                        q[6] * 2, 4)
        o["q2"] = _rpot(p[3] + p[2] + p[1] + p[0] + q[0] + q[1] * 2 +
                        q[2] * 2 + q[3] * 2 + q[4] + q[5] + q[6] * 3, 4)
        o["q3"] = _rpot(p[2] + p[1] + p[0] + q[0] + q[1] + q[2] * 2 +
                        q[3] * 2 + q[4] * 2 + q[5] + q[6] * 4, 4)
        o["q4"] = _rpot(p[1] + p[0] + q[0] + q[1] + q[2] + q[3] * 2 +
                        q[4] * 2 + q[5] * 2 + q[6] * 5, 4)
        o["q5"] = _rpot(p[0] + q[0] + q[1] + q[2] + q[3] + q[4] * 2 +
                        q[5] * 2 + q[6] * 7, 4)
        for i, key in enumerate(["p0", "p1", "p2", "p3", "p4", "p5"]):
            outp[i] = xp.where(w2, o[key], outp[i])
        for i, key in enumerate(["q0", "q1", "q2", "q3", "q4", "q5"]):
            outq[i] = xp.where(w2, o[key], outq[i])

    newP = xp.stack([outp[6 - i] for i in range(7)], -1)
    newQ = xp.stack(outq[:7], -1)
    return newP, newQ


# --- encoder side: torch tensors ---------------------------------------------

def _vpass(x: torch.Tensor, level: int, size: int, bd: int,
           edges: torch.Tensor, mask=None) -> torch.Tensor:
    """Filter the vertical edges of ``x`` (..., rows, cols) at the columns
    ``edges`` (n,); ``mask`` (rows, n) bool limits which rows of which
    edge are filtered.  All edges are filtered at once: they must be far
    enough apart that none reads or writes what another writes (16 for
    size 14, which reads 7 and writes 6 samples a side; 8 for size 6,
    which reads 3 and writes 2).  Returns a new plane."""
    limit, blimit, thresh = thresholds(level)
    cols = edges[:, None] + torch.arange(-7, 7, device=x.device)   # (n, 14)
    win = x[..., cols]                                   # (..., rows, n, 14)
    nP, nQ = _filter_taps(win[..., :7], win[..., 7:], limit, blimit, thresh,
                          size, bd, torch)
    new = torch.cat([nP, nQ], -1)
    if mask is not None:
        new = torch.where(mask[:, :, None], new, win)
    # write back only the span the filter can change: at the chroma
    # spacing the 14-wide windows of neighbouring edges overlap
    k = slice(1, 13) if size == 14 else slice(5, 9)
    out = x.clone()
    out[..., cols[:, k]] = new[..., k]
    return out


def _filter_plane(plane: torch.Tensor, level: int, step: int, size: int,
                  bd: int, nw: int, nh: int, split=None,
                  strip: bool = False) -> torch.Tensor:
    """Deblock one plane (or a stack of planes, (..., rows, cols)) on the
    uniform step x step grid, plus (with ``split``, a (rows // step,
    cols // step) int grid, or ``strip``) the masked edges at half the
    step that PARTITION_SPLIT blocks and the strip's rows
    [nh - step/2, nh) introduce.  nw/nh: coded plane dims; edges beyond
    them are not filtered.  level 0 leaves the plane as it is.

    Pass order is the spec's: all vertical edges, then all horizontal
    ones on the vertically filtered samples.  Within a direction the
    uniform and the masked edges go through one pass: they lie half a
    step apart, which no filter length used here reaches across."""
    if level <= 0:
        return plane
    h, w = plane.shape[-2:]
    dev = plane.device
    off = step // 2
    ev = torch.arange(step, nw, step, device=dev)
    eh = torch.arange(step, nh, step, device=dev)
    mv = mh = None
    if split is not None or strip:
        if split is None:
            split = torch.zeros((h // step, w // step), dtype=torch.int32,
                                device=dev)
        if tuple(split.shape) != (h // step, w // step) or h % step or \
                w % step:
            raise ValueError(f"deblock: split grid {tuple(split.shape)} "
                             f"for a {h}x{w} plane at step {step}")
        sb = split.to(torch.bool)
        rows, cols = torch.arange(h, device=dev), torch.arange(w, device=dev)
        # masked edge j of a pass sits at j * step + off and must end
        # inside the coded extent
        mid_v = torch.arange(w // step, device=dev) * step + off
        mid_h = torch.arange(h // step, device=dev) * step + off
        mv = sb.repeat_interleave(step, 0) & (mid_v + off <= nw)[None, :]
        if strip:
            in_strip = (rows >= nh - off) & (rows < nh)
            mv = mv | (in_strip[:, None] & (mid_v + off <= nw)[None, :])
        mv = mv & (rows < nh)[:, None]
        mh = sb.T.repeat_interleave(step, 0) & (mid_h + off <= nh)[None, :]
        mh = mh & (cols < nw)[:, None]
        # the uniform edges filter every row
        mv = torch.cat([mv.new_ones((h, ev.numel())), mv], 1)
        mh = torch.cat([mh.new_ones((w, eh.numel())), mh], 1)
        ev, eh = torch.cat([ev, mid_v]), torch.cat([eh, mid_h])

    x = plane
    if ev.numel():
        x = _vpass(x, level, size, bd, ev, mv)
    x = x.transpose(-1, -2).contiguous()
    if eh.numel():
        x = _vpass(x, level, size, bd, eh, mh)
    return x.transpose(-1, -2).contiguous()


def deblock_frame(rec_y, rec_u, rec_v, lf_y: int, lf_u: int, lf_v: int,
                  bd: int, th: int, tw: int, split=None,
                  strip: bool = False):
    """Filter a recon frame (int32 tensors): the uniform 32/16 grid, plus
    the masked mid-block edges of PARTITION_SPLIT blocks (``split``:
    (gh, gw) grid on the luma-32 grid) and of a 16-px bottom strip row
    (``strip``, th % 32 == 16).  th/tw: coded luma dims; chroma at half.
    Levels are host ints.  Returns new planes."""
    fh8 = ((th + 7) >> 3) << 3
    fw8 = ((tw + 7) >> 3) << 3
    y = _filter_plane(rec_y, lf_y, 32, 14, bd, fw8, fh8, split, strip)
    if lf_u == lf_v:    # as the engine sets them: U and V as one stack
        u, v = _filter_plane(torch.stack([rec_u, rec_v]), lf_u, 16, 6, bd,
                             fw8 // 2, fh8 // 2, split, strip)
        return y, u, v
    u = _filter_plane(rec_u, lf_u, 16, 6, bd, fw8 // 2, fh8 // 2, split,
                      strip)
    v = _filter_plane(rec_v, lf_v, 16, 6, bd, fw8 // 2, fh8 // 2, split,
                      strip)
    return y, u, v


# --- decoder side: numpy, from the decoded per-4x4 grids ---------------------

def _general_vpass(w, lvl: int, sharpness: int, txw, n4w, skip, inter,
                   chroma: bool, bd: int):
    """Filter every vertical edge of one plane from per-4x4-unit grids
    (numpy, sequential in place: edge spacing >= filter reach, so
    in-place equals simultaneous).  ``w``: int32 plane horizontally
    padded by 8 (index safety for the 7-wide windows; the pad lanes are
    masked off).  txw/n4w: tx and block widths in 4px units on this
    plane's grid; skip/inter: per-unit flags.  chroma selects the
    6/4-tap ladder, luma the 14/8/4."""
    mr, mc = txw.shape
    if lvl <= 0:
        return
    limit, blimit, thresh = thresholds(lvl, sharpness)
    for c in range(1, mc):
        txq = txw[:, c]
        txp = txw[:, c - 1]
        tx_edge = np.mod(c, np.maximum(txq, 1)) == 0
        blk_edge = np.mod(c, np.maximum(n4w[:, c], 1)) == 0
        sk_q = skip[:, c] & inter[:, c]
        sk_p = skip[:, c - 1] & inter[:, c - 1]
        on = tx_edge & (blk_edge | ~sk_q | ~sk_p)
        if not on.any():
            continue
        msz = np.minimum(np.maximum(txp, 1), np.maximum(txq, 1))
        if chroma:
            size_of = np.where(msz >= 2, 6, 4)
            ladder = (6, 4)
        else:
            size_of = np.where(msz >= 4, 14, np.where(msz == 2, 8, 4))
            ladder = (14, 8, 4)
        e = 4 * c + 8  # +8: horizontal pad offset
        P = w[:, e - 7:e]
        Q = w[:, e:e + 7]
        for sz in ladder:
            rows = on & (size_of == sz)
            if not rows.any():
                continue
            m = np.repeat(rows, 4)[:, None]
            nP, nQ = _filter_taps(P, Q, limit, blimit, thresh, sz, bd, np)
            w[:, e - 7:e] = np.where(m, nP, P)
            w[:, e:e + 7] = np.where(m, nQ, Q)
            P = w[:, e - 7:e]
            Q = w[:, e:e + 7]


def deblock_frame_general(planes, levels, sharpness: int,
                          tx_w4, tx_h4, n4_w, n4_h, skips, inter,
                          uv_txw, uv_txh, bd: int):
    """CPU spec deblock (7.14) driven by the decoded per-4x4 grids: the
    conformance decoder's path for any one-tx-per-block stream (uniform
    32/16, PARTITION_SPLIT 16s, strip rows) whose blocks are all
    >= 8x8 px.

    planes: (y, u, v) numpy int planes (coded padded dims).
    levels: hdr.lf.level, (y_vert, y_horz, u, v).
    tx_*/n4_*: luma-grid tx and block dims in 4px units; skips/inter:
    per-unit flags; uv_tx*: chroma-grid tx dims in chroma 4px units
    (owner-sampled).  Returns new (y, u, v).
    """
    mr, mc = tx_w4.shape
    skips = np.asarray(skips).astype(bool)
    inter = np.asarray(inter).astype(bool)
    # chroma grids: bottom-right owner sampling (spec sub-8 chroma
    # ownership); callers must reject sub-8x8 blocks beforehand
    ri = np.minimum(np.arange((mr + 1) // 2) * 2 + 1, mr - 1)
    ci = np.minimum(np.arange((mc + 1) // 2) * 2 + 1, mc - 1)
    uv_n4w = np.maximum(n4_w[np.ix_(ri, ci)] >> 1, 1)
    uv_n4h = np.maximum(n4_h[np.ix_(ri, ci)] >> 1, 1)
    uv_skip = skips[np.ix_(ri, ci)]
    uv_inter = inter[np.ix_(ri, ci)]

    def run(plane, lvl_v, lvl_h, txw, txh, n4w, n4h, sk, it, chroma):
        gr, gc = txw.shape
        h = gr * 4
        w = np.pad(plane[:h].astype(np.int32), ((0, 0), (8, 8)),
                   mode="edge")
        _general_vpass(w, lvl_v, sharpness, txw, n4w, sk, it, chroma, bd)
        out = plane.copy().astype(np.int32)
        out[:h] = w[:, 8:-8]
        # horizontal pass: transpose, swap to the height grids
        wt = np.pad(out.T[:gc * 4, :h].astype(np.int32),
                    ((0, 0), (8, 8)), mode="edge")
        _general_vpass(wt, lvl_h, sharpness, txh.T, n4h.T, sk.T, it.T,
                       chroma, bd)
        out.T[:gc * 4, :h] = wt[:, 8:-8]
        return out

    y = run(planes[0], levels[0], levels[1], tx_w4, tx_h4, n4_w, n4_h,
            skips, inter, False)
    u = run(planes[1], levels[2], levels[2], uv_txw, uv_txh, uv_n4w,
            uv_n4h, uv_skip, uv_inter, True)
    v = run(planes[2], levels[3], levels[3], uv_txw, uv_txh, uv_n4w,
            uv_n4h, uv_skip, uv_inter, True)
    return y, u, v

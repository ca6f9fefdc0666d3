"""Spec-AV1 P-frame encoder in PyTorch (port of ``specav1/jax_inter.py``).

Full-pel search (K2 through ``motion.search_v3``), quarter-pel
refinement and motion compensation with the spec 8-tap subpel filters
and InterRound0/1 rounding, float32 forward DCT + deadzone quantization,
skip RDO, the 32 -> 16 split RD, and the spec-exact integer
reconstruction.  Every block depends only on the previous frame's
reconstruction, so the frame runs as batched tensor ops over 32x32
blocks; window reads go through K1 (``kernels.gather``), the chroma
MC's U and V windows in one launch.

With a GOLDEN reference (the GOP keyframe's reconstruction) every
32x32 block picks LAST or GOLDEN by its full-pel SSDs; window reads of
the selected plane go through the two-plane K1 (``gather_windows2``).
The in-loop filters follow the reference's order: with ``deblock`` the
reconstruction is loop-filtered (``specav1.loopfilter``), with ``cdef``
CDEF strengths are searched and applied (``specav1.torch_cdef``), with
``lr`` the Wiener loop restoration is searched and applied per unit
(``specav1.torch_lr``).

Inside a multi-device stripe (``stripe=True``, see ``specav1.stripes``)
the frame is a row stripe of a taller one, and the frame-level stages
(the 16-px strip, deblocking, CDEF, LR) are left to the gathered frame
(``finish_frame``).  ``split16`` and ``refine`` stay on.  Arithmetic
that JAX runs in int32 (including the reference's ``int64`` casts, which
run as int32 with x64 off) runs in int32 here, wrap included.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.encoder.kernels import gather, motion, refine
from av1tpu_torch.specav1 import inter_recon, loopfilter, torch_cdef, torch_lr
from av1tpu_torch.specav1 import lr as _NL
from av1tpu_torch.specav1.transforms import Quantizer, fwd_mat, inv_tx2d_add

PAD = motion.PAD   # luma edge padding (chroma uses PAD // 2)
_MAX_FP = PAD - 8  # clamp full-pel MVs so MC windows stay in the pad
I32 = torch.int32

_QPEL_OFFS = tuple((dr, dc) for dr in (-2, 0, 2) for dc in (-2, 0, 2))


def _rounds(bit_depth: int):
    if bit_depth == 12:
        return 5, 9
    return 3, 11


def _filt(device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(inter_recon.SUBPEL_REGULAR, np.int32),
                           device=device)


def edge_pad(plane: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicate padding (numpy's mode="edge") by index clamping."""
    h, w = plane.shape
    rows = torch.arange(-top, h + bottom, device=plane.device).clamp(0, h - 1)
    cols = torch.arange(-left, w + right, device=plane.device).clamp(0, w - 1)
    return plane[rows[:, None], cols[None, :]]


def prep_ref(ref: torch.Tensor, t_h: int, t_w: int, pad: int):
    """Crop a padded recon to the coded dims and edge-pad it back out
    by ``pad`` (plus the SB padding) for MC."""
    r = ref[:t_h, :t_w]
    return edge_pad(r, pad, pad + ref.shape[0] - t_h, pad,
                    pad + ref.shape[1] - t_w)


def _subpel_hv(win, fx, fy, size: int, r0: int, r1: int, bit_depth: int):
    """Batched spec 8-tap h+v filtering of (..., B, size+7, size+7) int32
    windows with per-block taps fx/fy (B, 8), shared by every leading
    index (the planes of one gather)."""
    lead = win.shape[:-2]
    h = torch.zeros((*lead, size + 7, size), dtype=I32, device=win.device)
    for t in range(8):
        h = h + fx[:, t, None, None] * win[..., :, t:t + size]
    h = (h + (1 << (r0 - 1))) >> r0
    v = torch.zeros((*lead, size, size), dtype=I32, device=win.device)
    for t in range(8):
        v = v + fy[:, t, None, None] * h[..., t:t + size, :]
    v = (v + (1 << (r1 - 1))) >> r1
    return v.clamp(0, (1 << bit_depth) - 1)


def _taps(phase: int) -> list:
    return [int(t) for t in np.asarray(inter_recon.SUBPEL_REGULAR)[phase]]


def _windows(refs, glds, ri, oy, ox, W: int):
    """K1 windows of refs (a plane, or a tuple of planes that go in one
    launch), or per block of (refs, glds)[ri]."""
    if glds is None:
        return gather.gather_windows(refs, oy, ox, W)
    return gather.gather_windows2(refs, glds, ri, oy, ox, W)


def _mc_blocks(refs, pos, mvs, size: int, ss: int, bit_depth: int,
               glds=None, ri=None):
    """Spec motion compensation for B size x size blocks of each plane
    in ``refs`` (a tuple: U and V, or one plane), every plane padded by
    PAD >> ss and of one shape; pos (B, 2) plane-space origins, mvs
    (B, 2) luma MVs in 1/8 pel.  The positions and filter phases are
    computed once, all planes' windows come from one K1 launch, and one
    8-tap pass filters them.  With ``glds`` (the GOLDEN planes in the
    same order; the reference's _mc_blocks2, the planes replacing its
    make_wide2 handle) block b predicts from them where ri[b] is 1.
    Returns a tuple of (B, size, size) int32 predictions, one a plane."""
    pad = PAD >> ss
    r0, r1 = _rounds(bit_depth)
    filt = _filt(refs[0].device)
    W7 = size + 7
    Hp, Wp = refs[0].shape
    mul = 2 >> ss
    sy16 = pos[:, 0] * 16 + mvs[:, 0] * mul
    sx16 = pos[:, 1] * 16 + mvs[:, 1] * mul
    fy = filt[(sy16 & 15).long()]
    fx = filt[(sx16 & 15).long()]
    iy = ((sy16 >> 4) - 3 + pad).clamp(0, Hp - W7)
    ix = ((sx16 >> 4) - 3 + pad).clamp(0, Wp - W7)
    win = _windows(tuple(refs), None if glds is None else tuple(glds), ri,
                   iy, ix, W7)                          # (P, B, W7, W7)
    return tuple(_subpel_hv(win, fx, fy, size, r0, r1, bit_depth))


def _qpel_refine9(src_blocks, ref_pad, pos, mv8, size: int, bit_depth: int,
                  gld_pad=None, ri=None):
    """Quarter-pel refinement over the 9 even-1/8 offsets around mv8
    with exact spec MC: one (size+9)^2 window per block, 3 horizontal
    and 9 vertical 8-tap passes in int32 (the reference's band-matrix
    matmuls are exact, so the integer filter gives the same values).
    With ``gld_pad`` (the reference's golden=True) block b reads plane
    (ref_pad, gld_pad)[ri[b]].
    Returns (mv8_best (B, 2), pred (B, size, size) int32)."""
    r0, r1 = _rounds(bit_depth)
    W9 = size + 9
    oy = ((pos[:, 0] * 16 + mv8[:, 0] * 2 - 4) >> 4) - 3 + PAD
    ox = ((pos[:, 1] * 16 + mv8[:, 1] * 2 - 4) >> 4) - 3 + PAD
    Hp, Wp = ref_pad.shape
    oy = oy.clamp(0, Hp - W9)
    ox = ox.clamp(0, Wp - W9)
    win = _windows(ref_pad, gld_pad, ri, oy, ox, W9)     # (B, W9, W9)
    blk = src_blocks.to(I32)
    # d16 = -4, 0, +4 -> sixteenth phase 12, 0, 4 at window offset 0, 1, 1
    phases = [(int(d16) & 15, 0 if d16 < 0 else 1) for d16 in (-4, 0, 4)]
    hs = []
    for ph, off in phases:
        taps = _taps(ph)
        h = torch.zeros((win.shape[0], W9, size), dtype=I32,
                        device=win.device)
        for t, w in enumerate(taps):
            if w:
                h = h + w * win[:, :, off + t:off + t + size]
        hs.append((h + (1 << (r0 - 1))) >> r0)
    preds = []
    costs = []
    for ph, off in phases:                               # dr
        taps = _taps(ph)
        for j in range(3):                               # dc
            v = torch.zeros_like(blk)
            for t, w in enumerate(taps):
                if w:
                    v = v + w * hs[j][:, off + t:off + t + size, :]
            v = ((v + (1 << (r1 - 1))) >> r1).clamp(0, (1 << bit_depth) - 1)
            preds.append(v)
            d = blk - v
            costs.append((d * d).sum((1, 2), dtype=I32))
    pidx = motion.first_argmin(torch.stack(costs), 0)   # (B,)
    pred = torch.stack(preds, 1)[torch.arange(blk.shape[0],
                                              device=blk.device), pidx]
    offs = torch.as_tensor(_QPEL_OFFS, dtype=I32, device=blk.device)
    return mv8 + offs[pidx], pred


def _blockify(src, nn: int, nbh: int, nbw: int):
    return src.to(I32).reshape(nbh, nn, nbw, nn).permute(0, 2, 1, 3) \
        .reshape(nbh * nbw, nn, nn)


def _to_plane(b, nn: int, nbh: int, nbw: int):
    return b.reshape(nbh, nbw, nn, nn).permute(0, 2, 1, 3).reshape(
        nbh * nn, nbw * nn)


def _ssd(a, b):
    d = a - b
    return (d * d).sum((1, 2), dtype=I32)


def code_strip(src_y, rec_y_p, rec_u_p, rec_v_p, lv_y_p, lv_u_p, lv_v_p,
               th: int, q: Quantizer, bit_depth: int):
    """Code the 16px bottom strip (th % 32 == 16) onto completed planes:
    intra V_PRED 16x16 luma blocks with coded ADST_DCT residual, chroma
    prediction-only.  Port of jax_inter.code_strip (the keyframe's strip
    is the same computation).  Updates the planes in place and returns
    the (nsc,) strip_skip grid."""
    Wd = rec_y_p.shape[1]
    nsc = 2 * (Wd // 32)
    dev = rec_y_p.device
    fm16i = fwd_mat("dct", 16, dev)
    fm16ia = fwd_mat("adst", 16, dev)
    y0 = (th // 32) * 32
    pred = rec_y_p[y0 - 1][None, :].expand(16, Wd)
    resid = (src_y[y0:y0 + 16, :] - pred).to(torch.float32)
    rblk = resid.reshape(16, Wd // 16, 16).permute(1, 0, 2)
    coef = fm16ia @ rblk @ fm16i.T
    lvs = q.quant(coef, 16, 0)
    dqs = q.dequant(lvs, 16, 0)
    pblk = pred.reshape(16, Wd // 16, 16).permute(1, 0, 2)
    rec_blk = inv_tx2d_add(dqs, pblk, bit_depth, row_kind="dct",
                           col_kind="adst")
    rec_y_p[y0:y0 + 16, :] = rec_blk.permute(1, 0, 2).reshape(16, Wd)
    lv_y_p[y0:y0 + 16, :] = lvs.permute(1, 0, 2).reshape(16, Wd)
    strip_skip = (lvs == 0).all(2).all(1)[:nsc].to(I32)
    cy0 = y0 // 2
    for rec_c, lv_c in ((rec_u_p, lv_u_p), (rec_v_p, lv_v_p)):
        rec_c[cy0:cy0 + 8, :] = rec_c[cy0 - 1][None, :].expand(8, Wd // 2)
        lv_c[cy0:cy0 + 8, :] = 0
    return strip_skip


def lr_off_outputs(th: int, tw: int, device):
    """(lr_choice all -1, lr_taps zeros) for the 256px RU grid."""
    nru = (_NL.count_units_in_frame(256, th) *
           _NL.count_units_in_frame(256, tw))
    return (torch.full((nru,), -1, dtype=I32, device=device),
            torch.zeros((nru, 6), dtype=I32, device=device))


def build_skip8(skip_blocks, strip_skip, th: int, tw: int, pw: int,
                split=None, skip16=None):
    """(uh, uw) per-8x8-unit coded-skip grid for CDEF (the reference's
    ``jax_inter.build_skip8``): the 32x32 block skips, each split
    block's per-quadrant skips (split, skip16 (B, 4) in z-order), and
    the 16x16 strip block skips when th % 32 == 16."""
    fh8 = ((th + 7) >> 3) << 3
    fw8 = ((tw + 7) >> 3) << 3
    sk8 = skip_blocks.to(I32).repeat_interleave(4, 0).repeat_interleave(4, 1)
    if split is not None:
        gh, gw = skip_blocks.shape
        s16 = skip16.reshape(gh, gw, 2, 2).permute(0, 2, 1, 3).reshape(
            2 * gh, 2 * gw).to(I32)
        s16_8 = s16.repeat_interleave(2, 0).repeat_interleave(2, 1)
        m = (split.reshape(gh, gw) != 0).repeat_interleave(4, 0) \
            .repeat_interleave(4, 1)
        sk8 = torch.where(m, s16_8, sk8)
    if th % 32 == 16:
        nsc = 2 * (pw // 32)
        srow = (th - 16) // 8
        strip8 = strip_skip.to(I32)[:nsc].repeat_interleave(2)
        sk8 = sk8.clone()
        sk8[srow:srow + 2, :strip8.shape[0]] = strip8[None]
    return sk8[:fh8 // 8, :fw8 // 8]


def finish_frame(src, rec, lvs, skip, split, skip16, q: Quantizer,
                 bit_depth: int, th: int, tw: int, lf_y: int = 0,
                 lf_uv: int = 0, deblock: bool = False, cdef: bool = False,
                 cdef_damping: int = 4, lr: bool = False):
    """The frame-level stages after the block pass, in the reference's
    order: the 16-px strip when th % 32 == 16 (written into ``rec`` and
    ``lvs`` in place), deblocking, CDEF, then loop restoration.  src,
    rec, lvs: (y, u, v) source, recon and level planes of the whole
    padded frame; skip and split (gh, gw), skip16 (gh * gw, 4) the block
    grids.  Returns (rec_y, rec_u, rec_v, strip_skip, cdefs, lr_choice,
    lr_taps)."""
    rec_y, rec_u, rec_v = rec
    dev = rec_y.device
    Wd = rec_y.shape[1]
    strip = th % 32 == 16
    if strip:
        strip_skip = code_strip(src[0].to(I32), rec_y, rec_u, rec_v, *lvs,
                                th, q, bit_depth)
    else:
        strip_skip = torch.zeros((2 * (Wd // 32),), dtype=I32, device=dev)
    if deblock:
        rec_y, rec_u, rec_v = loopfilter.deblock_frame(
            rec_y, rec_u, rec_v, lf_y, lf_uv, lf_uv, bit_depth, th, tw,
            split=split, strip=strip)
    pre_cdef_y = rec_y  # post-deblock: the LR stripe-boundary source
    if cdef:
        skip8 = build_skip8(skip, strip_skip, th, tw, Wd, split=split,
                            skip16=skip16)
        rec_y, rec_u, rec_v, cdefs = torch_cdef.cdef_search_apply(
            rec_y, rec_u, rec_v, *src, skip8, cdef_damping,
            bit_depth=bit_depth, th=th, tw=tw)
    else:
        cdefs = torch.zeros((4,), dtype=I32, device=dev)
    if lr:
        rec_y, lr_choice, lr_taps = torch_lr.lr_search_apply(
            rec_y, pre_cdef_y, src[0], bit_depth=bit_depth, th=th, tw=tw)
    else:
        lr_choice, lr_taps = lr_off_outputs(th, tw, dev)
    return rec_y, rec_u, rec_v, strip_skip, cdefs, lr_choice, lr_taps


def encode_frame(y, u, v, ref_y, ref_u, ref_v, qindex: int,
                 bit_depth: int, th: int = 0, tw: int = 0,
                 qround: float = 0.70, gld=None, lf_y: int = 0,
                 lf_uv: int = 0, deblock: bool = False, cdef: bool = False,
                 cdef_damping: int = 4, lr: bool = False,
                 stripe: bool = False, row0: int = 0):
    """One P-frame.  y/u/v: SB-padded source planes; ref_*: the previous
    reconstruction (int32, same padded shape).  Returns the reference's
    16-tuple (mvs (B,2) 1/8-pel, skips (B,), lv_y, lv_u, lv_v, rec_y,
    rec_u, rec_v, strip_skip, cdefs, lr_choice, split (B,), mv16 (B,4,2),
    skip16 (B,4), refsel (B,), lr_taps).

    gld: the GOLDEN reference planes (y, u, v), the reference's
    golden=True: each 32x32 block picks LAST (ref_*) or GOLDEN from its
    full-pel SSDs, a rate-aware margin keeping LAST unless GOLDEN clearly
    wins; quarter-pel refinement and MC read the selected plane, and
    split quadrants inherit the parent's choice.  refsel is 0 = LAST,
    1 = GOLDEN.  GOLDEN is evaluated at the zero MV only.

    deblock: loop-filter the returned reconstruction at levels lf_y /
    lf_uv (the split grid and a 16-px strip add their mid-block edges).
    cdef: then search and apply the CDEF frame strengths at damping
    cdef_damping (cdefs: [y_pri, y_sec, uv_pri, uv_sec]).  lr: then the
    per-unit Wiener search on luma, reading the post-deblock luma at
    stripe boundaries (lr_choice, lr_taps; all off without it).

    stripe: y/u/v are the row stripe of a taller frame that starts at
    pixel row ``row0`` (a multiple of 32), th/tw the whole frame's coded
    dims; the strip and the in-loop filters are left to the caller
    (``finish_frame`` on the gathered frame), and strip_skip, cdefs and
    the LR outputs come back off.  The reference planes (and ``gld``) are
    then prebuilt padded windows covering padded-frame rows
    [row0 - PAD, row0 + stripe height + PAD) (``stripes.halo_windows``),
    and block positions stay stripe-local."""
    dev = y.device
    H, Wd = y.shape
    n = 32
    gh, gw = H // n, Wd // n
    B = gh * gw
    pos = torch.as_tensor(motion.block_positions(H, Wd, n), device=dev)
    cpos = pos // 2
    th = th or H
    tw = tw or Wd

    if stripe:
        ref_pad_y, ref_pad_u, ref_pad_v = ref_y, ref_u, ref_v
    else:
        ref_pad_y = prep_ref(ref_y, th, tw, PAD)
        ref_pad_u = prep_ref(ref_u, th // 2, tw // 2, PAD // 2)
        ref_pad_v = prep_ref(ref_v, th // 2, tw // 2, PAD // 2)

    src_y = y.to(I32)
    blocks = _blockify(src_y, n, gh, gw)
    q = Quantizer(qindex, bit_depth, qround, dev)
    lam = (q.acq * q.acq) >> 7

    mv_fp = motion.search_v3(src_y, ref_pad_y, n).clamp(-_MAX_FP, _MAX_FP)
    c_l = ref_pad_y[PAD:PAD + H, PAD:PAD + Wd].to(I32)
    gld_pad_y = gld_pad_u = gld_pad_v = refsel = c_g = None
    if gld is not None:
        if stripe:
            gld_pad_y, gld_pad_u, gld_pad_v = gld
        else:
            gld_pad_y = prep_ref(gld[0], th, tw, PAD)
            gld_pad_u = prep_ref(gld[1], th // 2, tw // 2, PAD // 2)
            gld_pad_v = prep_ref(gld[2], th // 2, tw // 2, PAD // 2)
        c_g = gld_pad_y[PAD:PAD + H, PAD:PAD + Wd].to(I32)
        # GOLDEN at the zero MV against LAST at its full-pel winner, in
        # int32 like the reference (the golden SSD passes through
        # float32 there; summed exactly here, then converted)
        ssd_g = motion.zero_ssd(src_y, c_g, n).to(I32)
        ssd_l = _ssd(blocks, motion.gather_blocks(ref_pad_y, pos, mv_fp, n))
        # rate-aware margin: a ~6% distortion win plus ~2 bits at the
        # frame lambda before a block switches to GOLDEN
        use_g = ssd_g + ssd_g // 16 + 2 * lam < ssd_l
        refsel = use_g.to(I32)
        mv_fp = torch.where(use_g[:, None], 0, mv_fp)
    mv8, pred_y = _qpel_refine9(blocks, ref_pad_y, pos, mv_fp * 8, n,
                                bit_depth, gld_pad_y, refsel)
    ref_pad_uv = (ref_pad_u, ref_pad_v)
    gld_pad_uv = None if gld is None else (gld_pad_u, gld_pad_v)
    pred_u, pred_v = _mc_blocks(ref_pad_uv, cpos, mv8, n // 2, 1, bit_depth,
                                gld_pad_uv, refsel)

    def plane_pipe(src, preds, nn, shift, nbh, nbw):
        fmat = fwd_mat("dct", nn, dev)
        sb = _blockify(src, nn, nbh, nbw)
        resid = (sb - preds).to(torch.float32)
        coef = fmat @ resid @ fmat.T
        lv = q.quant(coef, nn, shift)
        rec = inv_tx2d_add(q.dequant(lv, nn, shift), preds, bit_depth)
        return lv, rec

    def skip_rdo(src3, preds3, lvs3, recs3):
        """Per-block skip decision over the 3 planes (int32 costs, as the
        reference computes them with x64 off)."""
        d_skip = sum(_ssd(s, p) for s, p in zip(src3, preds3))
        d_code = sum(_ssd(s, r) for s, r in zip(src3, recs3))
        nnz = sum((l != 0).sum((1, 2), dtype=I32) for l in lvs3)
        force = d_skip < d_code + lam * (3 * nnz)
        fmask = force[:, None, None]
        lvs = [torch.where(fmask, 0, l) for l in lvs3]
        recs = [torch.where(fmask, p, r) for p, r in zip(preds3, recs3)]
        d = torch.where(force, d_skip, d_code)
        nnz = torch.where(force, 0, nnz)
        skip = ((lvs[0] == 0).all(2).all(1) & (lvs[1] == 0).all(2).all(1)
                & (lvs[2] == 0).all(2).all(1)).to(I32)
        return lvs, recs, d, nnz, skip

    lv_y, rec_y_b = plane_pipe(y, pred_y, 32, 1, gh, gw)
    lv_u, rec_u_b = plane_pipe(u, pred_u, 16, 0, gh, gw)
    lv_v, rec_v_b = plane_pipe(v, pred_v, 16, 0, gh, gw)
    yb, ub, vb = (_blockify(y, 32, gh, gw), _blockify(u, 16, gh, gw),
                  _blockify(v, 16, gh, gw))
    (lv_y, lv_u, lv_v), (rec_y_b, rec_u_b, rec_v_b), d32, nnz32, skip = \
        skip_rdo((yb, ub, vb), (pred_y, pred_u, pred_v),
                 (lv_y, lv_u, lv_v), (rec_y_b, rec_u_b, rec_v_b))

    rec_y_p = _to_plane(rec_y_b, 32, gh, gw)
    rec_u_p = _to_plane(rec_u_b, 16, gh, gw)
    rec_v_p = _to_plane(rec_v_b, 16, gh, gw)
    lv_y_p = _to_plane(lv_y, 32, gh, gw)
    lv_u_p = _to_plane(lv_u, 16, gh, gw)
    lv_v_p = _to_plane(lv_v, 16, gh, gw)

    # ---- 32 -> 16 partition RD (spec PARTITION_SPLIT) ----------------
    g16h, g16w = H // 16, Wd // 16
    B16 = g16h * g16w
    pos16 = torch.as_tensor(motion.block_positions(H, Wd, 16), device=dev)
    cpos16 = pos16 // 2
    blocks16 = _blockify(y, 16, g16h, g16w)
    # quadrants seed from the parent's selected full-pel winner and
    # refine +-8 in K2
    seed16 = mv_fp.reshape(gh, gw, 2).repeat_interleave(2, 0) \
        .repeat_interleave(2, 1).reshape(B16, 2)
    ssd16_zero = motion.zero_ssd(src_y, c_l, 16)
    ri16 = None
    if gld is None:
        mv16_r, ssd16_r = refine.refine_around_seeds(
            blocks16, ref_pad_y, pos16, seed16, 16, 8, PAD)
    else:
        # quadrants inherit the parent's reference
        ri16 = refsel.reshape(gh, gw).repeat_interleave(2, 0) \
            .repeat_interleave(2, 1).reshape(B16)
        mv16_r, ssd16_r = refine.refine_around_seeds2(
            blocks16, ref_pad_y, gld_pad_y, ri16, pos16, seed16, 16, 8, PAD)
        ssd16_zero = torch.where(ri16 > 0, motion.zero_ssd(src_y, c_g, 16),
                                 ssd16_zero)
    keep = ssd16_r + ssd16_r / 16.0 < ssd16_zero
    mv16_fp = torch.where(keep[:, None], mv16_r, 0).clamp(-_MAX_FP, _MAX_FP)
    mv16, pred16_y = _qpel_refine9(blocks16, ref_pad_y, pos16, mv16_fp * 8,
                                   16, bit_depth, gld_pad_y, ri16)
    pred16_u, pred16_v = _mc_blocks(ref_pad_uv, cpos16, mv16, 8, 1,
                                    bit_depth, gld_pad_uv, ri16)
    lv16_y, rec16_y = plane_pipe(y, pred16_y, 16, 0, g16h, g16w)
    lv16_u, rec16_u = plane_pipe(u, pred16_u, 8, 0, g16h, g16w)
    lv16_v, rec16_v = plane_pipe(v, pred16_v, 8, 0, g16h, g16w)
    u16b = _blockify(u, 8, g16h, g16w)
    v16b = _blockify(v, 8, g16h, g16w)
    (lv16s, rec16s, d16, nnz16, skip16) = skip_rdo(
        (blocks16, u16b, v16b), (pred16_y, pred16_u, pred16_v),
        (lv16_y, lv16_u, lv16_v), (rec16_y, rec16_u, rec16_v))
    lv16_y, lv16_u, lv16_v = lv16s
    rec16_y, rec16_u, rec16_v = rec16s

    def quads(a):
        # (B16, ...) -> (B, 4, ...) in z-order (0,0),(0,1),(1,0),(1,1)
        g = a.reshape(gh, 2, gw, 2, *a.shape[1:])
        return torch.stack([g[:, 0, :, 0], g[:, 0, :, 1], g[:, 1, :, 0],
                            g[:, 1, :, 1]], dim=2).reshape(B, 4,
                                                           *a.shape[1:])

    d16_sum = quads(d16).sum(1, dtype=I32)
    nnz16_sum = quads(nnz16).sum(1, dtype=I32)
    # header-bit model: ~8 bits per coded unit, +2 for the partition
    HB = 8
    cost32 = d32 + lam * (3 * nnz32 + HB)
    cost16 = d16_sum + lam * (3 * nnz16_sum + 4 * HB + 2)
    # only blocks fully inside the coded mi grid may split
    mi_rows_t = 2 * ((th + 7) >> 3)
    mi_cols_t = 2 * ((tw + 7) >> 3)
    bi = torch.arange(B, device=dev) // gw + row0 // 32
    bj = torch.arange(B, device=dev) % gw
    inside = ((bi + 1) * 8 <= mi_rows_t) & ((bj + 1) * 8 <= mi_cols_t)
    split = (cost16 < cost32) & inside
    sm = split.reshape(gh, gw)

    def sel_plane(p32, b16, nn16):
        p16 = _to_plane(b16, nn16, g16h, g16w)
        m = sm.repeat_interleave(2 * nn16, 0).repeat_interleave(2 * nn16, 1)
        return torch.where(m, p16, p32)

    rec_y_p = sel_plane(rec_y_p, rec16_y, 16)
    rec_u_p = sel_plane(rec_u_p, rec16_u, 8)
    rec_v_p = sel_plane(rec_v_p, rec16_v, 8)
    lv_y_p = sel_plane(lv_y_p, lv16_y, 16)
    lv_u_p = sel_plane(lv_u_p, lv16_u, 8)
    lv_v_p = sel_plane(lv_v_p, lv16_v, 8)
    mv16_z = quads(mv16)
    skip16_z = quads(skip16)
    split = split.to(I32)

    if stripe:
        strip_skip = torch.zeros((2 * (Wd // 32),), dtype=I32, device=dev)
        cdefs = torch.zeros((4,), dtype=I32, device=dev)
        lr_choice, lr_taps = lr_off_outputs(th, tw, dev)
    else:
        rec_y_p, rec_u_p, rec_v_p, strip_skip, cdefs, lr_choice, lr_taps = \
            finish_frame((y, u, v), (rec_y_p, rec_u_p, rec_v_p),
                         (lv_y_p, lv_u_p, lv_v_p), skip.reshape(gh, gw),
                         split.reshape(gh, gw), skip16_z, q, bit_depth, th,
                         tw, lf_y=lf_y, lf_uv=lf_uv, deblock=deblock,
                         cdef=cdef, cdef_damping=cdef_damping, lr=lr)
    if refsel is None:
        refsel = torch.zeros((B,), dtype=I32, device=dev)
    return (mv8, skip, lv_y_p, lv_u_p, lv_v_p, rec_y_p, rec_u_p, rec_v_p,
            strip_skip, cdefs, lr_choice, split, mv16_z, skip16_z, refsel,
            lr_taps)

"""Spec-AV1 keyframe encoder in PyTorch (port of ``specav1/jax_intra.py``).

A wavefront over 32x32 blocks: each wave is the set of blocks whose
above, left, above-right and (superblock-corner) bottom-left neighbours
are done, and runs as one batched step over its blocks (the reference
runs each wave as one ``lax.scan`` step of a vmap).  Per block: edge
assembly by the spec availability rules, all 45 luma candidates (nine
modes, directional ones at every angle delta), full RD in the transform
domain, a joint chroma DC/V/H choice, and the 32 -> 16 split RD over
four quadrants with mode-derived transform kinds.  Reconstruction is the
spec-exact integer inverse transform, so a conforming decoder
reproduces it bit for bit.

The port covers ``split16=True``.  The in-loop filters run on the
finished reconstruction in the reference's order: deblocking
(``specav1.loopfilter``), CDEF (``specav1.torch_cdef``), then the Wiener
loop restoration (``specav1.torch_lr``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1tpu_torch.encoder.kernels.motion import first_argmin
from av1tpu_torch.specav1 import recon, torch_inter
from av1tpu_torch.specav1.tile import MODE_TO_TXFM
from av1tpu_torch.specav1.transforms import (Quantizer, fwd_mat,
                                             inv_tx2d_add,
                                             inv_tx2d_add_mixed)
from av1tpu_torch.utils import spans as tracer

I32 = torch.int32
F32 = torch.float32

# --- candidate tables: copied from jax_intra (a JAX module) -----------------
# mode order must match encode.py _MODES (first-strict-min tie-breaks)
_MODE_IDS = np.array([recon.DC_PRED, recon.V_PRED, recon.H_PRED,
                      recon.SMOOTH_PRED, recon.PAETH_PRED, recon.D45_PRED,
                      recon.D135_PRED, recon.D203_PRED, recon.D67_PRED],
                     np.int32)
_DIRECTIONAL = np.array([0, 1, 1, 0, 0, 1, 1, 1, 1], bool)

_CAND_MODE = []
_CAND_DELTA = []
for _m, _d in zip(_MODE_IDS, _DIRECTIONAL):
    if _d:
        for _dl in range(-3, 4):
            _CAND_MODE.append(int(_m))
            _CAND_DELTA.append(_dl)
    else:
        _CAND_MODE.append(int(_m))
        _CAND_DELTA.append(0)
_CAND_MODE = np.array(_CAND_MODE, np.int32)       # (45,)
_CAND_DELTA = np.array(_CAND_DELTA, np.int32)
_CAND_DIR = np.array([recon.MODE_ANGLE.get(int(m), 0) != 0
                      for m in _CAND_MODE], bool)
# candidates whose prediction angle exceeds 180 read the BELOW-LEFT edge
_CAND_READS_BL = np.array(
    [recon.MODE_ANGLE.get(int(m), 0) + 3 * int(d) > 180 if dirn else False
     for m, d, dirn in zip(_CAND_MODE, _CAND_DELTA, _CAND_DIR)], bool)

_UV_MODE_IDS = np.array([recon.DC_PRED, recon.V_PRED, recon.H_PRED],
                        np.int32)
_UV_TX_KINDS = (("dct", "dct"), ("dct", "adst"), ("adst", "dct"))
_UV_DIR = np.array([recon.MODE_ANGLE.get(int(m), 0) != 0
                    for m in _UV_MODE_IDS], bool)

_Y16_COMBOS = (("dct", "dct"), ("dct", "adst"),
               ("adst", "dct"), ("adst", "adst"))


def _mode_combo(mode: int) -> int:
    """Index into _Y16_COMBOS of a mode's derived 16x16 transform.
    Copied from jax_intra._mode_combo."""
    return _Y16_COMBOS.index(recon.TX_1D[MODE_TO_TXFM[mode]])


_CAND_COMBO = np.array([_mode_combo(int(m)) for m in _CAND_MODE], np.int32)

# header-bit model for the keyframe 32->16 split RD
_HB16 = 10.0


# --- static plans: copied from jax_intra (host numpy) -----------------------

@functools.lru_cache(maxsize=None)
def plan_waves(nbr: int, nbc: int, tile_row_starts: tuple = ()):
    """Wavefront levels + availability for an nbr x nbc grid of 32x32
    blocks, by simulating the decoder's raster-SB/z-order walk.
    Copied from jax_intra.plan_waves.

    Returns dict of (nwaves, maxb) int32 arrays: r, c, have_a, have_l,
    ntr, nbl, valid."""
    starts = sorted(set([0] + list(tile_row_starts)))
    tile_of = np.zeros(nbr, np.int32)
    for t, s0 in enumerate(starts):
        tile_of[s0:] = t
    level = np.zeros((nbr, nbc), np.int64)
    ntr = np.zeros((nbr, nbc), np.int32)
    nbl = np.zeros((nbr, nbc), np.int32)
    have_a = np.zeros((nbr, nbc), np.int32)
    decoded = np.zeros((nbr, nbc), bool)
    order = []
    for sr in range(0, nbr, 2):
        for sc in range(0, nbc, 2):
            for dr, dc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                r, c = sr + dr, sc + dc
                if r < nbr and c < nbc:
                    order.append((r, c))
    for r, c in order:
        deps = []
        up = r > 0 and tile_of[r - 1] == tile_of[r]
        have_a[r, c] = int(up)
        if up:
            deps.append((r - 1, c))
        if c > 0:
            deps.append((r, c - 1))
        if up and c + 1 < nbc and decoded[r - 1, c + 1]:
            ntr[r, c] = 32
            deps.append((r - 1, c + 1))
        if c > 0 and r + 1 < nbr and tile_of[r + 1] == tile_of[r] \
                and decoded[r + 1, c - 1]:
            nbl[r, c] = 32
            deps.append((r + 1, c - 1))
        level[r, c] = 1 + max((level[d] for d in deps), default=-1)
        decoded[r, c] = True
    nwaves = int(level.max()) + 1
    waves = [[] for _ in range(nwaves)]
    for r, c in order:
        waves[int(level[r, c])].append((r, c))
    maxb = max(len(wv) for wv in waves)
    out = {k: np.zeros((nwaves, maxb), np.int32)
           for k in ("r", "c", "have_a", "have_l", "ntr", "nbl", "valid")}
    for i, wv in enumerate(waves):
        for j, (r, c) in enumerate(wv):
            out["r"][i, j] = r
            out["c"][i, j] = c
            out["have_a"][i, j] = have_a[r, c]
            out["have_l"][i, j] = int(c > 0)
            out["ntr"][i, j] = ntr[r, c]
            out["nbl"][i, j] = nbl[r, c]
            out["valid"][i, j] = 1
    return out


@functools.lru_cache(maxsize=None)
def _dir_tables(mode: int, size: int, delta: int = 0):
    """Static two-tap gather tables for a directional predictor at
    angle_delta ``delta``.  Copied from jax_intra._dir_tables.

    Returns (sel, i0, i1, w1) int32 (size, size) arrays: prediction =
    round2(src[i0]*(32-w1) + src[i1]*w1, 5) where src is ar_full when
    sel==0 else lc_full (length 2*size+1, index 0 = corner)."""
    p_angle = recon.MODE_ANGLE[mode] + 3 * delta
    w = h = size
    mx = w + h - 1
    sel = np.zeros((h, w), np.int32)
    i0 = np.zeros((h, w), np.int32)
    i1 = np.zeros((h, w), np.int32)
    w1 = np.zeros((h, w), np.int32)
    for i in range(h):
        for j in range(w):
            if p_angle < 90:
                dx = int(recon.DR_DERIVATIVE[p_angle])
                idx = (i + 1) * dx
                base_i = (idx >> 6) + j
                shift = (idx >> 1) & 0x1F
                if base_i > mx:
                    i0[i, j] = i1[i, j] = 1 + mx
                    w1[i, j] = 0
                else:
                    i0[i, j] = 1 + min(base_i, mx)
                    i1[i, j] = 1 + min(base_i + 1, mx)
                    w1[i, j] = shift
            elif p_angle > 180:
                dy = int(recon.DR_DERIVATIVE[270 - p_angle])
                idx = (j + 1) * dy
                base_i = (idx >> 6) + i
                shift = (idx >> 1) & 0x1F
                sel[i, j] = 1
                i0[i, j] = 1 + min(base_i, mx)
                i1[i, j] = 1 + min(base_i + 1, mx)
                w1[i, j] = shift
            else:  # zone 2
                dx = int(recon.DR_DERIVATIVE[180 - p_angle])
                idx = (j << 6) - (i + 1) * dx
                base_i = idx >> 6
                if base_i >= -1:
                    shift = (idx >> 1) & 0x1F
                    i0[i, j] = 1 + base_i
                    i1[i, j] = 2 + base_i
                    w1[i, j] = shift
                else:
                    dy = int(recon.DR_DERIVATIVE[p_angle - 90])
                    idx2 = (i << 6) - (j + 1) * dy
                    base2 = idx2 >> 6
                    shift = (idx2 >> 1) & 0x1F
                    sel[i, j] = 1
                    i0[i, j] = 1 + base2
                    i1[i, j] = 2 + base2
                    w1[i, j] = shift
    return sel, i0, i1, w1


def _round2(x, n: int):
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# batched predictors: every tensor carries the wave's blocks in dim 0
# ---------------------------------------------------------------------------

class _Predictor:
    """Stacked static tables for one (size, candidate list), built once
    per device: the table-driven (directional) candidates predict in one
    gather, the rest by their closed forms."""

    def __init__(self, size: int, modes, deltas, device):
        self.size = size
        self.modes = [int(m) for m in modes]
        self.deltas = [int(d) for d in deltas]
        self.table_idx = []
        sels, i0s, i1s, w1s = [], [], [], []
        for k, (m, dl) in enumerate(zip(self.modes, self.deltas)):
            if dl != 0 or m not in (recon.DC_PRED, recon.V_PRED,
                                    recon.H_PRED, recon.PAETH_PRED,
                                    recon.SMOOTH_PRED):
                sel, i0, i1, w1 = _dir_tables(m, size, dl)
                self.table_idx.append(k)
                sels.append(sel)
                i0s.append(i0)
                i1s.append(i1)
                w1s.append(w1)
        if self.table_idx:
            def t(a, dt=torch.int64):
                return torch.as_tensor(np.stack(a), dtype=dt, device=device)
            self.sel0 = t(sels, torch.bool).logical_not()
            self.i0 = t(i0s)
            self.i1 = t(i1s)
            self.w1 = t(w1s, I32)
        wv = np.asarray(recon.SM_WEIGHTS[size], np.int32)
        self.sm_w = torch.as_tensor(wv, device=device)

    def __call__(self, ar, lc, corner, have_a, have_l, base: int):
        """ar/lc (Bw, 2*size+1) int32 with [:, 0] = corner; corner,
        have_a, have_l (Bw,).  Returns (Bw, ncand, size, size) int32."""
        size = self.size
        Bw = ar.shape[0]
        above = ar[:, 1:1 + size]
        left = lc[:, 1:1 + size]
        n2 = size.bit_length() - 1
        out = [None] * len(self.modes)
        if self.table_idx:
            v0 = torch.where(self.sel0, ar[:, self.i0], lc[:, self.i0])
            v1 = torch.where(self.sel0, ar[:, self.i1], lc[:, self.i1])
            tab = _round2(v0 * (32 - self.w1) + v1 * self.w1, 5)
            for j, k in enumerate(self.table_idx):
                out[k] = tab[:, j]
        for k, (m, dl) in enumerate(zip(self.modes, self.deltas)):
            if out[k] is not None:
                continue
            if m == recon.DC_PRED:
                s_a = above.sum(1, dtype=I32)
                s_l = left.sum(1, dtype=I32)
                v = torch.where(
                    have_a & have_l, (s_a + s_l + size) // (2 * size),
                    torch.where(have_a, (s_a + (size >> 1)) >> n2,
                                torch.where(have_l,
                                            (s_l + (size >> 1)) >> n2,
                                            torch.full_like(s_a, base))))
                out[k] = v[:, None, None].expand(Bw, size, size)
            elif m == recon.V_PRED:
                out[k] = above[:, None, :].expand(Bw, size, size)
            elif m == recon.H_PRED:
                out[k] = left[:, :, None].expand(Bw, size, size)
            elif m == recon.PAETH_PRED:
                a = above[:, None, :]
                l_ = left[:, :, None]
                c = corner[:, None, None]
                pb = a + l_ - c
                pa = (pb - a).abs()
                pl = (pb - l_).abs()
                pc = (pb - c).abs()
                out[k] = torch.where((pa <= pl) & (pa <= pc), a,
                                     torch.where(pl <= pc, l_, c))
            else:  # SMOOTH_PRED
                br = left[:, size - 1, None, None]
                rt = above[:, size - 1, None, None]
                i = self.sm_w[None, :, None]
                j = self.sm_w[None, None, :]
                s = (i * above[:, None, :] + (256 - i) * br +
                     j * left[:, :, None] + (256 - j) * rt)
                out[k] = _round2(s, 9)
        return torch.stack([o.expand(Bw, size, size) for o in out], 1)


def _gather_edges(rec, y0, x0, have_a, have_l, ntr, nbl, size: int,
                  base: int, fdims):
    """(ar_full, lc_full, corner) for a batch of blocks: (Bw, 2*size+1)
    edge vectors with [:, 0] = corner, mirroring recon.predict_intra's
    edge assembly; reads clamp at the coded dims ``fdims``."""
    n = 2 * size
    fh, fw = fdims
    y0c = (y0 - 1).clamp(min=0)
    x0c = (x0 - 1).clamp(min=0)
    ar_n = torch.arange(n, device=rec.device)
    na = (size + ntr).clamp(max=n).minimum(fw - x0).clamp(min=1)
    above = rec[y0c[:, None], x0[:, None] + ar_n[None].minimum(
        na[:, None] - 1)]
    ha = have_a[:, None]
    hl = have_l[:, None]
    above = torch.where(ha, above, torch.where(
        hl, rec[y0, x0c][:, None], base - 1))
    nl = (size + nbl).clamp(max=n).minimum(fh - y0).clamp(min=1)
    left = rec[y0[:, None] + ar_n[None].minimum(nl[:, None] - 1),
               x0c[:, None]]
    left = torch.where(hl, left, torch.where(
        ha, rec[y0c, x0][:, None], base + 1))
    corner = torch.where(have_a & have_l, rec[y0c, x0c],
                         torch.where(have_a, rec[y0c, x0],
                                     torch.where(have_l, rec[y0, x0c],
                                                 base)))
    ar = torch.cat([corner[:, None], above], 1)
    lc = torch.cat([corner[:, None], left], 1)
    return ar, lc, corner


def _ext_cap(vec, own: int, ext_flag):
    """Replicate past own+ext, ext in {0, own} (ext_flag per block)."""
    cap = torch.where(ext_flag, vec[:, 2 * own - 1], vec[:, own - 1])
    n_ok = torch.where(ext_flag, 2 * own, own)
    keep = torch.arange(2 * own, device=vec.device)[None] < n_ok[:, None]
    return torch.where(keep, vec, cap[:, None])


def _rep(v, k: int):
    """(Bw,) -> (Bw, k) repeated column."""
    return v[:, None].expand(v.shape[0], k)


def _edge(cnr, ab, lf):
    return (torch.cat([cnr[:, None], ab], 1),
            torch.cat([cnr[:, None], lf], 1), cnr)


def _take(x, idx):
    """x[b, idx[b]] for a batch-first tensor."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


class _KeyCtx:
    """Per-frame constants of one keyframe encode."""

    def __init__(self, qindex, bit_depth, qround, device):
        self.q = Quantizer(qindex, bit_depth, qround, device)
        self.bd = bit_depth
        self.base = 1 << (bit_depth - 1)
        self.dev = device
        # nonzero angle deltas cost ~2 extra bits at the skip-RDO lambda
        self.lam = (self.q.acq * self.q.acq) >> 7
        self.lam_f = torch.tensor(float(self.lam), dtype=F32, device=device)
        t = functools.partial(torch.as_tensor, device=device)
        self.dcosts = t(self.lam * 2 * (_CAND_DELTA != 0), dtype=I32).to(F32)
        self.cand_dir = t(_CAND_DIR)
        self.reads_bl = t(_CAND_READS_BL)
        self.cand_mode = t(_CAND_MODE, dtype=I32)
        self.cand_delta = t(_CAND_DELTA, dtype=I32)
        self.cand_combo = t(_CAND_COMBO, dtype=torch.int64)
        self.uv_modes = t(_UV_MODE_IDS, dtype=I32)
        self.uv_dir = t(_UV_DIR)
        self.big = torch.tensor(1e18, dtype=F32, device=device)
        self.zero_f = torch.tensor(0.0, dtype=F32, device=device)
        self.pred_y32 = _Predictor(32, _CAND_MODE, _CAND_DELTA, device)
        self.pred_y16 = _Predictor(16, _CAND_MODE, _CAND_DELTA, device)
        self.pred_uv16 = _Predictor(16, _UV_MODE_IDS, [0, 0, 0], device)
        self.pred_uv8 = _Predictor(8, _UV_MODE_IDS, [0, 0, 0], device)
        self.fm = {(k, n): fwd_mat(k, n, device)
                   for k in ("dct", "adst") for n in (8, 16)}
        self.fm[("dct", 32)] = fwd_mat("dct", 32, device)
        kinds16 = [_Y16_COMBOS[int(k)] for k in _CAND_COMBO]
        self.fc16 = torch.stack([self.fm[(ck, 16)] for _, ck in kinds16])
        self.fr16 = torch.stack([self.fm[(rk, 16)] for rk, _ in kinds16])
        self.combo_row_adst = t([rk == "adst" for rk, _ in _Y16_COMBOS])
        self.combo_col_adst = t([ck == "adst" for _, ck in _Y16_COMBOS])

    def uv_choice(self, srcs, edges, ha, hl, size: int, predictor):
        """Joint chroma DC/V/H RD over both planes: every candidate's
        transform kinds (spec compute_tx_type) are coded and the
        post-quantization distortion + lambda*rate picks one.  Returns
        (uv_idx (Bw,), lv_u, lv_v, rec_u, rec_v, cost_int (Bw,), and the
        per-candidate dist and nnz (Bw, 3))."""
        q, bd = self.q, self.bd
        lv_pl, rec_pl = [], []
        for (arc, lcc, cornc), s in zip(edges, srcs):
            preds = predictor(arc, lcc, cornc, ha, hl, self.base)
            lv_k, rec_k = [], []
            for k, (rk, ck) in enumerate(_UV_TX_KINDS):
                fr, fc = self.fm[(rk, size)], self.fm[(ck, size)]
                coef = fc @ (s - preds[:, k]).to(F32) @ fr.T
                lvc = q.quant(coef, size, 0)
                recc = inv_tx2d_add(q.dequant(lvc, size, 0), preds[:, k],
                                    bd, row_kind=rk, col_kind=ck)
                lv_k.append(lvc)
                rec_k.append(recc)
            lv_pl.append(torch.stack(lv_k, 1))
            rec_pl.append(torch.stack(rec_k, 1))
        dist = sum(((s[:, None] - rp) ** 2).sum((2, 3), dtype=I32)
                   for rp, s in zip(rec_pl, srcs))
        nz = sum((l != 0).sum((2, 3), dtype=I32) for l in lv_pl)
        pen = torch.where(self.uv_dir[None] & ~(ha | hl)[:, None],
                          1 << 30, 0).to(I32)
        kq = first_argmin(dist + self.lam * (3 * nz) + pen, 1)
        return (kq, _take(lv_pl[0], kq), _take(lv_pl[1], kq),
                _take(rec_pl[0], kq), _take(rec_pl[1], kq),
                _take(dist, kq) + self.lam * 3 * _take(nz, kq),
                dist, nz)


def _block_step(ctx: _KeyCtx, rec_y, rec_u, rec_v, src_y, src_u, src_v,
                r, c, ha, hl, ntr, nbl, fh_c: int, fw8: int,
                strip_row, split_ok):
    """block_fn of the reference, batched over one wave's blocks."""
    q, bd, base, dev = ctx.q, ctx.bd, ctx.base, ctx.dev
    y0, x0 = r * 32, c * 32
    ar, lcv, corner = _gather_edges(rec_y, y0, x0, ha, hl, ntr, nbl, 32,
                                    base, (fh_c, fw8))
    preds = ctx.pred_y32(ar, lcv, corner, ha, hl, base)   # (Bw,45,32,32)
    a32 = torch.arange(32, device=dev)
    sy = src_y[(y0[:, None] + a32)[:, :, None],
               (x0[:, None] + a32)[:, None, :]]
    # full-RD luma mode decision in the transform domain
    resids = (sy[:, None] - preds).to(F32)
    fm32 = ctx.fm[("dct", 32)]
    coefs = fm32 @ resids @ fm32.T
    lvs = q.quant(coefs, 32, 1)
    deqs = q.dequant(lvs, 32, 1).to(F32)
    qerr = ((coefs - deqs) ** 2).sum((2, 3)) / 64.0
    nnzs = (lvs != 0).sum((2, 3), dtype=I32)
    rd = qerr + ctx.lam_f * (3.0 * nnzs) + ctx.dcosts
    rd = rd + torch.where(ctx.cand_dir[None] & ~(ha | hl)[:, None],
                          ctx.big, ctx.zero_f)
    if strip_row is not None:
        rd = rd + torch.where(ctx.reads_bl[None] & strip_row[:, None],
                              ctx.big, ctx.zero_f)
    mi = first_argmin(rd, 1)
    mode = ctx.cand_mode[mi]
    angle = ctx.cand_delta[mi]
    pred = _take(preds, mi)
    lvy = _take(lvs, mi)
    rec_blk_y = inv_tx2d_add(q.dequant(lvy, 32, 1), pred, bd)

    # chroma: one shared uv_mode from {DC, V, H}
    cy0, cx0 = y0 // 2, x0 // 2
    a16 = torch.arange(16, device=dev)
    crows = (cy0[:, None] + a16)[:, :, None]
    ccols = (cx0[:, None] + a16)[:, None, :]
    csrcs = [src_u[crows, ccols], src_v[crows, ccols]]
    cedges = [_gather_edges(rec_p, cy0, cx0, ha, hl, ntr // 2, nbl // 2,
                            16, base, (fh_c // 2, fw8 // 2))
              for rec_p in (rec_u, rec_v)]
    (uvmi, lvu, lvv, rec_blk_u, rec_blk_v, _, cdist, cnnz) = ctx.uv_choice(
        csrcs, cedges, ha, hl, 16, ctx.pred_uv16)
    uv_mode = ctx.uv_modes[uvmi]
    skip = ((lvy == 0).all(2).all(1) & (lvu == 0).all(2).all(1) &
            (lvv == 0).all(2).all(1)).to(I32)

    # ---- 32 -> 16 keyframe partition split RD ----------------------
    Bw = r.shape[0]
    true_ = torch.ones((Bw,), dtype=torch.bool, device=dev)
    ext_tr = ntr > 0
    ext_bl = nbl > 0
    lam_f = ctx.lam_f
    (arc_u, lcc_u, corn_u), (arc_v, lcc_v, corn_v) = cedges
    loc_y = torch.zeros((Bw, 32, 32), dtype=I32, device=dev)
    loc_u = torch.zeros((Bw, 16, 16), dtype=I32, device=dev)
    loc_v = torch.zeros((Bw, 16, 16), dtype=I32, device=dev)
    lvy16 = torch.zeros_like(loc_y)
    lvu16 = torch.zeros_like(loc_u)
    lvv16 = torch.zeros_like(loc_v)
    m16l, a16l, u16l, s16l = [], [], [], []
    rd_split = lam_f * (4.0 * _HB16 + 2.0)
    for qr, qc in ((0, 0), (0, 1), (1, 0), (1, 1)):
        if (qr, qc) == (0, 0):
            ar33, lc33, cnr_q = ar[:, :33], lcv[:, :33], corner
            ha_q, hl_q = ha, hl
            e_u = (arc_u[:, :17], lcc_u[:, :17], corn_u)
            e_v = (arc_v[:, :17], lcc_v[:, :17], corn_v)
        elif (qr, qc) == (0, 1):
            tlc = loc_y[:, 0:16, 15]
            abv = _ext_cap(ar[:, 17:49], 16, ext_tr)
            abv = torch.where(ha[:, None], abv, tlc[:, 0:1])
            lft = torch.cat([tlc, _rep(tlc[:, 15], 16)], 1)
            cnr_q = torch.where(ha, ar[:, 16], tlc[:, 0])
            ar33, lc33, _ = _edge(cnr_q, abv, lft)
            ha_q, hl_q = ha, true_

            def _tr_c(arc, locp):
                tl = locp[:, 0:8, 7]
                ab = _ext_cap(arc[:, 9:25], 8, ext_tr)
                ab = torch.where(ha[:, None], ab, tl[:, 0:1])
                lf = torch.cat([tl, _rep(tl[:, 7], 8)], 1)
                cq = torch.where(ha, arc[:, 8], tl[:, 0])
                return _edge(cq, ab, lf)

            e_u = _tr_c(arc_u, loc_u)
            e_v = _tr_c(arc_v, loc_v)
        elif (qr, qc) == (1, 0):
            abv = loc_y[:, 15, 0:32]
            lft = _ext_cap(lcv[:, 17:49], 16, ext_bl)
            lft = torch.where(hl[:, None], lft, loc_y[:, 15, 0:1])
            cnr_q = torch.where(hl, lcv[:, 16], loc_y[:, 15, 0])
            ar33, lc33, _ = _edge(cnr_q, abv, lft)
            ha_q, hl_q = true_, hl

            def _bl_c(lcc, locp):
                ab = locp[:, 7, 0:16]
                lf = _ext_cap(lcc[:, 9:25], 8, ext_bl)
                lf = torch.where(hl[:, None], lf, locp[:, 7, 0:1])
                cq = torch.where(hl, lcc[:, 8], locp[:, 7, 0])
                return _edge(cq, ab, lf)

            e_u = _bl_c(lcc_u, loc_u)
            e_v = _bl_c(lcc_v, loc_v)
        else:
            abv = torch.cat([loc_y[:, 15, 16:32], _rep(loc_y[:, 15, 31], 16)],
                            1)
            lft = torch.cat([loc_y[:, 16:32, 15], _rep(loc_y[:, 31, 15], 16)],
                            1)
            cnr_q = loc_y[:, 15, 15]
            ar33, lc33, _ = _edge(cnr_q, abv, lft)
            ha_q = hl_q = true_

            def _br_c(locp):
                ab = torch.cat([locp[:, 7, 8:16], _rep(locp[:, 7, 15], 8)], 1)
                lf = torch.cat([locp[:, 8:16, 7], _rep(locp[:, 15, 7], 8)], 1)
                return _edge(locp[:, 7, 7], ab, lf)

            e_u = _br_c(loc_u)
            e_v = _br_c(loc_v)
        sy16 = sy[:, qr * 16:(qr + 1) * 16, qc * 16:(qc + 1) * 16]
        # luma quadrant: 45 candidates with mode-derived transforms
        preds16 = ctx.pred_y16(ar33, lc33, cnr_q, ha_q, hl_q, base)
        res16 = (sy16[:, None] - preds16).to(F32)
        coef16 = ctx.fc16 @ res16 @ ctx.fr16.transpose(1, 2)
        lvs16 = q.quant(coef16, 16, 0)
        deq16 = q.dequant(lvs16, 16, 0).to(F32)
        qerr16 = ((coef16 - deq16) ** 2).sum((2, 3)) / 64.0
        nnz16 = (lvs16 != 0).sum((2, 3), dtype=I32)
        rdq = qerr16 + lam_f * (3.0 * nnz16) + ctx.dcosts
        rdq = rdq + torch.where(ctx.cand_dir[None] & ~(ha_q | hl_q)[:, None],
                                ctx.big, ctx.zero_f)
        mq = first_argmin(rdq, 1)
        lvq = _take(lvs16, mq)
        combo = ctx.cand_combo[mq]
        recq = inv_tx2d_add_mixed(q.dequant(lvq, 16, 0), _take(preds16, mq),
                                  bd, ctx.combo_row_adst[combo],
                                  ctx.combo_col_adst[combo])
        loc_y[:, qr * 16:(qr + 1) * 16, qc * 16:(qc + 1) * 16] = recq
        lvy16[:, qr * 16:(qr + 1) * 16, qc * 16:(qc + 1) * 16] = lvq
        su8 = csrcs[0][:, qr * 8:(qr + 1) * 8, qc * 8:(qc + 1) * 8]
        sv8 = csrcs[1][:, qr * 8:(qr + 1) * 8, qc * 8:(qc + 1) * 8]
        (kq, lvu8, lvv8, recu8, recv8, cuv, _, _) = ctx.uv_choice(
            (su8, sv8), (e_u, e_v), ha_q, hl_q, 8, ctx.pred_uv8)
        loc_u[:, qr * 8:(qr + 1) * 8, qc * 8:(qc + 1) * 8] = recu8
        loc_v[:, qr * 8:(qr + 1) * 8, qc * 8:(qc + 1) * 8] = recv8
        lvu16[:, qr * 8:(qr + 1) * 8, qc * 8:(qc + 1) * 8] = lvu8
        lvv16[:, qr * 8:(qr + 1) * 8, qc * 8:(qc + 1) * 8] = lvv8
        rd_split = rd_split + _take(rdq, mq) + cuv.to(F32)
        m16l.append(ctx.cand_mode[mq])
        a16l.append(ctx.cand_delta[mq])
        u16l.append(ctx.uv_modes[kq])
        s16l.append(((lvq == 0).all(2).all(1) & (lvu8 == 0).all(2).all(1)
                     & (lvv8 == 0).all(2).all(1)).to(I32))

    # pixel-scale RD for split-vs-none (the 32x32 forward matrix packs
    # 16x pixel energy vs 64x at 16/8, so qerr32 is scaled by 4 here)
    rd_none = (4.0 * _take(qerr, mi) + lam_f * (3.0 * _take(nnzs, mi)) +
               ctx.dcosts[mi] +
               (_take(cdist, uvmi) + ctx.lam * 3 * _take(cnnz, uvmi)).to(F32)
               + lam_f * _HB16)
    do_sp = split_ok & (rd_split < rd_none)
    sp3 = do_sp[:, None, None]
    return (torch.where(sp3, loc_y, rec_blk_y),
            torch.where(sp3, loc_u, rec_blk_u),
            torch.where(sp3, loc_v, rec_blk_v),
            torch.where(sp3, lvy16, lvy), torch.where(sp3, lvu16, lvu),
            torch.where(sp3, lvv16, lvv), mode, uv_mode, angle, skip,
            do_sp.to(I32), torch.stack(m16l, 1), torch.stack(u16l, 1),
            torch.stack(a16l, 1), torch.stack(s16l, 1))


def encode_frame(y, u, v, qindex: int, nbr: int, nbc: int, bit_depth: int,
                 th: int = 0, tw: int = 0, tile_row_starts: tuple = (),
                 qround: float = 0.70, lf_y: int = 0, lf_uv: int = 0,
                 deblock: bool = False, cdef: bool = False,
                 cdef_damping: int = 4, lr: bool = False,
                 fh_clamp: int = None):
    """One keyframe.  y/u/v: SB-padded source planes (nbr x nbc blocks
    of 32).  Returns the reference's 19-tuple: (rec_y, rec_u, rec_v,
    lv_y, lv_u, lv_v, mode, uv_mode, skip, angle, split, m16, uv16,
    a16, s16 grids, strip_skip, cdefs, lr_choice, lr_taps).  The
    wavefront predicts from the unfiltered planes (the spec's
    placement); the returned reconstruction is then deblocked at levels
    lf_y / lf_uv with ``deblock``, CDEF-filtered at searched strengths
    (damping cdef_damping) with ``cdef``, and loop-restored per unit
    with ``lr``.

    fh_clamp: the bottom edge-read clamp in place of the coded height
    rounded up to 8 (the spec's MiRows * 4 bound): a keyframe stripe
    (``stripes.encode_key_striped``) passes its share of the frame's, so
    that the last stripe clamps at the true frame bottom."""
    dev = y.device
    H, Wd = nbr * 32, nbc * 32
    th = th or H
    tw = tw or Wd
    strip = (th % 32) == 16
    nbr_main = th // 32
    waves = plan_waves(nbr_main if strip else -(-th // 32), -(-tw // 32),
                       tuple(tile_row_starts))
    fh8 = ((th + 7) >> 3) << 3
    fw8 = ((tw + 7) >> 3) << 3
    fh_c = fh8 if fh_clamp is None else fh_clamp
    ctx = _KeyCtx(qindex, bit_depth, qround, dev)
    src_y, src_u, src_v = y.to(I32), u.to(I32), v.to(I32)
    # the strip-sharing SB row bans bottom-left readers (see jax_intra)
    strip_same_sb = strip and (nbr_main * 32) % 64 == 32

    def z(*shape):
        return torch.zeros(shape, dtype=I32, device=dev)

    rec_y, rec_u, rec_v = z(H, Wd), z(H // 2, Wd // 2), z(H // 2, Wd // 2)
    lv_y, lv_u, lv_v = z(H, Wd), z(H // 2, Wd // 2), z(H // 2, Wd // 2)
    grids = [z(nbr, nbc) for _ in range(5)] + \
        [z(nbr, nbc, 4) for _ in range(4)]
    planes = (rec_y, rec_u, rec_v, lv_y, lv_u, lv_v)
    # one upload of the plan; each wave's blocks are its valid prefix
    plan = {k: torch.as_tensor(a, dtype=torch.int64, device=dev)
            for k, a in waves.items()}
    for i, nb in enumerate(waves["valid"].sum(1)):
        r, c, ntr, nbl = (plan[k][i, :nb] for k in ("r", "c", "ntr", "nbl"))
        ha, hl = plan["have_a"][i, :nb] > 0, plan["have_l"][i, :nb] > 0
        # only blocks fully inside the coded mi grid may split
        split_ok = ((r + 1) * 32 <= fh_c) & ((c + 1) * 32 <= fw8)
        strip_row = None
        if strip_same_sb:
            strip_row = r == nbr_main - 1
            split_ok = split_ok & ~strip_row
        with tracer.span("key.wave", n=0):
            outs = _block_step(ctx, rec_y, rec_u, rec_v, src_y, src_u,
                               src_v, r, c, ha, hl, ntr, nbl, fh_c, fw8,
                               strip_row, split_ok)
            for plane, blk, nn in zip(planes, outs[:6], (32, 16, 16) * 2):
                h, w = plane.shape
                plane.view(h // nn, nn, w // nn, nn)[r, :, c, :] = blk
            # block outputs are (mode, uv, angle, skip, ...); the grids
            # are stored (mode, uv, skip, angle, ...)
            mode, uv, angle, skip = outs[6:10]
            for g, val in zip(grids, (mode, uv, skip, angle) + outs[10:]):
                g[r, c] = val
    rec_y, rec_u, rec_v, strip_skip, cdefs, lr_choice, lr_taps = \
        torch_inter.finish_frame((y, u, v), (rec_y, rec_u, rec_v),
                                 (lv_y, lv_u, lv_v), grids[2], grids[4],
                                 grids[8], ctx.q, bit_depth, th, tw,
                                 lf_y=lf_y, lf_uv=lf_uv, deblock=deblock,
                                 cdef=cdef, cdef_damping=cdef_damping, lr=lr)
    return (rec_y, rec_u, rec_v, lv_y, lv_u, lv_v, *grids, strip_skip,
            cdefs, lr_choice, lr_taps)

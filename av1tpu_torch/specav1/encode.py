# Copied from av1tpu/specav1/encode.py.
"""Spec-AV1 intra keyframe encoder (host reference implementation).

Produces temporal units the independent libaom decoder accepts, using
the proven writer/recon layers.  Structure:

  * fixed 32x32 block grid (TX_32X32 luma / TX_16X16 chroma — the
    DCT-only sizes, so no tx_type symbols are needed);
  * raster block order; prediction from the spec recon frame;
  * mode decision over DC/V/H/SMOOTH/PAETH + the diagonal modes by SSE
    of the spec predictors;
  * float forward DCT scaled to the integer inverse's gain, rounded to
    levels with a deadzone; recon via the spec-exact inverse so the
    encoder and any conformant decoder agree bit-for-bit.

The engines lift the hot parts (prediction/FDCT/quant as batched
tensor code) onto the device; this module is a test reference only: the
port's tests hold it to the JAX package's copy byte for byte, no entry
point of the port reaches it, and no engine falls back to it.
"""

from __future__ import annotations

import math

import numpy as np

from av1tpu_torch.specav1 import inter_recon, mvrefs, recon
from av1tpu_torch.specav1 import tile as T
from av1tpu_torch.specav1 import writer as W
from av1tpu_torch.specav1.cdfs import FrameContext

_MODES = (T.DC_PRED, T.V_PRED, T.H_PRED, T.SMOOTH_PRED, T.PAETH_PRED,
          T.D45_PRED, T.D135_PRED, T.D203_PRED, T.D67_PRED)


def _ortho_dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    m = np.cos((2 * j + 1) * k * math.pi / (2 * n)) * math.sqrt(2.0 / n)
    m[0] *= 1.0 / math.sqrt(2)
    return m


_DCT = {n: _ortho_dct_matrix(n) for n in (4, 8, 16, 32, 64)}

# inverse integer-transform gain: g(N) = sqrt(N/2) * sqrt(2) = sqrt(N)/sqrt(2)
_ROW_SHIFT = recon._ROW_SHIFT


def _fwd_scale(w: int, h: int) -> float:
    gw = math.sqrt(w) / math.sqrt(2)
    gh = math.sqrt(h) / math.sqrt(2)
    rs = _ROW_SHIFT[(w.bit_length() - 1, h.bit_length() - 1)]
    scale = (1 << (rs + 4)) / (gw * gh)
    if ((w.bit_length() + h.bit_length()) & 1) == 1:
        scale *= math.sqrt(2)
    return scale


def fdct2d(res: np.ndarray) -> np.ndarray:
    """Forward 2D DCT matched to the spec integer inverse's scaling."""
    h, w = res.shape
    out = _DCT[h] @ res.astype(np.float64) @ _DCT[w].T
    return out * _fwd_scale(w, h)


def quantize(coeffs: np.ndarray, qindex: int, bit_depth: int,
             deadzone: float = 0.62) -> np.ndarray:
    h, w = coeffs.shape
    dcq = int(recon.DC_Q[bit_depth][qindex])
    acq = int(recon.AC_Q[bit_depth][qindex])
    # tx scale is area-based (libaom av1_get_tx_scale); spec dequant is
    # (level * q) >> shift, so the effective step is q / 2^shift
    pels = w * h
    shift = int(pels > 256) + int(pels > 1024)
    dqv = np.full((h, w), acq / (1 << shift), np.float64)
    dqv[0, 0] = dcq / (1 << shift)
    mag = np.abs(coeffs) / dqv + (1.0 - deadzone)
    lv = np.floor(mag).astype(np.int64)
    lv = np.minimum(lv, 32767)
    return np.where(coeffs < 0, -lv, lv)


def _apply_cdef(rec: list, skips4: np.ndarray, cdef: tuple) -> list:
    """In-loop CDEF on the host recon (spec 7.15; deblock is off in the
    host encoders, so CDEF is the only loop filter)."""
    from av1tpu_torch.specav1 import cdef as CD
    damping, y_pri, y_sec, uv_pri, uv_sec = cdef
    fy, fu, fv = CD.cdef_frame((rec[0], rec[1], rec[2]), skips4,
                               y_pri=y_pri, y_sec=y_sec, uv_pri=uv_pri,
                               uv_sec=uv_sec, damping=damping)
    return [fy.astype(np.int32), fu.astype(np.int32),
            fv.astype(np.int32)]


def _lr_state(lr: dict | None, w: int, h: int):
    """LrEncState from the host encoders' `lr` spec dict:
    {"types": (y, u, v) RESTORE_*, "size": 64|128|256,
     "decisions": {(plane, ur, uc): None | ("wiener", vf3, hf3)
                   | ("sgr", set_idx, xqd0, xqd1)}}."""
    if lr is None:
        return None
    from av1tpu_torch.specav1 import lr as lr_mod
    return lr_mod.LrEncState.for_encode(
        lr["types"], lr.get("size", 256), w, h, lr["decisions"],
        uv_shift=lr.get("uv_shift", 0))


def _apply_lr(state, rec: list, pre_cdef: list) -> list:
    from av1tpu_torch.specav1 import lr as lr_mod
    fy, fu, fv = lr_mod.apply_lr_frame(state, rec, pre_cdef, 8,
                                       state.hdr.frame_height,
                                       state.hdr.frame_width)
    return [fy.astype(np.int32), fu.astype(np.int32),
            fv.astype(np.int32)]


class KeyFrameEncoder:
    """Encodes one spec-AV1 key frame from 8-bit I420 planes."""

    BLOCK = 32          # luma block/tx size
    BSIZE = T.BLOCK_32X32

    def __init__(self, qindex: int, cdef: tuple | None = None,
                 lr: dict | None = None):
        self.qindex = qindex
        # (damping, y_pri, y_sec, uv_pri, uv_sec) -> CDEF-enabled stream
        self.cdef = cdef
        # {"types", "size", "decisions"} -> LR-enabled stream (_lr_state)
        self.lr = lr

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
               render_size: tuple | None = None, order_hint: int = 0):
        """Returns (tu_bytes, recon_planes)."""
        self.order_hint = order_hint
        qidx = self.qindex
        h, w = y.shape
        assert h % 64 == 0 and w % 64 == 0, "pad to SB size first"
        self.render_size = render_size
        mi_cols, mi_rows = w // 4, h // 4
        fc = FrameContext(qidx)
        tw = W.TileWriter(fc, mi_cols, mi_rows, qidx)
        self.decoded = np.zeros((mi_rows, mi_cols), bool)
        self.mi_rows, self.mi_cols = mi_rows, mi_cols
        # per-block records (the native tile writer's input format;
        # also what the TPU encoder produces directly)
        gh, gw = mi_rows // 8, mi_cols // 8
        self.grid_y_mode = np.zeros((gh, gw), np.int32)
        self.grid_uv_mode = np.zeros((gh, gw), np.int32)
        self.grid_skip = np.zeros((gh, gw), np.int32)
        self.levels_y = np.zeros((h, w), np.int32)
        self.levels_u = np.zeros((h // 2, w // 2), np.int32)
        self.levels_v = np.zeros((h // 2, w // 2), np.int32)
        rec = [np.zeros((h, w), np.int32),
               np.zeros((h // 2, w // 2), np.int32),
               np.zeros((h // 2, w // 2), np.int32)]
        src = [y.astype(np.int32), u.astype(np.int32), v.astype(np.int32)]
        B = self.BLOCK
        lrstate = _lr_state(self.lr, w, h)
        for sb_r in range(0, mi_rows, 16):
            tw.start_sb_row(sb_r)
            for sb_c in range(0, mi_cols, 16):
                if lrstate is not None:
                    lrstate.write_lr(tw, sb_r, sb_c, 16, 16)
                tw.partition(sb_r, sb_c, T.BLOCK_64X64, T.PARTITION_SPLIT)
                # z-order children (spec SPLIT recursion order)
                for br, bc in ((sb_r, sb_c), (sb_r, sb_c + 8),
                               (sb_r + 8, sb_c), (sb_r + 8, sb_c + 8)):
                    if br < mi_rows and bc < mi_cols:
                        self._block(tw, src, rec, br, bc)
        tile = tw.finish()
        self.tile_bytes = tile
        self.skips4 = tw.skips.copy()   # coded skip flags (MI grid)
        seq_kw, hdr_kw = {}, {}
        pre_cdef = rec  # post-deblock (= unfiltered here): LR stripe src
        if self.cdef is not None:
            rec = _apply_cdef(rec, self.skips4, self.cdef)
            seq_kw["enable_cdef"] = True
            hdr_kw["cdef"] = self.cdef
        if lrstate is not None:
            rec = _apply_lr(lrstate, rec, pre_cdef)
            seq_kw["enable_restoration"] = True
            hdr_kw["lr_types"] = tuple(self.lr["types"])
            hdr_kw["lr_unit_size"] = self.lr.get("size", 256)
        tu = W.assemble_keyframe(w, h, qidx, tile,
                                 render_size=self.render_size,
                                 order_hint=self.order_hint,
                                 seq_kw=seq_kw, **hdr_kw)
        return tu, rec

    def _avail(self, r4, c4s, c4e=None, rows=False):
        """Spec haveAboveRight/BelowLeft: the cells decoded?"""
        if rows:
            return bool(self.decoded[c4s:c4e, r4].all())
        return bool(self.decoded[r4, c4s:c4e].all())

    def _edges(self, br, bc, w4, h4):
        """(n_top_right, n_bottom_left) in luma pixels for a block."""
        ntr = nbl = 0
        if br > 0:
            c4, c4e = bc + w4, min(bc + 2 * w4, self.mi_cols)
            if c4 < self.mi_cols and self._avail(br - 1, c4, c4e):
                ntr = w4 * 4
        if bc > 0:
            r4, r4e = br + h4, min(br + 2 * h4, self.mi_rows)
            if r4 < self.mi_rows and self._avail(bc - 1, r4, r4e,
                                                 rows=True):
                nbl = h4 * 4
        return ntr, nbl

    # -----------------------------------------------------------------
    def _block(self, tw, src, rec, br, bc):
        qidx = self.qindex
        B = self.BLOCK
        x0, y0 = bc * 4, br * 4
        sy = src[0][y0:y0 + B, x0:x0 + B]
        have_l = x0 > 0
        have_a = y0 > 0
        ntr, nbl = self._edges(br, bc, B // 4, B // 4)
        # luma mode decision on spec predictors
        best = None
        for mode in _MODES:
            if mode in (T.V_PRED, T.H_PRED, T.D45_PRED, T.D135_PRED,
                        T.D203_PRED, T.D67_PRED):
                if not (have_a or have_l):
                    continue
            pred = recon.predict_intra(rec[0], x0, y0, B, B, mode, 0,
                                       8, have_l, have_a, ntr, nbl)
            sse = int(((sy - pred) ** 2).sum())
            if best is None or sse < best[0]:
                best = (sse, mode, pred)
        _, mode, pred = best
        # chroma: DC always (v1)
        uv_mode = T.DC_PRED
        cx, cy = x0 // 2, y0 // 2
        CB = B // 2
        upreds = []
        for p in (1, 2):
            upreds.append(recon.predict_intra(
                rec[p], cx, cy, CB, CB, T.DC_PRED, 0, 8,
                cx > 0, cy > 0, ntr // 2 if ntr else 0,
                nbl // 2 if nbl else 0))
        # transform + quant
        levels_y = quantize(fdct2d(sy - pred), qidx, 8)
        lv_uv = []
        for i, p in enumerate((1, 2)):
            su = src[p][cy:cy + CB, cx:cx + CB]
            lv_uv.append(quantize(fdct2d(su - upreds[i]), qidx, 8))
        skip = int(not levels_y.any() and not lv_uv[0].any()
                   and not lv_uv[1].any())
        gr, gc = br // 8, bc // 8
        self.grid_y_mode[gr, gc] = mode
        self.grid_uv_mode[gr, gc] = uv_mode
        self.grid_skip[gr, gc] = skip
        self.levels_y[y0:y0 + B, x0:x0 + B] = levels_y
        self.levels_u[cy:cy + CB, cx:cx + CB] = lv_uv[0]
        self.levels_v[cy:cy + CB, cx:cx + CB] = lv_uv[1]
        # emit
        tw.partition(br, bc, self.BSIZE, T.PARTITION_NONE)
        tw.block_intra(br, bc, self.BSIZE, skip, mode, uv_mode)
        tx_y = T.TX_32X32
        tx_uv = T.TX_16X16
        if not skip:
            tw.coeffs(0, x0, y0, tx_y, levels_y, intra_dir=mode)
            tw.coeffs(1, cx, cy, tx_uv, lv_uv[0])
            tw.coeffs(2, cx, cy, tx_uv, lv_uv[1])
        tw.update_partition_ctx(br, bc, self.BSIZE)
        # spec recon
        dqy = recon.dequant_coeffs(levels_y, qidx, 0, 0, 8, B, B)
        rec[0][y0:y0 + B, x0:x0 + B] = recon.inv_txfm_add(
            dqy, recon.DCT_DCT, pred, 8)
        for i, p in enumerate((1, 2)):
            dq = recon.dequant_coeffs(lv_uv[i], qidx, 0, 0, 8, CB, CB)
            rec[p][cy:cy + CB, cx:cx + CB] = recon.inv_txfm_add(
                dq, recon.DCT_DCT, upreds[i], 8)
        self.decoded[br:br + B // 4, bc:bc + B // 4] = True


class InterFrameEncoder:
    """Spec-AV1 single-ref inter frame (host reference implementation).

    Same fixed 32x32 grid as the keyframe encoder.  Per block the mode
    decision tries: NEARESTMV (stack[0]), GLOBALMV (0,0), NEWMV from a
    small diamond integer search + quarter-pel refine, and a DC-intra
    fallback — all evaluated with the exact spec MC, picked by luma
    SSE.  Reconstruction is the spec path so any conformant decoder
    matches bit-for-bit.
    """

    BLOCK = 32
    BSIZE = T.BLOCK_32X32

    def __init__(self, qindex: int, ref_planes: tuple, order_hint: int,
                 search_range: int = 16, cdef: tuple | None = None,
                 lr: dict | None = None):
        self.qindex = qindex
        self.refs = ref_planes          # (y, u, v) FULL coded-size recon
        self.order_hint = order_hint
        self.search_range = search_range
        # (damping, y_pri, y_sec, uv_pri, uv_sec); the stream's keyframe
        # must have signaled enable_cdef
        self.cdef = cdef
        # the keyframe must have signaled enable_restoration
        self.lr = lr

    def encode(self, y, u, v, render_size=None):
        qidx = self.qindex
        h, w = y.shape
        assert h % 64 == 0 and w % 64 == 0
        assert self.refs[0].shape == (h, w), "ref/coded size mismatch"
        mi_cols, mi_rows = w // 4, h // 4
        fc = FrameContext(qidx)
        tw = W.TileWriter(fc, mi_cols, mi_rows, qidx)
        rec = [np.zeros((h, w), np.int32),
               np.zeros((h // 2, w // 2), np.int32),
               np.zeros((h // 2, w // 2), np.int32)]
        src = [y.astype(np.int32), u.astype(np.int32), v.astype(np.int32)]
        self.mi_rows, self.mi_cols = mi_rows, mi_cols
        self.decoded = np.zeros((mi_rows, mi_cols), bool)
        lrstate = _lr_state(self.lr, w, h)
        for sb_r in range(0, mi_rows, 16):
            tw.start_sb_row(sb_r)
            for sb_c in range(0, mi_cols, 16):
                if lrstate is not None:
                    lrstate.write_lr(tw, sb_r, sb_c, 16, 16)
                tw.partition(sb_r, sb_c, T.BLOCK_64X64, T.PARTITION_SPLIT)
                for br, bc in ((sb_r, sb_c), (sb_r, sb_c + 8),
                               (sb_r + 8, sb_c), (sb_r + 8, sb_c + 8)):
                    if br < mi_rows and bc < mi_cols:
                        self._block(tw, src, rec, br, bc)
        tile = tw.finish()
        self.tile_bytes = tile
        self.skips4 = tw.skips.copy()   # coded skip flags (MI grid)
        hdr_kw = {}
        pre_cdef = rec
        if self.cdef is not None:
            rec = _apply_cdef(rec, self.skips4, self.cdef)
            hdr_kw["cdef"] = self.cdef
        if lrstate is not None:
            rec = _apply_lr(lrstate, rec, pre_cdef)
            hdr_kw["lr_types"] = tuple(self.lr["types"])
            hdr_kw["lr_unit_size"] = self.lr.get("size", 256)
        tu = W.assemble_interframe(w, h, qidx, tile,
                                   order_hint=self.order_hint,
                                   render_size=render_size, **hdr_kw)
        return tu, rec

    # -----------------------------------------------------------------
    def _search_mv(self, sy, x0, y0, pred_mv):
        """Small diamond integer search + quarter-pel refine around the
        predictor; returns a quarter-pel (even 1/8-unit) MV."""
        ref_y = self.refs[0]
        rh, rw = ref_y.shape
        B = self.BLOCK

        def sad_int(mr, mc):
            ry, rx = y0 + mr, x0 + mc
            if not (0 <= ry <= rh - B and 0 <= rx <= rw - B):
                return 1 << 30
            blk = ref_y[ry:ry + B, rx:rx + B]
            return int(np.abs(sy - blk).sum())

        best = (pred_mv[0] >> 3, pred_mv[1] >> 3)
        best_cost = sad_int(*best)
        if sad_int(0, 0) < best_cost:
            best, best_cost = (0, 0), sad_int(0, 0)
        step = 8
        while step >= 1:
            improved = True
            while improved:
                improved = False
                for dr, dc in ((-step, 0), (step, 0), (0, -step),
                               (0, step)):
                    cand = (best[0] + dr, best[1] + dc)
                    if abs(cand[0]) > self.search_range or \
                            abs(cand[1]) > self.search_range:
                        continue
                    c = sad_int(*cand)
                    if c < best_cost:
                        best, best_cost = cand, c
                        improved = True
            step >>= 1
        # quarter-pel refine with exact MC (mv in 1/8 units, even)
        mv = (best[0] * 8, best[1] * 8)
        cost = None
        for _ in range(2):
            improved = False
            for dr, dc in ((-2, 0), (2, 0), (0, -2), (0, 2)):
                cand = (mv[0] + dr, mv[1] + dc)
                pred = inter_recon.predict_inter(ref_y, x0, y0, B, B,
                                                 cand, 0, 0, 8)
                c = int(((sy - pred) ** 2).sum())
                if cost is None:
                    base = inter_recon.predict_inter(ref_y, x0, y0, B, B,
                                                     mv, 0, 0, 8)
                    cost = int(((sy - base) ** 2).sum())
                if c < cost:
                    mv, cost = cand, c
                    improved = True
            if not improved:
                break
        return mv

    def _block(self, tw, src, rec, br, bc):
        qidx = self.qindex
        B = self.BLOCK
        x0, y0 = bc * 4, br * 4
        sy = src[0][y0:y0 + B, x0:x0 + B]
        stack = tw.mv_stack(br, bc, self.BSIZE, mvrefs.LAST_FRAME)
        ref_y = self.refs[0]

        cands = []  # (sse, order, y_mode, mv, pred)
        for order, (mode, mv) in enumerate((
                (T.NEARESTMV, stack.ref_mv(0)),
                (T.GLOBALMV, (0, 0)))):
            pred = inter_recon.predict_inter(ref_y, x0, y0, B, B, mv,
                                             0, 0, 8)
            cands.append((int(((sy - pred) ** 2).sum()), order, mode,
                          mv, pred))
        new_mv = self._search_mv(sy, x0, y0, stack.ref_mv(0))
        if new_mv != stack.ref_mv(0) and new_mv != (0, 0):
            pred = inter_recon.predict_inter(ref_y, x0, y0, B, B, new_mv,
                                             0, 0, 8)
            cands.append((int(((sy - pred) ** 2).sum()), 2, T.NEWMV,
                          new_mv, pred))
        cands.sort(key=lambda t: (t[0], t[1]))
        sse_inter, _, y_mode, mv, pred_y = cands[0]
        # DC-intra fallback (occlusions / scene content the ref lacks)
        have_l, have_a = x0 > 0, y0 > 0
        pred_dc = recon.predict_intra(rec[0], x0, y0, B, B, T.DC_PRED, 0,
                                      8, have_l, have_a, 0, 0)
        use_intra = int(((sy - pred_dc) ** 2).sum()) * 2 < sse_inter
        cx, cy = x0 // 2, y0 // 2
        CB = B // 2
        if use_intra:
            y_mode, uv_mode = T.DC_PRED, T.DC_PRED
            pred_y = pred_dc
            preds_uv = [recon.predict_intra(rec[p], cx, cy, CB, CB,
                                            T.DC_PRED, 0, 8, cx > 0,
                                            cy > 0, 0, 0)
                        for p in (1, 2)]
        else:
            preds_uv = [inter_recon.predict_inter(self.refs[p], cx, cy,
                                                  CB, CB, mv, 1, 1, 8)
                        for p in (1, 2)]
        levels_y = quantize(fdct2d(sy - pred_y), qidx, 8)
        lv_uv = [quantize(fdct2d(src[p][cy:cy + CB, cx:cx + CB] -
                                 preds_uv[i]), qidx, 8)
                 for i, p in enumerate((1, 2))]
        skip = int(not levels_y.any() and not lv_uv[0].any()
                   and not lv_uv[1].any())
        tw.partition(br, bc, self.BSIZE, T.PARTITION_NONE)
        if use_intra:
            tw.block_intra_interframe(br, bc, self.BSIZE, skip,
                                      T.DC_PRED, T.DC_PRED)
        else:
            tw.block_inter(br, bc, self.BSIZE, skip, mvrefs.LAST_FRAME,
                           y_mode, mv, stack)
        if not skip:
            inter_blk = not use_intra
            tw.coeffs(0, x0, y0, T.TX_32X32, levels_y, is_inter=inter_blk)
            tw.coeffs(1, cx, cy, T.TX_16X16, lv_uv[0], is_inter=inter_blk)
            tw.coeffs(2, cx, cy, T.TX_16X16, lv_uv[1], is_inter=inter_blk)
        tw.update_partition_ctx(br, bc, self.BSIZE)
        # spec recon
        dqy = recon.dequant_coeffs(levels_y, qidx, 0, 0, 8, B, B)
        rec[0][y0:y0 + B, x0:x0 + B] = recon.inv_txfm_add(
            dqy, recon.DCT_DCT, pred_y, 8)
        for i, p in enumerate((1, 2)):
            dq = recon.dequant_coeffs(lv_uv[i], qidx, 0, 0, 8, CB, CB)
            rec[p][cy:cy + CB, cx:cx + CB] = recon.inv_txfm_add(
                dq, recon.DCT_DCT, preds_uv[i], 8)
        self.decoded[br:br + B // 4, bc:bc + B // 4] = True


def encode_stream_host(frames, qindex: int, keyint: int = 64,
                       cdef: tuple | None = None,
                       lr: dict | None = None):
    """Host spec encoder: list of (y, u, v) -> list of temporal units.

    Keyframe every `keyint` frames; inter frames reference the previous
    reconstruction (slot 0).  Returns (tus, recons) with recons cropped
    to source dims.  cdef: optional (damping, y_pri, y_sec, uv_pri,
    uv_sec) applied in-loop to every frame.
    """
    tus, recons = [], []
    ref_full = None
    h0 = w0 = None
    for i, (y, u, v) in enumerate(frames):
        h, w = y.shape
        if h0 is None:
            h0, w0 = h, w
        assert (h, w) == (h0, w0)
        ph, pw = (h + 63) & ~63, (w + 63) & ~63
        if (ph, pw) != (h, w):
            yp = np.pad(y, ((0, ph - h), (0, pw - w)), mode="edge")
            up = np.pad(u, ((0, (ph - h) // 2), (0, (pw - w) // 2)),
                        mode="edge")
            vp = np.pad(v, ((0, (ph - h) // 2), (0, (pw - w) // 2)),
                        mode="edge")
        else:
            yp, up, vp = y, u, v
        rs = (w, h) if (ph, pw) != (h, w) else None
        if i % keyint == 0:
            enc = KeyFrameEncoder(qindex, cdef=cdef, lr=lr)
            tu, rec = enc.encode(yp, up, vp, render_size=rs,
                                 order_hint=i & 127)
        else:
            enc = InterFrameEncoder(qindex, ref_full, order_hint=i & 127,
                                    cdef=cdef, lr=lr)
            tu, rec = enc.encode(yp, up, vp, render_size=rs)
        ref_full = tuple(r.copy() for r in rec)
        tus.append(tu)
        recons.append((rec[0][:h, :w], rec[1][:h // 2, :w // 2],
                       rec[2][:h // 2, :w // 2]))
    return tus, recons


def encode_keyframe(y, u, v, qindex: int):
    """Pad to 64, encode (render_size signals the true display dims),
    return (tu, recon (y,u,v) cropped)."""
    h, w = y.shape
    ph = (h + 63) & ~63
    pw = (w + 63) & ~63
    if (ph, pw) != (h, w):
        y = np.pad(y, ((0, ph - h), (0, pw - w)), mode="edge")
        u = np.pad(u, ((0, (ph - h) // 2), (0, (pw - w) // 2)),
                   mode="edge")
        v = np.pad(v, ((0, (ph - h) // 2), (0, (pw - w) // 2)),
                   mode="edge")
    enc = KeyFrameEncoder(qindex)
    tu, rec = enc.encode(y, u, v, render_size=(w, h))
    return tu, (rec[0][:h, :w], rec[1][:h // 2, :w // 2],
                rec[2][:h // 2, :w // 2])

# Copied from av1tpu/specav1/native.py (without the CDF read-back, which the
# port does not use).
"""ctypes surface for the native spec-AV1 tile writer (spec_tile.cc).

The C++ writer walks a whole tile per call (the Python TileWriter costs
seconds per 1080p frame in symbol-call overhead; the native walk is
milliseconds).  Output bytes are identical to writer.TileWriter by
construction and by test (tests/test_spec_native.py), and streams are
decode-verified against system libaom.
"""

from __future__ import annotations

import ctypes

import numpy as np

from av1tpu_torch.encoder import entropy
from av1tpu_torch.specav1.cdfs import FrameContext

# table ids — must match spec_tile.cc TableId
(TBL_PARTITION, TBL_SKIP, TBL_KF_Y_MODE, TBL_ANGLE_DELTA, TBL_UV_MODE,
 TBL_TXB_SKIP, TBL_EOB_PT_16, TBL_EOB_PT_32, TBL_EOB_PT_64, TBL_EOB_PT_128,
 TBL_EOB_PT_256, TBL_EOB_PT_512, TBL_EOB_PT_1024, TBL_EOB_EXTRA,
 TBL_COEFF_BASE_EOB, TBL_COEFF_BASE, TBL_COEFF_BR, TBL_DC_SIGN,
 TBL_INTRA_EXT_TX, TBL_IF_Y_MODE, TBL_INTRA_INTER, TBL_SINGLE_REF,
 TBL_NEWMV, TBL_ZEROMV, TBL_REFMV, TBL_DRL, TBL_MV_JOINT, TBL_MV_SIGN,
 TBL_MV_CLASSES, TBL_MV_CLASS0, TBL_MV_BITS, TBL_MV_CLASS0_FP,
 TBL_MV_FP, TBL_INTER_EXT_TX, TBL_RESTORE_WIENER) = range(35)

_configured = False


def _lib() -> ctypes.CDLL:
    global _configured
    lib = entropy.load_library()
    if not _configured:
        lib.stw_create.restype = ctypes.c_void_p
        lib.stw_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.stw_destroy.argtypes = [ctypes.c_void_p]
        lib.stw_set_cdf.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int]
        lib.stw_set_cdf.restype = ctypes.c_int
        lib.stw_encode_intra32.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.stw_encode_intra32.restype = ctypes.c_int64
        lib.stw_encode_inter32.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.stw_encode_inter32.restype = ctypes.c_int64
        lib.stw_set_tile_row.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int]
        lib.stw_set_lr.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int]
        lib.stw_densify.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int]
        _configured = True
    return lib


def densify(maskbytes: np.ndarray, vals: np.ndarray,
            nbits: int) -> np.ndarray:
    """Scatter the sparse level transfer (spec_engine._pack_outputs
    wire format: MSB-first bitmask bytes + int16 values in position
    order) into a dense int32 flat array of length `nbits`."""
    lib = _lib()
    mb = np.ascontiguousarray(maskbytes, np.uint8)
    vv = np.ascontiguousarray(vals, np.int16)
    # np.empty + C-side memset: measured faster than np.zeros' lazily
    # zeroed pages (page-fault cost exceeds a streaming memset here)
    out = np.empty(nbits, np.int32)
    lib.stw_densify(mb.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_int64(nbits),
                    vv.ctypes.data_as(ctypes.c_void_p),
                    out.ctypes.data_as(ctypes.c_void_p),
                    ctypes.c_int(0))
    return out


def _fc_tables(fc: FrameContext) -> list[tuple[int, np.ndarray]]:
    return [
        (TBL_PARTITION, fc.partition),
        (TBL_SKIP, fc.skip),
        (TBL_KF_Y_MODE, fc.kf_y_mode),
        (TBL_ANGLE_DELTA, fc.angle_delta),
        (TBL_UV_MODE, fc.uv_mode),
        (TBL_TXB_SKIP, fc.txb_skip),
        (TBL_EOB_PT_16, fc.eob_pt[16]),
        (TBL_EOB_PT_32, fc.eob_pt[32]),
        (TBL_EOB_PT_64, fc.eob_pt[64]),
        (TBL_EOB_PT_128, fc.eob_pt[128]),
        (TBL_EOB_PT_256, fc.eob_pt[256]),
        (TBL_EOB_PT_512, fc.eob_pt[512]),
        (TBL_EOB_PT_1024, fc.eob_pt[1024]),
        (TBL_EOB_EXTRA, fc.eob_extra),
        (TBL_COEFF_BASE_EOB, fc.coeff_base_eob),
        (TBL_COEFF_BASE, fc.coeff_base),
        (TBL_COEFF_BR, fc.coeff_br),
        (TBL_DC_SIGN, fc.dc_sign),
        (TBL_INTRA_EXT_TX, fc.intra_ext_tx),
        (TBL_IF_Y_MODE, fc.if_y_mode),
        (TBL_INTRA_INTER, fc.intra_inter),
        (TBL_SINGLE_REF, fc.single_ref),
        (TBL_NEWMV, fc.newmv),
        (TBL_ZEROMV, fc.zeromv),
        (TBL_REFMV, fc.refmv),
        (TBL_DRL, fc.drl),
        (TBL_MV_JOINT, fc.mv_joint),
        (TBL_MV_SIGN, np.stack([fc.mv[0].sign, fc.mv[1].sign])),
        (TBL_MV_CLASSES, np.stack([fc.mv[0].classes, fc.mv[1].classes])),
        (TBL_MV_CLASS0, np.stack([fc.mv[0].class0, fc.mv[1].class0])),
        (TBL_MV_BITS, np.stack([fc.mv[0].bits, fc.mv[1].bits])),
        (TBL_MV_CLASS0_FP, np.stack([fc.mv[0].class0_fp,
                                     fc.mv[1].class0_fp])),
        (TBL_MV_FP, np.stack([fc.mv[0].fp, fc.mv[1].fp])),
        (TBL_INTER_EXT_TX, fc.inter_ext_tx),
        (TBL_RESTORE_WIENER, fc.restore_wiener),
    ]


_fc_buf_cache: dict = {}


def _fc_buffers(qindex: int) -> list:
    """(table_id, contiguous uint16 array) list for a qindex, cached —
    FrameContext construction + dtype conversion cost ~8ms and was
    being paid once PER TILE (4 tiles x 8 frames per chunk)."""
    got = _fc_buf_cache.get(qindex)
    if got is None:
        fc = FrameContext(qindex)
        got = [(tid, np.ascontiguousarray(arr.astype(np.uint16)))
               for tid, arr in _fc_tables(fc)]
        if len(_fc_buf_cache) > 64:
            _fc_buf_cache.clear()
        _fc_buf_cache[qindex] = got
    return got


_tile_pool = None


def _pool():
    global _tile_pool
    if _tile_pool is None:
        from concurrent.futures import ThreadPoolExecutor
        _tile_pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="av1tpu-tile")
    return _tile_pool


def encode_tile_rows(kind: str, qindex: int, mi_cols: int, mi_rows: int,
                     spans: list, grid_args: tuple, ylv, ulv, vlv,
                     strip_skip=None, lr=None, angles=None,
                     split3=None, key_split5=None) -> list:
    """Encode one spec tile per (mi_row0, mi_row1) span, in parallel
    (the C++ walker releases the GIL).  grid_args: the per-frame grid
    arrays of encode_intra32_tile / encode_inter32_tile; each tile gets
    the matching row slice.  strip_skip goes to the LAST tile (the 16px
    bottom strip lives there).  angles: per-block luma angle_delta grid
    (key frames).  split3: (splits, mvs16, skips16) grids for the
    inter 32->16 SPLIT path.  Returns the list of per-tile bytes."""
    enc = encode_intra32_tile if kind == "key" else encode_inter32_tile

    def one(span):
        mi0, mi1 = span
        g0, g1 = mi0 // 8, (mi1 + 7) // 8
        sliced = tuple(g[g0:g1] for g in grid_args)
        ss = strip_skip if mi1 == spans[-1][1] else None
        kw = {}
        if angles is not None and kind == "key":
            kw["angles"] = angles[g0:g1]
        if key_split5 is not None and kind == "key":
            kw["split5"] = tuple(g[g0:g1] for g in key_split5)
        if split3 is not None and kind != "key":
            kw["splits"] = split3[0][g0:g1]
            kw["mvs16"] = split3[1][g0:g1]
            kw["skips16"] = split3[2][g0:g1]
        return enc(qindex, mi_cols, mi1 - mi0, *sliced,
                   ylv[mi0 * 4:], ulv[mi0 * 2:], vlv[mi0 * 2:],
                   tile_row0=mi0, frame_mi_rows=mi_rows, strip_skip=ss,
                   lr=lr, **kw)

    if len(spans) == 1:
        return [one(spans[0])]
    return list(_pool().map(one, spans))


def encode_inter32_tile(qindex: int, mi_cols: int, mi_rows: int,
                        modes: np.ndarray, mvs: np.ndarray,
                        skips: np.ndarray, ylv: np.ndarray,
                        ulv: np.ndarray, vlv: np.ndarray,
                        tile_row0: int = 0,
                        frame_mi_rows: int = 0,
                        strip_skip: np.ndarray | None = None,
                        lr=None, splits: np.ndarray | None = None,
                        mvs16: np.ndarray | None = None,
                        skips16: np.ndarray | None = None) -> bytes:
    """Emit one spec tile for a 32x32-grid single-ref inter frame with
    optional per-block 32->16 SPLIT.

    modes: (gh, gw) int32, 0 = intra-DC fallback, 1 = inter.
    mvs: (gh, gw, 2) int32 final MVs in (row, col) 1/8-pel (even).
    splits: (gh, gw) int32, 1 = code the block as four 16x16 inter
    quadrants using mvs16 (gh, gw, 4, 2) and skips16 (gh, gw, 4)
    (z-order quadrants; luma TX_16X16 + chroma TX_8X8 levels are read
    from the same level planes at quadrant offsets).
    The inter Y mode is derived from the MV stack in native code.
    tile_row0/frame_mi_rows place this tile as one row of a taller
    frame (MV clamping is frame-relative)."""
    lib = _lib()
    gh, gw = (mi_rows + 7) // 8, (mi_cols + 7) // 8

    def as32(a, shape):
        a = np.ascontiguousarray(np.asarray(a, np.int32))
        assert a.shape == shape, (a.shape, shape)
        return a

    modes = as32(modes, (gh, gw))
    mvs = as32(mvs, (gh, gw, 2))
    skips = as32(skips, (gh, gw))
    if splits is not None:
        splits = as32(splits, (gh, gw))
        mvs16 = as32(mvs16, (gh, gw, 4, 2))
        skips16 = as32(skips16, (gh, gw, 4))
    # level planes are SB-padded; mi dims are the true coded dims
    ylv = np.ascontiguousarray(np.asarray(ylv, np.int32))
    ulv = np.ascontiguousarray(np.asarray(ulv, np.int32))
    vlv = np.ascontiguousarray(np.asarray(vlv, np.int32))
    assert ylv.shape[0] >= mi_rows * 4 and ylv.shape[1] >= mi_cols * 4
    ystride, cstride = ylv.shape[1], ulv.shape[1]

    w = lib.stw_create(mi_cols, mi_rows, qindex)
    try:
        if tile_row0 or frame_mi_rows:
            lib.stw_set_tile_row(w, tile_row0,
                                 frame_mi_rows or mi_rows)
        if lr is not None:
            # (unit_size, choice (urows, ucols) int32, taps (N, 6):
            # per-row (v0, v1, v2, h0, h1, h2))
            usz, choice, taps = lr
            choice = np.ascontiguousarray(np.asarray(choice, np.int32))
            taps = np.ascontiguousarray(np.asarray(taps, np.int32))
            lib.stw_set_lr(w, usz, choice.shape[0], choice.shape[1],
                           choice.ctypes.data_as(ctypes.c_void_p),
                           taps.ctypes.data_as(ctypes.c_void_p),
                           taps.shape[0])
        for tid, a in _fc_buffers(qindex):
            ok = lib.stw_set_cdf(w, tid, a.ctypes.data_as(ctypes.c_void_p),
                                 a.size)
            if not ok:
                raise RuntimeError(f"cdf table {tid} shape mismatch "
                                   f"({a.size} u16)")
        # worst-case tile bytes ~ 2 B/px at near-lossless; np.empty
        # avoids create_string_buffer's zeroing of multi-MB caps (the
        # level planes passed in may span the whole frame)
        cap = mi_rows * 4 * mi_cols * 4 * 2 + (1 << 16)
        out = np.empty(cap, np.uint8)
        sstrip = None
        if strip_skip is not None:
            sstrip = np.ascontiguousarray(np.asarray(strip_skip, np.int32))
            assert sstrip.size >= (mi_cols + 3) // 4
        sz = lib.stw_encode_inter32(
            w, modes.ctypes.data_as(ctypes.c_void_p),
            mvs.ctypes.data_as(ctypes.c_void_p),
            skips.ctypes.data_as(ctypes.c_void_p),
            sstrip.ctypes.data_as(ctypes.c_void_p)
            if sstrip is not None else None,
            ylv.ctypes.data_as(ctypes.c_void_p), ystride,
            ulv.ctypes.data_as(ctypes.c_void_p),
            vlv.ctypes.data_as(ctypes.c_void_p), cstride,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            splits.ctypes.data_as(ctypes.c_void_p)
            if splits is not None else None,
            mvs16.ctypes.data_as(ctypes.c_void_p)
            if splits is not None else None,
            skips16.ctypes.data_as(ctypes.c_void_p)
            if splits is not None else None)
        if sz < 0:
            raise RuntimeError("tile buffer too small")
        return out[:sz].tobytes()
    finally:
        lib.stw_destroy(w)


def encode_intra32_tile(qindex: int, mi_cols: int, mi_rows: int,
                        y_modes: np.ndarray, uv_modes: np.ndarray,
                        skips: np.ndarray, ylv: np.ndarray,
                        ulv: np.ndarray, vlv: np.ndarray,
                        tile_row0: int = 0,
                        frame_mi_rows: int = 0,
                        strip_skip: np.ndarray | None = None,
                        lr=None, angles: np.ndarray | None = None,
                        split5=None) -> bytes:
    """Emit one spec tile for a fixed-32x32-grid intra frame.

    y_modes/uv_modes/skips: (gh, gw) int32 with gw = mi_cols//8.
    angles: (gh, gw) int32 luma angle_delta per block (None = all 0;
    only read for directional y modes).  ylv: (mi_rows*4, mi_cols*4)
    int32 quantized levels; ulv/vlv at half resolution.  mi dims must
    be multiples of 16 (SB-padded).
    split5: (splits (gh, gw), y16, uv16, ang16, sk16 each (gh, gw, 4))
    for RD-chosen 32->16 keyframe PARTITION_SPLIT blocks (z-order
    quadrants; TX_16X16 luma / TX_8X8 chroma levels are read from the
    same level planes at quadrant offsets).
    """
    lib = _lib()
    gh, gw = (mi_rows + 7) // 8, (mi_cols + 7) // 8

    def as32(a, shape):
        a = np.ascontiguousarray(np.asarray(a, np.int32))
        assert a.shape == shape, (a.shape, shape)
        return a

    y_modes = as32(y_modes, (gh, gw))
    uv_modes = as32(uv_modes, (gh, gw))
    skips = as32(skips, (gh, gw))
    angles = as32(angles, (gh, gw)) if angles is not None else None
    if split5 is not None:
        splits = as32(split5[0], (gh, gw))
        y16 = as32(split5[1], (gh, gw, 4))
        uv16 = as32(split5[2], (gh, gw, 4))
        ang16 = as32(split5[3], (gh, gw, 4))
        sk16 = as32(split5[4], (gh, gw, 4))
    else:
        splits = y16 = uv16 = ang16 = sk16 = None
    ylv = np.ascontiguousarray(np.asarray(ylv, np.int32))
    ulv = np.ascontiguousarray(np.asarray(ulv, np.int32))
    vlv = np.ascontiguousarray(np.asarray(vlv, np.int32))
    assert ylv.shape[0] >= mi_rows * 4 and ylv.shape[1] >= mi_cols * 4
    ystride, cstride = ylv.shape[1], ulv.shape[1]

    w = lib.stw_create(mi_cols, mi_rows, qindex)
    try:
        if tile_row0 or frame_mi_rows:
            lib.stw_set_tile_row(w, tile_row0,
                                 frame_mi_rows or mi_rows)
        if lr is not None:
            # (unit_size, choice (urows, ucols) int32, taps (N, 6):
            # per-row (v0, v1, v2, h0, h1, h2))
            usz, choice, taps = lr
            choice = np.ascontiguousarray(np.asarray(choice, np.int32))
            taps = np.ascontiguousarray(np.asarray(taps, np.int32))
            lib.stw_set_lr(w, usz, choice.shape[0], choice.shape[1],
                           choice.ctypes.data_as(ctypes.c_void_p),
                           taps.ctypes.data_as(ctypes.c_void_p),
                           taps.shape[0])
        for tid, a in _fc_buffers(qindex):
            ok = lib.stw_set_cdf(w, tid, a.ctypes.data_as(ctypes.c_void_p),
                                 a.size)
            if not ok:
                raise RuntimeError(f"cdf table {tid} shape mismatch "
                                   f"({a.size} u16)")
        # worst-case tile bytes ~ 2 B/px at near-lossless; np.empty
        # avoids create_string_buffer's zeroing of multi-MB caps (the
        # level planes passed in may span the whole frame)
        cap = mi_rows * 4 * mi_cols * 4 * 2 + (1 << 16)
        out = np.empty(cap, np.uint8)
        sstrip = None
        if strip_skip is not None:
            sstrip = np.ascontiguousarray(np.asarray(strip_skip, np.int32))
            assert sstrip.size >= (mi_cols + 3) // 4
        def _p(a):
            return (a.ctypes.data_as(ctypes.c_void_p)
                    if a is not None else None)

        sz = lib.stw_encode_intra32(
            w, y_modes.ctypes.data_as(ctypes.c_void_p),
            uv_modes.ctypes.data_as(ctypes.c_void_p),
            _p(angles),
            skips.ctypes.data_as(ctypes.c_void_p),
            _p(sstrip),
            ylv.ctypes.data_as(ctypes.c_void_p), ystride,
            ulv.ctypes.data_as(ctypes.c_void_p),
            vlv.ctypes.data_as(ctypes.c_void_p), cstride,
            out.ctypes.data_as(ctypes.c_void_p), cap,
            _p(splits), _p(y16), _p(uv16), _p(ang16), _p(sk16))
        if sz < 0:
            raise RuntimeError("tile buffer too small")
        return out[:sz].tobytes()
    finally:
        lib.stw_destroy(w)

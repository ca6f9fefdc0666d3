"""Inter (P) frame encoding of the private av1tpu profile: a port of
``av1tpu/legacy/core/inter_frame.py``.

Inter prediction references the previous reconstructed frame, so every
block is independent: search → MC → transform → quantize → reconstruct
as one batched pass.  In the v2 frame (the engine's) the full-pel
search is ``motion.search_v3`` (the K1 gather and the K2 refine, twice
per reference searched), then the quarter-pel ``subpel_refine`` and the
normative subpel MC.  The v1 frame (``encode_inter_frame``, which only
the stripe functions of ``legacy/mesh_sharding.py`` call) is full-pel:
``motion.tss_search``, K1 gathers for the luma prediction and for U and
V in one launch, DCT only, no in-loop filter, 8-bit.  The decoder
reuses the same normative ops (MC, dequant, exact inverse transform,
clip), so encoder recon == decoder recon bit-exactly.

A chunk of K P-frames is a loop over K on the device (the reference's
``lax.scan``): frame k's recon is frame k+1's reference, and GOLDEN is
the same for the whole chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.encoder import quant
from av1tpu_torch.encoder.kernels import mc, motion
from av1tpu_torch.encoder.kernels import transforms as tx
from av1tpu_torch.encoder.kernels.motion import _to_blocks, first_argmin
from av1tpu_torch.encoder.kernels.restoration import edge_pad
from av1tpu_torch.legacy.core.intra_frame import filter_planes

CHROMA_PAD = motion.CHROMA_PAD


def _from_blocks(blocks: torch.Tensor, hp: int, wp: int,
                 n: int) -> torch.Tensor:
    rows, cols = hp // n, wp // n
    return (blocks.reshape(rows, cols, n, n).permute(0, 2, 1, 3)
            .reshape(hp, wp))


def _code_plane(src_blocks, pred, dc_step, ac_step, maxval: int = 255):
    """residual → levels + recon blocks (encoder side)."""
    res = src_blocks.to(torch.int32) - pred
    lv = quant.quantize_block(tx.fwd_txfm(res), dc_step, ac_step)
    dq = quant.dequantize_block(lv, dc_step, ac_step)
    rec = (pred + tx.inv_txfm(dq)).clamp(0, maxval)
    return lv, rec


def _recon_plane(levels, pred, dc_step, ac_step, maxval: int = 255):
    """levels → recon blocks (normative, shared with the decoder)."""
    dq = quant.dequantize_block(levels, dc_step, ac_step)
    return (pred + tx.inv_txfm(dq)).clamp(0, maxval)


# signaled transform alphabet for inter luma (syntax symbol order)
TX_ALPHABET = (tx.DCT_DCT, tx.ADST_ADST, tx.IDTX)


def _select(stack: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """stack (T, B, ...) indexed per block by sel (B,)."""
    idx = sel.to(torch.int64).reshape(1, -1, *([1] * (stack.dim() - 2)))
    return torch.gather(stack, 0, idx.expand(1, *stack.shape[1:]))[0]


def tx_lambda(ac_step: int) -> float:
    """Rate-distortion multiplier for transform selection, in float32 as
    the reference computes it from its traced step:
    float32(ac * ac) / 24 (a float32 value held as a Python float)."""
    return float(np.float32(ac_step * ac_step) / np.float32(24.0))


def _code_plane_txsel(src_blocks, pred, dc_step, ac_step, maxval, lam):
    """Luma residual coding with per-block transform selection: every
    transform of TX_ALPHABET, and the one of least SSD + lam·(Σ|level| +
    2·nnz).  The reference sums the SSD in float32; the port sums it
    exactly and converts once.  Returns (levels, recon blocks, tx_syms
    uint8)."""
    src_i = src_blocks.to(torch.int32)
    res = src_i - pred
    lvs, recs, costs = [], [], []
    for t in TX_ALPHABET:
        lv = quant.quantize_block(tx.fwd_txfm(res, t), dc_step, ac_step)
        dq = quant.dequantize_block(lv, dc_step, ac_step)
        rec = (pred + tx.inv_txfm(dq, t)).clamp(0, maxval)
        d = (rec - src_i).to(torch.int64)
        ssd = (d * d).sum((1, 2)).to(torch.float32)
        alv = lv.abs()
        rate = (alv.sum((1, 2)) + 2 * (alv != 0).sum((1, 2))).to(
            torch.float32)
        lvs.append(lv)
        recs.append(rec)
        costs.append(ssd + lam * rate)
    sel = first_argmin(torch.stack(costs), 0)
    return (_select(torch.stack(lvs), sel), _select(torch.stack(recs), sel),
            sel.to(torch.uint8))


def _recon_plane_txsel(levels, pred, dc_step, ac_step, maxval, tx_syms):
    """Decoder-side luma recon with signaled per-block transforms
    (every inverse evaluated, then selected)."""
    dq = quant.dequantize_block(levels, dc_step, ac_step)
    recs = [(pred + tx.inv_txfm(dq, t)).clamp(0, maxval)
            for t in TX_ALPHABET]
    return _select(torch.stack(recs), tx_syms)


def _pad_refs(y, u, v):
    return (edge_pad(y.to(torch.int32), motion.PAD, motion.PAD),
            edge_pad(u.to(torch.int32), CHROMA_PAD, CHROMA_PAD),
            edge_pad(v.to(torch.int32), CHROMA_PAD, CHROMA_PAD))


_positions: dict = {}


def block_positions(hp: int, wp: int, n: int, device) -> torch.Tensor:
    key = (hp, wp, n, str(device))
    t = _positions.get(key)
    if t is None:
        t = _positions[key] = torch.as_tensor(
            motion.block_positions(hp, wp, n), dtype=torch.int32,
            device=device)
    return t


def _predict_v1(ref_y_pad, ref_u_pad, ref_v_pad, mvs, hp: int, wp: int,
                n: int):
    """Full-pel v1 predictions: luma blocks at pos + mv, U and V blocks at
    pos + chroma_mv(mv) in one K1 launch."""
    dev = mvs.device
    cn = n // 2
    pred_y = motion.gather_blocks(ref_y_pad, block_positions(hp, wp, n, dev),
                                  mvs, n)
    pred_uv = motion.gather_blocks((ref_u_pad, ref_v_pad),
                                   block_positions(hp // 2, wp // 2, cn, dev),
                                   motion.chroma_mv(mvs), cn, pad=CHROMA_PAD)
    return pred_y, pred_uv[0], pred_uv[1]


def encode_inter_frame(y, u, v, ref_y_pad, ref_u_pad, ref_v_pad, dc_step,
                       ac_step, block: int):
    """Encode one v1 P-frame (8-bit).  Planes padded to block multiples;
    the references edge-padded by motion.PAD (luma) and CHROMA_PAD.
    Returns (mvs (B, 2) int32, levels y / u / v (B, n*n) raster order,
    recon y / u / v) as the reference does."""
    n = block
    cn = n // 2
    hp, wp = y.shape
    hc, wc = u.shape
    mvs = motion.tss_search(y, ref_y_pad, n)
    pred_y, pred_u, pred_v = _predict_v1(ref_y_pad, ref_u_pad, ref_v_pad,
                                         mvs, hp, wp, n)
    lv_y, rec_y = _code_plane(_to_blocks(y, n), pred_y, dc_step, ac_step)
    lv_u, rec_u = _code_plane(_to_blocks(u, cn), pred_u, dc_step, ac_step)
    lv_v, rec_v = _code_plane(_to_blocks(v, cn), pred_v, dc_step, ac_step)
    return (mvs, lv_y.reshape(lv_y.shape[0], -1),
            lv_u.reshape(lv_u.shape[0], -1), lv_v.reshape(lv_v.shape[0], -1),
            _from_blocks(rec_y, hp, wp, n), _from_blocks(rec_u, hc, wc, cn),
            _from_blocks(rec_v, hc, wc, cn))


def decode_inter_frame(mvs, lv_y, lv_u, lv_v, ref_y_pad, ref_u_pad,
                       ref_v_pad, dc_step, ac_step, hp: int, wp: int,
                       block: int):
    """Decoder-side v1 P-frame reconstruction (bit-identical to
    ``encode_inter_frame``'s recon)."""
    n = block
    cn = n // 2
    mvs = mvs.to(torch.int32)
    pred_y, pred_u, pred_v = _predict_v1(ref_y_pad, ref_u_pad, ref_v_pad,
                                         mvs, hp, wp, n)
    rec_y = _recon_plane(lv_y.reshape(-1, n, n), pred_y, dc_step, ac_step)
    rec_u = _recon_plane(lv_u.reshape(-1, cn, cn), pred_u, dc_step, ac_step)
    rec_v = _recon_plane(lv_v.reshape(-1, cn, cn), pred_v, dc_step, ac_step)
    return (_from_blocks(rec_y, hp, wp, n),
            _from_blocks(rec_u, hp // 2, wp // 2, cn),
            _from_blocks(rec_v, hp // 2, wp // 2, cn))


def _inter_core_v2(y_u8, u_u8, v_u8, ref, dc_step, ac_step, qindex,
                   block: int, bit_depth: int = 8, tile_rows: int = 1,
                   use_subpel: bool = True, use_aux_filters: bool = True,
                   ref2=None, use_two_refs: bool = False,
                   use_tx_select: bool = True):
    """One P-frame: source planes and the (y, u, v) reference (and GOLDEN,
    ``ref2``, with ``use_two_refs``), unpadded.  With two references both
    are searched in full and a block takes GOLDEN only when its
    prediction SAD beats LAST's by more than 1/16.  Returns the
    reference's output tuple: (mvs int16, levels int16 ×3, skips, recon
    int32 ×3, lr_mode int, cdef_on, sparse mask, values, count, refs
    uint8, tx_syms uint8)."""
    n = block
    cn = n // 2
    maxval = (1 << bit_depth) - 1
    dev = y_u8.device
    y = y_u8.to(torch.int32)
    u = u_u8.to(torch.int32)
    v = v_u8.to(torch.int32)
    hp, wp = y.shape
    hc, wc = u.shape
    ref_y_pad, ref_u_pad, ref_v_pad = _pad_refs(*ref)
    pos_y = block_positions(hp, wp, n, dev)
    y_blocks = _to_blocks(y, n)

    def search_one(ref_pad):
        mv_full = motion.search_v3(y, ref_pad, n)
        if use_subpel:
            mv = motion.subpel_refine(y_blocks, ref_pad, pos_y, mv_full, n,
                                      maxval=maxval)
        else:
            mv = mv_full * 4
        return mv, mc.predict_subpel_luma(ref_pad, pos_y, mv, n, motion.PAD,
                                          maxval)

    mvs, pred_y = search_one(ref_y_pad)
    if use_two_refs:
        ref2_y_pad, ref2_u_pad, ref2_v_pad = _pad_refs(*ref2)
        mv2, pred2_y = search_one(ref2_y_pad)
        sad1 = (y_blocks - pred_y).abs().sum((1, 2), dtype=torch.int32)
        sad2 = (y_blocks - pred2_y).abs().sum((1, 2), dtype=torch.int32)
        refs = sad2 + sad2 // 16 < sad1
        mvs = torch.where(refs[:, None], mv2, mvs)
        pred_y = torch.where(refs[:, None, None], pred2_y, pred_y)
    else:
        refs = torch.zeros((y_blocks.shape[0],), dtype=torch.bool,
                           device=dev)
    if use_tx_select:
        lv_y, rec_y, tx_syms = _code_plane_txsel(
            y_blocks, pred_y, dc_step, ac_step, maxval, tx_lambda(ac_step))
    else:  # DCT only: the per-block tx symbol is still coded (as 0)
        lv_y, rec_y = _code_plane(y_blocks, pred_y, dc_step, ac_step,
                                  maxval)
        tx_syms = torch.zeros((y_blocks.shape[0],), dtype=torch.uint8,
                              device=dev)

    pos_c = block_positions(hc, wc, cn, dev)
    pred_u = mc.predict_subpel_chroma(ref_u_pad, pos_c, mvs, cn, CHROMA_PAD,
                                      maxval)
    pred_v = mc.predict_subpel_chroma(ref_v_pad, pos_c, mvs, cn, CHROMA_PAD,
                                      maxval)
    if use_two_refs:
        sel = refs[:, None, None]
        pred_u = torch.where(sel, mc.predict_subpel_chroma(
            ref2_u_pad, pos_c, mvs, cn, CHROMA_PAD, maxval), pred_u)
        pred_v = torch.where(sel, mc.predict_subpel_chroma(
            ref2_v_pad, pos_c, mvs, cn, CHROMA_PAD, maxval), pred_v)
    lv_u, rec_u = _code_plane(_to_blocks(u, cn), pred_u, dc_step, ac_step,
                              maxval)
    lv_v, rec_v = _code_plane(_to_blocks(v, cn), pred_v, dc_step, ac_step,
                              maxval)

    lv_y = lv_y.reshape(lv_y.shape[0], -1)
    lv_u = lv_u.reshape(lv_u.shape[0], -1)
    lv_v = lv_v.reshape(lv_v.shape[0], -1)
    skips = ((lv_y == 0).all(1) & (lv_u == 0).all(1) & (lv_v == 0).all(1))
    out_y, out_u, out_v, cdef_on, lr_mode = filter_planes(
        _from_blocks(rec_y, hp, wp, n), _from_blocks(rec_u, hc, wc, cn),
        _from_blocks(rec_v, hc, wc, cn), y, n, qindex, bit_depth, tile_rows,
        aux=use_aux_filters)
    lv_y16, lv_u16, lv_v16 = (lv.to(torch.int16) for lv in (lv_y, lv_u,
                                                            lv_v))
    sp_mask, sp_vals, sp_count = sparse_pack_levels(lv_y16, lv_u16, lv_v16)
    return (mvs.to(torch.int16), lv_y16, lv_u16, lv_v16, skips,
            out_y, out_u, out_v, lr_mode, cdef_on, sp_mask, sp_vals,
            sp_count, refs.to(torch.uint8), tx_syms)


def encode_inter_frame_v2(y_u8, u_u8, v_u8, ref_y, ref_u, ref_v, dc_step,
                          ac_step, qindex, block: int, bit_depth: int = 8,
                          tile_rows: int = 1, use_subpel: bool = True,
                          use_aux_filters: bool = True, ref2_y=None,
                          ref2_u=None, ref2_v=None,
                          use_two_refs: bool = False,
                          use_tx_select: bool = True):
    """One P-frame (see ``_inter_core_v2``): source and reference planes
    unpadded; the references are padded on the device."""
    return _inter_core_v2(y_u8, u_u8, v_u8, (ref_y, ref_u, ref_v), dc_step,
                          ac_step, qindex, block, bit_depth, tile_rows,
                          use_subpel, use_aux_filters,
                          (ref2_y, ref2_u, ref2_v), use_two_refs,
                          use_tx_select)


def encode_inter_chunk_v2(ys_u8, us_u8, vs_u8, ref_y, ref_u, ref_v,
                          dc_steps, ac_steps, qindexes, block: int,
                          bit_depth: int = 8, tile_rows: int = 1,
                          use_subpel: bool = True,
                          use_aux_filters: bool = True, ref2_y=None,
                          ref2_u=None, ref2_v=None,
                          use_two_refs: bool = False,
                          use_tx_select: bool = True):
    """K consecutive P-frames in one call: ys/us/vs are (K, H, W) stacks,
    the steps and qindexes K host ints each.  Frame k's recon is frame
    k+1's reference; GOLDEN is the same for every frame (chunks never
    span a keyframe).  Returns the K frames' output tuples."""
    ref = (ref_y, ref_u, ref_v)
    outs = []
    for k in range(ys_u8.shape[0]):
        out = _inter_core_v2(ys_u8[k], us_u8[k], vs_u8[k], ref, dc_steps[k],
                             ac_steps[k], qindexes[k], block, bit_depth,
                             tile_rows, use_subpel, use_aux_filters,
                             (ref2_y, ref2_u, ref2_v), use_two_refs,
                             use_tx_select)
        ref = out[5:8]
        outs.append(out)
    return outs


def decode_inter_frame_v2(mvs, lv_y, lv_u, lv_v, ref, dc_step, ac_step,
                          qindex, lr_mode, cdef_on, hp: int, wp: int,
                          block: int, bit_depth: int = 8,
                          tile_rows: int = 1, refs=None, ref2=None,
                          tx_syms=None):
    """Decoder-side subpel P-frame reconstruction (matches the encoder
    bit-exactly).  ``ref`` / ``ref2`` are the unpadded (y, u, v) LAST and
    GOLDEN planes; mvs in q4 luma units; refs (B,) selects GOLDEN where
    set (two_ref frames, ``ref2`` given); tx_syms (B,) indexes
    TX_ALPHABET for the luma transform (None → all DCT)."""
    n = block
    cn = n // 2
    maxval = (1 << bit_depth) - 1
    hc, wc = hp // 2, wp // 2
    dev = lv_y.device
    if tx_syms is None:
        tx_syms = torch.zeros((lv_y.shape[0],), dtype=torch.uint8,
                              device=dev)
    mvs = mvs.to(torch.int32)
    ref_y_pad, ref_u_pad, ref_v_pad = _pad_refs(*ref)
    pos_y = block_positions(hp, wp, n, dev)
    pred_y = mc.predict_subpel_luma(ref_y_pad, pos_y, mvs, n, motion.PAD,
                                    maxval)
    pos_c = block_positions(hc, wc, cn, dev)
    pred_u = mc.predict_subpel_chroma(ref_u_pad, pos_c, mvs, cn, CHROMA_PAD,
                                      maxval)
    pred_v = mc.predict_subpel_chroma(ref_v_pad, pos_c, mvs, cn, CHROMA_PAD,
                                      maxval)
    if ref2 is not None:
        sel = refs.to(torch.bool)[:, None, None]
        g_y, g_u, g_v = _pad_refs(*ref2)
        pred_y = torch.where(sel, mc.predict_subpel_luma(
            g_y, pos_y, mvs, n, motion.PAD, maxval), pred_y)
        pred_u = torch.where(sel, mc.predict_subpel_chroma(
            g_u, pos_c, mvs, cn, CHROMA_PAD, maxval), pred_u)
        pred_v = torch.where(sel, mc.predict_subpel_chroma(
            g_v, pos_c, mvs, cn, CHROMA_PAD, maxval), pred_v)
    rec_y = _recon_plane_txsel(lv_y.reshape(-1, n, n), pred_y, dc_step,
                               ac_step, maxval, tx_syms)
    rec_u = _recon_plane(lv_u.reshape(-1, cn, cn), pred_u, dc_step, ac_step,
                         maxval)
    rec_v = _recon_plane(lv_v.reshape(-1, cn, cn), pred_v, dc_step, ac_step,
                         maxval)
    out_y, out_u, out_v, _, _ = filter_planes(
        _from_blocks(rec_y, hp, wp, n), _from_blocks(rec_u, hc, wc, cn),
        _from_blocks(rec_v, hc, wc, cn), None, n, qindex, bit_depth,
        tile_rows, cdef_on=cdef_on, lr_mode=lr_mode)
    return out_y, out_u, out_v


SPARSE_CAP_FRACTION = 16  # capacity = total_coeffs / 16


def sparse_pack_levels(lv_y, lv_u, lv_v):
    """Compact the (mostly zero) level arrays for the host transfer: (mask
    packed to bits uint8, the first cap nonzero values int16, count
    int32) over the concatenated y|u|v coefficients.  The caller reads
    the full arrays when count > cap."""
    flat = torch.cat([lv_y.reshape(-1), lv_u.reshape(-1), lv_v.reshape(-1)])
    n = flat.shape[0]
    cap = n // SPARSE_CAP_FRACTION
    mask = flat != 0
    idx = torch.cumsum(mask.to(torch.int32), 0) - 1
    vals = torch.zeros((cap + 1,), dtype=torch.int16, device=flat.device)
    vals.scatter_(0, torch.where(mask & (idx < cap), idx, cap).to(
        torch.int64), flat)
    count = mask.sum(dtype=torch.int32)
    bits = torch.cat([mask, mask.new_zeros((-n) % 8)]).reshape(-1, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=flat.device)
    packed = (bits.to(torch.int32) * weights).sum(1).to(torch.uint8)
    return packed, vals[:cap], count


def sparse_unpack_levels(mask_packed, vals, count, shapes):
    """Host-side inverse of sparse_pack_levels (numpy; copied from
    av1tpu/legacy/core/inter_frame.py).

    shapes: [(B, ny), (B, nc), (B, nc)] for y/u/v.  Returns the three
    int16 arrays, or None if count exceeded the capacity."""
    total = sum(b * n for b, n in shapes)
    cap = total // SPARSE_CAP_FRACTION
    count = int(count)
    if count > cap:
        return None
    mask = np.unpackbits(np.asarray(mask_packed))[:total].astype(bool)
    flat = np.zeros(total, np.int16)
    flat[mask] = np.asarray(vals)[:count]
    out = []
    off = 0
    for b, n in shapes:
        out.append(flat[off:off + b * n].reshape(b, n))
        off += b * n
    return out

"""Intra (key) frame encoding of the private av1tpu profile: a port of
``av1tpu/legacy/core/intra_frame.py``.

* **Mode decision** — fully parallel over all blocks, using *source*
  neighbors as a stand-in for reconstructed ones; every mode is
  evaluated and argmin'd.
* **Commit pass** — intra predicts from reconstructed neighbors, so the
  blocks commit in a wavefront over the knight's-move diagonals
  (d = 2r + c): each step runs one whole diagonal as a batch of
  gather → predict → transform → quantize → reconstruct → scatter.  The
  reference's ``lax.fori_loop`` is a Python loop over the diagonals here
  (126 at 1080p with 32-px blocks), and each step indexes only the
  diagonal's live blocks (the reference pads every diagonal to the
  longest and drops the dead lanes' writes).  Tile stripes and the U and
  V planes (which share their block grid) run as one batch of planes
  through the same loop.  Used by the encoder and the decoder
  (bit-identical recon by construction).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1tpu_torch.encoder import quant
from av1tpu_torch.encoder.kernels import (cdef, deblock, intra,
                                          restoration)
from av1tpu_torch.encoder.kernels import transforms as tx
from av1tpu_torch.encoder.kernels.motion import first_argmin

def _border(bit_depth: int) -> int:
    """Normative out-of-frame neighbor value (128 at 8 bits)."""
    return 1 << (bit_depth - 1)


def _maxval(bit_depth: int) -> int:
    return (1 << bit_depth) - 1


@functools.lru_cache(maxsize=None)
def wavefront_plan(rows: int, cols: int) -> tuple[np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Knight's-move wavefront schedule: (diag_r, diag_c, mask), each (D, L).
    Copied from av1tpu/legacy/core/intra_frame.py.

    Diagonal index d = 2r + c, so every dependency of the directional
    predictors precedes its consumer: left (r, c-1) → d-1, above
    (r-1, c) → d-2, above-left (r-1, c-1) → d-3 and, for D45/D67,
    above-right (r-1, c+1) → d-1.
    """
    n_diag = 2 * (rows - 1) + (cols - 1) + 1
    per_d = [[] for _ in range(n_diag)]
    for r in range(rows):
        for c in range(cols):
            per_d[2 * r + c].append((r, c))
    maxlen = max(len(p) for p in per_d)
    diag_r = np.zeros((n_diag, maxlen), np.int32)
    diag_c = np.zeros((n_diag, maxlen), np.int32)
    mask = np.zeros((n_diag, maxlen), bool)
    for d, blocks in enumerate(per_d):
        for k, (r, c) in enumerate(blocks):
            diag_r[d, k] = r
            diag_c[d, k] = c
            mask[d, k] = True
    return diag_r, diag_c, mask


_plans: dict = {}


def _device_plan(rows: int, cols: int, device) -> list:
    """Per diagonal, the (r, c) of its live blocks as int64 tensors."""
    key = (rows, cols, str(device))
    plan = _plans.get(key)
    if plan is None:
        diag_r, diag_c, mask = wavefront_plan(rows, cols)
        plan = [(torch.as_tensor(r[m], dtype=torch.int64, device=device),
                 torch.as_tensor(c[m], dtype=torch.int64, device=device))
                for r, c, m in zip(diag_r, diag_c, mask)]
        _plans[key] = plan
    return plan


def _to_blocks(planes: torch.Tensor, n: int) -> torch.Tensor:
    """(P, H, W) → (P, B, n, n) in raster block order."""
    P, hp, wp = planes.shape
    return (planes.reshape(P, hp // n, n, wp // n, n).permute(0, 1, 3, 2, 4)
            .reshape(P, -1, n, n))


def _mode_sse(src: torch.Tensor, block: int,
              bit_depth: int = 8) -> torch.Tensor:
    """Per-block per-mode prediction SSE using source neighbors, for
    planes (P, Hp, Wp): (P, B, n_modes) int64 (exact; the reference's
    int32 sums stay below 2^31)."""
    P, hp, wp = src.shape
    n = block
    rows, cols = hp // n, wp // n
    s = src.to(torch.int32)
    ps = torch.full((P, hp + 1, wp + 1 + n), _border(bit_depth),
                    dtype=torch.int32, device=src.device)
    ps[:, 1:, 1:wp + 1] = s
    # extended above row (2n wide) feeds D45/D67; the out-of-frame tail
    # replicates the last in-frame sample
    a_rows = ps[:, 0:hp:n, 1:]                          # (P, rows, wp + n)
    above_ext = torch.stack([a_rows[:, :, c * n:c * n + 2 * n]
                             for c in range(cols)], dim=2)
    above_ext = above_ext.reshape(P, -1, 2 * n)         # (P, B, 2n)
    off = torch.arange(2 * n, device=src.device)
    col0 = (torch.arange(cols, device=src.device).repeat(rows) * n)[:, None]
    above_ext = torch.where(col0 + off[None] < wp, above_ext,
                            above_ext[..., n - 1:n])
    left = (ps[:, 1:, 0:wp:n].reshape(P, rows, n, cols)
            .permute(0, 1, 3, 2).reshape(P, -1, n))
    corner = ps[:, 0:hp:n, 0:wp:n].reshape(P, -1)
    preds = intra.predict_all_modes_v2(above_ext.reshape(-1, 2 * n),
                                       left.reshape(-1, n),
                                       corner.reshape(-1), n)
    blocks = _to_blocks(s, n).reshape(-1, 1, n, n)
    d = (preds - blocks).to(torch.int64)
    return (d * d).sum((2, 3)).reshape(P, rows * cols, -1)


def decide_modes(src: torch.Tensor, block: int,
                 bit_depth: int = 8) -> torch.Tensor:
    """Dense all-mode SSE argmin with source neighbors, planes (P, Hp, Wp)
    → (P, B) int32 (the first minimum, as jnp.argmin)."""
    return first_argmin(_mode_sse(src, block, bit_depth), 2).to(torch.int32)


def decide_uv_modes(u: torch.Tensor, v: torch.Tensor, block: int,
                    bit_depth: int = 8) -> torch.Tensor:
    """Chroma mode decision: U and V share one mode per block, chosen by
    the summed SSE over both planes."""
    sse = _mode_sse(u, block, bit_depth) + _mode_sse(v, block, bit_depth)
    return first_argmin(sse, 2).to(torch.int32)


def _commit(src, levels_in, modes, dc_step, ac_step, block, *, decode,
            bit_depth: int = 8, tiles: int = 1):
    """The wavefront commit over planes (P, Hp, Wp) that share one block
    grid: tile stripes, or U and V.

    Encode (decode=False): src holds the source planes; levels are
    computed (fwd transform + quantize) and returned.  Decode
    (decode=True): levels_in (P, B, n*n) are given and src only gives the
    shape and device.  modes (P, B).  Returns (levels (P, B, n*n) int32,
    recon (P, Hp, Wp) int32).
    """
    P, hp, wp = src.shape
    n = block
    rows, cols = hp // n, wp // n
    dev = src.device
    plan = _device_plan(rows, cols, dev)
    ref_lanes = tiles * wavefront_plan(rows, cols)[0].shape[1]
    modes = modes.to(torch.int64)
    rn = torch.arange(n, device=dev)
    ext_off = torch.arange(2 * n, device=dev)
    pidx = torch.arange(P, device=dev)[:, None]
    # +n columns on the right so the above-right gather for the last
    # block column stays in bounds
    recon = torch.full((P, hp + 1, wp + 1 + n), _border(bit_depth),
                       dtype=torch.int32, device=dev)
    if decode:
        levels = levels_in.to(torch.int32)
    else:
        levels = torch.zeros((P, rows * cols, n * n), dtype=torch.int32,
                             device=dev)
        src_i = src.to(torch.int32)
    maxval = _maxval(bit_depth)
    for r, c in plan:
        L = r.shape[0]
        bi = r * cols + c                                   # (L,)
        # neighbors: the above row (2n, tail replicated past the frame
        # edge), the left column and the corner, for every plane
        ar = r * n
        ac = 1 + c * n
        above = recon[pidx[:, :, None], ar[None, :, None],
                      (ac[:, None] + ext_off)[None]]        # (P, L, 2n)
        above = torch.where((c * n)[:, None] + ext_off < wp, above,
                            above[..., n - 1:n])
        leftv = recon[pidx[:, :, None], (1 + ar[:, None] + rn)[None],
                      (c * n)[None, :, None]]               # (P, L, n)
        corner = recon[pidx, ar[None], (c * n)[None]]       # (P, L)
        mode = modes[:, bi]                                 # (P, L)
        pred = intra.predict_mode_v2(
            above.reshape(-1, 2 * n), leftv.reshape(-1, n),
            corner.reshape(-1), mode.reshape(-1), n)        # (P*L, n, n)
        ri = (1 + ar[:, None] + rn)[None, :, :, None]       # (1, L, n, 1)
        ci = (ac[:, None] + rn)[None, :, None, :]           # (1, L, 1, n)
        if decode:
            lv = levels[:, bi].reshape(-1, n, n)
        else:
            srcb = src_i[pidx[:, :, None, None], ri - 1, ci - 1]
            res = srcb.reshape(-1, n, n) - pred
            lv = quant.quantize_block(tx.fwd_txfm(res, ref_blocks=ref_lanes),
                                      dc_step, ac_step)
            levels[:, bi] = lv.reshape(P, L, n * n)
        dq = quant.dequantize_block(lv, dc_step, ac_step)
        rec = (pred + tx.inv_txfm(dq)).clamp(0, maxval)
        recon[pidx[:, :, None, None], ri, ci] = rec.reshape(P, L, n, n)
    return levels, recon[:, 1:, 1:wp + 1]


def _stripes(plane: torch.Tensor, tiles: int) -> torch.Tensor:
    """(H, W) → (tiles, H / tiles, W): intra prediction never crosses
    tile rows, so each stripe runs its own wavefront."""
    h, w = plane.shape
    return plane.reshape(tiles, h // tiles, w)


def encode_plane(src, modes, dc_step, ac_step, block: int,
                 bit_depth: int = 8):
    """Encode one padded plane: returns (levels (B, n*n), recon (Hp, Wp))."""
    lv, rec = _commit(src[None], None, modes[None], dc_step, ac_step, block,
                      decode=False, bit_depth=bit_depth)
    return lv[0], rec[0]


def decode_plane(levels, modes, dc_step, ac_step, hp: int, wp: int,
                 block: int, bit_depth: int = 8, tile_rows: int = 1):
    """Decoder-side commit: levels (B, n*n) and modes (B,) tensors in,
    recon (Hp, Wp) out (bit-identical to encode)."""
    T = tile_rows
    n = block
    bpt = (hp // n // T) * (wp // n)
    shape = torch.empty((T, hp // T, wp), device=levels.device)
    _lv, rec = _commit(shape, levels.reshape(T, bpt, n * n),
                       modes.reshape(T, bpt), dc_step, ac_step, block,
                       decode=True, bit_depth=bit_depth)
    return rec.reshape(hp, wp)


def filter_planes(rec_y, rec_u, rec_v, src_y, n: int, qindex: int,
                  bit_depth: int, tiles: int, aux: bool = True,
                  cdef_on=None, lr_mode=None):
    """The in-loop chain per tile stripe: deblock, CDEF (kept where the
    frame gate finds it moves luma toward the source), then the frame's
    restoration preset.  Encoder: src_y given, the gate and the mode are
    decided here.  Decoder: cdef_on / lr_mode come from the header.
    Returns (y, u, v, cdef_on bool tensor, lr_mode int)."""
    maxval = _maxval(bit_depth)
    cn = n // 2
    dev = rec_y.device
    ys = deblock.deblock_plane(_stripes(rec_y, tiles), n, qindex, bit_depth)
    uvs = deblock.deblock_plane(
        torch.stack([_stripes(rec_u, tiles), _stripes(rec_v, tiles)]), cn,
        qindex, bit_depth)
    if not aux:
        return (ys.reshape(rec_y.shape), uvs[0].reshape(rec_u.shape),
                uvs[1].reshape(rec_v.shape),
                torch.tensor(False, device=dev), 0)
    cdef_y = cdef.cdef_plane(ys, qindex, bit_depth)
    cdef_uv = cdef.cdef_plane(uvs, qindex, bit_depth, is_chroma=True)
    if cdef_on is None:
        cdef_on = cdef.cdef_gate(src_y, ys.reshape(rec_y.shape),
                                 cdef_y.reshape(rec_y.shape))
    else:
        cdef_on = torch.as_tensor(bool(cdef_on), device=dev)
    ys = cdef.select(cdef_on, cdef_y, ys)
    uvs = cdef.select(cdef_on, cdef_uv, uvs)
    if lr_mode is None:
        lr_mode = restoration.choose_mode(src_y, ys.reshape(rec_y.shape),
                                          maxval, tiles)
    ys = restoration.apply_restoration(ys, lr_mode, maxval)
    uvs = restoration.apply_restoration(uvs, lr_mode, maxval)
    return (ys.reshape(rec_y.shape), uvs[0].reshape(rec_u.shape),
            uvs[1].reshape(rec_v.shape), cdef_on, lr_mode)


def encode_key_frame_v2(y_u8, u_u8, v_u8, dc_step, ac_step, qindex,
                        block: int, bit_depth: int = 8,
                        tile_rows: int = 1):
    """Keyframe encode: mode decision and the three plane commits, then
    the loop filters.  Source planes (uint8/int16 tensors) in; (y_modes
    uint8, levels int16 ×3, skips bool, recon int32 ×3, lr_mode int,
    cdef_on bool tensor, sparse mask, values, count, uv_modes uint8) out,
    as the reference's tuple — recons stay on the device as the GOP
    reference."""
    from av1tpu_torch.legacy.core.inter_frame import sparse_pack_levels
    n = block
    cn = n // 2
    T = tile_rows
    y = _stripes(y_u8.to(torch.int32), T)
    uv = torch.cat([_stripes(u_u8.to(torch.int32), T),
                    _stripes(v_u8.to(torch.int32), T)])      # (2T, ...)
    modes = decide_modes(y, n, bit_depth)                   # (T, Bt)
    uv_modes = decide_uv_modes(uv[:T], uv[T:], cn, bit_depth)
    lv_y, rec_y = _commit(y, None, modes, dc_step, ac_step, n,
                          decode=False, bit_depth=bit_depth, tiles=T)
    lv_uv, rec_uv = _commit(uv, None, uv_modes.repeat(2, 1), dc_step,
                            ac_step, cn, decode=False, bit_depth=bit_depth,
                            tiles=T)
    lv_y = lv_y.reshape(-1, n * n)
    lv_u = lv_uv[:T].reshape(-1, cn * cn)
    lv_v = lv_uv[T:].reshape(-1, cn * cn)
    skips = ((lv_y == 0).all(1) & (lv_u == 0).all(1) & (lv_v == 0).all(1))
    hp, wp = y_u8.shape
    src_y = y.reshape(hp, wp)
    rec_y, rec_u, rec_v, cdef_on, lr_mode = filter_planes(
        rec_y.reshape(hp, wp), rec_uv[:T].reshape(hp // 2, wp // 2),
        rec_uv[T:].reshape(hp // 2, wp // 2), src_y, n, qindex, bit_depth, T)
    lv_y16, lv_u16, lv_v16 = (lv.to(torch.int16) for lv in (lv_y, lv_u,
                                                            lv_v))
    sp_mask, sp_vals, sp_count = sparse_pack_levels(lv_y16, lv_u16, lv_v16)
    return (modes.reshape(-1).to(torch.uint8), lv_y16, lv_u16, lv_v16,
            skips, rec_y, rec_u, rec_v, lr_mode, cdef_on, sp_mask, sp_vals,
            sp_count, uv_modes.reshape(-1).to(torch.uint8))

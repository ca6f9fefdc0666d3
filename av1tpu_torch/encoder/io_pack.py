# Copied from av1tpu/encoder/io_pack.py (pack_chunk verbatim; unpack_chunk
# rewritten as torch tensor code).
"""Lossless source-upload packing: mod-2^bd delta + 4-bit nibbles.

A chunk of K source frames travels to the device as one upload.  This
module packs it losslessly into about half the bytes:

  * per plane class, per chunk, the host picks the better of two
    predictors: TEMPORAL (the previous source frame; the previous
    chunk's last frame stays on the device as the base, never
    re-uploaded) or SPATIAL-H (left neighbour, column 0 temporal), and
    stores the mod-2^bd prediction residual;
  * residuals in [-8, 7] (mod 2^bd) pack two to a byte; the rare
    outliers ride a fixed-cap side list of (flat position, true value)
    scattered over the nibble expansion on the device;
  * the device inverts exactly (cumsum mod 2^bd along the frame or the
    row axis) in ``unpack_chunk``.

Everything is bit-lossless (mod-2^bd arithmetic is exact in int32), so
the bitstream is byte-identical to the raw upload's.  When a chunk's
outliers exceed the cap (deep grain), ``pack_chunk`` returns None and
the engine uploads that chunk raw.
"""

from __future__ import annotations

import numpy as np
import torch

# outlier budget per frame (synthetic 1080p luma needs ~2.7k, chroma
# ~0; real grain can exceed this, and then the chunk goes raw)
CAP_PER_FRAME = 8192

MODE_TEMPORAL = 0
MODE_SPATIAL_H = 1


def _fit4(d: np.ndarray, mod: int = 256) -> np.ndarray:
    """Residual representable in one nibble: d in [0,7] u [mod-8,mod)
    (mod-2^bd encoding of [-8, 7])."""
    return (d < 8) | (d >= mod - 8)


def pack_chunk(planes: list, base: tuple, cap: int | None = None,
               bit_depth: int = 8):
    """Pack k frames of padded uint8/uint16 (y, u, v) planes against
    ``base`` (the previous source frame's padded planes).

    Returns (nib, exc_pos, exc_val, modes) or None when the outliers
    exceed ``cap`` (the caller falls back to the raw upload).  Layout of
    the flat residual buffer matches the raw chunk upload: all Y
    frames, then all U, then all V.  bit_depth > 8 packs mod-2^bd
    residuals with uint16 exception values (same nibble window).
    """
    k = len(planes)
    mod = 1 << bit_depth
    if cap is None:
        cap = CAP_PER_FRAME * k
    parts = []
    modes = np.empty(3, np.int32)
    mask = mod - 1
    for pi in range(3):
        cur = np.stack([p[pi] for p in planes])            # (k, H, W)
        prev = np.concatenate([base[pi][None], cur[:-1]])
        dt = (cur.astype(np.int32) - prev.astype(np.int32)) & mask
        # pick the predictor on a 1-in-8 row sample (a full compare
        # costs a second pass for a decision that is stable per
        # content class)
        s = cur[:, ::8, :].astype(np.int32)
        et = int((~_fit4((s - prev[:, ::8, :].astype(np.int32))
                         & mask, mod)).sum())
        sh = np.empty_like(s)
        sh[:, :, 0] = (s[:, :, 0]
                       - prev[:, ::8, 0].astype(np.int32)) & mask
        sh[:, :, 1:] = (s[:, :, 1:] - s[:, :, :-1]) & mask
        es = int((~_fit4(sh, mod)).sum())
        if es < et:
            d = dt  # reuse storage shape; fill spatial in-place below
            d[:, :, 1:] = (cur[:, :, 1:].astype(np.int32)
                           - cur[:, :, :-1].astype(np.int32)) & mask
            modes[pi] = MODE_SPATIAL_H
        else:
            d = dt
            modes[pi] = MODE_TEMPORAL
        parts.append(d.reshape(-1))
    flat = np.concatenate(parts).astype(np.int32)
    fit = _fit4(flat, mod)
    pos = np.nonzero(~fit)[0]
    if pos.size > cap:
        return None
    nibs = np.where(fit, flat, 0).astype(np.uint8) & 15
    nib = (nibs[0::2] | (nibs[1::2] << 4)).astype(np.uint8)
    exc_pos = np.full(cap, flat.size, np.int32)   # OOB pad -> 'drop'
    exc_pos[:pos.size] = pos
    exc_dt = np.uint8 if bit_depth == 8 else np.uint16
    exc_val = np.zeros(cap, exc_dt)
    exc_val[:pos.size] = flat[pos].astype(exc_dt)
    return nib, exc_pos, exc_val, modes


def unpack_chunk(nib, exc_pos, exc_val, modes, base_y, base_u, base_v,
                 k: int, ph: int, pw: int, bit_depth: int = 8):
    """Exact inverse of ``pack_chunk`` on the device of ``nib``.

    nib: uint8 tensor; exc_pos: int32 tensor; exc_val: the exception
    values as uint8 (8-bit) or int16 holding the uint16 bits (10-bit);
    modes: the three plane modes on the host (a numpy array); base_*:
    the base planes on the device (any integer dtype).  Returns (ys, us,
    vs): (k, ph, pw) and 2 x (k, ph/2, pw/2) stacks, uint8 at 8 bits and
    int16 above, the dtypes of the raw upload."""
    I32 = torch.int32
    mask = (1 << bit_depth) - 1
    out_dt = torch.uint8 if bit_depth == 8 else torch.int16
    hc, wc = ph // 2, pw // 2
    ny = k * ph * pw
    nc = k * hc * wc
    n = ny + 2 * nc
    nib = nib.to(I32)
    d = torch.stack([nib & 15, nib >> 4], dim=-1).reshape(-1)[:n]
    d = torch.where(d < 8, d, d + (mask - 15))   # nibble -> mod-2^bd
    # the pad entries of exc_pos point one past the end: scatter into a
    # spare slot and drop it
    d = torch.cat([d, d.new_zeros(1)])
    d.scatter_(0, exc_pos.to(torch.int64).clamp(max=n),
               exc_val.to(I32) & 0xFFFF)
    d = d[:n]

    def plane(dk, base, mode):
        base32 = base.to(I32)
        if int(mode) == MODE_SPATIAL_H:
            # column 0 is temporal by construction
            col0 = (base32[:, 0][None]
                    + torch.cumsum(dk[:, :, 0], 0, dtype=I32)) & mask
            ds = dk.clone()
            ds[:, :, 0] = col0
            r = torch.cumsum(ds, 2, dtype=I32) & mask
        else:
            r = (base32[None] + torch.cumsum(dk, 0, dtype=I32)) & mask
        return r.to(out_dt)

    ys = plane(d[:ny].reshape(k, ph, pw), base_y, modes[0])
    us = plane(d[ny:ny + nc].reshape(k, hc, wc), base_u, modes[1])
    vs = plane(d[ny + nc:].reshape(k, hc, wc), base_v, modes[2])
    return ys, us, vs

"""Motion search: the ``search_v3``, ``gather_blocks`` and
``subpel_refine`` subset of ``av1tpu/encoder/kernels/motion.py``.

Stage 1: a +-8 shift scan on 8x-downsampled planes (+-64 full-pel) sets
per-block seeds.  Stage 2: K2 refines +-8 around the zero seed and
around the coarse seed.  Final: best-of with the exact zero-MV SSD and
a rate-aware zero bias.  ``subpel_refine`` (the private av1tpu
profile's quarter-pel step) refines the full-pel winner on a 7x7 grid.

The reference's coarse scan is a ``lax.scan`` over the 289 frame shifts;
here it is one batched tensor op over all shifts, keeping the strict
'<' first-minimum order over the dy-major displacement list.  Its sums
are integer (exact: a 4x4 block of 8x-downsampled 10-bit pixels stays
below 2^24, where the reference's float32 sums are exact too).
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.encoder.kernels import gather, refine

PAD = 64          # normative luma reference padding (pixels)
MAX_MV = PAD - 16  # keep gathers inside the padded extent
COARSE_SCALE = 4
COARSE_RADIUS_V2 = 16


def block_positions(hp: int, wp: int, n: int) -> np.ndarray:
    """Top-left (row, col) of each block in raster order, (B, 2).
    Copied from av1tpu/encoder/kernels/motion.py (a JAX module)."""
    rows, cols = hp // n, wp // n
    r, c = np.mgrid[0:rows, 0:cols]
    return np.stack([r.reshape(-1) * n, c.reshape(-1) * n], axis=1).astype(
        np.int32)


def gather_blocks(ref_pad: torch.Tensor, pos: torch.Tensor,
                  mvs: torch.Tensor, n: int, pad: int = PAD) -> torch.Tensor:
    """(B, n, n) int32 blocks at pos + mv (full-pel) of the reference
    padded by ``pad``; positions clamp into the padded extent.  Port of
    motion.gather_blocks."""
    hp2, wp2 = ref_pad.shape
    r = (pos[:, 0] + pad + mvs[:, 0]).clamp(0, hp2 - n)
    c = (pos[:, 1] + pad + mvs[:, 1]).clamp(0, wp2 - n)
    return gather.gather_windows(ref_pad, r, c, n)


def _to_blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    hp, wp = plane.shape
    rows, cols = hp // n, wp // n
    return (plane.reshape(rows, n, cols, n).permute(0, 2, 1, 3)
            .reshape(rows * cols, n, n))


def _downsample(plane: torch.Tensor, s: int) -> torch.Tensor:
    h, w = plane.shape
    return (plane.to(torch.int32).reshape(h // s, s, w // s, s)
            .sum((1, 3), dtype=torch.int32) // (s * s))


def _block_sum(x: torch.Tensor, n: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return x.reshape(*x.shape[:-2], h // n, n, w // n, n).sum(
        (-3, -1), dtype=x.dtype)


def first_argmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the FIRST minimum along ``dim`` (jnp.argmin's rule),
    independent of the backend's argmin tie handling."""
    mn = x.amin(dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    return torch.where(x == mn, idx, n).amin(dim)


def _shift_scan_search(src: torch.Tensor, ref_pad: torch.Tensor, n: int,
                       radius: int, pad: int):
    """Exhaustive +-radius over frame shifts, all shifts at once.
    Returns (best_mv (rows, cols, 2) int32, best_cost (rows, cols))."""
    hp, wp = src.shape
    S = 2 * radius + 1
    ref = ref_pad[pad - radius:pad + radius + hp,
                  pad - radius:pad + radius + wp].to(torch.int32)
    wins = ref.unfold(0, hp, 1).unfold(1, wp, 1)        # (S, S, hp, wp)
    diff = src.to(torch.int32)[None, None] - wins
    cost = _block_sum(diff * diff, n).reshape(S * S, hp // n, wp // n)
    k = first_argmin(cost, 0)
    best_c = torch.gather(cost, 0, k[None])[0]
    mv = torch.stack([k // S - radius, k % S - radius], dim=-1)
    return mv.to(torch.int32), best_c


def search_v3(src: torch.Tensor, ref_pad: torch.Tensor, n: int):
    """Full-pel MVs (B, 2) int32 for the n x n blocks of ``src``
    against ``ref_pad`` (padded by PAD).  Port of motion.search_v3."""
    dev = src.device
    hp, wp = src.shape
    B = (hp // n) * (wp // n)
    pos = torch.as_tensor(block_positions(hp, wp, n), device=dev)
    src_i = src.to(torch.int32)
    blocks = _to_blocks(src_i, n)
    zero = torch.zeros((B, 2), dtype=torch.int32, device=dev)
    r = 8

    mv_a, ssd_a = refine.refine_around_seeds(blocks, ref_pad, pos, zero, n,
                                             r, PAD)
    cscale = 8 if n // 8 >= 4 else COARSE_SCALE
    cradius = 8 if cscale == 8 else COARSE_RADIUS_V2
    if n // cscale >= 4:
        src_c = _downsample(src_i, cscale)
        ref_c = _downsample(ref_pad, cscale)
        mv_c, _ = _shift_scan_search(src_c, ref_c, n // cscale, cradius,
                                     PAD // cscale)
        seed = (mv_c.reshape(B, 2) * cscale).clamp(-MAX_MV, MAX_MV)
        mv_b, ssd_b = refine.refine_around_seeds(blocks, ref_pad, pos, seed,
                                                 n, r, PAD)
        take = ssd_b < ssd_a
        mv_a = torch.where(take[:, None], mv_b, mv_a)
        ssd_a = torch.minimum(ssd_a, ssd_b)
    mv_best = mv_a.clamp(-MAX_MV, MAX_MV)

    center = ref_pad[PAD:PAD + hp, PAD:PAD + wp].to(torch.int32)
    ssd_zero = zero_ssd(src_i, center, n)
    better = ssd_a + ssd_a / 16.0 < ssd_zero
    return torch.where(better[:, None], mv_best, zero)


def zero_ssd(src: torch.Tensor, center: torch.Tensor, n: int):
    """Per-block zero-MV SSD (B,) float32, summed exactly in int32."""
    d = src - center
    return _block_sum(d * d, n).reshape(-1).to(torch.float32)


def subpel_refine(src_blocks: torch.Tensor, ref_pad: torch.Tensor,
                  pos: torch.Tensor, mv_full: torch.Tensor, n: int,
                  pad: int = PAD, maxval: int = 255) -> torch.Tensor:
    """Quarter-pel refinement around the full-pel winner (port of
    motion.subpel_refine): the 7x7 quarter-pel grid (+-3/4 pel) with the
    normative interpolation, one region per block, the horizontal pass
    of each column offset shared by its 7 vertical phases.  Returns MVs
    in q4 units.  The full-pel centre stays unless the best candidate's
    SAD beats it by a quarter.  As in the reference, the first
    candidate (-3, -3) only seeds the running minimum: if it stays the
    minimum, the offset stays (0, 0)."""
    from av1tpu_torch.encoder.kernels import mc

    taps = mc.LUMA_TAPS
    B = src_blocks.shape[0]
    R = n + taps - 1 + 1          # covers candidate floor in {-1, 0}
    off = taps // 2 - 1
    hp2, wp2 = ref_pad.shape
    r0 = (pos[:, 0] + pad + mv_full[:, 0] - off - 1).clamp(0, hp2 - R)
    c0 = (pos[:, 1] + pad + mv_full[:, 1] - off - 1).clamp(0, wp2 - R)
    regions = mc.windows(ref_pad, r0, c0, R).to(torch.int32)
    src_f = src_blocks.to(torch.int32)
    center_q = mv_full * (1 << mc.MV_PREC)
    best_ssd = center_ssd = None
    best_dq = torch.zeros((B, 2), dtype=torch.int32, device=src_f.device)
    ftab = mc.luma_filters()
    for qx in range(-3, 4):
        fx, px = (qx >> 2), qx & 3
        sub_x = regions[:, :, 1 + fx:1 + fx + n + taps - 1]
        htmp = mc._hfilter(sub_x, ftab[px], n, taps)      # (B, R, n)
        for qy in range(-3, 4):
            fy, py = (qy >> 2), qy & 3
            vt = htmp[:, 1 + fy:1 + fy + n + taps - 1, :]
            out = mc._vfilter(vt, ftab[py], n, taps)
            out = (out + (1 << (mc.FINAL_SHIFT - 1))) >> mc.FINAL_SHIFT
            pred = out.clamp(0, maxval)
            ssd = (src_f - pred).abs().sum((1, 2), dtype=torch.int32)
            if qy == 0 and qx == 0:
                center_ssd = ssd
            if best_ssd is None:
                best_ssd = ssd
            else:
                take = ssd < best_ssd
                best_ssd = torch.minimum(best_ssd, ssd)
                best_dq = torch.where(
                    take[:, None],
                    torch.tensor([qy, qx], dtype=torch.int32,
                                 device=src_f.device), best_dq)
    # the reference compares in float32: center - center / 4.0 is exact
    # there for SADs below 2^22 (32x32 blocks of 10-bit samples)
    cf = center_ssd.to(torch.float32)
    keep_center = best_ssd.to(torch.float32) >= cf - cf / 4.0
    return torch.where(keep_center[:, None], center_q, center_q + best_dq)

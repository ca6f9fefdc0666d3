"""Full-pel motion search: the ``search_v3`` and ``gather_blocks``
subset of ``av1tpu/encoder/kernels/motion.py``.

Stage 1: a +-8 shift scan on 8x-downsampled planes (+-64 full-pel) sets
per-block seeds.  Stage 2: K2 refines +-8 around the zero seed and
around the coarse seed.  Final: best-of with the exact zero-MV SSD and
a rate-aware zero bias.

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

"""Motion search of the private av1tpu profile: a port of
``av1tpu/encoder/kernels/motion.py``.

``search_v3`` (the v2 frame's full-pel search): a +-8 shift scan on
8x-downsampled planes (+-64 full-pel) sets per-block seeds, K2 refines
+-8 around the zero seed and around the coarse seed, and the exact
zero-MV SSD with a rate-aware zero bias decides.  ``subpel_refine``
refines the full-pel winner on a 7x7 quarter-pel grid.

``search`` (alias ``tss_search``; the v1 frame's): an exhaustive +-8
stage around the zero seed and another around a coarse seed (+-12 on
4x-downsampled planes, ``_search_stage_coarse``), best-of with the
zero MV.  The reference computes each stage as a float32 grouped
convolution, Σref² − 2·Σsrc·ref (``_ssd_surface``).  At +-8 that is K2's
work: the same clamped region origin, the same dy-major first minimum,
and SSD = surface + Σsrc², so ``_search_stage`` is K1's region gather
and K2.  The coarse stage's 625 displacements exceed K2's CTA, so it
stays tensor code over ``_ssd_surface``.  ``search_v2`` is the +-16
shift scan at full resolution plus a refined coarse candidate.

The reference's shift scans are a ``lax.scan`` over frame shifts; here
they run over groups of shifts, each group one batched tensor op,
keeping the strict '<' first-minimum order over the dy-major
displacement list.  Every SSD here is summed exactly in integers and
converted to float32 once; the reference's float32 sums agree while
they stay below 2^24 (16-px blocks of 8-bit samples: 256 x 255^2).
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.encoder.kernels import gather, refine
from av1tpu_torch.encoder.kernels.restoration import edge_pad

PAD = 64          # normative luma reference padding (pixels)
CHROMA_PAD = 32   # normative chroma padding (chroma MVs are half-range)
COARSE_SCALE = 4  # downsample factor of the coarse stage
COARSE_RADIUS = 12   # +-12 coarse = +-48 full-pel
FINE_RADIUS = 8      # +- window around the coarse seed
MAX_MV = PAD - 16  # keep gathers inside the padded extent
FINE_RADIUS_V2 = 16     # direct window +-16
COARSE_RADIUS_V2 = 16   # coarse window +-16 at 4x = +-64 full-pel
REFINE_RADIUS_V2 = 3    # per-block refine around the coarse seed
# elements of one group of the shift scans' batched difference planes
SCAN_BUDGET = 1 << 26


def pad_ref(plane: torch.Tensor) -> torch.Tensor:
    """Edge-replicate pad by PAD on all sides (normative)."""
    return edge_pad(plane, PAD, PAD)


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
    motion.gather_blocks.  A tuple of planes of one shape (U and V)
    gives (P, B, n, n) in one launch."""
    hp2, wp2 = (ref_pad if isinstance(ref_pad, torch.Tensor)
                else ref_pad[0]).shape
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
    """Exhaustive +-radius over frame shifts, in groups of dy rows of at
    most ``SCAN_BUDGET`` difference samples, each group one batched op;
    a later group's minimum replaces the running one only where it is
    strictly smaller.  Returns (best_mv (rows, cols, 2) int32, best_cost
    (rows, cols) int32)."""
    hp, wp = src.shape
    S = 2 * radius + 1
    ref = ref_pad[pad - radius:pad + radius + hp,
                  pad - radius:pad + radius + wp].to(torch.int32)
    wins = ref.unfold(0, hp, 1).unfold(1, wp, 1)        # (S, S, hp, wp)
    src_i = src.to(torch.int32)
    g = max(1, SCAN_BUDGET // (S * hp * wp))
    best_c = best_k = None
    for dy0 in range(0, S, g):
        diff = src_i[None, None] - wins[dy0:dy0 + g]
        cost = _block_sum(diff * diff, n).reshape(-1, hp // n, wp // n)
        k = first_argmin(cost, 0)
        c = torch.gather(cost, 0, k[None])[0]
        k = k + dy0 * S
        if best_c is None:
            best_c, best_k = c, k
        else:
            better = c < best_c
            best_c = torch.where(better, c, best_c)
            best_k = torch.where(better, k, best_k)
    mv = torch.stack([best_k // S - radius, best_k % S - radius], dim=-1)
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


# ---------------------------------------------------------------------------
# v1 search (the v1 frame, ``legacy/core/inter_frame.encode_inter_frame``)

def chroma_mv(mvs: torch.Tensor) -> torch.Tensor:
    """Full-pel chroma MV from a luma MV (normative v1): halved, rounded
    toward zero."""
    return (mvs + (mvs < 0).to(mvs.dtype)) >> 1


def _ssd_surface(blocks: torch.Tensor, regions: torch.Tensor) -> torch.Tensor:
    """SSD of every block against every aligned window of its region, up
    to the block's own energy: blocks (B, n, n), regions (B, n+2r, n+2r)
    -> (B, 2r+1, 2r+1) float32, Σref(d)² − 2·Σsrc·ref(d).  Both sums are
    exact integers, converted to float32 once."""
    n = blocks.shape[-1]
    reg = regions.to(torch.int32)
    wins = reg.unfold(1, n, 1).unfold(2, n, 1)          # (B, S, S, n, n)
    cross = (wins * blocks.to(torch.int32)[:, None, None]).sum(
        (-2, -1), dtype=torch.int64)
    energy = (wins * wins).sum((-2, -1), dtype=torch.int64)
    return (energy - 2 * cross).to(torch.float32)


def _argmin_2d(cost: torch.Tensor, radius: int) -> torch.Tensor:
    """(B, S, S) -> displacement (B, 2) int32 in [-radius, radius] of the
    first minimum in dy-major order."""
    B, S, _ = cost.shape
    k = first_argmin(cost.reshape(B, S * S), 1)
    return torch.stack([k // S - radius, k % S - radius], dim=1).to(
        torch.int32)


def _search_stage(src: torch.Tensor, ref_pad: torch.Tensor, n: int,
                  radius: int, seeds: torch.Tensor) -> torch.Tensor:
    """Exhaustive +-radius around per-block seeds; absolute MVs (B, 2)
    int32 within +-MAX_MV.  The reference's surface argmin is K2's SSD
    argmin (SSD = surface + Σsrc², the same region origin and order), so
    the regions go through K1 and the search through K2."""
    hp, wp = src.shape
    pos = torch.as_tensor(block_positions(hp, wp, n), device=src.device)
    blocks = _to_blocks(src.to(torch.int32), n)
    mv, _ = refine.refine_around_seeds(blocks, ref_pad, pos, seeds, n,
                                       radius, PAD)
    return mv.clamp(-MAX_MV, MAX_MV)


def _search_stage_coarse(src_c: torch.Tensor, ref_c: torch.Tensor, cn: int,
                         radius: int) -> torch.Tensor:
    """Coarse stage on downsampled planes (``ref_c`` padded by
    PAD / COARSE_SCALE): MVs (B, 2) int32 in downsampled units."""
    hp, wp = src_c.shape
    pad_c = PAD // COARSE_SCALE
    pos = torch.as_tensor(block_positions(hp, wp, cn), device=src_c.device)
    blocks = _to_blocks(src_c.to(torch.int32), cn)
    R = cn + 2 * radius
    hp2, wp2 = ref_c.shape
    r0 = (pos[:, 0] + pad_c - radius).clamp(0, hp2 - R)
    c0 = (pos[:, 1] + pad_c - radius).clamp(0, wp2 - R)
    ar = torch.arange(R, device=src_c.device)
    regions = ref_c[(r0.long()[:, None] + ar)[:, :, None],
                    (c0.long()[:, None] + ar)[:, None, :]]
    d = _argmin_2d(_ssd_surface(blocks, regions), radius)
    base = torch.stack([r0 - (pos[:, 0] + pad_c), c0 - (pos[:, 1] + pad_c)],
                       dim=1) + radius
    return (base + d).to(torch.int32)


def _block_ssd(blocks: torch.Tensor, ref_pad: torch.Tensor,
               pos: torch.Tensor, mv: torch.Tensor, n: int) -> torch.Tensor:
    """Per-block SSD (B,) int32 of ``blocks`` against the reference at
    pos + mv (one K1 gather)."""
    d = blocks - gather_blocks(ref_pad, pos, mv, n)
    return (d * d).sum((1, 2), dtype=torch.int32)


def search(src: torch.Tensor, ref_pad: torch.Tensor, n: int) -> torch.Tensor:
    """Two-stage exhaustive full-pel search: MVs (B, 2) int32.  Effective
    window +-(COARSE_SCALE * COARSE_RADIUS + FINE_RADIUS) = +-56.  Port of
    motion.search: K1 and K2 once for each stage at +-8, one K1 gather
    for each candidate's SSD."""
    dev = src.device
    hp, wp = src.shape
    s = COARSE_SCALE
    cn = n // s
    zero = torch.zeros(((hp // n) * (wp // n), 2), dtype=torch.int32,
                       device=dev)
    pos = torch.as_tensor(block_positions(hp, wp, n), device=dev)
    blocks = _to_blocks(src.to(torch.int32), n)

    # fine search around the zero seed (robust baseline, window +-FINE)
    best_mv = _search_stage(src, ref_pad, n, FINE_RADIUS, zero)
    best_ssd = _block_ssd(blocks, ref_pad, pos, best_mv, n)
    if cn >= 4:
        # wide-window candidate: coarse on 4x-downsampled planes, refined
        coarse = _search_stage_coarse(_downsample(src, s),
                                      _downsample(ref_pad, s), cn,
                                      COARSE_RADIUS)
        mv_wide = _search_stage(src, ref_pad, n, FINE_RADIUS, coarse * s)
        ssd_wide = _block_ssd(blocks, ref_pad, pos, mv_wide, n)
        take = ssd_wide < best_ssd
        best_mv = torch.where(take[:, None], mv_wide, best_mv)
        best_ssd = torch.minimum(best_ssd, ssd_wide)
    # always consider the zero MV: cheap to code, avoids noisy drift
    ssd_z = _block_ssd(blocks, ref_pad, pos, zero, n)
    better = best_ssd + (best_ssd >> 4) < ssd_z
    return torch.where(better[:, None], best_mv, zero)


# kept name of the reference's callers and tests
tss_search = search


def search_v2(src: torch.Tensor, ref_pad: torch.Tensor,
              n: int) -> torch.Tensor:
    """Shift-scan search: MVs (B, 2) int32.  Port of motion.search_v2.

    Stage 1: the direct +-FINE_RADIUS_V2 shift scan at full resolution.
    Stage 2: a +-COARSE_RADIUS_V2 shift scan on 4x-downsampled planes
             (window +-64), refined per block over +-REFINE_RADIUS_V2
             (one K1 gather a candidate).
    Final:   best-of {fine, refined coarse, zero} with a zero-MV bias,
             compared in float32 as the reference does."""
    dev = src.device
    hp, wp = src.shape
    B = (hp // n) * (wp // n)
    pos = torch.as_tensor(block_positions(hp, wp, n), device=dev)
    blocks = _to_blocks(src.to(torch.int32), n)
    zero = torch.zeros((B, 2), dtype=torch.int32, device=dev)

    mv_fine, c_fine = _shift_scan_search(src, ref_pad, n, FINE_RADIUS_V2, PAD)
    best_mv = mv_fine.reshape(B, 2)
    best_c = c_fine.reshape(B)
    s = COARSE_SCALE
    if n // s >= 4:
        mv_c, _ = _shift_scan_search(_downsample(src, s),
                                     _downsample(ref_pad, s), n // s,
                                     COARSE_RADIUS_V2, PAD // s)
        seed = mv_c.reshape(B, 2) * s
        r = REFINE_RADIUS_V2
        cand_mv = seed.clamp(-MAX_MV, MAX_MV)
        cand_c = _block_ssd(blocks, ref_pad, pos, cand_mv, n)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                if dy == 0 and dx == 0:
                    continue
                mv = (seed + torch.tensor([dy, dx], dtype=torch.int32,
                                          device=dev)).clamp(-MAX_MV, MAX_MV)
                c = _block_ssd(blocks, ref_pad, pos, mv, n)
                take = c < cand_c
                cand_mv = torch.where(take[:, None], mv, cand_mv)
                cand_c = torch.minimum(cand_c, c)
        take = cand_c < best_c
        best_mv = torch.where(take[:, None], cand_mv, best_mv)
        best_c = torch.minimum(best_c, cand_c)
    # zero-MV bias (rate-aware), in float32 as the reference
    bf = best_c.to(torch.float32)
    c_zero = _block_ssd(blocks, ref_pad, pos, zero, n).to(torch.float32)
    better = bf + bf / 16.0 < c_zero
    return torch.where(better[:, None], best_mv, zero)

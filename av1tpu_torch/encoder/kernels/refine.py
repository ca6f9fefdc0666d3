"""K2: all-displacement SSD refine (port of pallas_motion).

For each n x n block, the SSD against all (2r+1)^2 displacements of its
(n + 2r)^2 search region, and the first strict minimum in dy-major
order.  Full-pel search runs it once per seed family and split16 once
per quadrant.

Kernel: ``csrc/refine.cu``, replacing the Pallas kernel
``av1tpu/encoder/kernels/pallas_motion.py::_refine_kernel``.  Bound by
device memory at the main-path shapes; the kernel splits the SSD into
window sums of r^2, the cross term and sum(b^2), and runs the cross
term register-blocked on 8-bit (dp4a) or 16-bit staged copies (see the
source's note).  The reference sums in float32, which is exact only
below 2^24; the port's sums are exact at 8 and 10 bits, so the two agree
whenever the reference's sums are exact.  The wrappers take a
block-first layout, blocks (B, n, n) and regions (B, R, R): the
reference's block-index-last transposes and 128-lane batch padding are
TPU layout workarounds.
"""

from __future__ import annotations

import ctypes

import torch

from av1tpu_torch import device as D
from av1tpu_torch.encoder.kernels import gather


def refine_ssd_plain(blocks: torch.Tensor, regions: torch.Tensor, n: int,
                     radius: int):
    """(best_ssd (B,) float32, disp (B, 2) int32) with the reference's
    strict-'<' scan over k = (dy + r) * S + (dx + r)."""
    S = 2 * radius + 1
    B = blocks.shape[0]
    blk = blocks.to(torch.int32)
    reg = regions.to(torch.int32)
    best = torch.full((B,), torch.iinfo(torch.int32).max, dtype=torch.int32,
                      device=blocks.device)
    best_k = torch.zeros((B,), dtype=torch.int32, device=blocks.device)
    for k in range(S * S):
        dy, dx = divmod(k, S)
        d = reg[:, dy:dy + n, dx:dx + n] - blk
        ssd = (d * d).sum((1, 2), dtype=torch.int32)
        better = ssd < best
        best = torch.where(better, ssd, best)
        best_k = torch.where(better, torch.full_like(best_k, k), best_k)
    disp = torch.stack([best_k // S - radius, best_k % S - radius], dim=1)
    return best.to(torch.float32), disp


def _refine_cuda(blocks, regions, n, radius):
    if blocks.dtype != torch.int32 or regions.dtype != torch.int32:
        raise TypeError("refine_ssd: blocks and regions must be int32")
    R = n + 2 * radius
    B = blocks.shape[0]
    if tuple(blocks.shape) != (B, n, n) or \
            tuple(regions.shape) != (B, R, R):
        raise ValueError(f"refine_ssd: shapes {tuple(blocks.shape)} / "
                         f"{tuple(regions.shape)} for n={n} r={radius}")
    if regions.device != blocks.device:
        raise ValueError("refine_ssd: blocks and regions on different "
                         "devices")
    if (2 * radius + 1) ** 2 > 320:
        raise ValueError(f"refine_ssd: radius {radius} exceeds the CTA")
    blocks = blocks.contiguous()
    regions = regions.contiguous()
    ssd = torch.empty((B,), dtype=torch.float32, device=blocks.device)
    disp = torch.empty((B, 2), dtype=torch.int32, device=blocks.device)
    vp = ctypes.c_void_p
    # the launch goes to the blocks' card and its current stream
    with torch.cuda.device(blocks.device):
        err = D.kernels().av1_refine_ssd(
            vp(blocks.data_ptr()), vp(regions.data_ptr()), B, n, radius,
            vp(ssd.data_ptr()), vp(disp.data_ptr()),
            vp(D.stream_ptr(blocks.device)))
    D.check_launch(err, "refine_ssd")
    refine_ssd.launches += 1
    return ssd, disp


def refine_ssd(blocks: torch.Tensor, regions: torch.Tensor, n: int,
               radius: int):
    """All-displacement SSD argmin: blocks (B, n, n), regions
    (B, n+2r, n+2r) int32 -> (best_ssd (B,) float32, disp (B, 2) int32
    in [-r, r]).  CUDA tensors launch the kernel; CPU tensors take the
    plain version."""
    if blocks.device.type == "cuda":
        return _refine_cuda(blocks, regions, n, radius)
    if blocks.device.type == "cpu":
        return refine_ssd_plain(blocks, regions, n, radius)
    raise RuntimeError(f"refine_ssd: unsupported device {blocks.device}")


refine_ssd.launches = 0


def refine_around_seeds(src_blocks: torch.Tensor, ref_pad: torch.Tensor,
                        pos: torch.Tensor, seeds: torch.Tensor, n: int,
                        radius: int, pad: int):
    """Gather one region per block around pos+seed and refine it.

    src_blocks (B, n, n) int; returns (mvs (B, 2) int32 absolute,
    ssd (B,) float32).  Port of pallas_motion.refine_around_seeds."""
    R = n + 2 * radius
    hp2, wp2 = ref_pad.shape
    r0 = (pos[:, 0] + pad + seeds[:, 0] - radius).clamp(0, hp2 - R)
    c0 = (pos[:, 1] + pad + seeds[:, 1] - radius).clamp(0, wp2 - R)
    regions = gather.gather_windows(ref_pad, r0, c0, R)
    ssd, disp = refine_ssd(src_blocks.to(torch.int32), regions, n, radius)
    # absolute MV: displacement relative to the clamped region origin
    base = torch.stack([r0 - (pos[:, 0] + pad), c0 - (pos[:, 1] + pad)],
                       dim=1) + radius
    return (base + disp).to(torch.int32), ssd


def refine_around_seeds2(src_blocks: torch.Tensor, ref_pad: torch.Tensor,
                         gld_pad: torch.Tensor, ri: torch.Tensor,
                         pos: torch.Tensor, seeds: torch.Tensor, n: int,
                         radius: int, pad: int):
    """refine_around_seeds with a per-block reference plane: block b's
    region comes from ``gld_pad`` where ``ri[b]`` is 1, else from
    ``ref_pad``.  Port of pallas_motion.refine_around_seeds2; the pair of
    planes takes the place of its make_wide2 handle."""
    R = n + 2 * radius
    hp2, wp2 = ref_pad.shape
    r0 = (pos[:, 0] + pad + seeds[:, 0] - radius).clamp(0, hp2 - R)
    c0 = (pos[:, 1] + pad + seeds[:, 1] - radius).clamp(0, wp2 - R)
    regions = gather.gather_windows2(ref_pad, gld_pad, ri, r0, c0, R)
    ssd, disp = refine_ssd(src_blocks.to(torch.int32), regions, n, radius)
    base = torch.stack([r0 - (pos[:, 0] + pad), c0 - (pos[:, 1] + pad)],
                       dim=1) + radius
    return (base + disp).to(torch.int32), ssd

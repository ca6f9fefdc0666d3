"""In-loop deblocking filter of the private av1tpu profile (NORMATIVE): a
port of ``av1tpu/encoder/kernels/deblock.py``.  It is not the spec-AV1
deblocking filter (``specav1/loopfilter.py``).

Filter: a conditional 2-pixel smoother at every transform-block edge.
For edge pixels p1 p0 | q0 q1:
  active  = |p1−p0| ≤ thr  ∧  |q1−q0| ≤ thr  ∧  |p0−q0| < blimit
  delta   = clip3( rs(3·(q0−p0) + (p1−q1), 3), −limit, limit )
  p0 += delta, q0 −= delta            (when active)
Strength derives from base_q_idx (no extra syntax):
  level  = clamp(qindex//8 − 4, 0, 16);  level 0 disables (limit 0).
  thr = 1 + level//4,  blimit = 3·level + 4,  limit = level.
Planes may carry leading dimensions (one per tile stripe); the filter
runs over the last two.
"""

from __future__ import annotations

import torch


def filter_params(qindex: int, bit_depth: int = 8):
    """(thr, blimit, limit) from qindex; thresholds scale with the sample
    range (×4 at 10-bit)."""
    level = min(max(int(qindex) // 8 - 4, 0), 16)
    s = 1 << (bit_depth - 8)
    return (1 + level // 4) * s, (3 * level + 4) * s, level * s


def _edge_filter(p1, p0, q0, q1, thr, blimit, limit, maxval):
    active = (((p1 - p0).abs() <= thr) & ((q1 - q0).abs() <= thr)
              & ((p0 - q0).abs() < blimit))
    delta = (3 * (q0 - p0) + (p1 - q1) + 4) >> 3
    delta = torch.where(active, delta.clamp(-limit, limit), 0)
    return (p0 + delta).clamp(0, maxval), (q0 - delta).clamp(0, maxval)


def deblock_plane(rec: torch.Tensor, n: int, qindex: int,
                  bit_depth: int = 8) -> torch.Tensor:
    """Filter all interior block edges of int32 recon planes (..., H, W):
    the vertical edges first, then the horizontal ones."""
    thr, blimit, limit = filter_params(qindex, bit_depth)
    maxval = (1 << bit_depth) - 1
    h, w = rec.shape[-2:]
    rec = rec.clone()
    if n < w:
        cols = torch.arange(n, w, n, device=rec.device)
        new_p0, new_q0 = _edge_filter(
            rec[..., cols - 2], rec[..., cols - 1], rec[..., cols],
            rec[..., cols + 1], thr, blimit, limit, maxval)
        rec[..., cols - 1] = new_p0
        rec[..., cols] = new_q0
    if n < h:
        rows = torch.arange(n, h, n, device=rec.device)
        new_p0, new_q0 = _edge_filter(
            rec[..., rows - 2, :], rec[..., rows - 1, :], rec[..., rows, :],
            rec[..., rows + 1, :], thr, blimit, limit, maxval)
        rec[..., rows - 1, :] = new_p0
        rec[..., rows, :] = new_q0
    return rec
